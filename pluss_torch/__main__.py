"""``python -m pluss_torch acc|speed|mrc ...`` — the same CLI as
``python -m pluss_torch.cli``."""

import sys

from pluss_torch.cli import main

sys.exit(main())
