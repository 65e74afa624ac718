"""Cache-model layer: AET-exact hierarchy read-offs.

The port's copy of ``pluss/model/__init__.py``.

:mod:`pluss_torch.model.hierarchy` turns one reuse-interval histogram into
multi-level / set-associative / non-LRU miss-ratio read-offs; the
cross-nest co-tenancy composition that feeds it heterogeneous streams
lives in :mod:`pluss_torch.analysis.interference`.
"""

from pluss_torch.model.hierarchy import (  # noqa: F401
    HierarchyConfig,
    aet_plateau,
    hierarchy_doc,
    level_readoffs,
    render_hierarchy,
)
