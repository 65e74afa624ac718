"""Multi-device execution: the sampler's stream windows sharded over a list
of devices (:mod:`pluss_torch.parallel.shard`), scheduled by the
work-stealing dispatchers (:mod:`pluss_torch.parallel.steal`), and across
processes on ``torch.distributed`` (:mod:`pluss_torch.parallel.multihost`).
The port's counterpart of ``pluss/parallel``."""

from pluss_torch.parallel import multihost
from pluss_torch.parallel.shard import default_devices, shard_run

__all__ = ["default_devices", "shard_run", "multihost"]
