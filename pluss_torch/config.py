"""Model constants and run configuration (the port's copy of ``pluss/config.py``).

The reference hardcodes these as compile-time ``-D`` macros; here they live in
one runtime-configurable dataclass, and every quirk constant of the
statistics pipeline keeps its provenance so golden-output parity stays
auditable.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Schedule + machine-model parameters of one sampling run.

    - ``thread_num``  — simulated OpenMP threads (``-DTHREAD_NUM=4``)
    - ``chunk_size``  — static-schedule chunk (``-DCHUNK_SIZE=4``)
    - ``ds``          — element size in bytes (``-DDS=8``)
    - ``cls``         — cache-line size in bytes (``-DCLS=64``)
    - ``cache_kb``    — AET sweep capacity (``POLYBENCH_CACHE_SIZE_KB``)
    """

    thread_num: int = 4
    chunk_size: int = 4
    ds: int = 8
    cls: int = 64
    cache_kb: int = 2560

    @property
    def lines_per_element_div(self) -> int:
        """Elements per cache line: ``CLS // DS`` (address -> line is
        ``addr*DS//CLS``)."""
        return self.cls // self.ds

    @property
    def aet_cache_entries(self) -> int:
        """AET sweep bound: ``cache_kb * 1024 / sizeof(double)``
        (pluss_utils.h:785)."""
        return self.cache_kb * 1024 // 8


#: NBD point-mass cutoff: thread-local reuse n >= NBD_CUTOFF_COEF*(T-1)/T is
#: emitted as a point mass at T*n instead of a negative-binomial dilation
#: (pluss_utils.h:993-997).
NBD_CUTOFF_COEF = 4000.0

#: NBD tail truncation: pmf terms accumulate until the running mass exceeds
#: this value; the crossing term is included (pluss_utils.h:1001-1008).
NBD_MASS_CUT = 0.9999

#: MRC printer dedup epsilon (pluss_utils.h:863, 899).
MRC_DEDUP_EPS = 1e-5

#: AET vestigial first-step epsilon (pluss_utils.h:798): with MRC_pred=-1 the
#: branch ``MRC_pred - P[prev_t] < 1e-4`` is always true, so every c gets an
#: entry.
AET_PRED_EPS = 1e-4

#: Dense histogram slots.  Slot 0 holds the cold-miss key (-1); slot 1+e
#: holds the log2 bin with key 2**e.  48 exponent slots cover reuse
#: intervals up to 2**47.
NBINS = 49

#: The share-unique capacity of the JAX package's engine
#: (``pluss/config.py``).  The port's engine keeps every share unique and
#: has no cap; this value survives only as the label that
#: :mod:`pluss_torch.analysis.tune` prints in every candidate's
#: ``share_cap`` field, so the tuner's lines and documents stay the JAX
#: package's byte for byte.
SHARE_CAP = 1024

DEFAULT = SamplerConfig()
