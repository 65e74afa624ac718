"""Chunk-scheduling math in closed form (the reference's ChunkDispatcher).

Static scheduling (``pluss_utils.h:410-425``): chunk id ``cid`` (0-based over
the whole parallel loop) is served by thread ``cid % T``; the engine turns
that rule into an owned-chunk matrix (:func:`pluss_torch.engine._owned_matrix`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChunkSchedule:
    """Closed-form view of one parallel loop's chunking: ``trip``
    iterations starting at value ``start`` with stride ``step``, cut into
    chunks of ``chunk_size`` (``ChunkDispatcher(chunk_size, trip, start,
    step)``, pluss_utils.h:325-334)."""

    chunk_size: int
    trip: int
    start: int = 0
    step: int = 1

    def __post_init__(self) -> None:
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.trip < 0:
            raise ValueError(f"trip must be >= 0, got {self.trip}")
        if self.step == 0:
            raise ValueError("step must be nonzero")

    @property
    def n_chunks(self) -> int:
        """``avail_chunk`` (pluss_utils.h:300); 0 for an empty loop."""
        return -(-self.trip // self.chunk_size)

    def chunk_index_range(self, cid: int) -> tuple[int, int]:
        """[begin, end) of chunk ``cid`` in iteration-index space (0..trip)."""
        if not 0 <= cid < self.n_chunks:
            raise ValueError(
                f"chunk id {cid} outside [0, {self.n_chunks}) "
                f"(trip={self.trip}, chunk_size={self.chunk_size})")
        b = cid * self.chunk_size
        return b, min(b + self.chunk_size, self.trip)
