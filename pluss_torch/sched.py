"""Chunk-scheduling math in closed form (the reference's ChunkDispatcher).

Static scheduling (``pluss_utils.h:410-425``): chunk id ``cid`` (0-based over
the whole parallel loop) is served by thread ``cid % T``; the engine turns
that rule, an explicit chunk->thread assignment (dynamic FIFO scheduling)
and the ``setStartPoint`` resume into an owned-chunk matrix
(:func:`pluss_torch.engine._owned_matrix`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChunkSchedule:
    """Closed-form view of one parallel loop's chunking: ``trip``
    iterations starting at value ``start`` with stride ``step``, cut into
    chunks of ``chunk_size`` (``ChunkDispatcher(chunk_size, trip, start,
    step)``, pluss_utils.h:325-334), served by ``thread_num`` threads;
    ``last = start + (trip-1)*step``."""

    chunk_size: int
    trip: int
    start: int = 0
    step: int = 1
    thread_num: int = 4

    def __post_init__(self) -> None:
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.trip < 0:
            raise ValueError(f"trip must be >= 0, got {self.trip}")
        if self.step == 0:
            raise ValueError("step must be nonzero")
        if self.thread_num < 1:
            raise ValueError(f"thread_num must be >= 1, got {self.thread_num}")

    @property
    def last(self) -> int:
        return self.start + (self.trip - 1) * self.step

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

    def chunk_bounds(self, cid: int) -> tuple[int, int]:
        """(lb, ub) inclusive in *value* space, as ``getNextStaticChunk``
        returns (pluss_utils.h:410-425): for step>0 ub is clamped to
        ``last``."""
        b, e = self.chunk_index_range(cid)
        v0 = self.start + b * self.step
        v1 = self.start + (e - 1) * self.step
        return (v0, v1) if self.step > 0 else (v1, v0)

    def chunk_owner(self, cid: int) -> int:
        """Static owner thread of chunk ``cid``: round-robin
        (pluss_utils.h:312,420)."""
        return cid % self.thread_num

    def chunks_of_thread(self, tid: int) -> list[int]:
        """Chunk ids thread ``tid`` serves under the static schedule, in
        execution order (the static analyses walk these)."""
        return list(range(tid, self.n_chunks, self.thread_num))

    def n_chunks_of_thread(self, tid: int) -> int:
        return len(self.chunks_of_thread(tid))

    def max_rounds(self) -> int:
        """Most chunks any one thread serves (the engine's row bound)."""
        return -(-self.n_chunks // self.thread_num) if self.n_chunks else 0

    def thread_iteration_indices(self, tid: int) -> list[int]:
        """All iteration indices (0..trip) of thread ``tid`` in execution
        order."""
        out = []
        for cid in self.chunks_of_thread(tid):
            b, e = self.chunk_index_range(cid)
            out.extend(range(b, e))
        return out

    def thread_iteration_values(self, tid: int) -> list[int]:
        return [self.start + i * self.step
                for i in self.thread_iteration_indices(tid)]

    # -- iteration value -> (round, tid, pos), the C++ dispatcher's API -----

    def static_tid(self, i: int) -> int:
        """``getStaticTid`` (pluss_utils.h:429-431)."""
        idx = (i - self.start) // self.step
        return idx // self.chunk_size - (
            idx // (self.chunk_size * self.thread_num)) * self.thread_num

    def static_chunk_id(self, i: int) -> int:
        """``getStaticChunkID``: the thread-local *round*, not the global
        cid (pluss_utils.h:433-435)."""
        return (i - self.start) // self.step // (self.chunk_size
                                                 * self.thread_num)

    def static_thread_local_pos(self, i: int) -> int:
        """``getStaticThreadLocalPos`` (pluss_utils.h:437-439)."""
        return (i - self.start) // self.step % self.chunk_size

    def local_rank(self, i: int) -> int:
        """Rank of iteration value ``i`` within its owner thread's stream:
        ``round*chunk_size + pos`` (only the globally-last chunk can be
        partial, so every earlier chunk of the owner is full)."""
        return self.static_chunk_id(i) * self.chunk_size \
            + self.static_thread_local_pos(i)

    # -- resume / start-point API (pluss_utils.h:443-587) -------------------

    def chunks_of_thread_from(self, tid: int, i: int) -> list[int]:
        """Chunk ids thread ``tid`` still serves when sampling resumes at
        iteration value ``i`` — ``setStartPoint`` semantics
        (pluss_utils.h:443-472): every thread skips ``static_chunk_id(i)``
        full rounds."""
        first = self.static_chunk_id(i) * self.thread_num + tid
        return [c for c in range(first, self.n_chunks, self.thread_num)
                if c >= 0]

    def static_start_chunk(self, i: int, tid: int) -> tuple[int, int]:
        """Value-space start chunk of ``tid`` after ``setStartPoint(i)``
        (``getStaticStartChunk``, pluss_utils.h:474-490).  As in the
        reference, the resume point's intra-chunk offset applies to every
        thread's start chunk, and only the far bound is clamped to
        ``last``, so a thread whose shifted start lies past the end gets an
        inverted (empty) range."""
        pos = self.static_thread_local_pos(i)
        base = (self.start + self.chunk_size * self.step * tid
                + self.static_chunk_id(i)
                * self.chunk_size * self.thread_num * self.step)
        near = base + pos * self.step
        far = base + (self.chunk_size - 1) * self.step
        if self.step > 0:
            return near, min(far, self.last)
        return max(far, self.last), near

    def start_chunk_of(self, i: int) -> int:
        """Global chunk id containing iteration value ``i``
        (``getStartChunk`` rounding, pluss_utils.h:492-516)."""
        return (i - self.start) // self.step // self.chunk_size

    def next_k_chunks(self, k: int, cid: int) -> list[int]:
        """``getNextKChunksFrom`` (pluss_utils.h:518-552) in chunk-id
        space."""
        return list(range(cid + 1, min(cid + 1 + k, self.n_chunks)))

    def prev_k_chunks(self, k: int, cid: int) -> list[int]:
        """``getPrevKChunksFrom`` (pluss_utils.h:554-587) in chunk-id
        space."""
        return list(range(cid - 1, max(cid - 1 - k, -1), -1))

    def dynamic_assignment(self, request_order: list[int] | None = None
                           ) -> list[int]:
        """Chunk -> thread map under FIFO dynamic scheduling
        (``getNextChunk``, pluss_utils.h:393-408).  ``request_order``: the
        sequence of thread ids asking for chunks; default round-robin,
        which equals the static map."""
        n = self.n_chunks
        if request_order is None:
            return [c % self.thread_num for c in range(n)]
        if len(request_order) < n:
            raise ValueError("request_order shorter than number of chunks")
        return list(request_order[:n])


def chunks_check(trip: int, chunk_size: int) -> int:
    return -(-trip // chunk_size)


def iteration_value_grid(sched: ChunkSchedule, tid: int):
    """(rounds, chunk_size) grids of thread ``tid`` as plain lists: for
    round r and in-chunk pos p, ``(g, v, rank, valid)`` with global index
    ``g = (r*T + tid)*CS + p``, value ``v = start + g*step``, local rank
    ``r*CS + p`` and ``valid = g < trip`` (the engine's formulas, for the
    tests to hold against :meth:`ChunkSchedule.thread_iteration_indices`)."""
    T, CS = sched.thread_num, sched.chunk_size
    rows = []
    for r in range(sched.max_rounds()):
        row = []
        for p in range(CS):
            g = (r * T + tid) * CS + p
            row.append((g, sched.start + g * sched.step, r * CS + p,
                        g < sched.trip))
        rows.append(row)
    return rows
