"""Sampled iteration points: uniform-interleaving order, equality, hashing
(the port's copy of ``pluss/iteration.py``; host numpy over
:class:`pluss_torch.sched.ChunkSchedule`).

The reference ships an ``Iteration`` type with a total-order comparator and a
hasher (the reference's ``src/iteration.rs:1-213``; C++ twin
``c_lib/test/runtime/pluss_utils.h:38-285``).  It is dead code in the live
samplers because they enumerate *every* iteration, but it is the declared
API for **true subset sampling**: hold sampled iteration points in ordered
sets that reflect the simulated uniform interleaving of the static schedule,
dedupe them by hash, and resume walks from a point (the
:class:`pluss_torch.sched.ChunkSchedule` start-point API).

Points live in struct-of-arrays form and the total order becomes a
lexicographic **key matrix** consumed by one ``np.lexsort`` — sorting N
sampled points is one vectorized sort, not N·log N comparator calls.  The
scalar :func:`compare` is kept as the executable specification the
vectorized keys are tested against.

Order semantics (``iteration.rs:151-194``, the ``IterationComp`` used by
ordered sets):

1. chunk round ``cid`` (``getStaticChunkID``), then in-chunk ``pos`` —
   uniform interleaving: all threads execute position p of round r together;
2. the non-parallel iteration variables in index order (the parallel one is
   skipped — it only determines cid/tid/pos);
3. thread id;
4. reference priority, **reversed** (higher priority = earlier in program
   order, ``iteration.rs:123-129``).

The sibling ``compare`` method (``iteration.rs:63-133``) omits step 3 (tid) —
a reference quirk; the set-ordering ``IterationComp`` semantics above are the
canonical ones here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pluss_torch.sched import ChunkSchedule

#: bits per iteration variable in the packed identity bitmap
#: (``iteration.rs:204``: ``bitmap |= iv << (i*14)``).
HASH_IV_BITS = 14
#: number of leading ivs the bitmap keeps (``i = 2`` countdown, iteration.rs:202-208).
HASH_IV_SLOTS = 3


@dataclasses.dataclass(frozen=True)
class IterationPoint:
    """One sampled access point: reference name + iteration vector.

    ``ivs`` are iteration *values* (``start + step*index``), as the reference
    stores them.  ``pidx`` is the parallel dimension's index within ``ivs``;
    ``priority`` is the reference's topological order (higher = earlier in the
    loop body).  Mirrors ``Iteration::new`` (iteration.rs:20-51) with the
    (cid, tid, pos) decomposition delegated to :class:`ChunkSchedule`.
    """

    name: str
    ivs: tuple[int, ...]
    priority: int = 1
    parallel: bool = True
    pidx: int = 0

    def decompose(self, sched: ChunkSchedule) -> tuple[int, int, int]:
        """(cid, tid, pos) under the static schedule (iteration.rs:31-39);
        dummy zeros outside a parallel region (iteration.rs:37-38)."""
        if not self.parallel:
            return 0, 0, 0
        v = self.ivs[self.pidx]
        return (
            sched.static_chunk_id(v),
            sched.static_tid(v),
            sched.static_thread_local_pos(v),
        )


def compare(a: IterationPoint, b: IterationPoint, sched: ChunkSchedule) -> int:
    """Scalar ``IterationComp`` total order (iteration.rs:151-194): -1/0/+1.

    This is the executable specification; :func:`order_keys` must sort any
    batch identically (tested in ``tests/test_torch_iteration.py``).
    """
    if a.parallel:
        (ac, at, ap), (bc, bt, bp) = a.decompose(sched), b.decompose(sched)
        if ac != bc:
            return -1 if ac < bc else 1
        if ap != bp:
            return -1 if ap < bp else 1
    common = min(len(a.ivs), len(b.ivs))
    for i in range(common):
        if a.parallel and i == a.pidx:
            continue
        if a.ivs[i] != b.ivs[i]:
            return -1 if a.ivs[i] < b.ivs[i] else 1
    if a.parallel and at != bt:
        return -1 if at < bt else 1
    if a.priority != b.priority:
        # higher priority executes earlier (iteration.rs:186-189 reverse)
        return -1 if a.priority > b.priority else 1
    return 0


def order_keys(
    ivs: np.ndarray,
    priorities: np.ndarray,
    sched: ChunkSchedule,
    pidx: int = 0,
    lengths: np.ndarray | None = None,
) -> list[np.ndarray]:
    """Lexicographic key columns (major first) for a batch of points.

    ``ivs``: [N, D] iteration values, rows padded beyond each point's real
    length; ``lengths``: [N] real lengths (default: all D).  A padded slot
    gets a value below the column minimum, so a shorter point ties-then-wins
    against deeper points sharing its prefix.

    Mixed-depth precondition: against deeper points with an equal common
    prefix the scalar comparator defers to priority (program order), while
    pad-low always places the shorter point first — the two agree exactly
    when shallower refs textually *precede* the deeper loop (the
    PLUSS-generated pattern: init refs before the accumulation loop, as in
    every spec in :mod:`pluss_torch.models`).  A shallow ref placed *after* an
    inner loop would need pad-high instead; batches mixing both shapes are
    outside this function's contract (use :func:`compare`).

    Use as ``np.lexsort(tuple(reversed(order_keys(...))))``.
    """
    ivs = np.asarray(ivs, np.int64)
    N, D = ivs.shape
    if lengths is None:
        lengths = np.full(N, D, np.int64)
    par = ivs[:, pidx]
    cid = np.array([sched.static_chunk_id(int(v)) for v in par], np.int64)
    tid = np.array([sched.static_tid(int(v)) for v in par], np.int64)
    pos = np.array([sched.static_thread_local_pos(int(v)) for v in par], np.int64)
    cols: list[np.ndarray] = [cid, pos]
    slot = np.arange(D)[None, :]
    mask = slot < lengths[:, None]
    lo = ivs.min() - 1
    padded = np.where(mask, ivs, lo)
    for i in range(D):
        if i == pidx:
            continue
        cols.append(padded[:, i])
    cols.append(tid)
    cols.append(-np.asarray(priorities, np.int64))
    return cols


def interleaved_argsort(
    ivs: np.ndarray,
    priorities: np.ndarray,
    sched: ChunkSchedule,
    pidx: int = 0,
    lengths: np.ndarray | None = None,
) -> np.ndarray:
    """Stable argsort of a point batch into uniform-interleaving order."""
    cols = order_keys(ivs, priorities, sched, pidx, lengths)
    return np.lexsort(tuple(reversed(cols)))


def iv_bitmap(ivs: np.ndarray, lengths: np.ndarray | None = None) -> np.ndarray:
    """Packed identity bitmap of the first 3 ivs (iteration.rs:198-212).

    ``bitmap = iv0 << 28 | iv1 << 14 | iv2`` with 14-bit fields; like the
    reference, values >= 2^14 overflow into neighboring fields (truncation is
    part of the contract — it is a *hash*, equality still compares full ivs,
    iteration.rs:137-149).
    """
    ivs = np.asarray(ivs, np.uint64)
    N, D = ivs.shape
    if lengths is None:
        lengths = np.full(N, D, np.int64)
    out = np.zeros(N, np.uint64)
    for i in range(min(D, HASH_IV_SLOTS)):
        shift = np.uint64((HASH_IV_SLOTS - 1 - i) * HASH_IV_BITS)
        out |= np.where(i < lengths, ivs[:, i], 0).astype(np.uint64) << shift
    return out


def point_hash(name_ids: np.ndarray, ivs: np.ndarray,
               lengths: np.ndarray | None = None) -> np.ndarray:
    """Vectorized point hash: the reference hashes (name, bitmap)
    (iteration.rs:199-210); here a 64-bit mix of the interned name id and
    :func:`iv_bitmap` — same collision semantics (ivs past the third slot and
    overflowing bits do not contribute)."""
    bm = iv_bitmap(ivs, lengths)
    h = np.asarray(name_ids, np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    h ^= bm + np.uint64(0x9E3779B97F4A7C15) + (h << np.uint64(6)) + (h >> np.uint64(2))
    return h


def dedup(name_ids: np.ndarray, ivs: np.ndarray,
          lengths: np.ndarray | None = None) -> np.ndarray:
    """Indices of the first occurrence of each distinct point, in input order.

    Equality follows ``PartialEq`` (iteration.rs:137-149): same name and same
    full iteration vector (no truncation — unlike the hash).
    """
    ivs = np.asarray(ivs, np.int64)
    N, D = ivs.shape
    if lengths is None:
        lengths = np.full(N, D, np.int64)
    mask = np.arange(D)[None, :] < lengths[:, None]
    canon = np.where(mask, ivs, np.iinfo(np.int64).min)
    rec = np.concatenate(
        [np.asarray(name_ids, np.int64)[:, None], lengths[:, None], canon], axis=1
    )
    _, first = np.unique(rec, axis=0, return_index=True)
    return np.sort(first)
