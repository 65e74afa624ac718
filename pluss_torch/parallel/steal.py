"""Host-side work-stealing chunk dispatch for the sharded backend.

The port's copy of ``pluss/parallel/steal.py``, with its semantics: the
static shard split (``S = ceil(n_windows / D)`` windows per device) makes
every device wait for the slowest one, and a quad nest's late windows
carry up to ~2x the sort volume of its early ones.  Window results
interact only at the boundary merge (heads of chunk ``k`` resolve
against the running max over earlier chunks' tails,
:mod:`pluss_torch.parallel.shard`), so any assignment of chunks to
workers gives the same merged result, and the assignment can be dynamic:

- :class:`StealDispatcher`: chunks known up front (``shard_run``); each
  worker owns a contiguous block deque (stream locality), and an idle
  worker steals the tail half of the fullest victim's deque.  Outputs are
  keyed by chunk id and merged in canonical stream order, so steal-order
  permutations are bit-identical by construction.
- :class:`QueueDispatcher`: chunks produced over time (the streamed
  sharded replay, fed by a sequential reader and compactor); a bounded
  queue with one consumer thread per worker; a pull of a chunk the static
  split would have homed elsewhere counts as a steal.

Workers are host threads.  These classes only schedule: the caller's
``run_chunk`` places the chunk on its worker's device (on a CUDA device,
under that worker's own stream) and fetches its results to the host
before returning, so a worker holds one chunk on its device at a time.
"""

from __future__ import annotations

import collections
import random
import threading
import time


class StealDispatcher:
    """Per-worker deques + steal-half-on-idle over a fixed chunk list.

    ``run_chunk(worker_idx, chunk_id)`` executes one chunk on worker
    ``worker_idx``'s device and stores its own result (keyed by
    ``chunk_id``); this class only schedules.  ``seed`` permutes the
    initial block deal (a rotation) and victim tie-breaks — it changes
    WHICH device computes a chunk, never the merged result, which is
    exactly what the determinism tests vary.
    """

    def __init__(self, n_chunks: int, n_workers: int, run_chunk,
                 seed: int = 0):
        if n_chunks < 0 or n_workers < 1:
            raise ValueError(f"bad dispatcher geometry: {n_chunks} chunks, "
                             f"{n_workers} workers")
        self.n_chunks = n_chunks
        self.n_workers = n_workers
        self.run_chunk = run_chunk
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._deques: list[collections.deque] = [
            collections.deque() for _ in range(n_workers)]
        # contiguous block deal (stream locality), rotated by the seed so
        # different seeds genuinely permute the chunk->device map
        rot = self._rng.randrange(n_workers) if n_workers > 1 else 0
        for ci in range(n_chunks):
            self._deques[(ci * n_workers // max(1, n_chunks) + rot)
                         % n_workers].append(ci)
        self.steals = 0
        self.busy_s = [0.0] * n_workers
        self.chunks_run = [0] * n_workers
        self.ran_by: dict[int, int] = {}   # chunk id -> worker that ran it
        self._errors: list[BaseException] = []

    def _next(self, wi: int) -> int | None:
        with self._lock:
            dq = self._deques[wi]
            if not dq:
                # steal HALF of the fullest victim's tail (tail = the
                # chunks the victim would reach last); rng breaks ties so
                # seeds explore different schedules
                best = max(len(d) for d in self._deques)
                if best == 0:
                    return None
                cands = [j for j, d in enumerate(self._deques)
                         if len(d) == best and j != wi]
                if not cands:
                    return None
                vd = self._deques[self._rng.choice(cands)]
                take = (len(vd) + 1) // 2
                grabbed = [vd.pop() for _ in range(take)]
                grabbed.reverse()
                dq.extend(grabbed)
                self.steals += 1
            return dq.popleft()

    def _worker(self, wi: int) -> None:
        while True:
            if self._errors:
                return   # fail fast: someone else's chunk already died
            ci = self._next(wi)
            if ci is None:
                return
            t0 = time.perf_counter()
            try:
                self.run_chunk(wi, ci)
            except BaseException as e:  # noqa: BLE001 — re-raised in run()
                with self._lock:
                    self._errors.append(e)
                return
            with self._lock:
                self.busy_s[wi] += time.perf_counter() - t0
                self.chunks_run[wi] += 1
                self.ran_by[ci] = wi

    def run(self) -> dict:
        """Dispatch every chunk; returns schedule stats.  Re-raises the
        first worker error after the surviving workers drain."""
        t0 = time.perf_counter()
        if self.n_workers == 1 or self.n_chunks <= 1:
            # degenerate shapes run inline (no thread overhead)
            self._worker(0)
        else:
            threads = [threading.Thread(target=self._worker, args=(wi,),
                                        daemon=True,
                                        name=f"pluss-steal-{wi}")
                       for wi in range(self.n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if self._errors:
            raise self._errors[0]
        wall = max(time.perf_counter() - t0, 1e-9)
        return {
            "steals": self.steals,
            "chunks": self.n_chunks,
            "wall_s": wall,
            "busy_s": list(self.busy_s),
            "busy_frac": [min(1.0, b / wall) for b in self.busy_s],
            "chunks_per_worker": list(self.chunks_run),
            "ran_by": dict(self.ran_by),
        }


class QueueDispatcher:
    """Bounded-queue dispatch for chunks PRODUCED over time.

    The streamed sharded replay's chunks come out of a sequential
    reader+compactor (stream-order-stateful, so production order is
    fixed); per-device consumer threads pull the next produced chunk —
    work-conserving by construction.  A pull of a chunk whose static
    home (``chunk_id * n_workers // n_chunks``) is a different device
    counts as a steal, so the telemetry records how much rebalancing
    the dynamic dispatch actually did.
    """

    _DONE = object()

    def __init__(self, n_workers: int, run_chunk, depth: int = 2):
        import queue

        if n_workers < 1 or depth < 1:
            raise ValueError(f"bad dispatcher geometry: {n_workers} "
                             f"workers, depth {depth}")
        self.n_workers = n_workers
        self.run_chunk = run_chunk
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self.steals = 0
        self.chunks = 0
        self.busy_s = [0.0] * n_workers
        self.chunks_run = [0] * n_workers
        self._errors: list[BaseException] = []

    def _worker(self, wi: int, n_chunks: int) -> None:
        while True:
            item = self._q.get()
            if item is self._DONE:
                self._q.put(self._DONE)   # pass the sentinel on
                return
            ci, payload = item
            if self._errors:
                continue   # drain mode: keep the producer unblocked
            t0 = time.perf_counter()
            try:
                self.run_chunk(wi, ci, payload)
            except BaseException as e:  # noqa: BLE001 — re-raised in run()
                with self._lock:
                    self._errors.append(e)
                continue
            with self._lock:
                self.busy_s[wi] += time.perf_counter() - t0
                self.chunks_run[wi] += 1
                if n_chunks and ci * self.n_workers // n_chunks != wi:
                    self.steals += 1

    def run(self, produce, n_chunks: int) -> dict:
        """Drain ``produce`` (an iterator of ``(chunk_id, payload)``)
        through the worker pool.  Producer exceptions re-raise here after
        the workers stop; worker exceptions stop the producer."""
        t0 = time.perf_counter()
        threads = [threading.Thread(target=self._worker,
                                    args=(wi, n_chunks), daemon=True,
                                    name=f"pluss-qsteal-{wi}")
                   for wi in range(self.n_workers)]
        for t in threads:
            t.start()
        produce_err: BaseException | None = None
        try:
            for item in produce:
                if self._errors:
                    break
                self._q.put(item)
                self.chunks += 1
        except BaseException as e:  # noqa: BLE001 — re-raised below
            produce_err = e
        self._q.put(self._DONE)
        for t in threads:
            t.join()
        if produce_err is not None:
            raise produce_err
        if self._errors:
            raise self._errors[0]
        wall = max(time.perf_counter() - t0, 1e-9)
        return {
            "steals": self.steals,
            "chunks": self.chunks,
            "wall_s": wall,
            "busy_s": list(self.busy_s),
            "busy_frac": [min(1.0, b / wall) for b in self.busy_s],
            "chunks_per_worker": list(self.chunks_run),
        }
