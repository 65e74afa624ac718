"""Subset sampling: estimate the histograms from a fraction of windows.

Counterpart of ``pluss/sampling.py``.  The reference declares this
capability (``Iteration``/``IterationComp`` sampled points, the C++
dispatcher's ``setStartPoint``/``getNextKChunksFrom``/``getPrevKChunksFrom``)
and never wires it; this module completes the surface on the engine's
round windows.

The sample unit is one engine window.  A numpy generator picks ``rate *
NW`` windows per nest (the JAX package's choice, so both packages walk the
same windows for a seed); each one is walked exactly from an empty carried
table, after ``context_windows`` preceding windows walked uncounted
(only their tails survive, no histogram is binned), so a reuse whose
predecessor lies in the context resolves to its true value instead of
censoring to cold.  The default context covers the nest's largest share
span.  Counts scale by ``NW / n_sampled``; ``sampled_fraction`` counts the
walked windows and their context.  ``mode="prefix"`` instead walks windows
``0..m`` as one exact chain and lets window ``m`` stand for the rest.

Each walk is the engine's ghost-merged sort window over all ``T`` thread
rows at once, one counted window (and one kernel-1 launch) at a time.
Estimates equal ``pluss.sampling.sampled_run``: integer histograms, then
float64 scaling in the JAX package's order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pluss_torch import cri, engine, mrc, obs
from pluss_torch.config import DEFAULT, NBINS, SamplerConfig
from pluss_torch.engine import (DeviceNest, SamplerResult,
                                merge_share_windows, resolve_device,
                                sort_budget, sort_window_bytes)
from pluss_torch.ops.event_hist import event_histogram
from pluss_torch.ops.reuse import share_keys, share_unique
from pluss_torch.spec import LoopNestSpec, slot_sizes


@functools.lru_cache(maxsize=64)
def _plan_cached(spec: LoopNestSpec, cfg: SamplerConfig,
                 window_accesses: int | None):
    """One plan per (spec, cfg, span).  No templates and no row-private
    tables: every sampled window walks the fresh-carry sort path."""
    return engine.plan(spec, cfg, window_accesses=window_accesses,
                       build_templates=False, build_rowpriv=False)


def _auto_context(dn: DeviceNest) -> int:
    """Context windows needed so context plus window span the nest's
    largest share span (the dominant carried-reuse length); at least 1 so
    ordinary cross-window reuses resolve too."""
    span = max((fr.ref.share_span or 0 for fr in dn.np_.refs), default=0)
    k = max(1, -(-span // dn.win_shift)) if dn.win_shift else 1
    return min(k, dn.np_.n_windows - 1)


def _window_counts(np_, cfg: SamplerConfig, nest) -> np.ndarray:
    """[T, NW] true accesses of each thread-window (the walk-cost unit),
    from the per-slot sizes the engine's clock tables use."""
    T = np_.owned.shape[0]
    slot, _ = slot_sizes(nest, np_.owned, np_.sched.trip, cfg.chunk_size)
    return slot.reshape(T, np_.n_windows, -1).sum(axis=2)


def _walk(dn: DeviceNest, w: int, last_pos: torch.Tensor, event_hist):
    """Walk window ``w`` of nest ``dn`` for every thread row against
    ``last_pos`` (advanced in place).  A counted walk returns its ``[T,
    NBINS]`` histogram and share uniques; ``event_hist=None`` (a context
    walk) bins nothing and returns None."""
    dh, ev = dn.sort_window(dn.np_.refs, dn.all_ranges, w, slice(None),
                            last_pos, event_hist)
    if dh is None:
        return None
    return dh, share_unique(share_keys(ev["reuse"], ev["share"]))


def _add_share(share_raw, part, scale: float) -> int:
    """Add one merge's counts times ``scale``; returns the unscaled mass."""
    mass = 0
    for t, d in enumerate(part):
        for v, c in d.items():
            share_raw[t][v] = share_raw[t].get(v, 0.0) + c * scale
            mass += c
    return mass


def sampled_run(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
                rate: float = 0.1, seed: int = 0,
                window_accesses: int | None = None,
                context_windows: int | None = None,
                mode: str = "uniform", *, device=None,
                _event_hist=event_histogram) -> SamplerResult:
    """Estimate the per-thread histograms from a ``rate`` fraction of
    windows, on ``device`` (default: the CUDA card).

    Returns a :class:`~pluss_torch.engine.SamplerResult` with float64
    counts; ``max_iteration_count`` is the full stream's access count and
    ``sampled_fraction`` the fraction of it walked (counted windows plus
    their context).  ``window_accesses`` sets the sample span,
    ``context_windows`` the warm-up depth (default: auto, see the module
    docstring).  ``mode``: ``"uniform"`` (random windows, each warmed by
    its own context) or ``"prefix"`` (the exact chain over windows
    ``0..m``, ``m+1 ≈ rate*NW``, with ``f(m)`` standing for the
    ``NW - m`` windows from ``m`` on; ``seed`` and ``context_windows`` do
    not apply).  ``_event_hist`` replaces kernel 1's wrapper (its plain
    version, for a cross-check on the card).

    Uniform mode's ``T x nsel`` sampled windows must fit the device's
    budget (:func:`~pluss_torch.engine.sort_budget`) as in the JAX
    package, or this raises before walking.
    """
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"sampling rate must be in (0, 1], got {rate}")
    if mode not in ("uniform", "prefix"):
        raise ValueError(f"unknown sampling mode {mode!r}")
    with obs.span("sampling.run"):
        dev = resolve_device(device)
        T = cfg.thread_num
        rng = np.random.default_rng(seed)
        hist = np.zeros((T, NBINS), np.float64)
        share_raw: list[dict] = [dict() for _ in range(T)]
        pl = _plan_cached(spec, cfg, window_accesses)
        walked = 0.0
        for ni in range(len(spec.nests)):
            dn = DeviceNest(pl, ni, dev)
            NW = dn.np_.n_windows
            carried = (T, dn.n_lines)   # an empty carried table's shape
            if mode == "prefix":
                m = min(NW - 1, max(0, round(rate * NW) - 1))
                last_pos = torch.full(carried, -1, dtype=dn.pdt, device=dev)
                outs = [_walk(dn, w, last_pos, _event_hist)
                        for w in range(m + 1)]
                dh = torch.stack([o[0] for o in outs],
                                 dim=1).cpu().numpy()
                walked += float(dh.sum())
                hist += dh[:, :m].sum(axis=1) + dh[:, m] * (NW - m)
                for lo, hi, scale in ((0, m, 1.0),
                                      (m, m + 1, float(NW - m))):
                    part = merge_share_windows(
                        [o[1][0] for o in outs[lo:hi]],
                        [o[1][1] for o in outs[lo:hi]], T)
                    walked += _add_share(share_raw, part, scale)
                continue
            warm_k = _auto_context(dn) if context_windows is None \
                else min(context_windows, NW - 1)
            nsel = max(1, round(rate * NW))
            # the JAX package walks T x nsel context-warmed windows at
            # once; its guard holds here too
            est = sort_window_bytes(dn.np_, cfg, pl.pos_dtype,
                                    dn.n_lines) * T * nsel
            limit = sort_budget(dev)
            if est > limit:
                raise RuntimeError(
                    f"sampling nest {ni}: {nsel} windows x {T} threads "
                    f"need ~{est / 2**30:.2f} GiB at once (incl. sort "
                    f"workspace), beyond the {limit / 2**30:.2f} GiB device "
                    "budget.  Lower the rate or shrink window_accesses.")
            sel = np.sort(rng.choice(NW, nsel, replace=False))
            scale = NW / nsel
            dh = torch.zeros((T, NBINS), dtype=torch.int64, device=dev)
            keys, cnts = [], []
            for w in sel.tolist():
                last_pos = torch.full(carried, -1, dtype=dn.pdt, device=dev)
                # only the real context windows: the JAX package re-walks
                # window 0 for the clamped ones, which changes no tail
                ctx = range(max(0, w - warm_k), w)
                if ctx:
                    with obs.tally_span("sampling.context"):
                        for wc in ctx:
                            _walk(dn, wc, last_pos, None)
                h, (k, c) = _walk(dn, w, last_pos, _event_hist)
                dh += h
                keys.append(k)
                cnts.append(c)
            dh = dh.cpu().numpy()
            hist += dh * scale
            # every counted access lands in exactly one bucket (event, cold
            # or share), so the unscaled masses measure the counted
            # fraction ...
            walked += float(dh.sum())
            walked += _add_share(share_raw,
                                 merge_share_windows(keys, cnts, T), scale)
            # ... and the context walks are walked work too
            if warm_k:
                counts = _window_counts(dn.np_, cfg, spec.nests[ni])
                for w in sel.tolist():
                    walked += float(counts[:, max(0, w - warm_k):w].sum())
        return SamplerResult(
            noshare_dense=hist, share_raw=share_raw, share_ratio=T - 1,
            max_iteration_count=pl.total_count,
            sampled_fraction=walked / pl.total_count if pl.total_count
            else 0.0)


def mrc_l2_error(a: np.ndarray, b: np.ndarray) -> float:
    """Relative L2 error between two MRC curves (padded to equal length)."""
    n = max(len(a), len(b))
    pa = np.pad(np.asarray(a, np.float64), (0, n - len(a)), mode="edge")
    pb = np.pad(np.asarray(b, np.float64), (0, n - len(b)), mode="edge")
    denom = float(np.linalg.norm(pb))
    return float(np.linalg.norm(pa - pb)) / denom if denom else 0.0


def _curve(res: SamplerResult, cfg: SamplerConfig) -> np.ndarray:
    return mrc.aet_mrc(cri.distribute(res.noshare_list(), res.share_list(),
                                      cfg.thread_num), cfg)


def mrc_error_table(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
                    rates=(0.05, 0.1, 0.25, 0.5, 1.0), seed: int = 0,
                    window_accesses: int | None = None,
                    context_windows: int | None = None,
                    mode: str = "uniform", *, device=None):
    """``[(rate, sampled_fraction, mrc_l2_error)]`` against the full run:
    how much of the stream must be walked for how much MRC accuracy."""
    full_curve = _curve(engine.run(spec, cfg, device=device), cfg)
    out = []
    for rate in rates:
        est = sampled_run(spec, cfg, rate, seed, window_accesses,
                          context_windows, mode, device=device)
        out.append((rate, est.sampled_fraction,
                    mrc_l2_error(_curve(est, cfg), full_curve)))
    return out
