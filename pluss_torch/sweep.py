"""Schedule sweeps: predicted miss-ratio curves across parallel configs.

The port's copy of ``pluss/sweep.py``.  PLUSS exists to answer "how will
this loop nest's cache behavior change with the parallel schedule?"
without running the program (the reference hardwires one config per
build: ``-DTHREAD_NUM=4 -DCHUNK_SIZE=4``).  Here the config is runtime
data, so the question becomes one call: sample the nest under every
(thread_num, chunk_size) candidate on ``device`` (default: the CUDA
card), run the CRI model and AET solver per config, and compare the
curves.

While point k runs on the device, a precompile thread plans point k+1
(host work and kernel builds only: ``engine.precompile`` through the
single-flight registry, so the point waits on that one plan instead of
planning twice).

Resilience: each point runs under the degradation ladder
(:func:`pluss_torch.resilience.run_resilient`) and can journal its raw
histograms to an atomic JSONL checkpoint — an interrupted multi-point
sweep resumed with ``journal=``/``resume=True`` (CLI: ``sweep --resume``)
recomputes ZERO finished points: the curve is rebuilt from the journaled
histograms through the same (deterministic, host-side) CRI + AET
pipeline.  The journal's records are the JAX package's, so either package
resumes the other's journal.  Points that degraded carry the rungs taken
in ``SweepPoint.degradations``, sharing one report surface with the static
analyzer's PL303 carried-level classifications (:func:`carried_levels`).

``device_groups`` splits the torch devices of ``device``'s type (or the
``devices`` list given, which may name one device more than once) into
groups and runs one point per group; a group of more than one device
runs its point through the sharded backend
(:func:`pluss_torch.parallel.shard_run`, under the shard ladder).  On one
card the groups clamp to one.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from pluss_torch import cri, mrc
from pluss_torch.config import SHARE_CAP, SamplerConfig
from pluss_torch.spec import LoopNestSpec


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One (config, prediction) row of a sweep."""

    cfg: SamplerConfig
    curve: np.ndarray            # miss ratio per cache size (aet_mrc)
    total_refs: int
    #: degradation-ladder rungs the point's run took ('journal' when the
    #: point was restored from a resume journal without recomputation)
    degradations: tuple = ()

    def miss_ratio_at(self, cache_lines: int) -> float:
        """Predicted miss ratio at a cache of ``cache_lines`` entries."""
        if len(self.curve) == 0:
            return 1.0
        return float(self.curve[min(cache_lines, len(self.curve) - 1)])


def _point_key(spec: LoopNestSpec, cfg: SamplerConfig) -> dict:
    """Canonical journal key of one sweep point: the full (model, machine,
    schedule) coordinate, so journals from different sweeps never alias."""
    return {"model": spec.name, "threads": cfg.thread_num,
            "chunk": cfg.chunk_size, "ds": cfg.ds, "cls": cfg.cls,
            "cache_kb": cfg.cache_kb}


def _intkeys(d: dict) -> dict:
    """JSON round-trip turns int dict keys into strings; undo it."""
    return {int(k): v for k, v in d.items()}


def _sweep_point(spec: LoopNestSpec, cfg: SamplerConfig, share_cap: int,
                 journal, resume: bool, jlock=None, device=None,
                 devices=None):
    """One sweep point: restore-from-journal or compute on ``device``,
    journal durably, and return ``(curve, refs, degradations)``.
    ``jlock`` serializes journal access when point workers run
    concurrently (each record is a single buffered write — unlocked
    concurrent appends could interleave partial lines).  ``share_cap`` is
    a label here: it is part of the CLI surface the JAX package has, and
    the port's engine has no cap.  ``devices`` (a group of more than one)
    runs the point sharded over them, under the shard ladder."""
    import contextlib

    from pluss_torch import obs
    from pluss_torch.resilience import run_resilient
    from pluss_torch.resilience.ladder import LADDER, SHARD_LADDER, _on_card

    t, cs = cfg.thread_num, cfg.chunk_size
    shard = devices is not None and len(devices) > 1
    if shard:
        device = devices[0]
    ladder = SHARD_LADDER if shard else LADDER
    # on the card the ladder stops before its CPU rung: a point the card
    # cannot run raises classified, never comes back as a host result
    rungs = tuple(r for r in ladder if r != "cpu_fallback") \
        if _on_card(device) else ladder
    key = _point_key(spec, cfg)
    lock = jlock if jlock is not None else contextlib.nullcontext()
    # one span per point, restored-from-journal or computed — the
    # per-point timings `stats` rolls up to show where a multi-config
    # sweep's wall clock actually went
    with obs.span("sweep.point", model=spec.name, threads=t, chunk=cs) as sp:
        rec = None
        if journal is not None and resume:
            with lock:
                rec = journal.get(key)
        if rec is not None:
            noshare = [_intkeys(d) for d in rec["noshare"]]
            share = [{int(r): _intkeys(h) for r, h in d.items()}
                     for d in rec["share"]]
            refs = rec["refs"]
            degradations = ("journal",) + tuple(rec.get(
                "degradations", ()))
            obs.counter_add("sweep.points_restored")
        else:
            res = run_resilient(spec, cfg, device=device, rungs=rungs,
                                **({"backend": "shard", "devices": devices}
                                   if shard else {}))
            noshare, share = res.noshare_list(), res.share_list()
            refs = res.max_iteration_count
            degradations = tuple(res.degradations)
            if journal is not None:
                with lock:
                    journal.record(key, noshare=noshare, share=share,
                                   refs=refs,
                                   degradations=list(degradations))
            obs.counter_add("sweep.points_run")
        sp.set(refs=refs, restored=rec is not None)
        ri = cri.distribute(noshare, share, t)
        return mrc.aet_mrc(ri, cfg), refs, degradations


def _precompile_point(spec: LoopNestSpec, cfg: SamplerConfig,
                      share_cap: int, device=None) -> None:
    from pluss_torch import engine, obs

    try:
        with obs.span("sweep.precompile", model=spec.name,
                      threads=cfg.thread_num, chunk=cfg.chunk_size):
            engine.precompile(spec, cfg, device=device)
        obs.counter_add("sweep.precompiles")
    except Exception:  # noqa: BLE001 — best-effort: the point itself
        # plans inline (and surfaces any real error) if this fails
        obs.counter_add("sweep.precompile_fail")


def _spawn_precompile(spec: LoopNestSpec, cfg: SamplerConfig,
                      share_cap: int, journal, resume: bool, device=None):
    """Start planning the NEXT point (host plan and kernel builds, no
    device dispatch) while the current point executes.  The single-flight
    registry makes the overlap safe: if the next point arrives while its
    plan is still in flight it waits on that one build instead of
    duplicating it.  Skipped for points a resume journal will restore
    (nothing will dispatch), and under ``PLUSS_NO_PRECOMPILE=1``."""
    import os
    import threading

    if os.environ.get("PLUSS_NO_PRECOMPILE"):
        return None
    if journal is not None and resume \
            and journal.get(_point_key(spec, cfg)) is not None:
        return None
    t = threading.Thread(target=_precompile_point,
                         args=(spec, cfg, share_cap, device),
                         name="pluss-sweep-precompile", daemon=True)
    t.start()
    return t


def sweep(spec: LoopNestSpec,
          thread_nums: Sequence[int] = (1, 2, 4, 8),
          chunk_sizes: Sequence[int] = (4,),
          base_cfg: SamplerConfig = SamplerConfig(),
          share_cap: int = SHARE_CAP,
          journal=None,
          resume: bool = False,
          device_groups: int | None = None,
          device=None, devices=None) -> list[SweepPoint]:
    """Predict the MRC of ``spec`` under each (thread_num, chunk_size), on
    ``device`` (default: the CUDA card).

    ``journal``: a :class:`pluss_torch.resilience.Journal` (or a path
    string) — every finished point's raw per-thread histograms are
    recorded there durably.  With ``resume=True``, points already
    journaled are restored instead of recomputed (the sampler run is the
    expensive part; the CRI + AET tail is deterministic host math and
    replays in milliseconds), stamped ``degradations=('journal',) +
    <original>``.

    ``device_groups``: split the devices of ``device``'s type into that
    many groups and run ONE POINT PER GROUP concurrently (a 1-device
    group pins ``engine.run`` to its device).  Points are ELASTIC: a
    point whose worker dies with a classified
    :class:`~pluss_torch.resilience.errors.PlussError` is requeued once
    onto another group (``sweep.elastic_requeues``).  Results are
    returned in canonical point order and equal the serial sweep's.  A
    group of more than one device runs its point through ``shard_run``
    over the group.  ``devices``: the list the groups split (default every
    device of ``device``'s type); it may name one device more than once.
    """
    from pluss_torch import engine
    from pluss_torch.resilience.journal import Journal

    dev = engine.resolve_device(device)
    if isinstance(journal, str):
        journal = Journal(journal)
    cfgs = [dataclasses.replace(base_cfg, thread_num=t, chunk_size=cs)
            for t in thread_nums for cs in chunk_sizes]
    if device_groups is not None and device_groups > 1 and len(cfgs) > 1:
        return _sweep_parallel(spec, cfgs, share_cap, journal, resume,
                               device_groups, dev, devices)
    out = []
    for k, cfg in enumerate(cfgs):
        # precompile phase: point k+1's plan overlaps point k's execute
        if k + 1 < len(cfgs):
            _spawn_precompile(spec, cfgs[k + 1], share_cap, journal, resume,
                              dev)
        curve, refs, degradations = _sweep_point(spec, cfg, share_cap,
                                                 journal, resume,
                                                 device=dev)
        out.append(SweepPoint(cfg, curve, refs, degradations))
    return out


def _devices_like(dev) -> list:
    """The devices of ``dev``'s type: every CUDA card, or the one host."""
    import torch

    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _sweep_parallel(spec: LoopNestSpec, cfgs, share_cap: int, journal,
                    resume: bool, device_groups: int, dev,
                    devices=None) -> list[SweepPoint]:
    """One-point-per-device-group sweep with elastic requeue (see
    :func:`sweep`)."""
    import queue
    import threading

    from pluss_torch import obs
    from pluss_torch.resilience.errors import PlussError

    import torch

    devices = [torch.device(d) for d in devices] if devices is not None \
        else _devices_like(dev)
    G = max(1, min(device_groups, len(devices), len(cfgs)))
    per = len(devices) // G
    groups = [devices[g * per:(g + 1) * per] for g in range(G)]
    jlock = threading.Lock()
    results: list = [None] * len(cfgs)
    errors: list = []
    attempts = [0] * len(cfgs)
    q: queue.Queue = queue.Queue()
    for i in range(len(cfgs)):
        q.put(i)

    def worker(gi: int) -> None:
        group = groups[gi]
        while True:
            try:
                i = q.get_nowait()
            except queue.Empty:
                return
            attempts[i] += 1
            try:
                results[i] = _sweep_point(spec, cfgs[i], share_cap,
                                          journal, resume, jlock,
                                          device=group[0], devices=group)
            except PlussError as e:
                if attempts[i] <= 1:
                    # elastic recovery: the point goes back on the queue
                    # for ANOTHER group's worker (this one exits — its
                    # device may be the sick one); finished points stay
                    # finished, journaled or in results[]
                    obs.counter_add("sweep.elastic_requeues")
                    obs.event("sweep.point_requeued", model=spec.name,
                              threads=cfgs[i].thread_num,
                              chunk=cfgs[i].chunk_size, error=type(e).__name__)
                    q.put(i)
                    return
                errors.append(e)
                return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                return

    threads = [threading.Thread(target=worker, args=(gi,), daemon=True,
                                name=f"pluss-sweep-{gi}")
               for gi in range(G)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    missing = [i for i, r in enumerate(results) if r is None]
    if missing and not errors:
        # every worker that could serve a requeued point has exited:
        # finish the stragglers inline (the coordinator thread is the
        # elastic backstop)
        for i in missing:
            results[i] = _sweep_point(spec, cfgs[i], share_cap, journal,
                                      resume, jlock, device=dev)
        missing = []
    if errors:
        raise errors[0]
    return [SweepPoint(cfg, *res) for cfg, res in zip(cfgs, results)]


def table(points: Iterable[SweepPoint], cache_lines: Sequence[int]) -> str:
    """Plain-text comparison table: one row per config, one column per cache
    size (in lines), values = predicted miss ratio.  A ``degraded`` column
    appears only when some point actually degraded (or resumed), so the
    clean-run format stays byte-stable for diffing."""
    points = list(points)
    with_deg = any(p.degradations for p in points)
    heads = ["threads", "chunk"] + [f"mr@{c}" for c in cache_lines]
    if with_deg:
        heads.append("degraded")
    rows = [heads]
    for p in points:
        row = [str(p.cfg.thread_num), str(p.cfg.chunk_size)] \
            + [f"{p.miss_ratio_at(c):.4f}" for c in cache_lines]
        if with_deg:
            row.append(",".join(p.degradations) or "-")
        rows.append(row)
    widths = [max(len(r[i]) for r in rows) for i in range(len(heads))]
    return "\n".join(
        "  ".join(v.rjust(w) for v, w in zip(r, widths)) for r in rows
    )


def schedule_analysis(spec: LoopNestSpec,
                      points: Iterable[SweepPoint]) -> str:
    """Schedule-aware analysis block for the sweep report: the spec's
    static footprint (schedule-independent: the union over threads is the
    global distinct-line count) and, per swept config, the false-sharing
    verdict under THAT schedule — the quantity that actually changes with
    (threads, chunk), which is the whole point of sweeping them.

    Built from the analyzer's own passes (not a re-derivation), with the
    expensive schedule-blind profiling shared across all points."""
    from pluss_torch.analysis import Severity, deps, falseshare, footprint

    points = list(points)
    if not points:
        return ""
    fp = footprint.footprints(spec, points[0].cfg)
    ana = deps.analyze(spec)
    lines = [
        "  footprint: %d lines (%s); %d accesses" % (
            fp.total,
            ", ".join(f"{a}={int(n)}"
                      for a, n in zip(fp.arrays, fp.per_array)),
            fp.accesses),
    ]
    for p in points:
        diags = falseshare.check(spec, p.cfg, analysis=ana)
        warns = sorted({f"{d.code}:{d.array}" for d in diags
                        if d.severity is Severity.WARNING})
        lines.append(
            f"  threads={p.cfg.thread_num} chunk={p.cfg.chunk_size}: "
            f"false sharing {', '.join(warns) if warns else 'none'}")
    return "schedule-aware analysis:\n" + "\n".join(lines)


def prediction_block(spec: LoopNestSpec,
                     points: Iterable[SweepPoint]) -> str:
    """Static-prediction block for the sweep report: per swept config,
    the symbolic reuse-interval derivation's verdict (:mod:`pluss_torch.
    analysis.ri`) — method taken, exact plateau location, and whether it
    lands inside the heuristic bracket.  The sampled table above and
    this block predict the same quantity from independent machinery, so
    reading them together IS the cross-check."""
    from pluss_torch.analysis import ri

    points = list(points)
    if not points:
        return ""
    lines = []
    for p in points:
        rep = ri.predict(spec, p.cfg)
        pred = rep.prediction
        head = (f"  threads={p.cfg.thread_num} "
                f"chunk={p.cfg.chunk_size}: ")
        if not pred.derivable:
            codes = ",".join(sorted({d.code for d in pred.diagnostics}))
            lines.append(head + f"not derivable ({codes})")
            continue
        where = "unreachable" if rep.plateau is None else (
            f"{rep.plateau} "
            + ("inside" if rep.plateau_in_bracket else "OUTSIDE")
            + f" [{rep.bracket.c_lo}, {rep.bracket.c_hi}]")
        lines.append(head + f"{pred.method}, exact plateau {where}")
    return "static prediction (PL7xx):\n" + "\n".join(lines)


def hierarchy_block(spec: LoopNestSpec,
                    points: Iterable[SweepPoint]) -> str:
    """AET-exact hierarchy read-offs for the sweep report: per swept
    config, every declared cache level's miss ratio priced off the same
    derived histogram (:mod:`pluss_torch.model.hierarchy`; PLUSS_CACHE_LEVELS
    / PLUSS_CACHE_ASSOC / PLUSS_CACHE_POLICY declare the hierarchy).
    Schedules the predictor refuses are skipped, not approximated."""
    from pluss_torch.analysis import ri
    from pluss_torch.model import hierarchy as hier_mod

    points = list(points)
    if not points:
        return ""
    hier = hier_mod.HierarchyConfig.from_env()
    lines = []
    for p in points:
        rep = ri.predict(spec, p.cfg)
        if rep.rihist is None:
            continue
        doc = hier_mod.hierarchy_doc(rep.rihist, p.cfg, hier)
        levels = " | ".join(
            f"{lv['size_kb']}KB {lv['miss_ratio']:.4g}"
            for lv in doc["levels"])
        plat = f" plateau c={doc['plateau_c']}" \
            if doc["plateau_c"] is not None else ""
        lines.append(f"  threads={p.cfg.thread_num} "
                     f"chunk={p.cfg.chunk_size}: {levels} "
                     f"[{doc['levels'][0]['model']}]{plat}")
    if not lines:
        return ""
    return "hierarchy:\n" + "\n".join(lines)


def tuned_block(spec: LoopNestSpec,
                points: Iterable[SweepPoint]) -> str:
    """Tuned-vs-actual block for the sweep report: one
    :func:`pluss_torch.analysis.tune.tune` pass over exactly the swept
    (threads, chunk) axes, then per sampled point its own sampled miss
    ratio at the tuning LLC next to the proof-carrying winner's
    predicted score — so the sweep table shows, per schedule, how far it
    sits from the statically proven best.  A tune refusal (PL903) prints
    the typed verdict instead of numbers."""
    from pluss_torch.analysis import tune as tune_mod

    points = list(points)
    if not points:
        return ""
    threads = tuple(sorted({p.cfg.thread_num for p in points}))
    chunks = tuple(sorted({p.cfg.chunk_size for p in points}))
    rep = tune_mod.tune(spec, base_cfg=points[0].cfg,
                        candidates=tune_mod.space(threads, chunks))
    v = rep.diagnostics[0]
    head = (f"tuned schedule (PL9xx, {rep.target_kb} KB LLC):\n"
            f"  [{v.code}] {v.message}")
    if rep.winner is None:
        return head
    w = rep.winner
    lines = [head]
    for p in points:
        sampled = p.miss_ratio_at(rep.target_entries)
        mark = " <- tuned winner" if (
            p.cfg.thread_num == w.candidate.threads
            and p.cfg.chunk_size == w.candidate.chunk) else ""
        lines.append(
            f"  threads={p.cfg.thread_num} chunk={p.cfg.chunk_size}: "
            f"sampled {sampled:.4g} vs tuned best {w.score:.4g} "
            f"(delta {sampled - w.score:+.4g}){mark}")
    return "\n".join(lines)


def transform_block(spec: LoopNestSpec,
                    points: Iterable[SweepPoint]) -> str:
    """Transform-space block for the sweep report: one
    :func:`pluss_torch.analysis.transform.search_transforms` pass over exactly
    the swept (threads, chunk) axes, reporting the best proven-legal
    (transform, schedule) pair and its static MRC delta against the
    untransformed winner — so the sweep table shows what a code-shape
    change would buy on top of the schedule it already prices.  A tune
    refusal prints the typed verdict instead of numbers."""
    from pluss_torch.analysis import transform as tf
    from pluss_torch.analysis import tune as tune_mod

    points = list(points)
    if not points:
        return ""
    threads = tuple(sorted({p.cfg.thread_num for p in points}))
    chunks = tuple(sorted({p.cfg.chunk_size for p in points}))
    rep = tf.search_transforms(
        spec, base_cfg=points[0].cfg,
        candidates=tune_mod.space(threads, chunks))
    lines = [f"transform search (PL95x, {rep.target_kb} KB LLC):"]
    for d in rep.diagnostics:
        lines.append(f"  [{d.code}] {d.message}")
    if rep.best is not None:
        lines.append(
            f"  best: {rep.best.transform.label()} + "
            f"{rep.best.tune.winner.candidate.label()} predicts "
            f"{rep.best.score():.4g} (delta {rep.delta:+.4g} vs "
            "untransformed winner)")
    return "\n".join(lines)


def carried_levels(spec: LoopNestSpec) -> str:
    """The static analyzer's PL303 carried-level classifications as a
    compact report block: one line per annotated
    reference, naming the loop level that carries its reuse — the same
    quantity the dynamic share split measures, so the sweep report shows
    the analytic prediction next to the sampled numbers.

    Built from the analyzer's own PL303 diagnostics (not a re-derivation)
    so this report can never drift from what ``lint`` prints."""
    from pluss_torch.analysis import deps

    lines = [
        f"  {d.ref} [{d.array}] {d.path}: {d.message}"
        for d in deps.check(spec) if d.code == "PL303"
    ]
    if not lines:
        return ""
    return "carried levels (PL303):\n" + "\n".join(lines)
