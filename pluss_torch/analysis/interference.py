"""Cross-nest co-tenancy interference: static composed-MRC prediction.

The port's copy of ``pluss/analysis/interference.py``.

The CRI model (PAPER.md §0, :mod:`pluss_torch.cri`) dilates a THREAD-LOCAL
reuse of length n by the other threads' interleaved accesses with
k ~ NegativeBinomial(r=n, p=1/T): every thread owns a 1/T share of the
merged access stream.  Nothing in that derivation needs the co-runners
to be the SAME program — it needs each runner's share of the stream.
This module generalizes the dilation from T identical threads of one
nest to K co-scheduled workloads with heterogeneous access rates — the
multi-tenant cache scenario every coalesced `cli serve` dispatch
creates — and reads each workload's DEGRADED miss-ratio curve off the
merged stream's AET clock:

1. **Composition** (:func:`compose`): thread i of workload w owns
   ``p_w = (rate_w / T_w) / sum_k rate_k`` of the merged stream
   (``rate_w`` derived statically from the symbolic prediction's
   access counts, overridable).  Each workload's thread-local
   histograms are dilated by :func:`pluss_torch.cri.nbd_dilate_p` at ``p_w``
   — the racetrack share split keeps its WORKLOAD-LOCAL racer count
   (disjoint address spaces: co-tenants dilate each other's reuses but
   never consume each other's shared values).  K=1 reduces to
   ``cri.distribute`` exactly (p = 1/T).
2. **Read-off**: the merged histogram's AET eviction times t*(c)
   (:func:`pluss_torch.mrc.aet_times`) are the shared cache's clock; workload
   w's degraded miss ratio at size c is ITS survival at the MERGED
   stream's t*(c) (:func:`pluss_torch.mrc.survival_at`).
3. **Verdicts**: PL801 (severe: predicted miss-ratio inflation above
   ``PLUSS_INTERFERENCE_THRESHOLD`` at the declared cache size), PL802
   (benign co-tenancy, inflation proven below threshold), PL803 (typed
   refusal — a workload outside the composition contract is never
   silently approximated).
4. **Oracle** (:func:`oracle_mrcs`): an interleaved schedule-simulation
   twin in the falseshare.py tradition — per-thread line-id streams
   walked straight off the spec, a deterministic proportional-fair
   virtual-time interleave weighted by each thread's stream share, and
   EXACT LRU stack distances (Bennett–Kruskal) on the merged stream.
   `cli cotenancy --check` pins the composed prediction against it at
   small n.

Like every pass in :mod:`pluss_torch.analysis`, this is pure host math on
tiny histograms — zero device dispatches.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pluss_torch import cri
from pluss_torch import mrc as mrc_mod
from pluss_torch.analysis import ri as ri_mod
from pluss_torch.analysis.diagnostics import Diagnostic, Severity
from pluss_torch.config import DEFAULT, NBD_CUTOFF_COEF, SamplerConfig
from pluss_torch.sched import ChunkSchedule
from pluss_torch.spec import LoopNestSpec, Ref
from pluss_torch.utils.envknob import env_float

#: PL801/PL802 decision bar: absolute miss-ratio inflation at the
#: declared cache size (PLUSS_INTERFERENCE_THRESHOLD overrides)
DEFAULT_THRESHOLD = 0.05

#: model-vs-oracle acceptance at small n.  The NBD interleave model is a
#: probabilistic approximation of a deterministic schedule AND the
#: thread-local histograms are log2-binned, so at n=16 (40-90-entry
#: curves) even the SOLO model sits 0.2-0.7 max-abs from an exact
#: simulation at the coarse small-c bins.  The meaningful pins, tuned
#: against the 7-pair x T in {1,2,4} registry sweep: the mean absolute
#: error over the curve, the agreement at the curve's large-cache end
#: (where every workload must reach its compulsory floor), and — the
#: composition-specific bound — the composed curve's max error may not
#: exceed the solo model's own oracle error by more than a margin: the
#: cross-nest composition must not ADD model error.
ORACLE_MAE_EPS = 0.25
ORACLE_EDGE_EPS = 0.10
ORACLE_MAX_MARGIN = 0.35


def interference_threshold() -> float:
    return env_float("PLUSS_INTERFERENCE_THRESHOLD", DEFAULT_THRESHOLD,
                     minimum=0.0)


@dataclasses.dataclass(frozen=True)
class WorkloadInput:
    """One co-scheduled workload: its thread-local histograms (the
    exact ``SamplerResult.noshare_list()``/``share_list()`` shapes, from
    either a static prediction or a sampled run), schedule config, and
    access rate (merged-stream weight; accesses per unit time)."""

    name: str
    noshare: list[dict]
    share: list[dict]
    cfg: SamplerConfig
    rate: float
    accesses: int
    spec: LoopNestSpec | None = None  # needed only by the oracle


@dataclasses.dataclass(frozen=True)
class WorkloadVerdict:
    name: str
    p: float                 # per-thread merged-stream ownership share
    solo_mr: float           # miss ratio alone at the declared cache
    degraded_mr: float       # miss ratio co-scheduled, same cache
    inflation: float         # degraded - solo (absolute)
    code: str                # PL801 | PL802


@dataclasses.dataclass
class CotenancyReport:
    workloads: tuple[str, ...]
    cache_kb: int
    threshold: float
    verdicts: list[WorkloadVerdict]
    solo_curves: list[np.ndarray]
    degraded_curves: list[np.ndarray]
    composed: list[dict]     # per-workload merged-clock histograms
    merged: dict             # their key-wise sum: the shared stream
    diagnostics: list[Diagnostic]

    @property
    def refused(self) -> bool:
        return any(d.code == "PL803" for d in self.diagnostics)

    def doc(self) -> dict:
        return {
            "workloads": list(self.workloads),
            "cache_kb": self.cache_kb,
            "threshold": self.threshold,
            "verdicts": [dataclasses.asdict(v) for v in self.verdicts],
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "degraded_mrc": [
                [[int(c), float(m)] for c, m in mrc_mod.dedup_lines(curve)]
                for curve in self.degraded_curves
            ],
        }


def distribute_p(noshare: list[dict], share: list[dict],
                 p: float) -> dict:
    """Heterogeneous-rate ``cri.distribute``: dilate one workload's
    thread-local histograms into merged-stream time, with every foreign
    access (same-workload sibling threads AND co-tenant workloads)
    charged through the single ownership share ``p``.  Same sorted
    deterministic accumulation order as the solo pass."""
    rihist: dict = {}
    for k, v in sorted(cri.merge(noshare).items()):
        if k < 0:
            cri.histogram_update(rihist, k, v)
            continue
        if p < 1.0:
            keys, pmf = cri.nbd_dilate_p(p, k)
            for kk, vv in zip(keys, pmf):
                cri.histogram_update(rihist, int(kk), v * float(vv))
        else:
            cri.histogram_update(rihist, k, v)
    merged: dict[int, dict] = {}
    for h in share:
        for n_key, hist in h.items():
            m = merged.setdefault(n_key, {})
            for r, c in hist.items():
                m[r] = m.get(r, 0.0) + c
    cut = NBD_CUTOFF_COEF * (1.0 - p)
    for n_key in sorted(merged):
        hist = merged[n_key]
        n = float(n_key)
        if p >= 1.0:
            for r in sorted(hist):
                cri.histogram_update(rihist, r, hist[r])
            continue
        items = sorted(hist.items())
        rs = np.fromiter((k for k, _ in items), np.int64, len(items))
        cs = np.fromiter((v for _, v in items), np.float64, len(items))
        big = rs >= cut
        ri_parts = [np.rint(rs[big] / p).astype(np.int64)]
        w_parts = [cs[big]]
        for r, c in zip(rs[~big].tolist(), cs[~big].tolist()):
            keys, pmf = cri.nbd_dilate_p(p, r)
            ri_parts.append(keys)
            w_parts.append(c * pmf)
        rivals = np.concatenate(ri_parts)
        w = np.concatenate(w_parts)
        if rivals.size:
            cri._racetrack_emit(rivals, w, n, rihist)
    return rihist


def from_models(names: list[str], cfg: SamplerConfig = DEFAULT,
                n: int = 16,
                rates: list[float] | None = None
                ) -> tuple[list[WorkloadInput], list[Diagnostic]]:
    """Build workload inputs from registry models via the static
    predictor — zero device dispatches.  A workload the predictor
    refuses (PL701/PL702) becomes a PL803 refusal here: composing an
    approximated histogram would be a silent lie about a pair."""
    from pluss_torch.models import REGISTRY

    inputs: list[WorkloadInput] = []
    diags: list[Diagnostic] = []
    for i, name in enumerate(names):
        spec = REGISTRY[name](n)
        pred = ri_mod.derive(spec, cfg)
        if not pred.derivable:
            why = ", ".join(sorted({d.code for d in pred.diagnostics
                                    if d.code in ("PL701", "PL702")}))
            diags.append(Diagnostic(
                "PL803", Severity.WARNING,
                f"workload {name!r} is outside the composition contract: "
                f"not statically derivable ({why or 'no histogram'})",
                model=name))
            continue
        rate = float(rates[i]) if rates is not None else float(pred.accesses)
        if rate <= 0.0:
            diags.append(Diagnostic(
                "PL803", Severity.WARNING,
                f"workload {name!r} has a non-positive access rate "
                f"({rate:g}); the ownership share is undefined",
                model=name))
            continue
        inputs.append(WorkloadInput(name, pred.noshare, pred.share, cfg,
                                    rate, int(pred.accesses), spec=spec))
    return inputs, diags


def compose(inputs: list[WorkloadInput],
            cfg: SamplerConfig = DEFAULT,
            threshold: float | None = None) -> CotenancyReport:
    """The cross-nest CRI composition pass over K >= 2 workloads."""
    if len(inputs) < 2:
        raise ValueError(f"co-tenancy needs >= 2 workloads, got "
                         f"{len(inputs)}")
    threshold = interference_threshold() if threshold is None \
        else float(threshold)
    names = tuple(w.name for w in inputs)
    total_rate = sum(w.rate for w in inputs)
    diags: list[Diagnostic] = []
    ps = [(w.rate / w.cfg.thread_num) / total_rate for w in inputs]
    composed = [distribute_p(w.noshare, w.share, p)
                for w, p in zip(inputs, ps)]
    merged = cri.merge(composed)
    times = mrc_mod.aet_times(merged, cfg)
    solo_curves, degraded_curves, verdicts = [], [], []
    for w, p, h in zip(inputs, ps, composed):
        solo = mrc_mod.aet_mrc(
            cri.distribute(w.noshare, w.share, w.cfg.thread_num), cfg)
        degraded = mrc_mod.survival_at(h, times)
        solo_curves.append(solo)
        degraded_curves.append(degraded)
        c = min(cfg.aet_cache_entries, len(solo) - 1, len(degraded) - 1)
        solo_mr = float(solo[c])
        deg_mr = float(degraded[min(c, len(degraded) - 1)])
        inflation = deg_mr - solo_mr
        code = "PL801" if inflation > threshold else "PL802"
        verdicts.append(WorkloadVerdict(w.name, p, solo_mr, deg_mr,
                                        inflation, code))
        if code == "PL801":
            diags.append(Diagnostic(
                "PL801", Severity.WARNING,
                f"severe interference on {w.name!r} co-scheduled with "
                f"{', '.join(x for x in names if x != w.name)}: miss "
                f"ratio {solo_mr:.4g} -> {deg_mr:.4g} "
                f"(+{inflation:.4g} > {threshold:g}) at "
                f"{cfg.cache_kb} KB", model=w.name))
        else:
            diags.append(Diagnostic(
                "PL802", Severity.INFO,
                f"benign co-tenancy for {w.name!r}: miss-ratio inflation "
                f"{inflation:.4g} <= {threshold:g} at {cfg.cache_kb} KB",
                model=w.name))
    return CotenancyReport(names, cfg.cache_kb, threshold, verdicts,
                           solo_curves, degraded_curves, composed, merged,
                           diags)


def analyze_models(names: list[str], cfg: SamplerConfig = DEFAULT,
                   n: int = 16,
                   rates: list[float] | None = None
                   ) -> CotenancyReport:
    """`cli cotenancy`'s whole pipeline: derive -> compose -> verdict.
    A refused workload yields a report whose diagnostics carry PL803 and
    whose curves cover only the composable survivors (still >= 2, else
    the report is pure refusal)."""
    inputs, refusals = from_models(names, cfg, n, rates)
    if len(inputs) < 2:
        return CotenancyReport(tuple(names), cfg.cache_kb,
                               interference_threshold(), [], [], [], [],
                               {}, refusals)
    rep = compose(inputs, cfg)
    rep.diagnostics = refusals + rep.diagnostics
    return rep


# ---------------------------------------------------------------------------
# interleaved schedule-simulation oracle (the numpy twin `--check` trusts)


def thread_line_streams(spec: LoopNestSpec,
                        cfg: SamplerConfig) -> list[np.ndarray]:
    """Per-thread cache-line access streams, walked straight off the
    spec with the engine's chunk schedule — the same walk the
    tests/oracle.py sampler performs, recording the touched (array,
    line) sequence instead of reuse histograms."""
    line_ids: dict[tuple[str, int], int] = {}
    streams: list[list[int]] = [[] for _ in range(cfg.thread_num)]

    def lid(array: str, line: int) -> int:
        key = (array, line)
        v = line_ids.get(key)
        if v is None:
            v = line_ids[key] = len(line_ids)
        return v

    def walk(tid: int, item, ivs: list[int], pnest) -> None:
        if isinstance(item, Ref):
            addr = item.addr_base + sum(c * ivs[d]
                                        for d, c in item.addr_terms)
            streams[tid].append(lid(item.array,
                                    addr * cfg.ds // cfg.cls))
            return
        trip, start = item.trip, item.start
        if item.bound_coef is not None or item.start_coef:
            pstart, pstep = pnest
            k0 = (ivs[0] - pstart) // pstep
            if item.bound_coef is not None:
                a, b = item.bound_coef
                ref_idx = k0 if item.bound_level == 0 \
                    else ivs[item.bound_level]
                trip = a + b * ref_idx
            start = start + item.start_coef * k0
        for i in range(trip):
            v = start + i * item.step
            for b in item.body:
                walk(tid, b, ivs + [v], pnest)

    for nest in spec.nests:
        pnest = (nest.start, nest.step)
        sched = ChunkSchedule(cfg.chunk_size, nest.trip, nest.start,
                              nest.step, cfg.thread_num)
        for tid in range(cfg.thread_num):
            for cid in sched.chunks_of_thread(tid):
                b0, e0 = sched.chunk_index_range(cid)
                for i in range(b0, e0):
                    v = sched.start + i * sched.step
                    for b in nest.body:
                        walk(tid, b, [v], pnest)
    return [np.asarray(s, np.int64) for s in streams]


def _interleave(streams: list[tuple[int, float, np.ndarray]]
                ) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic proportional-fair merge: the j-th access of a
    stream with weight u lands at virtual time (j+1)/u; ties break by
    stream order.  Returns (merged line ids, merged workload ids)."""
    times, lines, wids, seqs, sids = [], [], [], [], []
    for si, (wid, weight, s) in enumerate(streams):
        if not s.size:
            continue
        times.append((np.arange(1, s.size + 1, dtype=np.float64)) / weight)
        lines.append(s)
        wids.append(np.full(s.size, wid, np.int64))
        seqs.append(np.arange(s.size, dtype=np.int64))
        sids.append(np.full(s.size, si, np.int64))
    t = np.concatenate(times)
    order = np.lexsort((np.concatenate(seqs), np.concatenate(sids), t))
    return np.concatenate(lines)[order], np.concatenate(wids)[order]


def _stack_distances(lines: np.ndarray) -> np.ndarray:
    """Exact LRU stack depths (Bennett–Kruskal, Fenwick tree): out[i] is
    the stack depth of access i's line (1 = most recent), or 0 for a
    cold miss.  A hit in a cache of size c is depth <= c."""
    n = lines.size
    bit = np.zeros(n + 1, np.int64)

    def add(i: int, v: int) -> None:
        i += 1
        while i <= n:
            bit[i] += v
            i += i & (-i)

    def prefix(i: int) -> int:       # sum of [0, i]
        i += 1
        s = 0
        while i > 0:
            s += bit[i]
            i -= i & (-i)
        return s

    last: dict[int, int] = {}
    out = np.zeros(n, np.int64)
    for i in range(n):
        ln = int(lines[i])
        j = last.get(ln)
        if j is not None:
            # distinct lines with last occurrence in (j, i-1], + itself
            out[i] = prefix(i - 1) - prefix(j) + 1
            add(j, -1)
        last[ln] = i
        add(i, 1)
    return out


def oracle_mrcs(inputs: list[WorkloadInput],
                cfg: SamplerConfig = DEFAULT) -> list[np.ndarray]:
    """Per-workload exact-LRU MRCs of the interleaved merged stream.
    Workload line ids are namespaced (disjoint address spaces, the same
    contract the composition assumes); curve index is cache size in
    lines, curve length capped like :func:`pluss_torch.mrc.aet_mrc`."""
    streams: list[tuple[int, float, np.ndarray]] = []
    offset = 0
    for wi, w in enumerate(inputs):
        if w.spec is None:
            raise ValueError(f"oracle needs specs; workload {w.name!r} "
                             "has none")
        per_tid = thread_line_streams(w.spec, w.cfg)
        space = max((int(s.max()) + 1 for s in per_tid if s.size),
                    default=0)
        for s in per_tid:
            streams.append((wi, w.rate / w.cfg.thread_num, s + offset))
        offset += space
    lines, wids = _interleave(streams)
    depth = _stack_distances(lines)
    out: list[np.ndarray] = []
    for wi, w in enumerate(inputs):
        mine = depth[wids == wi]
        total = float(mine.size)
        cold = float((mine == 0).sum())
        hot = mine[mine > 0]
        c_max = min(int(hot.max(initial=0)), cfg.aet_cache_entries)
        hist = np.bincount(hot, minlength=c_max + 1)[:c_max + 1]
        # miss at size c <=> depth > c (cold misses everywhere)
        deeper = float(hot.size) - np.cumsum(hist, dtype=np.float64)
        curve = (cold + deeper) / (total or 1.0)
        out.append(curve)
    return out


def check_against_oracle(report: CotenancyReport,
                         inputs: list[WorkloadInput],
                         cfg: SamplerConfig = DEFAULT
                         ) -> tuple[bool, dict]:
    """``cli cotenancy --check``: composed per-workload curves against
    the schedule-simulation oracle, three pins per workload (see the
    ORACLE_* constants): curve MAE, large-cache-end agreement, and the
    no-added-error bound vs the workload's SOLO model-vs-oracle gap."""
    oracle = oracle_mrcs(inputs, cfg)
    per: list[dict] = []
    ok = True
    max_abs_overall = 0.0
    for w, pred, orc in zip(inputs, report.degraded_curves, oracle):
        pred = np.asarray(pred, float)
        m = min(len(pred), len(orc))
        diff = np.abs(pred[:m] - orc[:m]) if m else np.zeros(1)
        err, mae = float(diff.max()), float(diff.mean())
        edge = float(diff[-1])
        solo = mrc_mod.aet_mrc(
            cri.distribute(w.noshare, w.share, w.cfg.thread_num), cfg)
        solo_orc = oracle_mrcs([w], cfg)[0]
        ms = min(len(solo), len(solo_orc))
        base = float(np.max(np.abs(solo[:ms] - solo_orc[:ms]))) if ms \
            else 0.0
        w_ok = (mae <= ORACLE_MAE_EPS and edge <= ORACLE_EDGE_EPS
                and err <= base + ORACLE_MAX_MARGIN)
        per.append({"workload": w.name, "max_abs_err": err, "mae": mae,
                    "edge_err": edge, "solo_max_abs_err": base,
                    "ok": w_ok})
        ok = ok and w_ok
        max_abs_overall = max(max_abs_overall, err)
    return ok, {"ok": ok, "max_abs_err": max_abs_overall,
                "mae_eps": ORACLE_MAE_EPS, "edge_eps": ORACLE_EDGE_EPS,
                "max_margin": ORACLE_MAX_MARGIN, "per_workload": per}
