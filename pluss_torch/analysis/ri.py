"""Symbolic reuse-interval analysis: the sampling-free static MRC path.

The port's copy of ``pluss/analysis/ri.py``.

For every reference pair of an affine nest the reuse polyhedron — the set
of iteration-vector pairs whose two accesses touch the same cache line
with no intervening touch — has an exact lattice-point count, because
stream positions and element addresses are closed forms of the iteration
vector (:class:`pluss_torch.spec.FlatRef`).  This pass derives the engine's
per-thread reuse-interval histograms from those counts alone, composes
them through the CRI dilation model (:mod:`pluss_torch.cri`) and the AET solver
(:mod:`pluss_torch.mrc`) exactly as a sampled run would, and proves the MRC's
plateau location statically — zero device dispatches, bit-identical
histograms to :func:`pluss_torch.engine.run`.

Derivability ladder (each rung exact; the next is the fallback):

1. **Closed-form periodic** (:func:`_closed_form`) — the Ehrhart-style
   uniform-reuse case.  For a single rectangular nest under the static
   chunk schedule, one owned chunk is one PERIOD of the thread's stream:
   consecutive periods shift every address by a constant
   ``addr_coefs[0]*step*T*CS``.  When that shift is cache-line-aligned
   (or zero) for every array, the per-period line sets are exact
   translates, so any reuse reaches back at most
   ``G = floor(span/|shift|) + 1`` periods and the per-period reuse-event
   multiset is EXACTLY periodic from period ``G`` on.  The derivation
   enumerates ``G + 2`` head periods, verifies ``events(G) ==
   events(G+1)`` (the lattice-count soundness check), multiplies the
   steady multiset across the remaining periods, and reconstructs a
   ragged tail from a ``G + 1``-period suffix window.  Work is
   ``O(T * G * CS * body)`` — independent of the trip count, which is
   what makes ``gemm`` at n=1024 (4.3e9 accesses) derivable in
   milliseconds-to-seconds on the host.
2. **Dense polynomial counting** (:func:`_dense`) — triangular and
   quad-contract families (and any rectangular shape that fails the
   uniformity precondition, e.g. syrk's mixed ``A[i][k]``/``A[j][k]``
   parallel coefficients): the polyhedra are enumerated per thread in
   position-ordered blocks against a carried last-access table
   (:func:`pluss_torch.analysis.polycount.scan_events`).  Exact for every
   shape the engine accepts; cost is the access count, gated by
   ``PLUSS_PREDICT_BUDGET``.
3. **Typed verdict** — outside both (contract/lint rejection: PL701;
   enumeration beyond budget: PL702) the prediction is refused with a
   machine-readable diagnostic, never approximated.

The exact plateau (:func:`predict`) must land inside the heuristic
``MrcBracket`` of :mod:`pluss_torch.analysis.footprint` — violation emits
PL704, the cross-prover soundness alarm.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pluss_torch import cri, mrc
from pluss_torch.analysis import footprint as footprint_mod
from pluss_torch.analysis import polycount as pc
from pluss_torch.analysis.diagnostics import Diagnostic, Severity
from pluss_torch.config import DEFAULT, SamplerConfig
from pluss_torch.sched import ChunkSchedule
from pluss_torch.spec import (LoopNestSpec, SpecContractError, flatten_nest,
                        nest_has_bounds, nest_has_varying_start,
                        nest_iteration_size, nest_iteration_sizes)

#: default enumeration budget (lattice cells) — covers every registry
#: family at its default size densely AND the gemm-1024 closed form
BUDGET_DEFAULT = 1 << 28


def predict_budget() -> int:
    from pluss_torch.utils.envknob import env_int

    return env_int("PLUSS_PREDICT_BUDGET", BUDGET_DEFAULT)


class _Fallback(Exception):
    """Closed-form preconditions failed mid-derivation; try denser rung."""


@dataclasses.dataclass
class Prediction:
    """Statically derived per-thread histograms of one spec.

    ``noshare``/``share`` use the exact dict formats of
    ``SamplerResult.noshare_list()``/``share_list()`` so bit-identity to
    an engine run is plain ``==``.  ``method`` is the ladder rung taken
    (``closed-form`` | ``dense``); None when not derivable.
    """

    model: str
    thread_num: int
    derivable: bool
    method: str | None
    noshare: list[dict] | None
    share: list[dict] | None
    accesses: int
    diagnostics: list[Diagnostic]
    #: closed-form only: the verified period horizon G (reuse reaches at
    #: most this many chunks back); None for dense
    periods: int | None = None
    footprint: footprint_mod.Footprint | None = None

    def matches_engine(self, res) -> bool:
        """Bit-identity against a ``SamplerResult``."""
        return (self.derivable
                and self.noshare == res.noshare_list()
                and self.share == res.share_list()
                and self.accesses == res.max_iteration_count)


@dataclasses.dataclass
class PredictReport:
    """One model's full static prediction: histograms + MRC + plateau."""

    prediction: Prediction
    bracket: footprint_mod.MrcBracket
    rihist: dict | None = None
    curve: np.ndarray | None = None
    plateau: int | None = None
    #: None when the plateau is unreachable in the modeled cache range;
    #: False triggers the PL704 soundness alarm
    plateau_in_bracket: bool | None = None

    @property
    def refined_bracket(self) -> footprint_mod.MrcBracket:
        """The exact plateau REPLACES the heuristic bounds wherever it
        is derivable and sound; the heuristic bracket stays as the fallback."""
        if self.plateau is not None and self.plateau_in_bracket:
            return self.bracket.refined(self.plateau)
        return self.bracket


def _diag(code: str, sev: Severity, msg: str, model: str) -> Diagnostic:
    return Diagnostic(code=code, severity=sev, message=msg, model=model)


# ---------------------------------------------------------------------------
# dense polynomial counting (rung 2)


def _dense(spec: LoopNestSpec, cfg: SamplerConfig,
           flats: list) -> tuple[list[dict], list[dict]]:
    """Exact per-thread histograms by blocked polyhedron enumeration."""
    T = cfg.thread_num
    bases = dict(zip((a for a, _ in spec.arrays), spec.line_bases(cfg)))
    counts = dict(zip((a for a, _ in spec.arrays), spec.line_counts(cfg)))
    n_lines = spec.total_lines(cfg)
    noshare, share = [], []
    scheds = [ChunkSchedule(cfg.chunk_size, nest.trip, nest.start,
                            nest.step, T) for nest in spec.nests]
    for tid in range(T):
        last_pos = np.full(n_lines, -1, np.int64)
        nsh: dict = {}
        shr: dict = {}
        base = 0
        for nest, sched, frs in zip(spec.nests, scheds, flats):
            if nest.trip <= 0:
                continue
            gs = pc.owned_iterations(sched, tid)
            if not len(gs):
                continue
            clks = pc.start_clocks(nest, gs, base)
            cells = sum(pc.ref_box_cells(fr) for fr in frs)
            for i0, i1 in pc.iteration_blocks(gs, cells):
                pos, line, span = pc.nest_block_events(
                    nest, frs, gs[i0:i1], clks[i0:i1],
                    bases.__getitem__, counts.__getitem__, cfg)
                nk, nc, sk, sc, _ = pc.scan_events(last_pos, pos, line,
                                                   span)
                pc.bump(nsh, nk, nc)
                pc.bump(shr, sk, sc)
            base = int(clks[-1]) + int(
                nest_iteration_sizes(nest, gs[-1:])[0])
        cold = float(int((last_pos >= 0).sum()))
        out = {-1: cold}
        out.update(sorted(nsh.items()))
        noshare.append(out)
        share.append({T - 1: dict(sorted(shr.items()))} if shr else {})
    return noshare, share


# ---------------------------------------------------------------------------
# closed-form periodic counting (rung 1)


def _uniform_reject(spec: LoopNestSpec, cfg: SamplerConfig,
                    flats: list) -> str | None:
    """None when the closed-form preconditions hold, else the reason."""
    if len(spec.nests) != 1:
        return "multiple nests (clocks persist across them)"
    nest = spec.nests[0]
    if nest.trip <= 0:
        return "empty parallel loop"
    if nest_has_bounds(nest) or nest_has_varying_start(nest):
        return "triangular/varying-start nest (polynomial counts apply)"
    per_arr: dict[str, set] = {}
    for fr in flats[0]:
        per_arr.setdefault(fr.ref.array, set()).add(fr.addr_coefs[0])
    T, CS = cfg.thread_num, cfg.chunk_size
    for a, cs in per_arr.items():
        if len(cs) > 1:
            return (f"array {a}: references disagree on the parallel "
                    "address coefficient (period shift is not uniform)")
        shift = next(iter(cs)) * nest.step * T * CS
        if shift and (shift * cfg.ds) % cfg.cls:
            return (f"array {a}: period shift of {shift} elements is "
                    "not cache-line-aligned")
    return None


def _inner_extremes(frs) -> dict:
    """Per-array (lo, hi, c0): extremes of each ref's g-independent
    address part over its full inner box (an affine form's extremes over
    a box are the sums of per-axis extremes — closed form, no
    enumeration), plus the shared parallel coefficient.  The g term is
    excluded; period translation shifts both extremes equally."""
    by_array: dict[str, tuple] = {}
    for fr in frs:
        lo = hi = fr.ref.addr_base
        for l in range(1, len(fr.trips)):
            base_l = fr.addr_coefs[l] * fr.starts[l]
            ext = fr.addr_coefs[l] * fr.steps[l] * (fr.trips[l] - 1)
            lo += base_l + min(0, ext)
            hi += base_l + max(0, ext)
        cur = by_array.get(fr.ref.array)
        if cur is None:
            by_array[fr.ref.array] = (lo, hi, fr.addr_coefs[0])
        else:
            by_array[fr.ref.array] = (min(cur[0], lo), max(cur[1], hi),
                                      cur[2])
    return by_array


def _period_horizon(spec: LoopNestSpec, cfg: SamplerConfig,
                    frs: list) -> int:
    """G: reuse reaches at most G owned chunks (periods) back.

    Per array: touching periods of any line lie inside an interval of
    ``floor(span/|shift|) + 1`` periods (span = the period touch set's
    line span, shift = the per-period line translation), so the most
    recent predecessor is at most ``floor(span/|shift|)`` periods back;
    a zero shift repeats the same set every period (predecessor distance
    1).  The +1 margin absorbs line-boundary straddle and is re-verified
    by the ``events(G) == events(G+1)`` check.
    """
    nest = spec.nests[0]
    T, CS = cfg.thread_num, cfg.chunk_size
    by_array = _inner_extremes(frs)
    G = 1
    for a, (lo, hi, c0) in by_array.items():
        # one period's parallel extent: CS consecutive g values
        par = c0 * nest.step * (CS - 1)
        span_el = (hi + max(0, par)) - (lo + min(0, par))
        shift_lines = abs(c0 * nest.step * T * CS) * cfg.ds // cfg.cls
        if shift_lines == 0:
            G = max(G, 1)
        else:
            span_lines = span_el * cfg.ds // cfg.cls + 1
            G = max(G, span_lines // shift_lines + 1)
    return G


def _closed_form(spec: LoopNestSpec, cfg: SamplerConfig, flats: list,
                 fp: footprint_mod.Footprint,
                 budget: int) -> tuple[list[dict], list[dict], int]:
    """The periodic derivation; raises :class:`_Fallback` on any failed
    precondition or verification so the caller can take the dense rung."""
    nest = spec.nests[0]
    frs = flats[0]
    T, CS = cfg.thread_num, cfg.chunk_size
    S = nest_iteration_size(nest)
    sched = ChunkSchedule(CS, nest.trip, nest.start, nest.step, T)
    G = _period_horizon(spec, cfg, frs)
    cells_per_iter = sum(pc.ref_box_cells(fr) for fr in frs)
    planned = 0
    for tid in range(T):
        t_chunks = sched.chunks_of_thread(tid)
        if not t_chunks:
            continue
        b, e = sched.chunk_index_range(t_chunks[-1])
        t_partial = (e - b) < CS
        full = len(t_chunks) - (1 if t_partial else 0)
        periods = min(full, G + 2)
        if t_partial:
            periods += (G + 2) if full > G + 2 else 1
        planned += periods
    planned *= CS * cells_per_iter
    if planned > budget:
        raise _Fallback(
            f"closed form needs ~{planned} cells (period horizon G={G}) "
            f"over the {budget} budget")
    bases = dict(zip((a for a, _ in spec.arrays), spec.line_bases(cfg)))
    counts = dict(zip((a for a, _ in spec.arrays), spec.line_counts(cfg)))
    n_lines = spec.total_lines(cfg)

    def run_block(gs, clks, last_pos, nsh, shr, count_from=None) -> None:
        for i0, i1 in pc.iteration_blocks(gs, cells_per_iter):
            pos, line, span = pc.nest_block_events(
                nest, frs, gs[i0:i1], clks[i0:i1],
                bases.__getitem__, counts.__getitem__, cfg)
            nk, nc, sk, sc, _ = pc.scan_events(last_pos, pos, line, span,
                                               count_from)
            pc.bump(nsh, nk, nc)
            pc.bump(shr, sk, sc)

    noshare, share = [], []
    for tid in range(T):
        chunks = sched.chunks_of_thread(tid)
        cold = float(int(fp.per_thread[tid].sum()))
        if not chunks:
            noshare.append({-1: 0.0})
            share.append({})
            continue
        b_last, e_last = sched.chunk_index_range(chunks[-1])
        tail_len = e_last - b_last
        partial = tail_len < CS
        P_full = len(chunks) - (1 if partial else 0)

        def period(p):
            gs = chunks[p] * CS + np.arange(CS, dtype=np.int64)
            clks = (np.int64(p) * CS + np.arange(CS, dtype=np.int64)) * S
            return gs, clks

        nsh: dict = {}
        shr: dict = {}
        last_pos = np.full(n_lines, -1, np.int64)
        deltas = {}
        for p in range(min(P_full, G + 2)):
            gs, clks = period(p)
            d_n: dict = {}
            d_s: dict = {}
            run_block(gs, clks, last_pos, d_n, d_s)
            for k, v in d_n.items():
                nsh[k] = nsh.get(k, 0.0) + v
            for k, v in d_s.items():
                shr[k] = shr.get(k, 0.0) + v
            if p >= G:
                deltas[p] = (d_n, d_s)
        if P_full > G + 2:
            if deltas[G] != deltas[G + 1]:
                raise _Fallback(
                    f"period multisets diverge at horizon G={G} "
                    "(uniformity verification failed)")
            reps = P_full - (G + 2)
            for k, v in deltas[G + 1][0].items():
                nsh[k] = nsh.get(k, 0.0) + v * reps
            for k, v in deltas[G + 1][1].items():
                shr[k] = shr.get(k, 0.0) + v * reps
            if partial:
                # ragged tail: a G+1-period suffix window re-creates the
                # exact predecessor state any tail access can reach
                lp2 = np.full(n_lines, -1, np.int64)
                tail_start = np.int64(P_full) * CS * S
                for p in range(P_full - (G + 1), P_full):
                    gs, clks = period(p)
                    run_block(gs, clks, lp2, nsh, shr,
                              count_from=int(tail_start))
                gs = np.arange(b_last, e_last, dtype=np.int64)
                clks = (np.int64(P_full) * CS
                        + np.arange(tail_len, dtype=np.int64)) * S
                run_block(gs, clks, lp2, nsh, shr,
                          count_from=int(tail_start))
        elif partial:
            gs = np.arange(b_last, e_last, dtype=np.int64)
            clks = (np.int64(P_full) * CS
                    + np.arange(tail_len, dtype=np.int64)) * S
            run_block(gs, clks, last_pos, nsh, shr)
        # mass balance: every access is one reuse event or one cold line
        total = sum(nsh.values()) + sum(shr.values()) + cold
        expect = float(int(fp.per_thread_accesses[tid]))
        if total != expect:
            raise _Fallback(
                f"thread {tid}: closed-form mass {total} != stream "
                f"length {expect} (soundness check failed)")
        out = {-1: cold}
        out.update(sorted(nsh.items()))
        noshare.append(out)
        share.append({T - 1: dict(sorted(shr.items()))} if shr else {})
    return noshare, share, G


# ---------------------------------------------------------------------------
# the ladder


def derive(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
           budget: int | None = None) -> Prediction:
    """Derive the per-thread reuse-interval histograms statically.

    Never raises for an in-contract spec: refusals come back as a
    non-derivable :class:`Prediction` with PL701/PL702 diagnostics.
    """
    from pluss_torch import obs

    if budget is None:
        budget = predict_budget()
    model = spec.name
    diags: list[Diagnostic] = []
    try:
        flats = [flatten_nest(nest) for nest in spec.nests]
    except SpecContractError as e:
        diags.append(_diag(
            "PL701", Severity.WARNING,
            f"reuse distribution not statically derivable: spec outside "
            f"the position contract ({e.code}: {e})", model))
        return Prediction(model, cfg.thread_num, False, None, None, None,
                          0, diags)
    from pluss_torch.analysis import lint_spec

    lint_errs = [d for d in lint_spec(spec)
                 if d.severity is Severity.ERROR]
    if lint_errs:
        diags.append(_diag(
            "PL701", Severity.WARNING,
            "reuse distribution not statically derivable: the address "
            f"model is invalid ({len(lint_errs)} lint ERROR(s), first "
            f"{lint_errs[0].code})", model))
        return Prediction(model, cfg.thread_num, False, None, None, None,
                          0, diags)
    with obs.span("ri.derive", model=model, threads=cfg.thread_num):
        fp = footprint_mod.footprints(spec, cfg)
        reject = _uniform_reject(spec, cfg, flats)
        if reject is None:
            try:
                noshare, share, G = _closed_form(spec, cfg, flats, fp,
                                                 budget)
                diags.append(_diag(
                    "PL703", Severity.INFO,
                    f"closed-form periodic derivation: period horizon "
                    f"G={G}, {fp.accesses} accesses counted without "
                    "enumeration", model))
                return Prediction(model, cfg.thread_num, True,
                                  "closed-form", noshare, share,
                                  int(fp.accesses), diags, periods=G,
                                  footprint=fp)
            except _Fallback as f:
                reject = str(f)
        cells = pc.spec_cells(spec)
        if cells > budget:
            diags.append(_diag(
                "PL702", Severity.WARNING,
                f"prediction enumeration of {cells} lattice cells "
                f"exceeds the {budget}-cell budget and no closed form "
                f"applies ({reject}); raise PLUSS_PREDICT_BUDGET to "
                "force the dense derivation", model))
            return Prediction(model, cfg.thread_num, False, None, None,
                              None, int(fp.accesses), diags,
                              footprint=fp)
        noshare, share = _dense(spec, cfg, flats)
        diags.append(_diag(
            "PL703", Severity.INFO,
            f"dense polynomial-count derivation: {cells} lattice cells "
            f"({reject})", model))
        return Prediction(model, cfg.thread_num, True, "dense", noshare,
                          share, int(fp.accesses), diags,
                          footprint=fp)


def predict(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
            budget: int | None = None) -> PredictReport:
    """Full static prediction: histograms -> CRI -> AET MRC -> plateau,
    checked against the heuristic bracket (PL704 on violation)."""
    pred = derive(spec, cfg, budget)
    fp = pred.footprint
    bracket = footprint_mod.mrc_bracket(spec, cfg, fp)
    report = PredictReport(pred, bracket)
    if not pred.derivable:
        return report
    report.rihist = cri.distribute(pred.noshare, pred.share,
                                   cfg.thread_num)
    report.curve = mrc.aet_mrc(report.rihist, cfg)
    report.plateau = mrc.plateau_of(report.rihist, report.curve)
    if report.plateau is not None:
        report.plateau_in_bracket = (
            bracket.c_lo <= report.plateau <= bracket.c_hi)
        if not report.plateau_in_bracket:
            pred.diagnostics.append(_diag(
                "PL704", Severity.ERROR,
                f"exact MRC plateau at cache size {report.plateau} lies "
                f"outside the static bracket [{bracket.c_lo}, "
                f"{bracket.c_hi}] — one of the provers is unsound",
                pred.model))
    return report


#: stated MRC tolerance of the predict≡engine contract.  The
#: CRI pass accumulates floats in SORTED key order (:mod:`pluss_torch.cri`), so
#: equal histograms compose to BIT-IDENTICAL curves regardless of dict
#: insertion or device-merge order — ``mrc_exact`` is the expected
#: outcome on every family, and the epsilon is kept only as a stated
#: contract bound, not an observed error
MRC_EPS = 1e-9


def check_against_engine(report: PredictReport, res,
                         cfg: SamplerConfig) -> tuple[bool, dict]:
    """The ``--check`` contract: histograms bit-identical to the engine,
    composed MRC within :data:`MRC_EPS` relative L2 (equal histograms
    compose to the same curve up to float summation order), and the
    exact plateau (when reached) inside the heuristic bracket."""
    pred = report.prediction
    hist_ok = pred.matches_engine(res)
    ref_curve = mrc.aet_mrc(
        cri.distribute(res.noshare_list(), res.share_list(),
                       cfg.thread_num), cfg)
    err = mrc.l2_error(report.curve, ref_curve) \
        if report.curve is not None else float("inf")
    mrc_exact = report.curve is not None and np.array_equal(
        report.curve, ref_curve)
    bracket_ok = report.plateau_in_bracket is not False
    ok = hist_ok and err <= MRC_EPS and bracket_ok
    return ok, {
        "histogram_identical": hist_ok,
        "mrc_exact": mrc_exact,
        "mrc_l2_error": err,
        "plateau_in_bracket": report.plateau_in_bracket,
    }


def report_doc(report: PredictReport) -> dict:
    """JSON view of one prediction (the CLI/serve/sweep block)."""
    pred = report.prediction
    doc: dict = {
        "derivable": pred.derivable,
        "method": pred.method,
        "accesses": pred.accesses,
        "threads": pred.thread_num,
        "mrc_plateau_bounds": [report.bracket.c_lo, report.bracket.c_hi],
        "mrc_floor": report.bracket.floor,
    }
    if pred.periods is not None:
        doc["period_horizon"] = pred.periods
    if pred.derivable:
        doc["cold"] = [float(h.get(-1, 0.0)) for h in pred.noshare]
        doc["histogram_keys"] = len(report.rihist)
        doc["histogram_mass"] = float(sum(report.rihist.values()))
        doc["mrc_points"] = int(len(report.curve))
        doc["mrc_terminal"] = float(report.curve[-1])
    if report.plateau is not None:
        doc["mrc_plateau_exact"] = report.plateau
        doc["plateau_in_bracket"] = report.plateau_in_bracket
    if pred.diagnostics:
        doc["diagnostics"] = [d.to_dict() for d in pred.diagnostics]
    return doc
