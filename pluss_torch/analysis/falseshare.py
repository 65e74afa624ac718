"""Line-granular false-sharing detection (PL5xx).

The port's copy of ``pluss/analysis/falseshare.py``.

The element-granular race pass asks "same ELEMENT, different threads".
The dominant parallel-cache pathology PLUSS's share/no-share split exists
to model is one level coarser: two threads touching the same CACHE LINE
at *different* elements — no data race, but the line ping-pongs between
caches exactly as if there were one.  This pass lowers each reference's
affine address map to line granularity and proves or flags that pattern
per same-nest, same-array reference pair (≥ one write, like the race
pass; nests never run concurrently, so cross-nest pairs cannot falsely
share).

Machine model: element width ``w`` per array (``Ref.dtype_bytes``
override, else ``SamplerConfig.ds``) and line size ``cfg.cls`` give
``E = cls // w`` elements per line.  Two accesses falsely share iff::

    addr1 - addr2 = d,   0 < |d| < E,   floor(addr1/E) == floor(addr2/E)

(arrays start on line boundaries — ``LoopNestSpec.line_bases`` — so the
floor is taken in array-local element space).  The test enumerates the
sub-line offsets ``d`` and decides each with the same exact-in-k,
Banerjee-in-the-inner-indices machinery as the race pass
(:func:`pluss_torch.analysis.deps._feasible` with ``delta=d``), restricted to
pairs the schedule places on two DIFFERENT threads
(:func:`pluss_torch.analysis.schedule.owner_of`).  The same-line alignment
condition is checked through the refs' achievable address residues mod
``E`` (an exact residue-set fold over the affine form — conservative
only in that it is decoupled from the offset feasibility), so a padded
layout whose rows are line-aligned REFUTES false sharing outright.

Polarity matches the race pass: refutation is a proof; confirmation is
conservative.  ``tests/test_falseshare.py`` validates the verdicts
against a line-granular simulation of the engine's schedule on several
model families, adversarial intra-line stride-1 specs, and padded vs
unpadded struct layouts.
"""

from __future__ import annotations

import math

import numpy as np

from pluss_torch.analysis import deps
from pluss_torch.analysis.diagnostics import Diagnostic, Severity, shown
from pluss_torch.analysis.schedule import owner_of
from pluss_torch.analysis.walk import ref_sites
from pluss_torch.config import SamplerConfig
from pluss_torch.spec import LoopNestSpec


def array_width(spec: LoopNestSpec, array: str, cfg: SamplerConfig) -> int:
    """Element width in bytes of ``array``: the refs' consistent
    ``dtype_bytes`` override, else the machine default ``cfg.ds``.
    Disagreeing overrides fall back to ``cfg.ds`` (the engine's rule)."""
    widths = {s.ref.dtype_bytes for s in ref_sites(spec)
              if s.ref.array == array and s.ref.dtype_bytes is not None}
    if len(widths) == 1:
        return widths.pop()
    return cfg.ds


_BIG = np.int64(np.iinfo(np.int64).max // 4)


def _split_profile(form, E: int):
    """Residue-coupled value profile of the INNER contribution mod ``E``.

    Splits the inner levels into line-SILENT ones (coefficient divisible
    by ``E`` — they move whole lines, never the within-line offset) and
    INTRA-line ones, and folds the intra levels into per-residue value
    intervals: ``(m_lo[ρ], m_hi[ρ], m_valid[ρ])`` bounds the intra sum
    over exactly the index combinations whose residue is ``ρ``.  This is
    what couples the same-line alignment condition to the offset
    feasibility — the decoupled test confirms false sharing on perfectly
    line-aligned rows (gemm's C), which a line-granular simulation
    refutes.  Bounded levels use static maximum trips: an over-
    approximation of the achievable set, so refutations stay sound.

    Returns ``(s_lo, s_hi, m_lo, m_hi, m_valid, g_all)`` with ``g_all``
    the gcd of all movable inner coefficients (the classic divisibility
    half, unchanged).
    """
    s_lo = s_hi = 0
    g_all = 0
    m_lo = np.full(E, _BIG)
    m_hi = np.full(E, -_BIG)
    m_valid = np.zeros(E, bool)
    m_lo[0] = m_hi[0] = 0
    m_valid[0] = True
    for c, lv in zip(form.coefs, form.levels):
        t = int(lv[-1])
        if c == 0 or t <= 1:
            continue
        g_all = math.gcd(g_all, abs(c))
        span = c * (t - 1)
        if c % E == 0:
            s_lo += min(span, 0)
            s_hi += max(span, 0)
            continue
        vals = c * np.arange(t, dtype=np.int64)
        res = vals % E
        c_lo = np.full(E, _BIG)
        c_hi = np.full(E, -_BIG)
        np.minimum.at(c_lo, res, vals)
        np.maximum.at(c_hi, res, vals)
        c_valid = c_hi >= c_lo
        # fold: new[ρ] ranges over old[ρ1] + cur[ρ2], ρ1+ρ2 ≡ ρ (mod E)
        n_lo = np.full(E, _BIG)
        n_hi = np.full(E, -_BIG)
        n_valid = np.zeros(E, bool)
        for r2 in np.nonzero(c_valid)[0]:
            rho = (np.arange(E) + r2) % E
            ok = m_valid
            np.minimum.at(n_lo, rho[ok], m_lo[ok] + c_lo[r2])
            np.maximum.at(n_hi, rho[ok], m_hi[ok] + c_hi[r2])
            n_valid[rho[ok]] = True
        m_lo, m_hi, m_valid = n_lo, n_hi, n_valid
    return s_lo, s_hi, m_lo, m_hi, m_valid, g_all


def _line_pair_feasible(p, q, own, E: int) -> int | None:
    """Smallest-|d| feasible cross-thread same-line pair at element
    offset ``d`` (``addr_p - addr_q = d``, ``0 < |d| < E``), or None when
    every sub-line offset is refuted.

    Same line forces the offset to equal the residue difference exactly
    (``d = r1 - r2`` with both residues inside the line), so the test
    enumerates ``(d, r1)`` and asks whether the residue-restricted inner
    intervals admit the required difference — exact in the parallel
    indices and their owners, Banerjee within each residue class.
    """
    f1, f2 = p.form, q.form
    if f1.trip0 != f2.trip0 or f1.trip0 <= 1:
        return None
    s1lo, s1hi, m1lo, m1hi, m1v, ga1 = _split_profile(f1, E)
    s2lo, s2hi, m2lo, m2hi, m2v, ga2 = _split_profile(f2, E)
    g = math.gcd(ga1, ga2)
    k2 = np.arange(f2.trip0, dtype=np.int64)[None, None, :]
    own2 = own(k2)
    base2 = f2.const + f2.k_coef * k2
    for b0 in range(0, f1.trip0, deps._PAIR_BLOCK):
        # block-level grids (pair mask, Banerjee interval, base offsets)
        # are residue/offset-INDEPENDENT: hoist them out of the (d, r1)
        # sweep — the schedule-blind interval (exact per-k inner domain,
        # incl. triangular clipping) intersects the residue-restricted
        # one below
        k1 = np.arange(b0, min(b0 + deps._PAIR_BLOCK, f1.trip0),
                       dtype=np.int64)[None, :, None]
        sl = slice(b0, b0 + k1.shape[1])
        pair_ok = (p.alive[sl][None, :, None] & q.alive[None, None, :]
                   & (k1 != k2) & (own(k1) != own2))
        if not bool(pair_ok.any()):
            continue
        L0 = p.lo[sl][None, :, None] - q.hi[None, None, :]
        H0 = p.hi[sl][None, :, None] - q.lo[None, None, :]
        D0 = base2 - (f1.const + f1.k_coef * k1)
        div0 = (D0 % g == 0) if g else None   # d-invariant when g | d
        kr1 = (-f1.const - f1.k_coef * k1) % E    # rho1 = (r1 + kr1) % E
        kr2 = (-f2.const - f2.k_coef * k2) % E
        for mag in range(1, E):
            for d in (mag, -mag):
                r1s = np.arange(max(0, d), E + min(0, d),
                                dtype=np.int64)[:, None, None]
                if r1s.shape[0] == 0:
                    continue
                D = D0 + d
                rho1 = (r1s + kr1) % E
                rho2 = (r1s - d + kr2) % E
                ok = pair_ok & m1v[rho1] & m2v[rho2]
                lo = s1lo - s2hi + m1lo[rho1] - m2hi[rho2]
                hi = s1hi - s2lo + m1hi[rho1] - m2lo[rho2]
                divisible = (div0 if g and d % g == 0 else
                             ((D % g == 0) if g else (D == 0)))
                feas = (ok & (D >= np.maximum(lo, L0))
                        & (D <= np.minimum(hi, H0)) & divisible)
                if bool(np.any(feas)):
                    return d
    return None


def _pad_suggestion(p, E: int, w: int, cls: int) -> str:
    """Padding advice from the write ref's parallel-axis stride."""
    stride = abs(p.form.k_coef)
    if stride == 0:
        return ("the reference is parallel-invariant — privatize or pad "
                "the shared element to a full line")
    if stride % E == 0:
        return ("the parallel stride is line-aligned; the sharing comes "
                "from an inner index — pad the inner extent to a "
                f"multiple of {E} elements")
    padded = -(-stride // E) * E
    return (f"line stride {stride * w} B per parallel iteration is not a "
            f"multiple of cls={cls} B — pad the per-iteration extent "
            f"from {stride} to {padded} elements")


def check(spec: LoopNestSpec, cfg: SamplerConfig,
          analysis: deps.Analysis | None = None,
          skip_nests: frozenset[int] = frozenset()) -> list[Diagnostic]:
    """PL501 (write-write) / PL502 (read-write) false-sharing findings per
    (nest, array), plus PL503 (INFO) for written arrays where every
    sub-line offset is refuted — the machine-checkable 'padding worked'
    verdict."""
    ana = analysis if analysis is not None \
        else deps.analyze(spec, skip_nests)
    own = owner_of(cfg)
    diags: list[Diagnostic] = []
    for (ni, array), group in sorted(ana.groups.items()):
        if not any(p.site.ref.is_write for p in group):
            continue
        w = array_width(spec, array, cfg)
        E = max(1, cfg.cls // max(1, w))
        found: dict[str, list[str]] = {"PL501": [], "PL502": []}
        detail: dict[str, str] = {}
        if E > 1:
            for i, p in enumerate(group):
                for q in group[i:]:
                    if not (p.site.ref.is_write or q.site.ref.is_write):
                        continue
                    d = _line_pair_feasible(p, q, own, E)
                    if d is None:
                        continue
                    code = "PL501" if (p.site.ref.is_write
                                       and q.site.ref.is_write) else "PL502"
                    found[code].append(
                        f"{p.site.ref.name}~{q.site.ref.name}@{d:+d}")
                    wp = p if p.site.ref.is_write else q
                    detail.setdefault(code, _pad_suggestion(
                        wp, E, w, cfg.cls))
        emitted = False
        for code, names in found.items():
            if not names:
                continue
            emitted = True
            kind = "write-write" if code == "PL501" else "read-write"
            diags.append(Diagnostic(
                code=code, severity=Severity.WARNING,
                message=f"cross-thread {kind} false sharing on '{array}' "
                        f"({E} elements/line): {shown(names)}; "
                        f"{detail[code]}",
                nest=ni, array=array,
            ))
        if not emitted:
            why = (f"element width {w} B fills a line" if E <= 1 else
                   f"every sub-line offset (|d| < {E}) is refuted under "
                   f"the schedule (T={cfg.thread_num}, "
                   f"chunk={cfg.chunk_size})")
            diags.append(Diagnostic(
                code="PL503", severity=Severity.INFO,
                message=f"no false sharing on written array '{array}': "
                        f"{why}",
                nest=ni, array=array,
            ))
    return diags
