"""Persisted batch-geometry autotuner of the streamed trace replay.

The port's copy of ``pluss/autotune.py``.  The streamed replay's
throughput knobs — window size, windows per batch, staged-ahead depth,
feed queue depth, reader pool width and wire encoding — ship with guessed
defaults.  This module times SHORT calibration replays of a synthetic
trace over a one-at-a-time candidate grid and persists the winning
geometry beside the disk plan cache, keyed by
:func:`pluss_torch.plancache.runtime_salt`: each (torch, CUDA, device,
``sm_XY``, NBINS) runtime tunes once, and every later run on that device
consults the stored winner instead of the shipped guess.

The JAX package's grid also toggles its fused Pallas kernels off and on
(its ``pallas`` field).  The port's grid has no such coordinate: a switch
that replaced a kernel with its plain version on the card would hide the
card, so no point ever runs a plain version there, and a sidecar that
carries a ``pallas`` field (one the JAX package wrote) changes nothing.

Disciplines (the plan cache's):

- the sidecar lives in ``engine._plan_cache_root()`` as
  ``autotune-<sha256(runtime_salt(device))[:16]>.json``; written
  atomically (tmp + ``os.replace``), never partially visible;
- the salt rides in the filename AND the payload — a runtime switch
  resolves to a different slot (a miss), and a doctored or copied file
  whose embedded salt disagrees is counted ``autotune.stale`` and
  ignored;
- unparseable or schema-invalid bytes are quarantined
  (:func:`pluss_torch.resilience.errors.quarantine_artifact`), counted,
  and recalibrated from scratch — never a crash;
- every consulted load counts ``autotune.hit`` (once per process), every
  calibration point ``autotune.probe``; ``stats`` renders the block.

Bit-identity gate: every calibration point's histogram is compared to the
first point's — a geometry knob that changed the RESULT is a bug, and that
point is disqualified loudly rather than timed.

Consult surface: :func:`consult` feeds the None-defaulted geometry of
``trace.replay_file``, ``stage_resident``, ``pack_file`` and friends
(``trace._resolve_*``); ``serve --warm`` announces the tuned geometry it
warms with.  ``PLUSS_AUTOTUNE=0`` switches consultation off (explicit
kwargs and ``PLUSS_*`` env always win anyway — the tuned value only ever
fills a default).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

#: geometry schema: field -> validator.  ``wire`` is stored RESOLVED
#: ("pack"/"d24v"), never "auto".
_FIELDS = {
    "window": lambda v: isinstance(v, int) and v >= 1,
    "batch_windows": lambda v: isinstance(v, int) and v >= 1,
    "stage_depth": lambda v: isinstance(v, int) and v >= 1,
    "queue_depth": lambda v: isinstance(v, int) and v >= 1,
    "feed_workers": lambda v: isinstance(v, int) and v >= 1,
    "wire": lambda v: v in ("pack", "d24v"),
}

#: memoized sidecar loads, keyed by path (one hit/stale count per process,
#: and the consult in a hot default-resolution path costs a dict lookup,
#: not a disk read)
_cache: dict[str, dict | None] = {}


def invalidate() -> None:
    """Forget memoized sidecar loads (tests; after :func:`calibrate`)."""
    _cache.clear()


def sidecar_path(device=None) -> str | None:
    """Disk slot of ``device``'s tuned geometry (default: the card), or
    None when the plan cache is off (``PLUSS_NO_PLAN_CACHE``, or no cache
    dir configured)."""
    from pluss_torch import engine, plancache

    root = engine._plan_cache_root()
    if root is None:
        return None
    slot = hashlib.sha256(
        plancache.runtime_salt(device).encode()).hexdigest()[:16]
    return os.path.join(root, f"autotune-{slot}.json")


def enabled() -> bool:
    """Whether default resolution consults the tuned geometry at all
    (``PLUSS_AUTOTUNE``, envknob policy, default on)."""
    from pluss_torch.utils.envknob import env_bool

    return env_bool("PLUSS_AUTOTUNE", True)


def consult(field: str, device=None):
    """The tuned value of one geometry field on ``device``, or None — no
    sidecar, a salt mismatch, consultation disabled, or the field absent
    or not one of the port's fields.  Explicit kwargs and ``PLUSS_*`` env
    overrides beat this by construction: callers only consult when
    resolving a None default."""
    if field not in _FIELDS:
        return None
    doc = _load(device)
    if doc is None:
        return None
    v = doc.get("geometry", {}).get(field)
    return v if v is None or _FIELDS[field](v) else None


def tuned_geometry(device=None) -> dict | None:
    """The persisted geometry's fields (a copy), or None."""
    doc = _load(device)
    if doc is None:
        return None
    return {k: v for k, v in doc["geometry"].items() if k in _FIELDS}


def _load(device) -> dict | None:
    if not enabled():
        return None
    path = sidecar_path(device)
    if path is None:
        return None
    if path not in _cache:
        _cache[path] = _read(path, device)
    return _cache[path]


def _read(path: str, device=None) -> dict | None:
    """Load + validate one sidecar.  Counter discipline (``autotune.*``):
    ``hit`` on a valid consulted load, ``stale`` on a salt mismatch or a
    quarantined corrupt file; a plain absent file is silent (the common
    un-calibrated state)."""
    from pluss_torch import obs, plancache

    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
        geo = doc["geometry"]
        salt = doc["salt"]
        if not isinstance(geo, dict) or not isinstance(salt, str):
            raise ValueError("sidecar schema: geometry/salt malformed")
        bad = [k for k, ok in _FIELDS.items() if k in geo and not ok(geo[k])]
        if bad:
            raise ValueError(f"invalid geometry fields: {', '.join(bad)}")
    except Exception as e:
        from pluss_torch.resilience.errors import quarantine_artifact

        obs.counter_add("autotune.stale")
        quarantine_artifact(
            path, "autotune geometry sidecar", e,
            action="recalibrate with `pluss_torch autotune --force`")
        return None
    if salt != plancache.runtime_salt(device):
        obs.counter_add("autotune.stale")
        print(f"pluss_torch: autotune sidecar {path} was calibrated on a "
              f"different runtime ({salt}); ignoring it — recalibrate "
              f"with `pluss_torch autotune`", file=sys.stderr)
        return None
    obs.counter_add("autotune.hit")
    obs.trace_event("autotune.consult", outcome="hit",
                    **{k: v for k, v in doc["geometry"].items()
                       if isinstance(v, (int, float))})
    return doc


def _save(doc: dict, device=None) -> str | None:
    """Atomic sidecar write (tmp + rename): readers see the old geometry
    or the new one, never half a JSON document."""
    import uuid

    path = sidecar_path(device)
    if path is None:
        return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    invalidate()
    return path


def _base_geometry(n_refs: int, device) -> dict:
    """The shipped defaults on ``device`` as a calibration starting point,
    with the window scaled so the calibration trace spans several
    windows."""
    from pluss_torch import trace

    window = trace.TRACE_WINDOW
    while window > max(1 << 12, n_refs // 4):
        window //= 4
    return {
        "window": window,
        "batch_windows": trace.WINDOWS_PER_BATCH,
        "stage_depth": 2,
        "queue_depth": 2,
        "feed_workers": trace._default_feed_workers(device),
        "wire": trace._resolve_wire(None, device),
    }


def _candidates(base: dict) -> list[dict]:
    """One-at-a-time variations around the base — coordinate probes, not
    a cross product: the knobs are near-independent (feed vs transport),
    and a short calibration cannot resolve interactions anyway.  The JAX
    package's grid less its kernel switch."""
    cands = [dict(base)]
    for delta in (
        {"batch_windows": max(2, base["batch_windows"] // 2)},
        {"batch_windows": base["batch_windows"] * 2},
        {"window": max(1 << 12, base["window"] // 4)},
        {"wire": "pack" if base["wire"] == "d24v" else "d24v"},
        {"feed_workers": base["feed_workers"] + 1},
        {"stage_depth": base["stage_depth"] + 2},
        {"queue_depth": base["queue_depth"] + 2},
    ):
        c = dict(base)
        c.update(delta)
        if c not in cands:
            cands.append(c)
    return cands


def _synth_trace(path: str, n_refs: int, seed: int = 7) -> None:
    """Synthetic u64 address stream with a hot set, a scan, and a cold
    tail — enough reuse-distance spread that geometry differences move
    real work, not just padding (the JAX package's stream, byte for
    byte)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    thirds = n_refs // 3
    hot = rng.integers(0, 1 << 14, thirds)
    scan = np.arange(thirds, dtype=np.int64) % (1 << 18)
    cold = rng.integers(0, 1 << 22, n_refs - 2 * thirds)
    addrs = np.concatenate([hot, scan, cold])
    (addrs.astype(np.uint64) * 64).tofile(path)


def _time_point(path: str, geo: dict, device) -> tuple[object, float]:
    """One calibration point: replay twice on ``device`` (warm: kernel
    builds and allocator, then timed) under the candidate geometry."""
    import time

    from pluss_torch import trace

    kw = dict(window=geo["window"], batch_windows=geo["batch_windows"],
              stage_depth=geo["stage_depth"],
              queue_depth=geo["queue_depth"],
              feed_workers=geo["feed_workers"], wire=geo["wire"],
              device=device)
    trace.replay_file(path, **kw)            # warm
    t0 = time.perf_counter()
    r = trace.replay_file(path, **kw)
    dt = time.perf_counter() - t0
    return r, dt


def calibrate(n_refs: int = 1 << 20, force: bool = False,
              trace_path: str | None = None,
              out=sys.stderr, device=None) -> dict:
    """Search the geometry grid on a short synthetic replay on ``device``
    (default: the card) and persist the winner for its runtime.  Returns
    the sidecar document (also when persistence is off — the caller still
    gets the measured winner).

    An existing valid sidecar short-circuits (zero re-calibration —
    ``autotune.hit`` witnesses the consult) unless ``force``."""
    import tempfile
    import time

    import numpy as np

    from pluss_torch import engine, obs, plancache

    dev = engine.resolve_device(device)
    if not force:
        doc = _load(dev)
        if doc is not None:
            out.write(f"autotune: valid geometry for "
                      f"{plancache.runtime_salt(dev)} already persisted "
                      f"(--force recalibrates)\n")
            return doc

    t_start = time.perf_counter()
    tmpdir = None
    path = trace_path
    if path is None:
        tmpdir = tempfile.mkdtemp(prefix="pluss-autotune-")
        path = os.path.join(tmpdir, "calib.u64")
        _synth_trace(path, n_refs)
    try:
        base = _base_geometry(n_refs, dev)
        best = None
        ref_hist = None
        for geo in _candidates(base):
            obs.counter_add("autotune.probe")
            try:
                r, dt = _time_point(path, geo, dev)
            except Exception as e:
                out.write(f"autotune: point {geo} failed "
                          f"({type(e).__name__}: {e}); skipped\n")
                continue
            hist = np.asarray(r.hist, np.int64)
            if ref_hist is None:
                ref_hist = hist
            elif not np.array_equal(hist, ref_hist):
                out.write(f"autotune: point {geo} changed the histogram "
                          f"— geometry must be result-invariant; "
                          f"disqualified\n")
                continue
            rps = r.total_count / max(dt, 1e-9)
            out.write(f"autotune: {rps:12.0f} refs/s  {geo}\n")
            if best is None or rps > best[0]:
                best = (rps, dict(geo))
        if best is None:
            raise RuntimeError("autotune: every calibration point failed")
        elapsed = time.perf_counter() - t_start
        doc = {
            "version": 1,
            "salt": plancache.runtime_salt(dev),
            "geometry": best[1],
            "refs_per_sec": round(best[0], 1),
            "calibration": {
                "n_refs": int(n_refs if trace_path is None else
                              os.path.getsize(path) // 8),
                "points": len(_candidates(base)),
                "elapsed_s": round(elapsed, 3),
            },
        }
        where = _save(doc, dev)
        if where:
            out.write(f"autotune: persisted winner to {where} "
                      f"({elapsed:.1f}s)\n")
        else:
            out.write("autotune: plan cache disabled "
                      "(PLUSS_NO_PLAN_CACHE / no cache dir) — winner "
                      "NOT persisted\n")
        return doc
    finally:
        if tmpdir is not None:
            import shutil

            shutil.rmtree(tmpdir, ignore_errors=True)


def dry_run(out=sys.stdout, device=None) -> int:
    """Validate ``device``'s persisted sidecar without calibrating: report
    its status and the tuned geometry.  Exit code 1 only when a file
    exists but fails validation (corrupt → quarantined, or wrong salt);
    'none yet' is a healthy state."""
    path = sidecar_path(device)
    if path is None:
        out.write("autotune: plan cache disabled; no sidecar to check\n")
        return 0
    if not os.path.exists(path):
        out.write(f"autotune: no sidecar yet at {path} "
                  f"(run `pluss_torch autotune` to calibrate)\n")
        return 0
    doc = _read(path, device)   # bypasses the PLUSS_AUTOTUNE consult switch
    if doc is None:
        out.write(f"autotune: sidecar {path} failed validation "
                  f"(quarantined or salt-stale)\n")
        return 1
    out.write(f"autotune: valid sidecar {path}\n")
    out.write(f"  salt: {doc['salt']}\n")
    if "refs_per_sec" in doc:
        out.write(f"  calibrated: {doc['refs_per_sec']:.0f} refs/s over "
                  f"{doc.get('calibration', {}).get('n_refs', '?')} refs\n")
    for k in sorted(doc["geometry"]):
        out.write(f"  {k:<16} {doc['geometry'][k]}\n")
    return 0
