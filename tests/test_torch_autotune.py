"""The port's persisted batch-geometry autotuner (``pluss_torch.autotune``)
held against the JAX package's (``pluss.autotune``), on the CPU.

- the sidecar cases of tests/test_autotune.py: roundtrip, no plan cache,
  one hit per process, a salt mismatch counted stale, corrupt and
  invalid-field sidecars quarantined, consult off by env, dry-run exit
  codes, the short-circuit, and a real calibration whose winner persists
  with every point's histogram bit-identical (to each other and to the
  JAX package's replay of the same synthetic trace);
- the default-resolution chain (kwarg > ``PLUSS_*`` env > tuned >
  shipped) of ``trace._resolve_*`` against ``pluss.trace._resolve_*``
  under the same env and the same sidecar values;
- no kernel switch: the port's grid has no ``pallas`` coordinate, a
  sidecar that carries one changes nothing, and no calibration point
  touches the kernel selection.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from pluss import autotune as jax_autotune
from pluss import obs as jax_obs
from pluss import plancache as jax_plancache
from pluss import trace as jax_trace
from pluss_torch import autotune, obs, plancache, trace

CPU = torch.device("cpu")


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    """Opt back into the plan cache (conftest disables it) with a private
    root, and forget memoized sidecar loads in both packages."""
    monkeypatch.delenv("PLUSS_NO_PLAN_CACHE", raising=False)
    monkeypatch.setenv("PLUSS_PLAN_CACHE_DIR", str(tmp_path))
    for k in ("PLUSS_AUTOTUNE", "PLUSS_BATCH_WINDOWS", "PLUSS_FEED_WORKERS",
              "PLUSS_TRACE_STAGE_DEPTH", "PLUSS_TRACE_QUEUE_DEPTH",
              "PLUSS_WIRE"):
        monkeypatch.delenv(k, raising=False)
    autotune.invalidate()
    jax_autotune.invalidate()
    yield tmp_path
    autotune.invalidate()
    jax_autotune.invalidate()


@pytest.fixture
def counters(tmp_path):
    """An active telemetry session; yields a snapshot callable."""
    obs.shutdown()
    obs.configure(str(tmp_path / "telemetry.jsonl"))
    yield obs.counters
    obs.shutdown()


GEOMETRY = {"window": 4096, "batch_windows": 2, "stage_depth": 3,
            "queue_depth": 5, "feed_workers": 2, "wire": "d24v"}


def _valid_doc(salt=None, **geo):
    return {
        "version": 1,
        "salt": salt or plancache.runtime_salt(CPU),
        "geometry": {**GEOMETRY, **geo},
        "refs_per_sec": 1234.5,
        "calibration": {"n_refs": 4096, "points": 1, "elapsed_s": 0.1},
    }


def test_sidecar_roundtrip(plan_cache):
    """_save → consult round-trips every geometry field; the sidecar
    lands under the plan-cache root, salt-keyed, in JAX's schema."""
    path = autotune._save(_valid_doc(), CPU)
    assert path is not None and os.path.exists(path)
    assert os.path.dirname(path) == str(plan_cache)
    assert os.path.basename(path).startswith("autotune-")
    assert path == autotune.sidecar_path(CPU)
    for k, v in GEOMETRY.items():
        assert autotune.consult(k, CPU) == v
    assert autotune.tuned_geometry(CPU) == GEOMETRY
    assert autotune.consult("no_such_field", CPU) is None
    with open(path) as f:
        doc = json.load(f)
    assert set(doc) == {"version", "salt", "geometry", "refs_per_sec",
                        "calibration"}
    # the JAX package's schema validators accept the port's document
    assert all(jax_autotune._FIELDS[k](v) for k, v in doc["geometry"].items())


def test_no_plan_cache_means_no_sidecar(monkeypatch):
    monkeypatch.setenv("PLUSS_NO_PLAN_CACHE", "1")
    autotune.invalidate()
    assert autotune.sidecar_path(CPU) is None
    assert autotune.consult("window", CPU) is None
    assert autotune._save(_valid_doc(), CPU) is None


def test_hit_counted_once_per_process(plan_cache, counters):
    autotune._save(_valid_doc(), CPU)
    autotune.invalidate()
    for _ in range(5):
        assert autotune.consult("window", CPU) == 4096
    assert counters().get("autotune.hit") == 1
    assert not counters().get("autotune.stale")


def test_salt_mismatch_is_a_stale_miss(plan_cache, counters, capsys):
    """A sidecar calibrated on another runtime (here: the JAX package's
    salt in the port's slot) is ignored, counted stale with one notice,
    and left in place."""
    path = autotune.sidecar_path(CPU)
    with open(path, "w") as f:
        json.dump(_valid_doc(salt=jax_plancache.runtime_salt()), f)
    assert autotune.consult("window", CPU) is None
    assert autotune.tuned_geometry(CPU) is None
    assert counters().get("autotune.stale") == 1
    assert "different runtime" in capsys.readouterr().err
    assert os.path.exists(path)


def test_corrupt_sidecar_quarantined(plan_cache, counters, capsys):
    path = autotune.sidecar_path(CPU)
    with open(path, "wb") as f:
        f.write(b"\x00not json{{{")
    assert autotune.consult("window", CPU) is None
    assert counters().get("autotune.stale") == 1
    assert not os.path.exists(path)
    assert os.path.exists(path + ".corrupt")
    assert "recalibrate" in capsys.readouterr().err


@pytest.mark.parametrize("field,value", [("wire", "carrier-pigeon"),
                                         ("window", 0),
                                         ("feed_workers", "8"),
                                         ("stage_depth", 2.5)])
def test_invalid_geometry_field_quarantined(plan_cache, counters, field,
                                            value):
    path = autotune.sidecar_path(CPU)
    with open(path, "w") as f:
        json.dump(_valid_doc(**{field: value}), f)
    assert autotune.consult(field, CPU) is None
    assert counters().get("autotune.stale") == 1
    assert os.path.exists(path + ".corrupt")


def test_consult_disabled_by_env(plan_cache, monkeypatch):
    autotune._save(_valid_doc(), CPU)
    monkeypatch.setenv("PLUSS_AUTOTUNE", "0")
    autotune.invalidate()
    assert autotune.consult("window", CPU) is None
    monkeypatch.delenv("PLUSS_AUTOTUNE")
    autotune.invalidate()
    assert autotune.consult("window", CPU) == 4096


def test_dry_run_exit_codes(plan_cache, monkeypatch):
    buf = io.StringIO()
    assert autotune.dry_run(buf, device=CPU) == 0
    assert "no sidecar yet" in buf.getvalue()

    autotune._save(_valid_doc(), CPU)
    buf = io.StringIO()
    assert autotune.dry_run(buf, device=CPU) == 0
    out = buf.getvalue()
    assert "valid sidecar" in out and "window" in out

    with open(autotune.sidecar_path(CPU), "w") as f:
        f.write("not json")
    buf = io.StringIO()
    assert autotune.dry_run(buf, device=CPU) == 1
    assert "failed validation" in buf.getvalue()

    monkeypatch.setenv("PLUSS_NO_PLAN_CACHE", "1")
    buf = io.StringIO()
    assert autotune.dry_run(buf, device=CPU) == 0
    assert "plan cache disabled" in buf.getvalue()


def test_cli_dry_run_and_doctored_salt(plan_cache, capsys, tmp_path):
    """``cli autotune --dry-run --cpu`` exits 0 on a valid sidecar and 1 on
    one whose salt was doctored (counted ``autotune.stale`` in its
    telemetry stream)."""
    from pluss_torch import cli

    autotune._save(_valid_doc(), CPU)
    assert cli.main(["autotune", "--dry-run", "--cpu"]) == 0
    assert "valid sidecar" in capsys.readouterr().out
    path = autotune.sidecar_path(CPU)
    doc = json.load(open(path))
    doc["salt"] = doc["salt"].replace("cpu", "sm_00")
    json.dump(doc, open(path, "w"))
    autotune.invalidate()
    ev = str(tmp_path / "ev.jsonl")
    assert cli.main(["autotune", "--dry-run", "--cpu",
                     "--telemetry", ev]) == 1
    obs.shutdown()
    with open(ev) as f:
        recs = [json.loads(line) for line in f]
    stale = [r for r in recs if r.get("ev") == "counter"
             and r.get("name") == "autotune.stale"]
    assert stale and stale[-1]["value"] == 1
    with pytest.raises(SystemExit):
        cli.main(["autotune", "--force", "--dry-run", "--cpu"])


def test_calibrate_short_circuits_on_valid_sidecar(plan_cache, monkeypatch):
    autotune._save(_valid_doc(), CPU)
    autotune.invalidate()

    def boom(*a, **k):
        raise AssertionError("calibration ran despite a valid sidecar")

    monkeypatch.setattr(autotune, "_time_point", boom)
    buf = io.StringIO()
    doc = autotune.calibrate(out=buf, device=CPU)
    assert doc["geometry"] == _valid_doc()["geometry"]
    assert "already persisted" in buf.getvalue()


def test_synth_trace_matches_jax(tmp_path):
    a, b = tmp_path / "port.u64", tmp_path / "jax.u64"
    autotune._synth_trace(str(a), 30001)
    jax_autotune._synth_trace(str(b), 30001)
    assert a.read_bytes() == b.read_bytes()


def test_calibrate_persists_winner_every_point_bit_identical(
        plan_cache, monkeypatch, counters):
    """A real calibration over the port's whole grid on the CPU: every
    point's histogram equals the first point's and the JAX package's
    replay of the same trace, the winner persists schema-valid, and a
    second calibrate short-circuits with one ``autotune.hit``."""
    seen = []
    real = autotune._time_point

    def record(path, geo, device):
        r, dt = real(path, geo, device)
        seen.append((dict(geo), np.asarray(r.hist, np.int64).copy()))
        return r, dt

    monkeypatch.setattr(autotune, "_time_point", record)
    n_refs = 16384
    # the grid before calibrating (after it, the base's wire resolves
    # through the persisted winner)
    cands = autotune._candidates(autotune._base_geometry(n_refs, CPU))
    buf = io.StringIO()
    doc = autotune.calibrate(n_refs=n_refs, out=buf, device=CPU)
    assert "disqualified" not in buf.getvalue(), buf.getvalue()
    assert "failed" not in buf.getvalue(), buf.getvalue()
    assert [g for g, _ in seen] == cands
    jax_cands = jax_autotune._candidates(
        jax_autotune._base_geometry(n_refs))
    assert len(cands) == len(jax_cands) - 1   # less the kernel switch
    path = str(plan_cache / "calib.u64")
    jax_autotune._synth_trace(path, n_refs)
    want = np.asarray(jax_trace.replay_file(path, window=4096).hist,
                      np.int64)
    for geo, hist in seen:
        assert np.array_equal(hist, want), geo
    assert doc["version"] == 1 and doc["salt"] == plancache.runtime_salt(CPU)
    assert doc["geometry"] in cands
    for k, ok in autotune._FIELDS.items():
        assert ok(doc["geometry"][k]), (k, doc["geometry"][k])
    assert doc["calibration"]["points"] == len(cands)
    assert counters().get("autotune.probe") == len(cands)
    autotune.invalidate()
    assert autotune.tuned_geometry(CPU) == doc["geometry"]
    buf = io.StringIO()
    again = autotune.calibrate(out=buf, device=CPU)
    assert again["geometry"] == doc["geometry"]
    assert "already persisted" in buf.getvalue()
    assert counters().get("autotune.hit") == 1
    # replay_file with no geometry kwargs resolves to the tuned values
    # and returns the same histogram
    r = trace.replay_file(path, device=CPU)
    assert np.array_equal(np.asarray(r.hist, np.int64), want)
    assert r.wire == doc["geometry"]["wire"]
    assert r.feed_workers == doc["geometry"]["feed_workers"]


def _write_both(plan_cache, geo):
    """The same geometry as each package's sidecar, under each one's
    salt, in one plan-cache directory."""
    autotune._save(_valid_doc(**geo), CPU)
    jdoc = _valid_doc(salt=jax_plancache.runtime_salt(), **geo)
    jdoc["geometry"]["pallas"] = False
    jax_autotune._save(jdoc)
    autotune.invalidate()
    jax_autotune.invalidate()


RESOLVERS = [
    ("window", "_resolve_window", None, (None, 1 << 14)),
    ("batch_windows", "_resolve_bw", "PLUSS_BATCH_WINDOWS", (None, 4)),
    ("stage_depth", "_resolve_stage_depth", "PLUSS_TRACE_STAGE_DEPTH",
     (None, 1)),
    ("queue_depth", "_resolve_queue_depth", "PLUSS_TRACE_QUEUE_DEPTH",
     (None, 7)),
    ("feed_workers", "_resolve_feed_workers", "PLUSS_FEED_WORKERS",
     (None, 3)),
]


@pytest.mark.parametrize("sidecar", [False, True])
@pytest.mark.parametrize("env", [None, "6", "junk"])
@pytest.mark.parametrize("field,fn,var,kwargs", RESOLVERS)
def test_default_resolution_chain_matches_jax(plan_cache, monkeypatch,
                                              field, fn, var, kwargs, env,
                                              sidecar):
    if sidecar:
        _write_both(plan_cache, {})
    if env is not None and var is not None:
        monkeypatch.setenv(var, env)
    for kw in kwargs:
        got = getattr(trace, fn)(kw, CPU)
        want = getattr(jax_trace, fn)(kw)
        assert got == want, (field, kw, env, sidecar)
    if sidecar and env is None and kwargs[0] is None:
        assert getattr(trace, fn)(None, CPU) == GEOMETRY[field]
    for bad in (0, -4):
        with pytest.raises(ValueError):
            getattr(jax_trace, fn)(bad)
        with pytest.raises(ValueError, match=">= 1"):
            getattr(trace, fn)(bad, CPU)


@pytest.mark.parametrize("sidecar", [False, True])
@pytest.mark.parametrize("env", [None, "pack", "d24v", "auto", "zstd"])
def test_wire_resolution_matches_jax(plan_cache, monkeypatch, env, sidecar):
    if sidecar:
        _write_both(plan_cache, {})
    if env is not None:
        monkeypatch.setenv("PLUSS_WIRE", env)
    for kw in (None, "auto", "pack", "d24v"):
        assert trace._resolve_wire(kw, CPU) == jax_trace._resolve_wire(kw)


def test_tuned_geometry_drives_replay_defaults(plan_cache, tmp_path):
    """With a sidecar, ``replay_file`` with no geometry kwargs replays
    under the tuned wire and pool, equal to JAX's replay under its own
    equal sidecar and to an explicit-kwarg replay."""
    _write_both(plan_cache, {"window": 1 << 12, "batch_windows": 2,
                             "wire": "d24v", "feed_workers": 2})
    path = str(tmp_path / "t.u64")
    autotune._synth_trace(path, 20000)
    got = trace.replay_file(path, device=CPU)
    assert (got.wire, got.feed_workers) == ("d24v", 2)
    want = jax_trace.replay_file(path)
    assert np.array_equal(np.asarray(got.hist), np.asarray(want.hist))
    plain = trace.replay_file(path, window=1 << 20, batch_windows=16,
                              wire="pack", feed_workers=1, device=CPU)
    assert np.array_equal(np.asarray(got.hist), np.asarray(plain.hist))


def test_no_kernel_switch(plan_cache, monkeypatch, tmp_path):
    """The port's grid has no kernel coordinate, a sidecar carrying the
    JAX package's ``pallas`` field changes nothing, and a calibration
    point never picks the kernels (no ``_kernels`` argument, no
    ``PLUSS_PALLAS_*`` in the environment)."""
    assert "pallas" not in autotune._FIELDS
    base = autotune._base_geometry(1 << 20, CPU)
    assert all("pallas" not in c for c in autotune._candidates(base))
    jax_cands = jax_autotune._candidates(jax_autotune._base_geometry(1 << 20))
    assert len(autotune._candidates(base)) == len(jax_cands) - 1

    path = str(tmp_path / "t.u64")
    autotune._synth_trace(path, 20000)
    ref = trace.replay_file(path, window=4096, device=CPU)
    for pallas in (False, True):
        autotune._save(_valid_doc(pallas=pallas), CPU)
        autotune.invalidate()
        assert autotune.consult("pallas", CPU) is None
        assert "pallas" not in autotune.tuned_geometry(CPU)
        assert autotune.tuned_geometry(CPU) == GEOMETRY
        r = trace.replay_file(path, window=4096, device=CPU)
        assert np.array_equal(np.asarray(r.hist), np.asarray(ref.hist))

    calls = []
    real = trace.replay_file

    def spy(p, *a, **kw):
        calls.append(dict(kw))
        assert not any(k.startswith("PLUSS_PALLAS") for k in os.environ)
        return real(p, *a, **kw)

    monkeypatch.setattr(trace, "replay_file", spy)
    autotune.calibrate(n_refs=8192, force=True, out=io.StringIO(),
                       device=CPU)
    assert calls and all("_kernels" not in kw and "pallas" not in kw
                         for kw in calls)
    assert all(kw["device"] == CPU for kw in calls)


def test_jax_sidecar_in_the_port_slot_is_not_consulted(plan_cache):
    """The salts differ, so the JAX package's sidecar sits in another
    slot: the port consults nothing from it."""
    jax_autotune._save(_valid_doc(salt=jax_plancache.runtime_salt(),
                                  pallas=True))
    jax_autotune.invalidate()
    assert jax_autotune.consult("window") == 4096
    assert autotune.sidecar_path(CPU) != jax_autotune.sidecar_path()
    assert autotune.consult("window", CPU) is None


def test_stats_renders_the_autotune_block():
    """The port's ``stats`` renders the autotune counters (the block the
    JAX package's stats prints, byte for byte)."""
    from pluss.obs.stats import autotune_breakdown as jax_block
    from pluss_torch.obs.stats import autotune_breakdown

    counters = {"autotune.probe": 8.0, "autotune.hit": 1.0,
                "autotune.stale": 1.0}
    assert autotune_breakdown(counters, {}) == jax_block(counters, {})
    assert any("geometry hits / stale" in ln
               for ln in autotune_breakdown(counters, {}))
    jax_obs.shutdown()
