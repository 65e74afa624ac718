"""The port's sharded backend against the JAX package's, on the CPU.

``pluss_torch.parallel.shard.shard_run`` over ``["cpu"] * D`` (D workers
of the one host) is held against ``pluss.engine.run`` and, at D = 8,
against ``pluss.parallel.shard.shard_run`` on conftest's 8 virtual CPU
devices: equal ``noshare_dense``, ``share_raw`` and
``max_iteration_count``, for D in {1, 2, 8}, both dispatch modes (static,
steal) and both window kernels (segmented, legacy).  The cases mirror
tests/test_parallel.py at n <= 32: template, mixed and sort windows,
template-ineligible arrays in clean windows, bounded and quad nests,
forced sub-windows, more devices than rounds, multi-nest carry, and the
``assignment``/``start_point`` resume.
"""

import functools

import numpy as np
import pytest

from pluss import engine as jax_engine
from pluss.config import SamplerConfig as JaxConfig
from pluss.parallel import default_mesh
from pluss.parallel import shard_run as jax_shard_run
from pluss.sched import ChunkSchedule
from pluss_torch import engine
from pluss_torch.config import SamplerConfig
from pluss_torch.parallel import default_devices, shard
from pluss_torch.parallel.shard import shard_run
from tests.test_torch_engine import carried


def _asg(n: int, cfg: dict):
    T = cfg.get("thread_num", 4)
    sched = ChunkSchedule(cfg.get("chunk_size", 4), n, 0, 1, T)
    return (tuple((c + 1) % T for c in range(sched.n_chunks)),)


#: (id, model, n, config kwargs, run kwargs)
CASES = [
    ("gemm16", "gemm", 16, {"cls": 8}, {}),
    ("gemm24_mixed", "gemm", 24, {"cls": 8}, {}),
    ("gemm8_more_devices_than_rounds", "gemm", 8, {"cls": 8}, {}),
    ("gemm32_subwindows", "gemm", 32, {}, {"window_accesses": 1}),
    ("gemm16_assignment", "gemm", 16, {"cls": 8},
     {"assignment": _asg(16, {})}),
    ("gemm32_start_point", "gemm", 32, {},
     {"start_point": 8, "window_accesses": 1}),
    ("mvt16", "mvt", 16, {"cls": 8}, {}),
    ("syrk32_var_refs", "syrk", 32, {}, {}),
    ("cholesky16_quad", "cholesky", 16, {"cls": 8}, {}),
    ("trmm16_varying_start", "trmm", 16, {}, {"window_accesses": 1}),
    ("2mm8_multi_nest", "2mm", 8, {"cls": 8}, {}),
]
IDS = [c[0] for c in CASES]


@functools.lru_cache(maxsize=None)
def _want(i: int):
    _, model, n, ckw, rkw = CASES[i]
    from pluss import models as jax_models

    return jax_engine.run(jax_models.REGISTRY[model](n), JaxConfig(**ckw),
                          **rkw)


def assert_same(got, want, what=""):
    assert got.max_iteration_count == want.max_iteration_count, what
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense,
                                  err_msg=what)
    assert got.share_raw == want.share_raw, what


@pytest.mark.parametrize("segmented", [True, False],
                         ids=["segmented", "legacy"])
@pytest.mark.parametrize("dispatch", ["static", "steal"])
@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_shard_run_equals_jax_engine(i, D, dispatch, segmented):
    _, model, n, ckw, rkw = CASES[i]
    got = shard_run(carried(model, n), SamplerConfig(**ckw),
                    devices=["cpu"] * D, dispatch=dispatch,
                    segmented=segmented, **rkw)
    assert_same(got, _want(i), f"D={D} {dispatch} segmented={segmented}")
    assert got.dispatch_stats["dispatch"] == dispatch
    assert got.dispatch_stats["devices"] == D
    assert got.degradations == ()


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_shard_run_equals_jax_shard_run_on_eight_devices(i):
    _, model, n, ckw, rkw = CASES[i]
    from pluss import models as jax_models

    want = jax_shard_run(jax_models.REGISTRY[model](n), JaxConfig(**ckw),
                         mesh=default_mesh(8), dispatch="static", **rkw)
    got = shard_run(carried(model, n), SamplerConfig(**ckw),
                    devices=["cpu"] * 8, dispatch="steal", **rkw)
    assert_same(got, want)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_grid_is_the_jax_grid(D):
    """Both packages cut the stream into the same window grid: the shard
    plan's windows, the chunk plan of the steal dispatch, and the natural
    window count it starts from."""
    from pluss import models as jax_models
    from pluss.parallel import shard as jax_shard

    for model, n, wa in (("gemm", 32, 1), ("cholesky", 16, 1),
                         ("2mm", 16, None)):
        jspec = jax_models.REGISTRY[model](n)
        want_pl, want_S = jax_shard._shard_geometry(jspec, JaxConfig(), D,
                                                     None, None, wa)
        pl, S = shard._shard_geometry(carried(model, n), SamplerConfig(),
                                      D, None, None, wa)
        assert S == want_S
        assert engine.natural_n_windows(carried(model, n), SamplerConfig(),
                                        window_accesses=wa) \
            == jax_engine.natural_n_windows(jspec, JaxConfig(),
                                            window_accesses=wa)
        assert [(np_.n_windows, np_.window_rounds) for np_ in pl.nests] \
            == [(np_.n_windows, np_.window_rounds) for np_ in want_pl.nests]
        np.testing.assert_array_equal(pl.nests[0].owned,
                                      want_pl.nests[0].owned)
        assert shard._chunk_plan(pl, S) == jax_shard._chunk_plan(want_pl, S)


def test_shard_plan_has_no_overlays_or_row_private_tables():
    pl = engine.shard_plan_cached(carried("syrk", 32), SamplerConfig(),
                                  None, None, None, 4)
    assert all(not np_.overlays for np_ in pl.nests)
    assert pl.nests[0].var_refs_novl == pl.nests[0].var_refs
    tri = engine.shard_plan_cached(carried("syrk_tri", 16), SamplerConfig(),
                                   None, None, None, 2)
    assert tri.nests[0].rpg_hist is None and tri.nests[0].refs


def test_plan_n_windows_matches_jax():
    from pluss import models as jax_models

    for nw in (1, 3, 8):
        pl = engine.plan(carried("gemm", 32), SamplerConfig(), n_windows=nw)
        want = jax_engine.plan(jax_models.REGISTRY["gemm"](32), JaxConfig(),
                               n_windows=nw)
        assert [(n.n_windows, n.window_rounds) for n in pl.nests] \
            == [(n.n_windows, n.window_rounds) for n in want.nests]
        np.testing.assert_array_equal(pl.nests[0].owned, want.nests[0].owned)


@pytest.mark.parametrize("model,n,ckw", [("gemm", 16, {"cls": 8}),
                                         ("cholesky", 16, {"cls": 8}),
                                         ("syrk", 16, {})])
def test_seq_backend_equals_vmap_and_jax(model, n, ckw):
    from pluss import models as jax_models

    got = engine.run(carried(model, n), SamplerConfig(**ckw), device="cpu",
                     backend="seq")
    want = jax_engine.run(jax_models.REGISTRY[model](n), JaxConfig(**ckw),
                          backend="seq")
    assert_same(got, want)
    assert_same(got, engine.run(carried(model, n), SamplerConfig(**ckw),
                                device="cpu"))
    with pytest.raises(ValueError, match="unknown backend"):
        engine.run(carried(model, n), SamplerConfig(**ckw), device="cpu",
                   backend="shard")


def test_dispatch_selection_and_refusals(monkeypatch):
    spec, cfg = carried("gemm", 16), SamplerConfig(cls=8)
    monkeypatch.setenv("PLUSS_SHARD_STEAL_MIN_REFS", "0")
    assert shard_run(spec, cfg, devices=["cpu"] * 2).dispatch_stats[
        "dispatch"] == "steal"
    monkeypatch.setenv("PLUSS_SHARD_STEAL_MIN_REFS", str(1 << 40))
    assert shard_run(spec, cfg, devices=["cpu"] * 2).dispatch_stats[
        "dispatch"] == "static"
    monkeypatch.setenv("PLUSS_SHARD_DISPATCH", "steal")
    assert shard_run(spec, cfg, devices=["cpu"] * 2).dispatch_stats[
        "dispatch"] == "steal"
    with pytest.raises(ValueError, match="unknown shard dispatch"):
        shard_run(spec, cfg, devices=["cpu"], dispatch="ring")
    monkeypatch.setenv("PLUSS_SHARD_SEGMENTED", "0")
    assert not shard._shard_segmented_default()


def test_entry_points_need_the_card_or_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_run(carried("gemm", 8), SamplerConfig())
    assert default_devices(3, device="cpu") == [torch.device("cpu")] * 3
    assert shard.device_fingerprint(["cpu", "cpu"]) == (("cpu", 0),
                                                        ("cpu", 0))


# ---------------------------------------------------------------------------
# the CLI's backends


def _blocks(text: str, banner: str) -> list[tuple[str, list[str]]]:
    """``[(banner, lines below it)]`` of a CLI's output."""
    out = []
    for line in text.splitlines():
        if line.startswith(banner):
            out.append((line.split(":")[0], []))
        elif out:
            out[-1][1].append(line)
    return out


@pytest.mark.parametrize("mode,extra", [("acc", []),
                                        ("speed", ["--reps", "1"])])
def test_cli_backends_print_jax_blocks(mode, extra, capsys):
    from pluss import cli as jax_cli
    from pluss_torch import cli

    argv = [mode, "--cpu", "--model", "gemm", "--n", "16", *extra]
    assert jax_cli.main(argv) == 0
    want = _blocks(capsys.readouterr().out, "TPU")
    assert cli.main(argv) == 0
    got = _blocks(capsys.readouterr().out, "TORCH CPU")
    assert [b for b, _ in want] == ["TPU VMAP", "TPU SHARD", "TPU SEQ"]
    assert [b for b, _ in got] == ["TORCH CPU", "TORCH CPU SHARD",
                                   "TORCH CPU SEQ"]
    assert [lines for _, lines in got] == [lines for _, lines in want]
    assert cli.main(argv + ["--backends", "seq,shard",
                            "--shard-dispatch", "static"]) == 0
    got = _blocks(capsys.readouterr().out, "TORCH CPU")
    assert [b for b, _ in got] == ["TORCH CPU SEQ", "TORCH CPU SHARD"]
    with pytest.raises(SystemExit):
        cli.main(argv + ["--backends", "ring"])
    assert "unknown backend 'ring'" in capsys.readouterr().err


@pytest.mark.parametrize("fmt", ["u64", "text"])
def test_cli_trace_backends_shard_matches_jax(tmp_path, fmt, capsys):
    from pluss import cli as jax_cli
    from pluss_torch import cli

    rng = np.random.default_rng(5)
    addrs = (rng.integers(0, 3000, 20_000) * 64).astype(np.uint64)
    path = tmp_path / f"t.{fmt}"
    if fmt == "u64":
        addrs.astype("<u8").tofile(path)
    else:
        path.write_text("\n".join(map(str, addrs.tolist())) + "\n")
    argv = ["trace", "--cpu", "--file", str(path), "--fmt", fmt,
            "--backends", "shard", "--window", "512", "--shard-dispatch",
            "static"]
    assert jax_cli.main(argv + ["--out", str(tmp_path / "j.csv")]) == 0
    want = capsys.readouterr().out.splitlines()
    assert cli.main(argv + ["--out", str(tmp_path / "t.csv")]) == 0
    got = capsys.readouterr().out.splitlines()
    assert want[0].startswith("TPU TRACE: ")
    assert got[0].startswith("TORCH CPU TRACE: ")
    assert got[1:-1] == want[1:-1]
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
