"""The plain reference (benchmark/reference/) against known answers and
against the port on the CPU, the kernel-1 byte count, the frozen spec
documents, the import scan, and the lower-precision control."""

import ast
import json
import os

import numpy as np
import pytest

from benchmark import compare, kernels, traffic
from benchmark.reference import curve, stream
from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _port(model, n, T=4, CS=4, sampled=None):
    from pluss_torch import cri, engine, mrc, sampling
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY
    spec, cfg = REGISTRY[model](n), SamplerConfig(thread_num=T,
                                                  chunk_size=CS)
    res = engine.run(spec, cfg, device="cpu") if sampled is None else \
        sampling.sampled_run(spec, cfg, sampled[0], sampled[1],
                             device="cpu")
    rih = cri.distribute(res.noshare_list(), res.share_list(), T)
    return spec, res, rih, mrc.aet_mrc(rih, cfg)


def _ref(spec, T=4, CS=4, sampled=None, dtype=np.float64):
    from pluss_torch.spec_codec import spec_to_json
    doc, sch = spec_to_json(spec), stream.Schedule(T, CS, 8, 64)
    h = stream.full(doc, sch, "cpu") if sampled is None else \
        stream.sampled(doc, sch, "cpu", *sampled)
    rih = curve.distribute(h.noshare, h.share, T, dtype)
    return h, rih, curve.aet_mrc(rih, 2560, dtype)


def test_gemm128_goldens():
    from pluss_torch.models import gemm
    from pluss_torch.spec_codec import spec_to_json
    h = stream.full(spec_to_json(gemm(128)), stream.Schedule(4, 4, 8, 64),
                    "cpu")
    merged, share = {}, {}
    for d in h.noshare:
        for k, v in d.items():
            merged[k] = merged.get(k, 0) + v
    for d in h.share:
        for k, v in d.items():
            share[k] = share.get(k, 0) + v
    assert merged == {-1: 12288, 1: 2127872, 2: 2097152, 4: 1835008,
                      256: 260096, 512: 1835008}
    assert share == {62194: 253952}
    assert h.accesses == 8421376


@pytest.mark.parametrize("model,n,T,CS,sampled", [
    ("cholesky", 24, 4, 4, None), ("cholesky", 31, 3, 2, None),
    ("cholesky", 32, 4, 4, (0.25, 11)), ("gemm", 32, 8, 1, None),
    ("gemm", 32, 1, 4, None), ("gemm", 64, 4, 4, (0.1, 2147483901)),
    ("gemm", 48, 2, 8, (0.5, 3)), ("syrk", 24, 4, 4, None),
    ("trmm", 24, 4, 4, None), ("mvt", 40, 4, 4, None)])
def test_reference_equals_the_port_on_the_cpu(model, n, T, CS, sampled):
    spec, res, rih, crv = _port(model, n, T, CS, sampled)
    h, rrih, rcrv = _ref(spec, T, CS, sampled)
    share = [{int(v): float(c) for v, c in d.items()} for d in res.share_raw]
    assert compare.counts_off(res.noshare_list(), share,
                              res.max_iteration_count, h) == 0
    assert compare.cri_gap(rih, rrih) <= compare.LIMITS["cri_gap"]
    assert compare.mrc_gap(crv, rcrv) <= compare.LIMITS["mrc_gap"]


@pytest.mark.parametrize("model,n,sampled", [
    ("gemm", 64, None), ("cholesky", 32, None), ("gemm", 64, (0.1, 5))])
def test_float32_control_fails(model, n, sampled):
    """The reference put in the program's place at float32 (the precision
    below the configuration's float64) is not correct."""
    spec, res, rih, crv = _port(model, n, sampled=sampled)
    _, rrih, rcrv = _ref(spec, sampled=sampled)
    _, crih, ccrv = _ref(spec, sampled=sampled, dtype=np.float32)
    nums = {"counts_off": 0, "cri_gap": compare.cri_gap(crih, rrih),
            "mrc_gap": compare.mrc_gap(ccrv, rcrv)}
    assert not compare.judge(nums), nums


def test_mrc_matches_the_cursor_walk():
    """The closed-form MRC equals the cursor loop it stands for."""
    rng = np.random.default_rng(3)
    keys = sorted(set((1 << rng.integers(0, 14, 12)).tolist()))
    rih = {k: float(rng.integers(1, 1000)) for k in keys}
    rih[-1] = 77.0
    P, acc, total = {}, rih[-1], sum(rih.values())
    for k in sorted((k for k in rih if k != -1), reverse=True):
        P[k] = acc / total
        acc += rih[k]
    P[0] = 1.0
    max_rt, want = max(rih), []
    sum_p, t, prev = 0.0, 0, 0
    for c in range(min(max_rt, 2560 * 128) + 1):
        while sum_p < c and t <= max_rt:
            if t in P:
                prev = t
            sum_p += P[prev]
            t += 1
        want.append(P[prev])
    np.testing.assert_array_equal(curve.aet_mrc(rih, 2560), want)


@pytest.mark.parametrize("T,L,pb,ms", [(4, 10_449_000, 4, 0.1622),
                                       (4, 10_449_000, 8, 0.2121),
                                       (4, 64_460_012, 8, 1.308)])
def test_event_hist_bytes_hand_worked(T, L, pb, ms):
    got = kernels.least_ms(kernels.event_hist_bytes(T, L, pb))
    assert float(f"{got:.4g}") == ms   # the hand-worked figures' digits


class _Spy:
    """Kernel 1's plain version, recording each window it is handed:
    ``(rows, length, valid ghosts per row, real accesses)``."""

    def __init__(self):
        self.seen = []

    def __call__(self, key_s, pos_s, span_s, valid_s, win_start):
        from pluss_torch.ops.event_hist import event_histogram_plain
        real = valid_s & (pos_s >= win_start[:, None])
        ghosts = (valid_s & ~real).sum(1)
        assert bool((ghosts == ghosts[0]).all())
        self.seen.append((key_s.shape[0], key_s.shape[1], int(ghosts[0]),
                          int(real.sum())))
        return event_histogram_plain(key_s, pos_s, span_s, valid_s,
                                     win_start)


def test_sort_windows_are_the_windows_kernel_1_gets():
    """The count's shapes, ghosts and real accesses, from the plan and the
    spec, equal what the program hands kernel 1: a bounded nest in one
    window and in size buckets, a sampled run's counted windows."""
    from pluss_torch import engine, sampling
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY
    from pluss_torch.spec_codec import spec_to_json
    cfg = SamplerConfig()
    for model, n, wa in (("cholesky", 48, None), ("cholesky", 48, 4000),
                         ("trmm", 24, 2000)):
        spec = REGISTRY[model](n)
        pl = engine.plan(spec, cfg, window_accesses=wa)
        spy = _Spy()
        engine._execute(pl, "cpu", event_hist=spy)
        got = kernels.sort_windows(pl, {"run": "full"}, spec_to_json(spec),
                                   [None])
        assert [w[:4] for w in got] == spy.seen
        assert all(kernels.event_hist_need_bytes(*w)
                   <= kernels.event_hist_bytes(w[0], w[1], w[4])
                   for w in got)
    spec = REGISTRY["gemm"](64)
    mix = {"run": "sampled", "rate": 0.3}
    preds = [traffic.Prediction(4, 4, s) for s in (3, 2 ** 31 + 5)]
    spy = _Spy()
    for p in preds:
        sampling.sampled_run(spec, cfg, 0.3, p.sample_seed, device="cpu",
                             _event_hist=spy)
    pl = sampling._plan_cached(spec, cfg, None)
    got = kernels.sort_windows(pl, mix, spec_to_json(spec), preds)
    assert [w[:4] for w in got] == spy.seen
    pl = engine.plan(spec, cfg)
    assert kernels.sort_windows(pl, {"run": "full"}, spec_to_json(spec),
                                [None]) == []


@pytest.mark.parametrize("name", ["cholesky-2000", "gemm-1024"])
def test_frozen_spec_is_the_registrys(name):
    from pluss_torch.models import REGISTRY
    from pluss_torch.spec_codec import spec_to_json
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        conf = json.load(f)
    assert conf["spec"] == spec_to_json(REGISTRY[conf["model"]](conf["n"]))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def _modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_under_benchmark_imports_jax_or_pluss():
    """Whole top-level names: ``pluss_torch`` passes, ``pluss`` fails;
    the reference and the trace writer also refuse ``pluss_torch``."""
    mods = list(_modules())
    assert len(mods) > 10
    assert os.path.join(BENCH, "reference", "trace.py") in mods
    for path in mods:
        refused = {"jax", "jaxlib", "flax", "pluss"}
        if os.sep + "reference" + os.sep in path or \
                path == os.path.join(BENCH, "tracedata.py"):
            refused.add("pluss_torch")
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & refused, (path, tops & refused)


def test_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import pluss_torch.engine\nfrom pluss.cri import x\n")
    assert {m.split(".")[0] for m in _imports(str(p))} == {"pluss_torch",
                                                           "pluss"}


def test_traffic_is_the_same_for_one_seed():
    mix = {"run": "sampled", "rate": 0.1}
    conf = {"thread_num": 4, "chunk_size": 4}
    take = lambda s: [p for _, p in zip(range(5),
                                        traffic.predictions(mix, conf, s))]
    assert take(2 ** 31 + 17) == take(2 ** 31 + 17)
    assert take(2 ** 31 + 17) != take(2 ** 31 + 18)
    assert traffic.warmup(mix, conf, 5) not in take(5)
    sweep = {"run": "full", "schedules": [[1, 1], [2, 2], [4, 8]]}
    got = [p.thread_num for _, p in zip(range(4),
                                        traffic.predictions(sweep, conf, 4))]
    assert got == [1, 2, 4, 1]   # from the head, whatever the seed

