"""The port's serving wire protocol (``pluss_torch.serve.protocol``) held
against the JAX package's (``pluss.serve.protocol``), on the CPU.

The same request objects — valid model, inline-spec, ``source``, trace
and sleep requests, and malformed, over-size, analyzer-failing and
frontend-failing ones — give equal ``Request`` fields, equal batch keys
and equal ``error_response`` documents in both packages, and
``result_payload`` shapes equal histograms into equal documents.
"""

import dataclasses

import numpy as np
import pytest

from pluss.resilience import errors as jax_errors
from pluss.serve import protocol as jax_protocol
from pluss.spec_codec import spec_to_json as jax_spec_to_json
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY
from pluss_torch.resilience import errors
from pluss_torch.serve import protocol
from pluss_torch.spec_codec import spec_to_json


def _gemm_c(n: int) -> str:
    from pluss_torch.frontend import polybench

    src = open(polybench.gemm_source_path()).read()
    return src.replace("#define N 128", f"#define N {n}")


OOB = {"name": "oob", "arrays": [["A", 1]],
       "nests": [{"trip": 8, "body": [
           {"name": "A1", "array": "A", "addr_terms": [[0, 1]]}]}]}


def _requests(tmp_path):
    trace = tmp_path / "refs.bin"
    np.random.default_rng(3).integers(0, 512, 4096).astype("<u8") \
        .tofile(trace)
    inline = spec_to_json(REGISTRY["gemm"](13))
    inline["name"] = "tenant_custom"
    return [
        {"id": "m1", "model": "gemm", "n": 16},
        {"id": "m2", "model": "mvt", "n": 12, "threads": 2, "chunk": 3,
         "ds": 4, "cls": 32, "output": "both", "share_cap": 64,
         "window": 4096, "tenant": "acme", "cache_kb": 512},
        {"id": "m3", "model": "syrk_tri", "n": 10, "deadline_ms": 5000,
         "verify": True},
        {"id": "s1", "spec": inline, "threads": 2},
        {"id": "c1", "source": _gemm_c(16), "lang": "c", "name": "gsrc",
         "threads": 2, "chunk": 2},
        {"id": "t1", "trace": str(trace), "output": "both"},
        {"id": "t2", "trace": str(trace), "window": 1 << 14, "cls": 32},
        {"id": "z1", "sleep_ms": 25},
    ]


BAD = [
    [],
    {"id": "b0"},
    {"id": "b1", "model": "gemm", "trace": "/x"},
    {"id": "b2", "model": "no_such_model"},
    {"id": "b3", "model": "gemm", "n": -4},
    {"id": "b4", "model": "gemm", "threads": 0},
    {"id": "b5", "model": "gemm", "output": "csv"},
    {"id": "b6", "model": "gemm", "deadline_ms": -1},
    {"id": "b7", "model": "gemm", "deadline_ms": True},
    {"id": "b8", "trace": "/no/such/file.bin"},
    {"id": "b9", "trace": "/tmp", "fmt": "yaml"},
    {"id": "b10", "sleep_ms": 10_000_000},
    {"id": "b11", "model": "gemm", "tenant": 7},
    {"id": "b12", "spec": OOB, "threads": 2},
    {"id": "b13", "source": "int main() { return 0; }", "lang": "c"},
    {"id": "b14", "source": "x = 1", "lang": "py"},
    {"id": "b15", "source": "", "lang": "c"},
    {"id": "b16", "spec": {"name": "x", "arrays": "A", "nests": []}},
]


def _fields(req, to_json):
    d = {f.name: getattr(req, f.name) for f in dataclasses.fields(req)
         if f.name not in ("spec", "cfg", "deadline", "t_admit", "reply",
                           "_claim_lock")}
    d["cfg"] = dataclasses.asdict(req.cfg)
    d["spec"] = None if req.spec is None else to_json(req.spec)
    d["has_deadline"] = req.deadline is not None
    return d


def _key(key, to_json):
    """A batch key with its spec and config as plain data."""
    out = []
    for part in key:
        if hasattr(part, "nests"):
            out.append(to_json(part))
        elif dataclasses.is_dataclass(part):
            out.append(dataclasses.asdict(part))
        else:
            out.append(part)
    return tuple(out)


def test_valid_requests_match_jax(tmp_path):
    objs = _requests(tmp_path)
    got = [protocol.parse_request(o) for o in objs]
    want = [jax_protocol.parse_request(o) for o in objs]
    for g, w in zip(got, want):
        assert _fields(g, spec_to_json) == _fields(w, jax_spec_to_json)
        assert _key(g.batch_key(), spec_to_json) == \
            _key(w.batch_key(), jax_spec_to_json)
    # the batch keys partition the requests the same way
    assert [[a.batch_key() == b.batch_key() for b in got] for a in got] \
        == [[a.batch_key() == b.batch_key() for b in want] for a in want]


def test_batch_key_grouping_matches_jax():
    pairs = [
        ({"model": "gemm", "n": 16, "threads": 2},
         {"model": "gemm", "n": 16, "threads": 2, "output": "histogram",
          "deadline_ms": 50, "id": "zzz", "cache_kb": 512}),
        ({"model": "gemm", "n": 16}, {"model": "gemm", "n": 12}),
        ({"model": "gemm", "n": 16}, {"model": "gemm", "n": 16,
                                      "share_cap": 64}),
        ({"model": "gemm", "n": 16}, {"model": "gemm", "n": 16,
                                      "window": 4096}),
        ({"model": "gemm", "n": 16}, {"source": _gemm_c(16),
                                      "name": "gemm16"}),
        ({"sleep_ms": 5}, {"sleep_ms": 5}),
    ]
    for a, b in pairs:
        got = protocol.parse_request(a).batch_key() == \
            protocol.parse_request(b).batch_key()
        want = jax_protocol.parse_request(a).batch_key() == \
            jax_protocol.parse_request(b).batch_key()
        assert got == want, (a, b)


def _error_doc(parse, obj, err_mod):
    with pytest.raises(err_mod.InvalidRequest) as ei:
        parse(obj)
    return protocol.error_response("r", ei.value) \
        if err_mod is errors else jax_protocol.error_response("r", ei.value)


@pytest.mark.parametrize("obj", BAD)
def test_rejections_match_jax(obj):
    got = _error_doc(protocol.parse_request, obj, errors)
    want = _error_doc(jax_protocol.parse_request, obj, jax_errors)
    assert got == want


@pytest.mark.parametrize("env,obj,needle", [
    ({"PLUSS_SERVE_MAX_REFS": "1000"},
     {"id": "r1", "model": "gemm", "n": 16}, "PLUSS_SERVE_MAX_REFS"),
    ({"PLUSS_SERVE_MAX_COST": "5000"},
     {"id": "r2", "model": "gemm", "n": 16}, "PLUSS_SERVE_MAX_COST"),
    ({"PLUSS_SERVE_MAX_COST": "100000", "PLUSS_SERVE_LINE_COST": "1000000"},
     {"id": "r3", "model": "mvt", "n": 64}, "footprint lines"),
])
def test_size_and_cost_bounds_match_jax(monkeypatch, env, obj, needle):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = _error_doc(protocol.parse_request, obj, errors)
    want = _error_doc(jax_protocol.parse_request, obj, jax_errors)
    assert got == want and needle in got["error"]["message"]


def test_trace_size_bound_matches_jax(tmp_path, monkeypatch):
    trace = tmp_path / "big.bin"
    np.arange(4096, dtype="<u8").tofile(trace)
    monkeypatch.setenv("PLUSS_SERVE_MAX_REFS", "100")
    obj = {"id": "t", "trace": str(trace)}
    assert _error_doc(protocol.parse_request, obj, errors) == \
        _error_doc(jax_protocol.parse_request, obj, jax_errors)


def test_default_deadline_and_anon_ids():
    r = protocol.parse_request({"model": "gemm", "n": 8},
                               default_deadline_ms=5_000)
    assert 4.0 < r.remaining_s() <= 5.0 and r.id.startswith("anon-")
    assert protocol.parse_request({"id": 7, "model": "gemm",
                                   "n": 8}).id == "7"


@pytest.mark.parametrize("err", [
    ("Overloaded", ("full",), {"site": "serve.admission",
                               "retry_after_ms": 250}),
    ("DeadlineExceeded", ("late",), {}),
    ("InvalidRequest", ("bad",), {"diagnostics": ({"code": "PL201"},)}),
    ("ResourceExhausted", ("oom",), {"site": "serve.spec"}),
    ("CompileError", ("nvcc",), {}),
])
def test_error_response_matches_jax(err):
    name, args, kw = err
    got = protocol.error_response("r1", getattr(errors, name)(*args, **kw))
    want = jax_protocol.error_response("r1",
                                       getattr(jax_errors, name)(*args, **kw))
    assert got == want
    assert protocol.error_response("x", RuntimeError("boom")) == \
        jax_protocol.error_response("x", RuntimeError("boom"))


@pytest.mark.parametrize("output", ["mrc", "histogram", "both"])
def test_result_payload_matches_jax(output):
    from pluss.config import SamplerConfig as JaxConfig

    ri = {-1: 3.0, 4: 10.0, 64: 2.0, 1024: 7.5}
    obj = {"model": "gemm", "n": 8, "output": output, "cache_kb": 1}
    got = protocol.result_payload(protocol.parse_request(obj), ri,
                                  SamplerConfig(cache_kb=1))
    want = jax_protocol.result_payload(jax_protocol.parse_request(obj), ri,
                                       JaxConfig(cache_kb=1))
    assert got == want


def test_parse_addr_matches_jax():
    for addr in ("/tmp/p.sock", "127.0.0.1:8080", ":9000", "host:nope",
                 "rel/path.sock"):
        assert protocol.parse_addr(addr) == jax_protocol.parse_addr(addr)


def test_claim_once():
    r = protocol.parse_request({"model": "gemm", "n": 8})
    assert not r.is_claimed() and r.claim() and not r.claim()
    assert r.is_claimed()


# ---------------------------------------------------------------------------
# the engine's serve surface


def test_dispatch_key_identity_like_jax():
    from pluss import engine as jax_engine
    from pluss.config import SamplerConfig as JaxConfig
    from pluss.models import REGISTRY as JAX_REGISTRY
    from pluss_torch import engine

    def keys(eng, reg, Cfg):
        spec = reg["gemm"](16)
        cfg = Cfg(thread_num=2)
        k = eng.dispatch_key(spec, cfg, 64, None)
        hash(k)
        return [k == eng.dispatch_key(reg["gemm"](16), cfg, 64, None),
                k == eng.dispatch_key(spec, cfg, 64, 4096),
                k == eng.dispatch_key(spec, Cfg(thread_num=4), 64, None),
                k == eng.dispatch_key(reg["gemm"](12), cfg, 64, None),
                k == eng.dispatch_key(spec, cfg, 128, None),
                k == eng.dispatch_key(spec, Cfg(thread_num=2,
                                                cache_kb=512), 64, None)]

    assert keys(engine, REGISTRY, SamplerConfig) == \
        keys(jax_engine, JAX_REGISTRY, JaxConfig) == \
        [True, False, False, False, False, True]


def test_tenant_view_isolation_and_stamps():
    from pluss_torch import engine

    res = engine.run(REGISTRY["gemm"](13),
                     SamplerConfig(thread_num=2, chunk_size=2), device="cpu")
    res.degradations = ("shrink_window",)
    a, b = res.tenant_view(), res.tenant_view()
    orig_hist = res.noshare_dense.copy()
    orig_share = [dict(d) for d in res.share_raw]
    a.noshare_dense[:] = -7
    a.share_raw[0][999999] = 42.0
    assert b.noshare_dense.tolist() == orig_hist.tolist()
    assert b.share_raw == orig_share == res.share_raw
    assert res.noshare_dense.tolist() == orig_hist.tolist()
    assert b.degradations == ("shrink_window",)
    assert b.max_iteration_count == res.max_iteration_count
