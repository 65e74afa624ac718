"""The port's loop-transformation prover (``pluss_torch.analysis.transform``)
vs the JAX package's (``pluss.analysis.transform``), on the CPU.

- every case of ``tests/test_transform.py`` (legal, engine-checked,
  illegal, refused, budget-exhausted): the port's ``TransformReport``
  document (verdict, edges, diagnostics, violation, provenance, the
  transformed spec) equals JAX's as JSON text;
- every legal transform preserves the order of every conflicting access
  pair (a brute-force walk of both iteration spaces through the port's
  ``instance_mapper``);
- ``check_transform`` on the port's CPU engine gives JAX's detail, and the
  port's transformed specs emit JAX's DSL text and import back;
- ``tile_ladder``, ``enumerate_transforms`` and ``search_transforms``
  (``tune --transforms``) equal JAX's, with no device dispatch.

Sizes are n <= 16, but the transform search at gemm-64 that finds the
tiled winner (as in ``tests/test_transform.py``).  One case is under
``-m slow``: gemm's interchange checked on JAX's engine, which JAX's own
suite also runs only there.
"""

import itertools
import json

import pytest

from pluss import frontend as jfe
from pluss import models as jax_models
from pluss.analysis import transform as jtf
from pluss.analysis import tune as jax_tune
from pluss.config import SamplerConfig as JaxConfig
from pluss.model import hierarchy as jax_hier
from pluss.spec_codec import spec_to_json as jax_doc
from pluss_torch import engine, frontend, spec_codec
from pluss_torch.analysis import transform as tf
from pluss_torch.analysis import tune as tune_mod
from pluss_torch.analysis.diagnostics import CODES
from pluss_torch.config import SamplerConfig
from pluss_torch.frontend.lower import derive_spans
from pluss_torch.model import hierarchy as hier_mod
from pluss_torch.models import REGISTRY
from pluss_torch.spec import Ref, nest_depth

BASE = SamplerConfig(thread_num=4, chunk_size=4)
JBASE = JaxConfig(thread_num=4, chunk_size=4)


def pair(model, n, apply):
    """(port report, JAX report) of one transform on one model."""
    return (apply(tf, REGISTRY[model](n)),
            apply(jtf, jax_models.REGISTRY[model](n)))


def same_report(got, want):
    assert got.code == want.code
    assert got.label() == want.label()
    assert json.dumps(got.doc(), indent=1) == json.dumps(want.doc(),
                                                         indent=1)


# ---------------------------------------------------------------------------
# the brute-force iteration-space oracle


def enumerate_accesses(spec):
    """Serial access stream: (nest, name, values, array, addr, write)."""
    out = []

    def walk(body, values, ni):
        for x in body:
            if isinstance(x, Ref):
                addr = x.addr_base + sum(c * values[d]
                                         for d, c in x.addr_terms)
                out.append((ni, x.name, tuple(values), x.array, addr,
                            x.is_write))
            else:
                for i in range(x.trip):
                    walk(x.body, values + [x.start + x.step * i], ni)

    for ni, nest in enumerate(spec.nests):
        walk([nest], [], ni)
    return out


def order_violations(spec, rep):
    """Conflicting original pairs whose order the transformed spec
    reverses; asserts the instance mapping is a bijection."""
    orig = enumerate_accesses(spec)
    trans = enumerate_accesses(rep.spec)
    mapper = tf.instance_mapper(rep.provenance)
    pos = {(ni, nm, vals): i for i, (ni, nm, vals, *_r) in enumerate(orig)}
    assert len(pos) == len(orig)
    perm = [pos[mapper(ni, nm, vals)] for (ni, nm, vals, *_r) in trans]
    assert sorted(perm) == list(range(len(orig)))
    newpos = [0] * len(orig)
    for t, o in enumerate(perm):
        newpos[o] = t
    bygroup = {}
    for i, (_n, _m, _v, arr, addr, w) in enumerate(orig):
        bygroup.setdefault((arr, addr), []).append((i, w))
    bad = []
    for g in bygroup.values():
        for (i, wi), (j, wj) in itertools.combinations(g, 2):
            if (wi or wj) and (newpos[i] < newpos[j]) != (i < j):
                bad.append((orig[i][:3], orig[j][:3]))
    return bad


def interchange(a, b):
    return lambda mod, s: mod.interchange(s, a, b)


def tile(*tiles):
    return lambda mod, s: mod.tile(s, list(tiles))


def fuse(a, b):
    return lambda mod, s: mod.fuse(s, a, b)


LEGAL_CASES = [
    ("gemm", interchange(0, 2)), ("gemm", interchange(1, 2)),
    ("gemm", tile((0, 3), (1, 3), (2, 3))), ("gemm", tile((2, 3))),
    ("syrk", interchange(0, 1)), ("syrk", tile((0, 3), (1, 3))),
    ("2mm", fuse(0, 1)), ("3mm", fuse(0, 1)), ("mvt", fuse(0, 1)),
    ("atax", fuse(0, 1)), ("stencil3d", interchange(1, 2)),
    ("heat3d", interchange(1, 2)), ("floyd_warshall", interchange(1, 2)),
    ("fdtd2d", fuse(0, 1)),
]


@pytest.mark.parametrize("i", range(len(LEGAL_CASES)))
def test_legal_transform_matches_jax_and_keeps_order(i):
    name, apply = LEGAL_CASES[i]
    got, want = pair(name, 6, apply)
    assert got.code == "PL951", got.diagnostics
    same_report(got, want)
    assert not order_violations(REGISTRY[name](6), got)


ENGINE_CASES = [
    pytest.param("gemm", interchange(0, 2), marks=pytest.mark.slow),
    ("gemm", tile((0, 4), (1, 4), (2, 4))),
    ("syrk", interchange(0, 1)), ("syrk", tile((0, 4), (1, 4))),
    ("2mm", fuse(0, 1)), ("3mm", fuse(0, 1)), ("mvt", fuse(0, 1)),
    ("stencil3d", interchange(1, 2)), ("heat3d", interchange(1, 2)),
    ("atax", fuse(0, 1)),
]


@pytest.mark.parametrize("name,apply", ENGINE_CASES)
def test_check_transform_on_the_cpu_matches_jax(name, apply):
    got, want = pair(name, 8, apply)
    same_report(got, want)
    ok, detail, diags = tf.check_transform(got, BASE, device="cpu")
    jok, jdetail, jdiags = jtf.check_transform(want, JBASE)
    assert ok and jok and not diags and not jdiags
    assert detail == jdetail and detail["histogram_identical"]


def test_check_transform_interchange_gemm_on_the_port():
    """The interchanged gemm (the case above that JAX checks only under
    ``-m slow``) on the port's CPU engine alone."""
    rep = tf.interchange(REGISTRY["gemm"](8), 0, 2)
    ok, detail, diags = tf.check_transform(rep, BASE, device="cpu")
    assert ok and not diags and detail["histogram_identical"]
    assert detail["mrc_exact"]


ILLEGAL_CASES = [
    ("seidel2d", interchange(0, 1)), ("seidel2d", interchange(0, 2)),
    ("floyd_warshall", interchange(0, 1)),
    ("floyd_warshall", interchange(0, 2)),
    ("jacobi2d", fuse(0, 1)), ("3mm", fuse(1, 2)), ("gemver", fuse(0, 1)),
]


@pytest.mark.parametrize("i", range(len(ILLEGAL_CASES)))
def test_illegal_transform_matches_jax(i):
    name, apply = ILLEGAL_CASES[i]
    got, want = pair(name, 8, apply)
    assert got.code == "PL952" and got.spec is None
    same_report(got, want)
    assert got.violation == want.violation
    with pytest.raises(ValueError):
        tf.check_transform(got, BASE, device="cpu")


REFUSAL_CASES = [
    *((m, interchange(0, 1)) for m in ("trmm", "syrk_tri", "cholesky",
                                       "ludcmp", "covariance")),
    *((m, tile((0, 2))) for m in ("trmm", "syrk_tri", "cholesky",
                                  "ludcmp", "covariance")),
    ("gemm", interchange(1, 0)), ("gemm", interchange(0, 3)),
    ("gemm", tile((0, 3), (2, 3))), ("gemm", tile((0, 5))),
    ("gemm", tile((-1, 2))), ("gemm", tile()), ("mvt", fuse(0, 2)),
    ("gemm", fuse(0, 1)), ("2mm", lambda mod, s: mod.interchange(s, 0, 1,
                                                                 nest=5)),
]


@pytest.mark.parametrize("i", range(len(REFUSAL_CASES)))
def test_refusal_matches_jax(i):
    name, apply = REFUSAL_CASES[i]
    got, want = pair(name, 8, apply)
    assert got.code == "PL953" and got.spec is None
    same_report(got, want)


def test_budget_exhaustion_refuses_typed(monkeypatch):
    monkeypatch.setenv("PLUSS_DEPVEC_BUDGET", "1")
    got, want = pair("gemm", 8, interchange(0, 2))
    assert got.code == "PL953"
    assert "budget" in got.diagnostics[0].message.lower()
    same_report(got, want)
    got, want = pair("2mm", 8, fuse(0, 1))
    assert got.code == "PL953"
    same_report(got, want)


@pytest.mark.parametrize("fn,text", [
    ("parse_interchange", "0"), ("parse_interchange", "0,1,2"),
    ("parse_tile", "0-8"), ("parse_tile", "0:x"), ("parse_fuse", "0"),
    ("parse_fuse", "a+b"),
])
def test_malformed_cli_params_raise(fn, text):
    with pytest.raises(ValueError):
        getattr(tf, fn)(text)
    with pytest.raises(ValueError):
        getattr(jtf, fn)(text)


def test_parse_helpers_match_jax():
    for fn, text in (("parse_interchange", "0,2"),
                     ("parse_tile", "0:8,1:8,2:8"), ("parse_fuse", "0+1")):
        assert getattr(tf, fn)(text) == getattr(jtf, fn)(text)


# ---------------------------------------------------------------------------
# transformed specs are ordinary specs


def test_respan_is_a_fixed_point_and_matches_jax():
    rep = tf.tile(REGISTRY["gemm"](32), [(0, 4), (1, 4), (2, 4)])
    assert rep.code == "PL951"
    assert spec_codec.specs_equal(derive_spans(rep.spec), rep.spec)
    # stale spans are stripped and re-derived, not copied
    stale = jtf._respan(jax_models.REGISTRY["syrk"](16))
    assert spec_codec.spec_to_json(tf._respan(REGISTRY["syrk"](16))) \
        == jax_doc(stale)


def test_transformed_spec_registers_and_reloads(tmp_path):
    rep = tf.tile(REGISTRY["gemm"](32), [(0, 8), (1, 8), (2, 8)])
    path = tmp_path / f"{rep.spec.name}.json"
    path.write_text(spec_codec.dump_spec(rep.spec) + "\n")
    assert spec_codec.specs_equal(spec_codec.load_spec_file(str(path)),
                                  rep.spec)


@pytest.mark.parametrize("name,apply", [
    ("gemm", tile((0, 8), (1, 8), (2, 8))), ("gemm", tile((2, 8))),
    ("syrk", tile((0, 8), (1, 8))), ("stencil3d", tile((1, 5), (2, 5))),
    ("gemm", interchange(0, 2)), ("2mm", fuse(0, 1)),
])
def test_transformed_spec_emits_jax_dsl_and_reimports(name, apply):
    got, want = pair(name, 32, apply)
    assert got.code == "PL951"
    text = frontend.emit_dsl(got.spec)
    assert text == jfe.emit_dsl(want.spec)
    assert "loop_raw" not in text, "tile loops must emit as step= sugar"
    (back,) = frontend.from_py(text, filename=f"<emit:{got.spec.name}>")
    assert spec_codec.specs_equal(back, got.spec)


def test_nest_depth():
    assert [nest_depth(n) for n in REGISTRY["gemm"](8).nests] == [3]
    assert [nest_depth(n) for n in REGISTRY["2mm"](8).nests] == [3, 3]
    assert nest_depth(REGISTRY["gemm"](8).nests[0].body[0].body[0]) == 0


# ---------------------------------------------------------------------------
# the transform space and its search (tune --transforms)


def test_tile_ladder_matches_jax():
    hier = hier_mod.HierarchyConfig(levels_kb=(1, 32), assoc=0,
                                    policy="lru")
    jhier = jax_hier.HierarchyConfig(levels_kb=(1, 32), assoc=0,
                                     policy="lru")
    sizes = tf.tile_ladder(REGISTRY["gemm"](64), [64, 64, 64], BASE, hier)
    assert sizes == jtf.tile_ladder(jax_models.REGISTRY["gemm"](64),
                                    [64, 64, 64], JBASE, jhier)
    assert sizes and all(2 <= s < 64 and 64 % s == 0 for s in sizes)


@pytest.mark.parametrize("name", ["gemm", "2mm", "syrk", "seidel2d",
                                  "trmm", "jacobi2d"])
def test_enumerate_transforms_matches_jax(name):
    got = tf.enumerate_transforms(REGISTRY[name](16), BASE)
    want = jtf.enumerate_transforms(jax_models.REGISTRY[name](16), JBASE)
    assert [r.label() for r in got] == [r.label() for r in want]
    for g, w in zip(got, want):
        same_report(g, w)


def test_search_transforms_doc_matches_jax():
    cands = tune_mod.space((1, 2), (1,))
    d0 = engine.DEVICE_DISPATCHES
    got = tf.search_transforms(REGISTRY["gemm"](16), candidates=cands)
    assert engine.DEVICE_DISPATCHES == d0
    want = jtf.search_transforms(jax_models.REGISTRY["gemm"](16),
                                 candidates=jax_tune.space((1, 2), (1,)))
    assert json.dumps(got.doc(), indent=1) == json.dumps(want.doc(),
                                                         indent=1)
    assert [d.message for d in got.diagnostics] == \
        [d.message for d in want.diagnostics]


def test_search_transforms_beats_untransformed_gemm():
    """At a 1 KB LLC the search proves a tiled gemm-64 schedule better
    than the untransformed winner, with no device dispatch, exactly as
    JAX's does; the winner verifies on the port's CPU engine."""
    hier = hier_mod.HierarchyConfig(levels_kb=(1,), assoc=0, policy="lru")
    jhier = jax_hier.HierarchyConfig(levels_kb=(1,), assoc=0, policy="lru")
    d0 = engine.DEVICE_DISPATCHES
    rep = tf.search_transforms(REGISTRY["gemm"](64),
                               candidates=tune_mod.space((1, 2, 4), (1, 4)),
                               hier=hier)
    assert engine.DEVICE_DISPATCHES == d0, "search touched the device"
    want = jtf.search_transforms(jax_models.REGISTRY["gemm"](64),
                                 candidates=jax_tune.space((1, 2, 4),
                                                           (1, 4)),
                                 hier=jhier)
    assert json.dumps(rep.doc(), indent=1) == json.dumps(want.doc(),
                                                         indent=1)
    assert rep.best is not None and rep.best.transform.kind == "tile"
    assert rep.best.score() < rep.base.winner.score - tune_mod.TIE_EPS
    assert rep.delta == rep.best.score() - rep.base.winner.score
    assert spec_codec.specs_equal(rep.best_spec(), rep.best.transform.spec)
    ok, detail, _ = tune_mod.check_winner(rep.best.transform.spec,
                                          rep.best.tune, device="cpu")
    assert ok and detail["histogram_identical"] and detail["mrc_exact"]


def test_search_refuses_when_the_base_tune_refuses(monkeypatch):
    monkeypatch.setenv("PLUSS_PREDICT_BUDGET", "10")
    got = tf.search_transforms(REGISTRY["gemm"](16),
                               candidates=tune_mod.space((2,), (1,)))
    want = jtf.search_transforms(jax_models.REGISTRY["gemm"](16),
                                 candidates=jax_tune.space((2,), (1,)))
    assert json.dumps(got.doc(), indent=1) == json.dumps(want.doc(),
                                                         indent=1)
    assert any(d.code == "PL903" for d in got.diagnostics)


def test_pl95x_codes_registered():
    for code in ("PL951", "PL952", "PL953", "PL954"):
        assert CODES[code][0] == "transform"
