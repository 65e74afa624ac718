"""The port's static analyzer vs the JAX package's, on the CPU.

- ``lint_spec`` at n=16 and at each builder's default size, and
  ``analyze_spec``, for all 29 families: the same diagnostics (code,
  severity, message, nest, path), in the same order;
- the analyze report's pieces: footprints, MRC brackets, the
  cache-hierarchy document and the dependence-vector document, equal as
  JSON text (so every float and every key order match);
- SARIF logs equal and valid;
- the shared host functions the analysis needs (envknob parsers,
  ``mrc.plateau_of``/``l2_error``, ``cri.nbd_dilate_p``, the spec codec's
  text and file readers), each held against the JAX package's function
  on the same inputs.

The port's specs are the JAX package's, carried through its codec JSON.
Everything compared is exact.
"""

import json

import numpy as np
import pytest

from pluss import analysis as jax_analysis
from pluss import cri as jax_cri
from pluss import models as jax_models
from pluss import mrc as jax_mrc
from pluss import spec_codec as jax_codec
from pluss.analysis import depvec as jax_depvec
from pluss.analysis import ri as jax_ri
from pluss.analysis import sarif as jax_sarif
from pluss.config import SamplerConfig as JaxConfig
from pluss.model import hierarchy as jax_hier
from pluss.utils import envknob as jax_envknob
from pluss_torch import analysis, cri, mrc, spec_codec
from pluss_torch.analysis import depvec, ri, sarif
from pluss_torch.config import SamplerConfig
from pluss_torch.model import hierarchy
from pluss_torch.models import REGISTRY
from pluss_torch.resilience.errors import InvalidRequest
from pluss_torch.utils import envknob

MODELS = sorted(REGISTRY)


def carried(spec):
    return spec_codec.spec_from_json(jax_codec.spec_to_json(spec))


def diag_key(diags):
    return [(d.code, d.severity.name, d.message, d.nest, d.path, d.model)
            for d in diags]


def as_json(x) -> str:
    return json.dumps(x, indent=1)


@pytest.mark.parametrize("model", MODELS)
def test_lint_matches_jax(model):
    js = jax_models.REGISTRY[model](16)
    assert diag_key(analysis.lint_spec(carried(js))) == \
        diag_key(jax_analysis.lint_spec(js))


@pytest.mark.parametrize("model", MODELS)
def test_lint_at_default_size_matches_jax(model):
    js = jax_models.REGISTRY[model]()
    got = analysis.lint_spec(carried(js))
    assert diag_key(got) == diag_key(jax_analysis.lint_spec(js))
    assert analysis.error_count(got) == 0


@pytest.mark.parametrize("model", MODELS)
def test_analyze_matches_jax(model):
    """Diagnostics, footprint, bracket, hierarchy and depvec documents."""
    js = jax_models.REGISTRY[model](16)
    ts = carried(js)
    jcfg, cfg = JaxConfig(), SamplerConfig()
    jd, jfp = jax_analysis.analyze_spec(js, jcfg)
    td, tfp = analysis.analyze_spec(ts, cfg)
    assert diag_key(td) == diag_key(jd)
    assert (tfp.total, tfp.arrays, list(map(int, tfp.per_array)),
            list(map(int, tfp.cold)), tfp.accesses) == \
        (jfp.total, jfp.arrays, list(map(int, jfp.per_array)),
         list(map(int, jfp.cold)), jfp.accesses)
    assert [vars(lv) for lv in tfp.levels] == \
        [vars(lv) for lv in jfp.levels]
    jb = jax_analysis.footprint.mrc_bracket(js, jcfg, jfp)
    tb = analysis.footprint.mrc_bracket(ts, cfg, tfp)
    assert (tb.floor, tb.c_lo, tb.c_hi, tb.guaranteed_reuse) == \
        (jb.floor, jb.c_lo, jb.c_hi, jb.guaranteed_reuse)
    jv, tv = jax_depvec.spec_vectors(js), depvec.spec_vectors(ts)
    assert as_json(depvec.doc_of(tv)) == as_json(jax_depvec.doc_of(jv))
    assert depvec.render(depvec.doc_of(tv)) == \
        jax_depvec.render(jax_depvec.doc_of(jv))
    assert diag_key(depvec.annotate_races(td, tv)) == \
        diag_key(jax_depvec.annotate_races(jd, jv))
    jrep, trep = jax_ri.predict(js, jcfg), ri.predict(ts, cfg)
    assert (trep.rihist is None) == (jrep.rihist is None)
    if trep.rihist is not None:
        got = hierarchy.hierarchy_doc(trep.rihist, cfg)
        want = jax_hier.hierarchy_doc(jrep.rihist, jcfg)
        assert as_json(got) == as_json(want)
        assert hierarchy.render_hierarchy(got) == \
            jax_hier.render_hierarchy(want)


@pytest.mark.parametrize("geometry", [
    (None, None, None), (1024, None, None), (None, "32:512:8192", 8),
    (None, "48,2048", 0)])
def test_cache_geometry_matches_jax(geometry):
    kb, hier = hierarchy.cache_geometry(*geometry)
    jkb, jhier = jax_hier.cache_geometry(*geometry)
    assert kb == jkb
    assert dataclass_fields(hier) == dataclass_fields(jhier)


def dataclass_fields(x):
    return {k: v for k, v in vars(x).items()}


@pytest.mark.parametrize("bad", [(512, "32:512", None), (None, "64:32", None),
                                 (None, "a:b", None)])
def test_cache_geometry_refusals_match_jax(bad):
    with pytest.raises(ValueError) as want:
        jax_hier.cache_geometry(*bad)
    with pytest.raises(ValueError) as got:
        hierarchy.cache_geometry(*bad)
    assert str(got.value) == str(want.value)


def test_sarif_documents_match_jax_and_validate():
    jd, td = [], []
    for model in MODELS:
        js = jax_models.REGISTRY[model](16)
        ts = carried(js)
        jd += jax_analysis.with_model(jax_analysis.lint_spec(js), js.name)
        td += analysis.with_model(analysis.lint_spec(ts), ts.name)
        jd += jax_analysis.with_model(
            jax_ri.predict(js).prediction.diagnostics, js.name)
        td += analysis.with_model(ri.predict(ts).prediction.diagnostics,
                                  ts.name)
    got, want = sarif.to_sarif(td), jax_sarif.to_sarif(jd)
    assert as_json(got) == as_json(want)
    assert sarif.validate(got) == [] == jax_sarif.validate(want)
    assert analysis.format_text(td) == jax_analysis.format_text(jd)
    assert analysis.format_json(td) == jax_analysis.format_json(jd)


def test_sarif_validator_flags_what_jax_flags():
    doc = sarif.to_sarif([])
    doc["version"] = "2.0"
    doc["runs"][0]["tool"]["driver"]["name"] = "other"
    assert sarif.validate(doc) == jax_sarif.validate(doc)
    assert sarif.validate(doc)


# --- the shared host functions the analysis reads -------------------------

@pytest.mark.parametrize("raw", ["", "2.5", "0.01", "-1", "x", " 3 "])
def test_env_float_matches_jax(raw, monkeypatch):
    monkeypatch.setenv("PLUSS_TEST_FLOAT", raw)
    assert envknob.env_float("PLUSS_TEST_FLOAT", 0.5, 0.0) == \
        jax_envknob.env_float("PLUSS_TEST_FLOAT", 0.5, 0.0)


@pytest.mark.parametrize("raw", ["", "32,512,8192", "8", "32,32", "64,32",
                                 "0,4", "a,b", "4,"])
def test_env_int_list_matches_jax(raw, monkeypatch):
    monkeypatch.setenv("PLUSS_TEST_LIST", raw)
    assert envknob.env_int_list("PLUSS_TEST_LIST", (1, 2)) == \
        jax_envknob.env_int_list("PLUSS_TEST_LIST", (1, 2))


def rihists():
    rng = np.random.default_rng(3)
    out = [{}, {-1: 5.0}, {-1: 0.0, 1: 3.0},
           {-1: 12.0, 1: 40.0, 4: 9.0, 64: 3.5}]
    keys = np.unique(rng.integers(1, 5000, 40))
    out.append({-1: 17.0, **{int(k): float(rng.integers(1, 50))
                              for k in keys}})
    return out


@pytest.mark.parametrize("i", range(5))
@pytest.mark.parametrize("cache_kb", [2560, 1])
def test_plateau_of_matches_jax(i, cache_kb):
    h = rihists()[i]
    cfg, jcfg = SamplerConfig(cache_kb=cache_kb), JaxConfig(cache_kb=cache_kb)
    curve = mrc.aet_mrc(h, cfg)
    assert np.array_equal(curve, jax_mrc.aet_mrc(h, jcfg))
    assert mrc.plateau_of(h, curve) == jax_mrc.plateau_of(h, curve)


def test_l2_error_matches_jax():
    rng = np.random.default_rng(1)
    pairs = [(rng.random(50), rng.random(50)), (rng.random(30),
             rng.random(70)), (np.zeros(4), np.zeros(4)), (np.array([]),
             np.ones(3)), (np.ones(5), np.ones(5))]
    for a, b in pairs:
        assert mrc.l2_error(a, b) == jax_mrc.l2_error(a, b)


@pytest.mark.parametrize("p,n", [(1.0, 7), (0.25, 3), (0.25, 5000),
                                 (0.5, 1), (0.1, 40), (0.9, 3999),
                                 (1 / 3, 12)])
def test_nbd_dilate_p_matches_jax(p, n):
    k, w = cri.nbd_dilate_p(p, n)
    jk, jw = jax_cri.nbd_dilate_p(p, n)
    assert np.array_equal(k, jk) and np.array_equal(w, jw)
    assert not k.flags.writeable and not w.flags.writeable


@pytest.mark.parametrize("t", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 17, 4000])
def test_nbd_dilate_p_at_one_over_t_is_nbd_dilate(t, n):
    k, w = cri.nbd_dilate_p(1.0 / t, n)
    kk, ww = cri.nbd_dilate(t, n)
    assert np.array_equal(k, kk) and np.array_equal(w, ww)


@pytest.mark.parametrize("model", ["gemm", "cholesky", "syrk_tri"])
def test_spec_dump_and_load_match_jax(model, tmp_path):
    js = jax_models.REGISTRY[model](16)
    ts = carried(js)
    text = spec_codec.dump_spec(ts)
    assert text == jax_codec.dump_spec(js)
    assert spec_codec.dump_spec(ts, indent=None) == \
        jax_codec.dump_spec(js, indent=None)
    path = tmp_path / "s.json"
    path.write_text(text + "\n")
    back = spec_codec.load_spec_file(str(path))
    assert back == ts and spec_codec.dump_spec(back) == text
    assert jax_codec.specs_equal(jax_codec.load_spec_file(str(path)), js)
    assert spec_codec.load_spec_text(text) == ts


def test_spec_load_refusals_are_invalid_request(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for path in (str(bad), str(tmp_path / "missing.json")):
        with pytest.raises(InvalidRequest) as got:
            spec_codec.load_spec_file(path)
        with pytest.raises(Exception) as want:
            jax_codec.load_spec_file(path)
        assert type(want.value).__name__ == "InvalidRequest"
        assert str(got.value) == str(want.value)
        assert got.value.site == "spec.codec"
    # a well-formed document that is not a spec: typed too
    with pytest.raises(InvalidRequest):
        spec_codec.load_spec_text('{"name": "x", "arrays": [], "nests": []}')
    with pytest.raises(Exception) as want:
        jax_codec.load_spec_text('{"name": "x", "arrays": [], "nests": []}')
    assert type(want.value).__name__ == "InvalidRequest"
