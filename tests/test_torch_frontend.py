"""The port's authoring frontend (``pluss_torch.frontend``) vs the JAX
package's (``pluss.frontend``), on the CPU.

- the DSL and the pragma-C parser derive the same spec documents from the
  same sources (``tests/test_frontend.py``'s cases), and refuse every
  adversarial source of ``tests/test_frontend_diags.py`` with the same
  PL6xx code and the same message (which names the source line);
- ``emit_dsl`` prints the JAX package's text byte for byte, for all 29
  registry families at the default size and at 24, and the text imports
  back codec-equal in the port, whichever package wrote it; the port's
  ``from_py`` resolves ``from pluss import frontend`` (and the other
  spellings) to its own frontend;
- the PolyBench corpus derives codec-equal to JAX's, and runs on the
  port's engine with every access accounted for;
- ``models.register_spec_dir`` folds ``--register`` files into a
  registry, never shadowing, skipping broken files.

Every source here is a few lines at n <= 32; the corpus is fixed-size
(under 100,000 accesses per family).
"""

import dataclasses
import json

import numpy as np
import pytest

from pluss import engine as jax_engine
from pluss import frontend as jfe
from pluss import models as jax_models
from pluss.frontend import polybench as jax_polybench
from pluss.spec_codec import spec_to_json as jax_doc
from pluss_torch import cri, engine, frontend, mrc, spec_codec
from pluss_torch.analysis.diagnostics import CODES
from pluss_torch.config import SamplerConfig
from pluss_torch.frontend import polybench
from pluss_torch.frontend.ir import FrontendError, FrontendRejected
from pluss_torch.models import REGISTRY, register_spec_dir
from pluss_torch.spec import Loop

def tdoc(spec):
    return spec_codec.spec_to_json(spec)


def gemm_c_source(n: int = 128) -> str:
    src = open(polybench.gemm_source_path()).read()
    return src.replace("#define N 128", f"#define N {n}")


def _refs(loop):
    for b in loop.body:
        if isinstance(b, Loop):
            yield from _refs(b)
        else:
            yield b


# ---------------------------------------------------------------------------
# DSL authoring: the same builder through both frontends


def build_gemm(fe, n):
    with fe.kernel(f"gemm{n}") as k:
        C = fe.array("C", (n, n))
        A = fe.array("A", (n, n))
        B = fe.array("B", (n, n))
        with fe.loop("i", 0, n, parallel=True) as i:
            with fe.loop("j", 0, n) as j:
                fe.read(C, i, j)
                fe.write(C, i, j)
                with fe.loop("k", 0, n) as kk:
                    fe.read(A, i, kk)
                    fe.read(B, kk, j)
                    fe.read(C, i, j)
                    fe.write(C, i, j)
    return k.spec()


def build_deco(fe, n):
    @fe.kernel(f"deco{n}")
    def deco():
        A = fe.array("A", n)
        with fe.loop("i", 0, n, parallel=True) as i:
            fe.read(A, i)

    return deco()


def build_tri(fe, n):
    # `for j in [i+1, n)`: trmm's varying start and varying trip
    with fe.kernel("tri") as k:
        A = fe.array("A", (n, n))
        with fe.loop("i", 0, n, parallel=True) as i:
            with fe.loop("j", i + 1, n) as j:
                fe.read(A, i, j)
    return k.spec()


def build_quad(fe, n):
    # cholesky's k < j inside j < i: a bound on an inner level
    with fe.kernel("quad") as k:
        A = fe.array("A", (n, n))
        with fe.loop("i", 0, n, parallel=True) as i:
            with fe.loop("j", 0, i) as j:
                with fe.loop("kk", 0, j) as kk:
                    fe.read(A, j, kk)
    return k.spec()


def build_back(fe, n):
    # ludcmp's back substitution: i = n-1 .. 0, inner j in [i+1, n)
    with fe.kernel("back") as k:
        x = fe.array("x", n)
        with fe.loop("i", n - 1, -1, step=-1, parallel=True) as i:
            with fe.loop("j", i + 1, n) as j:
                fe.read(x, j)
    return k.spec()


def build_mixed(fe, n):
    # dtypes, explicit names, spans, a linear subscript, trip_max, steps
    with fe.kernel("mixed", auto_span=False) as k:
        A = fe.array("A", (n, n), dtype="f32")
        B = fe.array("B", n * n, dtype=2)
        with fe.loop("i", 0, n, step=2, parallel=True) as i:
            with fe.loop("j", 1, n - 1) as j:
                fe.read(A, i, j - 1, name="west", share_span=7)
                fe.write(B, i * n + j, dtype_bytes=8)
            with fe.loop("j2", 0, i + 1, trip_max=n + 3) as j2:
                fe.read(A, 0 * i + j2, j2)
    return k.spec()


BUILDERS = {"gemm": build_gemm, "deco": build_deco, "tri": build_tri,
            "quad": build_quad, "back": build_back, "mixed": build_mixed}


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_dsl_builder_matches_jax(name, n):
    want = jax_doc(BUILDERS[name](jfe, n))
    got = BUILDERS[name](frontend, n)
    assert tdoc(got) == want


def test_dsl_gemm_equals_registry():
    # the DSL gemm, its derived share span included, is the registry's
    assert spec_codec.specs_equal(build_gemm(frontend, 32),
                                  REGISTRY["gemm"](32))


def test_dsl_lowered_fields():
    n = 16
    loop = build_tri(frontend, n).nests[0].body[0]
    assert (loop.start, loop.start_coef) == (1, 1)
    assert loop.bound_coef == (n - 1, -1) and loop.bound_level == 0
    assert loop.trip == n - 1
    jloop = build_quad(frontend, 12).nests[0].body[0]
    assert jloop.bound_coef == (0, 1) and jloop.bound_level == 0
    assert jloop.body[0].bound_coef == (0, 1)
    assert jloop.body[0].bound_level == 1
    nest = build_back(frontend, 8).nests[0]
    assert (nest.trip, nest.start, nest.step) == (8, 7, -1)
    assert (nest.body[0].start, nest.body[0].start_coef) == (8, -1)
    spec = build_deco(frontend, 8)
    assert spec.name == "deco8" and spec.nests[0].body[0].name == "A0"


def test_dsl_auto_span_only_on_the_observed_ref():
    spans = {r.name: r.share_span
             for r in _refs(build_gemm(frontend, 32).nests[0])}
    assert spans["B0"] is not None and spans["B0"] > 1
    assert all(v is None for nm, v in spans.items() if nm != "B0")


def test_kernel_verified_spec_gates():
    with frontend.kernel("oob") as k:
        A = frontend.array("A", 8)
        with frontend.loop("i", 0, 8, parallel=True) as i:
            frontend.write(A, i + 4)
    with pytest.raises(FrontendRejected) as ei:
        k.verified_spec()
    assert any(d.code == "PL101" for d in ei.value.diagnostics)


# ---------------------------------------------------------------------------
# pragma-C


C_SOURCES = {
    "gemm16": gemm_c_source(16),
    "gemm128": gemm_c_source(128),
    "scalars": """
    #define N 8
    double A[N]; double B[N]; double s;
    #pragma pluss parallel
    for (i = 0; i < N; i++) {
        s = A[i] + sqrt(B[i]);
        A[i] = s * 0.5;
    }
    """,
    "compound": """
    #define N 8
    double C[N]; double A[N]; double B[N];
    #pragma pluss parallel
    for (i = 0; i < N; i++)
        C[i] += A[i] * B[i];
    """,
    "two_nests": """
    #define N 8
    double A[N]; double B[N];
    #pragma pluss parallel
    for (i = 0; i < N; i++) B[i] = A[i];
    #pragma pluss parallel
    for (i = 0; i < N; i++) A[i] = B[i];
    """,
    "suffixes": ("#define N 8L\ndouble A[N];\n#pragma pluss parallel\n"
                 "for (i = 0; i < N; i++) A[i] = A[3u] + 1.0;\n"),
    "types": ("/* f32 and int arrays */\n#include <math.h>\n#define N 8\n"
              "float A[N][N]; int B[N]; long C[N];\n"
              "#pragma pluss parallel\n"
              "for (i = 0; i <= N - 1; i += 1)\n"
              "  for (j = i; j < N; j = j + 1) // triangular\n"
              "    C[j] -= A[i][j] * B[i];\n"),
}


@pytest.mark.parametrize("name", sorted(C_SOURCES))
def test_c_source_matches_jax(name):
    want = jax_doc(jfe.from_c(C_SOURCES[name], name=name))
    assert tdoc(frontend.from_c(C_SOURCES[name], name=name)) == want


def test_c_gemm_equals_registry_and_runs_bit_identical():
    spec = frontend.from_c(gemm_c_source(16), name="gemm_imported")
    assert tdoc(spec)["nests"] == tdoc(REGISTRY["gemm"](16))["nests"]
    cfg = SamplerConfig(thread_num=4, chunk_size=4)
    r1 = engine.run(spec, cfg, device="cpu")
    r2 = engine.run(REGISTRY["gemm"](16), cfg, device="cpu")
    assert r1.noshare_list() == r2.noshare_list()
    assert r1.share_list() == r2.share_list()
    ri1 = cri.distribute(r1.noshare_list(), r1.share_list(), 4)
    ri2 = cri.distribute(r2.noshare_list(), r2.share_list(), 4)
    assert np.array_equal(mrc.aet_mrc(ri1, cfg), mrc.aet_mrc(ri2, cfg))


def test_c_reference_extraction_order():
    refs = list(_refs(frontend.from_c(C_SOURCES["scalars"]).nests[0]))
    assert [(r.array, r.is_write) for r in refs] == [
        ("A", False), ("B", False), ("A", True)]
    refs = list(_refs(frontend.from_c(C_SOURCES["compound"]).nests[0]))
    assert [(r.array, r.is_write) for r in refs] == [
        ("A", False), ("B", False), ("C", False), ("C", True)]
    spec = frontend.from_c(C_SOURCES["suffixes"])
    assert spec.nests[0].trip == 8 and spec.arrays == (("A", 8),)


# ---------------------------------------------------------------------------
# the typed refusals: the same code and message in both packages


HEAD = "#define N 8\ndouble A[N][N];\ndouble B[N];\n"
PAR = HEAD + "#pragma pluss parallel\n"

C_ADVERSARIAL = [
    ("non_affine_product", PAR + "for (i = 0; i < N; i++) for (j = 0; "
     "j < N; j++) A[i][i * j] = 1.0;", "PL601"),
    ("indirect", PAR + "for (i = 0; i < N; i++) B[B[i]] = 1.0;", "PL601"),
    ("division_bound", PAR + "for (i = 0; i < N / 2; i++) B[i] = 1.0;",
     "PL601"),
    ("non_unit_step", PAR + "for (i = 0; i < N; i += 2) B[i] = 1.0;",
     "PL602"),
    ("negative_step", PAR + "for (i = N - 1; i >= 0; i--) B[i] = 1.0;",
     "PL602"),
    ("missing_pragma", HEAD + "for (i = 0; i < N; i++) B[i] = 1.0;",
     "PL603"),
    ("inner_pragma", PAR + "for (i = 0; i < N; i++) {\n#pragma pluss "
     "parallel\nfor (j = 0; j < N; j++) B[j] = 1.0; }", "PL603"),
    ("shadowed", PAR + "for (i = 0; i < N; i++) for (i = 0; i < N; i++) "
     "B[i] = 1.0;", "PL604"),
    ("var_shadows_define", "#define N 4\ndouble A[8];\ndouble B[8];\n"
     "#pragma pluss parallel\nfor (N = 0; N < 8; N++) A[N] = B[N];",
     "PL604"),
    ("bare_array_lvalue", PAR + "for (i = 0; i < N; i++) B = B[i];",
     "PL606"),
    ("array_named_like_define", "#define B 4\ndouble A[8];\ndouble B[8];\n"
     "#pragma pluss parallel\nfor (i = 0; i < 8; i++) A[i] = B[i];",
     "PL604"),
    ("unclosed_brace", PAR + "for (i = 0; i < N; i++) { B[i] = 1.0;",
     "PL605"),
    ("garbage", "what even is this @@@", None),
    ("undeclared", PAR + "for (i = 0; i < N; i++) Z[i] = 1.0;", "PL606"),
    ("arity", PAR + "for (i = 0; i < N; i++) A[i] = 1.0;", "PL606"),
    ("bound_two_vars", PAR + "for (i = 0; i < N; i++) for (j = 0; j < N; "
     "j++) for (k = 0; k < i + j; k++) B[k] = 1.0;", "PL607"),
    ("float_subscript", PAR + "for (i = 0; i < N; i++) B[i * 0.5] = 1.0;",
     "PL601"),
    ("empty", "", None),
    ("pragma_only", "#pragma pluss parallel\n", None),
    ("unknown_pragma", HEAD + "#pragma omp parallel for\n"
     "for (i = 0; i < N; i++) B[i] = 1.0;", None),
]


def raised(fn):
    try:
        fn()
    except FrontendError as e:
        return e
    except jfe.FrontendError as e:
        return e
    raise AssertionError("no FrontendError")


def same_refusal(got, want, code):
    if code is not None:
        assert want.code == code
    assert got.code == want.code
    assert str(got) == str(want)
    assert [(d.code, d.message) for d in got.diagnostics] == \
        [(d.code, d.message) for d in want.diagnostics]
    assert got.code in CODES and not isinstance(got, SyntaxError)


@pytest.mark.parametrize("label,src,code", C_ADVERSARIAL,
                         ids=[c[0] for c in C_ADVERSARIAL])
def test_c_refusal_matches_jax(label, src, code):
    want = raised(lambda: jfe.from_c(src, name="adv"))
    got = raised(lambda: frontend.from_c(src, name="adv"))
    assert isinstance(got, FrontendError)
    same_refusal(got, want, code)


def dsl_non_affine(fe):
    with fe.kernel("adv"):
        A = fe.array("A", 64)
        with fe.loop("i", 0, 8, parallel=True) as i:
            with fe.loop("j", 0, 8) as j:
                fe.read(A, i * j)


def dsl_division(fe):
    with fe.kernel("adv"):
        A = fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True) as i:
            fe.read(A, i // 2)


def dsl_modulo(fe):
    with fe.kernel("adv"):
        A = fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True) as i:
            fe.read(A, 3 % i)


def dsl_power(fe):
    with fe.kernel("adv"):
        A = fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True) as i:
            fe.read(A, i ** 2)


def dsl_true_division(fe):
    with fe.kernel("adv"):
        A = fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True) as i:
            fe.read(A, 8 / i)


def dsl_float_bound(fe):
    fe.loop("i", 0, 8.5)


def dsl_zero_step(fe):
    fe.loop("i", 0, 8, step=0)


def dsl_top_level_not_parallel(fe):
    with fe.kernel("adv"):
        fe.array("A", 8)
        with fe.loop("i", 0, 8):
            pass


def dsl_nested_parallel(fe):
    with fe.kernel("adv"):
        fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True):
            with fe.loop("j", 0, 8, parallel=True):
                pass


def dsl_shadowed(fe):
    with fe.kernel("adv"):
        fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True):
            with fe.loop("i", 0, 8):
                pass


def dsl_ref_outside_loop(fe):
    with fe.kernel("adv"):
        A = fe.array("A", 8)
        fe.read(A, 0)


def dsl_out_of_scope(fe):
    with fe.kernel("adv"):
        A = fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True) as i:
            pass
        with fe.loop("j", 0, 8, parallel=True):
            fe.read(A, i)


def dsl_out_of_scope_zero(fe):
    with fe.kernel("adv") as k:
        A = fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True) as i:
            pass
        with fe.loop("j", 0, 8, parallel=True) as j:
            fe.read(A, j + 0 * i)
    k.spec()


def dsl_duplicate_array(fe):
    with fe.kernel("adv"):
        fe.array("A", 8)
        fe.array("A", 8)


def dsl_bad_shape(fe):
    with fe.kernel("adv"):
        fe.array("A", (8, 0))


def dsl_bad_dtype(fe):
    with fe.kernel("adv"):
        fe.array("A", 8, dtype="quad")


def dsl_bound_two_vars(fe):
    with fe.kernel("adv") as k:
        A = fe.array("A", 64)
        with fe.loop("i", 0, 8, parallel=True) as i:
            with fe.loop("j", 0, 8) as j:
                with fe.loop("k", 0, i + j):
                    fe.read(A, 0)
    k.spec()


def dsl_no_context(fe):
    fe.array("A", 8)


def dsl_dtype_bytes(fe):
    with fe.kernel("adv"):
        A = fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True) as i:
            fe.read(A, i, dtype_bytes="8")


def dsl_loop_reentry(fe):
    with fe.kernel("adv"):
        A = fe.array("A", 8)
        lp = fe.loop("i", 0, 8, parallel=True)
        with lp as i:
            fe.read(A, i)
        with lp as i:
            fe.write(A, i)


def dsl_foreign_handle(fe):
    with fe.kernel("one"):
        A = fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True) as i:
            fe.read(A, i)
    with fe.kernel("two"):
        fe.array("B", 8)
        with fe.loop("i", 0, 8, parallel=True) as i:
            fe.read(A, i)


def dsl_subscript_arity(fe):
    with fe.kernel("adv"):
        A = fe.array("A", (8, 8))
        with fe.loop("i", 0, 8, parallel=True) as i:
            fe.read(A, i, i, i)


def dsl_empty_loop(fe):
    with fe.kernel("adv") as k:
        fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True):
            pass
    k.spec()


def dsl_never_executes(fe):
    with fe.kernel("adv") as k:
        A = fe.array("A", 8)
        with fe.loop("i", 0, 8, parallel=True) as i:
            with fe.loop("j", 4, 4):
                fe.read(A, i)
    k.spec()


def dsl_strided_varying_bound(fe):
    with fe.kernel("adv") as k:
        A = fe.array("A", 64)
        with fe.loop("i", 0, 8, parallel=True) as i:
            with fe.loop("j", 0, i + 1, step=2) as j:
                fe.read(A, j)
    k.spec()


def dsl_no_nest(fe):
    with fe.kernel("adv"):
        fe.array("A", 8)


DSL_ADVERSARIAL = {
    "non_affine": (dsl_non_affine, "PL601"),
    "division": (dsl_division, "PL601"),
    "modulo": (dsl_modulo, "PL601"),
    "power": (dsl_power, "PL601"),
    "true_division": (dsl_true_division, "PL601"),
    "float_bound": (dsl_float_bound, "PL601"),
    "zero_step": (dsl_zero_step, "PL602"),
    "top_level_not_parallel": (dsl_top_level_not_parallel, "PL603"),
    "nested_parallel": (dsl_nested_parallel, "PL603"),
    "shadowed": (dsl_shadowed, "PL604"),
    "ref_outside_loop": (dsl_ref_outside_loop, "PL608"),
    "out_of_scope": (dsl_out_of_scope, "PL608"),
    "out_of_scope_zero": (dsl_out_of_scope_zero, "PL608"),
    "duplicate_array": (dsl_duplicate_array, "PL608"),
    "bad_shape": (dsl_bad_shape, "PL608"),
    "bad_dtype": (dsl_bad_dtype, "PL608"),
    "bound_two_vars": (dsl_bound_two_vars, "PL607"),
    "no_context": (dsl_no_context, "PL608"),
    "dtype_bytes": (dsl_dtype_bytes, "PL608"),
    "loop_reentry": (dsl_loop_reentry, "PL608"),
    "foreign_handle": (dsl_foreign_handle, "PL606"),
    "subscript_arity": (dsl_subscript_arity, "PL606"),
    "empty_loop": (dsl_empty_loop, "PL608"),
    "never_executes": (dsl_never_executes, "PL607"),
    "strided_varying_bound": (dsl_strided_varying_bound, "PL602"),
    "no_nest": (dsl_no_nest, "PL608"),
}


@pytest.mark.parametrize("label", sorted(DSL_ADVERSARIAL))
def test_dsl_refusal_matches_jax(label):
    fn, code = DSL_ADVERSARIAL[label]
    want = raised(lambda: fn(jfe))
    got = raised(lambda: fn(frontend))
    assert isinstance(got, FrontendError)
    same_refusal(got, want, code)


PY_ADVERSARIAL = {
    "name_error": "from pluss import frontend\nfrontend.array('A', "
                  "undefined_n)\n",
    "syntax": "with frontend.kernel('x'):\n  frontend.array('A' 8)\n",
    "no_kernel": "x = 1\n",
    "clash": ("from pluss import frontend\n"
              "for n in (4, 8):\n"
              "    with frontend.kernel('clash'):\n"
              "        A = frontend.array('A', n)\n"
              "        with frontend.loop('i', 0, n, parallel=True) as i:\n"
              "            frontend.read(A, i)\n"),
}


@pytest.mark.parametrize("label", sorted(PY_ADVERSARIAL))
def test_py_refusal_matches_jax(label):
    src = PY_ADVERSARIAL[label]
    want = raised(lambda: jfe.from_py(src, "adv.py"))
    got = raised(lambda: frontend.from_py(src, "adv.py"))
    same_refusal(got, want, None)
    if label == "name_error":
        assert got.code == "PL605"
        assert isinstance(got.__cause__, NameError)


def test_py_decorated_builder_called_twice_collapses():
    src = ("from pluss import frontend\n"
           "@frontend.kernel('twice')\n"
           "def build():\n"
           "    A = frontend.array('A', 8)\n"
           "    with frontend.loop('i', 0, 8, parallel=True) as i:\n"
           "        frontend.read(A, i)\n"
           "build()\nbuild()\n")
    specs = frontend.from_py(src)
    assert [s.name for s in specs] == ["twice"]
    assert [tdoc(s) for s in specs] == [jax_doc(s) for s in jfe.from_py(src)]


def test_unknown_dialect_and_extension(tmp_path):
    for fn in (lambda: frontend.from_source("x", "rust"),
               lambda: frontend.import_path(str(tmp_path / "x.rs")),
               lambda: frontend.import_path(str(tmp_path / "missing.c"))):
        e = raised(fn)
        assert e.code == "PL605"


def test_analyzer_rejection_is_typed_with_findings(tmp_path):
    src = tmp_path / "oob.c"
    src.write_text("#define N 8\ndouble A[N];\n#pragma pluss parallel\n"
                   "for (i = 0; i < N; i++) A[i + 4] = 1.0;\n")
    with pytest.raises(FrontendRejected) as ei:
        frontend.import_path(str(src))
    with pytest.raises(jfe.FrontendRejected) as ej:
        jfe.import_path(str(src))
    assert ei.value.code == "PL609" and str(ei.value) == str(ej.value)
    assert [d.to_dict() for d in ei.value.diagnostics] == \
        [d.to_dict() for d in ej.value.diagnostics]
    assert any(d.code == "PL101" for d in ei.value.diagnostics)


def test_verified_imports_match_jax(tmp_path):
    """``import_path`` with and without a schedule: the same specs and
    the same (warning) diagnostics as JAX's."""
    src = tmp_path / "g16.c"
    src.write_text(gemm_c_source(16))
    cfg = SamplerConfig(thread_num=4, chunk_size=4)
    from pluss.config import SamplerConfig as JaxConfig

    for mine, theirs in ((None, None),
                         (cfg, JaxConfig(thread_num=4, chunk_size=4))):
        got = frontend.import_path(str(src), mine)
        want = jfe.import_path(str(src), theirs)
        assert [tdoc(s) for s, _ in got] == [jax_doc(s) for s, _ in want]
        assert [[d.to_dict() for d in ds] for _, ds in got] == \
            [[d.to_dict() for d in ds] for _, ds in want]


def test_every_pl6xx_code_is_registered():
    family = {c for c in CODES if c.startswith("PL6")}
    assert family == {"PL601", "PL602", "PL603", "PL604", "PL605",
                      "PL606", "PL607", "PL608", "PL609"}
    assert all(CODES[c][0] == "frontend" for c in family)


# ---------------------------------------------------------------------------
# emit_dsl: JAX's text, byte for byte, and the round trip


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_emit_dsl_text_matches_jax_default_size(name):
    assert frontend.emit_dsl(REGISTRY[name]()) == \
        jfe.emit_dsl(jax_models.REGISTRY[name]())


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_emit_dsl_text_matches_jax_at_24(name):
    assert frontend.emit_dsl(REGISTRY[name](24)) == \
        jfe.emit_dsl(jax_models.REGISTRY[name](24))


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_registry_family_roundtrips_through_dsl(name):
    spec = REGISTRY[name]()
    src = frontend.emit_dsl(spec)
    assert src.splitlines()[1] == "from pluss import frontend"
    assert "loop_raw" not in src
    (back,) = frontend.from_py(src, filename=f"<emit:{name}>")
    assert tdoc(back) == tdoc(spec)


@pytest.mark.parametrize("name", ["gemm", "syrk_tri", "cholesky", "ludcmp",
                                  "covariance", "conv2d"])
def test_dsl_text_crosses_between_packages(name):
    """JAX's emitted text imported by the port, and the port's by JAX."""
    jspec = jax_models.REGISTRY[name](24)
    (got,) = frontend.from_py(jfe.emit_dsl(jspec))
    assert tdoc(got) == jax_doc(jspec)
    (back,) = jfe.from_py(frontend.emit_dsl(REGISTRY[name](24)))
    assert jax_doc(back) == jax_doc(jspec)


def test_loop_raw_escape_hatch_matches_jax():
    """A loop the value-space sugar cannot express (a start slope not a
    multiple of the parallel step) emits and imports as ``loop_raw``."""
    src = ("from pluss import frontend\n"
           "with frontend.kernel('raw', auto_span=False):\n"
           "    A = frontend.array('A', 256)\n"
           "    with frontend.loop('c0', 0, 16, step=2, parallel=True):\n"
           "        with frontend.loop_raw('c1', 4, start=1, step=1, "
           "start_coef=3) as c1:\n"
           "            frontend.read(A, c1, name='A0')\n")
    (spec,) = frontend.from_py(src)
    (jspec,) = jfe.from_py(src)
    assert tdoc(spec) == jax_doc(jspec)
    text = frontend.emit_dsl(spec)
    assert "loop_raw" in text and text == jfe.emit_dsl(jspec)
    (back,) = frontend.from_py(text)
    assert tdoc(back) == tdoc(spec)


IMPORT_FORMS = {
    "from_pluss": "from pluss import frontend\n",
    "import_pluss_frontend": "import pluss.frontend\n"
                             "frontend = pluss.frontend\n",
    "import_as": "import pluss.frontend as frontend\n",
    "from_pluss_frontend": "from pluss.frontend import kernel, array, loop, "
                           "read\nimport types\nfrontend = types."
                           "SimpleNamespace(kernel=kernel, array=array, "
                           "loop=loop, read=read)\n",
    "from_pluss_torch": "from pluss_torch import frontend\n",
    "import_pluss": "import pluss\nfrontend = pluss.frontend\n",
    "implicit": "",
}


@pytest.mark.parametrize("form", sorted(IMPORT_FORMS))
def test_from_py_resolves_the_frontend_names_to_the_port(form):
    """Every spelling of the frontend import records into the port, and
    other imports still go to the real import."""
    src = IMPORT_FORMS[form] + (
        "import math\n"
        "with frontend.kernel('k'):\n"
        "    A = frontend.array('A', 16)\n"
        "    with frontend.loop('i', 0, int(math.sqrt(256)), "
        "parallel=True) as i:\n"
        "        frontend.read(A, i)\n")
    (spec,) = frontend.from_py(src)
    assert spec.nests[0].trip == 16
    assert type(spec).__module__ == "pluss_torch.spec"


def test_from_py_other_pluss_names_are_refused():
    e = raised(lambda: frontend.from_py("from pluss import engine\n"))
    assert e.code == "PL605" and isinstance(e.__cause__, ImportError)


# ---------------------------------------------------------------------------
# the PolyBench corpus


@pytest.fixture(scope="module")
def corpus():
    return polybench.import_polybench()


def test_corpus_families(corpus):
    assert set(corpus) == set(polybench.FAMILIES) == \
        set(jax_polybench.FAMILIES)
    assert len(corpus) >= 5 and not set(corpus) & set(REGISTRY)
    assert polybench.import_polybench(families=[]) == {}
    assert polybench.EXAMPLES_DIR.endswith("pluss_torch/frontend/examples")


@pytest.mark.parametrize("family", sorted(polybench.FAMILIES))
def test_corpus_family_matches_jax(corpus, family):
    want = jax_polybench.import_polybench(families=[family])[family]
    assert tdoc(corpus[family]) == jax_doc(want)
    with open(polybench.source_path(family)) as f, \
            open(jax_polybench.source_path(family)) as g:
        assert f.read() == g.read()


def test_corpus_gemm_source_code_is_jax_s():
    """The same code below a header comment of as many lines, so every
    diagnostic names the same source line."""
    with open(polybench.gemm_source_path()) as f, \
            open(jax_polybench.gemm_source_path()) as g:
        mine, theirs = f.read(), g.read()
    cut, jcut = mine.index("#define N 128"), theirs.index("#define N 128")
    assert mine[cut:] == theirs[jcut:]
    assert mine[:cut].count("\n") == theirs[:jcut].count("\n")


@pytest.mark.parametrize("family", sorted(polybench.FAMILIES))
def test_corpus_family_runs_on_the_port_engine(corpus, family):
    res = engine.run(corpus[family], device="cpu")
    assert res.max_iteration_count > 0
    assert int(res.noshare_dense.sum()) + sum(
        sum(d.values()) for d in res.share_raw) == res.max_iteration_count


def test_corpus_jacobi1d_matches_the_jax_engine(corpus):
    spec = corpus["jacobi1d"]
    got = engine.run(spec, device="cpu")
    want = jax_engine.run(
        jax_polybench.import_polybench(families=["jacobi1d"])["jacobi1d"])
    assert got.noshare_list() == want.noshare_list()
    assert got.share_list() == want.share_list()
    assert got.max_iteration_count == want.max_iteration_count


# ---------------------------------------------------------------------------
# the spec codec and the file registry


def test_codec_dump_load_roundtrip(tmp_path):
    spec = REGISTRY["cholesky"](16)
    path = tmp_path / "chol.json"
    path.write_text(spec_codec.dump_spec(spec))
    assert spec_codec.specs_equal(spec_codec.load_spec_file(str(path)), spec)
    assert not spec_codec.specs_equal(spec, REGISTRY["cholesky"](12))


def test_register_spec_dir_folds_and_never_shadows(tmp_path, capsys):
    spec = frontend.from_c(gemm_c_source(12), name="gemm12")
    (tmp_path / "gemm12.json").write_text(spec_codec.dump_spec(spec))
    (tmp_path / "gemm.json").write_text(spec_codec.dump_spec(
        dataclasses.replace(REGISTRY["gemm"](8), name="gemm")))
    (tmp_path / "notes.txt").write_text("not a spec")
    registry = {"gemm": REGISTRY["gemm"]}
    assert register_spec_dir(str(tmp_path), registry) == ["gemm12"]
    assert "already registered; not shadowing" in capsys.readouterr().err
    assert registry["gemm"] is REGISTRY["gemm"]
    built = registry["gemm12"]()
    assert spec_codec.specs_equal(built, spec) and built.nests[0].trip == 12
    assert spec_codec.specs_equal(registry["gemm12"](999), spec)
    err = capsys.readouterr().err
    assert "fixed-size spec; ignoring n=999" in err
    registry["gemm12"](5)           # noticed once per spec
    assert capsys.readouterr().err == ""
    assert register_spec_dir(str(tmp_path), registry) == []


def test_register_spec_dir_skips_broken(tmp_path, capsys):
    (tmp_path / "broken.json").write_text("{nope")
    (tmp_path / "partial.json").write_text(json.dumps({"name": "x"}))
    registry: dict = {}
    assert register_spec_dir(str(tmp_path), registry) == []
    assert registry == {}
    assert capsys.readouterr().err.count("skipping") == 2
    assert register_spec_dir(str(tmp_path / "missing"), registry) == []
    assert "cannot read PLUSS_SPEC_DIR" in capsys.readouterr().err
