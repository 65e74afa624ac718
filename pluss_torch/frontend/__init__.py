"""``pluss_torch.frontend`` — the loop-nest AUTHORING subsystem (the
port's copy of ``pluss/frontend``).

Two entry surfaces, one verified artifact: the Python loop-nest DSL
(:mod:`pluss_torch.frontend.dsl`) and the pragma-annotated-C parser
(:mod:`pluss_torch.frontend.cparse`) both record a small
surface-independent IR (:mod:`pluss_torch.frontend.ir`) that ONE
normalizer (:mod:`pluss_torch.frontend.lower`) turns into a
:class:`~pluss_torch.spec.LoopNestSpec` — and every derived spec passes
the lint (plus, schedule given, the schedule-aware analysis) before
anyone runs it.  ``cli import file.py|file.c [--run|--json|--register]``
is the command line's way in, and ``frontend.import_polybench()`` derives
the checked-in PolyBench corpus (:mod:`pluss_torch.frontend.polybench`).

Out-of-grammar constructs raise typed ``PL6xx``
:class:`FrontendError`\\ s (registered in the analyzer's CODES table);
an analyzer rejection of a grammatical source raises
:class:`FrontendRejected` with the findings attached.
``emit_dsl(spec)`` prints any spec back as DSL source, byte for byte the
JAX package's text; :func:`from_py` runs such text (it says ``from pluss
import frontend``) against this package's frontend.
"""

from __future__ import annotations

from pluss_torch.frontend.cparse import parse_c
from pluss_torch.frontend.dsl import (ArrayHandle, Kernel, array,
                                      collect_kernels, kernel, loop,
                                      loop_raw, read, write)
from pluss_torch.frontend.emit import emit_dsl
from pluss_torch.frontend.ir import (FrontendError, FrontendRejected,
                                     LinExpr, err)
from pluss_torch.frontend.lower import derive_spans, lower, verify_spec


def from_c(src: str, name: str = "source"):
    """Pragma-C text -> ONE LoopNestSpec (a file's pragma nests are one
    workload, like the reference's ``gemm.ppcg_omp.c``).  No analyzer
    gate — callers gate via :func:`verify_spec`."""
    return lower(parse_c(src, name))


def _dsl_builtins(frontend_mod) -> dict:
    """The builtins a DSL file runs under: the real ones, with an
    ``__import__`` that resolves the JAX package's frontend names
    (``pluss`` and ``pluss.frontend``: :func:`emit_dsl` writes ``from
    pluss import frontend``) to this package's frontend, so the file's
    kernels record here whether or not the JAX package is importable.
    Any other part of ``pluss`` is an ImportError, in every process;
    ``pluss_torch.frontend`` is this module already, and every other name
    goes to the real import."""
    import builtins
    import types

    shim = types.ModuleType("pluss")
    shim.frontend = frontend_mod
    real = builtins.__import__

    def dsl_import(name, globals=None, locals=None, fromlist=(), level=0):
        if level or name.split(".")[0] != "pluss":
            return real(name, globals, locals, fromlist, level)
        if name == "pluss":
            wanted = [f for f in fromlist or () if f != "frontend"]
        else:
            wanted = [] if name == "pluss.frontend" \
                else [name[len("pluss."):]]
        if wanted:
            raise ImportError(f"a DSL file imports only the frontend from "
                              f"pluss, not {', '.join(wanted)}")
        # `from pluss.frontend import x` wants the module itself,
        # `import pluss.frontend` the top package
        return frontend_mod if name == "pluss.frontend" and fromlist \
            else shim

    return {**vars(builtins), "__import__": dsl_import}


def from_py(src: str, filename: str = "<dsl>"):
    """Execute DSL source text, collecting every kernel it records ->
    list of LoopNestSpecs (ungated, like :func:`from_c`).  CLI-only
    surface: this EXECUTES the text — never feed it wire input.  The
    text may import the frontend as ``pluss.frontend`` (the JAX
    package's name, which :func:`emit_dsl` writes) or as
    ``pluss_torch.frontend``: both are this package's."""
    import pluss_torch.frontend as frontend_mod

    ns = {"frontend": frontend_mod, "__name__": "__pluss_dsl__",
          "__builtins__": _dsl_builtins(frontend_mod)}
    with collect_kernels() as kernels:
        try:
            code = compile(src, filename, "exec")
        except SyntaxError as e:
            raise err("PL605", f"{filename}: not valid Python DSL "
                               f"source: {e}") from e
        try:
            exec(code, ns)
        except FrontendError:
            raise              # already typed, with its own code
        except Exception as e:
            # a plain Python bug in the DSL file (NameError, ...) must
            # still reach `cli import` as a typed rejection, not a raw
            # traceback; __cause__ keeps the chain for debugging
            raise err("PL605", f"{filename}: DSL source raised "
                               f"{type(e).__name__}: {e}") from e
    if not kernels:
        raise err("PL608", f"{filename}: no frontend.kernel(...) block "
                           "finished recording")
    # a decorated builder called N times records N identical kernels:
    # exact duplicates collapse (the call was idempotent), but two
    # DIFFERENT specs under one name would silently overwrite each
    # other downstream (--register files, registry entries) — typed
    from pluss_torch.spec_codec import spec_to_json

    out, seen = [], {}
    for k in kernels:
        spec = k.spec()
        doc = spec_to_json(spec)
        if spec.name in seen:
            if seen[spec.name] == doc:
                continue
            raise err("PL608",
                      f"{filename}: two different kernels named "
                      f"{spec.name!r} — names must be unique per file")
        seen[spec.name] = doc
        out.append(spec)
    return out


def from_source(src: str, lang: str, name: str = "source"):
    """Dispatch by dialect: ``c`` -> one-spec list, ``py`` -> kernels."""
    if lang == "c":
        return [from_c(src, name)]
    if lang == "py":
        return from_py(src, name)
    raise err("PL605", f"unknown source dialect {lang!r} (c | py)")


def import_path(path: str, cfg=None):
    """``cli import``'s core: read a ``.py`` or ``.c`` file, derive
    its spec(s), and run the analyzer ADMISSION GATE on each (ERROR
    findings raise :class:`FrontendRejected` with the findings
    attached).  Returns ``[(spec, diagnostics), ...]``."""
    import os

    stem = os.path.splitext(os.path.basename(path))[0]
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".c", ".py"):
        raise err("PL605", f"{path}: unknown source extension {ext!r} "
                           "(expected .c or .py)")
    try:
        with open(path) as f:
            src = f.read()
    except OSError as e:
        raise err("PL605", f"cannot read {path}: {e}") from e
    specs = from_source(src, "c" if ext == ".c" else "py", name=stem)
    return [(spec, verify_spec(spec, cfg)) for spec in specs]


__all__ = [
    "ArrayHandle", "FrontendError", "FrontendRejected", "Kernel",
    "LinExpr", "array", "collect_kernels", "derive_spans", "emit_dsl",
    "from_c", "from_py", "from_source", "import_path", "kernel", "loop",
    "loop_raw", "lower", "parse_c", "read", "verify_spec", "write",
]
