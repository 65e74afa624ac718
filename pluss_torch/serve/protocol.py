"""The serving wire protocol: JSONL requests/responses + the admission gate
(the port's copy of ``pluss/serve/protocol.py``; the wire is the JAX
package's, so either package's client talks to either package's server).

One request = one JSON object = one line.  Three request shapes share the
schema (exactly one selector per request):

- ``{"model": "gemm", "n": 64, ...}`` — a registry model at a size;
- ``{"spec": {...}, ...}`` — an inline :class:`~pluss_torch.spec.LoopNestSpec`
  (see :func:`spec_from_json`; :func:`spec_to_json` is its inverse —
  both come from :mod:`pluss_torch.spec_codec`);
- ``{"source": "...", "lang": "c", ...}`` — inline pragma-annotated C
  source (the ``gemm.ppcg_omp.c`` subset) the FRONTEND derives a spec
  from (:mod:`pluss_torch.frontend`), then admits through the very same
  analyzer gate and shared-dispatch path as an inline spec.  Only the
  ``c`` dialect is served: the Python DSL executes caller code and is a
  CLI-only surface (``cli import file.py``), never a wire one;
- ``{"trace": "/path/refs.bin", "fmt": "u64", ...}`` — a packed-trace
  replay (a SERVER-side path: the daemon serves local callers, it is not
  an internet-facing file service).

Common fields: ``id`` (echoed; assigned when absent), schedule knobs
(``threads``/``chunk``/``ds``/``cls``), ``window``, ``share_cap``,
``output`` (``mrc`` | ``histogram`` | ``both``), ``deadline_ms`` (from
admission), ``verify`` (opt into the full schedule-aware analysis on
top of the always-on lint gate), and ``sleep_ms`` (a documented
load-generator knob that holds the device loop — how the tests make
sheds and queue pressure deterministic).

Responses echo ``id`` with ``ok: true`` plus the result payload, or
``ok: false`` with a typed ``error`` object mirroring the resilience
taxonomy (``Overloaded``, ``DeadlineExceeded``, ``InvalidRequest``, …)
so clients can key backoff/retry policy on ``error.type`` +
``error.retryable``, never on message text.

The ADMISSION GATE lives here (:func:`parse_request`): spec requests are
validated through the static analyzer (ERROR diagnostics reject the
request with the findings attached) and bounded by
``PLUSS_SERVE_MAX_REFS`` before any device work is scheduled; verdicts
are memoized per spec so a hot model lints once, not per request.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import socket
import threading
import time

from pluss_torch import obs
from pluss_torch.config import SHARE_CAP, SamplerConfig
from pluss_torch.resilience.errors import InvalidRequest, PlussError
from pluss_torch.spec import LoopNestSpec, SpecContractError, loop_size
from pluss_torch.spec_codec import SpecDecodeError, spec_to_json  # noqa: F401
from pluss_torch.spec_codec import spec_from_json as _decode

#: default per-request stream bound (total accesses across threads): big
#: enough for the flagship gemm-1024 (4.3e9), small enough that one rogue
#: inline spec cannot wedge the shared device loop for hours
MAX_REFS_DEFAULT = 1 << 34

_anon_ids = itertools.count(1)


#: default per-request STATIC-COST bound: predicted refs plus the
#: line-weighted footprint, both from the static analyzer — a spec is
#: priced on what it will actually make the device loop do, not just its
#: raw stream length.  Wide enough for gemm-1024 (cost ~4.3e9)
MAX_COST_DEFAULT = 1 << 35

#: default weight of one footprint line in the cost formula (a distinct
#: line costs a last-access-table slot and sort bandwidth per window)
LINE_COST_DEFAULT = 64

#: footprint masks allocate O(declared lines) booleans; refuse to even
#: price a spec whose declared arrays exceed this (hostile-spec guard)
_COST_LINES_CAP = 1 << 28


def max_serve_refs() -> int:
    from pluss_torch.utils.envknob import env_int

    return env_int("PLUSS_SERVE_MAX_REFS", MAX_REFS_DEFAULT)


def max_serve_cost() -> int:
    from pluss_torch.utils.envknob import env_int

    return env_int("PLUSS_SERVE_MAX_COST", MAX_COST_DEFAULT)


def serve_line_cost() -> int:
    from pluss_torch.utils.envknob import env_int

    return env_int("PLUSS_SERVE_LINE_COST", LINE_COST_DEFAULT, minimum=0)


def spec_from_json(obj) -> LoopNestSpec:
    """Decode an inline spec document (:mod:`pluss_torch.spec_codec`);
    every malformation is the typed :class:`InvalidRequest` the JAX
    package's codec raises, with the same message and site."""
    try:
        return _decode(obj)
    except SpecDecodeError as e:
        raise InvalidRequest(str(e), site="spec.codec", cause=e) from e


@functools.lru_cache(maxsize=256)
def _static_cost(spec: LoopNestSpec, cfg: SamplerConfig) -> tuple[int, int]:
    """Memoized (predicted refs, touched footprint lines) of one spec
    under one schedule — the static analyzer's exact counts
    (:func:`pluss_torch.analysis.footprint.footprints`), shared across requests
    like the lint verdict."""
    from pluss_torch.analysis import footprint

    fp = footprint.footprints(spec, cfg)
    return int(fp.accesses), int(fp.total)


# ---------------------------------------------------------------------------
# requests


@dataclasses.dataclass
class Request:
    """One parsed, ADMITTED request plus its serving bookkeeping."""

    id: str
    kind: str                     # "spec" | "trace" | "sleep"
    cfg: SamplerConfig
    #: which selector admitted it: "spec" | "trace" | "sleep" | "source"
    #: ("source" requests become kind "spec" once the frontend derives
    #: their LoopNestSpec — batching and execution are selector-blind —
    #: but the SLO counters keep the ingestion surface visible)
    origin: str = ""
    spec: LoopNestSpec | None = None
    trace: str | None = None
    fmt: str = "u64"
    share_cap: int = SHARE_CAP
    window: int | None = None
    output: str = "mrc"
    sleep_ms: float = 0.0
    #: projected device bytes of the trace's resident staging (trace
    #: requests; admission-time pricing) — the server serves
    #: resident only when this fits the residency budget
    hbm_bytes: int = 0
    #: absolute monotonic deadline (set at admission), None = no deadline
    deadline: float | None = None
    #: monotonic admission instant (latency measurements)
    t_admit: float = 0.0
    #: response writer installed by the connection handler:
    #: ``reply(dict)`` — must be safe to call from the device loop
    reply: object = None
    #: fairness id (``obj["tenant"]``): the DRR queue round-robins across
    #: these and the token bucket meters per value; "" is the shared
    #: anonymous tenant
    tenant: str = ""
    #: True once the request sits in the serve journal as ``open`` — the
    #: first claimed reply marks it ``done``
    journaled: bool = False
    #: claim-once guard: with a watchdog, a hard-bounded drain, and a
    #: stale device loop all able to answer the same request, exactly ONE
    #: of them may win (see :meth:`claim`)
    answered: bool = False
    _claim_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def claim(self) -> bool:
        """Test-and-set the once-only right to answer this request.
        Returns True exactly once; late repliers (a stale abandoned
        device loop, a deadline racing the watchdog) get False and must
        stay silent."""
        with self._claim_lock:
            if self.answered:
                return False
            self.answered = True
            return True

    def is_claimed(self) -> bool:
        """Non-consuming peek at the claim flag: lets a dispatch path
        skip members somebody (the watchdog, a forced drain) already
        answered, WITHOUT eating their claim."""
        with self._claim_lock:
            return self.answered

    def remaining_s(self) -> float | None:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        r = self.remaining_s()
        return r is not None and r <= 0

    def batch_key(self) -> tuple:
        """Shared-dispatch compatibility key: requests with equal keys are
        satisfiable by ONE device dispatch (same plan, same compiled
        shape — see :func:`pluss_torch.engine.dispatch_key`), with per-request
        views demultiplexed on return.  ``output``/``deadline``/``id``
        are deliberately absent — response shaping is demux work, not
        dispatch work.  Sleep requests never coalesce (each holds the
        loop on purpose)."""
        if self.kind == "spec":
            from pluss_torch import engine

            return ("spec",) + engine.dispatch_key(
                self.spec, self.cfg, self.share_cap, self.window)
        if self.kind == "trace":
            return ("trace", self.trace, self.fmt, self.cfg.cls,
                    self.window)
        return ("sleep", self.id)


@functools.lru_cache(maxsize=256)
def _lint_verdict(spec: LoopNestSpec) -> tuple:
    """Memoized admission verdict: () for clean, else the ERROR
    diagnostics as JSON-able dicts.  Hot models lint once, not per
    request."""
    from pluss_torch import analysis

    diags = analysis.lint_spec(spec)
    errs = [d for d in diags if d.severity is analysis.Severity.ERROR]
    return tuple(
        {"code": d.code, "severity": "ERROR", "message": d.message}
        for d in errs
    )


@functools.lru_cache(maxsize=128)
def _analyze_verdict(spec: LoopNestSpec, cfg: SamplerConfig) -> tuple:
    """Memoized schedule-aware verdict for ``verify: true``
    requests — placement-refined races + false sharing under the
    request's own schedule."""
    from pluss_torch import analysis

    diags, _ = analysis.analyze_spec(spec, cfg)
    errs = [d for d in diags if d.severity is analysis.Severity.ERROR]
    return tuple(
        {"code": d.code, "severity": "ERROR", "message": d.message}
        for d in errs
    )


@functools.lru_cache(maxsize=64)
def _derive_source_spec(src: str, name: str) -> LoopNestSpec:
    """Memoized frontend derivation for serve ``source`` requests (the
    parse + lower + share-span race analysis dominates admission cost;
    specs are frozen, so sharing the object across requests is safe).
    Rejections raise and are deliberately NOT cached — errors stay
    cheap to recompute and never poison the memo."""
    from pluss_torch.frontend import from_c

    return from_c(src, name=name)


def _spec_from_source(rid: str, obj) -> LoopNestSpec:
    """Derive a spec from an inline ``source`` request via the frontend's
    pragma-C parser.  Every frontend rejection — tokenizer, grammar,
    lowering — is a typed :class:`InvalidRequest` with the PL6xx
    diagnostics attached as data, exactly like an analyzer rejection."""
    src = obj.get("source")
    if not isinstance(src, str) or not src.strip():
        raise InvalidRequest(
            f"request {rid!r}: source must be a non-empty string",
            site="serve.parse")
    lang = obj.get("lang", "c")
    if lang != "c":
        # the Python DSL EXECUTES caller code; it is a CLI surface
        # (`cli import file.py`), never a wire one
        raise InvalidRequest(
            f"request {rid!r}: lang must be 'c' (the pragma-C subset); "
            f"got {lang!r} — the Python DSL is not served",
            site="serve.parse")
    from pluss_torch.frontend import FrontendError

    name = obj.get("name")
    if name is not None and not isinstance(name, str):
        raise InvalidRequest(f"request {rid!r}: name must be a string",
                             site="serve.parse")
    try:
        # memoized like _lint_verdict: a hot source (the daemon's
        # amortization story) parses + lowers + derives spans ONCE, not
        # per request.  The derived name is part of the key — and kept
        # request-stable (no per-request anon ids) so the memo can hit.
        return _derive_source_spec(src, name or "source")
    except FrontendError as e:
        raise InvalidRequest(
            f"request {rid!r}: source rejected by the frontend: {e}",
            site="serve.frontend", cause=e,
            diagnostics=tuple(d.to_dict() for d in e.diagnostics))


def parse_request(obj, default_deadline_ms: float | None = None) -> Request:
    """Parse + ADMIT one request object; raises :class:`InvalidRequest`
    on any malformation, unknown model, analyzer rejection, or size
    bound.  On success the request is stamped with its admission instant
    and absolute deadline."""
    if not isinstance(obj, dict):
        raise InvalidRequest(
            f"request must be a JSON object, got {type(obj).__name__}",
            site="serve.parse")
    rid = obj.get("id")
    if rid is None:
        rid = f"anon-{next(_anon_ids)}"
    rid = str(rid)

    selectors = [k for k in ("model", "spec", "trace", "source")
                 if obj.get(k) is not None]
    if "sleep_ms" in obj and not selectors:
        selectors = ["sleep"]
    if len(selectors) != 1:
        raise InvalidRequest(
            f"request {rid!r} must name exactly one of "
            f"model/spec/trace/source (got {selectors or 'none'})",
            site="serve.parse")

    def opt_int(key: str, default, minimum: int = 1):
        v = obj.get(key)
        if v is None:
            return default
        if isinstance(v, bool) or not isinstance(v, int) or v < minimum:
            raise InvalidRequest(
                f"request {rid!r}: {key!r} must be an integer >= "
                f"{minimum}, got {v!r}", site="serve.parse")
        return v

    cfg = SamplerConfig(thread_num=opt_int("threads", 4),
                        chunk_size=opt_int("chunk", 4),
                        ds=opt_int("ds", 8),
                        cls=opt_int("cls", 64),
                        cache_kb=opt_int("cache_kb", 2560))
    output = obj.get("output", "mrc")
    if output not in ("mrc", "histogram", "both"):
        raise InvalidRequest(
            f"request {rid!r}: output must be mrc|histogram|both, got "
            f"{output!r}", site="serve.parse")
    dl_ms = obj.get("deadline_ms", default_deadline_ms)
    if dl_ms is not None and (isinstance(dl_ms, bool) or not isinstance(
            dl_ms, (int, float)) or dl_ms <= 0):
        raise InvalidRequest(
            f"request {rid!r}: deadline_ms must be a positive number",
            site="serve.parse")
    tenant = obj.get("tenant", "")
    if not isinstance(tenant, str) or len(tenant) > 128:
        raise InvalidRequest(
            f"request {rid!r}: tenant must be a string of <= 128 chars",
            site="serve.parse")
    now = time.monotonic()
    req = Request(
        id=rid,
        tenant=tenant,
        kind="sleep" if selectors == ["sleep"] else
             ("trace" if selectors == ["trace"] else "spec"),
        origin=selectors[0] if selectors[0] in ("trace", "sleep", "source")
               else "spec",
        cfg=cfg,
        share_cap=opt_int("share_cap", SHARE_CAP),
        window=opt_int("window", None),
        output=output,
        deadline=(now + dl_ms / 1e3) if dl_ms is not None else None,
        t_admit=now,
    )
    if req.kind == "sleep":
        ms = obj.get("sleep_ms")
        if isinstance(ms, bool) or not isinstance(ms, (int, float)) \
                or ms < 0 or ms > 60_000:
            raise InvalidRequest(
                f"request {rid!r}: sleep_ms must be in [0, 60000]",
                site="serve.parse")
        req.sleep_ms = float(ms)
        return req
    if req.kind == "trace":
        path = obj.get("trace")
        fmt = obj.get("fmt", "u64")
        if not isinstance(path, str) or not path:
            raise InvalidRequest(f"request {rid!r}: trace must be a path",
                                 site="serve.parse")
        if fmt not in ("u64", "text"):
            raise InvalidRequest(
                f"request {rid!r}: fmt must be u64|text, got {fmt!r}",
                site="serve.parse")
        import os

        if not os.path.exists(path):
            raise InvalidRequest(
                f"request {rid!r}: no such trace file: {path}",
                site="serve.parse")
        if fmt == "u64":
            # admission prices the stream like the spec path prices
            # static cost: the ref count reads off the file size,
            # so an oversized trace is refused typed at parse time —
            # and the projected resident-staging bytes ride the request
            # so the server can account device memory before serving it
            # resident
            refs = os.path.getsize(path) // 8
            bound = max_serve_refs()
            if refs > bound:
                raise InvalidRequest(
                    f"request {rid!r}: trace of {refs} refs exceeds the "
                    f"per-request bound {bound} (PLUSS_SERVE_MAX_REFS)",
                    site="serve.admission")
            from pluss_torch import trace as trace_mod

            win = req.window or trace_mod.TRACE_WINDOW
            batch = trace_mod.WINDOWS_PER_BATCH * win
            req.hbm_bytes = -(-max(refs, 1) // batch) * batch * 3
        req.trace, req.fmt = path, fmt
        # the trace path's admission gate is the size/format pricing
        # above — record the verdict like the spec lint gate does, so a
        # traced replay's causal tree starts at admission either way
        obs.trace_event("admission.verdict", trace=os.path.basename(path),
                        verdict="admit", errors=0)
        return req
    # spec request: registry model, inline spec, or frontend-derived
    # source, then the analyzer gate
    if req.origin == "source":
        spec = _spec_from_source(rid, obj)
    elif obj.get("model") is not None:
        from pluss_torch.models import REGISTRY

        model = obj["model"]
        if model not in REGISTRY:
            raise InvalidRequest(
                f"request {rid!r}: unknown model {model!r}",
                site="serve.parse")
        n = opt_int("n", None)   # builders do not validate sizes
        try:
            spec = REGISTRY[model](n) if n is not None \
                else REGISTRY[model]()
        except (SpecContractError, ValueError, TypeError) as e:
            raise InvalidRequest(
                f"request {rid!r}: building {model}({n}) failed: {e}",
                site="serve.parse", cause=e)
    else:
        spec = spec_from_json(obj["spec"])
        try:   # the spec contract runs at plan time; fail it at ADMISSION
            for nest in spec.nests:
                from pluss_torch.spec import flatten_nest

                flatten_nest(nest)
        except SpecContractError as e:
            raise InvalidRequest(
                f"request {rid!r}: spec rejected: {e}",
                site="serve.parse", cause=e,
                diagnostics=({"code": e.code, "severity": "ERROR",
                              "message": str(e)},))
    total = sum(loop_size(nst) for nst in spec.nests)
    bound = max_serve_refs()
    if total > bound:
        raise InvalidRequest(
            f"request {rid!r}: stream of {total} accesses exceeds the "
            f"per-request bound {bound} (PLUSS_SERVE_MAX_REFS)",
            site="serve.parse")
    errs = _lint_verdict(spec)
    if not errs and obj.get("verify"):
        errs = _analyze_verdict(spec, cfg)
    # attribution only inside a bound serve request (the connection
    # handler binds the rid before parsing); CLI and test callers of
    # parse_request emit nothing
    obs.trace_event("admission.verdict", spec=spec.name,
                    verdict="reject" if errs else "admit",
                    errors=len(errs))
    if errs:
        raise InvalidRequest(
            f"request {rid!r}: spec {spec.name!r} rejected by the static "
            f"analyzer ({len(errs)} ERROR diagnostic(s))",
            site="serve.admission", diagnostics=errs)
    # STATIC-COST pricing (after the lint gate: only well-formed specs
    # are worth pricing): predicted refs + line-weighted footprint from
    # the analyzer's exact counts, so a short-stream/huge-footprint spec
    # can't slip under the raw PLUSS_SERVE_MAX_REFS stream bound
    cost_bound = max_serve_cost()
    line_w = serve_line_cost()
    declared = sum(spec.line_counts(cfg))
    if declared > _COST_LINES_CAP:
        raise InvalidRequest(
            f"request {rid!r}: declared arrays span {declared} cache "
            f"lines — beyond what admission will even price "
            f"(PLUSS_SERVE_MAX_COST)", site="serve.admission")
    # the price does not depend on cache_kb: memoized without it, a
    # tenant's cache-size variants of a hot model price once
    refs, fp_lines = _static_cost(spec, dataclasses.replace(cfg, cache_kb=0))
    cost = refs + line_w * fp_lines
    if cost > cost_bound:
        raise InvalidRequest(
            f"request {rid!r}: static cost {cost} (predicted {refs} refs "
            f"+ {line_w}x{fp_lines} footprint lines) exceeds the "
            f"per-request bound {cost_bound} (PLUSS_SERVE_MAX_COST)",
            site="serve.admission")
    req.spec = spec
    return req


# ---------------------------------------------------------------------------
# responses


def error_response(rid: str | None, err: BaseException) -> dict:
    """Typed error payload: PlussErrors keep their taxonomy bits; anything
    else is wrapped as a fatal internal error (no raw tracebacks cross
    the wire)."""
    if isinstance(err, PlussError):
        e = {"type": type(err).__name__, "message": str(err),
             "retryable": bool(err.retryable),
             "degradable": bool(err.degradable)}
        diags = getattr(err, "diagnostics", ())
        if diags:
            e["diagnostics"] = list(diags)
        # sheds name their suggested back-off so clients don't have to
        # guess (token-bucket refill, the breaker's next probe slot, ...)
        retry_after = getattr(err, "retry_after_ms", None)
        if retry_after is not None:
            e["retry_after_ms"] = int(retry_after)
    else:
        e = {"type": "InternalError",
             "message": f"{type(err).__name__}: {err}",
             "retryable": False, "degradable": False}
    return {"id": rid, "ok": False, "error": e}


def result_payload(req: Request, rihist: dict, cfg: SamplerConfig) -> dict:
    """Shape one request's demuxed result per its ``output`` field.
    ``rihist`` is the merged reuse-interval histogram (the CRI output for
    spec requests, ``ReplayResult.histogram()`` for traces)."""
    from pluss_torch import mrc

    out: dict = {}
    if req.output in ("mrc", "both"):
        curve = mrc.aet_mrc(rihist, cfg)
        out["mrc"] = [[int(c), float(m)] for c, m in mrc.dedup_lines(curve)]
    if req.output in ("histogram", "both"):
        out["histogram"] = {str(int(k)): float(v)
                            for k, v in sorted(rihist.items())}
    return out


# ---------------------------------------------------------------------------
# client


def parse_addr(addr: str) -> tuple:
    """``host:port`` → a TCP address, anything else → a unix socket path."""
    if ":" in addr and not addr.startswith("/") and "/" not in addr:
        host, _, port = addr.rpartition(":")
        try:
            return ("tcp", host or "127.0.0.1", int(port))
        except ValueError:
            pass
    return ("unix", addr)


class Client:
    """Minimal JSONL client for one server connection (load generators,
    tests).

    Not thread-safe; one Client per client thread.  ``request`` assigns
    an id when absent and blocks until THAT id's response arrives
    (buffering any other ids, which :meth:`request_many` drains)."""

    def __init__(self, addr: str, timeout: float = 120.0):
        kind, *rest = parse_addr(addr)
        if kind == "tcp":
            self._sock = socket.create_connection(
                (rest[0], rest[1]), timeout=timeout)
        else:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(timeout)
            self._sock.connect(rest[0])
        self._rfile = self._sock.makefile("rb")
        self._pending: dict[str, dict] = {}
        self._n = 0

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def send(self, obj: dict) -> str:
        """Fire one request without waiting; returns its id."""
        if obj.get("id") is None:
            self._n += 1
            obj = {**obj, "id": f"c{self._n}"}
        self._sock.sendall(json.dumps(obj).encode() + b"\n")
        return str(obj["id"])

    def _read_one(self) -> dict:
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def recv(self, rid: str) -> dict:
        """Block until the response for ``rid`` arrives."""
        if rid in self._pending:
            return self._pending.pop(rid)
        while True:
            resp = self._read_one()
            if str(resp.get("id")) == rid:
                return resp
            self._pending[str(resp.get("id"))] = resp

    def request(self, obj: dict) -> dict:
        return self.recv(self.send(obj))

    def request_many(self, objs: list[dict]) -> list[dict]:
        """Pipeline all requests on this connection, then collect every
        response (order matches ``objs``)."""
        ids = [self.send(o) for o in objs]
        return [self.recv(i) for i in ids]
