"""``stats``: aggregate one telemetry JSONL stream into a report.

The port's copy of ``pluss/obs/stats.py``, whole: on any stream it prints
what the JAX package's ``pluss stats`` prints, byte for byte, so a stream
written by either package reads the same in both.  The blocks of layers
the port does not have yet (serve, shard, warm start, autotune) stay, so
the reader is whole; they render only when their counters are present.

Renders the span tree (per name-path: count, total wall incl. children,
self time excl. children), event counts, counter/gauge rollups
(cumulative counters: the LAST record per name wins), and — when the
trace-replay counters are present — the replay time breakdown the feed-
bound diagnosis needs: reader prefetch-stall seconds, h2d staging time
and MB/s, per-batch device time, checkpoint cost, what fraction of the
replay's wall clock those buckets account for, plus the parallel-feed
extras: concurrent wire-encode seconds across the worker pool and the
wire-vs-device byte ratio (how much the compressed d24v wire shaved off
the transport).

``--check`` validates the stream against the schema instead (exit 1 on
any violation).  A torn FINAL line is tolerated with a notice — that is
the expected crash artifact of the sink's append discipline; torn or
alien lines anywhere else are violations.
"""

from __future__ import annotations

import json

from pluss_torch.obs.telemetry import EVENT_KINDS, SCHEMA_VERSION


def load(path: str) -> tuple[list[dict], list[str], list[str]]:
    """(records, problems, notes) of one stream.  ``problems`` are schema
    violations (--check failures); ``notes`` are tolerated oddities."""
    problems: list[str] = []
    notes: list[str] = []
    records: list[dict] = []
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict) or "ev" not in rec:
                raise ValueError("not a telemetry record")
        except ValueError as e:
            if i == len(lines) - 1:
                notes.append(f"dropped torn final line (crash artifact): "
                             f"{line[:40]!r}")
                break
            problems.append(f"line {i + 1}: unparseable record: {e}")
            continue
        records.append(rec)
    p2, n2 = _check_schema(records)
    return records, problems + p2, notes + n2


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_schema(records: list[dict]) -> tuple[list[str], list[str]]:
    """(problems, notes).  A dangling span parent is a PROBLEM in a
    finished stream (it has an ``end`` record — the sink closed cleanly,
    so every parent must have recorded) but only a NOTE in a truncated
    one: children record at exit before their still-open ancestors, so a
    crash mid-span legitimately orphans them (the same tolerance as the
    torn final line)."""
    problems: list[str] = []
    notes: list[str] = []
    if not records:
        return ["empty stream (no records)"], notes
    finished = any(r.get("ev") == "end" for r in records)
    span_ids: set[int] = set()
    for r in records:
        if r.get("ev") == "span":
            sid = r.get("id")
            if isinstance(sid, int):
                if sid in span_ids:
                    problems.append(f"duplicate span id {sid}")
                span_ids.add(sid)
    for i, r in enumerate(records, 1):
        ev = r["ev"]
        if ev not in EVENT_KINDS:
            problems.append(f"record {i}: unknown ev kind {ev!r}")
            continue
        if ev == "meta":
            if i != 1:
                problems.append(f"record {i}: meta must be the first record")
            schema = r.get("schema")
            if not isinstance(schema, int) or schema > SCHEMA_VERSION:
                problems.append(
                    f"record {i}: schema {schema!r} is newer than this "
                    f"reader understands ({SCHEMA_VERSION})")
            continue
        if i == 1:
            problems.append("record 1: stream must start with a meta record")
        if ev == "span":
            if not isinstance(r.get("name"), str) or not r.get("name"):
                problems.append(f"record {i}: span without a name")
            if not isinstance(r.get("id"), int):
                problems.append(f"record {i}: span without an integer id")
            if not _is_num(r.get("t")) or not _is_num(r.get("dur")) \
                    or r.get("dur", 0) < 0:
                problems.append(f"record {i}: span needs numeric t and "
                                "non-negative dur")
            par = r.get("parent")
            if par is not None and par not in span_ids:
                msg = (f"record {i}: span parent {par!r} matches no span "
                       "in the stream")
                if finished:
                    problems.append(msg)
                else:
                    notes.append(msg + " (open ancestor lost to a crash; "
                                 "aggregating at the root)")
        elif ev in ("counter", "gauge"):
            if not isinstance(r.get("name"), str) or not r.get("name"):
                problems.append(f"record {i}: {ev} without a name")
            if not _is_num(r.get("value")):
                problems.append(f"record {i}: {ev} {r.get('name')!r} "
                                "without a numeric value")
        elif ev == "event":
            if not isinstance(r.get("name"), str) or not r.get("name"):
                problems.append(f"record {i}: event without a name")
        elif ev == "end":
            if not _is_num(r.get("dur")):
                problems.append(f"record {i}: end record without a dur")
    return problems, notes


# ---------------------------------------------------------------------------
# aggregation


class _Node:
    __slots__ = ("name", "count", "total", "self_s", "children")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.self_s = 0.0
        self.children: dict[str, _Node] = {}


def _span_tree(records: list[dict]) -> _Node:
    """Aggregate span instances into a name-path tree (root is synthetic).

    Children are emitted before parents (spans record at exit), so paths
    resolve in a second pass over the id → record map.  A span whose
    parent never recorded (e.g. torn by a crash) aggregates at the root.
    """
    spans = {r["id"]: r for r in records
             if r.get("ev") == "span" and isinstance(r.get("id"), int)}
    child_dur: dict[int, float] = {}
    for r in spans.values():
        p = r.get("parent")
        if p is not None:
            child_dur[p] = child_dur.get(p, 0.0) + float(r.get("dur", 0.0))

    def path_of(r: dict) -> tuple[str, ...]:
        names: list[str] = []
        seen: set[int] = set()
        cur: dict | None = r
        while cur is not None and cur["id"] not in seen:
            seen.add(cur["id"])
            names.append(str(cur.get("name", "?")))
            cur = spans.get(cur.get("parent"))
        return tuple(reversed(names))

    root = _Node("")
    for r in spans.values():
        node = root
        for name in path_of(r):
            node = node.children.setdefault(name, _Node(name))
        node.count += 1
        dur = float(r.get("dur", 0.0))
        node.total += dur
        node.self_s += max(0.0, dur - child_dur.get(r["id"], 0.0))
    return root


def _metric_rollup(records: list[dict], kind: str) -> dict[str, float]:
    """Last value per name (counter records are cumulative snapshots)."""
    out: dict[str, float] = {}
    for r in records:
        if r.get("ev") == kind and isinstance(r.get("name"), str) \
                and _is_num(r.get("value")):
            out[r["name"]] = float(r["value"])
    return out


def _fmt_val(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else f"{v:.6g}"


def _render_spans(node: _Node, lines: list[str], depth: int) -> None:
    kids = sorted(node.children.values(),
                  key=lambda n: (-n.total, n.name))
    for k in kids:
        label = "  " + ". " * depth + k.name
        lines.append(f"{label:<44} {k.count:>5}  {k.total:>9.3f}s "
                     f"{k.self_s:>9.3f}s")
        _render_spans(k, lines, depth + 1)


def trace_breakdown(counters: dict[str, float],
                    wall: float | None) -> list[str]:
    """The feed-bound diagnosis block: stall / h2d / device / checkpoint
    buckets vs the replay's wall time.  Empty when the trace counters are
    absent from the stream."""
    buckets = [("reader prefetch stall", "trace.prefetch_stall_s"),
               ("h2d staging", "trace.h2d_s"),
               ("device compute", "trace.device_s"),
               ("checkpoint saves", "trace.ckpt_save_s"),
               ("table growth", "trace.grow_s")]
    if not any(k in counters for _, k in buckets):
        return []
    lines = ["trace replay breakdown:"]
    if wall is not None:
        lines.append(f"  {'wall (trace.replay_file span)':<28} {wall:>9.3f}s")
    accounted = 0.0
    for label, key in buckets:
        if key not in counters:
            continue
        v = counters[key]
        accounted += v
        pct = f"  {100.0 * v / wall:>5.1f}%" if wall else ""
        extra = ""
        if key == "trace.device_s" and counters.get("trace.batches"):
            nb = counters["trace.batches"]
            extra = f"  ({v / nb:.4f}s/batch over {int(nb)} batches)"
        lines.append(f"  {label:<28} {v:>9.3f}s{pct}{extra}")
    if wall:
        lines.append(f"  {'accounted':<28} {accounted:>9.3f}s of "
                     f"{wall:.3f}s wall ({100.0 * accounted / wall:.1f}%)")
    h2d_b, h2d_s = counters.get("trace.h2d_bytes"), counters.get("trace.h2d_s")
    if h2d_b and h2d_s:
        lines.append(f"  {'h2d rate':<28} {h2d_b / 1e6 / h2d_s:>9.1f} MB/s")
    # feed-worker wire-encode runs CONCURRENTLY with the buckets above
    # (pool threads), so it reports beside the wall accounting, not in it
    enc = counters.get("trace.wire_encode_s")
    if enc is not None:
        lines.append(f"  {'wire encode (feed workers)':<28} {enc:>9.3f}s"
                     "  (concurrent)")
    dev_b = counters.get("trace.device_bytes")
    if h2d_b and dev_b:
        lines.append(
            f"  {'wire compression':<28} {h2d_b / 1e6:>9.1f} MB wire vs "
            f"{dev_b / 1e6:.1f} MB device ({dev_b / h2d_b:.2f}x)")
    if counters.get("trace.refs_replayed") and wall:
        lines.append(f"  {'replay rate':<28} "
                     f"{counters['trace.refs_replayed'] / wall:>9.3g} refs/s")
    return lines


def serve_breakdown(counters: dict[str, float],
                    gauges: dict[str, float]) -> list[str]:
    """The serving SLO block: request outcomes, latency quantiles, batch
    occupancy (how many requests each device dispatch served), queue
    pressure, and the per-request resilience activity.  Empty when the
    serve counters are absent from the stream."""
    total = counters.get("serve.requests")
    if not total:
        return []
    lines = ["serve SLO:"]
    kinds = [f"{k[len('serve.requests.'):]} {int(v)}"
             for k, v in sorted(counters.items())
             if k.startswith("serve.requests.")]
    lines.append(f"  {'requests':<28} {int(total):>9}"
                 + (f"  ({', '.join(kinds)})" if kinds else ""))
    for label, key in (("ok", "serve.ok"),
                       ("errors", "serve.errors"),
                       ("shed (admission)", "serve.shed"),
                       ("deadline exceeded", "serve.deadline_exceeded"),
                       ("admission rejects", "serve.admission_rejects")):
        v = counters.get(key)
        if v:
            pct = 100.0 * v / total
            lines.append(f"  {label:<28} {int(v):>9}  ({pct:.1f}%)")
    p50, p99 = gauges.get("serve.p50_ms"), gauges.get("serve.p99_ms")
    if p50 is not None or p99 is not None:
        lines.append(
            f"  {'latency p50 / p99':<28} "
            f"{_fmt_val(p50) if p50 is not None else '?':>9} / "
            f"{_fmt_val(p99) if p99 is not None else '?'} ms")
    batches = counters.get("serve.batches")
    if batches:
        members = counters.get("serve.batched_requests", 0.0)
        lines.append(
            f"  {'batches dispatched':<28} {int(batches):>9}  "
            f"(occupancy {members / batches:.2f} req/dispatch, "
            f"{int(members - batches)} dispatch(es) coalesced away)")
    qd = gauges.get("serve.queue_depth")
    if qd is not None:
        lines.append(f"  {'queue depth (last)':<28} {_fmt_val(qd):>9}")
    rungs = counters.get("resilience.rungs_taken")
    if rungs:
        per = [f"{k[len('resilience.rungs_taken.'):]}={int(v)}"
               for k, v in sorted(counters.items())
               if k.startswith("resilience.rungs_taken.")]
        lines.append(f"  {'ladder rungs taken':<28} {int(rungs):>9}"
                     + (f"  ({', '.join(per)})" if per else ""))
    hits = counters.get("engine.plan_cache.hit")
    if hits is not None or counters.get("engine.plan_cache.miss"):
        miss = counters.get("engine.plan_cache.miss", 0.0)
        ev = counters.get("engine.plan_cache.evict", 0.0)
        lines.append(f"  {'plan cache hit/miss/evict':<28} "
                     f"{int(hits or 0):>9} / {int(miss)} / {int(ev)}")
    return lines


def warmstart_breakdown(counters: dict[str, float],
                        gauges: dict[str, float]) -> list[str]:
    """The warm-start block: XLA compile seconds actually paid by this
    process, AOT executable sidecar hit/miss/restore-failure traffic,
    single-flight dedup, and serve/sweep warmup activity.  Empty when the
    stream has no compile or AOT activity at all (a fully warm process
    that restored nothing shows its aot_hit count here)."""
    keys = ("engine.compiles", "engine.compile_s",
            "engine.plan_cache.aot_hit", "engine.plan_cache.aot_miss",
            "engine.plan_cache.aot_load_fail")
    if not any(counters.get(k) for k in keys):
        return []
    lines = ["warm start:"]
    comp = counters.get("engine.compiles", 0.0)
    comp_s = counters.get("engine.compile_s", 0.0)
    lines.append(f"  {'compiles paid':<28} {int(comp):>9}  "
                 f"({comp_s:.3f}s wall)")
    hit = counters.get("engine.plan_cache.aot_hit", 0.0)
    miss = counters.get("engine.plan_cache.aot_miss", 0.0)
    fail = counters.get("engine.plan_cache.aot_load_fail", 0.0)
    lines.append(f"  {'aot exe hit/miss/load_fail':<28} "
                 f"{int(hit):>9} / {int(miss)} / {int(fail)}")
    waits = counters.get("engine.compile_singleflight_waits")
    if waits:
        lines.append(f"  {'single-flight dedup waits':<28} {int(waits):>9}")
    warmed = counters.get("serve.warmed")
    if warmed or counters.get("serve.warm_fail"):
        wf = counters.get("serve.warm_fail", 0.0)
        lines.append(f"  {'serve warmup (ok / fail)':<28} "
                     f"{int(warmed or 0):>9} / {int(wf)}")
    parked = counters.get("serve.compile_parked")
    if parked:
        lines.append(f"  {'serve batches parked':<28} {int(parked):>9}")
    pre = counters.get("sweep.precompiles")
    if pre:
        lines.append(f"  {'sweep points precompiled':<28} {int(pre):>9}")
    infl = gauges.get("serve.compile_inflight")
    if infl is not None:
        lines.append(f"  {'compile in flight (last)':<28} "
                     f"{_fmt_val(infl):>9}")
    return lines


def shard_breakdown(counters: dict[str, float],
                    gauges: dict[str, float]) -> list[str]:
    """The multi-chip scale-out block: chunk dispatch volume, how much
    rebalancing the work-stealing dispatcher actually did, and each
    device's busy fraction (a balanced fleet shows near-equal fractions;
    a straggler-bound one shows the gap stealing is closing).  Empty when
    the stream has no shard dispatch activity."""
    chunks = counters.get("shard.chunks")
    if not chunks:
        return []
    lines = ["shard scale-out:"]
    lines.append(f"  {'chunks dispatched':<28} {int(chunks):>9}")
    steals = counters.get("shard.steals", 0.0)
    lines.append(f"  {'chunks stolen':<28} {int(steals):>9}  "
                 f"({100.0 * steals / chunks:.1f}%)")
    busy = sorted(((int(k.rsplit(".", 1)[1]), v)
                   for k, v in gauges.items()
                   if k.startswith("shard.device_busy_frac.")))
    if busy:
        lines.append("  device busy fractions (last) "
                     + " ".join(f"d{i}={v:.2f}" for i, v in busy))
    retries = counters.get("engine.share_cap_retries")
    if retries:
        lines.append(f"  {'share-cap retries':<28} {int(retries):>9}")
    deaths = counters.get("multihost.worker_deaths")
    if deaths:
        salv = counters.get("multihost.salvages", 0.0)
        lines.append(f"  {'worker deaths / salvages':<28} "
                     f"{int(deaths):>9} / {int(salv)}")
    return lines


def residency_breakdown(counters: dict[str, float],
                        gauges: dict[str, float]) -> list[str]:
    """The trace residency block (r13): HBM store hit traffic, eviction
    and fallback pressure, stage-through population, and the last
    resident footprint vs budget.  Empty when the stream has no
    residency activity at all."""
    hits = counters.get("residency.hit", 0.0)
    misses = counters.get("residency.miss", 0.0)
    keys = ("residency.hit", "residency.miss", "residency.evict",
            "residency.stage_through", "residency.fallback")
    if not any(counters.get(k) for k in keys):
        return []
    lines = ["trace residency:"]
    total = hits + misses
    rate = f"  ({100.0 * hits / total:.1f}% hit)" if total else ""
    lines.append(f"  {'store hits / misses':<28} "
                 f"{int(hits):>9} / {int(misses)}{rate}")
    st = counters.get("residency.stage_through")
    if st:
        lines.append(f"  {'entries staged through':<28} {int(st):>9}")
    ev = counters.get("residency.evict")
    if ev:
        lines.append(f"  {'LRU evictions':<28} {int(ev):>9}")
    fb = counters.get("residency.fallback")
    if fb:
        lines.append(f"  {'budget fallbacks (streamed)':<28} {int(fb):>9}")
    pins = counters.get("residency.pin")
    if pins:
        lines.append(f"  {'replay pins':<28} {int(pins):>9}")
    res = gauges.get("trace.hbm_resident_bytes")
    if res is not None:
        lines.append(f"  {'resident bytes (last)':<28} "
                     f"{res / 1e6:>9.1f} MB")
    qh = gauges.get("serve.queue_hbm_bytes")
    if qh:
        lines.append(f"  {'queued HBM demand (last)':<28} "
                     f"{qh / 1e6:>9.1f} MB")
    return lines


_BREAKER_STATE = {0: "closed", 1: "half_open", 2: "open"}


def hardening_breakdown(counters: dict[str, float],
                        gauges: dict[str, float]) -> list[str]:
    """The fleet-hardening block (r14): request-journal traffic and
    recovery, circuit-breaker trips with brown-out/shed volume, watchdog
    abandons, tenant rate-limit sheds, and connection-layer protection.
    Empty when none of the hardening machinery fired (a healthy daemon
    with no journal configured prints nothing here)."""
    keys = ("serve.journal.appended", "serve.journal.recovered",
            "serve.breaker.open", "serve.breaker.brownout",
            "serve.breaker.shed", "serve.watchdog.abandoned",
            "serve.fairness.rate_limited", "serve.conn_shed",
            "serve.conn_idle_closed", "serve.drain_forced")
    if not any(counters.get(k) for k in keys) \
            and gauges.get("serve.breaker.state") is None:
        return []
    lines = ["serve hardening:"]
    app = counters.get("serve.journal.appended")
    if app or counters.get("serve.journal.completed"):
        comp = counters.get("serve.journal.completed", 0.0)
        lines.append(f"  {'journal appended / done':<28} "
                     f"{int(app or 0):>9} / {int(comp)}")
    rec = counters.get("serve.journal.recovered")
    if rec:
        exp = counters.get("serve.journal.expired", 0.0)
        lines.append(f"  {'recovered (of them expired)':<28} "
                     f"{int(rec):>9}  ({int(exp)} expired)")
    rot = counters.get("serve.journal.rotations")
    if rot:
        lines.append(f"  {'journal compactions':<28} {int(rot):>9}")
    jfail = counters.get("serve.journal.append_fail")
    if jfail:
        lines.append(f"  {'journal append failures':<28} {int(jfail):>9}")
    opens = counters.get("serve.breaker.open")
    if opens or gauges.get("serve.breaker.state") is not None:
        closes = counters.get("serve.breaker.close", 0.0)
        reopens = counters.get("serve.breaker.reopen", 0.0)
        state = gauges.get("serve.breaker.state")
        now = f"  (now {_BREAKER_STATE.get(int(state), '?')})" \
            if state is not None else ""
        lines.append(f"  {'breaker open/close/reopen':<28} "
                     f"{int(opens or 0):>9} / {int(closes)} / "
                     f"{int(reopens)}{now}")
    bo = counters.get("serve.breaker.brownout")
    if bo:
        lines.append(f"  {'spec brown-outs (cpu)':<28} {int(bo):>9}")
    bs = counters.get("serve.breaker.shed")
    if bs:
        lines.append(f"  {'trace sheds (breaker open)':<28} {int(bs):>9}")
    ab = counters.get("serve.watchdog.abandoned")
    if ab:
        abr = counters.get("serve.watchdog.abandoned_requests", 0.0)
        lines.append(f"  {'watchdog abandons':<28} {int(ab):>9}  "
                     f"({int(abr)} request(s) answered retryable)")
    rl = counters.get("serve.fairness.rate_limited")
    if rl:
        lines.append(f"  {'tenant rate-limit sheds':<28} {int(rl):>9}")
    at = gauges.get("serve.fairness.active_tenants")
    if at:
        lines.append(f"  {'active tenants (last)':<28} {_fmt_val(at):>9}")
    cs = counters.get("serve.conn_shed")
    ic = counters.get("serve.conn_idle_closed")
    if cs or ic:
        lines.append(f"  {'conns shed / idle-closed':<28} "
                     f"{int(cs or 0):>9} / {int(ic or 0)}")
    df = counters.get("serve.drain_forced")
    if df:
        lines.append(f"  {'forced drains':<28} {int(df):>9}")
    return lines


def interference_breakdown(counters: dict[str, float],
                           gauges: dict[str, float]) -> list[str]:
    """The co-tenancy interference block (r15): advisory stamps the
    serving path attached to responses dispatched with other workloads
    queued behind them, how many crossed the severe (PL801) bar, and the
    last observed miss-ratio inflation.  Empty when no dispatch ever had
    a co-tenant (solo traffic prints nothing here)."""
    adv = counters.get("serve.interference.advisories")
    errs = counters.get("serve.interference.errors")
    if not adv and not errs:
        return []
    lines = ["co-tenancy interference:"]
    sev = counters.get("serve.interference.severe", 0.0)
    lines.append(f"  {'advisories (of them severe)':<28} "
                 f"{int(adv or 0):>9}  ({int(sev)} PL801)")
    infl = gauges.get("serve.interference.last_inflation")
    if infl is not None:
        lines.append(f"  {'last inflation':<28} {_fmt_val(infl):>9}")
    if errs:
        lines.append(f"  {'advisory errors (no stamp)':<28} "
                     f"{int(errs):>9}")
    return lines


def placement_breakdown(counters: dict[str, float],
                        gauges: dict[str, float]) -> list[str]:
    """The interference-aware placement block (r16): how often the
    batcher's lead pick consulted the static pairwise-interference cost
    (``PLUSS_SERVE_PLACEMENT=on``), how many picks actually reordered
    within a tenant's backlog, memo efficiency, and the last chosen
    pair's predicted cost.  Empty on the advisory-only A/B control."""
    ch = counters.get("serve.placement.choices")
    errs = counters.get("serve.placement.errors")
    if not ch and not errs:
        return []
    lines = ["interference-aware placement:"]
    re_ = counters.get("serve.placement.reorders", 0.0)
    lines.append(f"  {'choices (of them reorders)':<28} "
                 f"{int(ch or 0):>9}  ({int(re_)} reordered)")
    mh = counters.get("serve.placement.memo_hits")
    if mh:
        lines.append(f"  {'pair-cost memo hits':<28} {int(mh):>9}")
    hr = counters.get("serve.placement.head_rescues")
    if hr:
        lines.append(f"  {'starvation-guard rescues':<28} {int(hr):>9}")
    cost = gauges.get("serve.placement.last_cost")
    if cost is not None:
        lines.append(f"  {'last pair cost':<28} {_fmt_val(cost):>9}")
    if errs:
        lines.append(f"  {'placement errors (FIFO kept)':<28} "
                     f"{int(errs):>9}")
    return lines


def autotune_breakdown(counters: dict[str, float],
                       gauges: dict[str, float]) -> list[str]:
    """The fused-kernel / autotuner block (r19): Pallas compile-probe
    traffic and loud XLA fallbacks, plus the geometry sidecar's consult
    outcomes — ``hit`` means a later run reused the persisted winner with
    zero re-calibration, ``stale`` a salt-mismatched or quarantined
    sidecar, ``probe`` one timed calibration point.  Empty when the
    stream has neither Pallas nor autotune activity."""
    keys = ("pallas.probe", "pallas.fallback",
            "autotune.probe", "autotune.hit", "autotune.stale")
    if not any(counters.get(k) for k in keys):
        return []
    lines = ["kernels & autotune:"]
    pp = counters.get("pallas.probe")
    if pp or counters.get("pallas.fallback"):
        fb = counters.get("pallas.fallback", 0.0)
        lines.append(f"  {'pallas probes / fallbacks':<28} "
                     f"{int(pp or 0):>9} / {int(fb)}"
                     + ("  (fused kernels DISABLED, XLA path)"
                        if fb else ""))
    hit = counters.get("autotune.hit")
    stale = counters.get("autotune.stale")
    if hit or stale:
        lines.append(f"  {'geometry hits / stale':<28} "
                     f"{int(hit or 0):>9} / {int(stale or 0)}")
    cal = counters.get("autotune.probe")
    if cal:
        lines.append(f"  {'calibration points timed':<28} {int(cal):>9}")
    return lines


def slo_breakdown(counters: dict[str, float],
                  gauges: dict[str, float]) -> list[str]:
    """The SLO burn-rate block (r20): error-budget consumption over the
    daemon's lifetime plus the live multi-window burn gauges the router
    tier keys off.  Empty when the SLO monitor never recorded an outcome
    (non-serve streams print nothing here)."""
    good = counters.get("serve.slo.good", 0.0)
    bad = counters.get("serve.slo.bad", 0.0)
    total = good + bad
    if not total:
        return []
    lines = ["serve SLO burn:"]
    target = gauges.get("serve.slo.target")
    frac = bad / total
    burn = f"  (burn {frac / target:.2f}x budget)" if target else ""
    lines.append(f"  {'outcomes good / bad':<28} "
                 f"{int(good):>9} / {int(bad)}  ({100.0 * frac:.2f}% bad)"
                 + burn)
    if target is not None:
        lines.append(f"  {'budgeted bad fraction':<28} "
                     f"{100.0 * target:>8.2f}%")
    bf = gauges.get("serve.slo.burn_fast")
    bs = gauges.get("serve.slo.burn_slow")
    if bf is not None or bs is not None:
        lines.append(
            f"  {'burn fast / slow (last)':<28} "
            f"{_fmt_val(round(bf, 3)) if bf is not None else '?':>9} / "
            f"{_fmt_val(round(bs, 3)) if bs is not None else '?'}")
    dumps = counters.get("flight.dumps")
    if dumps:
        lines.append(f"  {'flight recorder dumps':<28} {int(dumps):>9}")
    return lines


# ---------------------------------------------------------------------------
# per-request trace view (--trace)


def _trace_matches(rec: dict, rid: str) -> bool:
    """A record belongs to request ``rid`` when stamped with its trace id
    directly, or — for the coalesced batch span — when ``rid`` appears in
    the span's ``traces`` member list."""
    if rec.get("trace") == rid:
        return True
    attrs = rec.get("attrs")
    if isinstance(attrs, dict):
        tr = attrs.get("traces")
        if isinstance(tr, (list, tuple)) and rid in tr:
            return True
    return False


def _attr_suffix(rec: dict) -> str:
    attrs = rec.get("attrs")
    parts = []
    if rec.get("error"):
        parts.append(f"error={rec['error']}")
    if isinstance(attrs, dict):
        for k in sorted(attrs):
            v = attrs[k]
            if isinstance(v, float):
                v = _fmt_val(round(v, 6))
            elif isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            parts.append(f"{k}={v}")
    return ("  [" + " ".join(parts) + "]") if parts else ""


def render_trace(records: list[dict], rid: str, out) -> int:
    """Render one request's causal span tree: every span/event stamped
    with ``rid``, nested by parent where the parent is also part of the
    trace (cross-thread stages whose parent span belongs to another
    thread's bookkeeping list at the root, ordered by start time)."""
    spans = [r for r in records
             if r.get("ev") == "span" and _trace_matches(r, rid)
             and isinstance(r.get("id"), int)]
    events = [r for r in records
              if r.get("ev") == "event" and _trace_matches(r, rid)]
    if not spans and not events:
        out.write(f"trace {rid}: no records in stream\n")
        return 1
    sel = {r["id"] for r in spans}
    kids: dict[int, list[dict]] = {}
    roots: list[dict] = []
    for r in spans:
        p = r.get("parent")
        (kids.setdefault(p, []) if p in sel else roots).append(r)
    ev_kids: dict[int, list[dict]] = {}
    loose: list[dict] = []
    for e in events:
        p = e.get("parent")
        (ev_kids.setdefault(p, []) if p in sel else loose).append(e)
    out.write(f"trace {rid}: {len(spans)} span(s), {len(events)} "
              f"event(s)\n")
    out.write(f"  {'stage':<44} {'start':>10} {'dur':>10}\n")

    def emit(rec: dict, depth: int) -> None:
        label = "  " + ". " * depth + str(rec.get("name", "?"))
        t = float(rec.get("t", 0.0))
        dur = float(rec.get("dur", 0.0))
        out.write(f"{label:<46} {t:>9.4f}s {dur:>9.4f}s"
                  f"{_attr_suffix(rec)}\n")
        branch = [(float(c.get("t", 0.0)), 0, "span", c)
                  for c in kids.get(rec["id"], [])]
        branch += [(float(e.get("t", 0.0)), 1, "event", e)
                   for e in ev_kids.get(rec["id"], [])]
        for _, _, kind, item in sorted(branch, key=lambda x: (x[0], x[1])):
            if kind == "span":
                emit(item, depth + 1)
            else:
                emit_event(item, depth + 1)

    def emit_event(rec: dict, depth: int) -> None:
        label = "  " + ". " * depth + "* " + str(rec.get("name", "?"))
        t = float(rec.get("t", 0.0))
        out.write(f"{label:<46} {t:>9.4f}s {'-':>10}"
                  f"{_attr_suffix(rec)}\n")

    items = [(float(r.get("t", 0.0)), 0, "span", r) for r in roots]
    items += [(float(e.get("t", 0.0)), 1, "event", e) for e in loose]
    for _, _, kind, item in sorted(items, key=lambda x: (x[0], x[1])):
        if kind == "span":
            emit(item, 0)
        else:
            emit_event(item, 0)
    return 0


# ---------------------------------------------------------------------------
# live tail (--follow)


def _follow_line(rec: dict) -> str | None:
    """One-line live rendering of a record; None skips it (meta noise)."""
    ev = rec.get("ev")
    tr = f"  trace={rec['trace']}" if rec.get("trace") else ""
    t = rec.get("t")
    ts = f"{float(t):>9.3f}s " if _is_num(t) else " " * 11
    if ev == "span":
        return (f"{ts}span  {rec.get('name', '?'):<36} "
                f"{float(rec.get('dur', 0.0)):>9.4f}s{tr}"
                f"{_attr_suffix(rec)}")
    if ev == "event":
        return (f"{ts}event {rec.get('name', '?'):<36} {'':>10}{tr}"
                f"{_attr_suffix(rec)}")
    if ev in ("counter", "gauge"):
        return (f"{ts}{ev:<5} {rec.get('name', '?'):<36} "
                f"{_fmt_val(rec.get('value', 0)):>10}")
    if ev == "end":
        return f"{ts}end   (stream closed, {rec.get('dur', '?')}s wall)"
    return None


def follow(path: str, out, err, poll_s: float = 0.25,
           max_idle_s: float | None = None) -> int:
    """Tail a growing telemetry stream, one line per record, until the
    ``end`` record lands (daemon shut down) or the reader is interrupted.
    Only COMPLETE lines render — a partially-flushed record waits for its
    newline, mirroring the sink's torn-line discipline."""
    import time as _time

    buf = b""
    pos = 0
    idle = 0.0
    appeared = False
    try:
        while True:
            try:
                with open(path, "rb") as f:
                    f.seek(pos)
                    chunk = f.read()
                appeared = True
            except FileNotFoundError:
                # tailing a stream the daemon hasn't created yet is the
                # normal startup race — wait it out inside the idle budget
                idle += poll_s
                if max_idle_s is not None and idle >= max_idle_s:
                    if appeared:
                        return 0
                    err.write(f"pluss stats: follow: no such stream "
                              f"{path}\n")
                    return 2
                _time.sleep(poll_s)
                continue
            if chunk:
                idle = 0.0
                pos += len(chunk)
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if not isinstance(rec, dict):
                        continue
                    rendered = _follow_line(rec)
                    if rendered is not None:
                        out.write(rendered + "\n")
                        out.flush()
                    if rec.get("ev") == "end":
                        return 0
            else:
                idle += poll_s
                if max_idle_s is not None and idle >= max_idle_s:
                    return 0
                _time.sleep(poll_s)
    except KeyboardInterrupt:
        return 0
    except OSError as e:
        err.write(f"pluss stats: follow: {e}\n")
        return 2


def render(records: list[dict], out) -> None:
    """Write the human report for one loaded stream."""
    n_spans = sum(1 for r in records if r.get("ev") == "span")
    n_events = sum(1 for r in records if r.get("ev") == "event")
    finished = any(r.get("ev") == "end" for r in records)
    out.write(f"telemetry stream: {len(records)} records, {n_spans} "
              f"span(s), {n_events} event(s)"
              + ("" if finished else "  [no end record: stream truncated]")
              + "\n")
    root = _span_tree(records)
    if root.children:
        lines = [f"  {'span':<42} {'n':>5}  {'total':>10} {'self':>10}"]
        _render_spans(root, lines, 0)
        out.write("spans:\n" + "\n".join(lines) + "\n")
    ev_counts: dict[str, int] = {}
    for r in records:
        if r.get("ev") == "event" and isinstance(r.get("name"), str):
            ev_counts[r["name"]] = ev_counts.get(r["name"], 0) + 1
    if ev_counts:
        out.write("events:\n")
        for name in sorted(ev_counts):
            out.write(f"  {name:<42} {ev_counts[name]:>7}\n")
    counters = _metric_rollup(records, "counter")
    if counters:
        out.write("counters:\n")
        for name in sorted(counters):
            out.write(f"  {name:<42} {_fmt_val(counters[name]):>12}\n")
    gauges = _metric_rollup(records, "gauge")
    if gauges:
        out.write("gauges (last value):\n")
        for name in sorted(gauges):
            out.write(f"  {name:<42} {_fmt_val(gauges[name]):>12}\n")
    replay = root.children.get("trace.replay_file")
    wall = replay.total if replay is not None else None
    block = trace_breakdown(counters, wall)
    if block:
        out.write("\n".join(block) + "\n")
    sblock = serve_breakdown(counters, gauges)
    if sblock:
        out.write("\n".join(sblock) + "\n")
    wblock = warmstart_breakdown(counters, gauges)
    if wblock:
        out.write("\n".join(wblock) + "\n")
    shblock = shard_breakdown(counters, gauges)
    if shblock:
        out.write("\n".join(shblock) + "\n")
    rblock = residency_breakdown(counters, gauges)
    if rblock:
        out.write("\n".join(rblock) + "\n")
    hblock = hardening_breakdown(counters, gauges)
    if hblock:
        out.write("\n".join(hblock) + "\n")
    iblock = interference_breakdown(counters, gauges)
    if iblock:
        out.write("\n".join(iblock) + "\n")
    pblock = placement_breakdown(counters, gauges)
    if pblock:
        out.write("\n".join(pblock) + "\n")
    ablock = autotune_breakdown(counters, gauges)
    if ablock:
        out.write("\n".join(ablock) + "\n")
    slblock = slo_breakdown(counters, gauges)
    if slblock:
        out.write("\n".join(slblock) + "\n")


def main(path: str, out, err, check: bool = False,
         trace: str | None = None, follow_stream: bool = False) -> int:
    """Entry point behind ``pluss stats <events.jsonl> [--check]
    [--trace RID] [--follow]``."""
    import os

    if not os.path.exists(path):
        err.write(f"pluss stats: no such file: {path}\n")
        return 2
    if follow_stream:
        return follow(path, out, err)
    records, problems, notes = load(path)
    for n in notes:
        err.write(f"pluss stats: note: {n}\n")
    if check:
        for p in problems:
            err.write(f"pluss stats: {path}: {p}\n")
        if problems:
            err.write(f"pluss stats: {path}: {len(problems)} schema "
                      "violation(s)\n")
            return 1
        out.write(f"pluss stats: {path}: ok "
                  f"({len(records)} records)\n")
        return 0
    if problems:
        for p in problems:
            err.write(f"pluss stats: {path}: {p}\n")
    if trace is not None:
        return render_trace(records, trace, out)
    render(records, out)
    return 0
