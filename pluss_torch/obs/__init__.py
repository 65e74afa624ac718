"""pluss_torch.obs — structured telemetry for the port's pipeline.

The port's copy of ``pluss.obs``: one substrate (counters / gauges /
spans / events → an append-only JSONL sink,
:mod:`pluss_torch.obs.telemetry`), optional ``torch.profiler`` sessions
and annotations (:mod:`pluss_torch.obs.xprof`, ``PLUSS_XPROF=dir``), the
``stats`` aggregator (:mod:`pluss_torch.obs.stats`), and the serving
layer's request trace context (:mod:`pluss_torch.obs.tracectx`), SLO
burn monitor (:mod:`pluss_torch.obs.slo`) and crash flight recorder
(:mod:`pluss_torch.obs.flight`).  Disabled (the default) every
hook is a near-free no-op and the instrumented pipelines are
bit-identical — telemetry is observably passive, enforced by
tests/test_torch_obs.py.

Enable with ``PLUSS_TELEMETRY=<events.jsonl>`` or ``--telemetry`` on the
CLI; ``PLUSS_PROM=<file>`` additionally exports a Prometheus-style
textfile at shutdown.
"""

from pluss_torch.obs.telemetry import (  # noqa: F401
    NOOP_SPAN,
    SCHEMA_VERSION,
    LatencyReservoir,
    Telemetry,
    active,
    configure,
    counter_add,
    counters,
    enabled,
    ensure_session,
    event,
    flush_metrics,
    gauge_set,
    gauges,
    render_prom,
    shutdown,
    span,
    trace_event,
)
