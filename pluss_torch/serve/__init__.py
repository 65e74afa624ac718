"""pluss_torch.serve — the long-lived multi-tenant MRC prediction service
(the port's copy of ``pluss.serve``).

PLUSS predicts miss-ratio curves *without running the program*, which
makes it a natural online service: callers submit a loop nest (registry
model or inline spec) or a packed trace over a JSONL socket and get an
MRC back, amortizing compiled plans across millions of requests.  The
pieces:

- :mod:`pluss_torch.serve.protocol`  — request/response schema, the inline-spec
  codec, the analyzer admission gate, and a small client;
- :mod:`pluss_torch.serve.admission` — the bounded shed-don't-block queue;
- :mod:`pluss_torch.serve.batcher`   — shared-dispatch coalescing of
  plan-compatible requests (max-delay/max-batch adaptive window);
- :mod:`pluss_torch.serve.journal`   — the crash-safe request journal behind
  ``--journal-dir`` / ``--recover`` (open on admission, done on reply);
- :mod:`pluss_torch.serve.server`    — the daemon: listener, device loop,
  per-request resilience ladder, watchdog + circuit breaker, SLO
  gauges, drain-and-stop.

Start one with ``python -m pluss_torch.cli serve --socket /tmp/p.sock``
(or ``--port``; ``--cpu`` serves on the host), send requests with
:class:`~pluss_torch.serve.protocol.Client`, and read its SLOs with
``python -m pluss_torch.cli stats <telemetry.jsonl>``.  The daemon
dispatches to one device (``ServeConfig.device``, default the CUDA card);
its wire protocol is the JAX package's, so either package's client talks
to either package's server.
"""

from pluss_torch.serve.admission import AdmissionQueue  # noqa: F401
from pluss_torch.serve.batcher import Batcher  # noqa: F401
from pluss_torch.serve.journal import RequestJournal  # noqa: F401
from pluss_torch.serve.protocol import (  # noqa: F401
    Client,
    Request,
    parse_request,
    spec_from_json,
    spec_to_json,
)
from pluss_torch.serve.server import ServeConfig, Server  # noqa: F401

__all__ = [
    "AdmissionQueue", "Batcher", "Client", "Request", "RequestJournal",
    "parse_request", "spec_from_json", "spec_to_json", "ServeConfig",
    "Server",
]
