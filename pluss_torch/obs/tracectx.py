"""Per-request trace context: the id that stitches one serve request's
telemetry back together across threads (the port's copy of
``pluss/obs/tracectx.py``).

A serve request ``rid`` crosses many threads on its way to an answer:
the connection handler admits it, a device loop coalesces it into a
batch, a background compile may park it, and the trace feed pool encodes
its windows off-thread.  Every one of those stages already records
spans/events into the telemetry stream — this module adds the ONE
missing bit, a propagated trace id, so ``stats --trace <rid>``
can later rebuild the request's causal story from the flat stream.

Two propagation primitives:

- :func:`bind` — a context manager installing ``rid`` as the current
  trace id on THIS thread (a ``threading.local`` stack, so nested binds
  restore correctly — e.g. a batch dispatch bound to the lead request
  re-binding per member for the demux spans);
- :func:`capture` / :func:`attach` — the explicit cross-thread handoff:
  the submitting side captures a token (just the current id), the worker
  side attaches it around the work it performs on that request's behalf
  (feed-pool encode jobs, background compiles).

The telemetry layer (:mod:`pluss_torch.obs.telemetry`) consults
:func:`current` when recording spans (captured at ``__enter__``, so the
stamp names the context the work STARTED under) and events.  The
disabled-telemetry path never reaches this module: ``obs.span`` and
friends return before any context lookup, so the None-check no-op
contract is untouched, and binding a context cannot perturb the
observed computation — it only adds a field to records that were being
written anyway (bit-identity pinned by tests/test_torch_tracectx.py).
"""

from __future__ import annotations

import contextlib
import threading

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current() -> str | None:
    """The innermost bound trace id on this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


@contextlib.contextmanager
def bind(trace_id: str | None):
    """Install ``trace_id`` as the current trace context for the body.

    ``None`` is accepted and means "no context" (a no-op), so call sites
    can bind unconditionally: ``with bind(req.id if traced else None)``.
    """
    if trace_id is None:
        yield
        return
    st = _stack()
    st.append(str(trace_id))
    try:
        yield
    finally:
        if st and st[-1] == str(trace_id):
            st.pop()


def capture() -> str | None:
    """A handoff token for the current context (None when unbound).

    The token is deliberately just the trace id: handing it to a worker
    thread and :func:`attach`-ing it there is equivalent to the worker
    having been bound by the submitter.
    """
    return current()


def attach(token: str | None):
    """Re-enter a :func:`capture`-d context on another thread."""
    return bind(token)
