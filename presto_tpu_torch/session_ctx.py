"""Per-query session context visible to scalar-function emitters.

The function registry's emit callbacks receive only argument ColVals
(exec/compiler.eval_expr), but a few functions depend on the session:
the session time zone (reference: ConnectorSession.getTimeZoneKey used
throughout operator/scalar/DateTimeFunctions.java) and the query start
instant (reference: session.getStartTime() — now() is per-QUERY stable,
not per-row).  The executor stamps these at query start; cluster workers
stamp them from the shipped session properties before running a
fragment, so zone-dependent expressions agree across the mesh.
"""

from __future__ import annotations

import contextvars
import time

import itertools

_TZ = contextvars.ContextVar("presto_tpu_session_tz", default="UTC")
_START_US = contextvars.ContextVar("presto_tpu_query_start_us", default=None)
_USER = contextvars.ContextVar("presto_tpu_session_user", default="user")
#: monotonically increasing per-query id (volatile-function cache nonce;
#: the start instant alone could collide within one microsecond)
_QSEQ_COUNTER = itertools.count(1)
_QSEQ = contextvars.ContextVar("presto_tpu_query_seq", default=0)
#: current expression-eval batch capacity (per-row volatile functions
#: like random() need a row count; emitters only see argument ColVals)
_BATCH_CAP = contextvars.ContextVar("presto_tpu_batch_capacity",
                                    default=None)
#: the session's device (collection functions build their element
#: columns there; a constant collection carries no tensor to ask)
_DEVICE = contextvars.ContextVar("presto_tpu_torch_device", default="cpu")


def current_zone() -> str:
    return _TZ.get()


def current_user() -> str:
    return _USER.get()


def query_start_us() -> int:
    v = _START_US.get()
    if v is None:  # direct emitter calls outside a query (tests)
        return int(time.time() * 1_000_000)
    return v


def query_seq() -> int:
    """Per-query nonce (see executor._volatile_nonce)."""
    return _QSEQ.get()


def device():
    import torch

    return torch.device(_DEVICE.get())


def batch_capacity() -> int | None:
    return _BATCH_CAP.get()


def set_batch_capacity(n: int) -> None:
    _BATCH_CAP.set(n)


def activate(session) -> None:
    """Stamp the context from a Session at query start."""
    _TZ.set(str(session.properties.get("time_zone", "UTC")))
    _START_US.set(int(time.time() * 1_000_000))
    _USER.set(str(getattr(session, "user", "user")))
    _QSEQ.set(next(_QSEQ_COUNTER))
    _DEVICE.set(str(getattr(session, "device", "cpu")))


def activate_raw(tz: str, start_us: int | None) -> None:
    """Worker-side: restore the coordinator's stamped context."""
    _TZ.set(tz or "UTC")
    if start_us is not None:
        _START_US.set(int(start_us))
