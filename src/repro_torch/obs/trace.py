"""Span tracer — nestable wall-clock spans over the HOST-side control
plane, with pluggable sinks.  A copy of the span API of
``repro.obs.trace`` (the port imports nothing of the JAX package), without
the profiler bridge and the Chrome-trace exporter.

    from repro_torch.obs import trace
    with trace.span("engine.round", k=8):
        params, losses = engine.round_step(...)

* **No-op without a sink.**  ``span(...)`` returns a shared singleton
  no-op context manager when no sink is installed — no allocation, no
  clock read — so the tracer can live on hot paths permanently.
* **Host time.**  CUDA launches are asynchronous: a span measures device
  work only when the code inside it waits for the device (the trainer's
  spans end on a host copy of the round's results, which does).
* **Structured records.**  A completed span emits one flat dict
  ``{"name", "ts", "dur", "id", "parent", "depth", "attrs"}`` (seconds,
  relative to the module epoch) to every installed sink, children before
  parents.  Sinks: :class:`MemorySink` (bounded ring), or anything with
  ``emit(record)``.

Span names used by the port: ``trainer.round``, ``controller.decide``,
``engine.round``, ``scan.decide``, and the arena's ``arena.run``,
``arena.plan``, ``arena.upload``, ``arena.dispatch``, ``arena.eval``;
event: ``plan.decision`` (``sim.dispatch.plan_dispatch``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List

__all__ = ["span", "event", "install_sink", "remove_sink", "installed",
           "MemorySink"]

# module epoch: every record's ts is relative to this, so one run's
# records are mutually comparable and small enough for exact float math
_EPOCH = time.perf_counter()

_SINKS: List[Any] = []

# span ids are process-global and monotonically increasing; the active
# span stack is thread-local so concurrent host threads nest correctly
_LOCK = threading.Lock()
_NEXT_ID = [0]
_TLS = threading.local()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _emit(record: Dict[str, Any]) -> None:
    for sink in list(_SINKS):
        sink.emit(record)


class _NoopSpan:
    """The shared do-nothing span — returned whenever no sink is
    installed, so un-observed runs pay (almost) nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "depth", "t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (e.g. how many
        executables a plan produced)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        st = _stack()
        with _LOCK:
            self.id = _NEXT_ID[0]
            _NEXT_ID[0] += 1
        self.parent = st[-1].id if st else None
        self.depth = len(st)
        st.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _emit({"name": self.name, "ts": self.t0 - _EPOCH,
               "dur": t1 - self.t0, "id": self.id, "parent": self.parent,
               "depth": self.depth, "attrs": self.attrs})
        return False


def span(name: str, **attrs) -> Any:
    """A context manager timing one named phase.  Returns the shared
    no-op singleton when no sink is installed — the zero-overhead
    contract — otherwise a live :class:`_Span` recording wall time,
    ``attrs``, and its position in the active span tree."""
    if not _SINKS:
        return _NOOP
    return _Span(name, attrs)


def event(name: str, **attrs) -> None:
    """An instantaneous structured record (``dur`` 0, no stack entry).
    No-op without a sink."""
    if not _SINKS:
        return
    st = _stack()
    with _LOCK:
        eid = _NEXT_ID[0]
        _NEXT_ID[0] += 1
    _emit({"name": name, "ts": time.perf_counter() - _EPOCH, "dur": 0.0,
           "id": eid, "parent": st[-1].id if st else None,
           "depth": len(st), "attrs": attrs})


# -- sinks -------------------------------------------------------------------


class MemorySink:
    """Bounded in-memory ring of completed span records (newest kept)."""

    def __init__(self, capacity: int = 4096):
        self.records: deque = deque(maxlen=capacity)

    def emit(self, record: Dict[str, Any]) -> None:
        self.records.append(record)

    def by_name(self, name: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["name"] == name]


def install_sink(sink: Any) -> Any:
    """Register ``sink`` (anything with ``emit(record)``); returns it."""
    _SINKS.append(sink)
    return sink


def remove_sink(sink: Any) -> None:
    if sink in _SINKS:
        _SINKS.remove(sink)


@contextmanager
def installed(sink: Any):
    """``with trace.installed(MemorySink()) as sink: ...`` — sink bound
    for the block, removed (and closed, if it has ``close``) on exit."""
    install_sink(sink)
    try:
        yield sink
    finally:
        remove_sink(sink)
        if hasattr(sink, "close"):
            sink.close()

