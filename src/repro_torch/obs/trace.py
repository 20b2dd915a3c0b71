"""Span tracer — nestable wall-clock spans over the HOST-side control
plane, with pluggable sinks: the port of ``repro.obs.trace`` (the port
imports nothing of the JAX package), the flight recorder included.

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
  parents.  Sinks: :class:`MemorySink` (bounded ring), :class:`JsonlSink`
  (the flight recorder: one JSON object per line, the JAX package's file
  format, so its ``load_jsonl`` and ``tools/obs_report.py`` read a port
  run unchanged; a sharded run writes one file per rank), or anything
  with ``emit(record)``.
* **Chrome trace.**  :func:`load_jsonl` reads a flight-recorder file
  back, :func:`to_chrome_trace` / :func:`export_chrome_trace` turn
  records into ``chrome://tracing`` / Perfetto events.
* **Profiler bridge.**  :func:`profiler_bridge` (off by default) mirrors
  every live span as a ``torch.profiler.record_function`` range, so a
  ``torch.profiler`` trace carries the span taxonomy; off, a span takes
  no extra branch beyond one flag test, and the no-sink path none.

Span names used by the port: ``trainer.round``, ``controller.decide``,
``engine.round``, ``scan.decide``, and the arena's ``arena.run``,
``arena.plan``, ``arena.upload``, ``arena.dispatch``, ``arena.gather``
(a sharded bucket's lanes gathered), ``arena.eval``; event:
``plan.decision`` (``sim.dispatch.plan_dispatch``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List

__all__ = ["span", "event", "install_sink", "remove_sink", "clear_sinks",
           "installed", "profiler_bridge", "MemorySink", "JsonlSink",
           "load_jsonl", "to_chrome_trace", "export_chrome_trace"]

# module epoch: every record's ts is relative to this, so one run's
# records are mutually comparable and small enough for exact float math
_EPOCH = time.perf_counter()

_SINKS: List[Any] = []

# profiler bridge: mirror live spans as torch.profiler ranges
_PROFILER_BRIDGE = False

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
    __slots__ = ("name", "attrs", "id", "parent", "depth", "t0",
                 "_range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._range = None

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
        if _PROFILER_BRIDGE:
            from torch.profiler import record_function
            self._range = record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
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


class JsonlSink:
    """Appends one JSON object per completed span to ``path`` — the
    flight-recorder file format (``runlogs/<run>.jsonl``) that
    ``tools/obs_report.py`` renders and :func:`load_jsonl` reads back,
    the JAX package's.  Values in ``attrs`` are made JSON-serialisable by
    :meth:`_jsonable`: a tensor or numpy value through ``.item()`` (one
    element) or ``.tolist()``, anything else unknown by ``repr``."""

    def __init__(self, path: str, flush_every: int = 64):
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self.path = path
        self._fh = open(path, "a")
        self._since_flush = 0
        self._flush_every = max(1, int(flush_every))

    @staticmethod
    def _jsonable(value: Any) -> Any:
        if hasattr(value, "item") and not isinstance(value, (str, bytes)):
            numel = getattr(value, "numel", None)
            size = numel() if callable(numel) else getattr(value, "size", 1)
            if size == 1:
                return JsonlSink._jsonable(value.item())
            if hasattr(value, "tolist"):
                return JsonlSink._jsonable(value.tolist())
            return repr(value)
        if isinstance(value, (list, tuple)):
            return [JsonlSink._jsonable(v) for v in value]
        if isinstance(value, dict):
            return {str(k): JsonlSink._jsonable(v)
                    for k, v in value.items()}
        if isinstance(value, (str, int, float, bool)) or value is None:
            return value
        return repr(value)

    def emit(self, record: Dict[str, Any]) -> None:
        rec = dict(record)
        rec["attrs"] = self._jsonable(record.get("attrs", {}))
        self._fh.write(json.dumps(rec) + "\n")
        self._since_flush += 1
        if self._since_flush >= self._flush_every:
            self._fh.flush()
            self._since_flush = 0

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def install_sink(sink: Any) -> Any:
    """Register ``sink`` (anything with ``emit(record)``); returns it."""
    _SINKS.append(sink)
    return sink


def remove_sink(sink: Any) -> None:
    if sink in _SINKS:
        _SINKS.remove(sink)


def clear_sinks() -> None:
    del _SINKS[:]


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


def profiler_bridge(enabled: bool) -> None:
    """Mirror every live span as a ``torch.profiler.record_function``
    range, so a ``torch.profiler`` trace carries the span taxonomy.  Off
    by default; the bridge fires only on spans a sink already made
    live, so the no-sink path is untouched either way."""
    global _PROFILER_BRIDGE
    _PROFILER_BRIDGE = bool(enabled)


# -- chrome trace export -----------------------------------------------------


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read a :class:`JsonlSink` file back into span records (blank lines
    skipped; a torn last line raises: the log is append-only and
    line-atomic)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def to_chrome_trace(records: List[Dict[str, Any]],
                    process_name: str = "repro") -> Dict[str, Any]:
    """Span records -> Chrome Trace Event JSON (``traceEvents`` of
    complete ``"X"`` events, ts and dur in microseconds); instant
    records (``dur == 0``) become ``"i"`` events."""
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": process_name}}]
    for r in records:
        common = {"name": r["name"], "pid": 0, "tid": 0,
                  "ts": round(float(r["ts"]) * 1e6, 3),
                  "args": dict(r.get("attrs", {}))}
        if r.get("dur", 0.0) > 0.0:
            events.append({**common, "ph": "X",
                           "dur": round(float(r["dur"]) * 1e6, 3)})
        else:
            events.append({**common, "ph": "i", "s": "t"})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(records: List[Dict[str, Any]], path: str,
                        process_name: str = "repro") -> str:
    """Write :func:`to_chrome_trace` of ``records`` to ``path``."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(records, process_name), f)
    return path

