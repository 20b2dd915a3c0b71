"""Span tracer — nestable wall-clock spans over the HOST-side control
plane, with pluggable sinks: the port of ``repro.obs.trace`` (the port
imports nothing of the JAX package), the flight recorder included.

    from repro_torch.obs import trace
    with trace.span("engine.round", k=8):
        params, losses = engine.round_step(...)

* **No-op without a sink.**  ``span(...)`` (``device=True`` too) returns
  a shared singleton no-op context manager and :func:`count` returns at
  once when no sink is installed — no allocation, no clock read, no CUDA
  call — so the tracer can live on hot paths permanently.  Nothing here
  synchronises with the device, with or without a sink.
* **Host time.**  CUDA launches are asynchronous: a span's ``dur`` is
  the host's time in it, which covers device work only where the code
  inside waits for the device.
* **Device time.**  ``span(name, device=True)`` with a sink installed
  and CUDA initialised records a timing event on the current stream at
  enter and at exit; its record gains ``attrs["device_s"]``, the seconds
  from the stream reaching the start event to the stream finishing the
  span's last launch (its kernels and the waits between them, when the
  stream ran dry for the host).  Such a record is held back until
  :func:`resolve_device`, which the caller invokes right after a
  read-back it makes anyway (the arena's ``arena.reduce``): it emits
  the records whose end the stream has passed, and keeps the rest.  So
  a device record reaches the sinks after its parent; its ``parent``
  and ``depth`` are those of its enter.
* **Structured records.**  A completed span emits one flat dict
  ``{"name", "ts", "ts_ns", "dur", "id", "parent", "depth", "attrs"}``
  to every installed sink, children before parents: ``ts`` and ``dur``
  in seconds, ``ts`` relative to the module epoch (the JAX package's
  format); ``ts_ns`` the start in integer ns on ``torch.profiler``'s
  event clock (Unix-epoch ns, ``time.time_ns``), so the records lie on
  a profiler trace of the same process.  Sinks: :class:`MemorySink`
  (bounded ring), :class:`JsonlSink` (the flight recorder: one JSON
  object per line, the JAX package's file format plus ``ts_ns``, so its
  ``load_jsonl`` and ``tools/obs_report.py`` read a port run unchanged;
  a sharded run writes one file per rank), or anything with
  ``emit(record)``.
* **Counters and totals.**  :func:`count` adds to a counter of the
  innermost live span (its record carries it in ``attrs``).  While any
  sink is installed the tracer folds every record it emits into a
  per-name table, :func:`totals`: calls, host seconds, device seconds
  and the sum of each counter; installing the first sink starts the
  table afresh, so it covers the spans completed while tracing was on.
* **Chrome trace.**  :func:`load_jsonl` reads a flight-recorder file
  back, :func:`to_chrome_trace` / :func:`export_chrome_trace` turn
  records into ``chrome://tracing`` / Perfetto events, on the module
  epoch or (``base_ns=``) on the profiler's clock.
* **Profiler bridge.**  :func:`profiler_bridge` (off by default) mirrors
  every live span as a ``torch.profiler.record_function`` range, so a
  ``torch.profiler`` trace carries the span taxonomy; off, a span takes
  no extra branch beyond one flag test, and the no-sink path none.

Spans the port emits (``layer.phase``; attributes in brackets):

* trainer: ``trainer.round`` [t] around ``controller.decide``;
* round engine: ``engine.round`` (a trainer round, or a whole
  ``run_scan`` [what, policy, rounds, k]); ``engine.lanes_round`` [t,
  lanes, k; ``device=True``: device_s], an arena round's data plane;
  within it ``engine.route`` [slots], a ladder's tier read-back, and
  ``engine.train_tier`` [tier, slots, width, steps], each SGD call of
  ``_train``; ``engine.eval`` [t, lanes], the in-rollout evaluation;
* a rollout's control plane, per lane and round: ``scan.decide`` [t,
  lane] (the controller's decision; counter ``solver.loop_tests``, one
  per tolerance test of ``core.solver``, each a read-back),
  ``scan.select`` [t, lane] (selection, epoch keys, eq.-(4)
  coefficients) and ``scan.outputs`` [t, lane] (queues, metrics row);
* arena: ``arena.run``, ``arena.plan``, ``arena.upload``,
  ``arena.compile`` (a signature's first run), ``arena.dispatch`` (a
  chunk's rounds), ``arena.reduce`` (its read-back),
  ``arena.gather`` (a sharded bucket's lanes gathered), ``arena.eval``
  (the final evaluation), ``arena.warmup``;
* sweep service: ``service.batch``, ``service.reduce``, ``store.load``,
  ``store.save``;
* events: ``plan.decision`` (``sim.dispatch.plan_dispatch``),
  ``watchdog.retrace`` (``obs.watchdog``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

__all__ = ["span", "event", "count", "totals", "resolve_device",
           "install_sink", "remove_sink", "clear_sinks", "installed",
           "profiler_bridge", "MemorySink", "JsonlSink", "load_jsonl",
           "to_chrome_trace", "export_chrome_trace"]

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

#: name -> {"calls", "host_s", "device_s", "counters"} of the records
#: emitted since the first sink went in (see :func:`totals`)
_TOTALS: Dict[str, Dict[str, Any]] = {}
#: the totals' row of counts made while no span was live
OUTSIDE = "outside spans"
#: device spans closed on the host, their end not yet known to have
#: passed on the stream: (record, (start, end) CUDA events, counts)
_PENDING: List[tuple] = []


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _row(name: str) -> Dict[str, Any]:
    row = _TOTALS.get(name)
    if row is None:
        row = _TOTALS[name] = {"calls": 0, "host_s": 0.0, "device_s": None,
                               "counters": {}}
    return row


def _emit(record: Dict[str, Any], counts: Optional[Dict[str, int]] = None,
          device_s: Optional[float] = None) -> None:
    sinks = list(_SINKS)
    if not sinks:
        return
    with _LOCK:
        row = _row(record["name"])
        row["calls"] += 1
        row["host_s"] += record["dur"]
        if device_s is not None:
            row["device_s"] = (row["device_s"] or 0.0) + device_s
        for name, n in (counts or {}).items():
            row["counters"][name] = row["counters"].get(name, 0) + n
    for sink in sinks:
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


def _device_events():
    """A (start, end) pair of CUDA timing events, or None where CUDA is
    not initialised (a CPU run: the span then has no device time)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "depth", "t0", "ts_ns",
                 "counts", "_device", "_events", "_range")

    def __init__(self, name: str, attrs: Dict[str, Any], device: bool):
        self.name = name
        self.attrs = attrs
        self.counts = None
        self._device = device
        self._events = None
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
        self.ts_ns = time.time_ns()
        if _PROFILER_BRIDGE:
            from torch.profiler import record_function
            self._range = record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        if self._device:
            self._events = _device_events()
            if self._events is not None:
                self._events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record()
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        record = {"name": self.name, "ts": self.t0 - _EPOCH,
                  "ts_ns": self.ts_ns, "dur": t1 - self.t0, "id": self.id,
                  "parent": self.parent, "depth": self.depth,
                  "attrs": self.attrs}
        if self._events is not None:
            with _LOCK:
                _PENDING.append((record, self._events, self.counts))
        else:
            _emit(record, self.counts)
        return False


def span(name: str, device: bool = False, **attrs) -> Any:
    """A context manager timing one named phase.  Returns the shared
    no-op singleton when no sink is installed — the zero-overhead
    contract — otherwise a live :class:`_Span` recording wall time,
    ``attrs``, and its position in the active span tree.  ``device``:
    also time the span's work on the current CUDA stream (see the module
    docstring; the record waits for :func:`resolve_device`)."""
    if not _SINKS:
        return _NOOP
    return _Span(name, attrs, device)


def event(name: str, **attrs) -> None:
    """An instantaneous structured record (``dur`` 0, no stack entry).
    No-op without a sink."""
    if not _SINKS:
        return
    st = _stack()
    with _LOCK:
        eid = _NEXT_ID[0]
        _NEXT_ID[0] += 1
    _emit({"name": name, "ts": time.perf_counter() - _EPOCH,
           "ts_ns": time.time_ns(), "dur": 0.0, "id": eid,
           "parent": st[-1].id if st else None, "depth": len(st),
           "attrs": attrs})


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost live span of
    this thread (its record carries the sum as ``attrs[name]``, and
    :func:`totals` sums it under the span's name), or of the totals'
    :data:`OUTSIDE` row when no span is live.  No-op without a sink."""
    if not _SINKS:
        return
    st = _stack()
    if not st:
        with _LOCK:
            counters = _row(OUTSIDE)["counters"]
            counters[name] = counters.get(name, 0) + n
        return
    sp = st[-1]
    if sp.counts is None:
        sp.counts = {}
    sp.counts[name] = sp.attrs[name] = sp.counts.get(name, 0) + n


def totals() -> Dict[str, Dict[str, Any]]:
    """A copy of the per-name table of the records emitted since the
    first sink went in: ``{name: {"calls", "host_s", "device_s",
    "counters"}}``, ``device_s`` None where no record of the name had
    device time, ``counters`` ``{counter: sum}``."""
    with _LOCK:
        return {name: dict(row, counters=dict(row["counters"]))
                for name, row in _TOTALS.items()}


def resolve_device() -> None:
    """Emit the held-back device spans (``span(..., device=True)``)
    whose end event the stream has passed, each with
    ``attrs["device_s"]``; keep the others for a later call.  It never
    waits for the device: call it right after a read-back the caller
    makes anyway, which has drained the stream.  Spans closed while
    sinks were installed and resolved after the last one went are
    dropped."""
    if not _PENDING:
        return
    with _LOCK:
        pending = _PENDING[:]
        del _PENDING[:]
    if not _SINKS:
        return
    keep = []
    for item in pending:
        record, (start, end), counts = item
        if not end.query():
            keep.append(item)
            continue
        device_s = start.elapsed_time(end) * 1e-3
        record["attrs"]["device_s"] = device_s
        _emit(record, counts, device_s)
    if keep:
        with _LOCK:
            _PENDING[:0] = keep


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
    """Register ``sink`` (anything with ``emit(record)``); returns it.
    The first sink starts :func:`totals` afresh and drops device spans
    still held back from an earlier session."""
    with _LOCK:
        if not _SINKS:
            _TOTALS.clear()
            del _PENDING[:]
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
                    process_name: str = "repro",
                    base_ns: Optional[int] = None) -> Dict[str, Any]:
    """Span records -> Chrome Trace Event JSON (``traceEvents`` of
    complete ``"X"`` events, ts and dur in microseconds); instant
    records (``dur == 0``) become ``"i"`` events.  ``ts`` counts from
    the module epoch, or with ``base_ns`` from that instant on the
    profiler's clock (each record's ``ts_ns``, which the JAX package's
    records lack): give a ``torch.profiler`` trace's
    ``baseTimeNanoseconds`` and add the events to its ``traceEvents``,
    and Perfetto lays the spans over the device timeline."""
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": process_name}}]
    for r in records:
        ts = (float(r["ts"]) * 1e6 if base_ns is None
              else (int(r["ts_ns"]) - int(base_ns)) * 1e-3)
        common = {"name": r["name"], "pid": 0, "tid": 0,
                  "ts": round(ts, 3),
                  "args": dict(r.get("attrs", {}))}
        if r.get("dur", 0.0) > 0.0:
            events.append({**common, "ph": "X",
                           "dur": round(float(r["dur"]) * 1e6, 3)})
        else:
            events.append({**common, "ph": "i", "s": "t"})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(records: List[Dict[str, Any]], path: str,
                        process_name: str = "repro",
                        base_ns: Optional[int] = None) -> str:
    """Write :func:`to_chrome_trace` of ``records`` to ``path``."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(records, process_name, base_ns), f)
    return path

