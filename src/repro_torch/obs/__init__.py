"""repro_torch.obs — host-side span tracing with the flight recorder
(``JsonlSink``, ``load_jsonl``, the Chrome-trace export and the
``torch.profiler`` bridge; the port of ``repro.obs.trace``), the
metrics registry (a copy of ``repro.obs.metrics``) and the retrace
watchdog (``repro.obs.watchdog``: armed by ``Arena.warmup``, it turns a
new bucket signature or a kernel build after warmup into a
``watchdog.retrace`` event, or a raise in strict mode)."""

from repro_torch.obs import trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (JsonlSink, MemorySink, clear_sinks,
                                   count, event, export_chrome_trace,
                                   install_sink, installed, load_jsonl,
                                   profiler_bridge, remove_sink,
                                   resolve_device, span, to_chrome_trace,
                                   totals)
from repro_torch.obs.watchdog import RetraceError, Watchdog
