"""repro_torch.obs — host-side span tracing with the flight recorder
(``JsonlSink``, ``load_jsonl``, the Chrome-trace export and the
``torch.profiler`` bridge; the port of ``repro.obs.trace``) and the
metrics registry (a copy of ``repro.obs.metrics``)."""

from repro_torch.obs import trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (JsonlSink, MemorySink, clear_sinks,
                                   event, export_chrome_trace, install_sink,
                                   installed, load_jsonl, profiler_bridge,
                                   remove_sink, span, to_chrome_trace)
