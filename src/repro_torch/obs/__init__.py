"""repro_torch.obs — host-side span tracing (a copy of ``repro.obs.trace``'s
span API, without the profiler bridge) and the metrics registry (a copy
of ``repro.obs.metrics``)."""

from repro_torch.obs import trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (MemorySink, event, install_sink,
                                   installed, remove_sink, span)
