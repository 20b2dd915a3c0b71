"""repro_torch.obs — host-side span tracing (a copy of ``repro.obs.trace``'s
span API, without the profiler bridge)."""

from repro_torch.obs import trace
from repro_torch.obs.trace import (MemorySink, install_sink, installed,
                                   remove_sink, span)
