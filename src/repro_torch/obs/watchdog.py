"""Retrace watchdog — the silent-failure sentinel of the warmed arena
path: the port of ``repro.obs.watchdog``.

The arena's steady state rests on one invariant: after ``Arena.warmup``,
same-shape runs do no cold work again.  A broken invariant does not
crash; it silently adds latency.  The watchdog turns it into a contract:

* :meth:`Watchdog.arm` (called by ``Arena.warmup`` when a watchdog is
  attached) snapshots the arena's trace counter, its executable-cache
  keys and the count of kernel libraries this process has loaded
  (``kernels._build.LOADED``).
* After every later ``Arena.run`` the arena reports back
  (:meth:`observe_run`).  A new bucket signature (a key of
  ``Arena._fns``: bank layout, K_max, shards, eval config, dropout) or a
  kernel library loaded since arming is a violation: the watchdog emits
  a ``watchdog.retrace`` event with the new keys (a kernel as
  ``"kernel:<name>"``), records it in :attr:`violations` and, in
  ``strict`` mode, raises :class:`RetraceError`; otherwise it warns.
* The baseline then advances, so one regression is reported once.

In eager PyTorch the cold work of a new signature is its first run (the
``nvcc`` build of a kernel at first launch, cuDNN's and cuBLAS's set-up
for a new SGD shape, the caching allocator's growth), so a kernel build
after warmup is a violation of its own.  The per-round shapes do not
depend on T or a chunk's length, so neither makes a new signature (the
JAX package retraces its scan at a new T).

:meth:`stall_report` reduces the streaming path's per-chunk
``arena.chunk.dispatch_s`` / ``arena.chunk.reduce_s`` histograms to
percentiles.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional

from repro_torch.kernels import _build
from repro_torch.obs import trace

__all__ = ["RetraceError", "Watchdog"]


class RetraceError(RuntimeError):
    """A strict watchdog saw cold work after warmup: a new bucket
    signature or a kernel build."""


class Watchdog:
    """Arms on warmup, checks every run.  ``strict=True`` raises on a
    violation; otherwise a structured event and a Python warning.

    Attach with :meth:`attach`: the arena calls ``arm`` and
    ``observe_run`` itself."""

    def __init__(self, strict: bool = False):
        self.strict = strict
        self.armed = False
        self._traces = 0
        self._fn_keys: set = set()
        self._loaded = 0
        #: violation records (newest last): ``{"retraces",
        #: "new_executables", "run_meta"}``
        self.violations: List[Dict[str, Any]] = []

    def attach(self, arena) -> "Watchdog":
        """Bind to ``arena`` (one watchdog per arena); returns self."""
        arena.watchdog = self
        return self

    # -- the contract --------------------------------------------------------

    def _snapshot(self, arena) -> None:
        self._traces = int(arena.traces)
        self._fn_keys = set(arena._fns)
        self._loaded = len(_build.LOADED)

    def arm(self, arena) -> None:
        """Snapshot the warmed state: cold work beyond THIS point is
        unexpected."""
        self.armed = True
        self._snapshot(arena)

    def observe_run(self, arena, run_meta: Optional[Dict[str, Any]] = None
                    ) -> Optional[Dict[str, Any]]:
        """Called by the arena after each ``run``.  Returns the violation
        record if one fired, else None."""
        if not self.armed:
            return None
        new_traces = int(arena.traces) - self._traces
        new_keys = sorted(set(arena._fns) - self._fn_keys, key=repr)
        new_kernels = _build.LOADED[self._loaded:]
        if new_traces <= 0 and not new_keys and not new_kernels:
            return None
        violation = {
            "retraces": int(new_traces),
            "new_executables": ([repr(k) for k in new_keys]
                                + [f"kernel:{name}" for name in new_kernels]),
            "run_meta": {k: run_meta[k] for k in
                         ("k_mode", "k_max", "dispatches",
                          "executables_built")
                         if run_meta and k in run_meta},
        }
        self.violations.append(violation)
        trace.event("watchdog.retrace", **violation)
        self._snapshot(arena)        # one regression = one report
        if self.strict:
            raise RetraceError(
                f"post-warmup retrace: {new_traces} new bucket "
                f"signature(s) run, new cache keys "
                f"{violation['new_executables']} — the warmed contract is "
                f"broken (a shape or eval config drifted from the warmup "
                f"call, or a kernel was built)")
        warnings.warn(
            f"obs.Watchdog: post-warmup retrace ({new_traces} new "
            f"signature(s), new cache keys {violation['new_executables']})",
            RuntimeWarning, stacklevel=2)
        return violation

    # -- streaming stall view ------------------------------------------------

    @staticmethod
    def stall_report(metrics) -> Dict[str, Dict[str, float]]:
        """Dispatch and reduce latency percentiles of the chunked path
        from the shared registry: ``{phase: {p50, p90, p99, mean,
        count}}``."""
        out: Dict[str, Dict[str, float]] = {}
        for phase, name in (("dispatch", "arena.chunk.dispatch_s"),
                            ("reduce", "arena.chunk.reduce_s")):
            h = metrics.get(name, default=None)
            if h is None or not getattr(h, "count", 0):
                continue
            ps = h.percentiles()
            out[phase] = {"p50": ps[50.0], "p90": ps[90.0],
                          "p99": ps[99.0], "mean": h.mean,
                          "count": h.count}
        return out
