"""Reduce a ``torch.profiler`` trace of the window to arrays the metric
readers read: device intervals, the program's span ranges on the host
(mirrored by ``obs.trace.profiler_bridge``) and the CUDA runtime calls.

The raw Kineto events are read once (``kineto_results.events()``), with
no per-event Python objects kept, so a window of millions of launches
reduces in seconds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

#: runtime calls that launch device work
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")
#: runtime calls in which the host waits for the device
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync",
              "cudaStreamWaitEvent")
#: the program's spans the readers look at
SPANS = ("scan.decide", "engine.lanes_round", "arena.dispatch",
         "arena.reduce", "arena.eval", "arena.run")


@dataclasses.dataclass
class Digest:
    window_ns: Tuple[int, int]
    dev_name: List[str]            # per device interval
    dev_start: np.ndarray          # ns
    dev_dur: np.ndarray            # ns
    dev_launch: np.ndarray         # ns of the launching runtime call, -1
    spans: Dict[str, np.ndarray]   # name -> [n, 2] host ranges (ns)
    host_ranges: np.ndarray        # [n, 2] of every span range, any name
    host_names: List[str]
    rt_name: List[str]
    rt_start: np.ndarray
    rt_dur: np.ndarray
    stats: dict

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def busy_intervals(self) -> np.ndarray:
        """The union of the device intervals, ``[n, 2]`` ns, sorted."""
        return union(self.dev_start, self.dev_dur)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        lo, hi = self.window_ns
        iv = np.clip(iv, lo, hi)
        return float(np.sum(iv[:, 1] - iv[:, 0])) * 1e-9


def union(starts: np.ndarray, durs: np.ndarray) -> np.ndarray:
    """The union of intervals ``[start, start + dur)``, ``[n, 2]``,
    sorted and disjoint."""
    if not len(starts):
        return np.zeros((0, 2), np.int64)
    order = np.argsort(starts, kind="stable")
    s = np.asarray(starts)[order]
    e = np.maximum.accumulate(s + np.asarray(durs)[order])
    # a new interval starts where a start lies past every earlier end
    new = np.concatenate([[True], s[1:] > e[:-1]])
    first = np.flatnonzero(new)
    last = np.concatenate([first[1:] - 1, [len(s) - 1]])
    return np.stack([s[first], e[last]], axis=1).astype(np.int64)


def digest(prof, window_ns: Optional[Tuple[int, int]] = None) -> Digest:
    from torch.autograd import DeviceType

    cpu = DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    dev, rt, host, host_names = [], [], [], set()
    for ev in events:
        name = ev.name()
        if name.startswith("aten::"):      # most events: host operators
            continue
        if ev.device_type() != cpu:
            dev.append((name, ev.start_ns(), ev.duration_ns(),
                        ev.correlation_id()))
        elif name.startswith("cu"):
            rt.append((name, ev.start_ns(), ev.duration_ns(),
                       ev.correlation_id()))
        else:
            host_names.add(name)
            if name in SPANS:
                host.append((name, ev.start_ns(),
                             ev.start_ns() + ev.duration_ns()))
    # a host range's mirror on the device timeline carries its name
    mirrors = sum(1 for d in dev if d[0] in host_names)
    dev = [d for d in dev if d[0] not in host_names]
    launch_at = {c: s for _, s, _, c in rt}
    dev_launch = np.asarray(
        [launch_at.get(c, -1) for _, _, _, c in dev],
        np.int64)
    spans = {}
    for name in SPANS:
        rows = sorted((a, b) for n, a, b in host if n == name)
        spans[name] = np.asarray(rows, np.int64).reshape(-1, 2)
    order = sorted(range(len(host)), key=lambda i: host[i][1])
    starts = [e[1] for e in dev] + [e[1] for e in rt]
    ends = [e[1] + e[2] for e in dev] + [e[1] + e[2] for e in rt]
    if window_ns is None:
        window_ns = (min(starts), max(ends)) if starts else (0, 0)
    return Digest(
        window_ns=window_ns,
        dev_name=[d[0] for d in dev],
        dev_start=np.asarray([d[1] for d in dev], np.int64),
        dev_dur=np.asarray([d[2] for d in dev], np.int64),
        dev_launch=dev_launch,
        spans=spans,
        host_ranges=np.asarray([(host[i][1], host[i][2]) for i in order],
                               np.int64).reshape(-1, 2),
        host_names=[host[i][0] for i in order],
        rt_name=[r[0] for r in rt],
        rt_start=np.asarray([r[1] for r in rt], np.int64),
        rt_dur=np.asarray([r[2] for r in rt], np.int64),
        stats={"device_events": len(dev), "mirrors_dropped": mirrors,
               "runtime_calls": len(rt), "span_ranges": len(host),
               "launch_found": int(np.sum(dev_launch >= 0))})


def within(points: np.ndarray, ranges: np.ndarray) -> np.ndarray:
    """For sorted, non-overlapping ``ranges`` ``[n, 2]``: which of
    ``points`` lie inside one."""
    if not len(ranges) or not len(points):
        return np.zeros(len(points), bool)
    i = np.searchsorted(ranges[:, 0], points, side="right") - 1
    ok = i >= 0
    ic = np.clip(i, 0, None)
    return ok & (points <= ranges[ic, 1])


def innermost_spans(d: Digest, points: List[int]) -> List[str]:
    """For sorted time points (ns), the innermost program span the host
    was in at each (the spans of one thread nest), or ``"outside
    spans"``: one sweep over the span ranges and the points."""
    r = d.host_ranges
    out, stack, i = [], [], 0
    for t in points:
        while i < len(r) and r[i, 0] <= t:
            while stack and r[stack[-1], 1] < r[i, 0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and r[stack[-1], 1] < t:
            stack.pop()
        out.append(d.host_names[stack[-1]] if stack else "outside spans")
    return out


def breakdown(d: Digest, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of the
    device by the program span the host was in (each gap named by the
    span at its middle), the largest first."""
    by_op: Dict[str, float] = {}
    for name, dur in zip(d.dev_name, d.dev_dur.tolist()):
        by_op[name] = by_op.get(name, 0.0) + dur * 1e-9
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    busy = d.busy_intervals()
    lo, hi = d.window_ns
    edges = [lo] + busy.reshape(-1).tolist() + [hi]
    gaps = [(max(a, lo), min(b, hi)) for a, b in
            zip(edges[0::2], edges[1::2])]
    gaps = [(a, b) for a, b in gaps if b > a]
    names = innermost_spans(d, [(a + b) // 2 for a, b in gaps])
    by_span: Dict[str, float] = {}
    for (a, b), name in zip(gaps, names):
        by_span[name] = by_span.get(name, 0.0) + (b - a) * 1e-9
    gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
