"""One run of a cell: set up the program from the seed's inputs, continue
one rollout of the paper's schedule through its untimed set-up rounds
into the timed window, stop at the first round boundary after the
window's seconds, and keep what the check and the metrics read.

The window is one ``Arena.run`` over the whole schedule with chunks of
one round and a chunk store of the harness's own
(:class:`WindowStore`): the arena hands the store a host copy of the
carry and the metric columns at every round boundary, and the store
reads the clock there, keeps the carries the check needs (in memory;
nothing is written to disk) and, once the window's seconds have passed,
stops the rollout by raising :class:`WindowClosed`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fedbench.harness import data as hdata


#: a traced run leaves the window's rounds up to the first boundary after
#: UNTRACED_SECONDS (or UNTRACED_SHARE of the window, where less) untraced,
#: for ``round_mfu``, which the profiler's cost on the host would lower;
#: it then profiles the rounds up to the first boundary TRACE_SECONDS (or
#: TRACE_SHARE of the window) later, so that stopping the profiler and
#: reading its millions of events stays well inside a run's time limit.
#: The window runs its full length either way; the profiler's start and
#: stop do not count toward its seconds.
UNTRACED_SECONDS = 10.0
UNTRACED_SHARE = 0.2
TRACE_SECONDS = 20.0
TRACE_SHARE = 0.4


class WindowClosed(Exception):
    """Raised from the chunk store at the boundary that closes the
    window."""


class _LiveSpans:
    """A span sink that keeps nothing: it makes the program's spans live,
    so the profiler bridge mirrors them as profiler ranges."""

    def emit(self, record) -> None:
        pass


@dataclasses.dataclass
class Item:
    """One lane-round the check recomputes: the lane, the round, the
    carry before it and after it (host arrays of that lane)."""
    lane: int
    round: int
    pre: Optional[dict]
    post: dict


class WindowStore:
    """The arena's chunk-store interface (``load``, ``save``, ``finish``,
    ``every``), used as the window's clock and recorder."""

    every = 1

    def __init__(self, setup_rounds: int, seconds: float, lanes: List[int],
                 window_checks: int, eval_every: int, check_seed: int,
                 on_start=None, on_trace_start=None, on_trace_stop=None):
        self.setup_rounds = setup_rounds
        self.seconds = seconds
        self.lanes = np.asarray(lanes, np.int64)
        self.window_checks = window_checks
        self.eval_every = eval_every
        self.rng = np.random.default_rng(check_seed)
        self.on_start = on_start
        #: given in a traced run only
        self.on_trace_start, self.on_trace_stop = on_trace_start, on_trace_stop
        self.t0 = self.t1 = None
        self.window_rounds = 0
        #: the window's rounds before the profiler started (all of them in
        #: an untraced run) and the clock at their end; the rounds the
        #: profiler saw; the seconds its start and stop took
        self.untraced_rounds = None
        self.t_untraced = self.t_traced = None
        self.traced_rounds = None
        self.paused = 0.0
        self.columns = None
        self.start_items: List[Item] = []
        self.window_items: List[Item] = []
        self.eval_items: List[Item] = []
        self.clock: List[float] = []
        self.setup_clock: List[float] = []
        self._last = None

    def load(self, tag):
        return None

    def finish(self, tag) -> None:
        pass

    def _lane_carry(self, tree: dict) -> List[dict]:
        return [{"params": {k: v[s].copy() for k, v in
                            tree["params"].items()},
                 "queues": tree["queues"][s].copy()} for s in self.lanes]

    def save(self, tag, t_next: int, tree: dict, columns: dict) -> None:
        now = time.perf_counter()
        r = t_next - 1                       # the round that just ended
        if self.t0 is None:
            self.setup_clock.append(now)
        carry = self._lane_carry(tree)
        if r == 0:
            self.start_items = [Item(int(s), 0, None, c)
                                for s, c in zip(self.lanes, carry)]
        if self.t0 is not None:
            # reservoir sampling of the window's rounds, seeded
            i = r - self.setup_rounds
            slot = i if i < self.window_checks else int(
                self.rng.integers(0, i + 1))
            if slot < self.window_checks:
                items = [Item(int(s), r, pre, post) for s, pre, post in
                         zip(self.lanes, self._last, carry)]
                if i < self.window_checks:
                    self.window_items.append(items)
                else:
                    self.window_items[slot] = items
            if (r + 1) % self.eval_every == 0 and not self.eval_items:
                self.eval_items = [Item(int(s), r, None, c)
                                   for s, c in zip(self.lanes, carry)]
        self._last = carry
        if t_next == self.setup_rounds:
            if self.on_start is not None:
                self.on_start()
            self.t0 = time.perf_counter()
            self.clock = [self.t0]
            return
        if self.t0 is None:
            return
        self.clock.append(now)
        i = t_next - self.setup_rounds          # window rounds done
        elapsed = now - self.t0 - self.paused
        if self.on_trace_start is not None and self.t_untraced is None:
            if elapsed >= min(UNTRACED_SECONDS,
                              UNTRACED_SHARE * self.seconds):
                self.untraced_rounds, self.t_untraced = i, now
                self.on_trace_start()
                self.t_traced = time.perf_counter()
                self.paused += self.t_traced - now
            return
        if self.on_trace_start is not None and self.traced_rounds is None:
            if now - self.t_traced < min(TRACE_SECONDS,
                                         TRACE_SHARE * self.seconds):
                return
            self.traced_rounds = i - self.untraced_rounds
            self.on_trace_stop()
            self.paused += time.perf_counter() - now
        if elapsed >= self.seconds:
            if self.untraced_rounds is None:
                self.untraced_rounds, self.t_untraced = i, now
            self.t1 = now
            self.window_rounds = i
            self.columns = columns
            raise WindowClosed()


def lr_schedule(lr: float, rounds: int) -> np.ndarray:
    """The paper's schedule: ``lr``, halved at 50% and again at 75% of
    the rounds, in float32."""
    t = np.arange(rounds)
    halvings = (t >= int(0.5 * rounds)).astype(np.int64) + (
        t >= int(0.75 * rounds)).astype(np.int64)
    return (np.float32(lr) * np.float32(0.5) ** halvings).astype(np.float32)


def check_lanes(traffic: dict, seed: int) -> List[int]:
    """The lanes the check recomputes: ``lanes_per_controller`` seeds of
    each controller, drawn from the check's stream of ``--seed``."""
    n = traffic["seeds_per_controller"]
    per = min(traffic["check"]["lanes_per_controller"], n)
    rng = np.random.default_rng(hdata.stream(seed, hdata.CHECK_LANES))
    out = []
    for c in range(len(traffic["controllers"])):
        out += sorted(int(c * n + j) for j in rng.choice(n, per,
                                                         replace=False))
    return out


def build(config: dict, traffic: dict, inputs: hdata.Inputs, device):
    """The program's objects for the cell: the task, the round engine on
    its default bank (the tier ladder for this partition), the system
    parameters, the test set's ``EvalBank``, the grid and the arena."""
    from repro_torch.core import paper_default_params
    from repro_torch.fl import ClientConfig
    from repro_torch.fl.round_engine import RoundEngine
    from repro_torch.models import CNNTask
    from repro_torch.sim import Arena, EvalBank, ScenarioGrid

    m = config["model"]
    if m["task"] != "cnn":
        raise ValueError(f"no task {m['task']!r} in the harness")
    task = CNNTask(image_shape=tuple(m["image_shape"]),
                   num_classes=m["num_classes"], width=m["width"])
    cl, bk = config["client"], config["bank"]
    engine = RoundEngine(task, ClientConfig(
        local_epochs=cl["local_epochs"], batch_size=cl["batch_size"],
        momentum=cl["momentum"]), device=device)
    bank = engine.make_bank(inputs.client_data, tiered=bk["tiered"],
                            max_tiers=bk["max_tiers"], storage=bk["storage"])
    sp = paper_default_params(
        num_devices=config["data"]["num_clients"],
        sample_count=traffic["sample_count"],
        local_epochs=cl["local_epochs"],
        dataset=config["system"]["dataset"],
        data_sizes=inputs.sizes.astype(np.float32), device=device)
    eval_bank = EvalBank(task, *inputs.test, device=device)
    grid = ScenarioGrid.product(
        controllers=traffic["controllers"], seeds=inputs.lane_seeds,
        V=(traffic["V"],), lam=(traffic["lam"],),
        mean_gain=(traffic["channel"]["mean_gain"],),
        min_gain=(traffic["channel"]["min_gain"],),
        max_gain=(traffic["channel"]["max_gain"],),
        sample_count=(traffic["sample_count"],),
        num_devices=config["data"]["num_clients"])
    return task, engine, bank, sp, eval_bank, grid, Arena(engine)


def bank_layout(bank) -> Dict[str, np.ndarray]:
    """Each client's true size and the rows its rung trains an epoch."""
    sizes = np.asarray(bank.sizes, np.int64)
    if hasattr(bank, "tier_of"):
        widths = np.asarray(bank.tier_buckets, np.int64)[
            np.asarray(bank.tier_of, np.int64)]
    else:
        widths = np.full(sizes.shape, int(bank.bucket_examples), np.int64)
    return {"sizes": sizes, "widths": widths}


@dataclasses.dataclass
class Window:
    """What a run's window left for the check and the metrics."""
    store: WindowStore
    lanes: int
    layout: Dict[str, np.ndarray]
    marks: dict
    setup_s: float
    memory_peak_bytes: int
    tf32_conv: bool
    tf32_matmul: bool
    traced: Optional[object]
    trace_stop_s: float       # the profiler's stop, inside the window
    traces_in_window: int
    kernels_loaded_in_window: int


def run_window(config: dict, traffic: dict, inputs: hdata.Inputs,
               seconds: float, trace: bool, device, t_process: float
               ) -> Window:
    """Set up, warm and run the window; returns once the window closed
    and the program's objects are released."""
    from repro_torch.kernels import _build
    from repro_torch.obs import trace as obs

    marks = {"inputs": time.perf_counter() - t_process}
    task, engine, bank, sp, eval_bank, grid, arena = build(
        config, traffic, inputs, device)
    marks["build"] = time.perf_counter() - t_process
    s_count = len(grid)
    rounds = int(config["rounds"])
    controllers = len(traffic["controllers"])
    h_all = inputs.h_seeds.repeat(controllers, 1, 1)
    lr_seq = lr_schedule(config["lr"], rounds)
    eval_bank.aot_warm(s_count, inputs.params0)
    marks["eval_warm"] = time.perf_counter() - t_process
    state = {"prof": None, "sink": None, "traces": 0, "loaded": 0,
             "stop_s": 0.0}

    def on_start():
        state["traces"], state["loaded"] = arena.traces, len(_build.LOADED)
        if device != "cpu":
            torch.cuda.synchronize()

    def on_trace_start():
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        state["sink"] = obs.install_sink(_LiveSpans())
        obs.profiler_bridge(True)
        state["prof"] = profile(activities=acts)
        state["prof"].start()

    def on_trace_stop():
        t = time.perf_counter()
        state["prof"].stop()
        obs.profiler_bridge(False)
        obs.remove_sink(state["sink"])
        state["stop_s"] = time.perf_counter() - t

    store = WindowStore(traffic["setup_rounds"], seconds,
                        check_lanes(traffic, inputs.check_seed),
                        traffic["check"]["window_rounds"],
                        traffic["eval_every"], inputs.check_seed,
                        on_start=on_start,
                        on_trace_start=on_trace_start if trace else None,
                        on_trace_stop=on_trace_stop if trace else None)
    try:
        arena.run(inputs.params0, sp, bank, grid, rounds, lr_seq,
                  h_all=h_all, eval_bank=eval_bank,
                  eval_every=traffic["eval_every"], chunk_size=1,
                  chunk_store=store)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the schedule ended before the window closed")
    marks["setup_rounds"] = [c - t_process for c in store.setup_clock]
    traces = arena.traces - state["traces"]
    loaded = len(_build.LOADED) - state["loaded"]
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    layout = bank_layout(bank)
    tf32 = (bool(torch.backends.cudnn.allow_tf32),
            bool(torch.backends.cuda.matmul.allow_tf32))
    del task, engine, bank, sp, eval_bank, grid, arena, h_all
    if device != "cpu":
        torch.cuda.empty_cache()
    return Window(store=store, lanes=s_count, layout=layout, marks=marks,
                  setup_s=store.t0 - t_process, memory_peak_bytes=int(peak),
                  tf32_conv=tf32[0], tf32_matmul=tf32[1],
                  traced=state["prof"], trace_stop_s=state["stop_s"],
                  traces_in_window=int(traces),
                  kernels_loaded_in_window=int(loaded))
