"""EvalBank — the device-resident evaluation data plane of the arena: the
port of ``repro.sim.eval.EvalBank``.

The test set is uploaded once, at construction (a copy, in the task's
device layout and in its own dtypes, as the JAX package holds it;
``fl.client_bank.stored_dtype``), and widened to f32 features and int64
labels where ``task.metrics`` reads it.  A whole ``[S, ...]`` lane stack
is evaluated by ``torch.func.vmap`` of ``task.metrics`` over the lane
axis of the params, the test set shared, in calls of at most
``lanes_per_call`` lanes.  Each lane's activations over the whole test
set are alive at once (about 6 GB a lane for the CNN over 7,500
CIFAR-10 images), so the chunk is derived from the test set's size:
``EVAL_LANE_EXAMPLES // num_examples`` lanes a call, at least one.  Two
consumers:

* :meth:`evaluate_stacked` — the arena's final evaluation
  (``RolloutReport.final_metrics``);
* :meth:`metrics_stacked` / :meth:`metrics_one` — the same evaluation
  returning device tensors, for the lane body's in-rollout evaluation
  every ``eval_every`` rounds (``RoundEngine._build_lanes``).

Evaluation runs under ``torch.no_grad``.  :meth:`carry_struct` gives
the shapes and dtypes of the in-rollout evaluation's carry (the sweep
service rebuilds a checkpointed carry from it); :meth:`aot_warm` runs
one discarded stacked evaluation (the JAX package compiles it ahead).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.fl.client_bank import upload, widen

Params = Dict[str, torch.Tensor]

#: lane-examples evaluated in one vmapped call (2 lanes of a 7,500-image
#: test set, 81 of a 200-image one)
EVAL_LANE_EXAMPLES = 16384


class EvalBank:
    """Device-resident test set + batched ``task.metrics`` evaluation on
    ``device`` (``'cuda'`` unless the caller asks for the CPU).
    ``lanes_per_call`` overrides the chunk derived from the test set's
    size (see the module docstring)."""

    def __init__(self, task, x, y, device="cuda",
                 lanes_per_call: Optional[int] = None):
        self.task = task
        self.device = torch.device(device)
        self.x = upload(x, self.device, task.device_layout)
        self.y = upload(y, self.device)
        self.num_examples = int(self.x.shape[0])
        if lanes_per_call is None:
            lanes_per_call = EVAL_LANE_EXAMPLES // self.num_examples
        self.lanes_per_call = max(1, int(lanes_per_call))
        #: the per-model evaluation, shared by every consumer so the
        #: ``test_*`` columns and ``final_metrics`` cannot diverge
        self.eval_fn = self.make_eval_fn(task)

    @staticmethod
    def make_eval_fn(task):
        """``eval_fn(params, data) -> {metric: scalar}`` over an ``(x,
        y)`` test set in its stored dtypes (widened here)."""
        def eval_fn(params: Params, data) -> Dict[str, torch.Tensor]:
            x, y = widen(*data)
            return task.metrics(params, {"x": x, "y": y})
        return eval_fn

    def metrics_one(self, params: Params) -> Dict[str, torch.Tensor]:
        """One model's metrics as 0-d device tensors."""
        with torch.no_grad():
            return self.eval_fn(params, (self.x, self.y))

    def metrics_stacked(self, params: Params) -> Dict[str, torch.Tensor]:
        """A ``[S, ...]`` params stack's metrics as ``[S]`` device tensors,
        one vmapped call per ``lanes_per_call`` lanes."""
        fn = vmap(self.eval_fn, in_dims=(0, None))
        s = next(iter(params.values())).shape[0]
        c = self.lanes_per_call
        with torch.no_grad():
            parts = [fn({n: v[i:i + c] for n, v in params.items()},
                        (self.x, self.y)) for i in range(0, s, c)]
        if len(parts) == 1:
            return parts[0]
        return {n: torch.cat([p[n] for p in parts]) for n in parts[0]}

    def evaluate_stacked(self, params: Params) -> Dict[str, np.ndarray]:
        """Evaluate a stacked ``[S, ...]`` params dict
        (:meth:`metrics_stacked`); returns ``{metric: [S] numpy array}``."""
        return {name: v.cpu().numpy()
                for name, v in self.metrics_stacked(params).items()}

    def evaluate_one(self, params: Params) -> Dict[str, Any]:
        """Single-model evaluation (host convenience / reference)."""
        return {name: float(v) for name, v in self.metrics_one(params).items()}

    def aot_warm(self, s: int, params_example: Params) -> bool:
        """Warm the stacked evaluation for an ``[s, ...]`` params stack:
        one discarded :meth:`metrics_stacked` call on ``s`` copies of
        ``params_example`` (one unstacked model) on the bank's device, so
        its first real call pays no cold set-up.  The JAX package
        compiles the evaluator ahead from shapes alone; eager PyTorch has
        nothing to compile, so the warm call runs.  Returns True."""
        stack = {name: v.to(self.device).unsqueeze(0).expand(
            (s,) + tuple(v.shape)) for name, v in params_example.items()}
        self.metrics_stacked(stack)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return True

    def carry_struct(self, params_example: Params, s: int
                     ) -> Dict[str, torch.Tensor]:
        """Shapes and dtypes of the in-rollout last-eval carry for an
        ``[s, ...]`` lane stack, ``{metric: [s]}``, as tensors on the
        ``meta`` device (the counterpart of the JAX package's
        ``ShapeDtypeStruct``).  Derived from the real evaluation, run on
        one test example of ``params_example`` (one unstacked model), so
        it cannot drift from what the lane body carries."""
        with torch.no_grad():
            out = self.eval_fn(params_example, (self.x[:1], self.y[:1]))
        return {name: torch.empty((s,) + tuple(v.shape), dtype=v.dtype,
                                  device="meta")
                for name, v in out.items()}
