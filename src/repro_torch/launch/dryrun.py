"""Dry run: count every (architecture x input shape) step on the ``meta``
device and print its roofline terms on one H100 — the port of
``repro.launch.dryrun``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json

For each combination it builds the reference's step under
``steps.dryrun_config`` at the shape's full global batch and length:
train (``remat=True``, the reference's ``TRAIN_MICROBATCH``), prefill,
or one decode token against a full ``cache_specs`` cache (the token at
the last position, so the whole cache is visible).  The parameters,
optimizer state, inputs and cache are ``meta`` tensors
(``steps.param_specs`` / ``input_specs`` / ``cache_specs``), so nothing
is allocated or drawn and no card is needed; the kernel wrappers report
their formula work (``kernels.ops``).  ``launch.op_cost`` counts the
step and ``launch.roofline.roofline_terms`` gives the terms at
``chips=1`` with the model flops; the argument bytes (params, optimizer
state, inputs, cache) stand where the reference prints XLA's
``memory_analysis``.

Where it departs from the reference:

* one device, no mesh: the reference lowers on a 16x16 (or 2x16x16)
  mesh of 512 forced host devices through ``repro.dist``, a module the
  JAX package never shipped, so its dry run cannot run; there are no
  sharding rules to port, and ``--multi-pod`` / ``--both-meshes`` raise;
* ``--ablate act_constraints`` raises (the port has no activation
  sharding annotations); ``moe_sort``, ``ring_cache`` and
  ``quantized_kv`` are kept;
* counted, not compiled: ``count_s`` is the seconds the count took.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Dict, Optional

from repro_torch.configs import ARCHS, get_spec
from repro_torch.configs.shapes import SHAPES, covered_shapes
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rf
from repro_torch.launch import steps as steps_lib
from repro_torch.optim import SGD
from repro_torch.tree import tree_flatten

# microbatch counts for the train_4k shape, the reference's
TRAIN_MICROBATCH = {
    "grok-1-314b": 8,
    "granite-20b": 4,
    "gemma2-27b": 4,
    "yi-9b": 4,
    "qwen2-vl-7b": 4,
    "granite-moe-3b-a800m": 4,
    "gemma-2b": 2,
    "recurrentgemma-2b": 2,
    "whisper-tiny": 2,
}
MESH_TAG = "1"
ABLATIONS = ("moe_sort", "ring_cache", "quantized_kv", "act_constraints")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])


def check_ablations(ablate: tuple) -> None:
    """Raise for an unknown ablation and for ``act_constraints`` (the
    port has no activation sharding annotations to remove)."""
    for name in ablate:
        if name not in ABLATIONS:
            raise ValueError(f"unknown ablation {name!r}; known: "
                             f"{ABLATIONS}")
    if "act_constraints" in ablate:
        raise ValueError("--ablate act_constraints: the port has no "
                         "activation sharding annotations to remove "
                         "(one device, no mesh)")


def ablated_config(cfg, ablate: tuple):
    """``cfg`` with the reference's ablations: ``quantized_kv`` (int8
    global-layer caches), ``moe_sort`` (capacity dispatch), ``ring_cache``
    (full-length local caches)."""
    check_ablations(ablate)
    if "quantized_kv" in ablate:
        cfg = dataclasses.replace(cfg, quantized_kv=True)
    if "moe_sort" in ablate:
        cfg = dataclasses.replace(cfg, moe_dispatch="capacity")
    if "ring_cache" in ablate:
        cfg = dataclasses.replace(cfg, local_ring_cache=False)
    return cfg


def count_step(arch: str, shape_name: str, *,
               microbatch: Optional[int] = None, ablate: tuple = ()):
    """Count one (arch, shape) step on ``meta``: ``(counter, cfg, tokens,
    argument bytes by part)``."""
    spec = get_spec(arch)
    shape = SHAPES[shape_name]
    cfg = ablated_config(steps_lib.dryrun_config(spec.config), ablate)
    params = steps_lib.param_specs(cfg)
    data = steps_lib.input_specs(arch, shape, cfg)
    args = {"params": _nbytes(params), "inputs": _nbytes(data)}
    if shape.kind == "train":
        mb = microbatch if microbatch is not None else \
            TRAIN_MICROBATCH.get(arch, 1)
        step = steps_lib.make_train_step(cfg, remat=True, microbatch=mb,
                                         device="meta")
        opt_state = SGD(momentum=0.9).init(params)
        args["opt_state"] = _nbytes(opt_state)
        _, counter = op_cost.count(step, params, opt_state, data)
        tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, device="meta")
        _, counter = op_cost.count(step, params, data)
        tokens = shape.global_batch * shape.seq_len
    else:
        step = steps_lib.make_serve_step(cfg, device="meta")
        cache = steps_lib.cache_specs(arch, shape, cfg)
        args["cache"] = _nbytes(cache)
        batch = dict(data, cache_index=shape.seq_len - 1)
        _, counter = op_cost.count(step, params, cache, batch)
        tokens = shape.global_batch
    args["total"] = sum(args.values())
    return counter, cfg, tokens, args


def lower_one(arch: str, shape_name: str, *,
              microbatch: Optional[int] = None, ablate: tuple = (),
              verbose: bool = True) -> Dict:
    """The reference's ``lower_one`` on one device: count the step and
    return its roofline terms (see the module docstring)."""
    kind = SHAPES[shape_name].kind
    t0 = time.time()
    counter, cfg, tokens, args = count_step(
        arch, shape_name, microbatch=microbatch, ablate=ablate)
    count_s = time.time() - t0
    analysis = counter.analyze()
    if kind == "train":
        model_flops = rf.train_model_flops(cfg.param_count(),
                                           cfg.active_param_count(), tokens)
    elif kind == "prefill":
        model_flops = 2.0 * cfg.active_param_count() * tokens
    else:
        model_flops = rf.decode_model_flops(cfg.active_param_count(), tokens)
    terms = rf.roofline_terms(analysis, chips=1, model_flops=model_flops)
    result = {
        "arch": arch, "shape": shape_name, "mesh": MESH_TAG, "kind": kind,
        "chips": 1, "count_s": round(count_s, 2), "terms": terms,
        "argument_bytes": args,
        "kernels": counter.kernels,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {MESH_TAG}] counted in "
              f"{count_s:.1f}s")
        print(f"  argument bytes: {args}")
        print(f"  op_cost: flops={terms['hlo_flops_per_device']:.3e} "
              f"bytes={terms['hlo_bytes_per_device']:.3e} (per device)")
        print(f"  roofline: compute {terms['compute_s']:.4f}s | memory "
              f"{terms['memory_s']:.4f}s | collective "
              f"{terms['collective_s']:.4f}s -> dominant {terms['dominant']}"
              f" | useful-flops ratio "
              f"{terms.get('model_flops_ratio', 0):.3f}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="not available: raises (see the module docstring)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="not available: raises (see the module docstring)")
    ap.add_argument("--all", action="store_true",
                    help="every covered (arch x shape)")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ablate", default="",
                    help="comma list: moe_sort,ring_cache,quantized_kv")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        raise ValueError("--multi-pod / --both-meshes: the reference's "
                         "meshes come from repro.dist, which the JAX package "
                         "never shipped; the port's dry run counts one "
                         "device's step")
    ablate = tuple(filter(None, args.ablate.split(",")))
    check_ablations(ablate)

    if args.all:
        combos = [(arch, shape.name) for arch, spec in ARCHS.items()
                  for shape in covered_shapes(spec)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]

    results, failures = [], []
    for arch, shape in combos:
        try:
            results.append(lower_one(arch, shape,
                                     microbatch=args.microbatch,
                                     ablate=ablate))
        except Exception as e:  # noqa: BLE001 — report, keep going
            traceback.print_exc()
            failures.append({"arch": arch, "shape": shape,
                             "mesh": MESH_TAG, "error": repr(e)})

    if results:
        print()
        print(rf.format_table(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f,
                      indent=1)
        print(f"\nwrote {args.out}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print(f"  {f_['arch']} x {f_['shape']} x {f_['mesh']}: "
                  f"{f_['error']}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
