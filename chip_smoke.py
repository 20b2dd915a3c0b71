#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one result line each (exits non-zero on any failure; no phase's
error is caught):

1. device — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build — compiles the three hand-written CUDA sources from ``src/``
   (one ``nvcc`` per source, all started together, into
   ``build/torch_ext/``) and times each; build.ptxas — each kernel's
   registers, shared memory and spills from ``-Xptxas -v``; build.sass —
   the count of tensor-core instructions (``HGMMA``, ``HMMA``) in each
   library's SASS, where ``cuobjdump`` is present (the bf16 flash kernel
   must show ``HGMMA``);
3. kernel against plain — each kernel against its plain PyTorch version
   (``kernels/ref.py``) at its main path's shapes and at the sweep of
   ``tests/test_kernels.py``, with the kernel's median time (CUDA events,
   L2 flushed before every launch), the plain version's, one PyTorch
   call's where one computes the same function, and the bound (bytes
   over the card's HBM rate, operations over its peak rate for the
   dtype, the larger):
   ``kernel`` (``fl_aggregate``/``fl_delta_reduce`` on a flat model,
   also bitwise against the order of arithmetic, yardstick
   ``torch.addmv``; timed after a clean flush that reads a
   buffer larger than the L2, and after the writing flush that the
   flash and SSD rows use),
   ``kernel.aggregate_fused`` (the round's eq.-(4) step at the CNN's six
   leaves, the ``fl_aggregate`` entry of the ``kernels`` line: one
   launch, within TOL of the plain per-leaf version, bitwise equal to the
   kernel's order of arithmetic computed exactly in PyTorch, to the
   ravel -> flat entry -> unravel path, and a CUDA-graph replay bitwise
   equal to the eager call), ``kernel.aggregate_leaves`` (the leaf
   kernel against its plain versions on gemma2-27b's smoke LM at 6
   layers in bf16, more leaves than one launch takes, and on ragged
   leaves of mixed dtypes), ``kernel.aggregate_lanes`` (the lane form,
   the scenario arena's eq.-(4) step of every lane in one launch per
   table, at 7 and 11 lanes of the CNN's six leaves, K = 8: bitwise its
   fma-order version and the one-lane launches, within TOL of the plain
   version, timed beside the seven one-lane launches and the
   ``torch.baddbmm`` flat yardstick),
   ``kernel.aggregate_resnet`` (the CIFAR-like testbed's eq.-(4) step at
   the paper-scale ResNet's 17 leaves, K = 8, f32: one launch, within
   TOL of the plain per-leaf version, bitwise its fma order, timed
   beside its bound; then ``ops.fl_aggregate_pytree`` on the same
   leaves, 17 launches, each leaf bitwise the one-launch call's),
   ``kernel.flash_attention`` (yardstick
   ``scaled_dot_product_attention`` at the causal point without window
   or soft-cap; each element within (atol, rtol), the relative L2 error
   of the output and of every query row within their limits; ``floor.sfu``, beside the bound, the
   special-function-unit floor of one exp2 and, with the soft-cap, one
   tanh per visible pair at the main-path points; one point at each
   other family's shape class, :data:`FAMILY_FLASH`: recurrentgemma's
   local layers (D 256, one KV head, window 2048), Whisper's encoder
   (non-causal, S 1500, D 64) and its cross-attention (192 and 1
   queries against 1500 keys), granite-moe (a group of 3), qwen2-vl (a
   group of 7) and grok-1 (soft-cap 30), each beside SDPA at the same
   shape and mask),
   ``kernel.delta_reduce_leaves`` (the client-sharded round's partial,
   the zero-theta leaf table into views of one flat buffer, at one of 2
   ranks' K = 4: the CNN's 6 leaves and the ResNet's 17, one launch,
   bitwise its fma order, beside ``torch.mv`` on the ravelled numbers),
   ``kernel.ssd_chunk`` (its two launches, scores and chunk, timed
   together; no single PyTorch call), ``kernel.flash_lse`` (the flash
   kernel writing its lse output, the training forward's form, at
   gemma-2b's training shape, a ragged f32 shape and gemma2-27b's
   soft-capped layer: lse within :data:`LSE_CAP_TOL`-widened TOL of the
   plain version, ``out`` within FLASH_TOL of the plain version and
   bitwise ``out`` without lse, timed with and without lse);
4. reference — a small LROA trainer run on the card against the same
   run on the CPU; reference.lm — the smoke LMs of
   :data:`LM_REFERENCE` (gemma2-27b on the flash path with a binding
   window, mamba2-130m, granite-moe, grok-1, recurrentgemma, Whisper,
   qwen2-vl, and gemma2 with int8 global caches) served greedily on the
   card and on the CPU with the same parameters and inputs: equal
   tokens, logits within 1e-4 (the int8 case's decode within 1e-3), the
   card's launches per layer kind as :func:`expected_launches` counts
   them (the CPU path is held against the JAX package by the tests); reference.scan —
   ``RoundEngine.run_scan`` under each of the seven controllers
   (``repro_torch.core.POLICIES``), then LROA with 20% dropout and with
   padded K, on the card against the same rollouts on the CPU (T = 3):
   equal selections, params, queues and metrics within 1e-4, T
   ``fl_aggregate`` launches on the card and none on the CPU, the padded
   rollout's params bitwise the unpadded one's; reference.arena — the
   scenario arena (``repro_torch.sim.Arena``) of nine lanes (the seven
   controllers, LROA with 20% dropout, LROA at K = 2 padded to 3),
   ``eval_every=1``, channels and masks drawn by the port's samplers, on
   the card against the CPU (channels and masks bitwise, selections
   exact, the rest within 1e-6, T lane launches on the card) and each
   card lane against its own ``run_scan`` on the card (selections exact,
   the rest within 1e-6); reference.tiered — the same trainer,
   ``run_scan`` and arena checks (the arena in 'pad' and 'group') on a
   3-rung tier ladder of 12 clients (:data:`TIERED`), the trainer also
   on an int8 ladder, one ``fl_aggregate`` launch per round whatever
   tiers it hits (queues card against CPU within 1e-4 there, the
   control plane's spread at N = 12); reference.pool — a ``BankPool``
   after churn (every tensor's storage unmoved) and a hierarchical
   round, card against CPU; reference.sweep — the sweep layer on the
   tiered testbed: a ``SweepService`` over ``Arena(k_mode='auto',
   chunk_size=2)`` with in-rollout evaluation, two submissions (the
   seven controllers at K = 4; LROA and Uni-D at K = 2 and 6 with
   dropout) coalesced, T = 6, killed after its first checkpoint and
   resumed bitwise on each device, another lr schedule finding no
   checkpoint, card against CPU within 1e-6 (queues 1e-4), one lane
   launch per bucket round; reference.sequential — the sequential
   reference path (``use_engine=False``) under LROA and DivFL (each
   update sketch observed before the next client trains) on the card
   against the CPU (T = 3; selections equal, params, losses, queues and
   DivFL's update bank within 1e-4), the fused trainer against the
   sequential one on the card at equal client sizes (losses 1e-5, params
   2e-5) and ``round_step_stacked`` bitwise ``round_step``;
   reference.train — ``make_train_step`` (gemma-2b smoke on the flash
   path with remat and 2 microbatches; mamba2-130m smoke with remat) and
   ``make_fl_round_step`` (gemma-2b smoke, K = 2, given coefficients) on
   the card against the CPU from the same seeded parameters and batches:
   losses, parameters and every leaf's gradient within
   :data:`TRAIN_TOL`, every leaf's gradient present, finite and nonzero,
   the card's flash / SSD / ``fl_aggregate`` launches as the layers,
   remat and microbatches give them;
5. main path — the paper-scale CNN testbed (N = 120 Dirichlet-0.5
   clients, K = 8, E = 2, batch 16) on the trainer's default bank, the
   4-rung tier ladder: ``warmup()``, then 3 LROA rounds through
   ``FederatedTrainer.run_round``, checking finite losses, q on the
   simplex, moved queues, changed params and exactly one
   ``fl_aggregate`` launch per round, logging the ladder and the tiers
   each round hit; main.single — the same on one 2048-row bucket;
   then, in spawned worlds (``launch.world.run_world``, a deadline on
   each) of two gloo ranks on ``cuda:0`` and of one NCCL rank:
   reference.shard — on :data:`TIERED`, the sharded ``round_step``
   (single bucket, a ladder round hitting three tiers, hierarchical over
   2 clusters), a two-round LROA ``run_scan`` and a four-lane
   ``Arena(mesh=)`` over two rounds, each against the unsharded port on
   the card (round 1e-6; run_scan params 1e-6, metrics rtol 1e-5, atol
   1e-4; the arena params 1e-6, metrics and queues rtol 1e-5, atol 1e-4),
   params bitwise across ranks, one ``fl_delta_reduce`` launch a rank a
   round, each rank's partial bitwise its fma order; shard.main (the
   gloo world) — ``FederatedTrainer(mesh=)`` on main.single's bucket (60
   of 120 rows a rank) and on main's ladder (its odd rungs whole on each
   rank), warmed up, 2 LROA rounds each: rows and bytes a rank, round
   time, ``fl_delta_reduce`` launches a rank a round, the all-reduce's
   bytes and time, params bitwise across ranks, selections equal to
   main's and main.single's and params within :data:`SHARD_MAIN_TOL` of
   theirs after each round, below the error one rank's partial dropped
   from the first all-reduce would leave; each rank writes
   ``runlogs/shard/rank<r>.jsonl``, rank 0 a Chrome trace, span counts
   read back with ``load_jsonl``; shard.arena — the seven controllers
   and LROA at a second seed, 4 lanes a rank, 2 rounds on the ladder:
   lane-rounds/s over the slower rank, one lane launch a rank a round;
   profile, profile.single — one more round of each under
   ``torch.profiler``; scan — the paper's comparison on the single
   bucket: the seven controllers' ``run_scan`` rollouts of 4
   rounds each from the same params over the same channels, each with
   its seconds, rounds/s, ``decide``'s share, modelled latency, final
   queue mean and last loss, exactly one ``fl_aggregate`` launch per
   round, q on the simplex and changed params; arena — the same
   comparison as one lane-batched ``Arena.run`` of the seven controllers
   (seed 0) over the scan phase's channels: each lane selects as the
   scan phase's rollout, params within :data:`ARENA_PARAM_TOL`, losses
   within :data:`ARENA_LOSS_TOL` relative, modelled latency within 1e-6
   relative, and one round held tighter (:func:`phase_arena_round`);
   one lane launch per round; lane-rounds/s, each lane's ``decide`` share, the final
   ``EvalBank`` accuracies over the 7,500-example test set, peak memory;
   arena.map — LROA, Uni-D and DivFL under ``Arena(batch='map')``, each
   lane bitwise its scan rollout, one one-lane ``fl_aggregate`` launch
   per lane round; arena.tiered — the arena's one-round checks on the
   ladder; sweep — the sweep layer at paper scale on the ladder: nine
   lanes in two coalesced submissions through the ``SweepService``
   (``k_mode='auto'``, chunks of 2, T = 6), killed and resumed bitwise,
   the same selections and modelled latency as ``k_mode='pad'``, the
   plan, store saves and loads (seconds, bytes), lane-rounds/s
   and ``CostModel.calibrate``; scale —
   one LROA round from the same params, selection and keys on the fp32
   ladder, an int8 ladder (loss within 5%), the single bucket, a
   120-slot ``BankPool`` after 8 evictions and re-admissions (within
   1e-6 of the single bucket's round, storage unmoved) and a clustered
   bucket flat and hierarchical (losses bitwise, params within 1e-5);
   warmup.arena — ``Arena.warmup`` on the ladder (3 lanes, K = 8, 2
   rounds) under a strict ``obs.Watchdog``: a fresh arena's cold run,
   the warmed arena's runs of that grid and another (no violation, no
   kernel library loaded after warmup, within the arena bounds of the
   cold run), a K = 12 grid raising ``RetraceError``, warmup's seconds
   and the first round warm against cold; warmup.sweep —
   ``SweepService.warmup`` then two submissions, no violation;
   warmup.pool — ``BankPool.warmup`` then churn, one cold write;
   the paper's Sec.-VII experiments at paper scale on the default bank:
   paper.cifar (50,000 synthetic 32x32x3 images, Dirichlet 0.5 over 120
   clients, ``ResNetTask()``, lr 0.05) and paper.femnist (28x28x1, 62
   classes, ``writer_partition`` over 120 writers, ``CNNTask()``, lr
   0.1), each LROA, Uni-D, Uni-S and DivFL through ``run(3)`` (CIFAR)
   or ``run(6)`` (FEMNIST) with ``eval_every=2``, LROA's after
   ``warmup()``:
   one ``fl_aggregate`` launch per
   round, rounds/s, accuracy curves, modelled latency, the time to 95%
   of the worst final accuracy and each baseline's saving against LROA,
   peak memory, one profiled LROA round (paper.femnist only);
   paper.sequential (DivFL on the
   CIFAR-like testbed under ``use_engine=False``, 2 rounds, beside the
   fused DivFL rounds); paper.heterogeneity (the control-only ablation
   of ``bench_sweeps.heterogeneity_sweep``: N = 120, K = 2, spreads 1, 2
   and 4, LROA against Uni-S over 50 rounds of the reference's 150,
   ``heterogeneous_params`` on the card bitwise the CPU's);
6. serve.gemma2 — gemma2-27b at full width and depth (46 layers, bf16
   parameters and activations, ``attn_impl='flash'``), random weights
   from a seed: ``greedy_generate`` of 16 tokens after 2 prompts of 4352
   tokens (4096 + 256, so the 4096 window binds and the local rings
   wrap), exactly 46 flash launches in prefill and none in decode, finite
   logits; profile.serve — one more prefill and one decode step under
   ``torch.profiler``;
7. serve.mamba2 — mamba2-130m at full size (f32): 4 prompts of 2048
   tokens, 32 greedy tokens, exactly 24 launches of each SSD kernel
   (``ssd_scores`` and ``ssd_chunk``, 48 in all) in prefill and none in
   decode;
8. the other families at full width under ``dryrun_config`` (bf16, the
   flash path), random weights from a seed, each freed before the next
   (:data:`FAMILY_SERVE`): serve.granite_moe (all 32 layers, 40 experts
   top-8 in 16 token groups, 2 x 4096 tokens, 16 new), serve.qwen2_vl
   (28 layers, 2 x 4096 tokens whose first 256 are seeded vision
   patches, M-RoPE ids, 16 new), serve.recurrentgemma (26 layers, 2 x
   4352 tokens: the 2048 window binds and the local rings wrap, 16 new),
   serve.whisper (4 encoder and 4 decoder layers, 8 x 1500 seeded audio
   frames, 192-token decoder prompts, 32 new) and serve.grok (4 of
   grok-1's 64 layers, logged as serve.grok.cut: all 64 do not fit the
   card; 2 x 2048 tokens, 8 new): finite logits, the token shape, and
   the flash launches of :func:`expected_launches` (one per attention
   layer in prefill: 32, 28, 8, 12 and 4; in decode none, but Whisper's
   4 cross-attention launches a step);
9. LM training at full width: train.gemma2b — ``make_train_step(remat=
   True, microbatch=2)`` at gemma-2b under ``dryrun_config`` (18 layers,
   d 2048, 8 heads / 1 KV head, D 256, d_ff 16384, vocab 256000: 2.51 B
   bf16 parameters), 3 steps on one repeated batch of 4 x 1024 tokens
   (the loss finite and falling, 72 flash launches with lse a step:
   18 layers x forward and remat's recompute x 2 microbatches), step
   time, tokens/s, peak memory, one profiled step (busy share, the plain
   flash backward's share from its profiler range), one step's peak with
   the in-place SGD update and one with the functional path;
   fl_round.gemma2b —
   ``make_fl_round_step`` at the same width, K = 2 clients drawn by LROA
   over 16 (as ``examples/lm_federated_torch.py``), 4 local steps on 2 x
   512 tokens, lr 1e-2, 2 rounds: one ``fl_aggregate`` launch per round
   and table of leaves, round time, peak memory (and one more round's by
   the functional SGD path), and the eq.-(4) step at its 11 bf16 leaves,
   bitwise its order of arithmetic, timed beside its bound
   (kernel.aggregate_gemma2b);
   train.mamba2 —
   ``launch/train.main`` at mamba2-130m's full config (4 x 2048
   tokens), 4 steps with checkpoints, then resumed to step 6: the SSD
   launches of each run, and the resumed run bitwise two fresh-momentum
   steps from the step-4 checkpoint;
10. examples — the repo's drivers through the functions their commands
   call: ``examples/quickstart_torch.py``'s ``run`` for 21 of its 400
   rounds (LROA's ``decide``, ``expected_energy`` and ``step_queues``;
   no kernel) on the card against the same run on the CPU: every
   printed number within 1e-4 relative;
   ``examples/fl_simulation_torch.py`` at its defaults (LROA, Uni-D and
   Uni-S over 24 devices, 40 rounds, one arena grid: the table, seconds,
   lane-rounds/s, one ``fl_aggregate_lanes`` launch a round), then its
   grid at 4 rounds, 8 devices and LROA, Uni-D, Uni-S and DivFL on the
   card against the CPU from one initial model (accuracy and total
   latency within reference.arena's 1e-6); ``examples/
   serve_decode_torch.py`` at its defaults for the gemma2-27b and
   mamba2-130m smoke models, the card's tokens equal to the CPU's, the
   flash and SSD launches of :func:`expected_launches`;
11. roofline — ``python -m repro_torch.launch.dryrun --all``, started in
   a background process on the host's CPU (no card visible) when the
   script starts: every (arch x covered shape) step counted on the
   ``meta`` device, its roofline table at the H100's peaks; then
   train.gemma2b, fl_round.gemma2b and the gemma2 and mamba2 prefills
   counted at the shapes timed above, each one's compute and memory
   terms beside its measured seconds;
12. the ``kernels`` JSON line (with ``flash_attention_lse`` and
   ``fl_delta_reduce``), then the last line ``{"ok": true, "device":
   {...}}``.

Float32 matmuls and convolutions run in full f32 (TF32 off), so the card
computes what the CPU reference computes.  Imports ``torch``, ``numpy``,
``repro_torch`` and the port's drivers (``examples/*_torch.py``) only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published peaks (NVIDIA data sheets, dense): HBM bytes/s, float32
# (non-tensor-core) FLOP/s and bf16 tensor-core FLOP/s, matched on the
# name nvidia-smi reports
PEAKS = (("H200", 4.8e12, 67e12, 989e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100", 3.35e12, 67e12, 989e12))
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# flash attention: (atol, rtol) of each element, the limit of the
# relative L2 error over the whole output, and of each query row's.  In
# bf16, P rounded to bf16 (2^-8 relative per weight at most) moves an
# element by up to 2^-8 sum_j p_j |v_j|, which stays large in the first
# rows of a causal mask, where few keys share the weight: on an H100
# the points below needed up to 2.35e-3 beyond rtol (atol_needed), so
# atol is 5e-3; rtol 2e-2 covers a one-ulp difference at |out| in
# [2, 4).  The plain
# version itself, rounded to bf16, is about 1.6e-3 from its f32 result
# in relative L2 (logged as plain_rel_l2_err): the limits are 4e-3 over
# the output and 1e-2 for every row, which a dropped kv tile (about
# 0.2) or a mask edge one key off in a row of 4096 keys (1.6e-2) exceed.
FLASH_TOL = {torch.float32: (2e-5, 2e-5, 1e-5, 1e-4),
             torch.bfloat16: (5e-3, 2e-2, 4e-3, 1e-2)}
# (N, K, dtype): the slice's CNN, the 11.17M-parameter model that
# paper_default_params accounts for, a ragged N, and K = 1
POINTS = ((545_002, 8, torch.float32), (11_172_342, 8, torch.float32),
          (11_172_342, 8, torch.bfloat16), (65_537, 3, torch.float32),
          (129, 1, torch.float32))
MAIN_POINT = POINTS[0]
# clock cycles the timer holds the device before each timed call (about
# 5 ms at the H100's 1,980 MHz; longer than the host's work for a call
# over a few hundred leaves)
HOLD_CYCLES = 10_000_000
ROUNDS = 3
# rounds of each controller's rollout in the scan phase, and of each
# card-against-CPU rollout in reference.scan
SCAN_ROUNDS = 4
REFERENCE_SCAN_ROUNDS = 3
# fixed bounds on an arena lane against its scan rollout, both with
# cuDNN's deterministic algorithms, set from the card's readings in
# PERF.md: params (max abs), losses (relative), and the least ratio of the
# distance from the rollout to the nearest other controller's to the
# lane's distance from it.  ROUND_*: after one round (arena.round.lane);
# ARENA_*: after the arena phase's SCAN_ROUNDS rounds (arena.lane)
ROUND_PARAM_TOL = 1e-3
ROUND_LOSS_TOL = 1e-5
ROUND_SEPARATION = 10
ARENA_PARAM_TOL = 5e-2
ARENA_LOSS_TOL = 5e-3
ARENA_SEPARATION = 2
# the sweep phases: rounds of each sweep, rounds per chunk
SWEEP_ROUNDS = 6
SWEEP_CHUNK = 2
# the lane kernel's points: (lanes, K) at the CNN's six leaves (f32), the
# scenario arena's round at paper scale (7 controllers, K = 8) and a grid
# of 11 lanes, 66 segments: more than one table
LANE_POINTS = ((7, 8), (11, 8))
# the small testbed of the card-against-CPU phases
SMALL = dict(num_devices=6, sample_count=3, local_epochs=2, batch_size=8,
             examples=400, image_shape=(8, 8, 1), num_classes=4, width=4,
             lr=0.1, rounds=3, seed=0)
# the card-against-CPU testbed of the tier ladder: 12 clients of given
# sizes whose buckets at batch 8 form 3 tiers (16, 32 and 64 rows; 4, 3
# and 5 clients), K = 4 so rounds hit several tiers
TIERED = dict(SMALL, num_devices=12, sample_count=4, examples=600,
              sizes=(12, 20, 9, 30, 40, 28, 60, 15, 64, 33, 14, 50))
# benchmarks/common.BenchConfig.paper_scale() at K = 8
PAPER_SCALE = dict(num_devices=120, sample_count=8, local_epochs=2,
                   batch_size=16, examples=50_000, image_shape=(32, 32, 3),
                   num_classes=10, width=32, lr=0.1, rounds=2000, seed=0)
# the paper's Sec.-VII testbeds at paper scale, R rounds of its 2000
# (PERF.md section 4): CIFAR-10-like (Dirichlet 0.5, ResNetTask at its
# defaults, the paper's CIFAR lr 0.05) and FEMNIST-like (writer
# partition, CNNTask at its defaults: 28x28x1, 62 classes, lr 0.1); the
# CIFAR-like testbed runs 3 rounds (6 until the training phases came:
# the script passed 900 s of its 1200)
PAPER_CIFAR = dict(PAPER_SCALE, task="resnet", dataset="cifar10", lr=0.05,
                   rounds=3, eval_every=2)
PAPER_FEMNIST = dict(PAPER_SCALE, image_shape=(28, 28, 1), num_classes=62,
                     task="cnn", dataset="femnist", partition="writer",
                     lr=0.1, rounds=6, eval_every=2)
# the paper's comparison (benchmarks/bench_convergence.py)
PAPER_CONTROLLERS = ("lroa", "uni_d", "uni_s", "divfl")
# rounds of DivFL's sequential reference path at paper scale
SEQUENTIAL_ROUNDS = 2
# benchmarks/bench_sweeps.heterogeneity_sweep at N = 120, K = 2: its
# spreads, and rounds of its control-only rollouts, cut from the
# reference's 150 to keep the script's time (PERF.md section 4)
HET_SPREADS = (1.0, 2.0, 4.0)
HET_ROUNDS = 50
# the drivers' phase (examples/*_torch.py): rounds of the quickstart on
# each device, of its 400, and the bound on each of its printed numbers,
# card against CPU, relative.  The solver's loops stop on tolerances at
# float32's rounding, so two devices run other trip counts and their
# rollouts drift apart with the rounds, and the card's 400 rounds take
# about 440 s (tests/quickstart_drift.py; ROADMAP section C, PERF.md
# section 6)
QUICKSTART_ROUNDS = 21
QUICKSTART_RTOL = 1e-4
# fl_simulation_torch's grid run card against CPU (its --rounds 4
# --devices 8 --controllers lroa,uni_d,uni_s,divfl) and reference.arena's
# bound on it; the arches served by serve_decode_torch
EXAMPLES_FL = dict(rounds=4, devices=8,
                   controllers=("lroa", "uni_d", "uni_s", "divfl"))
EXAMPLES_FL_TOL = 1e-6
EXAMPLES_SERVE = ("gemma2-27b", "mamba2-130m")


@contextlib.contextmanager
def cudnn_deterministic(on: bool = True):
    """cuDNN's deterministic algorithms on (or off) for the block."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def log(phase: str, **fields) -> None:
    """One result line, with ``at_s``: the seconds since the script
    started, which show where its time goes."""
    fields["at_s"] = time.perf_counter() - T0
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def peaks(name: str):
    for key, hbm, f32, bf16 in PEAKS:
        if key in name:
            return hbm, f32, bf16
    raise RuntimeError(f"no published peaks for card {name!r}")


def time_ms(fn, iters: int = 30, flush=None, clean: bool = False) -> float:
    """Median device time of ``fn`` over CUDA events, one launch per
    event pair, with the L2 cache flushed before each launch.

    The default flush writes the buffer (``zero_()``), which leaves up to
    the L2's size of dirty lines that a memory-bound kernel must write back
    as its reads evict them; ``clean`` reads the buffer instead, which
    leaves none.  After either flush the device is held for about 5 ms
    (``torch.cuda._sleep``), so the host has enqueued ``fn``
    before its start event is reached: the time is the device's alone,
    even for a call whose Python takes longer than the flush."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            if clean:
                flush.sum()
            else:
                flush.zero_()
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_kernels(flush, hbm: float, f32_peak: float) -> list:
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    points = []
    for n, k, dtype in POINTS:
        theta = torch.randn(n, device="cuda", generator=gen).to(dtype)
        deltas = torch.randn(k, n, device="cuda", generator=gen).to(dtype)
        coeffs = torch.softmax(torch.randn(k, device="cuda", generator=gen),
                               0)
        tol = TOL[dtype]
        out = fk.fl_aggregate_cuda(theta, deltas, coeffs)
        red = fk.fl_delta_reduce_cuda(deltas, coeffs)
        want = ref.aggregate_reference(theta, deltas, coeffs)
        want_red = ref.delta_reduce_reference(deltas, coeffs)
        bitwise = (
            torch.equal(out, ref.aggregate_leaves_fma_reference(
                [theta], [deltas], coeffs)[0])
            and torch.equal(red, ref.aggregate_leaves_fma_reference(
                None, [deltas], coeffs)[0]))
        torch.cuda.synchronize()
        ok = (torch.allclose(out.float(), want.float(), atol=tol, rtol=tol)
              and torch.allclose(red, want_red, atol=tol, rtol=tol))
        err = float((out.float() - want.float()).abs().max())
        err_red = float((red - want_red).abs().max())
        size = theta.element_size()
        agg_bytes = (k + 2) * n * size + 4 * k
        red_bytes = k * n * size + 4 * n + 4 * k
        ops = 2 * k * n
        def kernel():
            return fk.fl_aggregate_cuda(theta, deltas, coeffs)

        def library():
            return torch.addmv(theta, deltas.t(), coeffs)

        f32 = dtype == torch.float32
        row = dict(
            n=n, k=k, dtype=str(dtype).replace("torch.", ""), tol=tol,
            max_abs_err=err, reduce_max_abs_err=err_red,
            bitwise_equal_to_fma_order=bitwise,
            vec=fk.vector_width(n, k, [(t.data_ptr(), t.element_size())
                                       for t in (theta, deltas, out)]),
            flush="clean",
            ms=time_ms(kernel, flush=flush, clean=True),
            ms_zero_flush=time_ms(kernel, flush=flush),
            plain_ms=time_ms(lambda: ref.aggregate_reference(
                theta, deltas, coeffs), flush=flush, clean=True),
            library_ms=(time_ms(library, flush=flush, clean=True)
                        if f32 else None),
            library_ms_zero_flush=(time_ms(library, flush=flush)
                                   if f32 else None),
            bound_ms=max(agg_bytes / hbm, ops / f32_peak) * 1e3,
            bound_by="bytes" if agg_bytes / hbm >= ops / f32_peak
            else "operations",
            reduce_ms=time_ms(lambda: fk.fl_delta_reduce_cuda(deltas,
                                                              coeffs),
                              flush=flush, clean=True),
            reduce_plain_ms=time_ms(lambda: ref.delta_reduce_reference(
                deltas, coeffs), flush=flush, clean=True),
            reduce_library_ms=(time_ms(lambda: torch.mv(deltas.t(), coeffs),
                                       flush=flush, clean=True)
                               if f32 else None),
            reduce_bound_ms=max(red_bytes / hbm, ops / f32_peak) * 1e3)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        log("kernel", **row)
        require(ok, f"kernel disagrees with its plain version at N={n} "
                    f"K={k} {dtype} (err {err}, reduce err {err_red}, "
                    f"tol {tol})")
        require(bitwise, f"kernel is not bitwise its order of arithmetic "
                         f"(ref.aggregate_leaves_fma_reference) at N={n} "
                         f"K={k} {dtype}")
        points.append(row)
        del theta, deltas, out, red, want, want_red
    return points


def _flat_leaves(tree, prefix: str = "") -> dict:
    """A nested dict of tensors as one dict of ``a/b/c`` names."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat_leaves(value, f"{prefix}{name}/"))
        else:
            out[f"{prefix}{name}"] = value
    return out


def wall_us(fn, calls: int = 200) -> float:
    """Host wall time per call of ``fn`` over back-to-back calls ended by
    one synchronise: the eager cost a caller pays, host work included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _leaf_bytes(thetas, deltas) -> int:
    """Each theta and delta read once, each output (theta's type) written
    once."""
    return sum(2 * t.numel() * t.element_size() + d.numel() * d.element_size()
               for t, d in zip(thetas, deltas))


def cnn_leaves(gen, k: int) -> tuple:
    """The paper-scale CNN's parameters (its six leaves) and K stacked
    deltas, on the card, from ``gen``."""
    params = make_task(PAPER_SCALE).init(gen)
    return params, {n: torch.randn((k,) + tuple(p.shape), device="cuda",
                                   generator=gen) * 1e-2
                    for n, p in params.items()}


def lm_leaves(gen, k: int) -> tuple:
    """gemma2-27b's smoke LM at 6 layers in bf16, as a model that keeps one
    tensor per layer holds it, and K bf16 deltas per leaf.  The smoke LM
    stacks each block weight over the layers of its pattern position (24
    leaves at any depth); split per layer, 6 layers give 68 leaves (more
    than one launch's table), each a view into its stacked tensor.  The
    deltas are of unit scale, so a wrong row, coefficient or leaf moves the
    output far past the bf16 tolerance."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import build_model

    cfg = dataclasses.replace(get_smoke_config("gemma2-27b"), num_layers=6)
    thetas = []
    for name, p in _flat_leaves(build_model(cfg, device="cuda").init(
            gen)).items():
        p = p.to(torch.bfloat16)
        thetas += ([p[i] for i in range(p.shape[0])]
                   if name.startswith("blocks/") else [p])
    return thetas, [torch.randn((k,) + tuple(p.shape), device="cuda",
                                generator=gen).to(torch.bfloat16)
                    for p in thetas]


def phase_aggregate_leaves(flush, hbm: float, f32_peak: float) -> dict:
    """The leaf kernel on the paths that reach it: ``aggregate_fused`` at
    the paper-scale CNN's six leaves (K = 8, f32), the main path's call,
    against the plain per-leaf version (within TOL), its exact order of
    arithmetic (``ref.aggregate_leaves_fma_reference``, bitwise), the
    ravel path (``ParamRavel.ravel`` and ``ravel_stacked``, the flat entry
    ``fl_aggregate_cuda``, ``unravel``; bitwise) and a CUDA-graph replay
    (bitwise equal to the eager call); then the kernel against its plain
    versions on many leaves: :func:`lm_leaves` (68 bf16 leaves, more than
    one table) with K = 4, and ragged leaves of mixed dtypes."""
    import math

    from repro_torch.fl import server
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    k = MAIN_POINT[1]
    params, stacked = cnn_leaves(gen, k)
    coeffs = torch.softmax(torch.randn(k, device="cuda", generator=gen), 0)
    ad = server.ParamRavel(params)

    def leaf_path():
        return server.aggregate_fused(params, stacked, coeffs)

    def ravel_path():
        return ad.unravel(fk.fl_aggregate_cuda(
            ad.ravel(params), ad.ravel_stacked(stacked), coeffs))

    thetas = [params[n] for n in ad.names]
    deltas = [stacked[n] for n in ad.names]
    before = fk.LAUNCHES["fl_aggregate"]
    new = leaf_path()
    launches = fk.LAUNCHES["fl_aggregate"] - before
    old = ravel_path()
    plain = ref.aggregate_leaves_reference(thetas, deltas, coeffs)
    exact = ref.aggregate_leaves_fma_reference(thetas, deltas, coeffs)
    torch.cuda.synchronize()
    tol = TOL[torch.float32]
    close = all(torch.allclose(new[n], w, atol=tol, rtol=tol)
                for n, w in zip(ad.names, plain))
    err = max(float((new[n] - w).abs().max())
              for n, w in zip(ad.names, plain))
    bitwise_fma = all(torch.equal(new[n], w)
                      for n, w in zip(ad.names, exact))
    bitwise = all(torch.equal(new[n], old[n]) for n in ad.names)
    del plain, exact

    # a CUDA graph of the call on fixed buffers, replayed on new deltas
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaf_path()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = leaf_path()
    for d in stacked.values():
        d.mul_(-0.5)
    graph.replay()
    eager = leaf_path()
    torch.cuda.synchronize()
    graph_equal = all(torch.equal(captured[n], eager[n]) for n in ad.names)

    nbytes = _leaf_bytes(thetas, deltas) + 4 * k
    bound_ms, bound_by = _bound(nbytes, 2 * k * ad.total, hbm, f32_peak)
    fused = dict(
        leaves=len(ad.names), n=ad.total, k=k, dtype="float32",
        sizes=dict(zip(ad.names, ad.sizes)),
        vec={n: fk.vector_width(sz, k, [(params[n].data_ptr(), 4),
                                        (stacked[n].data_ptr(), 4)])
             for n, sz in zip(ad.names, ad.sizes)},
        launches=launches, tol=tol, max_abs_err=err,
        bitwise_equal_to_fma_order=bitwise_fma,
        bitwise_equal_to_ravel_path=bitwise,
        graph_bitwise_equal=graph_equal, flush="clean",
        ms=time_ms(leaf_path, flush=flush, clean=True),
        plain_ms=time_ms(lambda: ref.aggregate_leaves_reference(
            thetas, deltas, coeffs), flush=flush, clean=True),
        ravel_path_ms=time_ms(ravel_path, flush=flush, clean=True),
        graph_replay_ms=time_ms(graph.replay, flush=flush, clean=True),
        ms_zero_flush=time_ms(leaf_path, flush=flush),
        ravel_path_ms_zero_flush=time_ms(ravel_path, flush=flush),
        wall_us=wall_us(leaf_path), ravel_path_wall_us=wall_us(ravel_path),
        graph_replay_wall_us=wall_us(graph.replay),
        bound_ms=bound_ms, bound_by=bound_by, mbytes=nbytes * 1e-6)
    fused["bound_share"] = bound_ms / fused["ms"]
    log("kernel.aggregate_fused", **fused)
    require(launches == 1, f"aggregate_fused at the CNN's leaves: one "
                           f"fl_aggregate launch, got {launches}")
    require(close, f"aggregate_fused disagrees with the plain per-leaf "
                   f"version (err {err}, tol {tol})")
    require(bitwise_fma, "aggregate_fused is bitwise its order of "
                         "arithmetic (ref.aggregate_leaves_fma_reference)")
    require(bitwise, "aggregate_fused is bitwise equal to the ravel path")
    require(graph_equal, "a CUDA graph replay of aggregate_fused is bitwise "
                         "equal to the eager call")
    del graph, captured, eager, new, old

    lm_thetas, lm_deltas = lm_leaves(gen, 4)
    ragged = [(1,), (7,), (3, 11), (257,), (5, 13, 2), (1025,), (),
              (4099,), (65_537,)]
    pairs = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.float32, torch.float32))
    rag_thetas = [torch.randn(s, device="cuda", generator=gen).to(
        pairs[i % 4][0]) for i, s in enumerate(ragged)]
    rag_deltas = [torch.randn((3,) + s, device="cuda", generator=gen).to(
        pairs[i % 4][1]) for i, s in enumerate(ragged)]
    cap = fk._library().fl_aggregate_max_segments()
    rows = []
    for label, ths, dls, want_launches in (
            ("gemma2-27b.smoke.6_layers.per_layer.bf16", lm_thetas,
             lm_deltas, math.ceil(len(lm_thetas) / cap)),
            ("ragged.mixed_dtypes", rag_thetas, rag_deltas, len(pairs))):
        kk = dls[0].shape[0]
        c = torch.softmax(torch.randn(kk, device="cuda", generator=gen), 0)
        before = fk.LAUNCHES["fl_aggregate"]
        outs = fk.fl_aggregate_leaves_cuda(ths, dls, c)
        n_launch = fk.LAUNCHES["fl_aggregate"] - before
        wants = ref.aggregate_leaves_reference(ths, dls, c)
        exact = ref.aggregate_leaves_fma_reference(ths, dls, c)
        torch.cuda.synchronize()
        tol = TOL[torch.bfloat16]
        ok = all(torch.allclose(o.float(), w.float(), atol=tol, rtol=tol)
                 for o, w in zip(outs, wants))
        err = max(float((o.float() - w.float()).abs().max())
                  for o, w in zip(outs, wants))
        bitwise_fma = all(torch.equal(o, w) for o, w in zip(outs, exact))
        del exact
        n = sum(t.numel() for t in ths)
        nbytes = _leaf_bytes(ths, dls) + 4 * kk
        bound_ms, bound_by = _bound(nbytes, 2 * kk * n, hbm, f32_peak)
        row = dict(
            label=label, leaves=len(ths), n=n, k=kk, tol=tol,
            max_abs_err=err, bitwise_equal_to_fma_order=bitwise_fma,
            launches=n_launch,
            odd_sized_leaves=sum(1 for t in ths if t.numel() % 8),
            ms=time_ms(lambda: fk.fl_aggregate_leaves_cuda(ths, dls, c),
                       flush=flush, clean=True),
            plain_ms=time_ms(lambda: ref.aggregate_leaves_reference(
                ths, dls, c), flush=flush, clean=True),
            wall_us=wall_us(lambda: fk.fl_aggregate_leaves_cuda(ths, dls, c),
                            calls=50),
            bound_ms=bound_ms, bound_by=bound_by, mbytes=nbytes * 1e-6)
        log("kernel.aggregate_leaves", **row)
        require(ok, f"leaf kernel disagrees with its plain version at "
                    f"{label} (err {err}, tol {tol})")
        require(bitwise_fma, f"leaf kernel is not bitwise its order of "
                             f"arithmetic at {label}")
        require(n_launch == want_launches,
                f"{label}: {want_launches} launches, got {n_launch}")
        rows.append(row)
    torch.cuda.empty_cache()
    return dict(fused=fused, leaves=rows)


def phase_aggregate_resnet(flush, hbm: float, f32_peak: float) -> dict:
    """The eq.-(4) step of the CIFAR-like testbed's round
    (``aggregate_fused`` at the paper-scale ResNet's 17 leaves, 694,378
    params, K = 8, f32): one launch, within TOL of the plain per-leaf
    version, bitwise its order of arithmetic
    (``ref.aggregate_leaves_fma_reference``), timed beside its bound as
    ``kernel.aggregate_fused`` is; then the per-leaf form
    ``ops.fl_aggregate_pytree`` on the same leaves: 17 launches, each leaf
    bitwise the one-launch call's."""
    from repro_torch.fl import server
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    k = MAIN_POINT[1]
    params = make_task(PAPER_CIFAR).init(gen)
    stacked = {n: torch.randn((k,) + tuple(p.shape), device="cuda",
                              generator=gen) * 1e-2
               for n, p in params.items()}
    coeffs = torch.softmax(torch.randn(k, device="cuda", generator=gen), 0)
    names = sorted(params)
    thetas = [params[n] for n in names]
    deltas = [stacked[n] for n in names]

    def leaf_path():
        return server.aggregate_fused(params, stacked, coeffs)

    def pytree_path():
        return ops.fl_aggregate_pytree(params, stacked, coeffs)

    before = fk.LAUNCHES["fl_aggregate"]
    new = leaf_path()
    launches = fk.LAUNCHES["fl_aggregate"] - before
    before = fk.LAUNCHES["fl_aggregate"]
    per_leaf = pytree_path()
    pytree_launches = fk.LAUNCHES["fl_aggregate"] - before
    plain = ref.aggregate_leaves_reference(thetas, deltas, coeffs)
    exact = ref.aggregate_leaves_fma_reference(thetas, deltas, coeffs)
    torch.cuda.synchronize()
    tol = TOL[torch.float32]
    close = all(torch.allclose(new[n], w, atol=tol, rtol=tol)
                for n, w in zip(names, plain))
    err = max(float((new[n] - w).abs().max()) for n, w in zip(names, plain))
    bitwise_fma = all(torch.equal(new[n], w) for n, w in zip(names, exact))
    pytree_bitwise = all(torch.equal(per_leaf[n], new[n]) for n in names)
    del plain, exact, per_leaf
    sizes = {n: params[n].numel() for n in names}
    total = sum(sizes.values())
    nbytes = _leaf_bytes(thetas, deltas) + 4 * k
    bound_ms, bound_by = _bound(nbytes, 2 * k * total, hbm, f32_peak)
    row = dict(
        leaves=len(names), n=total, k=k, dtype="float32", sizes=sizes,
        vec={n: fk.vector_width(sizes[n], k, [(params[n].data_ptr(), 4),
                                              (stacked[n].data_ptr(), 4)])
             for n in names},
        launches=launches, tol=tol, max_abs_err=err,
        bitwise_equal_to_fma_order=bitwise_fma,
        pytree_launches=pytree_launches,
        pytree_bitwise_equal_to_one_launch=pytree_bitwise, flush="clean",
        ms=time_ms(leaf_path, flush=flush, clean=True),
        plain_ms=time_ms(lambda: ref.aggregate_leaves_reference(
            thetas, deltas, coeffs), flush=flush, clean=True),
        pytree_ms=time_ms(pytree_path, flush=flush, clean=True),
        ms_zero_flush=time_ms(leaf_path, flush=flush),
        wall_us=wall_us(leaf_path), pytree_wall_us=wall_us(pytree_path),
        bound_ms=bound_ms, bound_by=bound_by, mbytes=nbytes * 1e-6)
    row["bound_share"] = bound_ms / row["ms"]
    log("kernel.aggregate_resnet", **row)
    require(len(names) == 17 and total == 694_378,
            f"the paper-scale ResNet has 17 leaves and 694,378 params, got "
            f"{len(names)} and {total}")
    require(launches == 1, f"aggregate_fused at the ResNet's leaves: one "
                           f"fl_aggregate launch, got {launches}")
    require(close, f"aggregate_fused at the ResNet's leaves disagrees with "
                   f"the plain per-leaf version (err {err}, tol {tol})")
    require(bitwise_fma, "aggregate_fused at the ResNet's leaves is bitwise "
                         "its order of arithmetic")
    require(pytree_launches == len(names),
            f"fl_aggregate_pytree: one launch per leaf ({len(names)}), got "
            f"{pytree_launches}")
    require(pytree_bitwise, "fl_aggregate_pytree is bitwise the one-launch "
                            "call, leaf by leaf")
    torch.cuda.empty_cache()
    return row


def phase_aggregate_lanes(flush, hbm: float, f32_peak: float) -> list:
    """The lane kernel (``fl_aggregate_lanes_cuda``, the scenario arena's
    eq.-(4) step of every lane in one launch per table) at the CNN's six
    leaves, f32, K = 8, over :data:`LANE_POINTS` lanes: bitwise its exact
    order of arithmetic (``ref.aggregate_lanes_fma_reference``) and S
    one-lane launches, within TOL of the plain version
    (``ref.aggregate_lanes_reference``), one launch per table.  Timed
    after the clean flush beside the bound, the S one-lane launches the
    arena would need without it, and ``torch.baddbmm`` on the ravelled
    ``[S, 1, K] x [S, K, N]`` (a flat yardstick: timed, never used)."""
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    cap = fk._library().fl_aggregate_max_segments()
    rows = []
    for lanes, k in LANE_POINTS:
        per = [cnn_leaves(gen, k) for _ in range(lanes)]
        names = sorted(per[0][0])
        thetas = [torch.stack([p[0][n] for p in per]) for n in names]
        deltas = [torch.stack([p[1][n] for p in per]) for n in names]
        del per
        coeffs = torch.softmax(torch.randn(lanes, k, device="cuda",
                                           generator=gen), 1).contiguous()
        before = fk.LAUNCHES["fl_aggregate_lanes"]
        out = fk.fl_aggregate_lanes_cuda(thetas, deltas, coeffs)
        launches = fk.LAUNCHES["fl_aggregate_lanes"] - before
        exact = ref.aggregate_lanes_fma_reference(thetas, deltas, coeffs)
        bitwise_fma = all(torch.equal(o, e) for o, e in zip(out, exact))
        del exact
        plain = ref.aggregate_lanes_reference(thetas, deltas, coeffs)
        err = max(float((o - w).abs().max()) for o, w in zip(out, plain))
        tol = TOL[torch.float32]
        close = all(torch.allclose(o, w, atol=tol, rtol=tol)
                    for o, w in zip(out, plain))
        del plain

        def one_lane_calls():
            return [fk.fl_aggregate_leaves_cuda(
                [t[s] for t in thetas], [d[s] for d in deltas], coeffs[s])
                for s in range(lanes)]

        bitwise_one = all(torch.equal(out[i][s], o)
                          for s, lane in enumerate(one_lane_calls())
                          for i, o in enumerate(lane))
        torch.cuda.synchronize()
        n = sum(t[0].numel() for t in thetas)
        theta_flat = torch.cat([t.reshape(lanes, 1, -1) for t in thetas], 2)
        delta_flat = torch.cat([d.reshape(lanes, k, -1) for d in deltas], 2)
        nbytes = _leaf_bytes(thetas, deltas) + 4 * lanes * k
        bound_ms, bound_by = _bound(nbytes, 2 * k * n * lanes, hbm, f32_peak)
        segments = lanes * len(names)
        row = dict(
            lanes=lanes, k=k, leaves=len(names), n=n, segments=segments,
            tables=-(-segments // cap), dtype="float32", launches=launches,
            tol=tol, max_abs_err=err, bitwise_equal_to_fma_order=bitwise_fma,
            bitwise_equal_to_one_lane_launches=bitwise_one, flush="clean",
            ms=time_ms(lambda: fk.fl_aggregate_lanes_cuda(
                thetas, deltas, coeffs), flush=flush, clean=True),
            one_lane_launches_ms=time_ms(one_lane_calls, flush=flush,
                                         clean=True),
            plain_ms=time_ms(lambda: ref.aggregate_lanes_reference(
                thetas, deltas, coeffs), flush=flush, clean=True),
            baddbmm_flat_ms=time_ms(lambda: torch.baddbmm(
                theta_flat, coeffs[:, None, :], delta_flat), flush=flush,
                clean=True),
            ms_zero_flush=time_ms(lambda: fk.fl_aggregate_lanes_cuda(
                thetas, deltas, coeffs), flush=flush),
            wall_us=wall_us(lambda: fk.fl_aggregate_lanes_cuda(
                thetas, deltas, coeffs), calls=100),
            bound_ms=bound_ms, bound_by=bound_by, mbytes=nbytes * 1e-6)
        row["bound_share"] = bound_ms / row["ms"]
        log("kernel.aggregate_lanes", **row)
        require(bitwise_fma, f"lane kernel at {lanes} lanes is bitwise its "
                             f"order of arithmetic")
        require(bitwise_one, f"lane kernel at {lanes} lanes is bitwise the "
                             f"one-lane launches")
        require(close, f"lane kernel at {lanes} lanes agrees with its plain "
                       f"version (err {err}, tol {tol})")
        require(launches == row["tables"],
                f"lane kernel at {lanes} lanes: {row['tables']} launches, "
                f"got {launches}")
        rows.append(row)
        del thetas, deltas, out, theta_flat, delta_flat
    torch.cuda.empty_cache()
    return rows


def make_task(cfg: dict):
    """``cfg``'s task: the ResNet (``task='resnet'``) or the CNN."""
    from repro_torch.models import CNNTask, ResNetTask

    cls = ResNetTask if cfg.get("task", "cnn") == "resnet" else CNNTask
    return cls(image_shape=cfg["image_shape"],
               num_classes=cfg["num_classes"], width=cfg["width"])


def build_trainer(device: str, cfg: dict, data: dict, sort_keys_fn=None,
                  bank_mode: str = "auto", bank_storage: str = "fp32",
                  controller: str = "lroa", use_engine: bool = True,
                  client_keys_fn=None, mesh=None):
    """A ``FederatedTrainer`` on ``cfg``'s testbed under ``controller``
    (a key of ``repro_torch.sim.testbed.CONTROLLERS``), on the bank
    ``bank_mode`` builds (the trainer's default 'auto': the tier ladder
    when the partition spans several tiers); ``use_engine=False`` takes
    the sequential reference path; ``mesh`` shards the client axis over
    its ranks."""
    import repro_torch.core as core
    from repro_torch.fl import (ChannelConfig, ChannelProcess, ClientConfig,
                                FederatedTrainer)
    from repro_torch.optim import paper_step_decay
    from repro_torch.sim.testbed import CONTROLLERS

    params = core.paper_default_params(
        num_devices=cfg["num_devices"], sample_count=cfg["sample_count"],
        local_epochs=cfg["local_epochs"], data_sizes=data["sizes"],
        dataset=cfg.get("dataset", "cifar10"), device=device)
    hp = core.estimate_hyperparams(params, 0.1, loss_scale=1.5, mu=1.0,
                                   nu=1e5)
    return FederatedTrainer(
        make_task(cfg), params, CONTROLLERS[controller](params, hp),
        ChannelProcess(cfg["num_devices"], ChannelConfig(seed=cfg["seed"])),
        data["clients"],
        ClientConfig(local_epochs=cfg["local_epochs"],
                     batch_size=cfg["batch_size"]),
        paper_step_decay(cfg["lr"], cfg["rounds"]), test_data=data["test"],
        eval_every=cfg.get("eval_every", max(cfg["rounds"] // 6, 1)),
        seed=cfg["seed"], bank_mode=bank_mode, bank_storage=bank_storage,
        device=device, sort_keys_fn=sort_keys_fn, use_engine=use_engine,
        client_keys_fn=client_keys_fn, mesh=mesh)


def make_data(cfg: dict) -> dict:
    """The benchmark testbed's data (``repro_torch.sim.testbed.
    build_testbed``, the port's numpy copies of the data layer);
    ``cfg['partition'] == 'writer'`` takes the FEMNIST-like writer
    partition instead of the Dirichlet one, and with ``cfg['sizes']``,
    the training split is cut into clients of those sizes."""
    from repro_torch.data import (make_client_datasets,
                                  synthetic_image_classification,
                                  train_test_split, writer_partition)
    from repro_torch.sim.testbed import BenchConfig, build_testbed

    if "sizes" not in cfg and cfg.get("partition") != "writer":
        params, _, clients, test = build_testbed(BenchConfig(
            num_devices=cfg["num_devices"], num_classes=cfg["num_classes"],
            image_shape=cfg["image_shape"], examples=cfg["examples"],
            seed=cfg["seed"]), device="cpu")
        return dict(clients=clients, test=test,
                    sizes=params.data_sizes.numpy())
    x, y = synthetic_image_classification(
        cfg["examples"], cfg["image_shape"], cfg["num_classes"], noise=0.3,
        seed=cfg["seed"])
    (xtr, ytr), test = train_test_split(x, y, 0.15, seed=cfg["seed"] + 1)
    if "sizes" in cfg:
        offs = np.cumsum((0,) + tuple(cfg["sizes"]))
        parts = [np.arange(offs[i], offs[i + 1])
                 for i in range(len(cfg["sizes"]))]
    else:
        parts = writer_partition(ytr, cfg["num_devices"],
                                 seed=cfg["seed"] + 2)
    return dict(clients=make_client_datasets(xtr, ytr, parts), test=test,
                sizes=np.asarray([len(p) for p in parts], np.float32))


def _tiers_hit(bank, selected) -> list:
    """The ladder's tiers a selection falls in ([0] on one bucket)."""
    tier_of = getattr(bank, "tier_of", None)
    sel = np.maximum(np.asarray(selected), 0)
    return [0] if tier_of is None else np.unique(tier_of[sel]).tolist()


def phase_reference(devices=("cpu", "cuda"), cfg: dict = SMALL,
                    bank_mode: str = "single", storage: str = "fp32",
                    label: str = "reference") -> None:
    """The port on the card against the port on the CPU, on a small
    testbed, with the same initial params and epoch keys (drawn as wide
    as the bank's widest bucket).  Each round of the card's run launches
    ``fl_aggregate`` once, however many tiers it hits, the CPU's never.
    Also run by ``tests/test_torch_cuda.py``."""
    from repro_torch.data import bucket_examples
    from repro_torch.kernels import fl_aggregate as fk

    data = make_data(cfg)
    rows = bucket_examples([len(x) for x, _ in data["clients"]],
                           cfg["batch_size"])
    runs = []
    for device in devices:
        key_rng = np.random.default_rng(123)
        trainer = build_trainer(
            device, cfg, data, sort_keys_fn=lambda k, r=key_rng: r.random(
                (k, cfg["local_epochs"], rows), np.float32),
            bank_mode=bank_mode, bank_storage=storage)
        require(trainer.bank.bucket_examples == rows,
                f"{label}: the keys cover the widest bucket")
        gen = torch.Generator()
        gen.manual_seed(7)
        trainer.global_params = {
            name: p.to(device) for name, p in trainer.task.init(gen).items()}
        recs, per_round = [], []
        for t in range(cfg["rounds"]):
            before = fk.LAUNCHES["fl_aggregate"]
            recs.append(trainer.run_round(t))
            per_round.append(fk.LAUNCHES["fl_aggregate"] - before)
        want = 1 if device == "cuda" else 0
        require(per_round == [want] * cfg["rounds"],
                f"{label} {device} run: fl_aggregate launches per round "
                f"{per_round}, want {want}")
        runs.append((recs, {n: p.cpu() for n, p in
                            trainer.global_params.items()},
                     trainer.controller.queues.cpu()))
    (rc, pc, qc), (rg, pg, qg) = runs
    sel_equal = all(a.selected == b.selected for a, b in zip(rc, rg))
    param_err = max(float((pc[n] - pg[n]).abs().max()) for n in pc)
    loss_err = max(abs(a.mean_loss - b.mean_loss) for a, b in zip(rc, rg))
    queue_rel = float(((qc - qg).abs() / qc.abs().clamp(min=1.0)).max())
    log(label, rounds=cfg["rounds"], bank=type(trainer.bank).__name__,
        storage=storage, tiers_hit=[_tiers_hit(trainer.bank, r.selected)
                                    for r in rg],
        selections_equal=sel_equal,
        param_max_abs_err=param_err, loss_max_abs_err=loss_err,
        queue_max_rel_err=queue_rel, tol=1e-4)
    require(sel_equal, "card and CPU select the same clients")
    require(param_err <= 1e-4 and loss_err <= 1e-4 and queue_rel <= 1e-4,
            "card and CPU runs agree within 1e-4")


def _seq_run(trainer, device: str, rounds: int) -> tuple:
    """``rounds`` rounds of ``trainer`` from the CPU generator's init
    (seed 7): its records, params and queues on the CPU, DivFL's update
    bank (or None) and the ``fl_aggregate`` launches of each round."""
    from repro_torch.kernels import fl_aggregate as fk

    gen = torch.Generator()
    gen.manual_seed(7)
    trainer.global_params = {
        name: p.to(device) for name, p in trainer.task.init(gen).items()}
    recs, launches = [], []
    for t in range(rounds):
        before = fk.LAUNCHES["fl_aggregate"]
        recs.append(trainer.run_round(t))
        launches.append(fk.LAUNCHES["fl_aggregate"] - before)
    bank = getattr(trainer.controller, "_update_bank", None)
    return (recs, {n: p.cpu() for n, p in trainer.global_params.items()},
            trainer.controller.queues.cpu(),
            None if bank is None else bank.copy(), launches)


def phase_reference_sequential(devices=("cpu", "cuda"), cfg: dict = SMALL,
                               label: str = "reference.sequential") -> None:
    """The sequential reference path (``use_engine=False``) on the card
    against the CPU on the small testbed, under LROA and DivFL (DivFL
    observing each client's update sketch before the next trains), T = 3,
    the same init and per-client epoch keys: equal selections, params,
    losses, queues and DivFL's update bank within 1e-4, no
    ``fl_aggregate`` launch (the list API aggregates in plain PyTorch on
    every device).  Then, on the last device, the fused trainer against
    the sequential one at equal client sizes (no padding; the keys of
    one numpy stream, read ``[K, E, B]`` by the fused path and ``[E, B]``
    per client by the sequential one), as ``tests/test_round_engine.py``
    holds the JAX package's two paths: equal selections, losses within
    1e-5, params within 2e-5; and ``round_step_stacked`` on the bank's
    host rows bitwise ``round_step``.  Also run by
    ``tests/test_torch_cuda.py``."""
    e = cfg["local_epochs"]
    data = make_data(cfg)
    runs = {}
    for device in devices:
        for name in ("lroa", "divfl"):
            key_rng = np.random.default_rng(123)
            trainer = build_trainer(
                device, cfg, data, bank_mode="single", controller=name,
                use_engine=False,
                client_keys_fn=lambda rows, r=key_rng: r.random(
                    (e, rows)).astype(np.float32))
            runs[device, name] = _seq_run(trainer, device, cfg["rounds"])
    for name in ("lroa", "divfl"):
        (rc, pc, qc, bc, lc), (rg, pg, qg, bg, lg) = (
            runs[devices[0], name], runs[devices[-1], name])
        sel_equal = all(a.selected == b.selected for a, b in zip(rc, rg))
        param_err = max(float((pc[n] - pg[n]).abs().max()) for n in pc)
        loss_err = max(abs(a.mean_loss - b.mean_loss)
                       for a, b in zip(rc, rg))
        queue_err = float((qc - qg).abs().max())
        bank_err = (None if bc is None else
                    float(np.max(np.abs(bc - bg))))
        log(label, controller=name, rounds=cfg["rounds"],
            selections=[r.selected for r in rg],
            selections_equal=sel_equal, param_max_abs_err=param_err,
            loss_max_abs_err=loss_err, queue_max_abs_err=queue_err,
            update_bank_max_abs_err=bank_err, tol=1e-4,
            fl_aggregate_launches=lc + lg)
        require(sel_equal, f"{label} {name}: card and CPU select the same "
                           f"clients")
        require(max(param_err, loss_err, queue_err) <= 1e-4,
                f"{label} {name}: card and CPU runs agree within 1e-4")
        require(sum(lc + lg) == 0, f"{label} {name}: the sequential path "
                                   f"launches no fl_aggregate")
        if name == "divfl":
            require(bg is not None and bool(np.any(bg)) and
                    bank_err <= 1e-4,
                    f"{label}: DivFL's update bank filled, card and CPU "
                    f"within 1e-4")

    device = devices[-1]
    equal = dict(cfg, sizes=(32,) * cfg["num_devices"])
    data_eq = make_data(equal)
    paths = {}
    for use_engine in (True, False):
        key_rng = np.random.default_rng(5)
        trainer = build_trainer(
            device, equal, data_eq, bank_mode="single",
            use_engine=use_engine,
            sort_keys_fn=lambda k, r=key_rng: r.random(
                (k, e, 32)).astype(np.float32),
            client_keys_fn=lambda rows, r=key_rng: r.random(
                (e, rows)).astype(np.float32))
        require(trainer.bank.uniform and trainer.bank.bucket_examples == 32,
                f"{label}: equal sizes fill one 32-row bucket")
        paths[use_engine] = _seq_run(trainer, device, cfg["rounds"])
    (rf, pf, _, _, lf), (rs, ps, _, _, ls) = paths[True], paths[False]
    sel_equal = all(a.selected == b.selected for a, b in zip(rf, rs))
    loss_err = max(abs(a.mean_loss - b.mean_loss) for a, b in zip(rf, rs))
    param_err = max(float((pf[n] - ps[n]).abs().max()) for n in pf)
    want = 1 if device == "cuda" else 0
    log(f"{label}.fused", device=device, rounds=cfg["rounds"],
        selections_equal=sel_equal, loss_max_abs_err=loss_err,
        param_max_abs_err=param_err, loss_tol=1e-5, param_tol=2e-5,
        fused_fl_aggregate_launches=lf, sequential_fl_aggregate_launches=ls)
    require(sel_equal, f"{label}.fused: the two paths select alike")
    require(loss_err <= 1e-5 and param_err <= 2e-5,
            f"{label}.fused: losses within 1e-5 and params within 2e-5")
    require(lf == [want] * cfg["rounds"] and sum(ls) == 0,
            f"{label}.fused: {want} fl_aggregate launch per fused round, "
            f"none on the sequential path")

    trainer = build_trainer(device, cfg, data, bank_mode="single")
    engine, bank = trainer.engine, trainer.bank
    sel = np.asarray([0, 2, 2], np.int64)[:cfg["sample_count"]]
    coeffs = np.linspace(0.5, 0.2, sel.size).astype(np.float32)
    keys = torch.as_tensor(np.random.default_rng(9).random(
        (sel.size, e, bank.bucket_examples)).astype(np.float32),
        device=device)
    xs, ys, ns, ne = bank.gather_host(sel)
    got, gl = engine.round_step_stacked(trainer.global_params, xs, ys,
                                        coeffs, 0.1, keys, ns, ne)
    wanted, wl = engine.round_step(trainer.global_params, bank, sel, coeffs,
                                   0.1, keys)
    bitwise = torch.equal(gl, wl) and all(torch.equal(got[n], wanted[n])
                                          for n in wanted)
    log(f"{label}.stacked", device=device, selected=sel.tolist(),
        masked=ns is not None, bitwise_equal=bitwise)
    require(bitwise, f"{label}.stacked: round_step_stacked is bitwise "
                     f"round_step")


def _rel_err(a, b) -> float:
    """max |a - b| / max(|b|, 1) over two arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def phase_reference_scan(devices=("cpu", "cuda"), cfg: dict = SMALL,
                         bank_mode: str = "single",
                         label: str = "reference.scan") -> None:
    """``RoundEngine.run_scan`` of every controller on the card against
    the same rollout on the CPU, on the small testbed of
    :func:`phase_reference`: the same initial params, channels, learning
    rates and draws (the rollout key comes from a CPU generator, and the
    counter-based draws give the same bits on both), T = 3 rounds; then
    one LROA rollout with 20% dropout and one with padded K (K_max = K +
    2).  Selections equal, params, queues and every metric within 1e-4,
    exactly T ``fl_aggregate`` launches on the card and none on the CPU,
    and the padded rollout's params bitwise the unpadded one's, on the
    card (``fl_aggregate`` adds the inert slots' exact zeros in order) and
    on the CPU, which runs on one thread here (with several, PyTorch's CPU
    reductions split the client axis by thread count, and K + 2 rows then
    sum in another order: about 3e-8 apart).  On a multi-tier ladder
    (``bank_mode``, ``cfg``) each round still launches ``fl_aggregate``
    once, and the padded rollout is held within 1e-6, not bitwise: its
    inert slots train in client 0's tier and so change the size of that
    tier's SGD call, and a one-client call (a plain convolution, not a
    grouped one) rounds differently from a call of several.  Also run
    by ``tests/test_torch_cuda.py``."""
    from repro_torch.core import POLICIES
    from repro_torch.fl import ChannelConfig, ChannelProcess
    from repro_torch.kernels import fl_aggregate as fk

    rounds = REFERENCE_SCAN_ROUNDS
    n, k = cfg["num_devices"], cfg["sample_count"]
    data = make_data(cfg)
    tiered = False
    h_seq = ChannelProcess(n, ChannelConfig(seed=cfg["seed"])
                           ).sample_sequence(rounds)
    drop = ChannelProcess(n, ChannelConfig(seed=cfg["seed"] + 1,
                                           dropout=0.2)
                          ).dropout_sequence(rounds)
    init = None
    cases = [(policy, {}) for policy in POLICIES] + [
        ("lroa", dict(drop_seq=drop)), ("lroa", dict(k_max=k + 2))]
    runs = {}
    threads = torch.get_num_threads()
    for device in devices:
        torch.set_num_threads(1 if device == "cpu" else threads)
        trainer = build_trainer(device, cfg, data, bank_mode=bank_mode)
        tiered = getattr(trainer.bank, "num_tiers", 1) > 1
        if init is None:
            init = trainer.task.init(torch.Generator().manual_seed(7))
        lr_seq = [trainer.lr_schedule(t) for t in range(rounds)]
        hp = trainer.controller.hp
        for i, (policy, extra) in enumerate(cases):
            before = fk.LAUNCHES["fl_aggregate"]
            params, queues, met = trainer.engine.run_scan(
                {name: p.to(device) for name, p in init.items()},
                trainer.params, trainer.bank, h_seq, lr_seq,
                torch.Generator().manual_seed(5), policy=policy, V=hp.V,
                lam=hp.lam, **extra)
            launched = fk.LAUNCHES["fl_aggregate"] - before
            require(launched == (rounds if device == "cuda" else 0),
                    f"{device} {policy} {sorted(extra)}: {launched} "
                    f"fl_aggregate launches in {rounds} rounds")
            runs[device, i] = ({name: p.cpu() for name, p in
                                params.items()}, queues.cpu(), met)
    torch.set_num_threads(threads)
    cpu, card = devices
    for i, (policy, extra) in enumerate(cases):
        (pc, qc, mc), (pg, qg, mg) = runs[cpu, i], runs[card, i]
        sel_equal = bool(np.array_equal(mc["selected"], mg["selected"]))
        param_err = max(float((pc[name] - pg[name]).abs().max())
                        for name in pc)
        queue_err = _rel_err(qg.numpy(), qc.numpy())
        metric_err = {name: _rel_err(mg[name], mc[name]) for name in mc
                      if name != "selected"}
        log(label, policy=policy, extra=sorted(extra),
            rounds=rounds, selections_equal=sel_equal,
            tiers_hit=[_tiers_hit(trainer.bank, row)
                       for row in mg["selected"]],
            selected=mg["selected"].tolist(), param_max_abs_err=param_err,
            queue_max_rel_err=queue_err, metric_max_rel_err=metric_err,
            q_min=mg["q_min"].tolist(), tol=1e-4)
        require(sel_equal, f"{policy}: card and CPU select the same clients")
        require(param_err <= 1e-4 and queue_err <= 1e-4 and
                max(metric_err.values()) <= 1e-4,
                f"{policy} {sorted(extra)}: card and CPU rollouts agree "
                f"within 1e-4")
        require(np.all(np.abs(mg["q_sum"] - 1.0) <= 1e-5),
                f"{policy}: q on the simplex in every round")
    padded = len(cases) - 1
    for device in devices:
        p1, q1, m1 = runs[device, 0]
        p2, q2, m2 = runs[device, padded]
        err = max(float((p1[name] - p2[name]).abs().max()) for name in p1)
        bitwise = all(torch.equal(p1[name], p2[name]) for name in p1)
        log(f"{label}.padded", device=device, k=k, k_max=k + 2,
            params_bitwise_equal=bitwise, param_max_abs_err=err,
            selections_equal=bool(np.array_equal(m2["selected"][:, :k],
                                                 m1["selected"])))
        require(np.array_equal(m2["selected"][:, :k], m1["selected"])
                and np.all(m2["selected"][:, k:] == -1),
                f"{device}: the padded rollout fills the first K slots as "
                f"the unpadded one and marks the rest -1")
        if not tiered:
            require(bitwise, f"{device}: the padded rollout's params are "
                             f"bitwise the unpadded one's")
        require(err <= 1e-6, f"{device}: the padded rollout's params within "
                             f"1e-6 of the unpadded one's ({err})")


def phase_scan(trainer, cfg: dict = PAPER_SCALE,
               rounds: int = SCAN_ROUNDS) -> dict:
    """The paper's comparison at paper scale: every controller's
    ``run_scan`` rollout of ``rounds`` rounds on the main path's engine
    and bank, from the same initial params over the same channels
    (``ChannelProcess(120, ChannelConfig(seed=0)).sample_sequence``),
    with the main path's V, lam and learning-rate schedule (``main``
    runs it with cuDNN's deterministic algorithms, which the ``arena``
    phase holds its lanes against).  Each rollout must launch ``fl_aggregate`` once per round, end with a
    finite loss, keep q on the simplex and change the params (on the CPU,
    for a rehearsal, it launches none)."""
    from repro_torch.core import POLICIES
    from repro_torch.fl import ChannelConfig, ChannelProcess
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.obs import trace

    engine, bank, sp = trainer.engine, trainer.bank, trainer.params
    dev = trainer.device
    on_card = dev.type == "cuda"
    want = rounds if on_card else 0
    hp = trainer.controller.hp
    h_seq = ChannelProcess(cfg["num_devices"], ChannelConfig(
        seed=cfg["seed"])).sample_sequence(rounds)
    lr_seq = [trainer.lr_schedule(t) for t in range(rounds)]
    init = trainer.task.init(torch.Generator(device=dev).manual_seed(
        cfg["seed"] + 1))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    trainer._sync()
    rows, results, final_queues = [], {}, {}
    _reset_launch_counts()
    t_all = time.perf_counter()
    for policy in POLICIES:
        count0 = fk.LAUNCHES["fl_aggregate"]
        with trace.installed(trace.MemorySink()) as sink:
            t0 = time.perf_counter()
            params, queues, met = engine.run_scan(
                init, sp, bank, h_seq, lr_seq,
                torch.Generator().manual_seed(cfg["seed"]), policy=policy,
                V=hp.V, lam=hp.lam)
            trainer._sync()
            seconds = time.perf_counter() - t0
        launched = fk.LAUNCHES["fl_aggregate"] - count0
        decide_s = sum(r["dur"] for r in sink.by_name("scan.decide"))
        changed = max(float((params[name] - init[name]).abs().max())
                      for name in init)
        q_err = float(np.max(np.abs(met["q_sum"] - 1.0)))
        row = dict(policy=policy, rounds=rounds, seconds=seconds,
                   rounds_per_s=rounds / seconds, decide_s=decide_s,
                   decide_share=decide_s / seconds,
                   fl_aggregate_launches=launched,
                   latency_total_s=float(np.sum(met["wall_time"])),
                   queue_mean_final=float(met["queue_mean"][-1]),
                   loss_last=float(met["loss"][-1]),
                   q_sum_max_err=q_err, q_min=float(np.min(met["q_min"])),
                   param_max_change=changed,
                   selected_round0=met["selected"][0].tolist())
        log("scan.controller", **row)
        require(launched == want, f"{policy}: {want} fl_aggregate "
                                  f"launches, got {launched}")
        require(np.isfinite(row["loss_last"]), f"{policy}: finite loss")
        require(q_err <= 1e-5, f"{policy}: q on the simplex in every round")
        require(changed > 0.0 and all(bool(torch.isfinite(p).all())
                                      for p in params.values()),
                f"{policy}: the params changed and are finite")
        rows.append(row)
        results[policy] = (params, met)
        final_queues[policy] = queues
    t_all = time.perf_counter() - t_all
    launches = dict(fk.LAUNCHES)
    lroa = rows[0]["latency_total_s"]
    summary = dict(controllers=len(rows), rounds=rounds, seconds=t_all,
                   peak_mem_bytes=(torch.cuda.max_memory_allocated()
                                   if on_card else None),
                   launches=launches,
                   cudnn_deterministic=torch.backends.cudnn.deterministic,
                   rounds_per_s={r["policy"]: r["rounds_per_s"] for r in rows},
                   latency_total_s={r["policy"]: r["latency_total_s"]
                                    for r in rows},
                   lroa_latency_over={r["policy"]: lroa / r["latency_total_s"]
                                      for r in rows[1:]})
    log("scan", **summary)
    require(launches["fl_aggregate"] == want * len(rows),
            f"{want * len(rows)} fl_aggregate launches in the scan phase")
    # what phase_arena and phase_arena_map reproduce lane by lane (not
    # logged)
    summary.update(h_seq=h_seq, lr_seq=lr_seq, init=init, results=results,
                   queues=final_queues)
    return summary


def _arena_grid(hp, cfg: dict):
    """reference.arena's grid: the seven controllers, LROA with 20%
    dropout and LROA at K - 1 (padded to K), seeds 0..8."""
    from repro_torch.core import POLICIES
    from repro_torch.sim import ScenarioGrid

    k = cfg["sample_count"]
    return ScenarioGrid.create(
        list(POLICIES) + ["lroa", "lroa"], seeds=list(range(9)), V=hp.V,
        lam=hp.lam, sample_count=[k] * 8 + [k - 1],
        dropout=[0.0] * 7 + [0.2, 0.0], num_devices=cfg["num_devices"])


def phase_reference_arena(devices=("cpu", "cuda"), cfg: dict = SMALL,
                          bank_mode: str = "single",
                          k_modes: tuple = ("pad",),
                          label: str = "reference.arena",
                          queue_tol: float = 1e-6) -> None:
    """The scenario arena (``repro_torch.sim.Arena``) on the small testbed
    of :func:`phase_reference`, T = 3, ``eval_every=1``, channels and
    dropout drawn by the port's samplers from the grid's seeds: nine
    lanes (:func:`_arena_grid`).  The card's run against the CPU's (one
    thread): channels and alive masks bitwise, selections exact, params,
    queues, metrics and test columns within 1e-6; T lane-batched
    ``fl_aggregate`` launches on the card, none on the CPU.  Then each
    card lane against its own ``run_scan`` on the card under the arena's
    contract (the generator of its seed, its channels and mask, K_max
    slots): selections exact, the rest within 1e-6.  ``k_modes``: each
    runs (under 'group', one lane launch per distinct K and round).
    ``queue_tol`` bounds the final queues card against CPU: they are the
    control plane's, the very code of ``run_scan`` (each card lane's
    queues are held to its ``run_scan``'s within 1e-6), whose own
    card-against-CPU spread grows with N.  Also run by
    ``tests/test_torch_cuda.py``."""
    for k_mode in k_modes:
        _reference_arena(devices, cfg, bank_mode, k_mode,
                         f"{label}.{k_mode}" if len(k_modes) > 1 else label,
                         queue_tol)


def _reference_arena(devices, cfg: dict, bank_mode: str, k_mode: str,
                     label: str, queue_tol: float) -> None:
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.sim import Arena, EvalBank

    rounds = REFERENCE_SCAN_ROUNDS
    data = make_data(cfg)
    init = None
    runs = {}
    threads = torch.get_num_threads()
    for device in devices:
        torch.set_num_threads(1 if device == "cpu" else threads)
        trainer = build_trainer(device, cfg, data, bank_mode=bank_mode)
        if init is None:
            init = trainer.task.init(torch.Generator().manual_seed(7))
        grid = _arena_grid(trainer.controller.hp, cfg)
        lr_seq = [trainer.lr_schedule(t) for t in range(rounds)]
        params = {name: p.to(device) for name, p in init.items()}
        arena = Arena(trainer.engine, k_mode=k_mode)
        evals = EvalBank(trainer.task, *data["test"], device=device)
        before = fk.LAUNCHES["fl_aggregate_lanes"]
        rep = arena.run(params, trainer.params, trainer.bank, grid, rounds,
                        lr_seq, eval_bank=evals, eval_every=1)
        launched = fk.LAUNCHES["fl_aggregate_lanes"] - before
        want = rounds * rep.meta["dispatches"] if device == "cuda" else 0
        require(launched == want,
                f"{label} {device}: {launched} fl_aggregate_lanes launches "
                f"in {rounds} rounds, want {want}")
        h_all = arena.sample_channels(grid, rounds, cfg["num_devices"])
        drop = arena.sample_dropout(grid, rounds, cfg["num_devices"])
        runs[device] = (rep, h_all.cpu(), drop.cpu(),
                        {n: v.cpu() for n, v in rep.params.items()})
        if device != "cuda":
            continue
        k_max = int(grid.sample_count.max())
        for s in range(len(grid)):
            # under 'group' a lane runs at its own K
            k_lane = k_max if k_mode == "pad" else int(grid.sample_count[s])
            p, q, met = trainer.engine.run_scan(
                params, grid.scenario_system_params(trainer.params, s),
                trainer.bank, h_all[s].cpu().numpy(), lr_seq,
                torch.Generator().manual_seed(int(grid.seed[s])),
                policy=grid.controller_names()[s], V=grid.V[s],
                lam=grid.lam[s], drop_seq=drop[s].cpu().numpy(),
                k_max=k_lane)
            sel_equal = bool(np.array_equal(
                rep.metrics["selected"][s][:, :k_lane], met["selected"])
                and np.all(rep.metrics["selected"][s][:, k_lane:] == -1))
            param_err = max(float((rep.params[n][s] - p[n]).abs().max())
                            for n in p)
            bitwise = all(torch.equal(rep.params[n][s], p[n]) for n in p)
            metric_err = {n: _rel_err(rep.metrics[n][s], met[n])
                          for n in met if n != "selected"}
            queue_err = _rel_err(rep.queues[s], q.cpu().numpy())
            log(f"{label}.lane", lane=s,
                policy=grid.controller_names()[s],
                k=int(grid.sample_count[s]), selections_equal=sel_equal,
                params_bitwise_equal=bitwise, param_max_abs_err=param_err,
                queue_max_rel_err=queue_err, metric_max_rel_err=metric_err,
                tol=1e-6)
            require(sel_equal, f"card lane {s} selects as its run_scan")
            require(param_err <= 1e-6 and queue_err <= 1e-6 and
                    max(metric_err.values()) <= 1e-6,
                    f"card lane {s} agrees with its run_scan within 1e-6")
    torch.set_num_threads(threads)
    cpu, card = devices
    (rc, hc, dc, pc), (rg, hg, dg, pg) = runs[cpu], runs[card]
    sel_equal = bool(np.array_equal(rc.metrics["selected"],
                                    rg.metrics["selected"]))
    param_err = max(float((pc[n] - pg[n]).abs().max()) for n in pc)
    queue_err = _rel_err(rg.queues, rc.queues)
    metric_err = {n: _rel_err(rg.metrics[n], rc.metrics[n])
                  for n in rc.metrics if n != "selected"}
    final_err = {n: _rel_err(rg.final_metrics[n], rc.final_metrics[n])
                 for n in rc.final_metrics}
    log(label, lanes=len(rc.grid), rounds=rounds,
        k_mode=k_mode, bank=type(trainer.bank).__name__,
        queue_tol=queue_tol,
        tiers_hit=sorted({t for lane in rg.metrics["selected"]
                          for row in lane
                          for t in _tiers_hit(trainer.bank, row)}),
        channels_bitwise_equal=bool(torch.equal(hc, hg)),
        dropout_bitwise_equal=bool(torch.equal(dc, dg)),
        selections_equal=sel_equal, param_max_abs_err=param_err,
        queue_max_rel_err=queue_err, metric_max_rel_err=metric_err,
        final_metric_max_rel_err=final_err,
        final_accuracy=rg.final_accuracy().tolist(), tol=1e-6)
    require(torch.equal(hc, hg) and torch.equal(dc, dg),
            "card and CPU draw the same channels and dropout masks")
    require(sel_equal, "arena: card and CPU select the same clients")
    require(param_err <= 1e-6 and queue_err <= queue_tol and
            max(metric_err.values()) <= 1e-6 and
            max(final_err.values()) <= 1e-6,
            f"arena: card and CPU agree within 1e-6 (queues within "
            f"{queue_tol})")


def phase_reference_tiered(devices=("cpu", "cuda")) -> None:
    """``reference.tiered``: the bank layer on the card against the CPU
    on the tiered testbed (:data:`TIERED`, a 3-rung ladder): trainer
    rounds on the fp32 and the int8 ladder, ``run_scan`` under the seven
    controllers and LROA with dropout and padded K, the 9-lane arena in
    'pad' and 'group', then the pool and the hierarchical round
    (:func:`phase_reference_pool`)."""
    from repro_torch.data import assign_tiers

    _, buckets = assign_tiers(TIERED["sizes"], TIERED["batch_size"])
    require(len(buckets) == 3, f"the tiered testbed spans 3 tiers, got "
                               f"{buckets}")
    phase_reference(devices, TIERED, "auto", "fp32", "reference.tiered")
    phase_reference(devices, TIERED, "auto", "int8",
                    "reference.tiered.int8")
    phase_reference_scan(devices, TIERED, "auto", "reference.tiered.scan")
    # at N = 12 the control plane's own card-against-CPU spread in the
    # queues is 1e-6 to 2.2e-6 (reference.tiered, reference.tiered.scan,
    # which hold them to 1e-4): the arena's queues are held to the same
    phase_reference_arena(devices, TIERED, "auto", ("pad", "group"),
                          "reference.tiered.arena", queue_tol=1e-4)
    phase_reference_pool(devices)


def phase_reference_pool(devices=("cpu", "cuda"), cfg: dict = TIERED
                         ) -> None:
    """The rest of the bank layer on the card against the CPU, on the
    tiered testbed, from the same params, selection, coefficients and
    epoch keys: (1) a ``BankPool`` of its 12 clients (one 64-row bucket)
    after 3 evictions and re-admissions in another order: every tensor
    keeps its ``data_ptr()``, one round within 1e-4 of the CPU's, one
    ``fl_aggregate`` launch on the card; (2) a single bucket with 3
    k-means clusters: ``round_step(hierarchical=True)`` within 1e-4 of
    the CPU's, its losses bitwise the flat round's and its params within
    1e-5 of them on each device, no ``fl_aggregate`` launch (the cluster
    reduce is plain ``index_add_``).  Also run by
    ``tests/test_torch_cuda.py``."""
    from repro_torch.fl import BankPool, ClientBank
    from repro_torch.kernels import fl_aggregate as fk

    data = make_data(cfg)
    clients = data["clients"]
    k, epochs = cfg["sample_count"], cfg["local_epochs"]
    rng = np.random.default_rng(3)
    sel = rng.choice(len(clients), k)
    coeffs = rng.dirichlet(np.ones(k)).astype(np.float32)
    rows = max(len(x) for x, _ in clients)
    runs = {}
    for device in devices:
        trainer = build_trainer(device, cfg, data, bank_mode="single")
        engine, layout = trainer.engine, trainer.task.device_layout
        init = {n: p.to(device) for n, p in trainer.task.init(
            torch.Generator().manual_seed(7)).items()}
        pool = BankPool(engine.cfg, capacity=len(clients),
                        initial_clients=dict(enumerate(clients)),
                        device=device, x_layout=layout)
        ptrs = pool.data_ptrs()
        for c in (4, 0, 9):
            pool.evict(c)
        for c in (9, 4, 0):
            pool.admit(c, *clients[c])
        require(pool.data_ptrs() == ptrs,
                f"{device}: the pool's tensors keep their storage across "
                f"churn")
        keys = torch.as_tensor(np.random.default_rng(4).random(
            (k, epochs, pool.bucket_examples), np.float32))
        bank = ClientBank(clients, engine.cfg, device=device,
                          x_layout=layout, clusters=3)
        require(bank.bucket_examples == pool.bucket_examples >= rows,
                "the pool and the bank share one bucket")
        out, launches = {}, {}
        for name, b, s, hier in (("pool", pool, pool.slots_for(sel), False),
                                 ("flat", bank, sel, False),
                                 ("hierarchical", bank, sel, True)):
            before = fk.LAUNCHES["fl_aggregate"]
            p, l = engine.round_step(init, b, s, coeffs, cfg["lr"], keys,
                                     hierarchical=hier)
            launches[name] = fk.LAUNCHES["fl_aggregate"] - before
            out[name] = ({n: v.cpu() for n, v in p.items()}, l.cpu())
        want = 1 if device == "cuda" else 0
        require(launches == dict(pool=want, flat=want, hierarchical=0),
                f"{device}: fl_aggregate launches {launches}")
        (ph, lh), (pf, lf) = out["hierarchical"], out["flat"]
        hier_err = max(float((ph[n] - pf[n]).abs().max()) for n in ph)
        pool_err = max(float((out["pool"][0][n] - pf[n]).abs().max())
                       for n in pf)
        log("reference.pool.device", device=device, launches=launches,
            churn_data_ptrs_equal=True, num_clusters=bank.num_clusters,
            hierarchical_vs_flat_param_max_abs_err=hier_err,
            hierarchical_losses_bitwise_flat=bool(torch.equal(lh, lf)),
            pool_vs_bank_param_max_abs_err=pool_err)
        require(torch.equal(lh, lf) and hier_err <= 1e-5,
                f"{device}: the hierarchical round is the flat round's "
                f"training with eq. (4) reassociated ({hier_err})")
        runs[device] = out
    cpu, card = devices
    for name in runs[cpu]:
        (pc, lc), (pg, lg) = runs[cpu][name], runs[card][name]
        param_err = max(float((pc[n] - pg[n]).abs().max()) for n in pc)
        loss_err = float((lc - lg).abs().max())
        log("reference.pool", round=name, selected=sel.tolist(),
            param_max_abs_err=param_err, loss_max_abs_err=loss_err,
            tol=1e-4)
        require(param_err <= 1e-4 and loss_err <= 1e-4,
                f"{name} round: card and CPU agree within 1e-4")


def phase_arena(trainer, scan: dict, test: tuple, cfg: dict = PAPER_SCALE,
                rounds: int = SCAN_ROUNDS) -> dict:
    """The paper's comparison as the arena runs it at paper scale: one grid
    of the seven controllers (seed 0, the main path's V and lam), T
    rounds over the ``scan`` phase's channel sequence broadcast to every
    lane, the same learning rates and initial params, on the main path's
    engine and bank.  Under the arena's contract lane s reproduces the
    ``scan`` phase's rollout s.  Both run with cuDNN's deterministic
    algorithms (:func:`cudnn_deterministic`; the card then repeats a
    rollout bit for bit), yet the S·K = 56 client SGD convolves through
    other cuDNN kernels than the scan's K = 8: the two differ by an ulp
    after one SGD step, and training at the paper's learning rate
    amplifies that to 1e-4 after a round and 1e-2 after four.  So the
    data plane is held tight over one round (:func:`phase_arena_round`),
    and the four-round lanes to fixed bounds set from the card's
    readings: selections equal, params within :data:`ARENA_PARAM_TOL`,
    losses within :data:`ARENA_LOSS_TOL` relative, modelled latency sums
    within 1e-6 relative, and every lane's distance to its scan rollout
    at most 1/:data:`ARENA_SEPARATION` of the distance from that rollout
    to the nearest other controller's.  One lane-batched
    ``fl_aggregate`` launch per round, finite changed params; the final
    ``[7, ...]`` params evaluated by an ``EvalBank`` over the test set
    (in calls of ``lanes_per_call`` lanes; the one-shot call beside it,
    with both peaks).  For what deterministic mode costs, the grid is run
    again with cuDNN's default algorithms, then with the deterministic
    ones, and Uni-D's ``run_scan`` with the default ones.  Logs rounds/s
    over all lanes, each lane's ``decide`` share (``scan.decide`` spans
    by lane), the final accuracies and the
    peak memory."""
    from repro_torch.core import POLICIES
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.obs import trace
    from repro_torch.sim import Arena, EvalBank, ScenarioGrid

    dev = trainer.device
    on_card = dev.type == "cuda"
    hp = trainer.controller.hp
    engine, bank, sp = trainer.engine, trainer.bank, trainer.params
    grid = ScenarioGrid.create(list(POLICIES), seeds=cfg["seed"], V=hp.V,
                               lam=hp.lam, sample_count=cfg["sample_count"],
                               num_devices=cfg["num_devices"])
    s_count = len(grid)
    h_all = np.broadcast_to(scan["h_seq"], (s_count,) + scan["h_seq"].shape)
    evals = EvalBank(trainer.task, *test, device=dev)
    arena = Arena(trainer.engine)

    def run():
        trainer._sync()
        t0 = time.perf_counter()
        rep = arena.run(scan["init"], sp, bank, grid, rounds, scan["lr_seq"],
                        h_all=h_all)
        trainer._sync()
        return rep, time.perf_counter() - t0

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else None

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    with cudnn_deterministic(), \
            trace.installed(trace.MemorySink(capacity=65536)) as sink:
        rep, seconds = run()
    launches = dict(fk.LAUNCHES)
    run_peak = peak()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = arena._final_eval(evals, rep.params)
    trainer._sync()
    eval_s = time.perf_counter() - t0
    eval_peak = peak()
    one_shot = EvalBank(trainer.task, *test, device=dev,
                        lanes_per_call=s_count)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    whole = one_shot.metrics_stacked(rep.params)
    one_shot_peak = peak()
    del one_shot
    meta = {k: rep.meta[k] for k in ("k_mode", "k_max", "dispatches", "plan")}
    decide_s = [sum(r["dur"] for r in sink.by_name("scan.decide")
                    if r["attrs"]["lane"] == s) for s in range(s_count)]
    rows = []
    for s, policy in enumerate(grid.controller_names()):
        ref_params, ref_met = scan["results"][policy]
        param_err, nearest_other = _lane_vs_scan(rep, s, policy,
                                                 scan["results"])
        loss_rel = _rel_err(rep.metrics["loss"][s], ref_met["loss"])
        latency = float(np.sum(rep.metrics["wall_time"][s]))
        latency_ref = float(np.sum(ref_met["wall_time"]))
        latency_rel = abs(latency - latency_ref) / abs(latency_ref)
        sel_equal = bool(np.array_equal(rep.metrics["selected"][s],
                                        ref_met["selected"]))
        changed = max(float((rep.params[n][s] - scan["init"][n]).abs().max())
                      for n in ref_params)
        row = dict(lane=s, policy=policy, selections_equal=sel_equal,
                   param_max_abs_err_vs_scan=param_err,
                   nearest_other_scan_max_abs_diff=nearest_other,
                   loss_max_rel_err_vs_scan=loss_rel,
                   latency_total_s=latency,
                   latency_rel_err_vs_scan=latency_rel,
                   decide_s=decide_s[s], decide_share=decide_s[s] / seconds,
                   final_accuracy=float(final["test_accuracy"][s]),
                   final_loss=float(final["test_loss"][s]),
                   param_max_change=changed)
        log("arena.lane", **row)
        require(sel_equal, f"arena lane {policy} selects as the scan phase")
        require(param_err <= ARENA_PARAM_TOL and loss_rel <= ARENA_LOSS_TOL,
                f"arena lane {policy}: params within {ARENA_PARAM_TOL} and "
                f"losses within {ARENA_LOSS_TOL} relative of the scan phase "
                f"({param_err}, {loss_rel})")
        require(param_err * ARENA_SEPARATION <= nearest_other,
                f"arena lane {policy}: within 1/{ARENA_SEPARATION} of the "
                f"distance to the nearest other scan rollout ({param_err}, "
                f"{nearest_other})")
        require(latency_rel <= 1e-6, f"arena lane {policy}: modelled latency "
                                     f"within 1e-6 of the scan phase")
        require(changed > 0.0 and all(bool(torch.isfinite(rep.params[n][s])
                                           .all()) for n in ref_params),
                f"arena lane {policy}: the params changed and are finite")
        rows.append(row)
    eval_bitwise = all(torch.equal(whole[n].cpu(),
                                   torch.as_tensor(final[f"test_{n}"]))
                       for n in whole)
    eval_err = max(float(np.max(np.abs(whole[n].cpu().numpy()
                                       - final[f"test_{n}"])))
                   for n in whole)
    del rep, whole
    # what cuDNN's deterministic algorithms cost, both timed warm: the
    # grid with the default algorithms, then with the deterministic ones
    # again; and Uni-D's scan rollout with the default ones beside the
    # scan phase's (deterministic, after LROA's)
    seconds_default = run()[1]
    with cudnn_deterministic():
        seconds_again = run()[1]
    trainer._sync()
    t0 = time.perf_counter()
    engine.run_scan(scan["init"], sp, bank, scan["h_seq"], scan["lr_seq"],
                    torch.Generator().manual_seed(cfg["seed"]),
                    policy="uni_d", V=hp.V, lam=hp.lam)
    trainer._sync()
    scan_default_s = time.perf_counter() - t0
    want = rounds if on_card else 0
    summary = dict(lanes=s_count, rounds=rounds, seconds=seconds,
                   lane_rounds_per_s=s_count * rounds / seconds,
                   cudnn_deterministic=True,
                   lane_rounds_per_s_cudnn_default=(s_count * rounds
                                                    / seconds_default),
                   lane_rounds_per_s_again=s_count * rounds / seconds_again,
                   scan_uni_d_rounds_per_s=scan["rounds_per_s"]["uni_d"],
                   scan_uni_d_rounds_per_s_cudnn_default=(rounds
                                                          / scan_default_s),
                   decide_share_total=sum(decide_s) / seconds,
                   param_tol=ARENA_PARAM_TOL, loss_tol=ARENA_LOSS_TOL,
                   separation=ARENA_SEPARATION,
                   eval_s=eval_s, eval_examples=evals.num_examples,
                   eval_lanes_per_call=evals.lanes_per_call,
                   eval_one_shot_bitwise_equal=eval_bitwise,
                   eval_one_shot_max_abs_err=eval_err,
                   final_accuracy=[r["final_accuracy"] for r in rows],
                   peak_mem_bytes=run_peak, eval_peak_mem_bytes=eval_peak,
                   eval_one_shot_peak_mem_bytes=one_shot_peak,
                   launches=launches, meta=meta)
    log("arena", **summary)
    require(launches["fl_aggregate_lanes"] == want,
            f"{want} fl_aggregate_lanes launches in the arena phase, got "
            f"{launches['fl_aggregate_lanes']}")
    require(launches["fl_aggregate"] == 0,
            "the arena's rounds launch only the lane kernel")
    require(bool(np.all(np.isfinite(final["test_accuracy"]))),
            "finite final accuracies")
    phase_arena_round(trainer, scan, cfg)
    return summary


def _lane_vs_scan(rep, s: int, policy: str, results: dict) -> tuple:
    """(lane s's max abs param distance from ``policy``'s scan rollout,
    the distance from that rollout to the nearest other controller's).
    Rollouts that ended exactly on it, as Uni-D's and Uni-S's do when
    they pick the same clients with the same weights, cannot be told
    apart and are left out of the second."""
    own = results[policy][0]
    err = max(float((rep.params[n][s] - own[n]).abs().max()) for n in own)
    apart = [max(float((p[n] - own[n]).abs().max()) for n in own)
             for o, (p, _) in results.items() if o != policy]
    return err, min([d for d in apart if d > 0.0] or [np.inf])


def phase_arena_round(trainer, scan: dict, cfg: dict = PAPER_SCALE,
                      label: str = "arena") -> None:
    """The arena's data plane held tight at paper scale, over one round
    with cuDNN's deterministic algorithms: the seven controllers'
    one-round ``run_scan`` rollouts against (1) a one-lane LROA arena,
    bitwise (``arena.bitwise``: the lane path itself adds no rounding),
    and (2) the seven-lane arena (``arena.round.lane``): selections
    equal, params within :data:`ROUND_PARAM_TOL`, losses within
    :data:`ROUND_LOSS_TOL` relative, and every lane's distance from its
    rollout at most 1/:data:`ROUND_SEPARATION` of the distance from that
    rollout to the nearest other controller's.  The 56-client SGD
    convolves through other cuDNN kernels than the 8-client one, which
    is what (2) leaves room for; a lane that trained on another lane's
    rows or took its coefficients would be a round's change away.  Each
    rollout launches ``fl_aggregate`` once and each arena
    ``fl_aggregate_lanes`` once.  ``label`` 'arena.tiered' runs it on the
    main path's tier ladder (the same channels, rates and params; the
    tiers each lane's round hit are logged)."""
    from repro_torch.core import POLICIES
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.sim import Arena, ScenarioGrid

    engine, bank, sp = trainer.engine, trainer.bank, trainer.params
    hp = trainer.controller.hp
    h, lr = scan["h_seq"][:1], scan["lr_seq"][:1]
    grid = ScenarioGrid.create(list(POLICIES), seeds=cfg["seed"], V=hp.V,
                               lam=hp.lam, sample_count=cfg["sample_count"],
                               num_devices=cfg["num_devices"])
    on_card = trainer.device.type == "cuda"
    _reset_launch_counts()
    with cudnn_deterministic():
        results = {policy: engine.run_scan(
            scan["init"], sp, bank, h, lr,
            torch.Generator().manual_seed(cfg["seed"]), policy=policy,
            V=hp.V, lam=hp.lam)[::2] for policy in POLICIES}
        one = Arena(engine).run(scan["init"], sp, bank, grid.take([0]), 1,
                                lr, h_all=h[None])
        rep = Arena(engine).run(scan["init"], sp, bank, grid, 1, lr,
                                h_all=np.broadcast_to(h, (len(grid),)
                                                      + h.shape))
        trainer._sync()
    launches = {name: fk.LAUNCHES[name]
                for name in ("fl_aggregate", "fl_aggregate_lanes")}
    want = (dict(fl_aggregate=len(POLICIES), fl_aggregate_lanes=2)
            if on_card else dict(fl_aggregate=0, fl_aggregate_lanes=0))
    log(f"{label}.round", bank=type(bank).__name__, launches=launches,
        tiers_hit=[_tiers_hit(bank, rep.metrics["selected"][s][0])
                   for s in range(len(grid))])
    require(launches == want, f"{label}: launches {launches}, want {want} "
                              f"(one per rollout round, one per arena "
                              f"round)")
    p_scan, m_scan = results["lroa"]
    params_equal = all(torch.equal(one.params[n][0], p_scan[n])
                       for n in p_scan)
    metrics_equal = all(np.array_equal(one.metrics[n][0], m_scan[n])
                        for n in m_scan)
    err = max(float((one.params[n][0] - p_scan[n]).abs().max())
              for n in p_scan)
    log(f"{label}.bitwise", lanes=1, rounds=1, cudnn_deterministic=True,
        params_bitwise_equal=params_equal,
        metrics_bitwise_equal=metrics_equal, param_max_abs_err=err)
    require(params_equal and metrics_equal,
            "a one-lane arena round is bitwise run_scan's round (cuDNN "
            "deterministic)")
    for s, policy in enumerate(grid.controller_names()):
        ref_met = results[policy][1]
        param_err, nearest = _lane_vs_scan(rep, s, policy, results)
        loss_rel = _rel_err(rep.metrics["loss"][s], ref_met["loss"])
        sel_equal = bool(np.array_equal(rep.metrics["selected"][s],
                                        ref_met["selected"]))
        changed = max(float((results[policy][0][n] - scan["init"][n])
                            .abs().max()) for n in scan["init"])
        log(f"{label}.round.lane", lane=s, policy=policy, rounds=1,
            cudnn_deterministic=True, selections_equal=sel_equal,
            param_max_abs_err_vs_scan=param_err,
            nearest_other_scan_max_abs_diff=nearest,
            loss_max_rel_err_vs_scan=loss_rel, param_max_change=changed,
            param_tol=ROUND_PARAM_TOL, loss_tol=ROUND_LOSS_TOL,
            separation=ROUND_SEPARATION)
        require(sel_equal, f"arena round lane {policy}: selections equal")
        require(param_err <= ROUND_PARAM_TOL and loss_rel <= ROUND_LOSS_TOL,
                f"arena round lane {policy}: params within "
                f"{ROUND_PARAM_TOL} and losses within {ROUND_LOSS_TOL} "
                f"relative of its one-round scan ({param_err}, {loss_rel})")
        require(param_err * ROUND_SEPARATION <= nearest,
                f"arena round lane {policy}: within 1/{ROUND_SEPARATION} "
                f"of the distance to the nearest other one-round scan "
                f"({param_err}, {nearest})")


# -- the streaming sweep layer: chunked, checkpointed arena runs behind the
# -- SweepService, k_mode='auto', batch='map'


class _Kill(Exception):
    """A sweep's simulated death, raised by a wrapped ``store.save``."""


def _instrument_store(store, rows: list, kill: bool = False) -> dict:
    """Wrap ``store.save`` / ``store.load`` to log each save's and each
    hit's seconds and file bytes into ``rows``; with ``kill``, the first
    save then raises :class:`_Kill`.  Returns the tally of kills."""
    save, load, fired = store.save, store.load, {"kills": 0}

    def nbytes(tag):
        return sum(os.path.getsize(os.path.join(
            store.directory, f"{tag}_{part}.npz"))
            for part in ("carry", "metrics"))

    def timed_save(tag, t_next, carry, metrics):
        t0 = time.perf_counter()
        save(tag, t_next, carry, metrics)
        rows.append(dict(op="save", tag=tag, t=int(t_next),
                         seconds=time.perf_counter() - t0,
                         bytes=nbytes(tag)))
        if kill:
            fired["kills"] += 1
            raise _Kill()

    def timed_load(tag):
        t0 = time.perf_counter()
        hit = load(tag)
        if hit is not None:
            rows.append(dict(op="load", tag=tag, t=int(hit[0]),
                             seconds=time.perf_counter() - t0,
                             bytes=nbytes(tag)))
        return hit

    store.save, store.load = timed_save, timed_load
    return fired


def _sweep(engine, params, sp, bank, subs, lr_seq, ckdir, rows,
           kill: bool = False, cost_model=None, **service_kw):
    """Submit the grids ``subs`` to a fresh ``SweepService`` over a fresh
    ``Arena(engine, k_mode='auto', chunk_size=SWEEP_CHUNK,
    cost_model=cost_model)`` checkpointing into ``ckdir``, and drain it.
    Returns ``(reports, service, kills)``; with ``kill`` the store dies at
    its first save, which must fire once (reports None)."""
    from repro_torch.sim import Arena, SweepService

    arena = Arena(engine, k_mode="auto", chunk_size=SWEEP_CHUNK,
                  cost_model=cost_model)
    svc = SweepService(arena, params, sp, bank, checkpoint_dir=ckdir,
                       **service_kw)
    fired = _instrument_store(svc.store, rows, kill)
    tickets = [svc.submit(grid, len(lr_seq), lr_seq) for grid in subs]
    if kill:
        try:
            svc.run_pending()
        except _Kill:
            pass
        require(fired["kills"] == 1, f"the sweep was killed once, "
                                     f"{fired['kills']} times")
        return None, svc, fired["kills"]
    done = svc.run_pending()
    require(done == tickets, f"the service completed {done}, want "
                             f"{tickets}")
    require(svc.stats["coalesced_lanes"] == [sum(len(g) for g in subs)],
            f"the submissions ran as one coalesced batch: "
            f"{svc.stats['coalesced_lanes']}")
    return [svc.result(t) for t in tickets], svc, 0


def _reports_bitwise(a, b) -> bool:
    """Params, queues, every metric column and the final evaluation of
    two reports, bit for bit."""
    return (all(torch.equal(a.params[n], b.params[n]) for n in a.params)
            and np.array_equal(a.queues, b.queues)
            and sorted(a.metrics) == sorted(b.metrics)
            and all(np.array_equal(a.metrics[n], b.metrics[n])
                    for n in a.metrics)
            and sorted(a.final_metrics) == sorted(b.final_metrics)
            and all(np.array_equal(a.final_metrics[n], b.final_metrics[n])
                    for n in a.final_metrics))


def _sweep_kill_resume(engine, params, sp, bank, subs, lr_seq, root: str,
                       label: str, other_lr: bool = False,
                       **service_kw) -> dict:
    """The uninterrupted sweep, the killed one, with ``other_lr`` a
    resubmission under another learning-rate schedule into the killed
    one's directory (which must find no checkpoint: the tag covers the
    schedule), and the resume (which must load exactly one), each run's
    launches read with the counts set to 0 before it.  The resumed
    reports must be bitwise the uninterrupted ones."""
    from repro_torch.kernels import fl_aggregate as fk

    rows, out = [], {}
    killdir = os.path.join(root, "killed")

    def timed(fn):
        _reset_launch_counts()
        _sync(bank)
        t0 = time.perf_counter()
        res = fn()
        _sync(bank)
        return res, time.perf_counter() - t0, {
            k: fk.LAUNCHES[k] for k in ("fl_aggregate",
                                        "fl_aggregate_lanes")}

    (whole, svc_w, _), out["seconds"], out["launches_whole"] = timed(
        lambda: _sweep(engine, params, sp, bank, subs, lr_seq,
                       os.path.join(root, "whole"), rows, **service_kw))
    (_, svc_k, _), out["kill_seconds"], out["launches_killed"] = timed(
        lambda: _sweep(engine, params, sp, bank, subs, lr_seq, killdir,
                       rows, kill=True, **service_kw))
    require(len(os.listdir(killdir)) == 4,
            f"{label}: the killed sweep left one checkpoint pair")
    if other_lr:
        other = [0.5 * lr for lr in lr_seq]
        (_, svc_o, _), _, _ = timed(
            lambda: _sweep(engine, params, sp, bank, subs, other, killdir,
                           rows, **service_kw))
        out["other_lr_loads"] = svc_o.store.loads
        require(svc_o.store.loads == 0,
                f"{label}: another lr schedule finds no checkpoint")
    (resumed, svc_r, _), out["resume_seconds"], out["launches_resumed"] = \
        timed(lambda: _sweep(engine, params, sp, bank, subs, lr_seq,
                             killdir, rows, **service_kw))
    require(svc_r.store.loads == 1 and os.listdir(killdir) == [],
            f"{label}: the resume loaded the checkpoint once and finished it")
    plan = whole[0].meta["plan"]
    out.update(
        whole=whole, resumed=resumed, plan=plan, store_rows=rows,
        bank_digest_s=[v for svc in (svc_w, svc_k, svc_r) for v in
                       svc.metrics.histogram("arena.bank_digest_s").values],
        saves=[svc.store.saves for svc in (svc_w, svc_k, svc_r)],
        loads=[svc.store.loads for svc in (svc_w, svc_k, svc_r)],
        dispatches=[r.meta["dispatches"] for r in whole],
        resume_dispatches=[r.meta["dispatches"] for r in resumed],
        bitwise=all(_reports_bitwise(a, b)
                    for a, b in zip(whole, resumed)))
    return out


def _sync(bank) -> None:
    if bank.device.type == "cuda":
        torch.cuda.synchronize()


def _require_sweep_launches(out: dict, rounds: int, on_card: bool,
                            label: str) -> None:
    """One lane launch per bucket round: T per bucket uninterrupted, the
    first chunk of the first bucket when killed, the rest on resume."""
    buckets = len(out["plan"])
    want = {"launches_whole": rounds * buckets,
            "launches_killed": SWEEP_CHUNK,
            "launches_resumed": rounds * buckets - SWEEP_CHUNK}
    for key, n in want.items():
        got = out[key]
        require(got == dict(fl_aggregate=0,
                            fl_aggregate_lanes=n if on_card else 0),
                f"{label}: {key} {got}, want {n} fl_aggregate_lanes")


def phase_reference_sweep(devices=("cpu", "cuda")) -> None:
    """``reference.sweep``: the sweep layer on the card against the CPU,
    on the tiered testbed (:data:`TIERED`).  A ``SweepService`` over
    ``Arena(engine, k_mode='auto', chunk_size=2)`` with in-rollout
    evaluation every 2 rounds, T = 6, priced as the JAX package prices
    but with no compile (the default prices plan one bucket; this plan
    splits the lanes by K, so the stitching and each bucket's own
    checkpoint run on the card too): submission 1, the seven
    controllers at K = 4; submission 2, LROA and Uni-D at K = 2 and at
    K = 6 with 10% dropout; the two coalesced into one batch.  On each
    device: killed after its first save, a resubmission under another lr
    schedule finds no checkpoint, and the resume is bitwise the
    uninterrupted run (the card's runs with cuDNN's deterministic
    algorithms).  Card against CPU (one thread): plans and selections
    equal, params, metrics and test columns within 1e-6, queues within
    1e-4 (the control plane's spread at N = 12, as ``reference.tiered``),
    the same store saves and loads; one lane launch per bucket round on
    the card.  Also run by ``tests/test_torch_cuda.py``."""
    from repro_torch.core import POLICIES
    from repro_torch.sim import CostModel, EvalBank, ScenarioGrid

    cfg, rounds = TIERED, SWEEP_ROUNDS
    n = cfg["num_devices"]
    data = make_data(cfg)
    init, runs = None, {}
    threads = torch.get_num_threads()
    for device in devices:
        torch.set_num_threads(1 if device == "cpu" else threads)
        trainer = build_trainer(device, cfg, data)
        if init is None:
            init = trainer.task.init(torch.Generator().manual_seed(7))
        hp = trainer.controller.hp
        subs = [ScenarioGrid.create(list(POLICIES), seeds=list(range(7)),
                                    V=hp.V, lam=hp.lam, sample_count=4,
                                    num_devices=n),
                ScenarioGrid.create(["lroa", "uni_d"] * 2,
                                    seeds=[7, 8, 9, 10], V=hp.V, lam=hp.lam,
                                    sample_count=[2, 2, 6, 6], dropout=0.1,
                                    num_devices=n)]
        lr_seq = [trainer.lr_schedule(t) for t in range(rounds)]
        evals = EvalBank(trainer.task, *data["test"], device=device)
        with cudnn_deterministic(device == "cuda"), \
                tempfile.TemporaryDirectory() as root:
            out = _sweep_kill_resume(
                trainer.engine, {k: p.to(device) for k, p in init.items()},
                trainer.params, trainer.bank, subs, lr_seq, root,
                "reference.sweep", eval_bank=evals, eval_every=2,
                other_lr=True, cost_model=CostModel(compile_cost=0.0))
        log("reference.sweep.resume", device=device, rounds=rounds,
            lanes=[len(g) for g in subs], plan=out["plan"],
            dispatches=out["dispatches"],
            resume_dispatches=out["resume_dispatches"],
            saves=out["saves"], loads=out["loads"],
            other_lr_loads=out["other_lr_loads"],
            resumed_bitwise_equal=out["bitwise"],
            launches=[out[k] for k in ("launches_whole", "launches_killed",
                                       "launches_resumed")])
        require(out["bitwise"], f"reference.sweep {device}: the resumed "
                                f"sweep is bitwise the uninterrupted one")
        _require_sweep_launches(out, rounds, device == "cuda",
                                f"reference.sweep {device}")
        runs[device] = out
    torch.set_num_threads(threads)
    cpu, card = (runs[d] for d in devices)
    errs = dict(param=0.0, metric=0.0, test=0.0, final=0.0, queue=0.0)
    sel_equal = True
    for rc, rg in zip(cpu["whole"], card["whole"]):
        sel_equal &= bool(np.array_equal(rc.metrics["selected"],
                                         rg.metrics["selected"]))
        errs["param"] = max(errs["param"], max(
            float((rc.params[k] - rg.params[k].cpu()).abs().max())
            for k in rc.params))
        for k in rc.metrics:
            if k != "selected":
                key = "test" if k.startswith("test_") else "metric"
                errs[key] = max(errs[key], _rel_err(rg.metrics[k],
                                                    rc.metrics[k]))
        errs["final"] = max([errs["final"]] + [
            _rel_err(rg.final_metrics[k], rc.final_metrics[k])
            for k in rc.final_metrics])
        errs["queue"] = max(errs["queue"], _rel_err(rg.queues, rc.queues))
    same_store = (cpu["saves"], cpu["loads"]) == (card["saves"],
                                                  card["loads"])
    log("reference.sweep", lanes=sum(len(r.grid) for r in card["whole"]),
        rounds=rounds, plan=card["plan"], plans_equal=cpu["plan"] ==
        card["plan"], selections_equal=sel_equal,
        **{f"{k}_max_err": v for k, v in errs.items()},
        store_counts_equal=same_store, tol=1e-6, queue_tol=1e-4)
    require(cpu["plan"] == card["plan"], "reference.sweep: the same plan")
    require(sel_equal, "reference.sweep: card and CPU select the same "
                       "clients")
    require(max(errs["param"], errs["metric"], errs["test"],
                errs["final"]) <= 1e-6 and errs["queue"] <= 1e-4,
            f"reference.sweep: card and CPU within 1e-6 (queues 1e-4): "
            f"{errs}")
    require(same_store, "reference.sweep: the same store saves and loads")


def phase_sweep(trainer, cfg: dict = PAPER_SCALE,
                rounds: int = SWEEP_ROUNDS) -> dict:
    """``sweep``: the sweep layer at paper scale on the trainer's default
    bank (the 4-rung ladder of ``main``), cuDNN deterministic: a
    ``SweepService`` over ``Arena(engine, k_mode='auto', chunk_size=2)``,
    submission 1 the seven controllers at K = 8 and submission 2 LROA at
    K / 2 = 4 and 3K / 2 = 12 (seed 0, nine lanes coalesced), T = 6, the
    channels drawn from the grid seeds and the ``scan`` phase's lr
    schedule.  Killed after its first save and resumed: bitwise the
    uninterrupted run.  The same grid under ``k_mode='pad'``: the same
    selections and modelled latency sums; its seconds (unchunked, no
    store) beside those of the grid split by K (the JAX package's prices
    without compile).  One lane launch per bucket round.  Logs the plan, lane-rounds/s, each save's and load's
    seconds and bytes, the resume's seconds, peak memory, and
    ``CostModel.calibrate`` on this engine with the plan it gives beside
    the default's."""
    from repro_torch.core import POLICIES
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.sim import Arena, CostModel, ScenarioGrid

    engine, bank, sp = trainer.engine, trainer.bank, trainer.params
    dev = trainer.device
    on_card = dev.type == "cuda"
    hp = trainer.controller.hp
    n, k = cfg["num_devices"], cfg["sample_count"]
    lr_seq = [trainer.lr_schedule(t) for t in range(rounds)]
    init = trainer.task.init(torch.Generator(device=dev).manual_seed(
        cfg["seed"] + 1))
    grids = [ScenarioGrid.create(list(POLICIES), seeds=cfg["seed"], V=hp.V,
                                 lam=hp.lam, sample_count=cfg["sample_count"],
                                 num_devices=n),
             ScenarioGrid.create(["lroa", "lroa"], seeds=cfg["seed"],
                                 V=hp.V, lam=hp.lam,
                                 sample_count=[k // 2, k + k // 2],
                                 num_devices=n)]
    lanes = sum(len(g) for g in grids)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with cudnn_deterministic(), tempfile.TemporaryDirectory() as root:
        out = _sweep_kill_resume(engine, init, sp, bank, grids, lr_seq,
                                 root, "sweep")
        peak = torch.cuda.max_memory_allocated() if on_card else None
        grid = ScenarioGrid.concat(grids)
        timed_runs = {}
        for label, arena in (
                ("pad", Arena(engine, k_mode="pad")),
                ("split", Arena(engine, k_mode="auto",
                                cost_model=CostModel(compile_cost=0.0)))):
            _reset_launch_counts()
            _sync(bank)
            t0 = time.perf_counter()
            rep = arena.run(init, sp, bank, grid, rounds, lr_seq)
            _sync(bank)
            timed_runs[label] = (rep, time.perf_counter() - t0,
                                 fk.LAUNCHES["fl_aggregate_lanes"])
    (pad, pad_seconds, pad_launches), (split, split_seconds,
                                       split_launches) = timed_runs.values()
    whole = out["whole"]
    selected = np.concatenate([r.metrics["selected"] for r in whole])
    latency = np.concatenate([r.metrics["wall_time"] for r in whole]
                             ).sum(axis=1)
    latency_pad = pad.metrics["wall_time"].sum(axis=1)
    latency_rel = float(np.max(np.abs(latency - latency_pad)
                               / np.abs(latency_pad)))
    for row in out["store_rows"]:
        log("sweep.store", **row)
    cal = CostModel.calibrate(engine, sp, bank)
    cal_plan = Arena(engine, k_mode="auto", cost_model=cal)._plan(
        bank, grid, rounds).describe()
    launches = {k: out["launches_whole"][k] + out["launches_killed"][k]
                + out["launches_resumed"][k] for k in out["launches_whole"]}
    launches["fl_aggregate_lanes"] += pad_launches + split_launches
    summary = dict(
        lanes=lanes, rounds=rounds, chunk=SWEEP_CHUNK, plan=out["plan"],
        buckets=len(out["plan"]), bank_digest_s=out["bank_digest_s"],
        seconds=out["seconds"],
        lane_rounds_per_s=lanes * rounds / out["seconds"],
        pad_seconds=pad_seconds,
        pad_lane_rounds_per_s=lanes * rounds / pad_seconds,
        split_plan=split.meta["plan"], split_seconds=split_seconds,
        split_lane_rounds_per_s=lanes * rounds / split_seconds,
        split_selections_equal=bool(np.array_equal(
            split.metrics["selected"], pad.metrics["selected"])),
        kill_seconds=out["kill_seconds"],
        resume_seconds=out["resume_seconds"],
        dispatches=out["dispatches"],
        resume_dispatches=out["resume_dispatches"], saves=out["saves"],
        loads=out["loads"], resumed_bitwise_equal=out["bitwise"],
        pad_selections_equal=bool(np.array_equal(
            selected, pad.metrics["selected"])),
        pad_latency_bitwise_equal=bool(np.array_equal(latency,
                                                      latency_pad)),
        pad_latency_max_rel_err=latency_rel,
        latency_total_s=latency.tolist(), peak_mem_bytes=peak,
        calibrated=dict(unit_cost=cal.unit_cost,
                        compile_cost=cal.compile_cost,
                        dispatch_cost=cal.dispatch_cost,
                        round_cost=cal.round_cost),
        calibrated_plan=cal_plan, cudnn_deterministic=True,
        launches=launches, launches_by_run={
            k: out[k] for k in ("launches_whole", "launches_killed",
                                "launches_resumed")},
        pad_launches=pad_launches, split_launches=split_launches)
    log("sweep", **summary)
    require(out["bitwise"], "sweep: the resumed sweep is bitwise the "
                            "uninterrupted one")
    _require_sweep_launches(out, rounds, on_card, "sweep")
    require(pad_launches == (rounds if on_card else 0),
            f"sweep: the padded run launched {pad_launches} lane kernels")
    require(split_launches == (rounds * len(split.meta["plan"]) if on_card
                               else 0),
            f"sweep: the split run launched {split_launches} lane kernels")
    require(summary["pad_selections_equal"]
            and summary["split_selections_equal"],
            "sweep: auto (default and split prices) selects as the padded "
            "plan")
    require(latency_rel <= 1e-6, f"sweep: auto's modelled latency sums "
                                 f"within 1e-6 of pad's ({latency_rel})")
    require(all(bool(torch.isfinite(v).all()) for r in whole
                for v in r.params.values()), "sweep: finite params")
    return summary


# warmup.*: the scenario layer's warmup under a strict retrace watchdog,
# on the paper-scale ladder (3 lanes, 2 rounds; chunks of one round, so
# each round's seconds are a chunk's dispatch span)
WARMUP_CONTROLLERS = ("lroa", "uni_d", "round_robin")
WARMUP_ROUNDS = 2
WARMUP_SWEEP_ROUNDS = 3


def _warm_grid(hp, cfg: dict, seed: int, scale: float = 1.0,
               k: int = None):
    from repro_torch.sim import ScenarioGrid

    return ScenarioGrid.create(
        list(WARMUP_CONTROLLERS), seeds=seed, V=hp.V * scale,
        lam=hp.lam * scale,
        sample_count=cfg["sample_count"] if k is None else k,
        num_devices=cfg["num_devices"])


def _timed_run(arena, init, sp, bank, grid, rounds: int, lr_seq) -> tuple:
    """``(report, seconds, each round's seconds)`` of one chunked run
    (one round a chunk: the rounds' ``arena.dispatch`` spans)."""
    from repro_torch.obs import trace

    with trace.installed(trace.MemorySink(capacity=65536)) as sink:
        _sync(bank)
        t0 = time.perf_counter()
        rep = arena.run(init, sp, bank, grid, rounds, lr_seq, chunk_size=1)
        _sync(bank)
        seconds = time.perf_counter() - t0
    spans = sorted(sink.by_name("arena.dispatch"),
                   key=lambda r: r["attrs"]["chunk"])
    return rep, seconds, [r["dur"] for r in spans]


def _reports_within(a, b) -> dict:
    """The batched-lane bounds of the ``arena`` phases, between two arena
    reports of one grid: selections equal, latency sums within 1e-6
    relative, params within :data:`ARENA_PARAM_TOL`, losses within
    :data:`ARENA_LOSS_TOL` relative."""
    sel = bool(np.array_equal(a.metrics["selected"], b.metrics["selected"]))
    lat_a = a.metrics["wall_time"].sum(axis=1)
    lat_b = b.metrics["wall_time"].sum(axis=1)
    lat = float(np.max(np.abs(lat_a - lat_b) / np.abs(lat_b)))
    param = max(float((a.params[n].float() - b.params[n].float()).abs()
                      .max()) for n in a.params)
    loss = _rel_err(a.metrics["loss"], b.metrics["loss"])
    return dict(selections_equal=sel, latency_max_rel_err=lat,
                param_max_abs_err=param, loss_max_rel_err=loss,
                bitwise=_reports_bitwise(a, b),
                ok=sel and lat <= 1e-6 and param <= ARENA_PARAM_TOL
                and loss <= ARENA_LOSS_TOL)


def phase_warmup_arena(trainer, cfg: dict = PAPER_SCALE,
                       rounds: int = WARMUP_ROUNDS) -> dict:
    """``warmup.arena``: ``Arena.warmup`` on the main path's engine and
    4-rung ladder (:data:`WARMUP_CONTROLLERS`, K = 8, T = 2, cuDNN
    deterministic), with a strict ``obs.Watchdog`` attached.  A fresh
    arena's run of a grid (cold), then the warmed arena's runs of that
    grid and of another (other V, lam and seeds): zero violations and
    zero kernel libraries loaded after warmup; the warmed run of the cold
    grid within the ``arena`` phases' bounds of the cold run
    (:func:`_reports_within`); a grid at K + 4 raises ``RetraceError``.
    Logs warmup's seconds and result, and the first round's seconds warm
    against cold (a fresh arena in this process: every kernel is built
    and cuDNN has run these shapes in the phases before, so "cold" is
    the arena's first run of the signature).  One lane launch per round
    of every run and of warmup's rounds."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.obs import RetraceError, Watchdog
    from repro_torch.sim import Arena

    engine, bank, sp = trainer.engine, trainer.bank, trainer.params
    dev = trainer.device
    on_card = dev.type == "cuda"
    hp = trainer.controller.hp
    lr_seq = [trainer.lr_schedule(t) for t in range(rounds)]
    init = trainer.task.init(torch.Generator(device=dev).manual_seed(
        cfg["seed"] + 1))
    grids = [_warm_grid(hp, cfg, 1, 2.0), _warm_grid(hp, cfg, 2, 0.5)]
    _reset_launch_counts()
    with cudnn_deterministic():
        cold, cold_s, cold_rounds = _timed_run(
            Arena(engine, chunk_size=1), init, sp, bank, grids[0], rounds,
            lr_seq)
        arena = Arena(engine, chunk_size=1)
        dog = Watchdog(strict=True).attach(arena)
        loaded = len(_build.LOADED)
        _sync(bank)
        t0 = time.perf_counter()
        warm = arena.warmup(init, sp, bank, _warm_grid(hp, cfg, 0), rounds,
                            lr_seq)
        _sync(bank)
        warmup_s = time.perf_counter() - t0
        runs = [_timed_run(arena, init, sp, bank, g, rounds, lr_seq)
                for g in grids]
        builds = _build.LOADED[loaded:]
        violations = list(dog.violations)
        try:
            arena.run(init, sp, bank,
                      _warm_grid(hp, cfg, 3, k=cfg["sample_count"] + 4),
                      rounds, lr_seq)
            drift_raised = False
        except RetraceError:
            drift_raised = True
    launches = dict(fk.LAUNCHES)
    agree = _reports_within(runs[0][0], cold)
    summary = dict(
        lanes=len(WARMUP_CONTROLLERS), rounds=rounds, warmup=warm,
        warmup_s=warmup_s, cold_s=cold_s, cold_round_s=cold_rounds,
        warm_s=[r[1] for r in runs], warm_round_s=[r[2] for r in runs],
        first_round_warm_over_cold=runs[0][2][0] / cold_rounds[0],
        executables_built=[r[0].meta["executables_built"] for r in runs],
        violations=violations, kernels_loaded_after_warmup=builds,
        drift_violation=dog.violations[-1] if dog.violations else None,
        drift_raised=drift_raised, warm_vs_cold=agree,
        cudnn_deterministic=True,
        launches={"fl_aggregate_lanes": launches["fl_aggregate_lanes"]})
    log("warmup.arena", **summary)
    require(violations == [] and not builds,
            "warmup.arena: no violation and no kernel build after warmup")
    require(all(r[0].meta["executables_built"] == 0 for r in runs),
            "warmup.arena: the warmed runs run no new signature")
    require(drift_raised, "warmup.arena: a K_max drift raises RetraceError")
    require(agree["ok"], f"warmup.arena: the warmed run within the arena "
                         f"bounds of the cold run ({agree})")
    # cold, warmup, two warm runs, the drifted run: one launch a round
    want = 5 * rounds if on_card else 0
    require(launches["fl_aggregate_lanes"] == want,
            f"warmup.arena: {want} lane launches, got "
            f"{launches['fl_aggregate_lanes']}")
    return summary


def phase_warmup_sweep(trainer, cfg: dict = PAPER_SCALE,
                       rounds: int = WARMUP_SWEEP_ROUNDS) -> dict:
    """``warmup.sweep``: ``SweepService.warmup`` over ``Arena(engine,
    k_mode='auto', chunk_size=2)`` on the ladder (T = 3: a chunk and its
    continuation), then two submissions of other V, lam and seeds, each
    run on its own, under a strict watchdog: zero violations, zero kernel
    builds, one lane launch per bucket round."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.obs import Watchdog
    from repro_torch.sim import Arena, SweepService

    engine, bank, sp = trainer.engine, trainer.bank, trainer.params
    dev = trainer.device
    on_card = dev.type == "cuda"
    hp = trainer.controller.hp
    lr_seq = [trainer.lr_schedule(t) for t in range(rounds)]
    init = trainer.task.init(torch.Generator(device=dev).manual_seed(
        cfg["seed"] + 1))
    arena = Arena(engine, k_mode="auto", chunk_size=SWEEP_CHUNK)
    svc = SweepService(arena, init, sp, bank)
    dog = Watchdog(strict=True).attach(arena)
    _reset_launch_counts()
    with cudnn_deterministic():
        _sync(bank)
        t0 = time.perf_counter()
        warm = svc.warmup(_warm_grid(hp, cfg, 0), rounds, lr_seq)
        _sync(bank)
        warmup_s = time.perf_counter() - t0
        loaded = len(_build.LOADED)
        seconds, reports = [], []
        for seed, scale in ((4, 2.0), (5, 0.5)):
            ticket = svc.submit(_warm_grid(hp, cfg, seed, scale), rounds,
                                lr_seq)
            t0 = time.perf_counter()
            require(svc.run_pending() == [ticket],
                    "warmup.sweep: the submission ran")
            _sync(bank)
            seconds.append(time.perf_counter() - t0)
            reports.append(svc.result(ticket))
    launches = dict(fk.LAUNCHES)
    builds = _build.LOADED[loaded:]
    summary = dict(lanes=len(WARMUP_CONTROLLERS), rounds=rounds,
                   chunk=SWEEP_CHUNK, warmup=warm, warmup_s=warmup_s,
                   submission_s=seconds, violations=list(dog.violations),
                   kernels_loaded_after_warmup=builds,
                   executables_built=[r.meta["executables_built"]
                                      for r in reports],
                   stall=Watchdog.stall_report(arena.metrics),
                   launches={"fl_aggregate_lanes":
                             launches["fl_aggregate_lanes"]})
    log("warmup.sweep", **summary)
    require(dog.violations == [] and not builds,
            "warmup.sweep: no violation and no kernel build after warmup")
    # warmup runs each bucket for a one-round chunk and its one-round
    # continuation; each submission for its T rounds
    want = len(warm["plan"]) * (2 + 2 * rounds) if on_card else 0
    require(launches["fl_aggregate_lanes"] == want,
            f"warmup.sweep: {want} lane launches, got "
            f"{launches['fl_aggregate_lanes']}")
    return summary


def phase_warmup_pool(trainer, data: dict, cfg: dict = PAPER_SCALE
                      ) -> dict:
    """``warmup.pool``: an empty ``BankPool`` of the paper-scale clients'
    shape (capacity 16), ``warmup`` (a sentinel admitted and evicted),
    then churn: 15 clients admitted, 6 of them evicted as they go.
    ``traces`` stays 1, every tensor keeps its ``data_ptr()``, the
    counters add up."""
    from repro_torch.fl import BankPool

    clients = data["clients"]
    cap = 16
    pool = BankPool(trainer.engine.cfg, capacity=cap,
                    max_examples=max(len(c[1]) for c in clients),
                    feature_shape=clients[0][0].shape[1:],
                    feature_dtype=clients[0][0].dtype,
                    label_dtype=clients[0][1].dtype,
                    device=trainer.device,
                    x_layout=trainer.task.device_layout)
    ptrs = pool.data_ptrs()
    t0 = time.perf_counter()
    pool.warmup()
    warmup_s = time.perf_counter() - t0
    traces_warm = pool.traces
    t0 = time.perf_counter()
    for i in range(15):
        pool.admit(i, *clients[i % len(clients)])
        if i < 12 and i % 2 == 0:
            pool.evict(i)
    _sync(pool)
    churn_s = time.perf_counter() - t0
    summary = dict(capacity=cap, bucket_examples=pool.bucket_examples,
                   nbytes=pool.nbytes, warmup_s=warmup_s, churn_s=churn_s,
                   traces_after_warmup=traces_warm, traces=pool.traces,
                   admits=pool.admits, evicts=pool.evicts,
                   uploads=pool.uploads, resident=pool.num_resident,
                   data_ptrs_unchanged=pool.data_ptrs() == ptrs)
    log("warmup.pool", **summary)
    require(traces_warm == 1 and pool.traces == 1,
            "warmup.pool: one cold write shape, at warmup")
    require(summary["data_ptrs_unchanged"],
            "warmup.pool: churn moved no tensor")
    require((pool.admits, pool.evicts, pool.num_resident) == (16, 7, 9),
            "warmup.pool: the counters add up (the sentinel included)")
    return summary


def start_dryrun(root: str) -> dict:
    """Start ``python -m repro_torch.launch.dryrun --all`` on the
    ``meta`` device in a background process (one thread, no card
    visible), so it counts every (arch x shape) while the card runs the
    other phases; :func:`phase_roofline` waits for it."""
    out, log_path = os.path.join(root, "dryrun.json"), \
        os.path.join(root, "dryrun.log")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    logf = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", out], env=env, stdout=logf, stderr=subprocess.STDOUT)
    return dict(proc=proc, out=out, log=log_path, logf=logf,
                t0=time.perf_counter())


def stop_dryrun(run: dict) -> None:
    """Kill the dry run if it is still running (on any exit of main)."""
    if run["proc"].poll() is None:
        run["proc"].kill()
        run["proc"].wait()
    run["logf"].close()


def _timed_step_counts() -> dict:
    """The steps the script times, counted on ``meta`` at the shapes it
    times them: ``train.gemma2b`` (:data:`GEMMA_TRAIN`, remat, 2
    microbatches), the gemma2-27b and mamba2-130m prefills
    (:data:`GEMMA_SERVE`, :data:`MAMBA_SERVE`) and one
    ``fl_round.gemma2b`` round (:data:`FL_ROUND`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import op_cost
    from repro_torch.launch.steps import (dryrun_config, make_fl_round_step,
                                          make_prefill_step,
                                          make_train_step, param_specs)
    from repro_torch.optim import SGD

    def tokens(*shape):
        return torch.empty(shape, dtype=torch.int64, device="meta")

    out = {}
    gemma2b = dryrun_config(get_config("gemma-2b"))
    p = param_specs(gemma2b)
    spec = GEMMA_TRAIN
    _, c = op_cost.count(
        make_train_step(gemma2b, remat=True, microbatch=spec["microbatch"],
                        device="meta"), p, SGD(momentum=0.9).init(p),
        {"tokens": tokens(spec["batch"], spec["seq"]),
         "labels": tokens(spec["batch"], spec["seq"])})
    out["train.gemma2b"] = c
    spec = FL_ROUND
    k = spec["clients"]
    _, c = op_cost.count(
        make_fl_round_step(gemma2b, k, lr=spec["lr"],
                           local_steps=spec["local_steps"], device="meta"),
        p, {"tokens": tokens(k, spec["local_batch"], spec["seq"]),
            "labels": tokens(k, spec["local_batch"], spec["seq"]),
            "coeffs": torch.empty(k, device="meta")})
    out["fl_round.gemma2b"] = c
    for label, cfg, spec in (
            ("serve.gemma2", dryrun_config(get_config("gemma2-27b")),
             GEMMA_SERVE),
            ("serve.mamba2", get_config("mamba2-130m"), MAMBA_SERVE)):
        _, c = op_cost.count(
            make_prefill_step(cfg, device="meta"), param_specs(cfg),
            {"tokens": tokens(spec["batch"], spec["prompt_len"])})
        out[label] = c
    return out


def phase_roofline(run: dict, timed: dict, smi: str) -> dict:
    """``roofline``: wait for the background dry run (:func:`start_dryrun`),
    require it to have counted every (arch x covered shape) on ``meta``,
    and print its roofline table (H100 constants, ``launch.mesh``).  Then
    the steps this script timed, counted on ``meta`` at their shapes
    (:func:`_timed_step_counts`): each one's counted compute and memory
    terms beside the measured seconds (``timed``: label -> seconds) and
    the share of the roofline the card reached, ``max(compute_s,
    memory_s) / measured``, on the card named by ``smi``."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import covered_shapes
    from repro_torch.launch import roofline as rf

    rc = run["proc"].wait(timeout=max(
        60.0, 1100.0 - (time.perf_counter() - run["t0"])))
    waited_at = time.perf_counter() - run["t0"]
    require(rc == 0, f"roofline: the dry run exited {rc} (its output: "
                     f"{open(run['log']).read()[-3000:]})")
    with open(run["out"]) as f:
        doc = json.load(f)
    require(doc["failures"] == [], f"roofline: combinations the dry run "
                                   f"could not count: {doc['failures']}")
    print(rf.format_table(doc["results"]), flush=True)
    rows = []
    for res in doc["results"]:
        t = res["terms"]
        rows.append(dict(arch=res["arch"], shape=res["shape"],
                         compute_s=t["compute_s"], memory_s=t["memory_s"],
                         dominant=t["dominant"],
                         useful=t.get("model_flops_ratio"),
                         count_s=res["count_s"],
                         argument_bytes=res["argument_bytes"]["total"]))
    t0 = time.perf_counter()
    counters = _timed_step_counts()
    count_s = time.perf_counter() - t0
    steps = {}
    for label, counter in counters.items():
        terms = rf.roofline_terms(counter.analyze(), chips=1)
        measured = timed[label]
        steps[label] = dict(
            measured_s=measured, compute_s=terms["compute_s"],
            memory_s=terms["memory_s"], dominant=terms["dominant"],
            flops=terms["hlo_flops_per_device"],
            bytes=terms["hlo_bytes_per_device"],
            roofline_share=max(terms["compute_s"], terms["memory_s"])
            / measured,
            kernels={k: v["calls"] for k, v in counter.kernels.items()})
    summary = dict(card=smi, combinations=len(rows),
                   dryrun_wall_s=waited_at, timed_count_s=count_s,
                   table=rows, steps=steps)
    log("roofline", **summary)
    require(len(rows) == sum(len(covered_shapes(spec))
                             for spec in ARCHS.values()),
            "roofline: every (arch x covered shape) counted")
    return summary


def phase_arena_map(trainer, scan: dict, cfg: dict = PAPER_SCALE,
                    rounds: int = SCAN_ROUNDS) -> dict:
    """``arena.map``: LROA, Uni-D and DivFL as one ``Arena(batch='map')``
    grid on the main path's single bucket, over the ``scan`` phase's
    channels, learning rates and initial params, cuDNN deterministic:
    each lane runs its round as ``run_scan`` does, so every lane must be
    bitwise its ``scan`` rollout (params, losses, selections, queues),
    with one one-lane ``fl_aggregate`` launch per lane round and no lane
    launch."""
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.sim import Arena, ScenarioGrid

    engine, bank, sp = trainer.engine, trainer.bank, trainer.params
    on_card = trainer.device.type == "cuda"
    hp = trainer.controller.hp
    policies = ["lroa", "uni_d", "divfl"]
    grid = ScenarioGrid.create(policies, seeds=cfg["seed"], V=hp.V,
                               lam=hp.lam, sample_count=cfg["sample_count"],
                               num_devices=cfg["num_devices"])
    h_all = np.broadcast_to(scan["h_seq"], (len(grid),)
                            + scan["h_seq"].shape)
    _reset_launch_counts()
    with cudnn_deterministic():
        trainer._sync()
        t0 = time.perf_counter()
        rep = Arena(engine, batch="map").run(
            scan["init"], sp, bank, grid, rounds, scan["lr_seq"],
            h_all=h_all)
        trainer._sync()
        seconds = time.perf_counter() - t0
    launches = {k: fk.LAUNCHES[k] for k in ("fl_aggregate",
                                            "fl_aggregate_lanes")}
    lanes = []
    for s, policy in enumerate(policies):
        ref_params, ref_met = scan["results"][policy]
        row = dict(
            lane=s, policy=policy,
            params_bitwise_equal=all(torch.equal(rep.params[k][s],
                                                 ref_params[k])
                                     for k in ref_params),
            losses_bitwise_equal=bool(np.array_equal(rep.metrics["loss"][s],
                                                     ref_met["loss"])),
            selections_equal=bool(np.array_equal(
                rep.metrics["selected"][s], ref_met["selected"])),
            queues_bitwise_equal=bool(np.array_equal(
                rep.queues[s], scan["queues"][policy].cpu().numpy())),
            param_max_abs_err=max(float((rep.params[k][s] - ref_params[k])
                                        .abs().max()) for k in ref_params))
        log("arena.map.lane", **row)
        require(row["params_bitwise_equal"] and row["losses_bitwise_equal"]
                and row["selections_equal"] and row["queues_bitwise_equal"],
                f"arena.map lane {policy} is bitwise its scan rollout")
        lanes.append(row)
    want = dict(fl_aggregate=len(grid) * rounds if on_card else 0,
                fl_aggregate_lanes=0)
    summary = dict(lanes=len(grid), rounds=rounds, seconds=seconds,
                   lane_rounds_per_s=len(grid) * rounds / seconds,
                   cudnn_deterministic=True, launches=launches)
    log("arena.map", **summary)
    require(launches == want, f"arena.map: launches {launches}, want {want} "
                              f"(one one-lane launch per lane round)")
    return summary


def describe_bank(bank, cfg: dict) -> dict:
    """The bank's ladder and footprint: tiers, bucket rows, clients and
    steps per epoch per tier, device bytes beside what the one global
    bucket would hold (``estimate_bank_nbytes``), and the mean bucket
    rows a client is padded to."""
    from repro_torch.fl import estimate_bank_nbytes

    tiers = getattr(bank, "tiers", [bank])
    sizes = bank.sizes
    return dict(
        kind=type(bank).__name__, storage=bank.storage, tiers=len(tiers),
        rows=[b.bucket_examples for b in tiers],
        clients=[b.num_clients for b in tiers],
        steps_per_epoch=[b.steps_per_epoch for b in tiers],
        bank_bytes=bank.nbytes,
        single_bucket_bytes=estimate_bank_nbytes(
            sizes, cfg["batch_size"], cfg["image_shape"]),
        mean_bucket_rows=bank.padded_examples / len(sizes),
        sizes_min=int(sizes.min()), sizes_median=float(np.median(sizes)),
        sizes_max=int(sizes.max()))


def phase_main_path(device: str = "cuda", cfg: dict = PAPER_SCALE,
                    data: dict = None, bank_mode: str = "auto",
                    label: str = "main") -> dict:
    """The paper-scale trainer through ``FederatedTrainer.run_round``:
    ``warmup()``, then ``ROUNDS`` LROA rounds on the bank ``bank_mode``
    builds ('auto', the trainer's default: the tier ladder at the
    paper's testbed; ``main.single`` runs 'single').  Finite losses, q on
    the simplex, moved queues, changed params, exactly one
    ``fl_aggregate`` launch per round; the ladder and the tiers each
    round hit are logged."""
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.obs import trace

    t0 = time.perf_counter()
    if data is None:
        data = make_data(cfg)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = build_trainer(device, cfg, data, bank_mode=bank_mode)
    trainer._sync()
    t_build = time.perf_counter() - t0
    bank = trainer.bank
    n_params = sum(p.numel() for p in trainer.global_params.values())
    ladder = describe_bank(bank, cfg)
    log(f"{label}.setup", data_s=t_data, trainer_s=t_build,
        num_clients=cfg["num_devices"], sample_count=cfg["sample_count"],
        bank_mode=bank_mode, bucket_rows=bank.bucket_examples,
        model_params=n_params, **ladder)
    t0 = time.perf_counter()
    trainer.warmup()
    log(f"{label}.warmup", seconds=time.perf_counter() - t0)

    before = {n: p.clone() for n, p in trainer.global_params.items()}
    queues0 = trainer.controller.queues.clone()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer._sync()
    per_round, rounds, snapshots = [], [], []
    _reset_launch_counts()
    with trace.installed(trace.MemorySink()) as sink:
        t_all = time.perf_counter()
        for t in range(ROUNDS):
            count0 = fk.LAUNCHES["fl_aggregate"]
            t0 = time.perf_counter()
            rec = trainer.run_round(t)
            trainer._sync()
            per_round.append(time.perf_counter() - t0)
            rounds.append((rec, fk.LAUNCHES["fl_aggregate"] - count0))
            if t < SHARD_ROUNDS:    # shard.main's yardstick
                snapshots.append(dict(
                    selected=[int(i) for i in rec.selected],
                    params={n: p.cpu().numpy()
                            for n, p in trainer.global_params.items()}))
            q = trainer.last_decision.q
            require(bool(torch.all(q > 0)) and
                    abs(float(q.sum()) - 1.0) <= 1e-5,
                    f"{label} round {t}: q on the simplex")
        t_all = time.perf_counter() - t_all
    launches = dict(fk.LAUNCHES)
    decide_s = [r["dur"] for r in sink.by_name("controller.decide")]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    want = 1 if device == "cuda" else 0
    hits = []
    for t, (rec, n_launch) in enumerate(rounds):
        hits.append(_tiers_hit(bank, rec.selected))
        log(f"{label}.round", t=t, seconds=per_round[t],
            decide_s=decide_s[t], loss=rec.mean_loss, selected=rec.selected,
            tiers_hit=hits[-1], fl_aggregate_launches=n_launch,
            queue_mean=rec.queue_mean, wall_time_model_s=rec.wall_time,
            test_accuracy=rec.test_accuracy)
        require(np.isfinite(rec.mean_loss), f"{label} round {t}: finite "
                                            f"loss")
        require(n_launch == want, f"{label} round {t}: {want} fl_aggregate "
                                  f"launch, got {n_launch}")
    require(launches["fl_aggregate"] == want * ROUNDS,
            f"{want * ROUNDS} fl_aggregate launches in {label}")
    moved = float((trainer.controller.queues - queues0).abs().max())
    changed = max(float((trainer.global_params[n] - before[n]).abs().max())
                  for n in before)
    finite = all(bool(torch.isfinite(p).all())
                 for p in trainer.global_params.values())
    require(moved > 0.0, f"{label}: the queues moved")
    require(changed > 0.0 and finite, f"{label}: the params changed and "
                                      f"are finite")
    summary = dict(rounds=ROUNDS, seconds=t_all, rounds_per_s=ROUNDS / t_all,
                   round_s_median=statistics.median(per_round),
                   decide_s_median=statistics.median(decide_s),
                   bank_bytes=bank.nbytes, peak_mem_bytes=peak,
                   queue_max_change=moved, param_max_change=changed,
                   tiers_hit=hits, launches=launches)
    log(label, **summary)
    summary.update(trainer=trainer, test=data["test"], data=data,
                   snapshots=snapshots)
    return summary


def phase_profile(trainer, t: int, label: str = "profile") -> None:
    """One more round under ``torch.profiler``: device time by kernel,
    launches, and the device's busy share of the round's wall time (the
    profiler slows the host side, so the share is a lower bound)."""
    rec, prof = _profiled(lambda: trainer.run_round(t))
    log(label, bank=type(trainer.bank).__name__, round_s=prof.pop("wall_s"),
        tiers_hit=_tiers_hit(trainer.bank, rec.selected), **prof)


def phase_scale(trainer, single, data: dict, cfg: dict = PAPER_SCALE
                ) -> dict:
    """The scale plane at paper scale: one LROA round (the main path's
    controller decides on a fresh channel draw, K clients drawn by q, the
    eq.-(4) weights; epoch keys as wide as the widest bucket) from the
    same params, selection, coefficients and keys through
    ``RoundEngine.round_step`` on: the main path's fp32 ladder and an
    int8 ladder (bank bytes; the int8 loss within 5% of the fp32 one);
    a ``BankPool`` of capacity 120 after 8 clients are evicted and
    re-admitted (every tensor keeps its ``data_ptr()``; params within
    1e-6 of the single bucket's round, bitwise logged); and a single
    bucket with 8 k-means clusters, flat and hierarchical (losses
    bitwise, params within 1e-5).  cuDNN's deterministic algorithms.
    One ``fl_aggregate`` launch per flat round, none for the
    hierarchical one."""
    from repro_torch.fl import BankPool, ClientBank, sample_clients
    from repro_torch.fl import aggregation_weights
    from repro_torch.kernels import fl_aggregate as fk

    dev = trainer.device
    engine, task = trainer.engine, trainer.task
    k = cfg["sample_count"]
    h = torch.as_tensor(trainer.channel.sample(), device=dev)
    q = trainer.controller.decide(h).q.cpu().numpy()
    sel = sample_clients(np.random.default_rng(cfg["seed"] + 5), q, k)
    coeffs = aggregation_weights(sel, q, trainer.w, k)
    keys = torch.rand((k, cfg["local_epochs"], trainer.bank.bucket_examples),
                      generator=torch.Generator(device=dev).manual_seed(11),
                      device=dev)
    init = task.init(torch.Generator(device=dev).manual_seed(cfg["seed"]
                                                             + 1))
    lr = trainer.lr_schedule(0)
    clients = data["clients"]
    t0 = time.perf_counter()
    int8 = engine.make_bank(clients, storage="int8")
    pool = BankPool(engine.cfg, capacity=cfg["num_devices"],
                    initial_clients=dict(enumerate(clients)), device=dev,
                    x_layout=task.device_layout)
    ptrs = pool.data_ptrs()
    churn = [int(c) for c in np.random.default_rng(cfg["seed"] + 6).choice(
        cfg["num_devices"], 8, replace=False)]
    for c in churn:
        pool.evict(c)
    for c in reversed(churn):
        pool.admit(c, *clients[c])
    clustered = ClientBank(clients, engine.cfg, device=dev,
                           x_layout=task.device_layout, clusters=8)
    trainer._sync()
    build_s = time.perf_counter() - t0
    out, rows = {}, []
    with cudnn_deterministic():
        for name, bank, s, hier in (
                ("fp32_ladder", trainer.bank, sel, False),
                ("int8_ladder", int8, sel, False),
                ("single", single.bank, sel, False),
                ("pool", pool, pool.slots_for(sel), False),
                ("clustered_flat", clustered, sel, False),
                ("hierarchical", clustered, sel, True)):
            _reset_launch_counts()
            trainer._sync()
            t0 = time.perf_counter()
            p, l = engine.round_step(init, bank, s, coeffs, lr, keys,
                                     hierarchical=hier)
            trainer._sync()
            seconds = time.perf_counter() - t0
            out[name] = (p, l)
            row = dict(bank=name, seconds=seconds,
                       loss=float(l.mean()), bank_bytes=bank.nbytes,
                       bytes_per_client=bank.bytes_per_client,
                       fl_aggregate_launches=fk.LAUNCHES["fl_aggregate"],
                       finite=all(bool(torch.isfinite(v).all())
                                  for v in p.values()))
            log("scale.round", **row)
            require(row["finite"] and np.isfinite(row["loss"]),
                    f"scale {name}: finite")
            require(row["fl_aggregate_launches"] ==
                    (0 if hier or dev.type != "cuda" else 1),
                    f"scale {name}: fl_aggregate launches "
                    f"{row['fl_aggregate_launches']}")
            rows.append(row)

    def dev_max(a, b):
        return max(float((out[a][0][n] - out[b][0][n]).abs().max())
                   for n in init)

    fp32_loss, int8_loss = rows[0]["loss"], rows[1]["loss"]
    summary = dict(
        selected=sel.tolist(), tiers_hit=_tiers_hit(trainer.bank, sel),
        build_s=build_s, churn=churn,
        pool_data_ptrs_equal=pool.data_ptrs() == ptrs,
        pool_admits=pool.admits, pool_evicts=pool.evicts,
        int8_bank_bytes=int8.nbytes, fp32_bank_bytes=trainer.bank.nbytes,
        single_bank_bytes=single.bank.nbytes, pool_bank_bytes=pool.nbytes,
        int8_loss_rel_err=abs(int8_loss - fp32_loss) / abs(fp32_loss),
        int8_param_max_abs_diff=dev_max("int8_ladder", "fp32_ladder"),
        ladder_vs_single_param_max_abs_diff=dev_max("fp32_ladder",
                                                    "single"),
        ladder_vs_single_loss_rel_diff=abs(fp32_loss - rows[2]["loss"])
        / abs(rows[2]["loss"]),
        pool_vs_single_param_max_abs_err=dev_max("pool", "single"),
        pool_vs_single_bitwise=all(torch.equal(out["pool"][0][n],
                                               out["single"][0][n])
                                   for n in init),
        hierarchical_vs_flat_param_max_abs_err=dev_max("hierarchical",
                                                       "clustered_flat"),
        hierarchical_losses_bitwise_flat=bool(torch.equal(
            out["hierarchical"][1], out["clustered_flat"][1])),
        num_clusters=clustered.num_clusters)
    log("scale", **summary)
    require(summary["pool_data_ptrs_equal"],
            "the pool's tensors keep their storage across churn")
    require(summary["int8_loss_rel_err"] <= 5e-2,
            f"the int8 ladder's loss within 5% of the fp32 ladder's "
            f"({summary['int8_loss_rel_err']})")
    require(summary["pool_vs_single_param_max_abs_err"] <= 1e-6,
            "the pool's round is the single bucket's within 1e-6")
    require(summary["hierarchical_losses_bitwise_flat"] and
            summary["hierarchical_vs_flat_param_max_abs_err"] <= 1e-5,
            "the hierarchical round is the flat round reassociated")
    del int8, pool, clustered, out
    return summary


# ---------------------------------------------------------------------------
# the paper's Sec.-VII experiments: the two testbeds, the sequential
# reference path, the heterogeneity ablation
# ---------------------------------------------------------------------------

def time_to_accuracy(curve, target: float) -> float:
    """The modelled time at which an accuracy curve first reaches
    ``target`` (``benchmarks/bench_convergence.time_to_accuracy``)."""
    for _, cum, acc in curve:
        if acc is not None and acc >= target:
            return cum
    return float("inf")


def phase_paper(label: str, cfg: dict, device: str = "cuda",
                controllers=PAPER_CONTROLLERS, profile: bool = False
                ) -> dict:
    """One of the paper's Sec.-VII testbeds at paper scale on the
    trainer's default bank (the tier ladder): each controller's
    ``FederatedTrainer`` runs ``run(R)`` with the launch counts set to 0
    just before and read just after, the first controller's after
    ``warmup()``.  Each round
    must make exactly one ``fl_aggregate`` launch (none on the CPU), the
    losses stay finite and the params change.  Logged per controller:
    rounds/s, the round times, ``accuracy_curve()``, the modelled total
    latency, peak memory; across them, as ``bench_convergence.py``
    computes them: the time to 95% of the worst final accuracy and each
    baseline's saving against LROA (time to target and total latency).
    With ``profile``, one more LROA round runs under ``torch.profiler``
    (the device's busy share; its post-processing takes minutes at the
    ResNet's 188k launches a round, so ``paper.cifar`` runs without)."""
    from repro_torch.kernels import fl_aggregate as fk

    on_card = device == "cuda"
    want = 1 if on_card else 0
    rounds = cfg["rounds"]
    t0 = time.perf_counter()
    data = make_data(cfg)
    log(f"{label}.setup", data_s=time.perf_counter() - t0,
        task=cfg.get("task", "cnn"), dataset=cfg["dataset"],
        partition=cfg.get("partition", "dirichlet"),
        image_shape=cfg["image_shape"], num_classes=cfg["num_classes"],
        num_clients=cfg["num_devices"], sample_count=cfg["sample_count"],
        rounds=rounds, lr=cfg["lr"], sizes_min=float(data["sizes"].min()),
        sizes_median=float(np.median(data["sizes"])),
        sizes_max=float(data["sizes"].max()))
    curves, totals, rows, launches = {}, {}, {}, 0
    for name in controllers:
        trainer = build_trainer(device, cfg, data, controller=name)
        t0 = time.perf_counter()
        if name == controllers[0]:
            # the later controllers' trainers (same task, bank and
            # shapes) find the process warm: with every trainer warmed up
            # the script passed 900 s, and the later controllers' round
            # times did not move (PERF.md section 6)
            trainer.warmup()
        warm_s = time.perf_counter() - t0
        init = {n: p.clone() for n, p in trainer.global_params.items()}
        per_round = []
        run_round = trainer.run_round

        def counted(t, run_round=run_round, trainer=trainer,
                    per_round=per_round):
            count0 = fk.LAUNCHES["fl_aggregate"]
            t1 = time.perf_counter()
            rec = run_round(t)
            trainer._sync()
            per_round.append((time.perf_counter() - t1,
                              fk.LAUNCHES["fl_aggregate"] - count0))
            return rec

        trainer.run_round = counted
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        trainer._sync()
        _reset_launch_counts()
        t0 = time.perf_counter()
        result = trainer.run(rounds)
        trainer._sync()
        seconds = time.perf_counter() - t0
        n_launch = fk.LAUNCHES["fl_aggregate"]
        launches += n_launch
        changed = max(float((result.params[n] - init[n]).abs().max())
                      for n in init)
        losses = [r.mean_loss for r in result.records]
        row = dict(
            controller=name, rounds=rounds, warmup_s=warm_s,
            seconds=seconds, rounds_per_s=rounds / seconds,
            round_s=[r for r, _ in per_round],
            fl_aggregate_launches=[n for _, n in per_round],
            accuracy_curve=result.accuracy_curve(),
            total_time_model_s=result.total_time, losses=losses,
            selected=[r.selected for r in result.records],
            tiers_hit=[_tiers_hit(trainer.bank, r.selected)
                       for r in result.records],
            peak_mem_bytes=(torch.cuda.max_memory_allocated() if on_card
                            else None),
            bank=type(trainer.bank).__name__, bank_bytes=trainer.bank.nbytes,
            param_max_change=changed)
        log(f"{label}.controller", **row)
        require(all(np.isfinite(losses)), f"{label} {name}: finite losses")
        require(changed > 0.0 and all(bool(torch.isfinite(p).all())
                                      for p in result.params.values()),
                f"{label} {name}: the params changed and are finite")
        require([n for _, n in per_round] == [want] * rounds and
                n_launch == want * rounds,
                f"{label} {name}: {want} fl_aggregate launch per round")
        curves[name] = row["accuracy_curve"]
        totals[name] = result.total_time
        rows[name] = row
        if profile and name == controllers[0] and on_card:
            rec, prof = _profiled(lambda: trainer.run_round(rounds))
            log(f"{label}.profile", controller=name,
                round_s=prof.pop("wall_s"),
                tiers_hit=_tiers_hit(trainer.bank, rec.selected), **prof)
        del trainer, result
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    finals = {n: (c[-1][2] if c else 0.0) for n, c in curves.items()}
    target = 0.95 * min(finals.values())
    to_target = {n: time_to_accuracy(c, target) for n, c in curves.items()}
    lroa = controllers[0]
    summary = dict(
        rounds=rounds, final_accuracy=finals, target_accuracy=target,
        time_to_target_model_s=to_target, total_time_model_s=totals,
        time_to_target_saving_pct={
            b: (100.0 * (1.0 - to_target[lroa] / to_target[b])
                if np.isfinite(to_target[b]) and np.isfinite(to_target[lroa])
                else None) for b in controllers[1:]},
        total_latency_saving_pct={
            b: 100.0 * (1.0 - totals[lroa] / totals[b])
            for b in controllers[1:]},
        rounds_per_s={n: r["rounds_per_s"] for n, r in rows.items()},
        peak_mem_bytes=max((r["peak_mem_bytes"] or 0)
                           for r in rows.values()) or None,
        launches={"fl_aggregate": launches})
    log(label, **summary)
    summary.update(data=data, rows=rows)
    return summary


def phase_paper_sequential(cfg: dict, paper: dict, device: str = "cuda",
                           rounds: int = SEQUENTIAL_ROUNDS) -> dict:
    """DivFL on the CIFAR-like testbed under ``use_engine=False`` (the
    reference semantics): K ``local_update`` calls a round on the
    clients' true examples, each update's sketch observed before the next
    client trains, the aggregate in plain PyTorch (no ``fl_aggregate``
    launch).  Its round times beside the fused DivFL rounds of
    ``paper.cifar``; no warmup (eager PyTorch compiles nothing ahead)."""
    from repro_torch.kernels import fl_aggregate as fk

    trainer = build_trainer(device, cfg, paper["data"], controller="divfl",
                            use_engine=False)
    init = {n: p.clone() for n, p in trainer.global_params.items()}
    k = cfg["sample_count"]
    per_round = []
    _reset_launch_counts()
    for t in range(rounds):
        t0 = time.perf_counter()
        rec = trainer.run_round(t)
        trainer._sync()
        per_round.append(time.perf_counter() - t0)
        observed = np.flatnonzero(np.any(trainer.controller._update_bank,
                                         axis=1))
        log("paper.sequential.round", t=t,
            seconds=per_round[-1], selected=rec.selected,
            loss=rec.mean_loss, clients_observed=observed.tolist(),
            wall_time_model_s=rec.wall_time)
        require(len(rec.selected) == k and np.isfinite(rec.mean_loss),
                f"paper.sequential round {t}: K clients, finite loss")
        require(set(rec.selected) <= set(observed.tolist()),
                f"paper.sequential round {t}: every selected client's "
                f"update observed")
    changed = max(float((trainer.global_params[n] - init[n]).abs().max())
                  for n in init)
    fused = paper["rows"]["divfl"]["round_s"]
    summary = dict(rounds=rounds, round_s=per_round,
                   fused_divfl_round_s=fused,
                   sequential_over_fused=(statistics.median(per_round)
                                          / statistics.median(fused)),
                   launches=_launch_counts(), param_max_change=changed)
    log("paper.sequential", **summary)
    require(summary["launches"]["fl_aggregate"] == 0,
            "paper.sequential: the list API aggregates without the kernel")
    require(changed > 0.0, "paper.sequential: the params changed")
    del trainer
    gc.collect()
    return summary


def phase_heterogeneity(device: str = "cuda", rounds: int = HET_ROUNDS,
                        spreads=HET_SPREADS, seed: int = 0) -> dict:
    """The control-only heterogeneity ablation of
    ``benchmarks/bench_sweeps.heterogeneity_sweep`` on the card: N = 120,
    K = 2, CPU-speed and cycles spreads 1, 2 and 4
    (``heterogeneous_params``, seed 7), LROA against Uni-S over the same
    channels and sampling streams, the realised latency (eq. 10) summed
    over ``rounds`` rounds.  The ``heterogeneous_params`` fields on the
    card must be bitwise the CPU's."""
    import repro_torch.core as core
    from repro_torch.core.controller import realized_round_time
    from repro_torch.fl import (ChannelConfig, ChannelProcess,
                                HeterogeneityConfig, heterogeneous_params,
                                sample_clients)
    from repro_torch.core.system_model import ARRAY_FIELDS
    from repro_torch.sim.testbed import CONTROLLERS

    n, k = 120, 2
    sizes = np.random.default_rng(seed).integers(200, 600, n).astype(
        np.float32)
    rows = []
    t_all = time.perf_counter()
    for spread in spreads:
        het = HeterogeneityConfig(cpu_speed_spread=spread,
                                  cycles_spread=spread, seed=7)
        params, on_cpu = (heterogeneous_params(core.paper_default_params(
            num_devices=n, data_sizes=sizes, sample_count=k, device=dev),
            het) for dev in (device, "cpu"))
        bitwise = all(torch.equal(getattr(params, f).cpu(),
                                  getattr(on_cpu, f)) for f in ARRAY_FIELDS)
        hp = core.estimate_hyperparams(params, 0.1, loss_scale=1.5, mu=1.0,
                                       nu=1e5)
        totals, seconds = {}, {}
        for name in ("lroa", "uni_s"):
            ctrl = CONTROLLERS[name](params, hp)
            chan = ChannelProcess(n, ChannelConfig(seed=seed))
            rng = np.random.default_rng(seed + 1)
            total = 0.0
            t0 = time.perf_counter()
            for _ in range(rounds):
                h = torch.as_tensor(chan.sample(), device=params.device)
                dec = ctrl.decide(h)
                sel = sample_clients(rng, dec.q.cpu().numpy(), k)
                total += realized_round_time(params, h, dec, sel)
                ctrl.step_queues(h, dec)
            seconds[name] = time.perf_counter() - t0
            totals[name] = total
        row = dict(spread=spread, rounds=rounds, lroa_s=totals["lroa"],
                   uni_s_s=totals["uni_s"],
                   latency_saving_pct=100.0 * (1 - totals["lroa"]
                                               / totals["uni_s"]),
                   params_bitwise_cpu=bitwise,
                   f_max_range=[float(params.f_max.min()),
                                float(params.f_max.max())],
                   seconds=seconds)
        log("paper.heterogeneity.spread", **row)
        require(bitwise, f"heterogeneous_params at spread {spread}: the "
                         f"card's fields are bitwise the CPU's")
        require(all(np.isfinite(v) and v > 0 for v in totals.values()),
                f"spread {spread}: finite positive latency totals")
        rows.append(row)
    summary = dict(rounds=rounds, reference_rounds=150,
                   seconds=time.perf_counter() - t_all,
                   saving_pct={r["spread"]: r["latency_saving_pct"]
                               for r in rows})
    log("paper.heterogeneity", **summary)
    return summary


# ---------------------------------------------------------------------------
# the LM slice: flash attention, SSD chunk, serving
# ---------------------------------------------------------------------------

# (B, H, Hkv, S, D) of gemma2-27b's prefill in serve.gemma2, and its
# attention scale and soft-cap
GEMMA_ATTN = (2, 32, 16, 4352, 128)
GEMMA_SCALE, GEMMA_CAP = 144.0 ** -0.5, 50.0
# (B, H, Hkv, Sq, Sk, D) and masks of tests/test_kernels.py, then a
# padded head dim (80 -> 128 on the bf16 path) and D = 256, ragged
FLASH_SWEEP = ((1, 2, 2, 33, 33, 16), (2, 4, 2, 64, 64, 32),
               (1, 8, 1, 48, 80, 64), (1, 4, 2, 300, 300, 80),
               (1, 2, 1, 200, 260, 256))
FLASH_MASKS = ((True, 0, 0.0), (True, 16, 0.0), (False, 0, 0.0),
               (True, 0, 20.0))
# (B, S, nh, hd, N, chunk): mamba2-130m's prefill in serve.mamba2, then
# the points of tests/test_kernels.py
SSD_MAIN = (4, 2048, 24, 64, 128, 256)
SSD_SWEEP = ((1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16),
             (1, 48, 1, 32, 16, 16))
GEMMA_SERVE = dict(batch=2, prompt_len=4352, new_tokens=16, seed=1)
MAMBA_SERVE = dict(batch=4, prompt_len=2048, new_tokens=32, seed=1)
# the flash kernel at the shape class of each family that the serve
# phases below run, as its prefill (and Whisper's decode) gives it, bf16:
# (label, (B, H, Hkv, Sq, Sk, D), causal, window, soft-cap)
FAMILY_FLASH = (
    ("recurrentgemma.local", (2, 10, 1, 4352, 4352, 256), True, 2048, 0.0),
    ("whisper.encoder", (8, 6, 6, 1500, 1500, 64), False, 0, 0.0),
    ("whisper.cross", (8, 6, 6, 192, 1500, 64), False, 0, 0.0),
    ("whisper.cross_decode", (8, 6, 6, 1, 1500, 64), False, 0, 0.0),
    ("granite_moe", (2, 24, 8, 4096, 4096, 64), True, 0, 0.0),
    ("qwen2_vl", (2, 28, 4, 4096, 4096, 128), True, 0, 0.0),
    ("grok", (2, 48, 8, 2048, 2048, 128), True, 0, 30.0),
)
FAMILY_LABELS = tuple(p[0] for p in FAMILY_FLASH)
# the new families' serving runs at full width: (phase, arch, depth cut
# or None, batch and prompts); Whisper's prompt is its decoder's, its
# 1500 audio frames and qwen2-vl's 256 leading patches come from a seed
FAMILY_SERVE = (
    ("granite_moe", "granite-moe-3b-a800m", None,
     dict(batch=2, prompt_len=4096, new_tokens=16, seed=1)),
    ("qwen2_vl", "qwen2-vl-7b", None,
     dict(batch=2, prompt_len=4096, new_tokens=16, seed=1)),
    ("recurrentgemma", "recurrentgemma-2b", None,
     dict(batch=2, prompt_len=4352, new_tokens=16, seed=1)),
    ("whisper", "whisper-tiny", None,
     dict(batch=8, prompt_len=192, new_tokens=32, seed=1)),
    # 4 of grok-1's 64 layers: all 64 (631 GB in bf16) do not fit 80 GB
    ("grok", "grok-1-314b", 4,
     dict(batch=2, prompt_len=2048, new_tokens=8, seed=1)),
)
# what each redesigned kernel does: the header comment of its source
DESIGNS = {name: f"the header comment of src/repro_torch/kernels/csrc/"
                 f"{name}.cu" for name in ("flash_attention", "ssd_chunk")}
# special-function-unit operations per SM per clock (H100: 4 per
# sub-partition)
SFU_PER_SM_CLOCK = 16


def _dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _bound(nbytes: float, flops: float, hbm: float, peak: float):
    t_bytes, t_ops = nbytes / hbm, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_agreement(out, want) -> dict:
    """The flash kernel's ``out`` against its plain version ``want`` under
    :data:`FLASH_TOL` for their dtype: every element within atol + rtol
    |want|, the relative L2 error over the output and the worst row's
    within their limits (``ok``), with the errors and the limits."""
    atol, rtol, l2_limit, row_limit = FLASH_TOL[want.dtype]
    diff = out.float() - want.float()
    ok = torch.allclose(out.float(), want.float(), atol=atol, rtol=rtol)
    rel_l2 = float(diff.norm() / want.float().norm())
    # rows with no visible key are 0 in both
    row_rel_l2 = float((diff.norm(dim=-1) / want.float().norm(
        dim=-1).clamp_min(1e-30)).max())
    return dict(
        atol=atol, rtol=rtol, rel_l2_limit=l2_limit,
        row_rel_l2_limit=row_limit, max_abs_err=float(diff.abs().max()),
        mean_abs_err=float(diff.abs().mean()),
        # the least atol that this rtol would need
        atol_needed=float((diff.abs() - rtol * want.float().abs()).max()),
        rel_l2_err=rel_l2, row_rel_l2_err_max=row_rel_l2,
        ok=ok and rel_l2 <= l2_limit and row_rel_l2 <= row_limit)


def _flash_disagreement(agree: dict) -> str:
    return (f"max err {agree['max_abs_err']}, atol {agree['atol']}, rtol "
            f"{agree['rtol']}; relative L2 {agree['rel_l2_err']}, limit "
            f"{agree['rel_l2_limit']}; worst row "
            f"{agree['row_rel_l2_err_max']}, limit "
            f"{agree['row_rel_l2_limit']}")


def phase_flash(flush, hbm: float, f32_peak: float, bf16_peak: float,
                sfu_ops_per_s: float) -> list:
    """The flash kernel against ``ref.mha_reference`` at gemma2-27b's
    prefill (global and local layers, and the plain causal point that
    ``scaled_dot_product_attention`` is timed at), at the shape class of
    each family the serve phases run (:data:`FAMILY_FLASH`, each beside
    SDPA at the same shape, mask and window; SDPA has no soft-cap) and at
    the sweep of tests/test_kernels.py in f32 and bf16."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    b, h, hkv, s, d = GEMMA_ATTN
    # gemma2.global.bshd: the global layer's inputs in the model's
    # [B, S, H, D] layout, passed as transpose(1, 2) views as prefill does
    points = [dict(label=label, shape=(b, h, hkv, s, s, d),
                   dtype=torch.bfloat16, causal=True, window=window,
                   softcap=cap, scale=GEMMA_SCALE, iters=10)
              for label, window, cap in (("gemma2.global", 0, GEMMA_CAP),
                                         ("gemma2.global.bshd", 0, GEMMA_CAP),
                                         ("gemma2.local", 4096, GEMMA_CAP),
                                         ("gemma2.causal_plain", 0, 0.0))]
    points += [dict(label=label, shape=shape, dtype=torch.bfloat16,
                    causal=causal, window=window, softcap=cap, scale=None,
                    iters=10, family=True)
               for label, shape, causal, window, cap in FAMILY_FLASH]
    for shape in FLASH_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for causal, window, cap in FLASH_MASKS:
                points.append(dict(label="sweep", shape=shape, dtype=dtype,
                                   causal=causal, window=window, softcap=cap,
                                   scale=None, iters=10))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    for pt in points:
        b, h, hkv, sq, sk, d = pt["shape"]
        dtype = pt["dtype"]
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for shape in ((b, h, sq, d), (b, hkv, sk, d),
                                 (b, hkv, sk, d)))
        if pt["label"].endswith(".bshd"):
            q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in (q, k, v))
        kw = dict(causal=pt["causal"], window=pt["window"],
                  softcap=pt["softcap"], scale=pt["scale"])
        out = fa.flash_attention_cuda(q, k, v, **kw)
        want = ref.mha_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        agree = flash_agreement(out, want)
        plain_rel_l2 = None
        if dtype == torch.bfloat16:
            want32 = ref.mha_reference(q.float(), k.float(), v.float(), **kw)
            plain_rel_l2 = float((want.float() - want32).norm()
                                 / want32.norm())
            del want32
        del want
        size = q.element_size()
        nbytes = 2 * (b * h * sq * d + b * hkv * sk * d) * size
        pairs = b * h * fa.visible_pairs(sq, sk, pt["causal"], pt["window"])
        flops = fa.flash_attention_flops(b, h, d, sq, sk, pt["causal"],
                                         pt["window"])
        sfu_ops = pairs * (2 if pt["softcap"] > 0 else 1)
        path = fa.kernel_path(dtype, d)
        bound_ms, bound_by = _bound(
            nbytes, flops, hbm,
            bf16_peak if dtype == torch.bfloat16 else f32_peak)
        library_ms = None
        if pt.get("family"):
            mask = None
            if pt["window"] > 0:
                qp = torch.arange(sq, device="cuda")[:, None]
                kp = torch.arange(sk, device="cuda")[None, :]
                mask = (kp <= qp) & (kp > qp - pt["window"])
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask,
                is_causal=pt["causal"] and mask is None,
                enable_gqa=True), iters=pt["iters"], flush=flush)
            del mask
        elif pt["label"] == "gemma2.causal_plain":
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=pt["scale"],
                enable_gqa=True), iters=pt["iters"], flush=flush)
        elif pt["label"] == "gemma2.local":
            # the window as a boolean mask; SDPA has no soft-cap
            pos = torch.arange(sq, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - pt["window"])
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=pt["scale"],
                enable_gqa=True), iters=pt["iters"], flush=flush)
            del mask
        row = dict(
            label=pt["label"], shape=list(pt["shape"]), dtype=_dname(dtype),
            causal=pt["causal"], window=pt["window"], softcap=pt["softcap"],
            **{k_: v_ for k_, v_ in agree.items() if k_ != "ok"},
            plain_rel_l2_err=plain_rel_l2,
            ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                       iters=pt["iters"], flush=flush),
            plain_ms=time_ms(lambda: ref.mha_reference(q, k, v, **kw),
                             iters=3 if sq > 1024 else pt["iters"],
                             flush=flush),
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            path=path.name, d_pad=path.d_pad, kv_tile=path.kv_tile,
            gflop=flops * 1e-9, mbytes=nbytes * 1e-6)
        row["tflop_per_s"] = flops / row["ms"] * 1e-9
        log("kernel.flash_attention", **row)
        if pt["label"] != "sweep" and not pt.get("family"):
            # a floor derived from the SM count and clock, not a reading:
            # one exp2 and, with the soft-cap, one tanh per visible pair
            log("floor.sfu", label=pt["label"], sfu_ops=sfu_ops,
                sfu_ops_per_s=sfu_ops_per_s,
                floor_ms=sfu_ops / sfu_ops_per_s * 1e3)
        require(agree["ok"],
                f"flash kernel disagrees with its plain version at "
                f"{row['shape']} {row['dtype']} causal={pt['causal']} "
                f"window={pt['window']} softcap={pt['softcap']} "
                f"({_flash_disagreement(agree)})")
        rows.append(row)
        del q, k, v, out
    torch.cuda.empty_cache()
    return rows


def phase_ssd(flush, hbm: float, f32_peak: float, bf16_peak: float) -> list:
    """The SSD-chunk kernel against ``ref.ssd_chunk_batched_reference`` at
    mamba2-130m's prefill (f32, and the same shape in bf16) and at the
    sweep of tests/test_kernels.py, within 5x the kernel tolerances."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk

    points = [("mamba2", SSD_MAIN, torch.float32),
              ("mamba2.bf16", SSD_MAIN, torch.bfloat16)]
    points += [("sweep", dims, dtype) for dims in SSD_SWEEP
               for dtype in (torch.float32, torch.bfloat16)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rows = []
    for label, dims, dtype in points:
        b, s, nh, hd, n, chunk = dims
        x = torch.randn((b, s, nh, hd), device="cuda", generator=gen)
        dt = torch.nn.functional.softplus(torch.randn(
            (b, s, nh), device="cuda", generator=gen))
        a_log = torch.log(torch.linspace(1.0, 16.0, nh, device="cuda"))
        bm = torch.randn((b, s, n), device="cuda", generator=gen)
        cm = torch.randn((b, s, n), device="cuda", generator=gen)
        ins = [t.to(dtype) for t in (x, dt, a_log, bm, cm)]
        y, states = sk.ssd_chunk_cuda(*ins, chunk=chunk)
        wy, wstates = ref.ssd_chunk_batched_reference(*ins, chunk)
        torch.cuda.synchronize()
        tol = 5 * TOL[dtype]
        ok = (torch.allclose(y.float(), wy.float(), atol=tol, rtol=tol)
              and torch.allclose(states, wstates, atol=tol, rtol=tol))
        err = max(float((y.float() - wy.float()).abs().max()),
                  float((states - wstates).abs().max()))
        del wy, wstates
        size = ins[0].element_size()
        nc = s // chunk
        nbytes = (2 * b * s * nh * hd + b * s * nh + nh + 2 * b * s * n) \
            * size + b * nc * nh * hd * n * 4
        flops = sk.ssd_chunk_flops(b, s, nh, hd, n, chunk)
        bound_ms, bound_by = _bound(
            nbytes, flops, hbm,
            bf16_peak if dtype == torch.bfloat16 else f32_peak)
        row = dict(
            label=label, dims=list(dims), dtype=_dname(dtype), tol=tol,
            max_abs_err=err,
            ms=time_ms(lambda: sk.ssd_chunk_cuda(*ins, chunk=chunk),
                       iters=10, flush=flush),
            plain_ms=time_ms(lambda: ref.ssd_chunk_batched_reference(
                *ins, chunk), iters=3 if s > 1024 else 10, flush=flush),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            gflop=flops * 1e-9, gflop_full_squares=2.0 * b * nh * nc * (
                chunk * chunk * (n + hd) + chunk * hd * n) * 1e-9,
            mbytes=nbytes * 1e-6)
        row["tflop_per_s"] = flops / row["ms"] * 1e-9
        log("kernel.ssd_chunk", **row)
        require(ok, f"ssd kernel disagrees with its plain version at "
                    f"{list(dims)} {_dname(dtype)} (err {err}, tol {tol})")
        rows.append(row)
        del x, dt, a_log, bm, cm, ins, y, states
    torch.cuda.empty_cache()
    return rows


# the smoke configs of tests/test_torch_lm.py and of the families' tests:
# gemma2 on the flash path with GQA and a window shorter than the prompt
# (it binds in prefill and the local ring wraps in decode), mamba2, the
# MoE pair, recurrentgemma (its 16-slot ring wraps), Whisper, qwen2-vl,
# and gemma2 with int8 global caches (quantized_kv); all on the flash
# path, so the card launches the kernel where a layer attends
LM_FLASH = dict(attn_impl="flash", flash_block_q=16, flash_block_kv=16)
LM_REFERENCE = (("gemma2-27b", dict(LM_FLASH, num_kv_heads=2,
                                    window_size=16)),
                ("mamba2-130m", {}),
                ("granite-moe-3b-a800m", dict(LM_FLASH, moe_groups=2)),
                ("grok-1-314b", dict(LM_FLASH, moe_groups=2)),
                ("recurrentgemma-2b", dict(LM_FLASH, window_size=16)),
                ("whisper-tiny", LM_FLASH),
                ("qwen2-vl-7b", LM_FLASH),
                ("gemma2-27b", dict(LM_FLASH, num_kv_heads=2, window_size=16,
                                    quantized_kv=True)))
# int8 KV caches: the card's K/V floats differ from the CPU's in the last
# bit (other matmul orders), so a value on a code's rounding edge can take
# the neighbouring code on one device; one code step (the head's amax /
# 127) in one cached value moves the decode logits by up to about 3.5e-4
# (tests/test_torch_kv_int8.py), so decode logits are held within 1e-3
# there and everything else within 1e-4
LM_TOL, LM_INT8_DECODE_TOL = 1e-4, 1e-3


def _launch_counts() -> dict:
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    return {**fk.LAUNCHES, **fa.LAUNCHES, **sk.LAUNCHES}


def _reset_launch_counts() -> None:
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    for mod in (fk, fa, sk):
        mod.reset_launch_counts()


def expected_launches(cfg, prompt_len: int) -> dict:
    """{kernel: (launches in prefill, launches per decode step)} on the
    card, from the model's layers: each attention layer that takes the
    flash path launches the flash kernel once per prefill (Whisper's
    encoder layers, decoder self-attention and cross-attention layers
    too) and each cross-attention layer once per decode step; each SSD
    layer launches its two kernels once per prefill; nothing else
    launches."""
    from repro_torch.models.attention import _use_flash

    counts = {k: (0, 0) for k in _launch_counts()}
    if cfg.is_encoder_decoder:
        t, n = cfg.encoder_seq_len, cfg.num_layers
        counts["flash_attention"] = (
            cfg.encoder_layers * _use_flash(cfg, t, t)
            + n * _use_flash(cfg, prompt_len, prompt_len)
            + n * _use_flash(cfg, prompt_len, t),
            n * _use_flash(cfg, 1, t))
        return counts
    blocks = cfg.all_blocks
    attn = sum(k in ("global", "local") for k in blocks)
    counts["flash_attention"] = (
        attn * _use_flash(cfg, prompt_len, prompt_len), 0)
    ssd = sum(k == "ssd" for k in blocks)
    counts["ssd_scores"] = counts["ssd_chunk"] = (ssd, 0)
    return counts


def family_inputs(cfg, batch: int, seed: int, device) -> dict:
    """The stubbed front ends' outputs, from a seeded generator on
    ``device`` in the activations' dtype: Whisper's audio frames
    (``frame_embeds`` [B, 1500, d]) or qwen2-vl's patch embeddings
    (``vision_embeds`` [B, 256, d]); {} for the other families."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    if cfg.is_encoder_decoder:
        shape, name = (batch, cfg.encoder_seq_len, cfg.d_model), \
            "frame_embeds"
    elif cfg.family == "vlm":
        shape, name = (batch, cfg.vision_patches, cfg.d_model), \
            "vision_embeds"
    else:
        return {}
    return {name: torch.randn(shape, generator=gen, device=device).to(dtype)}


def phase_reference_lm(devices=("cpu", "cuda"),
                       cases=LM_REFERENCE) -> None:
    """The smoke LMs of :data:`LM_REFERENCE` served greedily on the card
    and on the CPU with the same parameters and inputs (drawn on the CPU,
    copied to the card): equal tokens, logits within 1e-4 in f32 (int8
    caches: decode logits within :data:`LM_INT8_DECODE_TOL`).  The card
    launches what :func:`expected_launches` says in prefill and in each
    decode step, the CPU nothing.  Also run by
    ``tests/test_torch_cuda.py``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_lm_tokens
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.launch.steps import build_model
    from repro_torch.models.transformer import tree_map

    new_tokens, prompt_len = 16, 24
    for arch, over in cases:
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        params = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        prompts = torch.as_tensor(synthetic_lm_tokens(
            3, prompt_len, cfg.vocab_size, seed=1))
        extra = family_inputs(cfg, 3, 2, "cpu")
        runs = []
        for device in devices:
            model = build_model(cfg, device=device)
            p = tree_map(lambda t, device=device: t.to(device), params)
            marks = {}
            _reset_launch_counts()
            toks, logits = greedy_generate(
                model, p, prompts.to(device), new_tokens,
                mark=lambda name: marks.update({name: _launch_counts()}),
                **{k: v.to(device) for k, v in extra.items()})
            pre, end = marks["prefill"], marks["decode"]
            runs.append((toks.cpu(), [lg.cpu() for lg in logits],
                         {k: (pre[k], end[k] - pre[k]) for k in pre}))
        (tc, lc, _), (tg, lg, _) = runs
        err_prefill = float((lc[0] - lg[0]).abs().max())
        err_decode = max(float((a - b).abs().max())
                         for a, b in zip(lc[1:], lg[1:]))
        decode_tol = LM_INT8_DECODE_TOL if cfg.quantized_kv else LM_TOL
        want = expected_launches(cfg, prompt_len)
        launches = {d: {k: n for k, n in counts.items() if any(n)}
                    for d, (_, _, counts) in zip(devices, runs)}
        log("reference.lm", arch=arch, quantized_kv=cfg.quantized_kv,
            tokens_equal=bool(torch.equal(tc, tg)),
            logits_max_abs_err=max(err_prefill, err_decode),
            prefill_logits_max_abs_err=err_prefill,
            decode_logits_max_abs_err=err_decode, tol=LM_TOL,
            decode_tol=decode_tol, launches=launches,
            expected_card_launches={k: n for k, n in want.items() if any(n)})
        require(torch.equal(tc, tg), f"{arch}: card and CPU tokens equal")
        require(err_prefill <= LM_TOL,
                f"{arch}: card and CPU prefill logits within {LM_TOL}")
        require(err_decode <= decode_tol,
                f"{arch}: card and CPU decode logits within {decode_tol}")
        for device, (_, _, counts) in zip(devices, runs):
            on_card = torch.device(device).type == "cuda"
            for kernel, (pre, dec) in counts.items():
                wp, wd = want[kernel] if on_card else (0, 0)
                require((pre, dec) == (wp, wd * (new_tokens - 1)),
                        f"{arch}: {kernel} launches on {device}: prefill "
                        f"{pre}, decode {dec}; expected {wp} and "
                        f"{wd} x {new_tokens - 1}")


def serve(arch: str, cfg, spec: dict, device="cuda") -> dict:
    """One greedy generation through the port's serving entry points,
    with the kernel counts set to 0 just before it and read after
    prefill and after decode.  On the card the launches in prefill and
    in each decode step are those of :func:`expected_launches`; on the
    CPU (a rehearsal at a small size) nothing launches."""
    from repro_torch.data import synthetic_lm_tokens
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.launch.steps import build_model
    from repro_torch.models.transformer import param_bytes, param_count

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    prompts = torch.as_tensor(synthetic_lm_tokens(
        spec["batch"], spec["prompt_len"], cfg.vocab_size,
        seed=spec["seed"]), device=device)
    extra = family_inputs(cfg, spec["batch"], spec["seed"] + 1, device)
    t_tokens = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sync()
    t_init = time.perf_counter() - t0
    log(f"serve.{arch}.setup", params=param_count(params),
        params_bytes=param_bytes(params), init_s=t_init,
        prompt_tokens_s=t_tokens, layers=cfg.num_layers,
        encoder_layers=cfg.encoder_layers or None,
        inputs={k: list(v.shape) for k, v in extra.items()},
        dtype=cfg.dtype, attn_impl=cfg.attn_impl)

    marks = {}

    def mark(name):
        sync()
        marks[name] = (time.perf_counter(), _launch_counts())

    sync()
    _reset_launch_counts()
    t0 = time.perf_counter()
    toks, logits = greedy_generate(model, params, prompts,
                                   spec["new_tokens"], mark=mark, **extra)
    (t_pre, n_pre), (t_dec, n_dec) = marks["prefill"], marks["decode"]
    prefill_s, decode_s = t_pre - t0, t_dec - t_pre
    launches_decode = {k: n_dec[k] - n_pre[k] for k in n_dec}
    finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
    b, new = spec["batch"], spec["new_tokens"]
    want = expected_launches(cfg, spec["prompt_len"])
    summary = dict(
        batch=b, prompt_len=spec["prompt_len"], new_tokens=new,
        prefill_s=prefill_s, decode_s=decode_s,
        decode_ms_per_token=decode_s / (new - 1) * 1e3,
        prefill_tokens_per_s=b * spec["prompt_len"] / prefill_s,
        decode_tokens_per_s=b * (new - 1) / decode_s,
        tokens_per_s=b * new / (prefill_s + decode_s),
        peak_mem_bytes=torch.cuda.max_memory_allocated() if on_card
        else None,
        launches_prefill=n_pre, launches_decode=launches_decode,
        expected_launches={k: list(n) for k, n in want.items() if any(n)},
        logits_finite=finite, tokens=toks[:, :8].tolist())
    log(f"serve.{arch}", **summary)
    require(finite, f"{arch}: finite logits")
    require(tuple(toks.shape) == (b, new), f"{arch}: {new} tokens each")
    for kernel, (wp, wd) in want.items():
        wp, wd = (wp, wd * (new - 1)) if on_card else (0, 0)
        require(n_pre[kernel] == wp,
                f"{arch}: {wp} {kernel} launches in prefill, got "
                f"{n_pre[kernel]}")
        require(launches_decode[kernel] == wd,
                f"{arch}: {wd} {kernel} launches in decode, got "
                f"{launches_decode[kernel]}")
    summary.update(model=model, params=params, prompts=prompts)
    return summary


def phase_serve_family(phase: str, arch: str, depth, spec: dict,
                       device="cuda") -> dict:
    """One of :data:`FAMILY_SERVE`: ``arch`` at full width under
    ``dryrun_config`` (bf16, the flash path; the MoE family in 16 token
    groups), random weights from a seed, ``depth`` layers where given
    (the cut is logged), through :func:`serve`; the model and its
    parameters are freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import dryrun_config

    cfg = dryrun_config(get_config(arch))
    if depth is not None:
        log(f"serve.{phase}.cut", num_layers=cfg.num_layers, kept=depth)
        cfg = dataclasses.replace(cfg, num_layers=depth)
    run = serve(phase, cfg, spec, device)
    for key in ("model", "params", "prompts"):
        del run[key]
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return run


def phase_serve_gemma2() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import dryrun_config

    return serve("gemma2", dryrun_config(get_config("gemma2-27b")),
                 GEMMA_SERVE)


def phase_serve_mamba2() -> dict:
    from repro_torch.configs import get_config

    return serve("mamba2", get_config("mamba2-130m"), MAMBA_SERVE)


def _profiled(fn, ranges=(), match=()):
    """Run ``fn`` once under ``torch.profiler``: (its result, wall s, the
    device's busy s, kernel launches, the 8 kernels with the most device
    time; for each ``torch.profiler.record_function`` name in ``ranges``
    its calls and the device time of the kernels launched inside it; for
    each substring in ``match`` the device time and launches of the
    kernels whose name holds it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    # a range's own device-side annotation is no kernel
    kernels = [e for e in averages
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in kernels) * 1e-6
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return out, dict(
        wall_s=wall, device_busy_s=busy, device_busy_share=busy / wall,
        kernel_launches=sum(e.count for e in kernels),
        top=[dict(name=e.key[:80], launches=e.count,
                  device_s=e.self_device_time_total * 1e-6) for e in top],
        ranges={name: dict(
            calls=sum(e.count for e in averages if e.key == name
                      and e.device_type == DeviceType.CPU),
            device_s=sum(e.device_time_total for e in averages
                         if e.key == name
                         and e.device_type == DeviceType.CPU) * 1e-6)
            for name in ranges},
        kernels_matching={sub: dict(
            launches=sum(e.count for e in kernels if sub in e.key),
            device_s=sum(e.self_device_time_total for e in kernels
                         if sub in e.key) * 1e-6) for sub in match})


def phase_profile_serve(run: dict) -> None:
    """One more gemma2 prefill, then one decode step from its caches,
    each under ``torch.profiler``: the device's busy share, launches, and
    the kernels with the most device time."""
    from repro_torch.launch.serve import pad_cache
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    model, params, prompts = run["model"], run["params"], run["prompts"]
    prefill = make_prefill_step(model.cfg)
    step = make_serve_step(model.cfg)
    (logits, cache), pre = _profiled(
        lambda: prefill(params, {"tokens": prompts}))
    cache = pad_cache(model, cache, prompts.shape[1] + 1)
    tok = torch.argmax(logits, dim=-1)[:, None]
    _, dec = _profiled(lambda: step(params, cache, {
        "tokens": tok, "cache_index": prompts.shape[1]}))
    log("profile.serve", prefill=pre, decode_step=dec)


# ---------------------------------------------------------------------------
# LM training: the flash kernel's lse output, the steps card against CPU,
# and gemma-2b / mamba2-130m at full width
# ---------------------------------------------------------------------------

# the flash kernel with its lse output: (label, (B, H, Hkv, S, D), dtype,
# causal, window, soft-cap, scale): gemma-2b's training shape (one
# microbatch of 2 x 1024 tokens), a ragged f32 shape, and gemma2-27b's
# soft-capped global layer
FLASH_LSE = (
    ("gemma2b.train", (2, 8, 1, 1024, 256), torch.bfloat16, True, 0, 0.0,
     None),
    ("f32.ragged", (1, 4, 2, 300, 80), torch.float32, True, 0, 0.0, None),
    ("gemma2.global", (2, 32, 16, 4352, 128), torch.bfloat16, True, 0,
     GEMMA_CAP, GEMMA_SCALE),
)
# lse against the plain version, max abs: f32 2e-5 (TOL); bf16 2e-2
# (TOL) plus, under a soft-cap, cap x 5e-4: the kernel's tanh.approx is
# off by up to 2^-10.99 of |tanh| (about 4.9e-4), so a logit moves by up
# to cap x 4.9e-4 and the lse, a p-weighted mean of its logits' moves, by
# no more (0.0245 at cap 50)
LSE_CAP_TOL = 5e-4
# card against CPU in reference.train: losses, params and (relative to
# each leaf's largest) grads, f32
TRAIN_TOL = 1e-4
# reference.train: (arch, config overrides, microbatch, remat)
TRAIN_REFERENCE = (("gemma-2b", LM_FLASH, 2, True),
                   ("mamba2-130m", {}, 1, True))
# train.gemma2b: make_train_step at gemma-2b's full width on one
# repeated batch of 4 x 1024 tokens, 2 microbatches, remat
GEMMA_TRAIN = dict(batch=4, seq=1024, microbatch=2, steps=3, lr=1e-2,
                   seed=5)
# fl_round.gemma2b: K = 2 clients of 2 x 512 tokens, 4 local steps, lr
# 1e-2, coefficients from LROA over 16 clients (examples/
# lm_federated_torch.py), 2 rounds
FL_ROUND = dict(devices=16, clients=2, local_batch=2, seq=512,
                local_steps=4, lr=1e-2, rounds=2)
# train.mamba2: launch/train.py at mamba2-130m's full config, 4 steps,
# then resumed to 6
MAMBA_TRAIN = dict(batch=4, seq=2048, lr=0.3)


def phase_flash_lse(flush, hbm: float, f32_peak: float,
                    bf16_peak: float) -> list:
    """The flash kernel with its ``lse`` output at :data:`FLASH_LSE`:
    ``lse`` against ``ref.mha_reference(return_lse=True)``, ``out``
    against its plain version under :data:`FLASH_TOL`
    (:func:`flash_agreement`) and bitwise ``out`` without ``lse``, the
    kernel's time with and
    without ``lse``, the plain version's, SDPA's where the point has no
    soft-cap or window."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = []
    for label, (b, h, hkv, s, d), dtype, causal, window, cap, scale \
            in FLASH_LSE:
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for shape in ((b, h, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d)))
        kw = dict(causal=causal, window=window, softcap=cap, scale=scale)
        out_serving = fa.flash_attention_cuda(q, k, v, **kw)
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        want_out, want_lse = ref.mha_reference(q, k, v, return_lse=True,
                                               **kw)
        torch.cuda.synchronize()
        tol = TOL[dtype] + (LSE_CAP_TOL * cap if dtype == torch.bfloat16
                            else 0.0)
        err = float((lse - want_lse).abs().max())
        bitwise = bool(torch.equal(out, out_serving))
        agree = flash_agreement(out, want_out)
        del out_serving, want_out, want_lse
        nbytes = (2 * (b * h * s * d + b * hkv * s * d) * q.element_size()
                  + b * h * s * 4)
        flops = fa.flash_attention_flops(b, h, d, s, s, causal, window)
        bound_ms, bound_by = _bound(
            nbytes, flops, hbm,
            bf16_peak if dtype == torch.bfloat16 else f32_peak)
        library_ms = None
        if cap == 0 and window == 0:
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale, enable_gqa=True),
                iters=10, flush=flush)
        row = dict(
            label=label, shape=[b, h, hkv, s, s, d], dtype=_dname(dtype),
            causal=causal, window=window, softcap=cap, lse_tol=tol,
            max_abs_err=err,
            **{f"out_{k_}": v_ for k_, v_ in agree.items() if k_ != "ok"},
            out_bitwise_equal_without_lse=bitwise,
            ms=time_ms(lambda: fa.flash_attention_cuda(
                q, k, v, return_lse=True, **kw), iters=10, flush=flush),
            ms_without_lse=time_ms(lambda: fa.flash_attention_cuda(
                q, k, v, **kw), iters=10, flush=flush),
            plain_ms=time_ms(lambda: ref.mha_reference(
                q, k, v, return_lse=True, **kw),
                iters=3 if s > 1024 else 10, flush=flush),
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            gflop=flops * 1e-9, mbytes=nbytes * 1e-6)
        row["lse_cost"] = row["ms"] / row["ms_without_lse"] - 1.0
        log("kernel.flash_lse", **row)
        require(err <= tol, f"flash lse within {tol} of the plain version "
                            f"at {label} (err {err})")
        require(agree["ok"], f"flash out with lse disagrees with the plain "
                             f"version at {label} "
                             f"({_flash_disagreement(agree)})")
        require(bitwise, f"flash out with lse is bitwise out without it at "
                         f"{label}")
        rows.append(row)
        del q, k, v, out, lse
    torch.cuda.empty_cache()
    return rows


def _train_batches(cfg, steps: int, batch: int, seq: int, seed: int,
                   device) -> list:
    """``steps`` batches of next-token pairs from the synthetic corpus."""
    from repro_torch.data import synthetic_lm_tokens

    toks = torch.as_tensor(synthetic_lm_tokens(
        steps * batch, seq + 1, cfg.vocab_size, seed=seed), device=device)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]}
            for t in toks.reshape(steps, batch, seq + 1)]


def _leaves(tree) -> list:
    from repro_torch.tree import tree_leaves
    return list(tree_leaves(tree))


def _grads_ok(grads) -> bool:
    """Every leaf's gradient present, finite and not all zero."""
    return all(g is not None and bool(torch.isfinite(g).all())
               and bool((g != 0).any()) for g in grads)


def _copy_to(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device, copy=True), tree)


def phase_reference_train(devices=("cpu", "cuda")) -> None:
    """The training steps on the card against the CPU from the same
    seeded parameters and batches (f32 smoke configs): ``make_train_step``
    at gemma-2b with the flash path (remat, 2 microbatches) and at
    mamba2-130m (remat), two steps each; ``make_fl_round_step`` at
    gemma-2b, K = 2, given coefficients.  Losses, parameters and every
    leaf's gradient within :data:`TRAIN_TOL`; every leaf's gradient
    present, finite and nonzero on each device (a kernel output cut from
    the graph would leave them missing or zero); the card's flash and SSD
    launches as the layers, remat and microbatches give them, one
    ``fl_aggregate`` launch per FL round.  Also run by
    ``tests/test_torch_cuda.py``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import (build_model, make_fl_round_step,
                                          make_loss_fn, make_train_step,
                                          value_and_grad)
    from repro_torch.optim import SGD

    for arch, over, micro, remat in TRAIN_REFERENCE:
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        params0 = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        batches0 = _train_batches(cfg, 2, 4, 32, 4, "cpu")
        runs = []
        for device in devices:
            params = _copy_to(params0, device)
            batches = [{k: v.to(device) for k, v in b.items()}
                       for b in batches0]
            _, grads = value_and_grad(make_loss_fn(build_model(cfg, device)),
                                      params, batches[0])
            require(_grads_ok(grads), f"{arch} on {device}: every leaf's "
                                      f"grad present, finite and nonzero")
            step = make_train_step(cfg, lr=0.1, remat=remat,
                                   microbatch=micro, device=device)
            state = SGD(momentum=0.9).init(params)
            _reset_launch_counts()
            losses = []
            for b in batches:
                params, state, m = step(params, state, b)
                losses.append(float(m["loss"]))
            runs.append((losses, [t.cpu() for t in _leaves(params)],
                         [g.cpu() for g in grads], _launch_counts()))
        (lc, pc, gc_, _), (lg, pg, gg, n_card) = runs
        loss_err = max(abs(a - b) for a, b in zip(lc, lg))
        param_err = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
        grad_err = max(float((a - b).abs().max() / a.abs().max().clamp_min(
            1e-30)) for a, b in zip(gc_, gg))
        layers = cfg.all_blocks
        per_pass = (2 if remat else 1) * (
            torch.device(devices[1]).type == "cuda")
        want = {"flash_attention": sum(kd in ("global", "local")
                                       for kd in layers),
                "ssd_scores": sum(kd == "ssd" for kd in layers),
                "ssd_chunk": sum(kd == "ssd" for kd in layers)}
        want = {kn: n * per_pass * micro * len(batches0)
                for kn, n in want.items()}
        want["flash_attention_lse"] = want["flash_attention"]
        log("reference.train", arch=arch, microbatch=micro, remat=remat,
            leaves=len(pc), losses_cpu=lc, losses_card=lg,
            loss_max_abs_err=loss_err, param_max_abs_err=param_err,
            grad_max_rel_err=grad_err, tol=TRAIN_TOL,
            card_launches={k: n for k, n in n_card.items() if n},
            expected_card_launches=want)
        require(loss_err <= TRAIN_TOL and param_err <= TRAIN_TOL
                and grad_err <= TRAIN_TOL,
                f"{arch}: card and CPU train steps within {TRAIN_TOL}")
        for kernel, n in want.items():
            require(n_card[kernel] == n, f"{arch}: {n} {kernel} launches "
                                         f"on the card, got {n_card[kernel]}")

    cfg = dataclasses.replace(get_smoke_config("gemma-2b"), **LM_FLASH)
    params0 = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    b0 = _train_batches(cfg, 2, 2, 32, 7, "cpu")
    batch0 = {"tokens": torch.stack([b["tokens"] for b in b0]),
              "labels": torch.stack([b["labels"] for b in b0]),
              "coeffs": torch.tensor([0.6, 0.45])}
    runs = []
    for device in devices:
        step = make_fl_round_step(cfg, 2, lr=0.1, local_steps=2,
                                  device=device)
        _reset_launch_counts()
        new, m = step(_copy_to(params0, device),
                      {k: v.to(device) for k, v in batch0.items()})
        runs.append((float(m["loss"]), [t.cpu() for t in _leaves(new)],
                     _launch_counts()))
    (lc, pc, _), (lg, pg, n_card) = runs
    param_err = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    attn = sum(kd in ("global", "local") for kd in cfg.all_blocks)
    log("reference.fl_round", arch="gemma-2b", clients=2, local_steps=2,
        loss_cpu=lc, loss_card=lg, loss_abs_err=abs(lc - lg),
        param_max_abs_err=param_err, tol=TRAIN_TOL,
        card_launches={k: n for k, n in n_card.items() if n})
    require(abs(lc - lg) <= TRAIN_TOL and param_err <= TRAIN_TOL,
            f"FL round: card and CPU within {TRAIN_TOL}")
    on_card = torch.device(devices[1]).type == "cuda"
    require(n_card["fl_aggregate"] == on_card and
            n_card["flash_attention"] == 2 * 2 * attn * on_card,
            f"FL round: one fl_aggregate launch and {4 * attn} flash "
            f"launches on the card, got {n_card}")


@torch.no_grad()
def _functional_sgd_step_(opt, grads, state, params, lr) -> None:
    """``SGD.step_``'s numbers by the functional path: ``update`` and
    ``apply_updates`` over whole trees, then copied into place."""
    from repro_torch.optim.sgd import apply_updates

    updates, new_state = opt.update(grads, state, params, lr)
    new_params = apply_updates(params, updates)
    del updates
    for old, new in zip(_leaves(params) + _leaves(state),
                        _leaves(new_params) + _leaves(new_state)):
        old.copy_(new)


def _step_peak(run, functional_sgd: bool = False):
    """Peak bytes allocated over ``run()``, with ``SGD.step_`` as the
    steps do it (in place, leaf by leaf) or, with ``functional_sgd``, as
    the functional path does it: ``update`` and then ``apply_updates``
    over whole trees, the old and new parameters and momentum alive at
    once, the result then copied into place.  The difference is what the
    in-place update saves.  Returns (the peak, or None if ``run()`` runs
    out of memory; the kernels' launches in ``run()``)."""
    from unittest import mock

    from repro_torch.optim import SGD

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    try:
        if functional_sgd:
            with mock.patch.object(SGD, "step_", _functional_sgd_step_):
                run()
        else:
            run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError:
        peak = None
    return peak, _launch_counts()


def phase_train_gemma2b(cfg=None, spec: dict = GEMMA_TRAIN,
                        device="cuda") -> dict:
    """``make_train_step(remat=True, microbatch=2)`` at gemma-2b's full
    width (``dryrun_config``: bf16, flash) on one repeated batch of 4 x
    1024 tokens, :data:`GEMMA_TRAIN`: the loss finite and falling, 72
    flash launches a step (18 layers x forward and remat's recompute x 2
    microbatches), each with lse, step time, tokens/s, peak memory, then
    one more step under ``torch.profiler`` (busy share; the plain flash
    backward's device time from its profiler range, the flash kernel's
    from its name), then one step's peak memory with the in-place SGD
    update and one with the functional path (:func:`_step_peak`).  Returns the model and the trained parameters for
    :func:`phase_fl_round_gemma2b`.  ``cfg``, ``spec`` and ``device``:
    a rehearsal on the CPU at a small size (no launches, no profile)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (build_model, dryrun_config,
                                          make_train_step)
    from repro_torch.models.flash import BACKWARD_RANGE
    from repro_torch.models.transformer import param_bytes, param_count
    from repro_torch.optim import SGD

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = cfg or dryrun_config(get_config("gemma-2b"))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sync()
    log("train.gemma2b.setup", params=param_count(params),
        params_bytes=param_bytes(params), init_s=time.perf_counter() - t0,
        layers=cfg.num_layers, d_model=cfg.d_model, heads=cfg.num_heads,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, dtype=cfg.dtype,
        attn_impl=cfg.attn_impl)
    batch = _train_batches(cfg, 1, spec["batch"], spec["seq"], spec["seed"],
                           device)[0]
    step = make_train_step(cfg, lr=spec["lr"], remat=True,
                           microbatch=spec["microbatch"], device=device)
    state = SGD(momentum=0.9).init(params)
    want = cfg.num_layers * 2 * spec["microbatch"] if on_card else 0
    losses, seconds = [], []
    for _ in range(spec["steps"]):
        sync()
        _reset_launch_counts()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        seconds.append(time.perf_counter() - t0)
        n = _launch_counts()
        require(n["flash_attention"] == want and
                n["flash_attention_lse"] == want,
                f"gemma-2b train step: {want} flash launches with lse, got "
                f"{n['flash_attention']} ({n['flash_attention_lse']})")
    tokens = spec["batch"] * spec["seq"]
    median = statistics.median(seconds)
    summary = dict(
        **{k: spec[k] for k in ("batch", "seq", "microbatch", "lr")},
        losses=losses, step_s=seconds, step_s_median=median,
        tokens_per_s=tokens / median,
        peak_mem_bytes=torch.cuda.max_memory_allocated() if on_card
        else None, launches_per_step=want)
    if on_card:
        (params, state, m), prof = _profiled(
            lambda: step(params, state, batch), ranges=(BACKWARD_RANGE,),
            match=("flash_fwd",))
        losses.append(float(m["loss"]))
        bwd = prof["ranges"][BACKWARD_RANGE]
        summary.update(
            profiled_step=prof, flash_backward_device_s=bwd["device_s"],
            flash_backward_calls=bwd["calls"],
            flash_backward_share_of_step=bwd["device_s"] / prof["wall_s"],
            flash_forward_device_s=prof["kernels_matching"]["flash_fwd"][
                "device_s"])
        require(bwd["calls"] == cfg.num_layers * spec["microbatch"],
                f"gemma-2b: {cfg.num_layers * spec['microbatch']} flash "
                f"backward calls in the profiled step, got {bwd['calls']}")
        # one more step each way: the in-place update's saving
        for key, functional in (("peak_step_bytes", False),
                                ("peak_step_bytes_functional_sgd", True)):
            summary[key], n = _step_peak(
                lambda: step(params, state, batch), functional)
            require(summary[key] is None or n["flash_attention"] == want,
                    f"gemma-2b train step ({key}): {want} flash launches, "
                    f"got {n['flash_attention']}")
    log("train.gemma2b", **summary)
    require(all(np.isfinite(losses)), "gemma-2b: finite losses")
    require(losses[-1] < losses[0], f"gemma-2b: the loss falls on the "
                                    f"repeated batch ({losses})")
    steps = spec["steps"] + 3 * on_card
    summary["launches"] = {"flash_attention": want * steps,
                           "flash_attention_lse": want * steps}
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return dict(summary, model=model, params=params)


def phase_fl_round_gemma2b(model, params, spec: dict = FL_ROUND) -> dict:
    """``make_fl_round_step`` at gemma-2b's full width (:data:`FL_ROUND`):
    each round LROA decides q over 16 clients from the channel, K = 2 are
    drawn and weighted ``w / (K q)`` as ``examples/lm_federated_torch.py``
    does, each trains 4 local steps on 2 x 512 tokens; exactly one
    ``fl_aggregate`` launch per round and table of leaves, 144 flash
    launches (2 clients x 4 steps x 18 layers); round time, peak
    memory, and the peak of one more round with the functional SGD path
    (:func:`_step_peak`); then the eq.-(4) step at the model's leaves
    timed beside its bound (:func:`_aggregate_at_leaves`,
    ``kernel.aggregate_gemma2b``).
    On the CPU (a rehearsal) nothing launches and nothing is timed."""
    from repro_torch.core import (LROAController, estimate_hyperparams,
                                  paper_default_params)
    from repro_torch.data import synthetic_lm_tokens
    from repro_torch.fl import ChannelConfig, ChannelProcess, sample_clients
    from repro_torch.fl.server import aggregation_weights
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.launch.steps import make_fl_round_step
    from repro_torch.models.transformer import param_count

    cfg, device = model.cfg, model.device
    on_card = torch.device(device).type == "cuda"
    n, k = spec["devices"], spec["clients"]
    shards = [synthetic_lm_tokens(spec["local_batch"], spec["seq"] + 1,
                                  cfg.vocab_size, seed=100 + i)
              for i in range(n)]
    sizes = np.asarray([s.size for s in shards], np.float32)
    sys_params = paper_default_params(num_devices=n, data_sizes=sizes,
                                      model_params=param_count(params),
                                      device=device)
    controller = LROAController(sys_params, estimate_hyperparams(
        sys_params, 0.1, loss_scale=5.0))
    channel = ChannelProcess(n, ChannelConfig(seed=0))
    w = sys_params.data_weights.cpu().numpy()
    rng = np.random.default_rng(0)
    step = make_fl_round_step(cfg, k, lr=spec["lr"],
                              local_steps=spec["local_steps"], device=device)
    leaves = _leaves(params)
    tables = (-(-len(leaves) // fk._library().fl_aggregate_max_segments())
              if on_card else 0)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rounds = []
    for t in range(spec["rounds"]):
        h = torch.as_tensor(channel.sample(), dtype=torch.float32,
                            device=device)
        dec = controller.decide(h)
        q = dec.q.cpu().numpy()
        selected = sample_clients(rng, q, k)
        coeffs = aggregation_weights(selected, q, w, k)
        toks = torch.as_tensor(np.stack([shards[i] for i in selected]),
                               device=device)
        batch = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:],
                 "coeffs": torch.as_tensor(coeffs, device=device)}
        if on_card:
            torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        params, m = step(params, batch)
        loss = float(m["loss"])
        seconds = time.perf_counter() - t0
        controller.step_queues(h, dec)
        launches = _launch_counts()
        rounds.append(dict(round=t, selected=selected.tolist(),
                           coeffs=coeffs.tolist(), loss=loss,
                           seconds=seconds, launches={
                               kn: v for kn, v in launches.items() if v}))
        require(np.isfinite(loss), "FL round at gemma-2b: finite loss")
        require(launches["fl_aggregate"] == tables,
                f"FL round: {tables} fl_aggregate launch(es) (one per table "
                f"of {len(leaves)} leaves), got {launches['fl_aggregate']}")
        want = k * spec["local_steps"] * cfg.num_layers * on_card
        require(launches["flash_attention"] == want,
                f"FL round: {want} flash launches, got "
                f"{launches['flash_attention']}")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    extra, rounds_run = {}, spec["rounds"]
    if on_card:
        # the last round's clients once more with the functional SGD path
        # (its result dropped): the in-place update's saving
        peak_functional, extra = _step_peak(lambda: step(params, batch),
                                            True)
        rounds_run = spec["rounds"] + 1
        require(peak_functional is None or extra["fl_aggregate"] == tables,
                f"FL round (functional SGD): {tables} fl_aggregate "
                f"launch(es), got {extra['fl_aggregate']}")
        aggregate = _aggregate_at_leaves(_leaves(params), k, rounds[-1][
            "coeffs"])
        log("kernel.aggregate_gemma2b", **aggregate)
    summary = dict(**spec, leaves=len(leaves), tables=tables,
                   round_log=rounds,
                   round_s=[r["seconds"] for r in rounds],
                   peak_mem_bytes=peak,
                   launches={"fl_aggregate": tables * rounds_run,
                             **{kn: sum(r["launches"].get(kn, 0)
                                        for r in rounds) + extra.get(kn, 0)
                                for kn in ("flash_attention",
                                           "flash_attention_lse")}})
    if on_card:
        summary.update(aggregate=aggregate,
                       peak_mem_bytes_functional_sgd=peak_functional)
    log("fl_round.gemma2b", **{k_: v for k_, v in summary.items()
                               if k_ != "round_log"})
    for r in rounds:
        log("fl_round.gemma2b.round", **r)
    return summary


def _aggregate_at_leaves(thetas: list, k: int, coeffs: list) -> dict:
    """The round's eq.-(4) step at gemma-2b's leaves (bf16 thetas and
    seeded bf16 deltas, the last round's coefficients): one
    ``ops.fl_aggregate_leaves`` call, bitwise its order of arithmetic
    (``ref.aggregate_leaves_fma_reference``) and within TOL[bf16] of the
    plain per-leaf version, timed after a clean L2 flush beside its
    bound (each theta and delta read once, each output written once).
    The deltas (1e-3, the thetas about 0.01-0.05) move most elements by
    an ulp or more, which the run counts (``changed_share``), so that a
    kernel dropping them fails the bitwise check."""
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ops, ref

    hbm, f32_peak, _ = peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    deltas = [(1e-3 * torch.randn((k,) + tuple(t.shape), device="cuda",
                                  generator=gen)).to(t.dtype)
              for t in thetas]
    c = torch.tensor(coeffs, dtype=torch.float32, device="cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def call():
        return ops.fl_aggregate_leaves(thetas, deltas, c)

    before = fk.LAUNCHES["fl_aggregate"]
    out = call()
    launches = fk.LAUNCHES["fl_aggregate"] - before
    want = ref.aggregate_leaves_reference(thetas, deltas, c)
    torch.cuda.synchronize()
    tol = TOL[torch.bfloat16]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(out, want))
    close = all(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)
                for a, b in zip(out, want))
    del want
    # the fma order in f64 (ref.fma_f32) over pieces of 2^26 elements, so
    # that its temporaries stay small beside the 524M-element embedding
    bitwise_fma, piece = True, 2 ** 26
    for theta, d, o in zip(thetas, deltas, out):
        theta, d, o = theta.reshape(-1), d.reshape(k, -1), o.reshape(-1)
        for a in range(0, theta.numel(), piece):
            exact = ref.aggregate_leaves_fma_reference(
                [theta[a:a + piece]], [d[:, a:a + piece]], c)[0]
            bitwise_fma &= bool(torch.equal(o[a:a + piece], exact))
    n = sum(t.numel() for t in thetas)
    changed = sum(int((o != t).sum()) for o, t in zip(out, thetas)) / n
    del out
    nbytes = _leaf_bytes(thetas, deltas) + 4 * k
    bound_ms, bound_by = _bound(nbytes, 2 * k * n, hbm, f32_peak)
    row = dict(leaves=len(thetas), n=n, k=k, dtype="bfloat16",
               launches=launches, tol=tol, max_abs_err=err,
               bitwise_equal_to_fma_order=bitwise_fma,
               changed_share=changed,
               ms=time_ms(call, iters=10, flush=flush, clean=True),
               plain_ms=time_ms(lambda: ref.aggregate_leaves_reference(
                   thetas, deltas, c), iters=3, flush=flush, clean=True),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               mbytes=nbytes * 1e-6, flush="clean")
    row["bound_share"] = bound_ms / row["ms"]
    require(close, f"eq. (4) at gemma-2b's leaves: the kernel within {tol} "
                   f"of the plain version (err {err})")
    require(bitwise_fma, "eq. (4) at gemma-2b's leaves: the kernel is "
                         "bitwise its order of arithmetic "
                         "(ref.aggregate_leaves_fma_reference)")
    require(changed > 0.5, f"eq. (4) at gemma-2b's leaves: the deltas move "
                           f"most elements (moved {changed:.3f})")
    require(launches == -(-len(thetas)
                          // fk._library().fl_aggregate_max_segments()),
            f"eq. (4) at gemma-2b's leaves: one launch per table, got "
            f"{launches}")
    del deltas, flush
    torch.cuda.empty_cache()
    return row


def phase_train_mamba2(spec: dict = MAMBA_TRAIN, device="cuda") -> dict:
    """``launch/train.main`` at mamba2-130m's full config
    (:data:`MAMBA_TRAIN`): 4 steps with checkpoints at 2 and 4, then the
    driver again with ``--steps 6``, which resumes from step 4.  The SSD
    kernels run in every forward (24 launches of each a step); the
    resumed run reaches step 6 with a finite loss; and it started from
    the saved step-4 parameters with fresh momentum, as the JAX driver
    does: two steps of ``make_train_step`` from the step-4 checkpoint
    with a zero momentum, on the batches the resumed driver read, give
    its parameters and momentum bitwise."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import lm_batches, synthetic_lm_tokens
    from repro_torch.launch import train as driver
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import SGD

    on_card = torch.device(device).type == "cuda"
    cfg = (get_config if spec.get("full", True) else get_smoke_config)(
        "mamba2-130m")
    ssd_layers = sum(kd == "ssd" for kd in cfg.all_blocks) * on_card
    with tempfile.TemporaryDirectory() as ckdir:
        argv = ["--arch", "mamba2-130m", "--batch", str(spec["batch"]),
                "--seq", str(spec["seq"]), "--lr", str(spec["lr"]),
                "--ckpt-every", "2", "--log-every", "1", "--ckpt-dir", ckdir,
                "--device", str(device)]
        if spec.get("full", True):
            argv.append("--full-config")
        runs = {}
        for steps in (4, 6):
            if on_card:
                torch.cuda.synchronize()
            _reset_launch_counts()
            t0 = time.perf_counter()
            run = driver.main(argv + ["--steps", str(steps)])
            if on_card:
                torch.cuda.synchronize()
            run["seconds"] = time.perf_counter() - t0
            run["launches"] = {k: v for k, v in _launch_counts().items()
                               if v}
            runs[steps] = run
            done = steps - run["start"]
            for kernel in ("ssd_scores", "ssd_chunk"):
                require(run["launches"].get(kernel, 0) == done * ssd_layers,
                        f"mamba2 driver: {done * ssd_layers} {kernel} "
                        f"launches, got {run['launches'].get(kernel)}")
        resumed = runs[6]
        require(runs[4]["start"] == 0 and resumed["start"] == 4,
                "mamba2 driver: the second run resumes from step 4")
        require(np.isfinite(resumed["loss"]),
                "mamba2 driver: finite loss at step 6")
        params, _ = restore_checkpoint(ckdir, "step_4", resumed["params"])
    # the driver's batches: its corpus and iterator, from the first batch
    toks = synthetic_lm_tokens(max(spec["batch"] * 16, 64), spec["seq"] + 1,
                               cfg.vocab_size, seed=0)
    batches = lm_batches(toks, spec["batch"], seed=1)
    step = make_train_step(cfg, lr=spec["lr"], remat=False, device=device)
    state = SGD(momentum=0.9).init(params)
    for _ in range(2):
        b = {k: torch.as_tensor(v, device=device)
             for k, v in next(batches).items()}
        params, state, _ = step(params, state, b)
    same_params = all(torch.equal(a, b) for a, b in zip(
        _leaves(params), _leaves(resumed["params"])))
    same_momentum = all(torch.equal(a, b) for a, b in zip(
        _leaves(state), _leaves(resumed["opt_state"])))
    out = dict(
        **spec, run_s={str(s): r["seconds"] for s, r in runs.items()},
        losses={str(s): [r["loss0"], r["loss"]] for s, r in runs.items()},
        start_of_resumed=resumed["start"],
        launches={str(s): r["launches"] for s, r in runs.items()},
        resumed_equals_fresh_momentum_replay=same_params and same_momentum)
    log("train.mamba2", **out)
    require(same_params and same_momentum,
            "mamba2 driver: the resumed run is bitwise two steps from the "
            "step-4 checkpoint with fresh momentum")
    out["launches"] = {k: sum(r["launches"].get(k, 0)
                              for r in runs.values())
                       for k in ("ssd_scores", "ssd_chunk")}
    del runs, resumed, params, state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


# -- client- and lane-axis sharding (launch.mesh, torch.distributed) ---------

# the sharded phases: ranks of the gloo world on the one card (NCCL
# refuses two ranks on one device; the one-rank world runs NCCL), the
# deadline on each world's rendezvous, every collective and the join, and
# the rounds of shard.main and shard.arena
SHARD_RANKS = 2
SHARD_TIMEOUT = 600.0
SHARD_ROUNDS = 2
# the reference's sharded-against-unsharded tolerances: the round's params
# and losses (tests/test_client_bank.py:214-216); the arena's params, and
# its metrics and queues (rtol, atol; tests/test_arena.py:1049-1056)
SHARD_ROUND_TOL = 1e-6
SHARD_ARENA_TOL = (1e-6, 1e-5, 1e-4)
# reference.shard's selections on TIERED (12 clients, 6 rows a rank on one
# bucket; rungs of 4, 3 and 5 clients, the first split over the ranks):
# each rank has a slot whose row the other holds, and the ladder's
# selection hits all three rungs
SHARD_SEL = {"single": [11, 2, 7, 0], "ladder": [10, 3, 0, 6]}
SHARD_COEFFS = [0.2, 0.3, 0.1, 0.4]
# shard.arena: the seven controllers and LROA at a second seed
SHARD_ARENA_SEEDS = [0] * 7 + [1]
# shard.main's banks: the single bucket, whose N = 120 rows split over 2
# ranks, and the trainer's default ladder, whose rungs of 41, 59, 19 and
# 1 clients do not, so the reference's rule holds them whole on every
# rank and each rank gathers its own slots' rows with no exchange
SHARD_MAIN_BANKS = ("single", "auto")
# shard.main's limit on the sharded trainer's params against the unsharded
# trainer's (main, main.single) after each round: above the sound
# readings and below the error that one rank's partial dropped from the
# first round's all-reduce leaves, both printed by every run (PERF.md
# section 6)
SHARD_MAIN_TOL = 5e-3


def _device_sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _digest(tree) -> str:
    """sha1 of a params dict's names and bytes (bitwise equality across
    ranks without shipping the params)."""
    import hashlib

    h = hashlib.sha1()
    for name in sorted(tree):
        v = tree[name].detach().cpu().contiguous()
        h.update(name.encode())
        h.update(v.view(torch.uint8).numpy().tobytes() if v.numel() else b"")
    return h.hexdigest()


def _max_err(a: dict, b: dict) -> float:
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


class _PartialTap:
    """Records every ``ops.fl_delta_reduce_leaves`` call of the block (its
    deltas, coefficients and the partials it wrote, before the all-reduce
    sums them in place), so each rank's partial is held afterwards against
    the kernel's order of arithmetic
    (``ref.aggregate_leaves_fma_reference(None, ...)``)."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.calls = ops, []
        self.orig = ops.fl_delta_reduce_leaves

        def tapped(deltas, coeffs, outs, impl="auto"):
            got = self.orig(deltas, coeffs, outs=outs, impl=impl)
            self.calls.append(([d.clone() for d in deltas], coeffs.clone(),
                               [g.clone() for g in got]))
            return got

        ops.fl_delta_reduce_leaves = tapped
        return self

    def __exit__(self, *exc) -> bool:
        self.ops.fl_delta_reduce_leaves = self.orig
        return False

    def bitwise(self) -> bool:
        from repro_torch.kernels import ref

        return bool(self.calls) and all(
            all(torch.equal(g, w) for g, w in zip(
                got, ref.aggregate_leaves_fma_reference(None, d, c)))
            for d, c, got in self.calls)


def _shard_reference(mesh, device: str) -> dict:
    """reference.shard on one rank: the TIERED testbed's sharded round
    (single bucket, ladder, hierarchical over 2 clusters), a two-round
    LROA ``run_scan`` on the ladder and a four-lane ``Arena.run`` over two
    rounds with the lanes split over the mesh, each beside the unsharded
    port on the same card; params digests for the cross-rank check."""
    import repro_torch.core as core
    from repro_torch.fl import ClientConfig, RoundEngine
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.sim import Arena, ScenarioGrid

    cfg = TIERED
    data = make_data(cfg)
    task = make_task(cfg)
    ccfg = ClientConfig(local_epochs=cfg["local_epochs"],
                        batch_size=cfg["batch_size"])
    eng = RoundEngine(task, ccfg, device=device, mesh=mesh)
    one = RoundEngine(task, ccfg, device=device)
    p0 = {n: v.to(device) for n, v in
          task.init(torch.Generator().manual_seed(7)).items()}

    def fresh():
        return {n: v.clone() for n, v in p0.items()}

    coeffs = np.asarray(SHARD_COEFFS, np.float32)
    out = {"rounds": {}}
    with _PartialTap() as tap:
        for case, sel, kw in (
                ("single", SHARD_SEL["single"], dict(tiered="single")),
                ("ladder", SHARD_SEL["ladder"], dict(tiered="tiered")),
                ("hierarchical", SHARD_SEL["single"],
                 dict(tiered="single", clusters=2))):
            bank = eng.make_bank(data["clients"], **kw)
            plain = one.make_bank(data["clients"], **kw)
            keys = torch.rand(
                (len(sel), cfg["local_epochs"], bank.bucket_examples),
                generator=torch.Generator().manual_seed(11)).to(device)
            hier = case == "hierarchical"
            before = fk.LAUNCHES["fl_delta_reduce"]
            ps, ls = eng.round_step(fresh(), bank, sel, coeffs, cfg["lr"],
                                    keys, hierarchical=hier)
            _device_sync()
            launches = fk.LAUNCHES["fl_delta_reduce"] - before
            p1, l1 = one.round_step(fresh(), plain, sel, coeffs, cfg["lr"],
                                    keys, hierarchical=hier)
            rungs = getattr(bank, "tiers", [bank])
            out["rounds"][case] = dict(
                digest=_digest(ps), param_max_abs_err=_max_err(ps, p1),
                loss_max_abs_err=float((ls - l1).abs().max()),
                bitwise=all(torch.equal(ps[n], p1[n]) for n in ps)
                and torch.equal(ls, l1),
                fl_delta_reduce_launches=launches,
                tiers_hit=_tiers_hit(plain, sel),
                rows_held=[r.rows_held for r in rungs],
                nbytes=bank.nbytes, unsharded_nbytes=plain.nbytes)
        sp = core.paper_default_params(
            num_devices=cfg["num_devices"], sample_count=cfg["sample_count"],
            local_epochs=cfg["local_epochs"], data_sizes=data["sizes"],
            device=device)
        hp = core.estimate_hyperparams(sp, 0.1, loss_scale=1.5, mu=1.0,
                                       nu=1e5)
        h = np.random.default_rng(5).uniform(
            0.05, 0.4, (SHARD_ROUNDS, cfg["num_devices"])).astype(np.float32)
        lr = np.full(SHARD_ROUNDS, cfg["lr"], np.float32)
        scans = []
        for e in (eng, one):
            before = fk.LAUNCHES["fl_delta_reduce"]
            p, q, met = e.run_scan(fresh(), sp, e.make_bank(data["clients"]),
                                   h, lr, torch.Generator().manual_seed(3),
                                   policy="lroa", V=hp.V, lam=hp.lam)
            _device_sync()
            scans.append((p, q.cpu().numpy(), met,
                          fk.LAUNCHES["fl_delta_reduce"] - before))
        (ps, qs, ms, launches), (p1, q1, m1, _) = scans
        out["scan"] = dict(
            digest=_digest(ps), param_max_abs_err=_max_err(ps, p1),
            selections_equal=bool(np.array_equal(ms["selected"],
                                                 m1["selected"])),
            metric_max_abs_err={n: float(np.abs(ms[n] - m1[n]).max())
                                for n in m1 if n != "selected"},
            metrics_close=all(np.allclose(ms[n], m1[n],
                                          rtol=SHARD_ARENA_TOL[1],
                                          atol=SHARD_ARENA_TOL[2])
                              for n in m1 if n != "selected"),
            queue_max_abs_err=float(np.abs(qs - q1).max()),
            fl_delta_reduce_launches=launches)
    out["partials_bitwise_fma_order"] = tap.bitwise()
    out["partials_checked"] = len(tap.calls)
    grid = ScenarioGrid.create(["lroa", "uni_d", "uni_s", "divfl"],
                               seeds=[0, 1, 2, 3], V=hp.V, lam=hp.lam,
                               sample_count=cfg["sample_count"],
                               num_devices=cfg["num_devices"])
    bank = one.make_bank(data["clients"])
    reps = [Arena(one, mesh=m).run(fresh(), sp, bank, grid, SHARD_ROUNDS,
                                   lr) for m in (mesh, None)]
    (a, b) = reps
    out["arena"] = dict(
        digest=_digest(a.params), lanes=len(grid), shards=a.meta["shards"],
        param_max_abs_err=_max_err(a.params, b.params),
        selections_equal=bool(np.array_equal(a.metrics["selected"],
                                             b.metrics["selected"])),
        metrics_close=all(np.allclose(a.metrics[n], b.metrics[n],
                                      rtol=SHARD_ARENA_TOL[1],
                                      atol=SHARD_ARENA_TOL[2])
                          for n in b.metrics if n != "selected"),
        metric_max_abs_err={n: float(np.abs(a.metrics[n]
                                            - b.metrics[n]).max())
                            for n in b.metrics if n != "selected"},
        queues_close=bool(np.allclose(a.queues, b.queues,
                                      rtol=SHARD_ARENA_TOL[1],
                                      atol=SHARD_ARENA_TOL[2])),
        metrics_digest=_digest({n: torch.as_tensor(v)
                                for n, v in a.metrics.items()}))
    return out


def _span_counts(path: str) -> dict:
    from repro_torch.obs import trace as obs_trace

    counts: dict = {}
    for r in obs_trace.load_jsonl(path):
        counts[r["name"]] = counts.get(r["name"], 0) + 1
    return counts


def _shard_trainer(mesh, device: str, data: dict, bank_mode: str,
                   want: list, cfg: dict = PAPER_SCALE) -> dict:
    """One bank of shard.main on one rank: ``FederatedTrainer(mesh=)``
    on ``bank_mode``'s bank, warmed up, then SHARD_ROUNDS LROA rounds
    timed, each round's params held against the unsharded trainer's
    (``want``, from ``main`` / ``main.single``); the first round's
    partial of this rank (the error its loss from the all-reduce would
    leave)."""
    t0 = time.perf_counter()
    trainer = build_trainer(device, cfg, data, bank_mode=bank_mode,
                            mesh=mesh)
    bank = trainer.bank
    rungs = getattr(bank, "tiers", [bank])
    _device_sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.warmup()
    _device_sync()
    warmup_s = time.perf_counter() - t0
    _reset_launch_counts()
    seconds, recs, errs = [], [], []
    with _PartialTap() as tap:
        for t in range(SHARD_ROUNDS):
            _device_sync()
            t0 = time.perf_counter()
            recs.append(trainer.run_round(t))
            _device_sync()
            seconds.append(time.perf_counter() - t0)
            errs.append(max(float(np.abs(
                p.cpu().numpy() - want[t]["params"][n]).max())
                for n, p in trainer.global_params.items()))
    launches = _launch_counts()
    return dict(
        bank=type(bank).__name__, rungs=len(rungs),
        rows_per_rung=[r.rows_held for r in rungs],
        clients_per_rung=[r.num_clients for r in rungs],
        rows_held=sum(r.rows_held for r in rungs),
        bytes_held=int(bank.nbytes), build_s=build_s, warmup_s=warmup_s,
        round_s=seconds,
        selected=[[int(i) for i in r.selected] for r in recs],
        selections_equal_unsharded=[[int(i) for i in r.selected]
                                    for r in recs]
        == [w["selected"] for w in want],
        loss=[r.mean_loss for r in recs], param_max_abs_err_unsharded=errs,
        dropped_partial_err=max(float(g.abs().max())
                                for g in tap.calls[0][2]),
        launches={k: v for k, v in launches.items() if v},
        fl_delta_reduce_per_round=launches["fl_delta_reduce"]
        / SHARD_ROUNDS,
        partials_bitwise_fma_order=tap.bitwise(),
        partials_checked=len(tap.calls), digest=_digest(
            trainer.global_params),
        n_params=sum(p.numel() for p in trainer.global_params.values()),
        tiers_hit=[_tiers_hit(bank, r.selected) for r in recs])


def _shard_main(mesh, device: str, trace_dir: str, data: dict,
                unsharded: dict, cfg: dict = PAPER_SCALE) -> dict:
    """shard.main on one rank: :func:`_shard_trainer` on each of
    SHARD_MAIN_BANKS, then the all-reduce of one model-sized f32 buffer
    timed on its own; the rank's flight-recorder file, and rank 0's
    Chrome trace."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.obs import trace as obs_trace

    rank = mesh_lib.axis_rank(mesh)
    path = os.path.join(trace_dir, f"rank{rank}.jsonl")
    sink = obs_trace.install_sink(obs_trace.JsonlSink(path))
    banks = {mode: _shard_trainer(mesh, device, data, mode, unsharded[mode],
                                  cfg) for mode in SHARD_MAIN_BANKS}
    buf = torch.ones(banks["single"]["n_params"], dtype=torch.float32,
                     device=device)
    reduce_s = []
    for _ in range(10):
        _device_sync()
        t0 = time.perf_counter()
        mesh_lib.all_reduce_sum_(buf, mesh)
        _device_sync()
        reduce_s.append(time.perf_counter() - t0)
    obs_trace.remove_sink(sink)
    sink.close()
    out = dict(rank=rank, banks=banks, all_reduce_bytes=4 * buf.numel(),
               all_reduce_ms=statistics.median(reduce_s) * 1e3,
               spans=_span_counts(path), trace=path)
    if rank == 0:
        out["chrome_trace"] = obs_trace.export_chrome_trace(
            obs_trace.load_jsonl(path),
            os.path.join(trace_dir, "rank0.chrome.json"), "shard.main rank 0")
    return out


def _shard_arena(mesh, device: str, trace_dir: str, data: dict,
                 cfg: dict = PAPER_SCALE) -> dict:
    """shard.arena on one rank: the seven controllers and LROA at a second
    seed (8 lanes, 4 a rank) over SHARD_ROUNDS rounds on the paper-scale
    testbed's ladder, the lanes split over the mesh.  The clock runs from
    a barrier to a barrier, so every rank reads the world's time."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.obs import trace as obs_trace
    from repro_torch.core import POLICIES
    from repro_torch.sim import Arena, ScenarioGrid

    rank = mesh_lib.axis_rank(mesh)
    path = os.path.join(trace_dir, f"rank{rank}.arena.jsonl")
    sink = obs_trace.install_sink(obs_trace.JsonlSink(path))
    trainer = build_trainer(device, cfg, data)
    grid = ScenarioGrid.create(
        list(POLICIES) + ["lroa"], seeds=SHARD_ARENA_SEEDS,
        V=trainer.controller.hp.V, lam=trainer.controller.hp.lam,
        sample_count=cfg["sample_count"], num_devices=cfg["num_devices"])
    lr = [trainer.lr_schedule(t) for t in range(SHARD_ROUNDS)]
    arena = Arena(trainer.engine, mesh=mesh)

    def barrier():
        mesh_lib.all_reduce_sum_(torch.zeros(1, device=device), mesh)
        _device_sync()

    _reset_launch_counts()
    barrier()
    t0 = time.perf_counter()
    rep = arena.run(trainer.global_params, trainer.params, trainer.bank,
                    grid, SHARD_ROUNDS, lr)
    barrier()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    obs_trace.remove_sink(sink)
    sink.close()
    finite = all(bool(torch.isfinite(v).all()) for v in rep.params.values())
    return dict(
        rank=rank, lanes=len(grid), lanes_per_rank=len(grid)
        // mesh_lib.axis_size(mesh), rounds=SHARD_ROUNDS, seconds=seconds,
        launches={k: v for k, v in launches.items() if v},
        digest=_digest(rep.params), finite=finite,
        shape_ok=all(v.shape[0] == len(grid) for v in rep.params.values())
        and rep.metrics["loss"].shape == (len(grid), SHARD_ROUNDS),
        modelled_latency=rep.metrics["wall_time"].sum(axis=1).tolist(),
        spans=_span_counts(path))


def shard_job(payload: dict, rank: int, world_size: int) -> dict:
    """One rank of a sharded phase (run by ``launch.world.run_world``):
    the mesh over the world on ``payload['device']``, then
    reference.shard (cuDNN deterministic) and, with
    ``payload['unsharded']`` (the unsharded trainers' params and
    selections after each round, by bank mode), shard.main and
    shard.arena on the paper-scale testbed pickled at
    ``payload['data']`` (the parent's, so no rank rebuilds it).  Returns
    numbers and digests only."""
    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = payload["device"]
    on_card = torch.device(device).type == "cuda"
    mesh = mesh_lib.make_fl_mesh(device_type="cuda" if on_card else "cpu",
                                 device=device if on_card else None)
    out = dict(rank=rank, world_size=world_size,
               backend=torch.distributed.get_backend())
    t0 = time.perf_counter()
    with cudnn_deterministic():
        out["reference"] = _shard_reference(mesh, device)
    out["reference_s"] = time.perf_counter() - t0
    if payload.get("unsharded"):
        t0 = time.perf_counter()
        with open(payload["data"], "rb") as fh:
            data = pickle.load(fh)
        out["data_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["main"] = _shard_main(mesh, device, payload["trace_dir"], data,
                                  payload["unsharded"])
        out["main_s"] = time.perf_counter() - t0
        out["arena"] = _shard_arena(mesh, device, payload["trace_dir"],
                                    data)
    return out


def _run_shard_world(ranks: int, backend: str, unsharded, workdir: str,
                     trace_dir: str, data: dict = None) -> list:
    from repro_torch.launch.world import run_world

    t0 = time.perf_counter()
    data_path = None
    if data is not None:
        os.makedirs(workdir, exist_ok=True)
        data_path = os.path.join(workdir, "data.pkl")
        with open(data_path, "wb") as fh:
            pickle.dump(data, fh, protocol=5)
    out = run_world(shard_job, ranks, backend=backend, workdir=workdir,
                    timeout=SHARD_TIMEOUT,
                    payload=dict(device="cuda:0", unsharded=unsharded,
                                 data=data_path, trace_dir=trace_dir))
    for r in out:
        r["world_s"] = time.perf_counter() - t0
    return out


def _check_shard_reference(label: str, ranks: list) -> None:
    """reference.shard's requirements over every rank's results."""
    refs = [r["reference"] for r in ranks]
    one_rank = len(ranks) == 1
    for case in refs[0]["rounds"]:
        rows = [ref["rounds"][case] for ref in refs]
        want = 0 if case == "hierarchical" else 1
        log(f"{label}.round", case=case, ranks=len(ranks),
            backend=ranks[0]["backend"],
            params_bitwise_across_ranks=len({r["digest"] for r in rows}) == 1,
            **{k: [r[k] for r in rows] for k in (
                "param_max_abs_err", "loss_max_abs_err", "bitwise",
                "fl_delta_reduce_launches", "tiers_hit", "rows_held",
                "nbytes", "unsharded_nbytes")}, tol=SHARD_ROUND_TOL)
        require(len({r["digest"] for r in rows}) == 1,
                f"{label} {case}: params bitwise equal on every rank")
        require(all(r["param_max_abs_err"] <= SHARD_ROUND_TOL and
                    r["loss_max_abs_err"] <= SHARD_ROUND_TOL for r in rows),
                f"{label} {case}: the sharded round within "
                f"{SHARD_ROUND_TOL} of the unsharded one")
        require(all(r["fl_delta_reduce_launches"] == want for r in rows),
                f"{label} {case}: {want} fl_delta_reduce launch a rank")
        if case == "ladder":
            require(len(rows[0]["tiers_hit"]) > 1,
                    f"{label}: the ladder round hits several tiers")
    scans = [ref["scan"] for ref in refs]
    log(f"{label}.scan", rounds=SHARD_ROUNDS, policy="lroa",
        params_bitwise_across_ranks=len({s["digest"] for s in scans}) == 1,
        **{k: [s[k] for s in scans] for k in (
            "selections_equal", "param_max_abs_err", "metric_max_abs_err",
            "metrics_close", "queue_max_abs_err",
            "fl_delta_reduce_launches")}, tol=SHARD_ROUND_TOL,
        metric_tol=SHARD_ARENA_TOL[1:])
    require(len({s["digest"] for s in scans}) == 1 and
            all(s["selections_equal"] and s["metrics_close"] and
                s["param_max_abs_err"] <= SHARD_ROUND_TOL and
                s["queue_max_abs_err"] <= SHARD_ARENA_TOL[2] and
                s["fl_delta_reduce_launches"] == SHARD_ROUNDS
                for s in scans),
            f"{label}: the sharded run_scan agrees with the unsharded one")
    arenas = [ref["arena"] for ref in refs]
    log(f"{label}.arena", rounds=SHARD_ROUNDS,
        params_bitwise_across_ranks=len({a["digest"] for a in arenas}) == 1,
        metrics_bitwise_across_ranks=len({a["metrics_digest"]
                                          for a in arenas}) == 1,
        **{k: [a[k] for a in arenas] for k in (
            "lanes", "shards", "selections_equal", "param_max_abs_err",
            "metric_max_abs_err", "metrics_close", "queues_close")},
        tol=SHARD_ARENA_TOL)
    require(len({a["digest"] for a in arenas}) == 1 and
            len({a["metrics_digest"] for a in arenas}) == 1,
            f"{label}: every rank returns the same arena report")
    require(all(a["selections_equal"] and a["metrics_close"] and
                a["queues_close"] and a["shards"] == len(ranks) and
                a["param_max_abs_err"] <= SHARD_ARENA_TOL[0]
                for a in arenas),
            f"{label}: the sharded arena agrees with the unsharded one")
    log(label, ranks=len(ranks), backend=ranks[0]["backend"],
        partials_checked=[ref["partials_checked"] for ref in refs],
        partials_bitwise_fma_order=[ref["partials_bitwise_fma_order"]
                                    for ref in refs],
        seconds=[r["reference_s"] for r in ranks],
        world_s=ranks[0]["world_s"], one_rank_bitwise=(
            {c: r["bitwise"] for c, r in refs[0]["rounds"].items()}
            if one_rank else None))
    require(all(ref["partials_bitwise_fma_order"] for ref in refs),
            f"{label}: each rank's partial is bitwise its fma order")


def phase_shard(root: str, data: dict, unsharded: dict, bank_bytes: dict
                ) -> dict:
    """reference.shard in a world of SHARD_RANKS gloo ranks on cuda:0 and
    in a one-rank NCCL world; shard.main (held against ``unsharded``, the
    ``main`` and ``main.single`` trainers' params and selections after
    each of their first rounds, by bank mode; ``bank_bytes`` their banks'
    bytes) and shard.arena in the gloo world, on their testbed ``data``.
    A
    rank that fails or outlives SHARD_TIMEOUT fails the phase
    (``launch.world.run_world`` raises after killing every rank)."""
    trace_dir = os.path.join(ROOT, "runlogs", "shard")
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.makedirs(trace_dir)
    gloo = _run_shard_world(SHARD_RANKS, "gloo", unsharded,
                            os.path.join(root, "gloo"), trace_dir, data)
    _check_shard_reference("reference.shard", gloo)
    nccl = _run_shard_world(1, "nccl", None, os.path.join(root, "nccl"),
                            trace_dir)
    _check_shard_reference("reference.shard.nccl", nccl)
    mains = [r["main"] for r in gloo]
    for mode in SHARD_MAIN_BANKS:
        rows = [m["banks"][mode] for m in mains]
        sound = max(max(r["param_max_abs_err_unsharded"]) for r in rows)
        fault = min(r["dropped_partial_err"] for r in rows)
        log("shard.main", ranks=SHARD_RANKS, backend="gloo",
            device="cuda:0", bank_mode=mode, bank=rows[0]["bank"],
            rungs=rows[0]["rungs"],
            clients_per_rung=rows[0]["clients_per_rung"],
            rows_per_rung_per_rank=[r["rows_per_rung"] for r in rows],
            rows_per_rank=[r["rows_held"] for r in rows],
            bytes_per_rank=[r["bytes_held"] for r in rows],
            unsharded_bytes=bank_bytes[mode],
            build_s=[r["build_s"] for r in rows],
            warmup_s=[r["warmup_s"] for r in rows],
            round_s=[r["round_s"] for r in rows],
            tiers_hit=rows[0]["tiers_hit"],
            fl_delta_reduce_per_rank_per_round=[
                r["fl_delta_reduce_per_round"] for r in rows],
            launches=[r["launches"] for r in rows],
            params_bitwise_across_ranks=len({r["digest"]
                                             for r in rows}) == 1,
            partials_bitwise_fma_order=[r["partials_bitwise_fma_order"]
                                        for r in rows],
            selections_equal_unsharded=rows[0]["selections_equal_unsharded"],
            loss=rows[0]["loss"],
            param_max_abs_err_unsharded=rows[0][
                "param_max_abs_err_unsharded"],
            dropped_partial_err=[r["dropped_partial_err"] for r in rows],
            param_tol=SHARD_MAIN_TOL)
        require(len({r["digest"] for r in rows}) == 1,
                f"shard.main {mode}: params bitwise equal on every rank")
        require(all(r["fl_delta_reduce_per_round"] == 1 and
                    r["partials_bitwise_fma_order"] for r in rows),
                f"shard.main {mode}: one fl_delta_reduce launch a rank a "
                f"round, each partial bitwise its fma order")
        require(rows[0]["selections_equal_unsharded"] and
                all(np.isfinite(rows[0]["loss"])),
                f"shard.main {mode}: the sharded trainer selects as the "
                f"unsharded one")
        require(sound <= SHARD_MAIN_TOL < fault,
                f"shard.main {mode}: params within {SHARD_MAIN_TOL} of "
                f"the unsharded trainer's after every round ({sound}), "
                f"below the {fault} a rank's dropped partial would leave")
    single = [m["banks"]["single"] for m in mains]
    require(all(r["rows_held"] * SHARD_RANKS == r["clients_per_rung"][0]
                and r["bytes_held"] < bank_bytes["single"] for r in single),
            "shard.main single: each rank holds its share of the rows, and "
            "fewer bytes than the whole bank")
    log("shard.main.collective", all_reduce_bytes=mains[0][
        "all_reduce_bytes"], all_reduce_ms=[m["all_reduce_ms"]
                                            for m in mains],
        spans=[m["spans"] for m in mains],
        chrome_trace=os.path.relpath(mains[0]["chrome_trace"], ROOT),
        reference_s=[r["reference_s"] for r in gloo],
        data_s=[r["data_s"] for r in gloo],
        main_s=[r["main_s"] for r in gloo], world_s=gloo[0]["world_s"],
        nccl_world_s=nccl[0]["world_s"])
    arenas = [r["arena"] for r in gloo]
    slowest = max(a["seconds"] for a in arenas)
    log("shard.arena", ranks=SHARD_RANKS, lanes=arenas[0]["lanes"],
        lanes_per_rank=arenas[0]["lanes_per_rank"], rounds=SHARD_ROUNDS,
        seconds=[a["seconds"] for a in arenas],
        lane_rounds_per_s=arenas[0]["lanes"] * SHARD_ROUNDS / slowest,
        launches=[a["launches"] for a in arenas],
        params_bitwise_across_ranks=len({a["digest"] for a in arenas}) == 1,
        modelled_latency=arenas[0]["modelled_latency"],
        spans=[a["spans"] for a in arenas])
    require(len({a["digest"] for a in arenas}) == 1 and
            all(a["finite"] and a["shape_ok"] for a in arenas),
            "shard.arena: every rank returns the whole, finite report")
    require(all(a["launches"].get("fl_aggregate_lanes") == SHARD_ROUNDS
                for a in arenas),
            "shard.arena: one lane launch a rank a round")
    return dict(main=mains, arena=arenas, launches={
        "fl_delta_reduce": {
            f"shard.main.{mode}.rank{m['rank']}":
            m["banks"][mode]["launches"].get("fl_delta_reduce", 0)
            for m in mains for mode in SHARD_MAIN_BANKS},
        "fl_aggregate_lanes": {f"shard.arena.rank{a['rank']}":
                               a["launches"].get("fl_aggregate_lanes", 0)
                               for a in arenas}})


def phase_delta_reduce_leaves(flush, hbm: float, f32_peak: float) -> list:
    """The partial eq.-(4) reduce of the client-sharded round
    (``ops.fl_delta_reduce_leaves``, the zero-theta leaf table writing
    into views of one flat f32 buffer, as ``server.aggregate_fused_psum``
    calls it) at one rank's share of K = 8 over SHARD_RANKS ranks: the
    paper-scale CNN's 6 leaves and the ResNet's 17, f32.  One launch,
    bitwise its order of arithmetic (``ref.aggregate_leaves_fma_reference(
    None, ...)``), within TOL of the plain version
    (``ref.delta_reduce_leaves_reference``), timed beside its bound and
    ``torch.mv`` on the same numbers ravelled into one ``[K, N]`` tensor
    (no one PyTorch call takes the leaves)."""
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ops, ref

    k = MAIN_POINT[1] // SHARD_RANKS
    rows = []
    for label, cfg in (("cnn", PAPER_SCALE), ("resnet", PAPER_CIFAR)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(9)
        params = make_task(cfg).init(gen)
        names = sorted(params)
        deltas = [torch.randn((k,) + tuple(params[n].shape), device="cuda",
                              generator=gen) * 1e-2 for n in names]
        coeffs = torch.softmax(torch.randn(k, device="cuda", generator=gen),
                               0)
        total = sum(params[n].numel() for n in names)
        flat = torch.empty(total, dtype=torch.float32, device="cuda")
        views, off = [], 0
        for n in names:
            views.append(flat[off:off + params[n].numel()].view(
                params[n].shape))
            off += params[n].numel()

        def kernel():
            return ops.fl_delta_reduce_leaves(deltas, coeffs, outs=views)

        before = fk.LAUNCHES["fl_delta_reduce"]
        got = [v.clone() for v in kernel()]
        launches = fk.LAUNCHES["fl_delta_reduce"] - before
        exact = ref.aggregate_leaves_fma_reference(None, deltas, coeffs)
        plain = ref.delta_reduce_leaves_reference(deltas, coeffs)
        ravelled = torch.cat([d.reshape(k, -1) for d in deltas], dim=1)
        lib = torch.mv(ravelled.t(), coeffs)
        torch.cuda.synchronize()
        tol = TOL[torch.float32]
        err = max(float((g - w).abs().max()) for g, w in zip(got, plain))
        bitwise = all(torch.equal(g, w) for g, w in zip(got, exact))
        lib_err = float((torch.cat([g.reshape(-1) for g in got])
                         - lib).abs().max())
        nbytes = 4 * k * total + 4 * total + 4 * k
        bound_ms, bound_by = _bound(nbytes, 2 * k * total, hbm, f32_peak)
        row = dict(
            label=label, leaves=len(names), n=total, k=k, dtype="float32",
            launches=launches, tol=tol, max_abs_err=err,
            bitwise_equal_to_fma_order=bitwise,
            library_max_abs_err=lib_err, flush="clean",
            ms=time_ms(kernel, flush=flush, clean=True),
            plain_ms=time_ms(lambda: ref.delta_reduce_leaves_reference(
                deltas, coeffs), flush=flush, clean=True),
            library_ms=time_ms(lambda: torch.mv(ravelled.t(), coeffs),
                               flush=flush, clean=True),
            library="torch.mv on the leaves ravelled into one [K, N] "
                    "tensor",
            bound_ms=bound_ms, bound_by=bound_by, mbytes=nbytes * 1e-6)
        row["bound_share"] = bound_ms / row["ms"]
        log("kernel.delta_reduce_leaves", **row)
        require(launches == 1, f"the partial reduce at the {label}'s "
                               f"{len(names)} leaves: one launch, got "
                               f"{launches}")
        require(err <= tol, f"the partial reduce at the {label}'s leaves "
                            f"disagrees with its plain version (err {err})")
        require(bitwise, f"the partial reduce at the {label}'s leaves is "
                         f"bitwise its order of arithmetic")
        rows.append(row)
        del deltas, exact, plain, ravelled, lib, flat, views, got
    torch.cuda.empty_cache()
    return rows


def _import_examples() -> tuple:
    """The drivers ``examples/{quickstart,fl_simulation,serve_decode}
    _torch.py`` as modules."""
    import importlib

    path = os.path.join(ROOT, "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    return tuple(importlib.import_module(f"{name}_torch") for name in (
        "quickstart", "fl_simulation", "serve_decode"))


def quickstart_run(rounds: int, device: str) -> dict:
    """``quickstart_torch.run(rounds=rounds, device=device)`` with its
    seconds."""
    quickstart = _import_examples()[0]
    _device_sync()
    t0 = time.perf_counter()
    out = quickstart.run(rounds=rounds, device=device)
    _device_sync()
    out["seconds"] = time.perf_counter() - t0
    return out


def _rel_errs(card: dict, cpu: dict) -> dict:
    """{number: largest |card - cpu| / |cpu|} over two quickstart runs'
    printed numbers (lambda, V and each printed round's)."""
    errs = {key: max(abs(a[key] - b[key]) / abs(b[key])
                     for a, b in zip(card["rounds"], cpu["rounds"]))
            for key in cpu["rounds"][0] if key != "round"}
    errs.update({key: abs(card[key] - cpu[key]) / abs(cpu[key])
                 for key in ("lam", "V")})
    return errs


def phase_examples(device: str = "cuda") -> dict:
    """The repo's drivers on the card, through the functions a user's
    command calls: ``quickstart_torch.run`` for :data:`QUICKSTART_ROUNDS`
    rounds against the same on the CPU, every printed number within :data:`QUICKSTART_RTOL` relative, no
    kernel launched; ``fl_simulation_torch.main`` at its defaults (the
    table, seconds, lane-rounds/s, one ``fl_aggregate_lanes`` launch a
    round); its ``run_arena_grid`` at :data:`EXAMPLES_FL` on the card and
    the CPU from one initial model drawn on the CPU (the port's own draws
    otherwise, the same bits on both), accuracy and total latency within
    :data:`EXAMPLES_FL_TOL`; ``serve_decode_torch.main`` of each of
    :data:`EXAMPLES_SERVE`'s smoke models at its defaults, the card's
    tokens equal to the CPU's, the flash and SSD launches of
    :func:`expected_launches`.  Returns the launches by path.  With
    ``device='cpu'`` (a rehearsal) it runs the same code against itself,
    and no launch is counted."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.sim.testbed import BenchConfig, build_testbed
    from repro_torch.tree import tree_map

    _, fl_sim, serve_demo = _import_examples()
    on_card = device != "cpu"
    t_phase = time.perf_counter()

    _reset_launch_counts()
    card = quickstart_run(QUICKSTART_ROUNDS, device)
    launched = sum(_launch_counts().values())
    cpu = quickstart_run(QUICKSTART_ROUNDS, "cpu")
    errs = _rel_errs(card, cpu)
    log("examples.quickstart", rounds=QUICKSTART_ROUNDS,
        printed_rounds=[r["round"] for r in card["rounds"]],
        card_s=card["seconds"], cpu_s=cpu["seconds"],
        card_rounds_per_s=QUICKSTART_ROUNDS / card["seconds"],
        max_rel_err=errs, rtol=QUICKSTART_RTOL, launches=launched,
        card=card["rounds"], cpu=cpu["rounds"])
    require(all(e <= QUICKSTART_RTOL for e in errs.values()),
            f"quickstart card against CPU within {QUICKSTART_RTOL}: {errs}")
    require(launched == 0, "the quickstart launches no kernel")

    _reset_launch_counts()
    _device_sync()
    t0 = time.perf_counter()
    table = fl_sim.main(["--device", device])
    _device_sync()
    seconds = time.perf_counter() - t0
    full = _launch_counts()
    defaults = BenchConfig(num_devices=24, rounds=40)
    lanes = len(table)
    log("examples.fl_simulation", seconds=seconds,
        lane_rounds_per_s=lanes * defaults.rounds / seconds, lanes=lanes,
        rounds=defaults.rounds, devices=defaults.num_devices, table=table,
        launches=full)
    require(full["fl_aggregate_lanes"] == defaults.rounds * on_card,
            "one fl_aggregate_lanes launch a round")
    require(all(np.isfinite(v).all() for v in table.values()),
            "a finite table")

    cfg = BenchConfig(num_devices=EXAMPLES_FL["devices"],
                      rounds=EXAMPLES_FL["rounds"])
    names = list(EXAMPLES_FL["controllers"])
    init = build_testbed(cfg, device="cpu")[1].init(
        torch.Generator().manual_seed(cfg.seed + 1))
    _reset_launch_counts()
    card_table = fl_sim.run_arena_grid(
        names, cfg, 1, device=device,
        params0=tree_map(lambda t: t.to(device, copy=True), init))
    small = _launch_counts()
    cpu_table = fl_sim.run_arena_grid(names, cfg, 1, device="cpu",
                                      params0=init)
    err = max(abs(a - b) - EXAMPLES_FL_TOL * abs(b)
              for name in names
              for a, b in zip(card_table[name], cpu_table[name]))
    log("examples.fl_simulation.reference", rounds=cfg.rounds,
        devices=cfg.num_devices, card=card_table, cpu=cpu_table,
        excess_over_rtol=err, tol=EXAMPLES_FL_TOL, launches=small)
    require(err <= EXAMPLES_FL_TOL, "fl_simulation card against CPU within "
            f"{EXAMPLES_FL_TOL}: {card_table} against {cpu_table}")
    require(small["fl_aggregate_lanes"] == cfg.rounds * on_card,
            "one fl_aggregate_lanes launch a round")

    served = {}
    for arch in EXAMPLES_SERVE:
        tokens_cpu = serve_demo.main(["--device", "cpu", "--arch", arch])
        _reset_launch_counts()
        t0 = time.perf_counter()
        tokens = serve_demo.main(["--device", device, "--arch", arch])
        _device_sync()
        seconds = time.perf_counter() - t0
        got = _launch_counts()
        lm = dataclasses.replace(get_smoke_config(arch), attn_impl="flash")
        want = {k: (pre + 15 * dec) * on_card for k, (pre, dec) in
                expected_launches(lm, 24).items()}
        label = "examples.serve." + arch.split("-")[0]
        log(label, seconds=seconds, tokens_equal=bool(
            np.array_equal(tokens, tokens_cpu)), launches=got,
            expected=want)
        require(np.array_equal(tokens, tokens_cpu),
                f"{arch} card tokens equal the CPU's")
        require(got == want, f"{arch} launches {got}, expected {want}")
        served[label] = got
    seconds = time.perf_counter() - t_phase
    log("examples", seconds=seconds)
    return {"seconds": seconds, "examples.fl_simulation":
            full["fl_aggregate_lanes"],
            "examples.fl_simulation.reference": small["fl_aggregate_lanes"],
            **served}


def kernels_line(points: list, leaves: dict, lanes: list, resnet: dict,
                 main_summary: dict, single_summary: dict,
                 scan_summary: dict, arena_summary: dict, map_summary: dict,
                 sweep_summary: dict, paper: dict, flash: list, ssd: list,
                 gemma: dict, mamba: dict, families: dict, smi: str,
                 sass: dict, flash_lse: list, training: dict,
                 reduce_leaves: list, shard: dict, warmups: dict,
                 examples: dict) -> dict:
    """The ``kernels`` record: each kernel with its launches on its main
    paths (the LROA rounds on the ladder and on the single bucket, the
    seven controllers' rollouts, the mapped arena's lane rounds and the
    paper testbeds' trainer rounds; the arena's and the sweep's
    lane-batched rounds; the gemma2, mamba2 and the other families'
    generations; the LM training phases; the sharded trainer's and arena's
    rounds, per rank; the drivers' runs of the ``examples`` phase) and its
    numbers at that path's shapes;
    ``flash_attention_lse`` is the flash kernel writing its lse output,
    the training forward's form; ``fl_delta_reduce`` is ``fl_aggregate``'s
    zero-theta form, a rank's partial eq.-(4) term."""
    m = next(p for p in points if (p["n"], p["k"]) == MAIN_POINT[:2]
             and p["dtype"] == "float32")
    fg = next(r for r in flash if r["label"] == "gemma2.global")
    fl = next(r for r in flash if r["label"] == "gemma2.local")
    fp = next(r for r in flash if r["label"] == "gemma2.causal_plain")
    fb = next(r for r in flash if r["label"] == "gemma2.global.bshd")
    sm = next(r for r in ssd if r["label"] == "mamba2")

    def entry(name, source, replaces, launches, row, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "status": "ported",
                "launches": launches, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "card": smi, **extra}

    def total(run, kernel):
        return run["launches_prefill"][kernel] + \
            run["launches_decode"][kernel]

    fused = leaves["fused"]
    la = lanes[0]
    rc = next(r for r in reduce_leaves if r["label"] == "cnn")
    rr = next(r for r in reduce_leaves if r["label"] == "resnet")
    lse_main = next(r for r in flash_lse if r["label"] == "gemma2b.train")
    demo_ssd = examples["examples.serve.mamba2"]

    def trained(kernel):
        return {path: run["launches"].get(kernel, 0)
                for path, run in training.items()
                if run["launches"].get(kernel, 0)}

    return {"kernels": [
        entry("fl_aggregate", "src/repro_torch/kernels/csrc/fl_aggregate.cu",
              "src/repro/kernels/fl_aggregate.py:35",
              main_summary["launches"]["fl_aggregate"]
              + single_summary["launches"]["fl_aggregate"]
              + scan_summary["launches"]["fl_aggregate"]
              + map_summary["launches"]["fl_aggregate"]
              + sum(run["launches"]["fl_aggregate"]
                    for run in paper.values())
              + sum(trained("fl_aggregate").values()),
              dict(fused, library_ms=None),
              launches_by_path={
                  "main": main_summary["launches"]["fl_aggregate"],
                  "main.single": single_summary["launches"]["fl_aggregate"],
                  "scan": scan_summary["launches"]["fl_aggregate"],
                  "arena.map": map_summary["launches"]["fl_aggregate"],
                  **{path: run["launches"]["fl_aggregate"]
                     for path, run in paper.items()},
                  **trained("fl_aggregate")},
              max_abs_err_all_points=max(
                  [p["max_abs_err"] for p in points] + [fused["max_abs_err"]]
                  + [r["max_abs_err"] for r in leaves["leaves"]]
                  + [resnet["max_abs_err"]]),
              design="the header comment of src/repro_torch/kernels/csrc/"
                     "fl_aggregate.cu",
              point="the round's eq.-(4) step: aggregate_fused at the "
                    "paper-scale CNN's 6 leaves, N=545,002, K=8, f32, one "
                    "launch; library_ms: no one PyTorch call takes the "
                    "leaves (torch.addmv on the flat model is under "
                    "variants.flat_545002)",
              flush="clean: the L2 flush reads a 256 MB buffer; "
                    "ms_zero_flush writes it, as the flash and SSD rows' "
                    "flush does",
              ms_zero_flush=fused["ms_zero_flush"],
              aggregate_fused={key: fused[key] for key in (
                  "leaves", "n", "bitwise_equal_to_fma_order",
                  "bitwise_equal_to_ravel_path", "graph_bitwise_equal",
                  "ravel_path_ms", "ravel_path_ms_zero_flush",
                  "graph_replay_ms", "wall_us", "ravel_path_wall_us")},
              variants={"gemma2b_11_leaves_bf16": {
                  "point": "fl_round.gemma2b's eq.-(4) step: gemma-2b's 11 "
                           "bf16 leaves (2.51 B params), K=2, one launch; "
                           "library_ms: none",
                  "launches": training["fl_round.gemma2b"]["launches"][
                      "fl_aggregate"],
                  **{key: training["fl_round.gemma2b"]["aggregate"][key]
                     for key in ("max_abs_err", "ms", "plain_ms",
                                 "library_ms", "bound_ms", "bound_by",
                                 "bound_share")}},
                  "resnet_17_leaves": {
                  "point": "paper.cifar's eq.-(4) step: aggregate_fused at "
                           "the paper-scale ResNet's 17 leaves, N=694,378, "
                           "K=8, f32, one launch; library_ms: none",
                  "launches": paper["paper.cifar"]["launches"][
                      "fl_aggregate"],
                  "library_ms": None,
                  **{key: resnet[key] for key in (
                      "max_abs_err", "bitwise_equal_to_fma_order", "ms",
                      "ms_zero_flush", "plain_ms", "bound_ms", "bound_by",
                      "wall_us", "vec")}},
                  "pytree_per_leaf_resnet": {
                  "launches_per_call": resnet["pytree_launches"],
                  "bitwise_equal_to_one_launch": resnet[
                      "pytree_bitwise_equal_to_one_launch"],
                  "ms": resnet["pytree_ms"],
                  "wall_us": resnet["pytree_wall_us"],
                  "bound_ms": resnet["bound_ms"]},
                  "flat_545002": {
                  "launches": 0,
                  **{key: m[key] for key in (
                      "max_abs_err", "bitwise_equal_to_fma_order", "ms",
                      "ms_zero_flush", "plain_ms", "library_ms",
                      "library_ms_zero_flush", "bound_ms", "bound_by")}}}),
        entry("fl_delta_reduce",
              "src/repro_torch/kernels/csrc/fl_aggregate.cu",
              "src/repro/kernels/ops.py:91",
              sum(shard["launches"]["fl_delta_reduce"].values()), rc,
              launches_by_path=shard["launches"]["fl_delta_reduce"],
              design="fl_aggregate's kernel with no theta "
                     "(fl_delta_reduce_leaves_cuda), writing each leaf's "
                     "f32 partial into a view of one flat buffer",
              point="one rank's partial of shard.main's round: the "
                    "paper-scale CNN's 6 leaves, N=545,002, K=4 (8 over 2 "
                    "ranks), f32, one launch; library_ms: torch.mv on the "
                    "same numbers ravelled into one [K, N] tensor",
              bitwise_equal_to_fma_order=all(
                  r["bitwise_equal_to_fma_order"] for r in reduce_leaves),
              shard_partials_bitwise_fma_order=all(
                  b["partials_bitwise_fma_order"] for mm in shard["main"]
                  for b in mm["banks"].values()),
              max_abs_err_all_points=max(
                  [r["max_abs_err"] for r in reduce_leaves]
                  + [p["reduce_max_abs_err"] for p in points]),
              variants={
                  "resnet_17_leaves": {k: rr[k] for k in (
                      "leaves", "n", "k", "max_abs_err", "ms", "plain_ms",
                      "library_ms", "bound_ms", "bound_by",
                      "bound_share")},
                  "flat_545002_k8": {
                      "launches": 0, "max_abs_err": m["reduce_max_abs_err"],
                      "ms": m["reduce_ms"], "plain_ms": m["reduce_plain_ms"],
                      "library_ms": m["reduce_library_ms"],
                      "bound_ms": m["reduce_bound_ms"]}}),
        entry("fl_aggregate_lanes",
              "src/repro_torch/kernels/csrc/fl_aggregate.cu",
              "src/repro/kernels/fl_aggregate.py:35",
              arena_summary["launches"]["fl_aggregate_lanes"]
              + sweep_summary["launches"]["fl_aggregate_lanes"]
              + sum(shard["launches"]["fl_aggregate_lanes"].values())
              + sum(w["launches"]["fl_aggregate_lanes"]
                    for w in warmups.values() if "launches" in w)
              + examples["examples.fl_simulation"]
              + examples["examples.fl_simulation.reference"],
              dict(la, library_ms=None),
              launches_by_path={
                  "arena": arena_summary["launches"]["fl_aggregate_lanes"],
                  "sweep": sweep_summary["launches"]["fl_aggregate_lanes"],
                  **shard["launches"]["fl_aggregate_lanes"],
                  **{path: w["launches"]["fl_aggregate_lanes"]
                     for path, w in warmups.items() if "launches" in w},
                  **{path: examples[path] for path in (
                      "examples.fl_simulation",
                      "examples.fl_simulation.reference")}},
              design="the header comment of src/repro_torch/kernels/csrc/"
                     "fl_aggregate.cu (segments on coefficient rows)",
              point="the arena's round at paper scale: 7 lanes x the CNN's "
                    "6 leaves, N=545,002, K=8, f32, one launch; library_ms: "
                    "no one PyTorch call takes the leaves (torch.baddbmm on "
                    "the ravelled lanes is baddbmm_flat_ms)",
              flush="clean", bitwise_equal_to_fma_order=la[
                  "bitwise_equal_to_fma_order"],
              one_lane_launches_ms=la["one_lane_launches_ms"],
              baddbmm_flat_ms=la["baddbmm_flat_ms"],
              ms_zero_flush=la["ms_zero_flush"],
              max_abs_err_all_points=max(r["max_abs_err"] for r in lanes),
              variants={f"lanes_{r['lanes']}": {
                  k: r[k] for k in ("segments", "tables", "launches",
                                    "max_abs_err", "ms", "plain_ms",
                                    "one_lane_launches_ms", "baddbmm_flat_ms",
                                    "bound_ms", "bound_by")}
                  for r in lanes[1:]}),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:93",
              total(gemma, "flash_attention")
              + sum(total(run, "flash_attention")
                    for run in families.values())
              + sum(trained("flash_attention").values())
              + examples["examples.serve.gemma2"]["flash_attention"],
              dict(fg, library_ms=fp["library_ms"]),
              launches_by_path={
                  "serve.gemma2": total(gemma, "flash_attention"),
                  **{f"serve.{phase}": total(run, "flash_attention")
                     for phase, run in families.items()},
                  **trained("flash_attention"),
                  "examples.serve.gemma2": examples[
                      "examples.serve.gemma2"]["flash_attention"]},
              design=DESIGNS["flash_attention"],
              sass=sass.get("flash_attention"),
              max_abs_err_all_points=max(r["max_abs_err"] for r in flash),
              point="gemma2-27b global layer: B=2 H=32 Hkv=16 S=4352 D=128 "
                    "bf16 causal softcap 50; library_ms: SDPA at the same "
                    "shape, causal, no window or soft-cap",
              variants={"local_window_4096": {
                  k: fl[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by")},
                  "global_bshd_views": {
                  k: fb[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")},
                  "causal_plain": {
                  k: fp[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")},
                  **{r["label"]: {k: r[k] for k in (
                      "shape", "causal", "window", "softcap", "max_abs_err",
                      "ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_by", "kv_tile")}
                     for r in flash if r["label"] in FAMILY_LABELS}}),
        entry("flash_attention_lse",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:93",
              sum(trained("flash_attention_lse").values()), lse_main,
              launches_by_path=trained("flash_attention_lse"),
              design=DESIGNS["flash_attention"] + " (the lse output)",
              point="the training forward with its lse output at gemma-2b's "
                    "training shape: B=2 H=8 Hkv=1 S=1024 D=256 bf16 causal "
                    "(one microbatch of train.gemma2b); library_ms: SDPA at "
                    "the same shape, causal",
              ms_without_lse=lse_main["ms_without_lse"],
              lse_cost=lse_main["lse_cost"],
              out_bitwise_equal_without_lse=all(
                  r["out_bitwise_equal_without_lse"] for r in flash_lse),
              max_abs_err_all_points=max(r["max_abs_err"]
                                         for r in flash_lse),
              variants={r["label"]: {k: r[k] for k in (
                  "shape", "dtype", "softcap", "lse_tol", "max_abs_err",
                  "ms", "ms_without_lse", "lse_cost", "plain_ms",
                  "library_ms", "bound_ms", "bound_by")}
                  for r in flash_lse if r is not lse_main}),
        entry("ssd_chunk", "src/repro_torch/kernels/csrc/ssd_chunk.cu",
              "src/repro/kernels/ssd_scan.py:65",
              total(mamba, "ssd_scores") + total(mamba, "ssd_chunk")
              + sum(trained("ssd_scores").values())
              + sum(trained("ssd_chunk").values())
              + demo_ssd["ssd_scores"] + demo_ssd["ssd_chunk"], sm,
              launches_by_path={
                  "serve.mamba2": total(mamba, "ssd_scores")
                  + total(mamba, "ssd_chunk"),
                  **{path: n + trained("ssd_chunk")[path]
                     for path, n in trained("ssd_scores").items()},
                  "examples.serve.mamba2": demo_ssd["ssd_scores"]
                  + demo_ssd["ssd_chunk"]},
              launches_by_kernel={k: total(mamba, k)
                                  + sum(trained(k).values()) + demo_ssd[k]
                                  for k in ("ssd_scores", "ssd_chunk")},
              design=DESIGNS["ssd_chunk"],
              max_abs_err_all_points=max(r["max_abs_err"] for r in ssd),
              point="mamba2-130m prefill: B=4 S=2048 nh=24 hd=64 N=128 "
                    "chunk=256 f32; ms, plain_ms and bound_ms cover both "
                    "launches (scores, chunk) of one call"),
    ]}


def ptxas_report(build_log: dict) -> list:
    """Registers, static shared memory, stack and spills of every kernel
    function, from the ``-Xptxas -v`` output of each library's build."""
    rows = []
    for lib, text in build_log.items():
        row = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                row = dict(library=lib, function=_demangle(m.group(1)))
                rows.append(row)
                continue
            if row is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                row.update(stack_bytes=int(m.group(1)),
                           spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                row["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                row["static_smem_bytes"] = int(m.group(1)) if m else 0
    return rows


def _demangle(name: str) -> str:
    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return name
    return out or name


def sass_counts() -> dict:
    """Tensor-core instructions in each kernel library's SASS, counted
    with ``cuobjdump -sass`` where the toolkit has it ({} where not)."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        return {}
    counts = {}
    for name in _build.KERNELS:
        sass = subprocess.run(
            [tool, "-sass", os.fspath(_build.library_path(name))],
            capture_output=True, text=True, check=True, timeout=120).stdout
        counts[name] = {op: sum(1 for line in sass.splitlines()
                                if re.search(rf"\b{op}\b", line))
                        for op in ("HGMMA", "HMMA")}
    return counts


def sfu_rate() -> float:
    """Special-function-unit operations per second: SMs x 16 per clock x
    the card's maximum SM clock (``nvidia-smi``)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * SFU_PER_SM_CLOCK * mhz * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as dry_root:
        dry = start_dryrun(dry_root)
        try:
            return run_phases(dry)
        finally:
            stop_dryrun(dry)


def run_phases(dry: dict) -> int:
    """Every phase, in order (``main``), with the background dry run
    ``dry`` (:func:`start_dryrun`) read by the ``roofline`` phase."""
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    hbm, f32_peak, bf16_peak = peaks(kind)
    print(smi, flush=True)
    log("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        hbm_bytes_per_s=hbm, f32_flops=f32_peak, bf16_flops=bf16_peak,
        tf32=False)

    t0 = time.perf_counter()
    per_kernel = _build.build_all(_build.KERNELS, verbose=True)
    log("build", seconds=time.perf_counter() - t0, per_kernel=per_kernel)
    for row in ptxas_report(_build.BUILD_LOG):
        log("build.ptxas", **row)
    sass = sass_counts()
    log("build.sass", **sass)
    if "flash_attention" in sass:
        require(sass["flash_attention"]["HGMMA"] > 0,
                "the bf16 flash kernel runs on the tensor cores (HGMMA)")
    sfu_ops_per_s = sfu_rate()

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    points = phase_kernels(flush, hbm, f32_peak)
    leaves = phase_aggregate_leaves(flush, hbm, f32_peak)
    lanes = phase_aggregate_lanes(flush, hbm, f32_peak)
    resnet_agg = phase_aggregate_resnet(flush, hbm, f32_peak)
    reduce_leaves = phase_delta_reduce_leaves(flush, hbm, f32_peak)
    flash = phase_flash(flush, hbm, f32_peak, bf16_peak, sfu_ops_per_s)
    ssd = phase_ssd(flush, hbm, f32_peak, bf16_peak)
    flash_lse = phase_flash_lse(flush, hbm, f32_peak, bf16_peak)
    del flush
    phase_reference()
    phase_reference_lm()
    phase_reference_scan()
    phase_reference_arena()
    phase_reference_tiered()
    phase_reference_sweep()
    phase_reference_sequential()
    phase_reference_train()
    main_summary = phase_main_path()
    ladder = main_summary.pop("trainer")
    data = main_summary.pop("data")
    single_summary = phase_main_path(data=data, bank_mode="single",
                                     label="main.single")
    single = single_summary.pop("trainer")
    test = single_summary.pop("test")
    del main_summary["test"], single_summary["data"]
    with tempfile.TemporaryDirectory() as root:
        shard = phase_shard(root, data, {
            "auto": main_summary.pop("snapshots"),
            "single": single_summary.pop("snapshots")}, {
            "auto": main_summary["bank_bytes"],
            "single": single_summary["bank_bytes"]})
    phase_profile(ladder, ROUNDS)
    phase_profile(single, ROUNDS, "profile.single")
    with cudnn_deterministic():
        scan_summary = phase_scan(single)
    arena_summary = phase_arena(single, scan_summary, test)
    map_summary = phase_arena_map(single, scan_summary)
    phase_arena_round(ladder, scan_summary, label="arena.tiered")
    sweep_summary = phase_sweep(ladder)
    phase_scale(ladder, single, data)
    warmups = {"warmup.arena": phase_warmup_arena(ladder),
               "warmup.sweep": phase_warmup_sweep(ladder),
               "warmup.pool": phase_warmup_pool(ladder, data)}
    for key in ("h_seq", "lr_seq", "init", "results", "queues"):
        del scan_summary[key]
    del ladder, single, test, data
    gc.collect()
    torch.cuda.empty_cache()

    cifar = phase_paper("paper.cifar", PAPER_CIFAR)
    phase_paper_sequential(PAPER_CIFAR, cifar)
    del cifar["data"]
    femnist = phase_paper("paper.femnist", PAPER_FEMNIST, profile=True)
    del femnist["data"]
    phase_heterogeneity()
    gc.collect()
    torch.cuda.empty_cache()

    gemma = phase_serve_gemma2()
    phase_profile_serve(gemma)
    for key in ("model", "params", "prompts"):
        del gemma[key]
    gc.collect()
    torch.cuda.empty_cache()
    mamba = phase_serve_mamba2()
    for key in ("model", "params", "prompts"):
        del mamba[key]
    gc.collect()
    torch.cuda.empty_cache()
    families = {phase: phase_serve_family(phase, arch, depth, spec)
                for phase, arch, depth, spec in FAMILY_SERVE}

    gemma_train = phase_train_gemma2b()
    fl_round = phase_fl_round_gemma2b(gemma_train.pop("model"),
                                      gemma_train.pop("params"))
    gc.collect()
    torch.cuda.empty_cache()
    training = {"train.gemma2b": gemma_train, "fl_round.gemma2b": fl_round,
                "train.mamba2": phase_train_mamba2()}
    gc.collect()
    torch.cuda.empty_cache()
    examples = phase_examples()
    phase_roofline(dry, {
        "train.gemma2b": gemma_train["step_s_median"],
        "fl_round.gemma2b": statistics.median(fl_round["round_s"]),
        "serve.gemma2": gemma["prefill_s"],
        "serve.mamba2": mamba["prefill_s"]}, smi)

    print(json.dumps(kernels_line(points, leaves, lanes, resnet_agg,
                                  main_summary, single_summary, scan_summary,
                                  arena_summary, map_summary, sweep_summary,
                                  {"paper.cifar": cifar,
                                   "paper.femnist": femnist},
                                  flash, ssd, gemma, mamba, families, smi,
                                  sass, flash_lse, training, reduce_leaves,
                                  shard, warmups, examples)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
