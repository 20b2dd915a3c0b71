"""The port's mixture-of-experts layer (``repro_torch.models.moe``) and the
MoE family (granite-moe, grok-1) held against the JAX package on the CPU:
the router, its top-k (ties included), the sort dispatch's keep-set index
for index, the three dispatches' outputs and aux loss, the model's
logits, caches and loss (cross-entropy plus the router's aux term), and
greedy generation against the JAX serving loop.

Inputs come from numpy seeds; everything runs in f32.  Tolerances: 1e-4
for outputs, aux and loss; the router's choices and the keep-set are
compared exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from test_torch_lm import _close, _pair, check_greedy_against_jax  # noqa

ARCHS = ["granite-moe-3b-a800m", "grok-1-314b"]


def _moe_setup(arch, seed=0, **over):
    """The smoke config of ``arch`` (with ``over``), JAX MoE params and
    the same params as tensors, and an input [2, 12, d]."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **over)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _jax_sort_plan(top_idx, cfg):
    """The sort dispatch's (order, buf_idx, keep) as
    ``repro.models.moe.apply_moe`` computes them for each group (its
    ``group_dispatch``, lines 105-116, in jnp on the JAX side)."""
    t, topk = top_idx.shape
    e = cfg.num_experts
    g = max(1, min(cfg.moe_groups, t))
    while t % g:
        g -= 1
    cap = int(max(1, round(cfg.moe_capacity_factor * (t // g) * topk / e)))
    outs = []
    for flat_expert in jnp.asarray(top_idx).reshape(g, -1):
        order = jnp.argsort(flat_expert, stable=True)
        sorted_expert = jnp.take(flat_expert, order)
        counts = jnp.sum(jax.nn.one_hot(flat_expert, e, dtype=jnp.float32),
                         axis=0).astype(jnp.int32)
        starts = jnp.cumsum(counts) - counts
        pos = jnp.arange(flat_expert.shape[0]) - jnp.take(starts,
                                                          sorted_expert)
        keep = pos < cap
        outs.append((order, jnp.where(keep, sorted_expert * cap + pos,
                                      e * cap), keep))
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]


def test_top_k_breaks_ties_toward_the_lower_index():
    rng = np.random.default_rng(0)
    p = rng.integers(0, 4, (64, 8)).astype(np.float32)      # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(p), 3)
    tv, ti = tmoe.top_k(torch.as_tensor(p), 3)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups,factor", [(1, 1.25), (3, 0.5), (4, 1.0)])
def test_sort_keep_set_equals_jax_index_for_index(arch, groups, factor):
    """Groups and capacities with drops (factor 0.5) and a router with two
    equal columns, so exact ties in the router's probabilities occur."""
    jcfg, tcfg, jp, tp, x = _moe_setup(arch, moe_groups=groups,
                                       moe_capacity_factor=factor)
    jp = dict(jp, router=jp["router"].at[:, 1].set(jp["router"][:, 0]))
    tp = dict(tp, router=torch.as_tensor(np.array(jp["router"])))
    xt = x.reshape(-1, jcfg.d_model)
    jprobs = jmoe.router_probs(jp, jnp.asarray(xt))
    tprobs = tmoe.router_probs(tp, torch.as_tensor(xt))
    _close(tprobs, jprobs, 1e-6)
    _, jidx = jax.lax.top_k(jprobs, jcfg.experts_per_token)
    _, tidx = tmoe.top_k(tprobs, tcfg.experts_per_token)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    # the plan from the same choices, index for index
    order, buf_idx, keep, cap = tmoe.sort_dispatch_plan(
        torch.as_tensor(np.array(jidx)).long(), tcfg)
    jorder, jbuf, jkeep = _jax_sort_plan(np.asarray(jidx), jcfg)
    assert np.array_equal(order.numpy(), jorder)
    assert np.array_equal(buf_idx.numpy(), jbuf)
    assert np.array_equal(keep.numpy(), jkeep)
    if factor < 1:
        assert not keep.all()                         # tokens were dropped
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, "sort")
    ty, taux = tmoe.apply_moe(tp, torch.as_tensor(x), tcfg, "sort")
    _close(ty, jy, 1e-4)
    _close(taux, jaux, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch", ["sort", "capacity", "dense"])
def test_dispatches_match_jax(arch, dispatch):
    jcfg, tcfg, jp, tp, x = _moe_setup(arch, seed=1,
                                       moe_capacity_factor=0.75)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, dispatch)
    ty, taux = tmoe.apply_moe(tp, torch.as_tensor(x), tcfg, dispatch)
    assert ty.dtype == torch.float32 and ty.shape == x.shape
    _close(ty, jy, 1e-4)
    _close(taux, jaux, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_sort_equals_capacity_with_one_group(arch):
    _, tcfg, _, tp, x = _moe_setup(arch, seed=2, moe_capacity_factor=0.75)
    ys, auxs = tmoe.apply_moe(tp, torch.as_tensor(x), tcfg, "sort")
    yc, auxc = tmoe.apply_moe(tp, torch.as_tensor(x), tcfg, "capacity")
    np.testing.assert_allclose(ys.numpy(), yc.numpy(), atol=1e-5, rtol=1e-5)
    assert float(auxs) == float(auxc)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_apply_and_loss_match_jax(arch):
    """Train and prefill logits, prefill caches, the summed aux loss and
    ``loss`` = cross-entropy + router_aux_loss_coef * aux."""
    jm, jp, tm, tp = _pair(arch, dict(moe_groups=2))
    toks = np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (2, 24)).astype(np.int32)
    for mode in ("train", "prefill"):
        jl, jaux, jcache = jm.apply(jp, jnp.asarray(toks), mode=mode)
        tl, taux, tcache = tm.apply(tp, torch.as_tensor(toks), mode=mode)
        _close(tl, jl, 1e-4)
        _close(taux, jaux, 1e-4)
        assert float(taux) > 0
        if mode == "prefill":
            for a, t in zip(jax.tree_util.tree_leaves(jcache),
                            tree_leaves(tcache)):
                _close(t, a, 1e-4)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    _close(tm.loss(tp, {k: torch.as_tensor(v) for k, v in batch.items()}),
           jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_greedy_generate_matches_the_jax_serving_loop(arch, impl):
    """Prefill dispatches by sort (two groups), decode densely."""
    check_greedy_against_jax(arch, dict(attn_impl=impl, moe_groups=2))
