"""The port's arch bridge (``repro_torch.core.arch_bridge``) held against
``repro.core.arch_bridge`` for all ten registered archs: update bits and
cycles per sample exactly, every ``SystemParams`` field within 1e-6
relative, and LROA's Algorithm 2 (``solve_p2``) on each arch's workload
within the port's 1e-4."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core import arch_bridge as jab  # noqa: E402
from repro.core import solve_p2 as jsolve  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core import arch_bridge as tab  # noqa: E402
from repro_torch.core import estimate_hyperparams, solve_p2  # noqa: E402
from repro_torch.core.system_model import ARRAY_FIELDS  # noqa: E402

ARCHS = sorted(jconfigs.ARCHS)
PROFILES = [dict(), dict(num_devices=12, seq_len=2048, wire_bits=32,
                         upload_only_active=False, energy_budget_j=5.0)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("profile", PROFILES, ids=["default", "custom"])
def test_bits_cycles_and_system_params_match_jax(arch, profile):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jprof, tprof = jab.EdgeProfile(**profile), tab.EdgeProfile(**profile)
    assert dataclasses.asdict(jprof) == dataclasses.asdict(tprof)
    assert tab.update_bits(tcfg, tprof) == jab.update_bits(jcfg, jprof)
    assert tab.cycles_per_sample(tcfg, tprof) == \
        jab.cycles_per_sample(jcfg, jprof)
    jsp = jab.system_params_for_arch(jcfg, jprof, seed=3)
    tsp = tab.system_params_for_arch(tcfg, tprof, seed=3, device="cpu")
    for name in ("num_devices", "sample_count", "local_epochs",
                 "bandwidth_hz", "noise_power", "model_bits",
                 "download_rate"):
        assert getattr(tsp, name) == pytest.approx(getattr(jsp, name),
                                                   rel=1e-6), name
    for name in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(tsp, name).numpy(),
                                   np.asarray(getattr(jsp, name)),
                                   rtol=1e-6, err_msg=name)


def test_moe_uploads_active_experts_only():
    cfg = tconfigs.get_config("grok-1-314b")
    active = tab.update_bits(cfg, tab.EdgeProfile())
    full = tab.update_bits(cfg, tab.EdgeProfile(upload_only_active=False))
    assert active < 0.3 * full


@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-130m",
                                  "whisper-tiny"])
def test_lroa_decides_on_the_arch_workload_as_jax(arch):
    """Algorithm 2 on each side's SystemParams over the same channel:
    q on the simplex, (f, p, q) within 1e-4 relative of JAX's."""
    from repro.core import estimate_hyperparams as jest
    n = 12
    prof = dict(num_devices=n)
    jsp = jab.system_params_for_arch(jconfigs.get_config(arch),
                                     jab.EdgeProfile(**prof))
    tsp = tab.system_params_for_arch(tconfigs.get_config(arch),
                                     tab.EdgeProfile(**prof), device="cpu")
    h = np.clip(np.random.default_rng(0).exponential(0.1, n), 0.01,
                0.5).astype(np.float32)
    jhp, thp = jest(jsp, 0.1, loss_scale=2.0), \
        estimate_hyperparams(tsp, 0.1, loss_scale=2.0)
    jd = jsolve(jsp, jnp.asarray(h), jnp.zeros((n,)), jhp.V, jhp.lam)
    td = solve_p2(tsp, torch.as_tensor(h), torch.zeros(n), thp.V, thp.lam)
    assert abs(float(td.q.sum()) - 1.0) < 1e-4
    for name in ("f", "p", "q"):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)),
                                   rtol=1e-4, atol=1e-9, err_msg=name)
