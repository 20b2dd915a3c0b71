"""The port's scenario arena (``repro_torch.sim.Arena``) against the JAX
package's ``repro.sim.Arena`` at N = 6, T = 3 (an ``MLPTask`` on a bank
with unequal clients): a mixed-K grid of all seven controllers (K = 3,
and two lanes at K = 2 padded to K_max = 3), with ``k_mode='pad'`` and
``'group'``, dropout given as ``drop_all``, the same channels in.  The
reference's lanes' selections and epoch keys are replayed (its epoch
keys rebuilt from ``repro.sim.scenario_keys(grid)[1][s]`` as its scan
splits them); round-robin and DivFL lanes also select as the reference
with no replay.  Params, queues and every metric within 1e-4.  Then the
port's own contracts: pad against group bitwise on the CPU, every lane
against the port's ``run_scan`` under the arena's contract, the
``eval_every`` columns and final evaluation against the JAX
``EvalBank``, the grid constructors and their validation against the
JAX package's, a ``mesh=`` that is no ``DeviceMesh`` and warmup's
``aot=True``, which eager PyTorch has no path for; the chunked, planned and mapped modes are held in
``tests/test_torch_streaming.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.sim as jsim  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro.data import synthetic_image_classification  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 system_params_from_numpy)

N, E, BS, T = 6, 2, 8, 3
SIZES = [40, 24, 33, 17, 48, 30]
TOL = 1e-4
METRICS = ("loss", "wall_time", "energy_mean", "queue_mean", "queue_norm",
           "q_min", "q_max")
# two padded lanes (K = 2 in a K_max = 3 grid): LROA and round-robin; the
# reference's padded slots are NaN for a channel-aware lane whose client
# 0 gets q = 0 (ROADMAP, section C), which test_padded_channel_aware_lane
# holds the port to on its own
GRID_K = [3] * 7 + [2, 2]
GRID_CONTROLLERS = list(tc.POLICIES) + ["lroa", "round_robin"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grid(pkg, hp):
    return pkg.ScenarioGrid.create(
        GRID_CONTROLLERS, seeds=np.arange(len(GRID_K)) + 3, V=hp.V,
        lam=hp.lam, sample_count=GRID_K, energy_scale=[1.0] * 8 + [0.8],
        num_devices=N)


@pytest.fixture(scope="module")
def bed():
    """Both packages' engines, banks, params, grids and eval banks, and
    the reference arena's runs: padded with dropout and eval_every=1,
    grouped without."""
    x, y = synthetic_image_classification(sum(SIZES), (8, 8, 1), 4,
                                          noise=0.3, seed=3)
    offs = np.cumsum([0] + SIZES)
    clients = [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
               for i in range(N)]
    sp = jc.paper_default_params(num_devices=N, sample_count=3,
                                 local_epochs=E,
                                 data_sizes=np.asarray(SIZES, np.float32))
    jtask = jm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    ttask = tm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    jeng = jfl.RoundEngine(jtask, jfl.ClientConfig(local_epochs=E,
                                                   batch_size=BS))
    teng = tfl.RoundEngine(ttask, tfl.ClientConfig(local_epochs=E,
                                                   batch_size=BS),
                           device="cpu")
    p0 = jtask.init(jax.random.PRNGKey(0))
    hp = jc.estimate_hyperparams(sp, 0.1, 1.5)
    xt, yt = synthetic_image_classification(60, (8, 8, 1), 4, noise=0.3,
                                            seed=9)
    bed = dict(
        sp=sp, tp=system_params_from_numpy(sp, "cpu"), jeng=jeng, teng=teng,
        jbank=jeng.make_bank(clients, "single"),
        tbank=teng.make_bank(clients, "single"), jp0=p0,
        tp0=params_from_jax({n: np.asarray(v) for n, v in p0.items()},
                            ttask, device="cpu"),
        jgrid=_grid(jsim, hp), tgrid=_grid(tsim, hp),
        h=np.random.default_rng(5).uniform(0.05, 0.4, (len(GRID_K), T, N)
                                           ).astype(np.float32),
        drop=(np.random.default_rng(6).uniform(size=(len(GRID_K), T, N))
              >= 0.25).astype(np.float32),
        lr=np.asarray([0.1, 0.1, 0.05], np.float32), xt=xt, yt=yt,
        jeval=jsim.EvalBank(jtask, xt, yt),
        teval=tsim.EvalBank(ttask, xt, yt, device="cpu"))
    bed["drop"][7, 1] = 0.0            # every client of lane 7 drops once
    rows = bed["jbank"].bucket_examples
    assert bed["tbank"].bucket_examples == rows
    bed["jrun"] = {
        "pad": jsim.Arena(jeng, k_mode="pad").run(
            p0, sp, bed["jbank"], bed["jgrid"], T, bed["lr"],
            h_all=bed["h"], drop_all=bed["drop"], eval_bank=bed["jeval"],
            eval_every=1),
        "group": jsim.Arena(jeng, k_mode="group").run(
            p0, sp, bed["jbank"], bed["jgrid"], T, bed["lr"],
            h_all=bed["h"])}
    roll = jsim.scenario_keys(bed["jgrid"])[1]
    bed["jkeys"] = np.stack([_jax_epoch_keys(roll[s], rows, 3)
                             for s in range(len(GRID_K))])
    return bed


def _jax_epoch_keys(rng, rows, k):
    """The reference scan's ``[T, k, E, B]`` epoch keys: per round ``rng,
    k_sel, k_cli = split(rng, 3)``, per slot ``fold_in(k_cli, i)``, then
    ``split(., E)`` and ``uniform``."""
    out = np.zeros((T, k, E, rows), np.float32)
    for t in range(T):
        rng, _, k_cli = jax.random.split(rng, 3)
        for i in range(k):
            for e, ek in enumerate(jax.random.split(
                    jax.random.fold_in(k_cli, i), E)):
                out[t, i, e] = np.asarray(jax.random.uniform(ek, (rows,)))
    return out


def _port_run(bed, k_mode, replay=True, **kw):
    mode = "pad" if "drop_all" in kw else "group"
    return tsim.Arena(bed["teng"], k_mode=k_mode).run(
        bed["tp0"], bed["tp"], bed["tbank"], bed["tgrid"], T, bed["lr"],
        h_all=bed["h"],
        replay_selected=(bed["jrun"][mode].metrics["selected"] if replay
                         else None),
        replay_sort_keys=bed["jkeys"] if replay else None, **kw)


def _assert_close_to_reference(bed, rep, jrep):
    np.testing.assert_array_equal(rep.metrics["selected"],
                                  jrep.metrics["selected"])
    for name in METRICS:
        assert rep.metrics[name].shape == (len(GRID_K), T), name
        np.testing.assert_allclose(rep.metrics[name], jrep.metrics[name],
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_allclose(rep.queues, np.asarray(jrep.queues),
                               rtol=TOL, atol=TOL)
    for s in range(len(GRID_K)):
        want = params_from_jax(
            {n: np.asarray(v[s]) for n, v in jrep.params.items()},
            bed["teng"].task, device="cpu")
        for name, v in want.items():
            np.testing.assert_allclose(rep.params[name][s].numpy(),
                                       v.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"lane {s} {name}")


@pytest.mark.parametrize("k_mode", ["pad", "group"])
def test_arena_matches_reference(bed, k_mode):
    """pad: with dropout and in-rollout evaluation; group: without."""
    if k_mode == "pad":
        rep = _port_run(bed, k_mode, drop_all=bed["drop"],
                        eval_bank=bed["teval"], eval_every=1)
    else:
        rep = _port_run(bed, k_mode)
    jrep = bed["jrun"][k_mode]
    _assert_close_to_reference(bed, rep, jrep)
    assert rep.meta["k_groups"] == jrep.meta["k_groups"] == [2, 3]
    assert rep.meta["plan"] == jrep.meta["plan"]
    assert rep.meta["dispatches"] == (1 if k_mode == "pad" else 2)
    assert rep.dispatch_accounting()["lanes_covered"] == len(GRID_K)
    assert np.all(rep.metrics["selected"][7:, :, 2] == -1)
    if k_mode == "pad":
        assert rep.metrics["wall_time"][7, 1] == 0.0


def test_deterministic_lanes_select_as_reference(bed):
    """Round-robin and DivFL lanes pick what the reference picks from
    the port's own draws (nothing replayed)."""
    rep = _port_run(bed, "pad", replay=False, drop_all=bed["drop"])
    jsel = bed["jrun"]["pad"].metrics["selected"]
    for s, name in enumerate(GRID_CONTROLLERS):
        if name in ("round_robin", "divfl"):
            np.testing.assert_array_equal(rep.metrics["selected"][s],
                                          jsel[s], err_msg=f"lane {s}")


def test_eval_columns_and_final_metrics_match_reference(bed):
    rep = _port_run(bed, "pad", drop_all=bed["drop"],
                    eval_bank=bed["teval"], eval_every=2)
    jrep = jsim.Arena(bed["jeng"]).run(
        bed["jp0"], bed["sp"], bed["jbank"], bed["jgrid"], T, bed["lr"],
        h_all=bed["h"], drop_all=bed["drop"], eval_bank=bed["jeval"],
        eval_every=2)
    for name in ("test_accuracy", "test_loss"):
        assert rep.metrics[name].shape == (len(GRID_K), T)
        np.testing.assert_allclose(rep.metrics[name], jrep.metrics[name],
                                   rtol=TOL, atol=TOL, err_msg=name)
        np.testing.assert_allclose(rep.final_metrics[name],
                                   jrep.final_metrics[name], rtol=TOL,
                                   atol=TOL, err_msg=name)
    # a step curve: round 0 holds the initial evaluation, round 1 the
    # evaluation after it, round 2 the same
    acc = rep.metrics["test_accuracy"]
    assert np.all(acc[:, 0] == acc[0, 0])
    np.testing.assert_array_equal(acc[:, 2], acc[:, 1])
    np.testing.assert_array_equal(rep.final_accuracy(),
                                  rep.final_metrics["test_accuracy"])
    one = bed["teval"].evaluate_one(rep.scenario_params(4))
    np.testing.assert_allclose(rep.final_metrics["test_loss"][4],
                               one["loss"], rtol=1e-6)


@pytest.mark.parametrize("lanes_per_call", [1, 2, 4])
def test_eval_bank_chunks_are_bitwise_the_one_shot_call(bed, lanes_per_call):
    """The stacked evaluation in calls of a few lanes gives the one-shot
    call's numbers bit for bit (CPU): directly, in the in-rollout test
    columns and in ``final_metrics``."""
    task = bed["teng"].task
    chunked = tsim.EvalBank(task, bed["xt"], bed["yt"], device="cpu",
                            lanes_per_call=lanes_per_call)
    assert bed["teval"].lanes_per_call >= len(GRID_K)
    runs = [_port_run(bed, "pad", eval_bank=ev, eval_every=1)
            for ev in (bed["teval"], chunked)]
    for name in ("test_accuracy", "test_loss"):
        np.testing.assert_array_equal(runs[1].metrics[name],
                                      runs[0].metrics[name], err_msg=name)
        np.testing.assert_array_equal(runs[1].final_metrics[name],
                                      runs[0].final_metrics[name],
                                      err_msg=name)
    one, got = (ev.metrics_stacked(runs[0].params)
                for ev in (bed["teval"], chunked))
    for name in one:
        assert got[name].shape == (len(GRID_K),)
        assert torch.equal(got[name], one[name]), name


def test_eval_bank_chunk_follows_the_test_set_size(bed):
    task = bed["teng"].task
    x = np.zeros((7500, 8, 8, 1), np.float32)
    y = np.zeros(7500, np.int64)
    assert tsim.EvalBank(task, x, y, device="cpu").lanes_per_call == 2
    assert tsim.EvalBank(task, x[:60], y[:60],
                         device="cpu").lanes_per_call == 273
    assert tsim.EvalBank(task, np.zeros((20000, 8, 8, 1), np.float32),
                         np.zeros(20000, np.int64),
                         device="cpu").lanes_per_call == 1


def test_pad_and_group_are_bitwise(bed):
    """On the CPU (one thread) the padded lanes' trajectories are the
    grouped ones, bit for bit, dropout included."""
    pad, grp = (tsim.Arena(bed["teng"], k_mode=m).run(
        bed["tp0"], bed["tp"], bed["tbank"], bed["tgrid"], T, bed["lr"],
        drop_all=bed["drop"]) for m in ("pad", "group"))
    for name in pad.metrics:
        np.testing.assert_array_equal(pad.metrics[name], grp.metrics[name],
                                      err_msg=name)
    np.testing.assert_array_equal(pad.queues, grp.queues)
    for name in pad.params:
        assert torch.equal(pad.params[name], grp.params[name]), name


@pytest.mark.parametrize("k_mode", ["pad", "group"])
def test_lanes_reproduce_run_scan(bed, k_mode):
    """Lane s is ``run_scan`` on scenario s with the generator of its seed,
    its channels and alive mask, at the lane's slot count: selections
    exact, and on the CPU (one thread) the model, losses, latencies,
    queues and every metric bitwise too."""
    grid = bed["tgrid"]
    arena = tsim.Arena(bed["teng"], k_mode=k_mode)
    rep = arena.run(bed["tp0"], bed["tp"], bed["tbank"], grid, T,
                    bed["lr"], drop_all=bed["drop"])
    h_all = arena.sample_channels(grid, T, N)
    k_max = int(grid.sample_count.max())
    for s in range(len(grid)):
        k = k_max if k_mode == "pad" else int(grid.sample_count[s])
        params, queues, met = bed["teng"].run_scan(
            bed["tp0"], grid.scenario_system_params(bed["tp"], s),
            bed["tbank"], h_all[s].numpy(), bed["lr"],
            torch.Generator().manual_seed(int(grid.seed[s])),
            policy=grid.controller_names()[s], V=grid.V[s],
            lam=grid.lam[s], drop_seq=bed["drop"][s], k_max=k)
        np.testing.assert_array_equal(rep.metrics["selected"][s][:, :k],
                                      met["selected"], err_msg=f"lane {s}")
        for name in METRICS + ("q_sum",):
            np.testing.assert_array_equal(rep.metrics[name][s], met[name],
                                          err_msg=f"lane {s} {name}")
        np.testing.assert_array_equal(rep.queues[s], queues.numpy())
        for name in params:
            assert torch.equal(rep.params[name][s], params[name]), (s, name)


def test_padded_channel_aware_lane_stays_finite(bed):
    """A channel-aware lane at K = 2 padded to 3, client 0 on the weakest
    channel (q = 0): its padded slots land on client 0 with coefficient
    exactly 0, so the lane is finite and bitwise its unpadded rollout
    (the reference's w / (K q) * 0 is NaN there: ROADMAP, section C)."""
    grid = tsim.ScenarioGrid.create(["channel_aware", "lroa"], seeds=[1, 2],
                                    V=1.0, lam=1.0, sample_count=[2, 3])
    h = bed["h"][:2].copy()
    h[:, :, 0] = 0.01
    arena = tsim.Arena(bed["teng"])
    rep = arena.run(bed["tp0"], bed["tp"], bed["tbank"], grid, T,
                    bed["lr"], h_all=h)
    single = arena.run(bed["tp0"], bed["tp"], bed["tbank"], grid.take([0]),
                       T, bed["lr"], h_all=h[:1])
    assert rep.meta["k_max"] == 3 and single.meta["k_max"] == 2
    assert np.all(rep.metrics["q_min"][0] == 0.0)
    for name in rep.params:
        assert bool(torch.isfinite(rep.params[name]).all()), name
        assert torch.equal(rep.params[name][0], single.params[name][0])


def test_channels_and_dropout_are_drawn_on_the_lanes(bed):
    """Default channels and masks come from the grid's seeds: lane-wise
    statistics, bitwise repeatable, cached by grid content."""
    grid = tsim.ScenarioGrid.create(
        ["lroa", "uni_d", "lroa"], seeds=[1, 2, 1], V=1.0, lam=1.0,
        mean_gain=[0.1, 0.05, 0.1], dropout=[0.0, 0.0, 0.3], sample_count=2)
    arena = tsim.Arena(bed["teng"])
    h = arena.sample_channels(grid, 40, N)
    assert h.shape == (3, 40, N) and h.dtype == torch.float32
    assert float(h.min()) >= 0.01 and float(h.max()) <= 0.5
    torch.testing.assert_close(h[0], h[2], rtol=0, atol=0)   # same seed
    assert not torch.equal(h[0], h[1])
    drop = arena.sample_dropout(grid, 40, N)
    assert float(drop[:2].min()) == 1.0 and 0.0 < float(drop[2].mean()) < 1.0
    hits = arena.input_cache_hits
    assert arena.sample_channels(grid, 40, N) is h
    assert arena.input_cache_hits == hits + 1
    rep = arena.run(bed["tp0"], bed["tp"], bed["tbank"], grid, 2,
                    bed["lr"][:2])
    assert arena.metrics.counter("arena.runs").value == 1
    assert rep.metrics["loss"].shape == (3, 2)
    assert np.all(np.isfinite(rep.metrics["loss"]))


def test_scenario_keys_are_the_run_scan_generators(bed):
    grid = bed["tgrid"]
    chan, roll = tsim.scenario_keys(grid)
    assert chan.dtype == roll.dtype == torch.int64
    for s, seed in enumerate(grid.seed):
        gen = torch.Generator().manual_seed(int(seed))
        assert int(roll[s]) == int(torch.randint(0, 2 ** 62, (),
                                                 generator=gen))
    assert len(set(chan.tolist())) == len(set(grid.seed.tolist()))


def test_derive_hyperparams_matches_reference(bed):
    kw = dict(mu=[1.0, 2.0, 0.5], nu=[1e5, 1e4, 1e5], loss_scale=1.5)
    args = (["lroa", "uni_d", "lroa"], [0, 1, 2], 0.0, 0.0)
    opts = dict(sample_count=[2, 3, 3], mean_gain=[0.1, 0.2, 0.1],
                energy_scale=[1.0, 0.5, 2.0])
    want = jsim.derive_hyperparams(
        bed["sp"], jsim.ScenarioGrid.create(*args, **opts), **kw)
    got = tsim.derive_hyperparams(
        bed["tp"], tsim.ScenarioGrid.create(*args, **opts), **kw)
    np.testing.assert_allclose(got.lam, want.lam, rtol=1e-5)
    np.testing.assert_allclose(got.V, want.V, rtol=1e-5)


def _fields(grid):
    return {f.name: getattr(grid, f.name) for f in dataclasses.fields(grid)}


GRID_CASES = {
    "create": lambda pkg: pkg.ScenarioGrid.create(
        ["lroa", 2, "divfl"], seeds=[0, 1, 2], V=[1.0, 2.0, 3.0], lam=0.5,
        sample_count=[2, 3, 2], chan_mode=["iid", "markov", 0],
        p_gb=0.1, p_bg=0.2, dropout=[0.0, 0.1, 0.2], num_devices=N),
    "product": lambda pkg: pkg.ScenarioGrid.product(
        ["lroa", "uni_s"], [0, 5], [1.0, 10.0], [0.1], energy_scale=(1.0,
                                                                     0.5),
        sample_count=(2, 4), chan_mode=("iid", "markov"), dropout=(0.0,
                                                                   0.3)),
    "take": lambda pkg: pkg.ScenarioGrid.product(
        list(pkg.ScenarioGrid._controller_ids(["lroa", "uni_d"])),
        [0, 1, 2], 1.0, 0.1).take(np.asarray([4, 0, 2])),
    "concat": lambda pkg: pkg.ScenarioGrid.concat([
        pkg.ScenarioGrid.create("lroa", 0, 1.0, 0.1),
        pkg.ScenarioGrid.create(["uni_d", "round_robin"], [3, 4], 2.0,
                                0.2, sample_count=3)]),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_constructors_match_reference(case):
    got, want = _fields(GRID_CASES[case](tsim)), _fields(
        GRID_CASES[case](jsim))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    grid = GRID_CASES[case](tsim)
    jgrid = GRID_CASES[case](jsim)
    assert grid.controller_names() == jgrid.controller_names()
    assert grid.channel_mode_names() == jgrid.channel_mode_names()
    for s in range(len(grid)):
        assert dataclasses.asdict(grid.channel_config(s)) == \
            dataclasses.asdict(jgrid.channel_config(s))


BAD_GRIDS = {
    "unknown_controller": dict(controllers="fedavg"),
    "controller_id": dict(controllers=9),
    "channel_mode": dict(chan_mode="rayleigh"),
    "k_above_n": dict(sample_count=7, num_devices=N),
    "k_zero": dict(sample_count=0),
    "seed": dict(seeds=2 ** 33),
    "dropout": dict(dropout=1.0),
    "p_gb": dict(p_gb=1.5),
}


@pytest.mark.parametrize("case", sorted(BAD_GRIDS))
def test_grid_validation_matches_reference(case):
    kw = dict(controllers="lroa", seeds=0, V=1.0, lam=0.1)
    kw.update(BAD_GRIDS[case])
    messages = []
    for pkg in (jsim, tsim):
        with pytest.raises(ValueError) as err:
            pkg.ScenarioGrid.create(kw.pop("controllers"), kw.pop("seeds"),
                                    kw.pop("V"), kw.pop("lam"), **kw)
        messages.append(str(err.value))
        kw = dict(controllers="lroa", seeds=0, V=1.0, lam=0.1)
        kw.update(BAD_GRIDS[case])
    assert messages[0] == messages[1]


@pytest.mark.parametrize("kwargs", [dict(mesh=object())], ids=["mesh"])
def test_unported_modes_raise(bed, kwargs):
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsim.Arena(bed["teng"], **kwargs)


def test_unported_run_options_raise(bed):
    arena = tsim.Arena(bed["teng"])
    # eager PyTorch builds nothing ahead of a run: warmup runs each bucket
    with pytest.raises(ValueError, match="compiles nothing ahead"):
        arena.warmup(bed["tp0"], bed["tp"], bed["tbank"], bed["tgrid"], T,
                     aot=True)
    assert not tsim.aot_cache_warmup_supported()
    with pytest.raises(ValueError):
        tsim.Arena(bed["teng"], k_mode="bogus")
    with pytest.raises(ValueError, match="eval_every requires"):
        arena.run(bed["tp0"], bed["tp"], bed["tbank"], bed["tgrid"], T,
                  bed["lr"], eval_every=1)
    with pytest.raises(ValueError, match="h_all must have shape"):
        arena.run(bed["tp0"], bed["tp"], bed["tbank"], bed["tgrid"], T,
                  bed["lr"], h_all=bed["h"][:, :2])
