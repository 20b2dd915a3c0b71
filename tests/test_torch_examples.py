"""The port's drivers against the JAX package's: the testbed
(``repro_torch.sim.testbed``) bitwise ``benchmarks.common``'s;
``examples/quickstart_torch.py`` against ``examples/quickstart.py`` run as
a subprocess; ``examples/fl_simulation_torch.py``'s arena grid against
the JAX ``repro.sim.Arena`` run of the same grid on the reference
testbed, its initial model, channels, selections and epoch keys
replayed; the span log of ``--obs`` rendered by ``tools/obs_report.py``;
``examples/serve_decode_torch.py`` at the JAX example's defaults.  Every
driver runs on the CPU here only because it is asked to
(``device='cpu'``): asked for the card on a machine without one, it
fails."""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.sim as jsim  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from repro.optim import paper_step_decay  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.system_model import ARRAY_FIELDS  # noqa: E402
from repro_torch.sim import testbed  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import fl_simulation_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_decode_torch  # noqa: E402

# the table of the FL simulation, port against the JAX arena with the
# reference's draws replayed: accuracy and total latency, relative and
# absolute
FL_TOL = 1e-4
# quickstart: each printed number within half a unit of its last printed
# digit or QUICK_RTOL relative of the JAX script's; QUICK_ROUNDS of its
# 400 (the port's eager solver takes minutes for the 400 on a CPU),
# so the printed rounds are 0 and 40
QUICK_RTOL = 1e-4
QUICK_ROUNDS = 41
FL_NAMES = ["lroa", "uni_d", "uni_s", "divfl"]
FL_T, FL_N = 3, 8
ENV = dict(os.environ, PYTHONPATH=f"{ROOT}/src:{ROOT}", JAX_PLATFORMS="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the testbed -------------------------------------------------------------


@pytest.mark.parametrize("use_cnn", [False, True], ids=["mlp", "cnn"])
def test_build_testbed_is_bitwise_the_reference(use_cnn):
    jp, jtask, jdata, (jx, jy) = jcommon.build_testbed(
        jcommon.BenchConfig(use_cnn=use_cnn))
    tp, ttask, tdata, (tx, ty) = testbed.build_testbed(
        testbed.BenchConfig(use_cnn=use_cnn), device="cpu")
    assert len(tdata) == len(jdata) == 20
    for (a, b), (c, d) in zip(tdata, jdata):
        assert a.dtype == c.dtype and b.dtype == d.dtype
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for a, b in ((tx, jx), (ty, jy)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tp.device.type == "cpu"
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    for name in ("num_devices", "sample_count", "local_epochs",
                 "bandwidth_hz", "noise_power", "model_bits"):
        assert float(getattr(tp, name)) == float(getattr(jp, name)), name
    assert type(ttask).__name__ == type(jtask).__name__
    want = params_from_jax({k: np.asarray(v) for k, v in
                            jtask.init(jax.random.PRNGKey(0)).items()},
                           ttask, device="cpu")
    got = ttask.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def test_bench_config_matches_the_reference():
    for make in (lambda m: m.BenchConfig(),
                 lambda m: m.BenchConfig(num_devices=9, use_cnn=True),
                 lambda m: m.BenchConfig.paper_scale()):
        assert vars(make(testbed)) == vars(make(jcommon))
    assert list(testbed.CONTROLLERS) == list(jcommon.CONTROLLERS)


@pytest.mark.parametrize("name", list(jcommon.CONTROLLERS))
def test_make_trainer_builds_the_reference_trainer(name):
    cfg = dict(num_devices=6, rounds=12, examples=400)
    kw = dict(mu=2.0, nu=1e4, sample_count=3)
    jt = jcommon.make_trainer(name, jcommon.BenchConfig(**cfg), **kw)
    tt = testbed.make_trainer(name, testbed.BenchConfig(**cfg), **kw,
                              device="cpu")
    assert type(tt.controller).__name__ == type(jt.controller).__name__
    np.testing.assert_allclose([tt.controller.hp.lam, tt.controller.hp.V],
                               [jt.controller.hp.lam, jt.controller.hp.V],
                               rtol=1e-6)
    assert tt.eval_every == jt.eval_every == 2
    assert tt.params.sample_count == jt.params.sample_count == 3
    assert tt.device.type == "cpu"


@pytest.mark.parametrize("name", ["lroa", "uni_s"])
def test_run_controller_matches_the_reference_control_plane(name):
    """The trainer's control plane reads only the seeded numpy channels,
    sampler and queues, so the selections equal the reference's and the
    modelled times, q and queues agree within FL_TOL; the losses (each
    package's own initial model and epoch keys) are finite."""
    cfg = dict(num_devices=6, rounds=3, examples=400)
    want = jcommon.run_controller(name, jcommon.BenchConfig(**cfg)).records
    got = testbed.run_controller(name, testbed.BenchConfig(**cfg),
                                 device="cpu").records
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g.selected) == list(w.selected)
        np.testing.assert_allclose(
            [g.wall_time, g.cum_time, g.q_min, g.q_max, g.queue_mean,
             g.energy_mean],
            [w.wall_time, w.cum_time, w.q_min, w.q_max, w.queue_mean,
             w.energy_mean], rtol=FL_TOL, atol=FL_TOL)
        assert np.isfinite(g.mean_loss)


# -- quickstart ---------------------------------------------------------------

_NUMBER = re.compile(r"-?\d+\.?\d*(?:e[+-]?\d+)?")


def _numbers(line: str) -> list:
    """(value, half a unit of its last printed digit) of every number in
    ``line``."""
    out = []
    for tok in _NUMBER.findall(line):
        dec = len(tok.split(".")[1]) if "." in tok else 0
        out.append((float(tok), 0.5 * 10.0 ** -dec))
    return out


def _quickstart_lines(res: dict) -> list:
    """``quickstart_torch.main``'s printed lines for ``res``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        quickstart_torch.report(res)
    return buf.getvalue().splitlines()


def test_quickstart_matches_the_jax_script():
    src = os.path.join(ROOT, "examples", "quickstart.py")
    code = ("import sys; src = open(sys.argv[1]).read(); "
            "old = 'N_DEVICES, ROUNDS = 40, 400'; assert old in src; "
            "src = src.replace(old, old[:-3] + sys.argv[2]); "
            "exec(compile(src, sys.argv[1], 'exec'), "
            "{'__name__': '__main__'})")
    ref = subprocess.Popen([sys.executable, "-c", code, src,
                            str(QUICK_ROUNDS)], env=ENV,
                           cwd=ROOT, stdout=subprocess.PIPE, text=True)
    res = quickstart_torch.run(rounds=QUICK_ROUNDS, device="cpu")
    out, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0
    want = [line for line in out.splitlines() if line.strip()]
    got = [line for line in _quickstart_lines(res) if line.strip()]
    assert [r["round"] for r in res["rounds"]] == [0, QUICK_ROUNDS - 1]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        for (a, _), (b, half) in zip(_numbers(g), _numbers(w)):
            assert abs(a - b) <= max(half, QUICK_RTOL * abs(b)), (g, w)


# -- the FL simulation --------------------------------------------------------


def _jax_table(grid, report):
    """``examples/fl_simulation.run_arena_grid``'s reduction of a report."""
    total, accuracy = report.total_latency(), report.final_accuracy()
    results = {}
    for s, name in enumerate(grid.controller_names()):
        results.setdefault(name, ([], []))
        results[name][0].append(float(accuracy[s]))
        results[name][1].append(float(total[s]))
    return {name: (float(np.mean(a)), float(np.mean(t)))
            for name, (a, t) in results.items()}


def _epoch_keys(rng, selected, bank, k, epochs):
    """The reference scan's ``[T, k, E, B_max]`` epoch keys: per round
    ``split(rng, 3)``, per slot ``fold_in(k_cli, i)``, ``split(., E)`` and
    ``uniform`` at the slot's bucket (its tier's on a ladder), padded."""
    tier_of = getattr(bank, "tier_of", None)
    width = (bank.bucket_examples if tier_of is None
             else max(bank.tier_buckets))
    out = np.zeros((len(selected), k, epochs, width), np.float32)
    for t, sel in enumerate(selected):
        rng, _, k_cli = jax.random.split(rng, 3)
        for i in range(k):
            rows = (width if tier_of is None else
                    bank.tier_buckets[tier_of[max(int(sel[i]), 0)]])
            for e, ek in enumerate(jax.random.split(
                    jax.random.fold_in(k_cli, i), epochs)):
                out[t, i, e, :rows] = np.asarray(
                    jax.random.uniform(ek, (rows,)))
    return out


@pytest.fixture(scope="module")
def fl_reference():
    """The JAX arena run of fl_simulation_torch's grid (the reference
    example's steps), its draws and its table."""
    cfg = jcommon.BenchConfig(num_devices=FL_N, rounds=FL_T)
    sp, task, clients, (xte, yte) = jcommon.build_testbed(cfg)
    hp = jc.estimate_hyperparams(sp, 0.1, loss_scale=1.5, mu=cfg.mu,
                                 nu=cfg.nu)
    engine = jfl.RoundEngine(task, jfl.ClientConfig(
        local_epochs=cfg.local_epochs, batch_size=cfg.batch_size))
    bank = engine.make_bank(clients)
    grid = jsim.ScenarioGrid.product(
        controllers=FL_NAMES, seeds=np.arange(1) + cfg.seed, V=(hp.V,),
        lam=(hp.lam,), sample_count=(cfg.sample_count,),
        num_devices=cfg.num_devices)
    arena = jsim.Arena(engine)
    sched = paper_step_decay(cfg.lr, cfg.rounds)
    lr_seq = np.asarray([float(sched(t)) for t in range(cfg.rounds)],
                        np.float32)
    p0 = task.init(jax.random.PRNGKey(cfg.seed + 1))
    h = np.asarray(arena.sample_channels(grid, cfg.rounds, cfg.num_devices))
    report = arena.run(p0, sp, bank, grid, cfg.rounds, lr_seq, h_all=h,
                       eval_bank=jsim.EvalBank(task, xte, yte))
    sel = np.asarray(report.metrics["selected"])
    roll = jsim.scenario_keys(grid)[1]
    keys = np.stack([_epoch_keys(roll[s], sel[s], bank, cfg.sample_count,
                                 cfg.local_epochs)
                     for s in range(len(FL_NAMES))])
    return dict(p0={k: np.asarray(v) for k, v in p0.items()}, h=h, sel=sel,
                keys=keys, table=_jax_table(grid, report))


def test_fl_simulation_table_matches_the_jax_arena(fl_reference):
    ref = fl_reference
    cfg = testbed.BenchConfig(num_devices=FL_N, rounds=FL_T)
    task = testbed.build_testbed(cfg, device="cpu")[1]
    table = fl_simulation_torch.run_arena_grid(
        FL_NAMES, cfg, 1, device="cpu",
        params0=params_from_jax(ref["p0"], task, device="cpu"),
        h_all=ref["h"], replay_selected=ref["sel"],
        replay_sort_keys=ref["keys"])
    assert list(table) == list(ref["table"]) == FL_NAMES
    for name in FL_NAMES:
        np.testing.assert_allclose(table[name], ref["table"][name],
                                   rtol=FL_TOL, atol=FL_TOL, err_msg=name)
    # the replay is not idle: the JAX lanes selected different clients
    assert len({tuple(s.ravel()) for s in ref["sel"]}) > 1


def test_fl_simulation_runs_its_own_draws_on_the_cpu():
    """No replay: the port's own initial model and draws; the same table
    twice (the draws are counter-based), every lane finite."""
    cfg = testbed.BenchConfig(num_devices=FL_N, rounds=2)
    a = fl_simulation_torch.run_arena_grid(FL_NAMES, cfg, 2, device="cpu")
    b = fl_simulation_torch.run_arena_grid(FL_NAMES, cfg, 2, device="cpu")
    assert a == b
    assert all(0.0 <= acc <= 1.0 and total > 0 for acc, total in a.values())


def test_fl_simulation_obs_log_renders(tmp_path, capsys):
    log = str(tmp_path / "fl.jsonl")
    table = fl_simulation_torch.main(["--obs", log, "--rounds", "2",
                                      "--devices", "6", "--controllers",
                                      "lroa,divfl", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "LROA saves" in out and f"span log written to {log}" in out
    assert set(table) == {"lroa", "divfl"}
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(ROOT, "tools", "obs_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    assert report.main([log]) == 0
    rendered = capsys.readouterr().out
    assert "== per-phase breakdown ==" in rendered
    assert "arena runs            : 1" in rendered


# -- serving ------------------------------------------------------------------


def test_serve_decode_prints_the_jax_example_lines(capsys):
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "serve_decode.py")],
        env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    tokens = serve_decode_torch.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert tokens.shape == (4, 16)
    assert ((tokens >= 0) & (tokens < 512)).all()
    got, want = out.splitlines(), ref.stdout.splitlines()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        # the prompts are the same; the weights are each package's draw
        assert g.split("-> generated")[0] == w.split("-> generated")[0]


# -- no fallback --------------------------------------------------------------


def test_drivers_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        quickstart_torch.run(rounds=1)
    with pytest.raises((RuntimeError, AssertionError)):
        fl_simulation_torch.main(["--rounds", "1", "--devices", "4"])
    with pytest.raises((RuntimeError, AssertionError)):
        serve_decode_torch.main(["--new-tokens", "2"])
    with pytest.raises((RuntimeError, AssertionError)):
        testbed.build_testbed(testbed.BenchConfig())
