"""The port's launch layer (``repro_torch.configs.shapes``,
``launch.op_cost``, ``launch.roofline``, ``launch.dryrun``,
``launch.mesh.make_production_mesh``, ``launch.steps``' specs) against
the JAX package's ``configs.shapes``, ``launch.hlo_cost``,
``launch.roofline`` and ``launch.steps`` on the CPU:

* ``SHAPES`` and ``covered_shapes`` equal for all ten archs; the specs
  hold the reference's ``eval_shape`` numbers (elements per dtype of the
  params and caches, the inputs' shapes and dtypes);
* the op counter's rules on known graphs (a matmul exactly ``2MKN``, a
  10-trip loop 10x, a batched einsum, an elementwise op's bytes) and on
  the smoke gemma-2b steps: the matmul flops of the train step (no remat,
  one microbatch) equal ``hlo_cost``'s ``dot`` total exactly, and the
  prefill's differ by exactly the vocabulary projection of the S - 1
  positions the JAX step computes and drops (the port projects the last
  position only); the stated tolerance, 2%, is not needed;
* each kernel wrapper's attributed work equals PERF.md's formula, the
  same on ``cpu`` and ``meta``, with the plain version's ops uncounted;
  ``meta`` outside a counter raises;
* the ring formulas equal ``parse_collectives`` on one HLO line per kind;
  ``roofline_terms`` equals the reference's rescaled by the constants'
  ratio; ``chip_smoke.py``'s H100 peaks are the module's constants;
* ``make_production_mesh`` and the collectives' records over torch's fake
  process group in a spawned process; ``dryrun`` of gemma-2b x train_4k
  on ``meta``, and its refusals."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.base import smoke_config as jsmoke  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import roofline as jrf  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.optim import SGD as JSGD  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun, mesh, op_cost  # noqa: E402
from repro_torch.launch import roofline as trf  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.optim import SGD  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATMULS = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot", "convolution",
           "convolution_backward")


def _per_dtype(leaves):
    c = Counter()
    for leaf in leaves:
        c[str(leaf.dtype).replace("torch.", "")] += int(np.prod(leaf.shape))
    return c


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_shapes_and_specs_match_reference(arch):
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    jcov = jshapes.covered_shapes(JARCHS[arch])
    tcov = tshapes.covered_shapes(ARCHS[arch])
    assert [s.name for s in tcov] == [s.name for s in jcov]
    cfg = ARCHS[arch].config
    tparams = tsteps.param_specs(cfg)
    assert {t.device.type for t in tree_flatten(tparams)[0]} == {"meta"}
    assert _per_dtype(tree_flatten(tparams)[0]) == _per_dtype(
        jax.tree_util.tree_leaves(jsteps.param_specs(JARCHS[arch].config)))
    for shape in tcov:
        want = jsteps.input_specs(arch, jshapes.SHAPES[shape.name])
        got = tsteps.input_specs(arch, shape)
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        if shape.kind == "decode":
            assert _per_dtype(tree_flatten(
                tsteps.cache_specs(arch, shape))[0]) == _per_dtype(
                jax.tree_util.tree_leaves(jsteps.cache_specs(
                    arch, jshapes.SHAPES[shape.name])))


# -- the counter's rules ------------------------------------------------------


def test_plain_matmul_counts_2mkn_and_its_bytes():
    a, b = torch.ones(128, 64), torch.ones(64, 32)
    _, c = op_cost.count(torch.matmul, a, b)
    assert c.rows["mm"][0] == 2 * 128 * 64 * 32
    assert c.rows["mm"][1] == (128 * 64 + 64 * 32 + 128 * 32) * 4
    # the reference's own bound on its HLO count of the same graph
    hlo = jax.jit(lambda x, y: x @ y).lower(
        jax.ShapeDtypeStruct((128, 64), jnp.float32),
        jax.ShapeDtypeStruct((64, 32), jnp.float32)).compile().as_text()
    assert hlo_cost.analyze(hlo)["flops"] == c.analyze()["flops"]


def test_loop_counts_every_trip():
    w = torch.ones(64, 64)

    def f(x):
        for _ in range(10):
            x = x @ w
        return x

    _, c = op_cost.count(f, torch.ones(64, 64))
    assert c.analyze()["flops"] == 10 * 2 * 64 ** 3


def test_batched_einsum():
    q, k = torch.ones(2, 3, 16, 8), torch.ones(2, 3, 16, 8)
    _, c = op_cost.count(torch.einsum, "bhsd,bhtd->bhst", q, k)
    assert sum(c.rows[n][0] for n in MATMULS) == 2 * 2 * 3 * 16 * 16 * 8


def test_elementwise_bytes_and_transcendentals():
    a = torch.ones(1024)
    _, c = op_cost.count(lambda x: torch.exp(x + 1.0), a)
    got = c.analyze()
    assert got["flops"] == 2 * 1024 and got["transcendentals"] == 1024
    assert got["bytes"] == 2 * (2 * 1024 * 4)
    _, c = op_cost.count(lambda x: x.reshape(32, 32).t(), a)
    assert c.analyze()["bytes"] == 0


def _smoke_step_flops(kind):
    """(port, reference) matmul flops of the smoke gemma-2b step, B = 2,
    S = 32, f32, the plain attention path in both."""
    b, s = 2, 32
    jcfg = jsmoke(JARCHS["gemma-2b"].config)
    tcfg = get_smoke_config("gemma-2b")
    jp = jsteps.param_specs(jcfg)
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    meta = torch.empty((b, s), dtype=torch.int32, device="meta")
    tp = tsteps.param_specs(tcfg)
    if kind == "train":
        jo = jax.eval_shape(JSGD(momentum=0.9).init, jp)
        lowered = jax.jit(jsteps.make_train_step(
            jcfg, remat=False, microbatch=1)).lower(
            jp, jo, {"tokens": tok, "labels": tok})
        _, c = op_cost.count(
            tsteps.make_train_step(tcfg, remat=False, microbatch=1,
                                   device="meta"),
            tp, SGD(momentum=0.9).init(tp), {"tokens": meta, "labels": meta})
    else:
        lowered = jax.jit(jsteps.make_prefill_step(jcfg)).lower(
            jp, {"tokens": tok})
        _, c = op_cost.count(tsteps.make_prefill_step(tcfg, device="meta"),
                             tp, {"tokens": meta})
    rows = hlo_cost.analyze_by_opcode(lowered.compile().as_text(), top=1000)
    want = sum(f for op, f, _ in rows if op in ("dot", "convolution"))
    got = sum(c.rows[n][0] for n in MATMULS)
    return got, want, tcfg, b, s


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_smoke_gemma_matmul_flops_match_hlo_cost(kind):
    got, want, cfg, b, s = _smoke_step_flops(kind)
    # the named gap: the JAX prefill projects every position onto the
    # vocabulary and keeps the last; the port projects the last only
    gap = (2 * b * (s - 1) * cfg.d_model * cfg.vocab_size
           if kind == "prefill" else 0)
    assert got == want - gap
    assert abs(got - (want - gap)) <= 0.02 * want     # the stated limit


# -- kernel attribution -------------------------------------------------------


def _formula(name, t):
    """PERF.md section 6's work of one call: (flops, bytes, exps)."""
    size = lambda x: x.numel() * x.element_size()  # noqa: E731
    if name in ("fl_aggregate", "fl_aggregate_lanes"):
        return (2.0 * sum(d.numel() for d in t["deltas"]),
                sum(2 * size(th) + size(d)
                    for th, d in zip(t["thetas"], t["deltas"])), 0.0)
    if name == "fl_delta_reduce":
        return (2.0 * sum(d.numel() for d in t["deltas"]),
                sum(size(d) + 4 * d[0].numel() for d in t["deltas"]), 0.0)
    if name == "flash_attention":
        q, k = t["q"], t["k"]
        b, h, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        pairs = b * h * fa.visible_pairs(sq, sk, True, t["window"])
        return (4.0 * d * pairs,
                2 * (b * h * sq * d + b * hkv * sk * d) * q.element_size()
                + 4 * b * h * sq, 2.0 * pairs)
    x, bin_ = t["x"], t["b_in"]
    b, s, nh, hd = x.shape
    n, nc = bin_.shape[-1], s // t["chunk"]
    return (ssd_scan.ssd_chunk_flops(b, s, nh, hd, n, t["chunk"]),
            (2 * b * s * nh * hd + b * s * nh + nh + 2 * b * s * n) * 4
            + b * nc * nh * hd * n * 4, 0.0)


def _inputs(name, device):
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(shape, generator=g).to(device)
    if name == "fl_aggregate":
        return dict(thetas=[r(6, 5), r(7)], deltas=[r(3, 6, 5), r(3, 7)],
                    coeffs=r(3))
    if name == "fl_aggregate_lanes":
        return dict(thetas=[r(2, 6, 5), r(2, 7)],
                    deltas=[r(2, 3, 6, 5), r(2, 3, 7)], coeffs=r(2, 3))
    if name == "fl_delta_reduce":
        deltas = [r(3, 6, 5), r(3, 7)]
        return dict(deltas=deltas, coeffs=r(3), outs=[
            torch.empty(d.shape[1:], device=device) for d in deltas])
    if name == "flash_attention":
        return dict(q=r(1, 4, 40, 16), k=r(1, 2, 40, 16), v=r(1, 2, 40, 16),
                    window=24)
    return dict(x=r(1, 32, 2, 8), dt=r(1, 32, 2).abs(), a_log=r(2),
                b_in=r(1, 32, 4), c_in=r(1, 32, 4), chunk=16)


def _call(name, t):
    if name == "fl_aggregate":
        return ops.fl_aggregate_leaves(t["thetas"], t["deltas"], t["coeffs"])
    if name == "fl_aggregate_lanes":
        return ops.fl_aggregate_lanes(t["thetas"], t["deltas"], t["coeffs"])
    if name == "fl_delta_reduce":
        return ops.fl_delta_reduce_leaves(t["deltas"], t["coeffs"],
                                          t["outs"])
    if name == "flash_attention":
        return ops.flash_attention(t["q"], t["k"], t["v"], causal=True,
                                   window=t["window"], softcap=20.0,
                                   return_lse=True)
    return ops.ssd_chunk(t["x"], t["dt"], t["a_log"], t["b_in"],
                         t["c_in"], chunk=t["chunk"])


KERNELS = ("fl_aggregate", "fl_aggregate_lanes", "fl_delta_reduce",
           "flash_attention", "ssd_chunk")


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_work_is_the_formula_on_cpu_and_meta(name):
    seen = []
    for device in ("cpu", "meta"):
        t = _inputs(name, device)
        with op_cost.OpCounter() as c:
            out = _call(name, t)
        outs = out if isinstance(out, (list, tuple)) else [out]
        assert {o.device.type for o in outs} == {device}
        assert set(c.rows) == {"kernel:" + name}      # plain ops uncounted
        k = c.kernels[name]
        assert k["calls"] == 1
        assert (k["flops"], k["bytes"], k["transcendentals"]) == \
            _formula(name, t)
        seen.append((k, [tuple(o.shape) for o in outs]))
    assert seen[0] == seen[1]


@pytest.mark.parametrize("name", KERNELS)
def test_meta_wrappers_raise_outside_a_counter(name):
    with pytest.raises(RuntimeError, match="only under an active"):
        _call(name, _inputs(name, "meta"))


# -- collectives, terms, constants --------------------------------------------


HLO_LINES = {
    "all-reduce": "  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %p), "
                  "replica_groups={{0,1,2,3}}, to_apply=%add",
    "all-gather": "  %ag = f32[4096]{0} all-gather(f32[1024]{0} %p), "
                  "replica_groups={{0,1,2,3}}, dimensions={0}",
    "reduce-scatter": "  %rs = f32[256]{0} reduce-scatter(f32[1024]{0} %p), "
                      "replica_groups={{0,1,2,3}}, dimensions={0}, "
                      "to_apply=%add",
    "all-to-all": "  %aa = f32[1024]{0} all-to-all(f32[1024]{0} %p), "
                  "replica_groups={{0,1,2,3}}, dimensions={0}",
    "collective-permute": "  %cp = f32[1024]{0} collective-permute("
                          "f32[1024]{0} %p), source_target_pairs={{0,1}}",
}


@pytest.mark.parametrize("kind", sorted(HLO_LINES))
def test_ring_formulas_match_parse_collectives(kind):
    (want,) = jrf.parse_collectives(HLO_LINES[kind])
    got = trf.collective_op(kind, want.result_bytes, want.group_size)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_roofline_terms_rescale_the_reference():
    from repro.launch import mesh as jmesh
    analysis = dict(flops=3.1e15, bytes=2.2e12, transcendentals=1e9,
                    collective_operand_bytes=4.4e9,
                    collective_traffic_bytes=6.6e9,
                    collective_counts={"all-reduce": 2},
                    collective_bytes_by_kind={"all-reduce": 4.4e9})
    want = jrf.roofline_terms(analysis, {}, chips=4, model_flops=9e15)
    assert set(want) - {"xla_raw_flops", "xla_raw_bytes"} == \
        set(trf.roofline_terms(analysis, chips=4, model_flops=9e15))
    got = trf.roofline_terms(analysis, chips=4, model_flops=9e15)
    for key, ratio in (("compute_s", jmesh.PEAK_FLOPS_BF16
                        / mesh.PEAK_FLOPS_BF16),
                       ("memory_s", jmesh.HBM_BW / mesh.HBM_BW),
                       ("collective_s", jmesh.ICI_BW / mesh.LINK_BW),
                       ("collective_traffic_s", jmesh.ICI_BW / mesh.LINK_BW)):
        assert got[key] == pytest.approx(want[key] * ratio, rel=1e-12)
    for key in ("hlo_flops_per_device", "hlo_bytes_per_device",
                "model_flops", "model_flops_ratio", "collective_counts"):
        assert got[key] == want[key]
    rows = [dict(arch="a", shape="s", mesh="1", terms=got)]
    assert trf.format_table(rows).splitlines()[0] == \
        jrf.format_table(rows).splitlines()[0]
    assert trf.train_model_flops(10, 4, 7) == jrf.train_model_flops(10, 4, 7)
    assert trf.decode_model_flops(4, 7) == jrf.decode_model_flops(4, 7)


def test_chip_smoke_peaks_are_the_mesh_constants():
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    (peaks,) = [ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "PEAKS"]
    assert dict((row[0], row[1:]) for row in peaks)["H100"] == (
        mesh.HBM_BW, mesh.PEAK_FLOPS_F32, mesh.PEAK_FLOPS_BF16)


_FAKE_WORLD = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh, op_cost
out = {}
for multi_pod, world in ((False, 256), (True, 512)):
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=world)
    m = mesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    out[str(multi_pod)] = [list(m.shape), list(m.mesh_dim_names)]
    if not multi_pod:
        try:
            mesh.make_production_mesh(multi_pod=True, device_type="cpu")
        except ValueError as e:
            out["refused"] = str(e)
        with op_cost.OpCounter() as c:
            mesh.all_reduce_sum_(torch.ones(1024), m, "data")
            mesh.all_gather_cat(torch.ones(8), m, "model")
            mesh.all_to_all_rows(torch.ones(16, 4), [1] * 16, [1] * 16, m,
                                 "data")
        out["ops"] = [[o.kind, o.result_bytes, o.group_size] for o in
                      c.collectives]
        out["analysis"] = c.analyze()
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_production_mesh_over_the_fake_backend():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _FAKE_WORLD], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["False"] == [[16, 16], ["data", "model"]]
    assert out["True"] == [[2, 16, 16], ["pod", "data", "model"]]
    assert "needs 512 ranks" in out["refused"]
    assert out["ops"] == [["all-reduce", 4096, 16], ["all-gather", 512, 16],
                          ["all-to-all", 256, 16]]
    want = [trf.collective_op(*op) for op in out["ops"]]
    assert out["analysis"]["collective_operand_bytes"] == \
        sum(o.operand_bytes for o in want)
    assert out["analysis"]["collective_traffic_bytes"] == \
        sum(o.ici_traffic_bytes for o in want)


def test_dryrun_gemma_train_on_meta(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k",
                        "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["failures"] == []
    (res,) = doc["results"]
    terms = res["terms"]
    assert res["chips"] == 1 and terms["dominant"] in ("compute_s",
                                                       "memory_s")
    assert terms["model_flops"] == pytest.approx(
        6.0 * res["active_param_count"] * 256 * 4096)
    # remat recomputes each block's forward: more than 6 N D counted
    assert 0.5 < terms["model_flops_ratio"] < 1.0
    # 18 layers x (forward + remat's recompute) x 2 microbatches
    assert res["kernels"]["flash_attention"]["calls"] == 72
    assert res["argument_bytes"]["opt_state"] == \
        2 * res["argument_bytes"]["params"]
    assert "gemma-2b" in capsys.readouterr().out
    with pytest.raises(ValueError, match="repro.dist"):
        dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k",
                     "--multi-pod"])
    with pytest.raises(ValueError, match="sharding annotations"):
        dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k",
                     "--ablate", "act_constraints"])
