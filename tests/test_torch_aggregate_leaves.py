"""The eq.-(4) aggregation over a model's leaves (the leaf kernel's path).

On the CPU, ``ops.fl_aggregate_leaves`` and ``server.aggregate_fused`` take
the plain per-leaf version; they are held against the JAX package's
``aggregate_fused`` and against ``fl_aggregate_tpu`` in interpret mode, leaf
by leaf, on the paper-scale CNN's six leaf shapes and on ragged leaf sizes
(f32 2e-5, bf16 2e-2).  ``ref.aggregate_leaves_fma_reference``, the
kernel's exact order of arithmetic (the bitwise reference of the card
checks), is held against exact rational rounding and against the same
interpret-mode kernel.  The host's segment-table builder
(``kernels.fl_aggregate.plan_segments``), which decides the CUDA kernel's
vector widths, tiles and launches, is checked property by property.
``test_torch_cuda.py`` holds the kernel itself against the plain versions.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.fl import aggregate_fused as jax_aggregate_fused  # noqa: E402
from repro.kernels.fl_aggregate import fl_aggregate_tpu  # noqa: E402
from repro_torch.fl import server  # noqa: E402
from repro_torch.kernels import fl_aggregate as fk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import CNNTask  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the paper-scale CNN (benchmarks/common.BenchConfig.paper_scale(): CIFAR
# shapes, width 32): b1 128, b2 10, c1 864, c2 18,432, d1 524,288, d2 1,280
CNN_SHAPES = CNNTask(image_shape=(32, 32, 3), num_classes=10,
                     width=32).shapes
# leaves whose sizes are odd, prime, or one past a vector or a tile
RAGGED_SHAPES = {"a": (1,), "b": (7,), "c": (3, 11), "d": (257,),
                 "e": (5, 13, 2), "f": (1025,), "g": ()}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(shapes, k, seed):
    rng = np.random.default_rng(seed)
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()}
    deltas = {n: rng.normal(size=(k,) + s).astype(np.float32)
              for n, s in shapes.items()}
    c = rng.normal(size=k)
    return params, deltas, (np.exp(c) / np.exp(c).sum()).astype(np.float32)


def _jax(tree, dtype):
    return {n: jnp.asarray(v).astype(jnp.dtype(dtype))
            for n, v in tree.items()}


def _torch(tree, dtype):
    return {n: torch.as_tensor(v).to(TORCH_DTYPES[dtype])
            for n, v in tree.items()}


@pytest.mark.parametrize("shapes,k", [(CNN_SHAPES, 8), (RAGGED_SHAPES, 3)],
                         ids=["cnn", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaves_match_pallas_interpret_per_leaf(shapes, k, dtype):
    params, deltas, coeffs = _tree(shapes, k, seed=len(shapes) + k)
    jp, jd = _jax(params, dtype), _jax(deltas, dtype)
    tp, td = _torch(params, dtype), _torch(deltas, dtype)
    names = sorted(shapes)
    got = ops.fl_aggregate_leaves([tp[n] for n in names],
                                  [td[n] for n in names],
                                  torch.as_tensor(coeffs))
    for name, out in zip(names, got):
        flat = fl_aggregate_tpu(jp[name].reshape(-1),
                                jd[name].reshape(k, -1),
                                jnp.asarray(coeffs), block=4096,
                                interpret=True)
        assert out.dtype == TORCH_DTYPES[dtype]
        assert tuple(out.shape) == shapes[name]
        np.testing.assert_allclose(
            out.float().reshape(-1).numpy(), np.asarray(flat, np.float32),
            atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shapes,k", [(CNN_SHAPES, 8), (RAGGED_SHAPES, 5)],
                         ids=["cnn", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aggregate_fused_matches_reference_aggregate_fused(shapes, k, dtype):
    """The round engine's entry point, both packages, same numpy inputs;
    the plain per-leaf version gives the same numbers as
    ``aggregate_stacked``."""
    params, deltas, coeffs = _tree(shapes, k, seed=3 * k)
    want = jax_aggregate_fused(_jax(params, dtype), _jax(deltas, dtype),
                               jnp.asarray(coeffs))
    tp, td = _torch(params, dtype), _torch(deltas, dtype)
    got = server.aggregate_fused(tp, td, torch.as_tensor(coeffs))
    stacked = server.aggregate_stacked(tp, td, torch.as_tensor(coeffs))
    assert list(got) == sorted(shapes)
    for name in shapes:
        assert got[name].dtype == TORCH_DTYPES[dtype]
        np.testing.assert_allclose(
            got[name].float().numpy(), np.asarray(want[name], np.float32),
            atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(got[name], stacked[name], atol=0, rtol=0)


def test_aggregate_fused_follows_the_adapter_order():
    params, deltas, coeffs = _tree(RAGGED_SHAPES, 2, seed=0)
    adapter = server.ParamRavel(_torch(params, "float32"))
    got = server.aggregate_fused(_torch(params, "float32"),
                                 _torch(deltas, "float32"),
                                 torch.as_tensor(coeffs), adapter=adapter)
    assert list(got) == adapter.names


def test_mixed_dtype_leaves_match_the_flat_plain_version():
    """Leaves of several (theta, delta) dtype pairs in one call: each
    agrees with the flat plain version on its own leaf."""
    params, deltas, coeffs = _tree(RAGGED_SHAPES, 4, seed=1)
    pairs = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)]
    names = sorted(params)
    thetas = [torch.as_tensor(params[n]).to(pairs[i % 4][0])
              for i, n in enumerate(names)]
    ds = [torch.as_tensor(deltas[n]).to(pairs[i % 4][1])
          for i, n in enumerate(names)]
    c = torch.as_tensor(coeffs)
    for t, d, out in zip(thetas, ds, ops.fl_aggregate_leaves(thetas, ds, c)):
        want = ref.aggregate_reference(t.reshape(-1),
                                       d.reshape(d.shape[0], -1), c)
        assert out.dtype == t.dtype and out.shape == t.shape
        tol = TOL["bfloat16"] if t.dtype == torch.bfloat16 else 2e-5
        torch.testing.assert_close(out.reshape(-1).float(), want.float(),
                                   atol=tol, rtol=tol)


# -- the kernel's order of arithmetic, bit for bit -------------------------


def _rounded_once(x: Fraction) -> np.float32:
    """The f32 nearest the rational ``x``, ties to even."""
    f = np.float32(float(x))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                    int(v.view(np.uint32)) & 1))


def _fma_inputs(case):
    if case == "random":
        rng = np.random.default_rng(0)
        n = 2000
        return (rng.normal(size=n).astype(np.float32),
                (rng.normal(size=n) * 10.0 ** rng.integers(-12, 3, n)
                 ).astype(np.float32),
                (rng.normal(size=n) * 10.0 ** rng.integers(-3, 3, n)
                 ).astype(np.float32))
    # a * b = +-(2^-24 - 2^-70) (or 2^6 scaled) puts c + a * b exactly
    # half-way between two f32 values in f64 with a non-zero rest, where
    # rounding f64 to f32 takes the even side and may be wrong
    cases = [(1 + 2 ** -23, s * m * (1 - 2 ** -23), sc * c)
             for c, m in ((1.0, 2 ** -24), (1 + 2 ** -23, 2 ** -24),
                          (1 + 2 ** -22, 2 ** -24), (2.0 ** 30, 2.0 ** 6),
                          (2.0 ** 30 + 2 ** 7, 2.0 ** 6))
             for s in (1, -1) for sc in (1, -1)]
    return tuple(np.array(x, np.float32) for x in zip(*cases))


@pytest.mark.parametrize("case", ["random", "midpoints"])
def test_fma_f32_rounds_once(case):
    """``ref.fma_f32`` is ``fmaf``: ``a * b + c`` rounded once to f32,
    against exact rational arithmetic, also where f64's rounding lands
    exactly half-way between two f32 values."""
    a, b, c = _fma_inputs(case)
    got = ref.fma_f32(torch.as_tensor(a), torch.as_tensor(b),
                      torch.as_tensor(c)).numpy()
    want = np.array([_rounded_once(Fraction(float(x)) * Fraction(float(y))
                                   + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if case == "midpoints":  # the cases where one f64 rounding is not enough
        twice = (a.astype(np.float64) * b + c).astype(np.float32)
        assert (twice != want).sum() >= 8


@pytest.mark.parametrize("shapes,k", [(CNN_SHAPES, 8), (RAGGED_SHAPES, 3)],
                         ids=["cnn", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fma_order_reference_matches_pallas_interpret(shapes, k, dtype):
    """The kernel's exact order of arithmetic, as the plain
    ``aggregate_leaves_fma_reference`` computes it, against
    ``fl_aggregate_tpu`` in interpret mode; with no thetas it is the
    reduce."""
    params, deltas, coeffs = _tree(shapes, k, seed=7 + k)
    jp, jd = _jax(params, dtype), _jax(deltas, dtype)
    tp, td = _torch(params, dtype), _torch(deltas, dtype)
    names = sorted(shapes)
    c = torch.as_tensor(coeffs)
    got = ref.aggregate_leaves_fma_reference([tp[n] for n in names],
                                             [td[n] for n in names], c)
    reduced = ref.aggregate_leaves_fma_reference(None,
                                                 [td[n] for n in names], c)
    for name, out, red in zip(names, got, reduced):
        flat = fl_aggregate_tpu(jp[name].reshape(-1),
                                jd[name].reshape(k, -1),
                                jnp.asarray(coeffs), block=4096,
                                interpret=True)
        assert out.dtype == TORCH_DTYPES[dtype]
        assert tuple(out.shape) == shapes[name]
        np.testing.assert_allclose(
            out.float().reshape(-1).numpy(), np.asarray(flat, np.float32),
            atol=TOL[dtype], rtol=TOL[dtype])
        assert red.dtype == torch.float32
        torch.testing.assert_close(
            red.reshape(-1), ref.delta_reduce_reference(
                td[name].reshape(k, -1), c), atol=2e-5, rtol=2e-5)


# -- the segment-table builder ---------------------------------------------

def _covered(sizes, rows, tile_vectors):
    """How often the kernel's tiles touch each element of each leaf: tile
    t of a leaf takes vectors [t * tv, (t + 1) * tv) below n // vec, and
    the leaf's last tile takes the scalar tail."""
    counts = {i: np.zeros(sizes[i], np.int64) for i, _, _ in rows}
    start = 0
    for i, vec, end in rows:
        n, n_vec = sizes[i], sizes[i] // vec
        for t in range(end - start):
            lo = t * tile_vectors
            hi = min((t + 1) * tile_vectors, n_vec)
            if hi > lo:
                counts[i][lo * vec:hi * vec] += 1
            if t == end - start - 1:
                counts[i][n_vec * vec:] += 1
        start = end
    return counts


ITEMSIZE = {"f32": 4, "bf16": 2}


@st.composite
def _leaf_calls(draw):
    n_leaves = draw(st.integers(1, 150))
    k = draw(st.integers(1, 20))
    with_theta = draw(st.booleans())
    sizes, pointers, kinds = [], [], []
    for _ in range(n_leaves):
        size = draw(st.one_of(st.integers(1, 40), st.integers(1, 5000)))
        delta_t = draw(st.sampled_from(["f32", "bf16"]))
        theta_t = draw(st.sampled_from(["f32", "bf16"]))
        out_t = theta_t if with_theta else "f32"
        # allocations are 256-byte aligned; views may sit any element off
        types = [delta_t, out_t] + ([theta_t] if with_theta else [])
        ptrs = [(256 * draw(st.integers(1, 1 << 20))
                 + ITEMSIZE[t] * draw(st.integers(0, 9)), ITEMSIZE[t])
                for t in types]
        sizes.append(size)
        pointers.append(ptrs)
        kinds.append((theta_t if with_theta else None, delta_t))
    tile_vectors = draw(st.sampled_from([128, 256, 7]))
    cap = draw(st.sampled_from([64, 5, 1]))
    return sizes, k, pointers, kinds, tile_vectors, cap


@settings(deadline=None, max_examples=150, derandomize=True)
@given(_leaf_calls())
# K = 1 and a tail after full vectors that fill their tiles exactly
@example(([29], 1, [[(256, 4), (512, 4)]], [(None, "f32")], 7, 64))
def test_plan_segments_covers_each_element_once(call):
    sizes, k, pointers, kinds, tile_vectors, cap = call
    plan = fk.plan_segments(sizes, k, pointers, kinds, tile_vectors, cap)
    seen = []
    for kind, rows in plan:
        assert 1 <= len(rows) <= cap
        for i, vec, _ in rows:
            seen.append(i)
            assert kinds[i] == kind
            # the vector: at most 16 bytes, every pointer and (K > 1)
            # every delta row start aligned to it
            assert vec in (1, 2, 4, 8)
            assert all(vec * isz <= 16 for _, isz in pointers[i])
            for addr, isz in pointers[i]:
                assert addr % (vec * isz) == 0
            delta_addr, delta_isz = pointers[i][0]
            for row in range(k):
                assert (delta_addr + row * sizes[i] * delta_isz) % (
                    vec * delta_isz) == 0
            # and the widest such: twice as wide would break one of them
            wider = 2 * vec
            if all(wider * isz <= 16 for _, isz in pointers[i]):
                assert (any(addr % (wider * isz) for addr, isz in pointers[i])
                        or (k > 1 and sizes[i] % wider))
        for i, counts in _covered(sizes, rows, tile_vectors).items():
            assert counts.min() == 1 and counts.max() == 1, i
        # the fewest tiles that hold each leaf's full vectors (at least
        # one): the kernel's launcher refuses any other prefix
        start = 0
        for i, vec, end in rows:
            assert end - start == max(1, -(-(sizes[i] // vec)
                                            // tile_vectors))
            start = end
    # every leaf in exactly one launch; ceil(L_kind / cap) launches a kind
    assert sorted(seen) == list(range(len(sizes)))
    for kind in set(kinds):
        n = sum(1 for x in kinds if x == kind)
        assert sum(1 for kd, _ in plan if kd == kind) == -(-n // cap)


def test_plan_segments_on_the_cnn():
    """The CNN's six leaves, f32, K = 8, freshly allocated (256-byte
    aligned): one launch; every leaf but ``b2`` (10 elements) streams
    16-byte vectors, ``b2`` 8-byte ones."""
    names = sorted(CNN_SHAPES)
    sizes = [int(np.prod(CNN_SHAPES[n])) for n in names]
    pointers = [[(4096 * (i + 1), 4)] * 3 for i in range(len(names))]
    plan = fk.plan_segments(sizes, 8, pointers, [("f32", "f32")] * 6,
                            tile_vectors=256, cap=64)
    assert len(plan) == 1
    vecs = {names[i]: vec for i, vec, _ in plan[0][1]}
    assert vecs == {"b1": 4, "b2": 2, "c1": 4, "c2": 4, "d1": 4, "d2": 4}
    # 545,002 elements in 535 tiles of 256 vectors
    assert plan[0][1][-1][2] == 535


def test_vector_width_of_a_flat_model():
    """The flat [K, N] call: rows start k * N elements apart, so with
    K > 1 the width must divide N; with K = 1 any N takes the widest."""
    aligned = [(1 << 20, 4)] * 3
    assert fk.vector_width(11_172_342, 8, aligned) == 2
    assert fk.vector_width(11_172_342, 1, aligned) == 4
    assert fk.vector_width(545_000, 8, aligned) == 4
    assert fk.vector_width(545_000, 8, [(1 << 20, 2)] * 3) == 8
    assert fk.vector_width(545_000, 8, [(1 << 20, 2), (1 << 20, 4)]) == 4
    assert fk.vector_width(64, 3, [((1 << 20) + 4, 4)]) == 1


def _lanes(shapes, lanes, k, seed, dtype):
    """``[S, ...]`` thetas, ``[S, K, ...]`` deltas and ``[S, K]`` coeffs."""
    trees = [_tree(shapes, k, seed + s) for s in range(lanes)]
    names = sorted(shapes)
    thetas = [torch.stack([_torch(t[0], dtype)[n] for t in trees])
              for n in names]
    deltas = [torch.stack([_torch(t[1], dtype)[n] for t in trees])
              for n in names]
    coeffs = torch.stack([torch.as_tensor(t[2]) for t in trees])
    coeffs[-1, -1] = 0.0                 # an inert slot, as padded K has
    return names, thetas, deltas, coeffs


@pytest.mark.parametrize("shapes,lanes,k", [(CNN_SHAPES, 3, 8),
                                            (RAGGED_SHAPES, 4, 3)],
                         ids=["cnn", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_references_are_bitwise_per_lane(shapes, lanes, k, dtype):
    """``ref.aggregate_lanes_reference`` (and its fma-order twin) is the
    one-model reference on each lane, bit for bit."""
    names, thetas, deltas, coeffs = _lanes(shapes, lanes, k, 10, dtype)
    plain = ref.aggregate_lanes_reference(thetas, deltas, coeffs)
    exact = ref.aggregate_lanes_fma_reference(thetas, deltas, coeffs)
    for s in range(lanes):
        one = ref.aggregate_leaves_reference(
            [t[s] for t in thetas], [d[s] for d in deltas], coeffs[s])
        one_fma = ref.aggregate_leaves_fma_reference(
            [t[s] for t in thetas], [d[s] for d in deltas], coeffs[s])
        for i, name in enumerate(names):
            assert torch.equal(plain[i][s], one[i]), (s, name)
            assert torch.equal(exact[i][s], one_fma[i]), (s, name)
            assert plain[i].dtype == thetas[i].dtype


@pytest.mark.parametrize("shapes,lanes,k", [(CNN_SHAPES, 7, 8),
                                            (RAGGED_SHAPES, 2, 5)],
                         ids=["cnn", "ragged"])
def test_aggregate_fused_lanes_is_aggregate_fused_per_lane(shapes, lanes, k):
    """On the CPU, the arena's eq.-(4) step of S lanes equals S calls of
    ``aggregate_fused``, and the ``ops`` wrapper dispatches it."""
    names, thetas, deltas, coeffs = _lanes(shapes, lanes, k, 20, "float32")
    params = dict(zip(names, thetas))
    stacked = dict(zip(names, deltas))
    out = server.aggregate_fused_lanes(params, stacked, coeffs)
    for s in range(lanes):
        one = server.aggregate_fused({n: v[s] for n, v in params.items()},
                                     {n: v[s] for n, v in stacked.items()},
                                     coeffs[s])
        for name in names:
            assert torch.equal(out[name][s], one[name]), (s, name)
    via_ops = ops.fl_aggregate_lanes(thetas, deltas, coeffs, impl="ref")
    for i, name in enumerate(names):
        assert torch.equal(via_ops[i], out[name])
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        server.aggregate_fused_lanes(params, stacked, coeffs, impl="cuda")
