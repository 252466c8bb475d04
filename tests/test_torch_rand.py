"""`rand`: the port's threefry draws against the reference's jax draws.

The same (shape, seed, dist, sparsity) through `repro.core.backend`'s
`rand` kernel (jax 0.9, x64, partitionable threefry) and through the
port's (`repro_torch.core.random`, torch on the CPU). Uniform draws and
the sparsity mask agree bit for bit. Normal draws agree bit for bit
except where XLA's float64 log (glibc's, correctly rounded in all but
~0.04 % of cases) and the port's (correctly rounded but for values
within ~1e-4 ulp of a rounding boundary; made of IEEE ops so that the
card rounds it like the CPU) round w = -log1p(-u²) apart: such entries
differ by at most `NORMAL_ULP` ulp, in at most `NORMAL_SHARE` of a large
draw (~0.002 % measured).
Then the reference tests that draw with `rand`, mirrored.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import backend as rb
from repro_torch.core import backend as tb
from repro_torch.core import random as trand

NORMAL_ULP = 4
NORMAL_SHARE = 1e-4

SHAPES_SEEDS = [
    ((7, 5), 0),
    ((333, 17), 3),                  # odd element count
    ((4,), -7),                      # negative seed: two's complement key
    ((2, 3, 5), 2 ** 33 + 1),        # the key's high word is 2
    # seed + 0x9E3779B9 crosses 2^32: the mask key's high word becomes 1
    ((9, 11), 2 ** 32 - 0x9E3779B9 + 5),
]


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


def _ref(shape, seed, dist, sp):
    attrs = {"_shape": shape, "seed": seed, "dist": dist, "sparsity_gen": sp}
    return np.asarray(rb.execute_op("rand", attrs, []))


def _port(shape, seed, dist, sp):
    attrs = {"_shape": shape, "seed": seed, "dist": dist, "sparsity_gen": sp}
    return tb.to_numpy(tb.execute_op("rand", attrs, [], device="cpu"))


def _ulps(a, b):
    return np.abs(a.view(np.int64) - b.view(np.int64))


def test_prng_key_words():
    assert trand.prng_key(0) == (0, 0)
    assert trand.prng_key(5) == (0, 5)
    assert trand.prng_key(2 ** 32 + 3) == (1, 3)
    assert trand.prng_key(-1) == (0xFFFFFFFF, 0xFFFFFFFF)


def test_threefry_known_answer():
    """The Random123 known-answer vector of threefry2x32 (20 rounds):
    key (0x13198a2e, 0x03707344), counter (0x243f6a88, 0x85a308d3)."""
    x0 = torch.tensor([0x243F6A88], dtype=torch.int64)
    x1 = torch.tensor([0x85A308D3], dtype=torch.int64)
    y0, y1 = trand.threefry2x32((0x13198A2E, 0x03707344), x0, x1)
    assert (int(y0), int(y1)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("sp", [1.0, 0.3])
@pytest.mark.parametrize("shape,seed", SHAPES_SEEDS)
def test_uniform_and_mask_are_bitwise(shape, seed, sp):
    want, got = _ref(shape, seed, "uniform", sp), _port(shape, seed,
                                                        "uniform", sp)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(want.view(np.int64), got.view(np.int64))


@pytest.mark.parametrize("sp", [1.0, 0.3])
@pytest.mark.parametrize("shape,seed", SHAPES_SEEDS)
def test_normal_within_ulps(shape, seed, sp):
    want, got = _ref(shape, seed, "normal", sp), _port(shape, seed,
                                                       "normal", sp)
    assert got.shape == want.shape
    assert np.array_equal(want == 0, got == 0)  # the same mask, bitwise
    assert _ulps(want, got).max() <= NORMAL_ULP


def test_normal_is_mostly_bitwise():
    """Over a draw of 100,000 normals, at most `NORMAL_SHARE` of the
    entries differ from jax's at all (those where the two logs round w
    apart)."""
    d = _ulps(_ref((400, 250), 11, "normal", 1.0),
              _port((400, 250), 11, "normal", 1.0))
    assert np.count_nonzero(d) <= NORMAL_SHARE * d.size


def test_row_ranges_draw_their_slice():
    """A counter-based draw: rows [r0, r1) drawn alone are those rows of
    the whole draw (chip_smoke compares row blocks this way)."""
    full = trand.rand((50, 7), 5, "normal", 0.5)
    for r0, r1 in ((0, 1), (13, 29), (49, 50)):
        part = trand.rand((50, 7), 5, "normal", 0.5, rows=(r0, r1))
        assert torch.equal(part, full[r0:r1])


def test_generator_dtype_follows_the_node():
    """The draw is float64 and is cast to the node's dtype (the port's
    generator rule, ROADMAP Queue 3 item 2)."""
    x = tb.execute_op("rand", {"_shape": (3, 4), "seed": 1, "dist":
                               "uniform"}, [], dtype=np.float32,
                      device="cpu")
    want = trand.rand((3, 4), 1).to(torch.float32)
    assert x.dtype == torch.float32 and torch.equal(x, want)


# -- the reference tests that draw with rand, mirrored -----------------------

def _pipeline(pk, xn):
    """tests/test_segments.py::test_generators_and_slicing_parity."""
    x = pk.input_tensor("X", xn)
    expr = (x[2:12, 1:5] * pk.ops.rand((10, 4), seed=3)
            + pk.ops.seq(0, 9) @ pk.ops.ones((1, 4)))
    return pk.ops.where(expr > 0.0, pk.ops.sqrt(pk.ops.abs_(expr)), expr)


def test_generators_and_slicing_parity(rng):
    xn = rng.normal(size=(20, 8))
    a = T.LineageRuntime(fuse=True, device="cpu").evaluate(
        [_pipeline(T, xn)])[0]
    b = T.LineageRuntime(fuse=False, device="cpu").evaluate(
        [_pipeline(T, xn)])[0]
    np.testing.assert_array_equal(a, b)
    want = R.LineageRuntime().evaluate([_pipeline(R, xn)])[0]
    np.testing.assert_allclose(a, want, rtol=1e-12, atol=1e-12)


def test_seed_traced():
    """tests/test_lineage_reuse.py::TestLineageHash::test_seed_traced."""
    from repro_torch.core.dag import LEAVES
    a = T.ops.rand((5, 5), seed=1)
    b = T.ops.rand((5, 5), seed=2)
    c = T.ops.rand((5, 5), seed=1)
    assert a.node.lhash(LEAVES.lineage) != b.node.lhash(LEAVES.lineage)
    assert a.node.lhash(LEAVES.lineage) == c.node.lhash(LEAVES.lineage)


def test_sparse_normal_through_a_plan():
    """A sparse normal draw feeding an aggregate: the reference's value
    within float64 rounding, and the same zeros."""
    def prog(pk):
        r = pk.ops.rand((64, 9), seed=21, dist="normal", sparsity=0.2)
        return [r, pk.ops.colSums(r * r)]
    got = T.LineageRuntime(device="cpu").evaluate(prog(T))
    want = R.LineageRuntime().evaluate(prog(R))
    assert np.array_equal(got[0] == 0, want[0] == 0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)


def test_sqrt_and_log_round_correctly(rng):
    """The two library functions the normal draw leans on, rebuilt from
    IEEE ops: the square root bitwise numpy's (correctly rounded), the
    log glibc's (math.log) but for a few rare boundary cases."""
    import math
    w = rng.uniform(0.0, 40.0, 200_000)
    assert np.array_equal(trand._sqrt(torch.from_numpy(w)).numpy(),
                          np.sqrt(w))
    x = np.concatenate([rng.uniform(2.0 ** -52, 0.6, 100_000),
                        10.0 ** rng.uniform(-300, 300, 20_000),
                        [1.0, 0.5, 2.0]])
    got = trand._log(torch.from_numpy(x)).numpy()
    want = np.array([math.log(v) for v in x])
    assert np.count_nonzero(got != want) <= 1e-3 * x.size
    assert _ulps(got, want).max() <= 1
