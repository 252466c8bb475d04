"""Per-op parity of the port's kernel registry against the reference.

Every op the port's `backend` registers runs on the same numpy inputs
through `repro.core.backend.execute_op` (jax, x64) and
`repro_torch.core.backend.execute_op` (torch, CPU). Values agree to
rel 1e-12 (both compute in the same dtype; libraries differ only in
summation order and libm rounding), and output dtypes are equal —
comparison ops give float32, `nnz` float64, the solvers float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as rb
from repro_torch.core import backend as tb
from repro_torch.core.dag import input_tensor, make_node
from repro_torch.interop import from_reference

RTOL = 1e-12


def _run(op, attrs, arrays, dtype=np.float64):
    """(reference result, port result) as numpy arrays."""
    want = rb.execute_op(op, dict(attrs), [jnp.asarray(a) for a in arrays])
    t = from_reference({str(i): a for i, a in enumerate(arrays)}, "cpu")
    got = tb.execute_op(op, dict(attrs), [t[str(i)] for i in range(len(arrays))],
                        dtype=dtype, device="cpu")
    return np.asarray(want), tb.to_numpy(got)


def _check(want, got, rtol=RTOL):
    assert want.dtype == got.dtype, (want.dtype, got.dtype)
    assert want.shape == got.shape, (want.shape, got.shape)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(want[~fin], got[~fin], equal_nan=True)
    scale = max(float(np.max(np.abs(want[fin]))) if fin.any() else 0.0,
                1e-300)
    assert np.all(np.abs(want[fin] - got[fin]) <= rtol * scale)


def _mat(seed, shape=(6, 5), positive=False, dtype=np.float64):
    a = np.random.default_rng(seed).normal(size=shape)
    # a few exact ties/zeros so comparisons and sign see every branch
    a.flat[::7] = 0.0
    a.flat[1::11] = a.flat[2::11][: len(a.flat[1::11])]
    if positive:
        a = np.abs(a) + 0.1
    return a.astype(dtype)


BINARY = sorted(rb._BINARY)
UNARY = sorted(rb._UNARY)
AGG = sorted(rb._AGG)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("op", BINARY)
def test_binary(op, dtype):
    a, b = _mat(0, dtype=dtype), _mat(1, dtype=dtype)
    if op == "pow":
        a = np.abs(a) + 0.5
    want, got = _run(op, {}, [a, b])
    _check(want, got, RTOL if dtype == np.float64 else 1e-6)


@pytest.mark.parametrize("op", ["add", "mul", "gt", "max2"])
def test_binary_broadcast_and_promotion(op):
    """A float32 matrix against a float64 0-d value promotes to float64,
    as jax does (torch alone would keep float32)."""
    a = _mat(2, dtype=np.float32)
    b = np.asarray(1.5, dtype=np.float64)
    want, got = _run(op, {}, [a, b])
    _check(want, got, 1e-6)
    want, got = _run(op, {}, [_mat(3), _mat(4, shape=(1, 5))])
    _check(want, got)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("op", UNARY)
def test_unary(op, dtype):
    a = _mat(5, positive=op in ("log", "sqrt"), dtype=dtype)
    if op == "round":
        a = np.round(a * 4) / 4 + 0.5 * (np.arange(a.size).reshape(a.shape) % 2)
    want, got = _run(op, {}, [a])
    _check(want, got, RTOL if dtype == np.float64 else 1e-6)


@pytest.mark.parametrize("op", AGG)
def test_aggregates(op):
    a = _mat(6, shape=(7, 7))
    want, got = _run(op, {}, [a])
    _check(want, got)


def test_aggregates_keep_float32():
    want, got = _run("colMeans", {}, [_mat(7, dtype=np.float32)])
    _check(want, got, 1e-6)


@pytest.mark.parametrize("op,shapes", [
    ("matmul", [(6, 5), (5, 3)]), ("matmul", [(6, 5), (5,)]),
    ("gram", [(40, 6)]), ("xtv", [(40, 6), (40, 2)]), ("xtv", [(40, 6), (40,)]),
    ("t", [(6, 5)]), ("diag", [(6, 5)]), ("diagm", [(5, 1)]),
    ("cumsum", [(6, 5)]),
])
def test_linear_algebra_and_structure(op, shapes):
    arrays = [_mat(10 + i, shape=s) for i, s in enumerate(shapes)]
    want, got = _run(op, {}, arrays)
    _check(want, got)


def _spd(n, seed):
    a = np.random.default_rng(seed).normal(size=(3 * n, n))
    return a.T @ a + 0.1 * np.eye(n)


@pytest.mark.parametrize("bshape", [(5, 1), (5, 3), (5,)])
def test_solve_spd(bshape):
    b = np.random.default_rng(21).normal(size=bshape)
    want, got = _run("solve", {}, [_spd(5, 20), b])
    _check(want, got, 1e-10)


def test_solve_float32_inputs_compute_float64():
    a, b = _spd(4, 22).astype(np.float32), np.ones((4, 1), np.float32)
    want, got = _run("solve", {}, [a, b])
    assert got.dtype == np.float64
    _check(want, got, 1e-10)


def test_solve_non_spd_is_nan():
    """The reference's Cholesky solve returns NaN on a matrix that is not
    positive definite; torch would raise — the port reproduces the NaN."""
    a = np.array([[1.0, 2.0], [2.0, 1.0]])
    want, got = _run("solve", {}, [a, np.ones((2, 1))])
    assert np.isnan(want).all() and np.isnan(got).all()
    want, got = _run("cholesky", {}, [a])
    _check(want, got)  # NaN lower triangle, zero upper, in both


@pytest.mark.parametrize("shape", [(6, 4), (4, 6)])
def test_solve_non_square_min_norm(shape):
    a = np.random.default_rng(23).normal(size=shape)
    a[:, -1] = a[:, 0]  # rank deficient: the minimum-norm solution
    b = np.random.default_rng(24).normal(size=(shape[0], 2))
    want, got = _run("solve", {}, [a, b])
    _check(want, got, 1e-10)


def test_cholesky_and_inv():
    a = _spd(6, 25)
    for op in ("cholesky", "inv"):
        want, got = _run(op, {}, [a])
        _check(want, got, 1e-10)
    want, got = _run("inv", {}, [np.zeros((3, 3))])
    assert not np.isfinite(want).all() and not np.isfinite(got).any()


@pytest.mark.parametrize("op,attrs,shapes", [
    ("slice", {"index": ((1, 4, 0), (2, 3, 1))}, [(6, 5)]),
    ("slice", {"index": ((0, 6, 0), (1, 4, 0))}, [(6, 5)]),
    ("reshape", {"newshape": (5, 6)}, [(6, 5)]),
    ("rbind", {"axis": 0}, [(2, 5), (3, 5)]),
    ("cbind", {"axis": 1}, [(6, 2), (6, 3)]),
    ("replace_nan", {"value": -1.0}, [(6, 5)]),
    ("quantile", {"q": 0.25}, [(9, 4)]),
])
def test_attr_ops(op, attrs, shapes):
    arrays = [_mat(30 + i, shape=s) for i, s in enumerate(shapes)]
    if op in ("replace_nan", "quantile"):
        arrays[0][1, 1] = np.nan
        arrays[0][2, 0] = np.inf
    want, got = _run(op, attrs, arrays)
    _check(want, got)


def test_where():
    c = (_mat(40) > 0).astype(np.float32)
    want, got = _run("where", {}, [c, _mat(41), _mat(42, dtype=np.float32)])
    _check(want, got, 1e-7)


@pytest.mark.parametrize("op,attrs", [
    ("literal", {"value": 2.5}),
    ("full", {"value": 3.0, "_shape": (4, 2)}),
    ("eye", {"_shape": (4, 4)}),
    ("seq", {"_shape": (5, 1), "start": 2.0, "stop": 6.0, "step": 1.0}),
])
def test_generators_default_float64(op, attrs):
    """Generators are float64 in the reference (x64); the port takes the
    node's dtype, whose DSL default is float64 — never torch's float32."""
    want, got = _run(op, attrs, [])
    _check(want, got)


def test_execute_op_defaults_to_cuda():
    """Like every entry point, `execute_op` builds generators on `cuda`
    unless the CPU is asked for, and raises without a GPU."""
    if torch.cuda.is_available():
        out = tb.execute_op("eye", {"_shape": (3, 3)}, [])
        assert out.device.type == "cuda" and out.dtype == torch.float64
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.execute_op("eye", {"_shape": (3, 3)}, [])


def test_rand_is_refused():
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        tb.execute_op("rand", {"_shape": (2, 2), "seed": 0}, [],
                      device="cpu")


def test_chunk_ops_are_their_base_ops():
    """A chunk partial is its base op over the rows it is handed; the
    combine boundary hands the accumulator through unchanged."""
    x = input_tensor("x", _mat(50, shape=(8, 3))).node
    cg = make_node("chunk_gram", (x,), (3, 3), np.float64, 1.0)
    comb = make_node("combine", (cg,), (3, 3), np.float64, 1.0)
    t = torch.from_numpy(_mat(50, shape=(8, 3)))
    g = tb.kernel_for_node(cg, torch.device("cpu"))(t)
    assert torch.equal(g, tb.execute_op("gram", {}, [t], device="cpu"))
    assert tb.kernel_for_node(comb, torch.device("cpu"))(g) is g


def _sparse_mat(shape, seed=9, dtype=np.float64):
    a = np.random.default_rng(seed).normal(size=shape)
    a[np.abs(a) < 1.2] = 0.0  # ~23 % nonzero
    return a.astype(dtype)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("shape,est,dtype", [
    ((100, 50), 0.1, np.float64),    # sparse and large enough: BCOO
    ((100, 50), 0.29, np.float32),   # just below the threshold
    ((100, 50), 0.3, np.float64),    # at the threshold: dense
    ((100, 50), 0.9, np.float64),
    ((64, 64), 0.1, np.float64),     # exactly SPARSE_MIN_NUMEL: BCOO
    ((63, 64), 0.1, np.float64),     # one row short of it: dense
    ((4096,), 0.1, np.float64),      # not a matrix: dense
    ((2, 64, 64), 0.1, np.float64),
    ((80, 80), 0.0, "zeros"),        # no nonzero at all: nse 0
])
def test_maybe_sparsify_matches_reference(kind, shape, est, dtype):
    """The reference's `maybe_sparsify` (Queue 3 item 6): the same
    BCOO/dense decision on both sides of `SPARSE_THRESHOLD` and of
    `SPARSE_MIN_NUMEL`, and for a BCOO the same nse (no padding), int32
    row-major indices, values and dense form."""
    from jax.experimental import sparse as jsparse
    a = np.zeros(shape) if dtype == "zeros" else _sparse_mat(shape,
                                                              dtype=dtype)
    want = rb.maybe_sparsify(jnp.asarray(a), est)
    arg = a if kind == "numpy" else torch.from_numpy(a)
    got = tb.maybe_sparsify(arg, est)
    assert tb.is_sparse(got) == isinstance(want, jsparse.BCOO)
    if not tb.is_sparse(got):
        assert got is arg
        return
    assert got.device.type == "cpu" and got.shape == want.shape
    assert got.nse == want.nse
    assert got.indices.dtype == torch.int32
    assert str(got.data.dtype) == f"torch.{want.data.dtype}"
    assert (got.indices_sorted, got.unique_indices) == \
        (want.indices_sorted, want.unique_indices)
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    assert np.array_equal(got.todense().numpy(), np.asarray(want.todense()))


@pytest.mark.cuda
def test_maybe_sparsify_keeps_the_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.from_numpy(_sparse_mat((100, 50))).cuda()
    got = tb.maybe_sparsify(a, 0.1)
    assert got.data.device == got.indices.device == a.device
    assert torch.equal(got.todense(), a)
