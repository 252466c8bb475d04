"""Cleaning builtins: the port's `repro_torch.lifecycle.cleaning` against
the reference's `repro.lifecycle.cleaning` on the same seeded data (the
reference at pipeline depth 1, the port on the CPU). Mirrors
tests/test_lifecycle.py::TestCleaning: every builtin within rtol 1e-12
of the reference (both compute in float64; the libraries differ only in
summation order), NaN positions equal, and the same reuse-cache counters
where a test reads them."""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.lifecycle import cleaning as rcl
from repro_torch.lifecycle import cleaning as tcl

RTOL = 1e-12


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


def _rt(key, **kw):
    return (T.LineageRuntime(device="cpu", **kw) if key == "port"
            else R.LineageRuntime(**kw))


def _both(fn_name, x, **kw):
    """(reference result, port result) of one builtin on the same data."""
    out = {}
    for key, pk, mod in (("ref", R, rcl), ("port", T, tcl)):
        out[key] = getattr(mod, fn_name)(pk.input_tensor("X", x),
                                         runtime=_rt(key), **kw)
    return out["ref"], out["port"]


def _check(want, got, rtol=RTOL):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got))
    scale = max(float(np.max(np.abs(want[~nan]), initial=0.0)), 1e-300)
    assert np.max(np.abs(want[~nan] - got[~nan]), initial=0.0) \
        <= rtol * scale


def _dirty(rng, shape, p_nan=0.05, outliers=()):
    x = rng.normal(size=shape)
    x[rng.random(shape) < p_nan] = np.nan
    for (i, j), v in outliers:
        x[i, j] = v
    return x


def test_isnan_mask(rng):
    x = _dirty(rng, (40, 5))
    got = T.LineageRuntime(device="cpu").evaluate(
        [tcl.isnan_mask(T.input_tensor("X", x))])[0]
    want = R.LineageRuntime().evaluate(
        [rcl.isnan_mask(R.input_tensor("X", x))])[0]
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("center,scale", [(True, True), (True, False),
                                          (False, True)])
def test_scale_matrix(rng, center, scale):
    x = rng.normal(size=(300, 3)) * [1.0, 5.0, 0.1] + [0.0, 2.0, -3.0]
    want, got = _both("scale_matrix", x, center=center, scale=scale)
    _check(want, got)
    if center and scale:
        np.testing.assert_allclose(got.mean(axis=0), 0, atol=1e-12)
        np.testing.assert_allclose(got.std(axis=0, ddof=1), 1, rtol=1e-6)


def test_impute_by_mean(rng):
    x = _dirty(rng, (50, 4))
    want, got = _both("impute_by_mean", x)
    _check(want, got)
    assert not np.isnan(got).any()
    j = np.argwhere(np.isnan(x))[0]
    np.testing.assert_allclose(got[tuple(j)], np.nanmean(x[:, j[1]]),
                               rtol=1e-9)


def test_impute_by_median(rng):
    x = _dirty(rng, (51, 3))
    want, got = _both("impute_by_median", x)
    _check(want, got)
    med = np.nanmedian(x, axis=0, keepdims=True)
    np.testing.assert_allclose(got, np.where(np.isnan(x), med, x))


def test_mice_lite(rng):
    n = 400
    z = rng.normal(size=(n, 1))
    x = np.hstack([z + 0.1 * rng.normal(size=(n, 1)) for _ in range(4)])
    x_miss = x.copy()
    mask = rng.random(x.shape) < 0.15
    x_miss[mask] = np.nan
    want, got = _both("mice_lite", x_miss, n_iter=3)
    # three chained rounds of solves: 1e-10 (the lifecycle solve tests')
    _check(want, got, rtol=1e-10)
    m_mean = tcl.impute_by_mean(T.input_tensor("Xm", x_miss),
                                runtime=T.LineageRuntime(device="cpu"))
    err_mean = np.abs(m_mean - x)[mask].mean()
    assert np.abs(got - x)[mask].mean() < 0.7 * err_mean


@pytest.mark.parametrize("repair", ["nan", "clip", "flag"])
def test_outlier_by_iqr(rng, repair):
    x = _dirty(rng, (200, 3), outliers=(((0, 0), 50.0), ((7, 2), -40.0)))
    want, got = _both("outlier_by_iqr", x, repair=repair)
    _check(want, got)
    assert got.dtype == np.float64
    if repair == "clip":
        assert got[0, 0] < 50.0


@pytest.mark.parametrize("repair", ["nan", "clip", "flag"])
def test_outlier_by_sd(rng, repair):
    x = rng.normal(size=(200, 2))
    x[0, 0] = 100.0
    want, got = _both("outlier_by_sd", x, k=4, repair=repair)
    _check(want, got)
    if repair == "nan":
        assert np.isnan(got[0, 0]) and np.isnan(got).sum() <= 3


@pytest.mark.parametrize("lower,upper", [(0.05, 0.95), (0.25, 0.75)])
def test_winsorize(rng, lower, upper):
    x = _dirty(rng, (300, 3))
    want, got = _both("winsorize", x, lower=lower, upper=upper)
    _check(want, got)
    assert np.nanmax(got) <= np.nanquantile(x, upper, axis=0).max() + 1e-9


def test_quantile_host_op_matches_numpy(rng):
    x = rng.normal(size=(150, 4))
    x[3, 1] = np.nan
    q = T.LineageRuntime(device="cpu").evaluate(
        [T.ops.quantile(T.input_tensor("X", x), 0.25)])[0]
    np.testing.assert_allclose(
        q, np.nanquantile(x, 0.25, axis=0, keepdims=True))
    with pytest.raises(ValueError, match="q must be"):
        T.ops.quantile(T.input_tensor("Xq", x), 1.5)


def test_cleaning_stays_in_one_plan_with_lineage(rng):
    """tests/test_lifecycle.py::test_cleaning_stays_in_one_plan_with_lineage:
    the second winsorize is served from the reuse cache, and the probes,
    hits and misses equal the reference's."""
    x = _dirty(rng, (4000, 8))
    stats, results = {}, {}
    for key, pk, mod in (("ref", R, rcl), ("port", T, tcl)):
        X = pk.input_tensor("XL", x)
        rt = _rt(key, cache=pk.ReuseCache())
        first = mod.winsorize(X, runtime=rt)
        assert rt.cache.stats.hits == 0
        second = mod.winsorize(X, runtime=rt)
        assert rt.cache.stats.hits > 0
        np.testing.assert_array_equal(first, second)
        med = mod.impute_by_median(X, runtime=rt)
        results[key] = (first, med)
        stats[key] = rt.cache.stats.as_dict()
    assert stats["port"] == stats["ref"]
    for want, got in zip(results["ref"], results["port"]):
        _check(want, got)
