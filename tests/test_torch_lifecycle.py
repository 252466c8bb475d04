"""Lifecycle builtins: the port's lmDS / lmCG / lm / steplm against the
reference on the same data (both at pipeline depth 1, and again both at
depth 2; the port on the CPU). Coefficients agree to rel 1e-10; steplm
selects the same columns in the same order, with identical reuse-cache
counters; the port's depth-2 results are bitwise its depth-1 results."""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.lifecycle import regression as rreg
from repro_torch.lifecycle import regression as treg

RTOL = 1e-10


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


def _rt(key, **kw):
    return (T.LineageRuntime(device="cpu", **kw) if key == "port"
            else R.LineageRuntime(**kw))


def _both(fn_name, xn, yn, **kw):
    out = {}
    for key, pk, mod in (("ref", R, rreg), ("port", T, treg)):
        rt = _rt(key, cache=pk.ReuseCache())
        res = getattr(mod, fn_name)(pk.input_tensor("X", xn),
                                    pk.input_tensor("y", yn), runtime=rt,
                                    **kw)
        out[key] = (res, rt.cache.stats.as_dict())
    return out


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _data(m, n, seed):
    rng = np.random.default_rng(seed)
    xn = rng.normal(size=(m, n))
    w = np.zeros((n, 1))
    w[[1, 4, n - 1]] = [[1.5], [-2.0], [0.7]]
    return xn, xn @ w + 0.1 * rng.normal(size=(m, 1))


@pytest.mark.parametrize("intercept", [False, True])
def test_lmds(intercept):
    xn, yn = _data(400, 12, 0)
    out = _both("lmDS", xn, yn, reg=1e-6, intercept=intercept)
    assert out["port"][0].dtype == out["ref"][0].dtype == np.float64
    assert _rel(out["port"][0], out["ref"][0]) <= RTOL
    assert out["port"][1] == out["ref"][1]


def test_lmcg():
    xn, yn = _data(300, 10, 1)
    out = _both("lmCG", xn, yn, reg=1e-6, tol=1e-12, max_iter=50)
    assert _rel(out["port"][0], out["ref"][0]) <= RTOL
    direct = np.linalg.solve(xn.T @ xn + 1e-6 * np.eye(10), xn.T @ yn)
    assert _rel(out["port"][0], direct) <= 1e-8


def test_lm_dispatches_to_direct_solve():
    xn, yn = _data(200, 8, 2)
    out = _both("lm", xn, yn)
    assert _rel(out["port"][0], out["ref"][0]) <= RTOL


@pytest.mark.parametrize("max_features", [3, None])
def test_steplm_selects_identically(max_features):
    xn, yn = _data(300, 7, 3)
    out = _both("steplm", xn, yn, max_features=max_features)
    (pb, psel), (rb, rsel) = out["port"][0], out["ref"][0]
    assert psel == rsel and {1, 4, 6} <= set(psel)
    assert _rel(pb, rb) <= RTOL
    assert out["port"][1] == out["ref"][1]


@pytest.mark.parametrize("name,m,n,seed,kw", [
    ("lmDS", 400, 12, 0, dict(reg=1e-6, intercept=True)),
    ("lmCG", 300, 10, 1, dict(reg=1e-6, tol=1e-12, max_iter=50)),
    ("lm", 200, 8, 2, {}),
    ("steplm", 300, 7, 3, dict(max_features=3))])
def test_builtins_at_depth2(monkeypatch, name, m, n, seed, kw):
    """Each builtin at pipeline depth 2 in both packages: the reference's
    coefficients (rel 1e-10) and reuse counters, and bitwise the port's
    depth-1 result."""
    xn, yn = _data(m, n, seed)
    d1 = _both(name, xn, yn, **kw)
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "2")
    d2 = _both(name, xn, yn, **kw)
    res = {k: v[0][0] if name == "steplm" else v[0] for k, v in d2.items()}
    assert _rel(res["port"], res["ref"]) <= RTOL
    assert d2["port"][1] == d2["ref"][1] == d1["port"][1]
    if name == "steplm":
        assert d2["port"][0][1] == d1["port"][0][1] == d2["ref"][0][1]
        assert np.array_equal(d2["port"][0][0], d1["port"][0][0])
    else:
        assert np.array_equal(d2["port"][0], d1["port"][0])
