"""Lifecycle builtins: the port's lmDS / lmCG / lm / steplm against the
reference on the same data (reference at pipeline depth 1, the port on
the CPU). Coefficients agree to rel 1e-10; steplm selects the same
columns in the same order, with identical reuse-cache counters."""
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
