"""Algorithm builtins: the port's `repro_torch.lifecycle.algorithms`
against the reference's `repro.lifecycle.algorithms` on the same seeded
data (the reference at pipeline depth 1, the port on the CPU). Mirrors
tests/test_lifecycle.py::TestAlgorithms, each held against the reference
too: pca's components and projections within 1e-10 up to a per-column
sign (eigenvectors' signs are arbitrary), kmeans' centers within 1e-10
with equal assignments, l2svm's w and mlogreg's W within rtol 1e-9 (many
iterations of float64 products summed in another order), l2svm also on
the bcoo lane."""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.lifecycle import algorithms as ralg
from repro_torch.lifecycle import algorithms as talg


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


def _rt(key, **kw):
    return (T.LineageRuntime(device="cpu", **kw) if key == "port"
            else R.LineageRuntime(**kw))


def _both(fn_name, arrays, sparsity=None, rt_kw=None, **kw):
    out = {}
    for key, pk, mod in (("ref", R, ralg), ("port", T, talg)):
        leaves = [pk.input_tensor(f"a{i}", a,
                                  sparsity=sparsity if i == 0 else None)
                  for i, a in enumerate(arrays)]
        out[key] = getattr(mod, fn_name)(*leaves, runtime=_rt(key,
                                                               **(rt_kw or {})),
                                         **kw)
    return out["ref"], out["port"]


def _rel(got, want):
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _signs(got, want):
    """Per-column signs that align `got` with `want`."""
    return np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)


def test_pca(rng):
    x = rng.normal(size=(100, 6)) @ np.diag([5, 3, 1, .5, .2, .1])
    (rc, rp), (tc, tp) = _both("pca", [x], k=2)
    s = _signs(tc, rc)
    assert np.max(np.abs(tc * s - rc)) <= 1e-10
    assert np.max(np.abs(tp * s - rp)) <= 1e-10 * np.max(np.abs(rp))
    xc = x - x.mean(0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    np.testing.assert_allclose(np.diag(np.abs(tc.T @ vt[:2].T)), 1.0,
                               atol=1e-6)


def test_kmeans(rng):
    a = rng.normal(size=(100, 2)) + [10, 10]
    b = rng.normal(size=(100, 2)) - [10, 10]
    x = np.vstack([a, b, rng.normal(size=(50, 2))])
    (rcen, rasg), (tcen, tasg) = _both("kmeans", [x], k=3, seed=1)
    assert np.array_equal(tasg, rasg)
    assert np.max(np.abs(tcen - rcen)) <= 1e-10
    assert len(set(tasg[:100])) == 1 and tasg[0] != tasg[150]


def test_l2svm(rng):
    x = rng.normal(size=(200, 5))
    y = np.sign(x @ rng.normal(size=(5, 1)))
    rw, tw = _both("l2svm", [x, y], max_iter=50)
    assert _rel(tw, rw) <= 1e-9
    assert (np.sign(x @ tw) == y).mean() > 0.97


def test_l2svm_sparse_inputs(rng):
    """The bcoo lane: X below the sparse threshold, bound as BCOO in both
    packages; w as on the dense lane."""
    x = rng.normal(size=(256, 32)) * (rng.random((256, 32)) < 0.1)
    y = np.sign(x @ rng.normal(size=(32, 1)) + 1e-3)
    rw, tw = _both("l2svm", [x, y], sparsity=0.1,
                   rt_kw=dict(sparse_inputs=True), max_iter=30)
    assert _rel(tw, rw) <= 1e-9
    dense = talg.l2svm(T.input_tensor("Xd", x), T.input_tensor("yd", y),
                       max_iter=30, runtime=_rt("port"))
    assert _rel(tw, dense) <= 1e-9


def test_mlogreg(rng):
    x = rng.normal(size=(300, 4))
    labels = (x[:, 0] > 0).astype(int)
    yoh = np.zeros((300, 2))
    yoh[np.arange(300), labels] = 1
    rW, tW = _both("mlogreg", [x, yoh], max_iter=150)
    assert _rel(tW, rW) <= 1e-9
    assert ((x @ tW).argmax(1) == labels).mean() > 0.95


def test_mlogreg_sparse_inputs(rng):
    """The bcoo lane: X below the sparse threshold, bound as BCOO in both
    packages, so every iteration's X @ W and Xᵀ(P - Y) are block-sparse
    products of several columns (one a class); W as on the dense lane."""
    x = rng.normal(size=(256, 32)) * (rng.random((256, 32)) < 0.1)
    labels = np.argmax(x @ rng.normal(size=(32, 3)), axis=1)
    yoh = np.eye(3)[labels]
    rW, tW = _both("mlogreg", [x, yoh], sparsity=0.1,
                   rt_kw=dict(sparse_inputs=True), max_iter=30)
    assert _rel(tW, rW) <= 1e-9
    dense = talg.mlogreg(T.input_tensor("Xd", x), T.input_tensor("Yd", yoh),
                         max_iter=30, runtime=_rt("port"))
    assert _rel(tW, dense) <= 1e-9


def test_mlogreg_three_classes(rng):
    x = rng.normal(size=(200, 5))
    labels = rng.integers(0, 3, size=200)
    yoh = np.eye(3)[labels]
    rW, tW = _both("mlogreg", [x, yoh], max_iter=40, lr=0.3)
    assert _rel(tW, rW) <= 1e-9


def test_y_cache_is_keyed_by_the_leaf(rng):
    """l2svm's label cache is the reference's: one host copy per label
    leaf (uid), read once per leaf however many iterations run."""
    y = T.input_tensor("ycache", np.ones((8, 1)))
    rt = _rt("port")
    first = talg.y_np_cache(y, rt)
    assert talg.y_np_cache(y, rt) is first
    assert talg._y_cache[y.node.uid] is first
