"""int8 compression with error feedback and FedAvg against the reference.

Mirrors `tests/test_substrate.py::TestCompression` and
`tests/test_federated.py::test_fedavg_trainer_converges` on the port, and
holds the port against the reference (in-process: neither needs a
multi-device host) on the same seeded float32 inputs: `quantize_int8`'s
q, scale and residual bitwise (inputs with exact .5 ties included: both
round half to even), `compress_tree` and `compressed_bytes` exactly, the
cross-site mean of int8 trees within float32's 1e-6; and `FedAvgTrainer`
with and without compression on the same batches: anchors within rtol
1e-5 / atol 1e-6 after 3 syncs and `bytes_exchanged` equal. The
reference runs under `jax.enable_x64(False)` with float32 arrays
(importing `repro.core` turns x64 on for the worker).
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import compress
from repro_torch.distributed.fedavg import FedAvgTrainer

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")


def _ties(n: int = 256) -> np.ndarray:
    """max|g| = 127 (scale exactly 1), then every half-integer tie of
    [-126.5, 126.5] and random values."""
    halves = np.arange(-126.5, 127.0, 1.0)
    rest = np.random.default_rng(5).uniform(-127, 127, n)
    return np.concatenate([[127.0], halves, rest]).astype(np.float32)


CASES = {
    "normal": lambda r: (r.normal(size=(4096,)), np.zeros(4096)),
    "normal_with_err": lambda r: (r.normal(size=(64, 64)),
                                  1e-2 * r.normal(size=(64, 64))),
    "small": lambda r: (1e-3 * r.normal(size=(300,)), 1e-5 * r.normal(
        size=(300,))),
    "ties": lambda r: (_ties(), np.zeros(_ties().shape)),
    "ties_scaled": lambda r: (_ties() * np.float32(2.0 ** -7),
                              np.zeros(_ties().shape)),
    "zeros": lambda r: (np.zeros(17), np.zeros(17)),
}


class TestCompression:
    """tests/test_substrate.py::TestCompression on the port."""

    def test_quantize_roundtrip_small_error(self, rng):
        g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
        q, scale, err = compress.quantize_int8(g, torch.zeros_like(g))
        back = compress.dequantize(q, scale)
        assert float((back + err - g).abs().max()) < 1e-6  # exact with EF
        assert q.dtype == torch.int8

    def test_error_feedback_unbiased(self):
        """Mean of compressed grads converges to mean of true grads."""
        errs = torch.zeros(64)
        total_true, total_sent = torch.zeros(64), torch.zeros(64)
        for i in range(50):
            g = torch.from_numpy(np.random.default_rng(i).normal(
                size=(64,)).astype(np.float32)) * 0.01
            q, s, errs = compress.quantize_int8(g, errs)
            total_sent = total_sent + compress.dequantize(q, s)
            total_true = total_true + g
        resid = float((total_true - total_sent).abs().max())
        assert resid < 1e-3  # bounded by one step's quantization error


@pytest.mark.parametrize("case", list(CASES))
def test_quantize_int8_is_bitwise_the_reference(case):
    from repro.distributed import compress as rcomp
    g, err = (np.asarray(a, np.float32)
              for a in CASES[case](np.random.default_rng(7)))
    with jax.enable_x64(False):
        want = rcomp.quantize_int8(jnp.asarray(g), jnp.asarray(err))
        want = [np.asarray(w) for w in want]
    got = compress.quantize_int8(torch.from_numpy(g), torch.from_numpy(err))
    for a, b in zip(got, want):
        assert a.numpy().dtype == b.dtype
        assert a.numpy().tobytes() == b.tobytes()
    if case == "ties":  # every tie went to the even integer
        halves = np.arange(-126.5, 127.0, 1.0)
        q = got[0].numpy()[1:1 + len(halves)].astype(np.float64)
        assert np.array_equal(q, np.round(halves))  # numpy: half to even


def _tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                  "d": rng.normal(size=(2, 2, 2)).astype(np.float32)}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_compress_tree_and_bytes_match_reference():
    from repro.distributed import compress as rcomp
    rng = np.random.default_rng(11)
    grads, errs = _tree(rng), _tree(rng)
    with jax.enable_x64(False):
        jg = jax.tree_util.tree_map(jnp.asarray, grads)
        want = rcomp.compress_tree(jg, jax.tree_util.tree_map(
            lambda e: jnp.asarray(e) * 1e-2, errs))
        want_bytes = rcomp.compressed_bytes(jg)
        want_init = rcomp.init_error_state(jg)
    tg = _torch_tree(grads)
    # the residuals' dicts in another key order: leaves pair up by key
    scaled = {"b": {k: torch.from_numpy(v) * 1e-2
                    for k, v in reversed(errs["b"].items())},
              "a": torch.from_numpy(errs["a"]) * 1e-2}
    got = compress.compress_tree(tg, scaled)
    for part_got, part_want in zip(got, want):
        gl, wl = dict(_leaves(part_got)), dict(_leaves(part_want))
        assert gl.keys() == wl.keys()
        for k in gl:
            assert gl[k].tobytes() == wl[k].tobytes(), k
    assert compress.compressed_bytes(tg) == want_bytes == (
        12 + 5 + 8 + 4 * 3, 4 * 25)
    init = compress.init_error_state(tg)
    for (k, a), (_, b) in zip(_leaves(init), _leaves(want_init)):
        assert a.dtype == b.dtype == np.float32 and not a.any() and \
            a.shape == b.shape


def test_crosspod_mean_matches_reference():
    """The reference's all-gather over a site axis (under `jax.vmap`'s
    axis name) against the port's stack over the sites' trees."""
    from repro.distributed import compress as rcomp
    rng = np.random.default_rng(13)
    sites = [_tree(rng) for _ in range(4)]
    with jax.enable_x64(False):
        qs, ss = [], []
        for t in sites:
            q, s, _ = rcomp.compress_tree(
                jax.tree_util.tree_map(jnp.asarray, t),
                jax.tree_util.tree_map(jnp.zeros_like, t))
            qs.append(q)
            ss.append(s)
        stack = lambda *xs: jnp.stack(xs)  # noqa: E731
        want = jax.vmap(lambda q, s: rcomp.crosspod_mean_int8(q, s, "site"),
                        axis_name="site")(
            jax.tree_util.tree_map(stack, *qs),
            jax.tree_util.tree_map(stack, *ss))
        want = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], want)
    tq, tsc = [], []
    for t in sites:
        q, s, _ = compress.compress_tree(
            _torch_tree(t), compress.init_error_state(_torch_tree(t)))
        tq.append(q)
        tsc.append(s)
    got = compress.crosspod_mean_int8(tq, tsc)
    for (k, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# FedAvg
# ---------------------------------------------------------------------------

def _regression(rng):
    w_true = rng.normal(size=(64, 1))

    def make_batch(site, step):
        r = np.random.default_rng(100 * site + step)
        x = r.normal(size=(96, 64))
        return (x.astype(np.float32),
                (x @ w_true + 0.01 * r.normal(size=(96, 1))).astype(
                    np.float32))
    return w_true, make_batch


def _torch_loss(params, batch):
    pred = batch["x"] @ params["w"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def test_fedavg_trainer_converges(rng):
    """Relaxed-sync FedAvg reaches a reasonable regression loss and
    compression reduces wire bytes 4x (the reference's test, float32)."""
    w_true, make_batch = _regression(rng)
    results = {}
    for compressed in (False, True):
        tr = FedAvgTrainer(loss_fn=_torch_loss, n_sites=3, sync_every=4,
                           lr=5e-2, compress_int8=compressed)
        tr.init({"w": torch.zeros((64, 1))})
        for step in range(100):
            for s in range(3):
                x, y = make_batch(s, step)
                tr.local_step(s, {"x": torch.from_numpy(x),
                                  "y": torch.from_numpy(y)})
            tr.maybe_sync()
        err = float(np.abs(tr.anchor["w"].numpy() - w_true).max())
        results[compressed] = (err, tr.bytes_exchanged)
    assert results[False][0] < 0.35
    assert results[True][0] < 0.45           # int8 a bit noisier
    assert results[True][1] < 0.3 * results[False][1]


@pytest.mark.parametrize("compressed", [False, True])
def test_fedavg_matches_reference(rng, compressed):
    from repro.distributed.fedavg import FedAvgTrainer as RefTrainer
    _, make_batch = _regression(rng)

    def ref_loss(params, batch):
        pred = batch["x"] @ params["w"]
        return jnp.mean((pred - batch["y"]) ** 2), {}

    with jax.enable_x64(False):
        ref = RefTrainer(loss_fn=ref_loss, n_sites=3, sync_every=4, lr=5e-2,
                         compress_int8=compressed)
        ref.init({"w": jnp.zeros((64, 1), jnp.float32)})
        port = FedAvgTrainer(loss_fn=_torch_loss, n_sites=3, sync_every=4,
                             lr=5e-2, compress_int8=compressed)
        port.init({"w": torch.zeros((64, 1), dtype=torch.float32)})
        syncs = 0
        for step in range(12):
            for s in range(3):
                x, y = make_batch(s, step)
                lr_ = ref.local_step(s, {"x": jnp.asarray(x),
                                         "y": jnp.asarray(y)})
                lp = port.local_step(s, {"x": torch.from_numpy(x),
                                         "y": torch.from_numpy(y)})
                assert lp == pytest.approx(lr_, rel=1e-5)
            synced = ref.maybe_sync()
            assert port.maybe_sync() == synced
            syncs += synced
            assert port.bytes_exchanged == ref.bytes_exchanged
        assert syncs == 3 and port.step == ref.step == 12
        want = np.asarray(ref.anchor["w"])
    got = port.anchor["w"]
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for site in port.sites:  # every site restarts from the anchor
        assert torch.equal(site.params["w"], got)
        assert site.params["w"] is not got
    if compressed:
        assert port.bytes_exchanged == 3 * 3 * (64 + 4)
        assert all(float(s.err["w"].abs().max()) > 0 for s in port.sites)
    else:
        assert port.bytes_exchanged == 3 * 3 * 4 * 64


# ---------------------------------------------------------------------------
# FedAvg of an LM through Model.loss with remat (ROADMAP Queue 3, item 37)
# ---------------------------------------------------------------------------

class _Loss(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.m = model

    def forward(self, batch):
        return self.m.loss(batch)


class _LossOf:
    """`loss_fn(params, batch)`: the model's `loss` at `params` (name ->
    tensor) through `torch.func.functional_call`, as a site computes it;
    the module's own weights stay as they are."""

    def __init__(self, model):
        self.module = _Loss(model)

    def __call__(self, params, batch):
        return torch.func.functional_call(
            self.module, {f"m.{k}": v for k, v in params.items()}, (batch,))


def _grads_at(loss_fn, params, batch):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss, _ = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                materialize_grads=True)
    return float(loss.detach()), dict(zip(leaves, grads))


def test_fedavg_site_gradients_with_remat_match_reference():
    """lm-100m (reduced, float32), batch 2 × 32, at a site's parameters
    (the model's + 0.05·N(0, 1), drawn with numpy): the gradients through
    `functional_call` with remat on equal those with remat off bit for
    bit (the recompute repeats the forward at the same tensors), and the
    reference's `jax.grad` of `Model.loss(params, batch)` within the
    training parity tests' limits (loss rel 1e-5, each leaf 1e-4 of its
    largest |gradient|); then one `FedAvgTrainer` round with remat on."""
    from test_torch_train_models import (GRAD_TOL, LOSS_RTOL, batch_for,
                                         leaf_errors, reference_loss_and_grads,
                                         reference_pair)
    from repro_torch.interop import params_from_reference
    ref, params, port, cfg = reference_pair("lm_100m")
    assert cfg.remat
    rng = np.random.default_rng(37)
    site_np = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    site = params_from_reference(site_np, cfg, "cpu")
    own = {k: v.detach().clone() for k, v in port.state_dict().items()}
    batch = batch_for(cfg, batch=2, seq=32)
    loss_fn = _LossOf(port)

    loss_on, on = _grads_at(loss_fn, site, batch)
    port.cfg = cfg.with_(remat=False)
    loss_off, off = _grads_at(loss_fn, site, batch)
    port.cfg = cfg
    assert loss_on == loss_off
    assert all(torch.equal(on[n], off[n]) for n in off)
    # the module's own weights were never the ones differentiated
    assert all(torch.equal(v, own[k]) for k, v in port.state_dict().items())

    want_loss, want = reference_loss_and_grads(ref, site_np, batch, cfg)
    assert set(on) == set(want)
    assert abs(loss_on - want_loss) <= LOSS_RTOL * abs(want_loss)
    errs = leaf_errors(on, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])

    tr = FedAvgTrainer(loss_fn=loss_fn, n_sites=2, sync_every=1, lr=1e-3)
    tr.init({k: v.clone() for k, v in site.items()})
    losses = [tr.local_step(s, batch_for(cfg, seed=2 + s, batch=2, seq=32))
              for s in range(2)]
    assert tr.maybe_sync() and tr.step == 1
    assert all(np.isfinite(losses))
    moved = [float((tr.anchor[k] - site[k]).abs().max()) for k in site]
    assert all(np.isfinite(moved)) and max(moved) > 0
