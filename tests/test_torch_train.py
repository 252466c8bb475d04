"""The port's optimizer, schedule, train steps, trainer and shapes against
the reference's, on the CPU.

- AdamW: the four cases of `tests/test_substrate.py::TestAdamW`, each
  also against the reference's function on the same arrays (new
  parameters, moments and norm within 1e-6 of each leaf's max), and a
  few steps over several leaves with clipping, weight decay and a bf16
  leaf (its update computed in float32, then cast).
- `warmup_cosine`: the reference's assertions, and the rate bit for bit
  the reference's float32 value at steps 0-120 (the reference test's
  schedule and the trainer's).
- Restart: `TestCheckpoint::test_restart_exactness` through the port
  (6 steps uninterrupted = 3, a checkpoint, a restore and 3 more,
  bitwise), and through the trainer (`main` with a checkpoint every 3
  steps; a second run resumed from the step-3 checkpoint ends on the
  same bits and the same losses).
- Cross-package resume, trainer to trainer: the port's `main` continues
  the reference trainer's step-3 checkpoint to step 6, and the
  reference's trainer the port's, each ending within a stated limit of
  the other package's own step 6 (below).
- `examples/train_lm.py --smoke`'s config (lm-100m cut to 2 layers, d
  128, vocab 512; batch 4, seq 64, lr 3e-4) trained for 30 steps from
  the reference's initial parameters in both packages: the port's loss
  falls (the example's assertion) and every step's loss is within rel
  1e-5 of the reference's (observed <= 1.9e-7).
- `launch/shapes.py`: `tests/test_models.py::test_long_context_skip_rule`
  and every assigned arch's `input_specs` at every shape equal to the
  reference's (shapes and dtypes; decode caches leaf by leaf).

The resume limit: the two packages sum in other orders, so a gradient
near 0 can take the other sign, and AdamW's step (about lr · sign(g)
early on) then moves that weight apart by up to 2 · lr a step. After the
3 resumed steps every parameter entry is within 2 · Σ lr of the other
package's, and in every leaf (parameters and moments) at most 0.1 % of
the entries are further apart than 1e-4 of the leaf's largest |value|
(observed: one entry of embed.tok, 1.9e-4 apart; Σ lr = 1.65e-3).
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from torch import nn

from repro_torch.checkpoint import store
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.interop import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.launch import shapes as pshapes
from repro_torch.launch import train as ptrain
from repro_torch.launch.steps import (init_train_state, make_train_step,
                                      train_state_shapes)
from repro_torch.models import build_model
from repro_torch.optim.adamw import (accumulate_grads,
                                     adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.schedules import warmup_cosine
from _torch_threads import one_thread  # noqa: F401

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

ADAMW_TOL = 1e-6
SMOKE_LOSS_RTOL = 1e-5
RESUME_SHARE = 1e-3
RESUME_NEAR = 1e-4


def _close(got, want, tol=ADAMW_TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _ref_adamw():
    from repro.optim import adamw
    return adamw


def _adamw_pair(p, g, **kw):
    """The port's and the reference's adamw_update on the same arrays:
    ((new params, state, metrics) of each, numpy)."""
    ref = _ref_adamw()
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tg = {k: torch.tensor(v) for k, v in g.items()}
    new_p, st, m = adamw_update(tg, adamw_init(tp), tp, **kw)
    with jax.enable_x64(False):
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        rp, rst, rm = ref.adamw_update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       ref.adamw_init(jp), jp, **kw)
    return (new_p, st, m), (rp, rst, rm)


class TestAdamW:
    def test_matches_reference(self, rng):
        p = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
        g = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
        (new_p, _, _), (rp, _, _) = _adamw_pair(
            p, g, lr=0.1, b1=0.9, b2=0.95, weight_decay=0.0,
            max_grad_norm=None)
        # first step -> mhat = g, vhat = g², delta = g/(|g| + eps)
        want = p["w"] - 0.1 * g["w"] / (np.abs(g["w"]) + 1e-8)
        np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
        _close(new_p["w"], rp["w"])

    def test_weight_decay(self):
        p = {"w": np.ones((2,), np.float32)}
        g = {"w": np.zeros((2,), np.float32)}
        (new_p, _, _), (rp, _, _) = _adamw_pair(
            p, g, lr=0.1, weight_decay=0.5, max_grad_norm=None)
        np.testing.assert_allclose(new_p["w"].numpy(), 0.95)
        _close(new_p["w"], rp["w"])

    def test_clip(self, rng):
        g = rng.normal(size=(100,)).astype(np.float32) * 100
        clipped, norm = clip_by_global_norm({"w": torch.tensor(g)}, 1.0)
        assert abs(float(torch.sqrt(torch.sum(clipped["w"] ** 2)))
                   - 1.0) < 1e-4
        with jax.enable_x64(False):
            rc, rn = _ref_adamw().clip_by_global_norm({"w": jnp.asarray(g)},
                                                      1.0)
        _close(norm, rn)
        _close(clipped["w"], rc["w"])

    def test_accumulate_grads(self, rng):
        w = rng.normal(size=(3, 2)).astype(np.float32)
        x = rng.normal(size=(4, 5, 3)).astype(np.float32)
        module = nn.Module()
        module.w = nn.Parameter(torch.tensor(w))

        def loss_fn(m, mb):
            return torch.mean((mb["x"] @ m.w) ** 2), {}

        loss, grads = accumulate_grads(loss_fn, module,
                                       {"x": torch.tensor(x)})
        # equals the full-batch gradient
        full = loss_fn(module, {"x": torch.tensor(x).reshape(20, 3)})[0]
        (g_full,) = torch.autograd.grad(full, [module.w])
        np.testing.assert_allclose(float(loss), float(full.detach()),
                                   rtol=1e-6)
        np.testing.assert_allclose(grads["w"].numpy(), g_full.numpy(),
                                   rtol=1e-5)

        def ref_loss(params, mb):
            return jnp.mean((mb["x"] @ params["w"]) ** 2), {}

        with jax.enable_x64(False):
            rl, rg = _ref_adamw().accumulate_grads(
                ref_loss, {"w": jnp.asarray(w)}, {"x": jnp.asarray(x)})
        _close(loss, rl)
        _close(grads["w"], rg["w"])

    def test_steps_with_clip_decay_and_bf16_leaf(self, rng):
        """Three steps on three leaves (one bf16) at the default clip 1.0
        and weight decay 0.1: parameters, moments, step and norm against
        the reference's at every step."""
        ref = _ref_adamw()
        shapes = {"a": (8, 5), "b": (5,), "c": (3, 4)}
        p = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        tp = {k: torch.tensor(v) for k, v in p.items()}
        tp["c"] = tp["c"].to(torch.bfloat16)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        jp["c"] = jp["c"].astype(jnp.bfloat16)
        tst = adamw_init(tp)
        with jax.enable_x64(False):
            jst = ref.adamw_init(jp)
        for step in range(3):
            g = {k: rng.normal(size=s).astype(np.float32) * 3
                 for k, s in shapes.items()}
            _, tst, tm = adamw_update({k: torch.tensor(v)
                                       for k, v in g.items()},
                                      tst, tp, lr=1e-2)
            with jax.enable_x64(False):
                jp, jst, jm = ref.adamw_update(
                    {k: jnp.asarray(v) for k, v in g.items()}, jst, jp,
                    lr=1e-2)
            assert int(tst.step) == int(jst.step) == step + 1
            _close(tm["grad_norm"], jm["grad_norm"])
            for k in shapes:
                _close(tst.m[k], jst.m[k])
                _close(tst.v[k], jst.v[k])
            _close(tp["a"], jp["a"])
            _close(tp["b"], jp["b"])
            # the bf16 leaf: the same float32 update, rounded once
            assert tp["c"].dtype == torch.bfloat16
            got = tp["c"].float().numpy()
            want = np.asarray(jp["c"].astype(jnp.float32))
            assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(
                want).max()


@pytest.mark.parametrize("peak,warmup,total", [(1.0, 10, 100),
                                               (3e-4, 20, 200)])
def test_warmup_cosine(peak, warmup, total):
    from repro.optim.schedules import warmup_cosine as ref_schedule
    kw = dict(peak_lr=peak, warmup_steps=warmup, total_steps=total)
    if peak == 1.0:
        assert float(warmup_cosine(0, **kw)) == 0.0
        assert abs(float(warmup_cosine(10, **kw)) - 1.0) < 1e-6
        assert float(warmup_cosine(100, **kw)) <= 0.11
    for step in range(121):
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        want = np.asarray(ref_schedule(step, **kw))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), step


TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
            vocab_size=128, loss_chunk=16, attn_chunk=32)


def test_restart_exactness(tmp_path):
    """Interrupted training == uninterrupted (lineage exactness), the
    reference test's config through the port's step and checkpoints."""
    cfg = get_config("lm_100m").with_(**TINY)
    model = build_model(cfg, device="cpu", train=True)
    pipe = TokenPipeline(vocab=128, batch=2, seq_len=32, seed=0)
    step_fn = make_train_step(model, lr=1e-3)
    params, opt0 = init_train_state(model, seed=0)
    init = {n: p.detach().clone() for n, p in params.items()}

    def run(start, stop, opt):
        for s in range(start, stop):
            opt, _ = step_fn(opt, pipe.batch_at(s))
        return opt

    opt_a = run(0, 6, opt0)
    state_a = train_state_to_reference(params, opt_a, cfg)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(init[n])
    opt1 = run(0, 3, adamw_init(params))
    store.save(str(tmp_path), 3, {"p": train_state_to_reference(
        params, opt1, cfg)})
    back, _ = store.restore(str(tmp_path),
                            {"p": train_state_to_reference(params, opt1,
                                                           cfg)})
    values, opt_b = train_state_from_reference(*back["p"], cfg, "cpu")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(values[n])
    opt_b = run(3, 6, opt_b)
    state_b = train_state_to_reference(params, opt_b, cfg)
    la = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), state_a))
    lb = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), state_b))
    assert len(la) == len(lb) > 0
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)


TRAINER = ["--reduced", "--steps", "6", "--batch", "2", "--seq-len", "64",
          "--ckpt-every", "3", "--log-every", "1", "--lr", "1e-3",
          "--warmup", "2"]


def _port_main(ckpt_dir):
    return ptrain.main(TRAINER + ["--ckpt-dir", str(ckpt_dir),
                                 "--device", "cpu"])


def _ref_main(ckpt_dir, monkeypatch):
    from repro.launch import train as rtrain
    monkeypatch.setattr(sys, "argv", ["train"] + TRAINER
                        + ["--ckpt-dir", str(ckpt_dir)])
    with jax.enable_x64(False):
        rtrain.main()


def _leaves(ckpt_dir, step):
    """A checkpoint's leaves as numpy, in the stored order."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for leaf in manifest["leaves"]:
        with np.load(os.path.join(path, f"shard_{leaf['shard']}.npz")) as z:
            out.append(z[leaf["key"]])
    return manifest, out


def _resume_from(src, dst, step=3):
    shutil.copytree(os.path.join(src, f"step_{step:08d}"),
                    os.path.join(dst, f"step_{step:08d}"))


def test_trainer_resumes_bitwise(tmp_path, capsys):
    a = _port_main(tmp_path / "a")
    assert a["start_step"] == 0 and len(a["losses"]) == 6
    assert "resumed" not in capsys.readouterr().out
    _resume_from(tmp_path / "a", tmp_path / "b")
    b = _port_main(tmp_path / "b")
    assert "resumed from step 3" in capsys.readouterr().out
    assert b["start_step"] == 3 and b["losses"] == a["losses"][3:]
    assert b["opt_state"].step.shape == () and int(b["opt_state"].step) == 6
    _, la = _leaves(tmp_path / "a", 6)
    mb, lb = _leaves(tmp_path / "b", 6)
    assert mb["lineage"]["pipeline"]["step"] == 3
    for x, y in zip(la, lb, strict=True):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _lr_sum():
    return sum(float(warmup_cosine(s, peak_lr=1e-3, warmup_steps=2,
                                   total_steps=6)) for s in (3, 4, 5))


def _close_after_resume(got, want):
    """`got` and `want` (checkpoint leaves; the step first, then the
    moments m and v, then the parameters) within the resume limit of the
    module docstring."""
    n = (len(want) - 1) // 3
    assert got[0] == want[0]
    for i, (x, y) in enumerate(zip(got, want, strict=True)):
        d = np.abs(x.astype(np.float64) - y)
        far = d > RESUME_NEAR * np.abs(y).max()
        assert far.mean() <= RESUME_SHARE, (i, int(far.sum()), x.size)
        if i > 2 * n:
            assert d.max() <= 2 * _lr_sum(), (i, float(d.max()))


def test_port_continues_reference_checkpoint(tmp_path, monkeypatch):
    _ref_main(tmp_path / "ref", monkeypatch)
    _resume_from(tmp_path / "ref", tmp_path / "port")
    out = _port_main(tmp_path / "port")
    assert out["start_step"] == 3
    _, want = _leaves(tmp_path / "ref", 6)
    _, got = _leaves(tmp_path / "port", 6)
    _close_after_resume(got, want)


def test_reference_continues_port_checkpoint(tmp_path, monkeypatch):
    _port_main(tmp_path / "port")
    _resume_from(tmp_path / "port", tmp_path / "ref")
    _ref_main(tmp_path / "ref", monkeypatch)
    _, want = _leaves(tmp_path / "port", 6)
    _, got = _leaves(tmp_path / "ref", 6)
    _close_after_resume(got, want)


SMOKE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
             vocab_size=512, loss_chunk=32, attn_chunk=64)


def test_train_lm_smoke_matches_reference():
    from repro.configs import get_config as ref_config
    from repro.launch.steps import init_train_state as ref_init
    from repro.launch.steps import make_train_step as ref_step
    from repro.models import build_model as ref_build
    pipe = TokenPipeline(vocab=512, batch=4, seq_len=64, seed=0)
    with jax.enable_x64(False):
        ref = ref_build(ref_config("lm-100m").with_(**SMOKE))
        params, opt = ref_init(ref, jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(np.asarray, params)
        values, port_opt = train_state_from_reference(
            params, opt, get_config("lm-100m").with_(**SMOKE), "cpu")
        step = jax.jit(ref_step(ref, lr=3e-4))
        want = []
        for s in range(30):
            batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}
            params, opt, m = step(params, opt, batch)
            want.append(float(m["loss"]))
    model = build_model(get_config("lm-100m").with_(**SMOKE), device="cpu",
                        train=True)
    model.load_state_dict(values)
    port_step = make_train_step(model, lr=3e-4)
    got = []
    for s in range(30):
        port_opt, m = port_step(port_opt, pipe.batch_at(s))
        got.append(float(m["loss"]))
    assert np.mean(got[-5:]) < np.mean(got[:5])
    np.testing.assert_allclose(got, want, rtol=SMOKE_LOSS_RTOL)


def test_train_state_shapes_match_reference():
    from repro.configs import get_config as ref_config
    from repro.launch.steps import train_state_shapes as ref_shapes
    from repro.models import build_model as ref_build
    cfg = get_config("deepseek_moe_16b").reduced()
    params, opt = train_state_shapes(build_model(cfg, device="cpu"))
    rp, ro = ref_shapes(ref_build(ref_config("deepseek_moe_16b").reduced()))
    n = cfg.n_periods()
    want = {}
    for path, leaf in _flatten_specs(rp):
        if path.startswith("periods."):
            for i in range(n):
                want["periods.%d.%s" % (i, path[8:])] = leaf.shape[1:]
        else:
            want[path] = leaf.shape
    assert {k: s for k, (s, _) in params.items()} == want
    assert all(d == torch.float32 for _, d in params.values())
    assert opt.step == ((), torch.int32) and ro.step.dtype == jnp.int32
    assert opt.m == {k: (s, torch.float32) for k, (s, _) in params.items()}
    assert opt.v == opt.m


def _flatten_specs(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, sub in items:
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(sub, (dict, list, tuple)):
            yield from _flatten_specs(sub, path)
        else:
            yield path, sub


def test_long_context_skip_rule():
    ok, why = pshapes.cell_supported(get_config("llama3_2_3b"), "long_500k")
    assert not ok and "full-attention" in why
    ok, _ = pshapes.cell_supported(get_config("rwkv6_3b"), "long_500k")
    assert ok
    ok, _ = pshapes.cell_supported(get_config("jamba_v0_1_52b"),
                                   "long_500k")
    assert ok


def _spec_leaves(tree):
    """(shape, dtype name) leaves of a spec tree, dicts by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not (
            len(tree) == 2 and isinstance(tree[1], torch.dtype)):
        return [x for t in tree for x in _spec_leaves(t)]
    if isinstance(tree, tuple):
        return [(tuple(tree[0]), str(tree[1]).removeprefix("torch."))]
    return [(tuple(tree.shape), str(tree.dtype))]


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_match_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.launch import shapes as rshapes
    from repro.models import build_model as ref_build
    cfg, rcfg = get_config(arch), ref_config(arch)
    model = build_model(cfg, device="meta")
    ref = ref_build(rcfg)
    assert pshapes.SHAPES == rshapes.SHAPES
    assert pshapes.LONG_OK_FAMILIES == rshapes.LONG_OK_FAMILIES
    for name in pshapes.SHAPES:
        assert pshapes.cell_supported(cfg, name)[0] \
            == rshapes.cell_supported(rcfg, name)[0]
        got = pshapes.input_specs(cfg, name, model)
        want = rshapes.input_specs(rcfg, name, ref)
        assert set(got) == set(want) and got["kind"] == want["kind"]
        assert (got["B"], got["S"]) == (want["B"], want["S"])
        for key in set(got) - {"kind", "B", "S", "cur_len"}:
            assert _spec_leaves(got[key]) == _spec_leaves(want[key]), key
        if got["kind"] == "decode":
            assert got["cur_len"] is int
            assert want["cur_len"].shape == ()
