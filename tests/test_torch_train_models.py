"""The port's training loss and gradients against the reference's.

For the reduced configs of the dense (qwen3-0.6b), moe
(deepseek-moe-16b), MLA (deepseek-v2-236b) and audio (musicgen-large)
families, in float32 at seq 128 (above the reduced attn_chunk 64, so
attention takes the "chunked" route in both packages), batch 2: the
reference's `Model.init(PRNGKey(0))` parameters carried over with
`params_from_reference`, the same seeded numpy batch through
`jax.jit(jax.value_and_grad(model.loss, has_aux=True))` and through the
port's `Model.loss` and autograd. The loss agrees within rel 1e-5
(observed <= 1.6e-7) and every parameter's gradient within 1e-4 of that
leaf's largest |gradient| (observed <= 1.7e-5: the same float32
operations in another summation order). Both packages checkpoint each
period (`cfg.remat`) and each loss chunk; the port's loss and gradients
with remat equal its own without, bit for bit, so the recompute
(MoE's routing and its host read of the group sizes included) repeats
the forward. `test_torch_train_families.py` holds the ssm, hybrid and
vision families the same way.

One bf16 step of the reduced qwen3 (float32 masters cast at each use,
as the reference): the loss within rel 1e-3 of the bf16 reference's
(observed 2.3e-5), every gradient within 5e-2 of its leaf's max
(observed <= 3.4e-2; labels shifted by one in a loss chunk move them by
>= 0.8), the embedding's gradient the bf16 cotangent summed into the
float32 table in float32 (bitwise; a bf16 sum gives other values), and
AdamW on identical gradients (the reference's) equal to the reference's
update within 1e-6 of each leaf's max, the new masters float32 values that bf16 cannot
hold. Whole train steps are not compared: at step 1 AdamW's update is
about g/|g|, so a gradient near 0 whose sign differs between the
packages moves a weight by 2·lr, which a whole-step comparison would
report as a fault.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.interop import (params_from_reference,
                                 train_state_to_reference)
from repro_torch.models import build_model
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     trainable_params)
from _torch_threads import one_thread  # noqa: F401

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

SEQ, BATCH = 128, 2
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_TOL = 5e-2
ADAMW_RTOL = 1e-6


def reference_pair(arch, **overrides):
    """(reference model, its float32 params as numpy, the port's training
    model holding the same values, the port's config) for the reduced
    config with `overrides` (the vision model over 16 image tokens, its
    xattn gates drawn nonzero: the reference starts them at 0, which
    would hide the image)."""
    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_build
    rcfg = ref_config(arch).reduced()
    if rcfg.family == "vlm":
        overrides = dict(overrides, n_image_tokens=16)
    rcfg = rcfg.with_(**overrides)
    cfg = get_config(arch).reduced().with_(**overrides)
    ref = ref_build(rcfg)
    with jax.enable_x64(False):  # the float32 init whatever ran before
        params = jax.tree_util.tree_map(np.asarray,
                                        ref.init(jax.random.PRNGKey(0)))
    if cfg.family == "vlm":
        rng = np.random.default_rng(7)
        for key, layer in params["periods"].items():
            if key.endswith(":xattn"):
                gate = layer["xattn"]["gate"]
                layer["xattn"]["gate"] = rng.uniform(
                    0.5, 1.5, gate.shape).astype(np.float32)
    port = build_model(cfg, device="cpu", train=True)
    port.load_state_dict(params_from_reference(params, cfg, "cpu"))
    return ref, params, port, cfg


def batch_for(cfg, seed=1, batch=BATCH, seq=SEQ):
    """Next-token batch (tokens, labels shifted by one; image embeddings
    for the vision model) from a seeded numpy stream."""
    rng = np.random.default_rng(seed)
    shape = (batch, seq + 1) + ((cfg.n_codebooks,) if cfg.n_codebooks
                                else ())
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def reference_loss_and_grads(ref, params, batch, cfg):
    """(loss, {port parameter name: float32 gradient tensor})."""
    with jax.enable_x64(False):
        fn = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))
        (loss, _), grads = fn(params, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        grads = jax.tree_util.tree_map(np.asarray, grads)
    return float(loss), params_from_reference(grads, cfg, "cpu")


def port_loss_and_grads(model, batch):
    params = trainable_params(model)
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                materialize_grads=True)
    return float(loss.detach()), dict(zip(params, grads))


def leaf_errors(got, want):
    """{name: max|got - want| over max|want|} of each leaf."""
    return {n: float((got[n].float() - w).abs().max()
                     / w.abs().max().clamp_min(1e-30))
            for n, w in want.items()}


def check_family(arch):
    ref, params, port, cfg = reference_pair(arch)
    batch = batch_for(cfg)
    want_loss, want = reference_loss_and_grads(ref, params, batch, cfg)
    loss, got = port_loss_and_grads(port, batch)
    assert set(got) == set(want)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), \
        (loss, want_loss)
    errs = leaf_errors(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    # remat repeats the forward exactly: the same bits without it
    port.cfg = cfg.with_(remat=False)
    loss2, got2 = port_loss_and_grads(port, batch)
    assert loss2 == loss
    assert all(torch.equal(got2[n], g) for n, g in got.items())


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "deepseek_moe_16b",
                                  "deepseek_v2_236b", "musicgen_large"])
def test_loss_and_gradients_match_reference(arch):
    check_family(arch)


def _shift_chunk_labels(batch, chunk):
    """Labels of the first loss chunk rolled by one position."""
    labels = batch["labels"].copy()
    labels[:, :chunk] = np.roll(labels[:, :chunk], 1, axis=1)
    return dict(batch, labels=labels)


def test_bf16_step_keeps_float32_masters():
    ref, params, port, cfg = reference_pair("qwen3_0_6b", dtype="bfloat16")
    batch = batch_for(cfg)
    want_loss, want = reference_loss_and_grads(ref, params, batch, cfg)
    cot = []

    def keep_cotangent(module, inputs, out):
        out.register_hook(cot.append)

    hook = port.embed.register_forward_hook(keep_cotangent)
    loss, got = port_loss_and_grads(port, batch)
    hook.remove()
    assert abs(loss - want_loss) <= BF16_LOSS_RTOL * abs(want_loss)
    errs = leaf_errors(got, want)
    assert max(errs.values()) <= BF16_GRAD_TOL, max(errs.items(),
                                                    key=lambda kv: kv[1])
    _, faulted = port_loss_and_grads(
        port, _shift_chunk_labels(batch, cfg.loss_chunk))
    assert max(leaf_errors(faulted, want).values()) > 10 * BF16_GRAD_TOL

    # every leaf float32; the embedding's gradient is its bf16 cotangent
    # scatter-added into the float32 table in float32
    assert all(g.dtype == torch.float32 for g in got.values())
    (g_out,) = cot
    assert g_out.dtype == torch.bfloat16
    ids = torch.from_numpy(batch["tokens"]).long().reshape(-1)
    rows = g_out.reshape(-1, cfg.d_model)
    table = port.embed.tok
    in_f32 = torch.zeros_like(table).index_add_(0, ids, rows.float())
    in_bf16 = torch.zeros(table.shape, dtype=torch.bfloat16).index_add_(
        0, ids, rows).float()
    assert torch.equal(got["embed.tok"], in_f32)
    assert not torch.equal(got["embed.tok"], in_bf16)

    # AdamW on identical gradients: the reference's, through both updates
    from repro.optim.adamw import adamw_init as ref_init
    from repro.optim.adamw import adamw_update as ref_update
    masters = trainable_params(port)
    nested, _ = train_state_to_reference(want, adamw_init(want), cfg)
    with jax.enable_x64(False):
        ref_grads = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                           nested)
        new_ref, _, ref_m = ref_update(ref_grads, ref_init(params), params,
                                       lr=1e-3)
    new_ref = params_from_reference(jax.tree_util.tree_map(
        np.asarray, new_ref), cfg, "cpu")
    _, opt, m = adamw_update(want, adamw_init(masters), masters, lr=1e-3)
    assert abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) \
        <= ADAMW_RTOL * float(ref_m["grad_norm"])
    errs = leaf_errors({n: p.detach() for n, p in masters.items()}, new_ref)
    assert max(errs.values()) <= ADAMW_RTOL, max(errs.items(),
                                                 key=lambda kv: kv[1])
    wq = masters["periods.0.0:attn.attn.wq"].detach()
    assert (wq != wq.to(torch.bfloat16).float()).float().mean() > 0.5

