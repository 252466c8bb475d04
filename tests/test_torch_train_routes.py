"""Training's routes in the port, without the reference (the file imports
no jax, so its `cuda`-marked case runs on the card's machine with
`python -m pytest -m cuda`).

- `Model.loss` never reaches a kernel entry point: with every kernel
  wrapper (flash, wkv6, the selective scan) replaced by one that raises,
  the loss and its gradients run for every family on the CPU with
  `use_pallas` on, the setting under which serving does reach them.
- The CUDA wrappers refuse a call that autograd would record (the
  kernels have no backward in either package) and take a call under
  `torch.no_grad()`; on the CPU that refusal comes before the device
  check, on the card (`cuda`-marked) before the launch.
- The port-only mirror of `tests/test_models.py::
  test_smoke_forward_and_train_step` over every assigned arch: a finite
  loss in (0, 20), one train step, its step count 1, every weight moved
  and still a finite float32 leaf.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.rwkv6 import ops as wops
from repro_torch.kernels.ssd import ops as sops
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import build_model
from _torch_threads import one_thread  # noqa: F401

FAMILIES = ["qwen3_0_6b", "deepseek_moe_16b", "deepseek_v2_236b",
            "rwkv6_3b", "jamba_v0_1_52b", "llama3_2_vision_90b",
            "musicgen_large"]
ENTRY_POINTS = [(fops, "flash_attention"), (fops, "flash_attention_cuda"),
                (wops, "wkv6"), (wops, "wkv6_cuda"),
                (sops, "ssm_scan"), (sops, "ssm_scan_cuda")]


def _cfg(arch, **kw):
    cfg = get_config(arch).reduced()
    if cfg.family == "vlm":
        kw = dict(kw, n_image_tokens=16)
    return cfg.with_(**kw)


def _batch(cfg, seed=0, batch=2, seq=64):
    rng = np.random.default_rng(seed)
    shape = (batch, seq + 1) + ((cfg.n_codebooks,) if cfg.n_codebooks
                                else ())
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


class _Reached(Exception):
    pass


@pytest.fixture
def kernels_raise(monkeypatch):
    """Every kernel entry point replaced by one that raises `_Reached`."""
    def boom(*args, **kwargs):
        raise _Reached
    for mod, name in ENTRY_POINTS:
        monkeypatch.setattr(mod, name, boom)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_never_reaches_a_kernel(arch, kernels_raise):
    """The loss names the plain routes ("ref"/"chunked" attention,
    `wkv_chunked`, `selective_scan`) whatever the sequence length; the
    parity tests run them at S 128, above the reduced attn_chunk."""
    cfg = _cfg(arch, use_pallas=True)
    model = build_model(cfg, device="cpu", train=True).init(seed=0)
    batch = _batch(cfg, batch=1)
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                materialize_grads=True)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)
    # the patch is live: serving under the same config reaches a kernel
    with pytest.raises(_Reached):
        model.forward(torch.from_numpy(batch["tokens"]),
                      image_embeds=batch.get("image_embeds"))


def _wrapper_calls(device, dtype):
    """(name, wrapper, inputs) of each CUDA wrapper at a small shape."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device, dtype)

    B, S, H, hd = 1, 64, 2, 64
    flash = (rand(B, S, H, hd), rand(B, S, H, hd), rand(B, S, H, hd))
    wkv = (rand(B, S, H, hd), rand(B, S, H, hd), rand(B, S, H, hd),
           -torch.rand((B, S, H, hd), generator=g).to(device) - 0.01,
           rand(H, hd, scale=0.1).float(),
           torch.zeros(B, H, hd, hd, device=device))
    di, ds = 32, 16
    ssm = (rand(B, S, di), torch.rand((B, S, di), generator=g).to(device),
           -torch.rand((di, ds), generator=g).to(device) - 0.5,
           rand(B, S, ds), rand(B, S, ds),
           torch.ones(di, device=device),
           torch.zeros(B, di, ds, device=device))
    return [("flash_attention", fops.flash_attention_cuda, flash),
            ("wkv6", wops.wkv6_cuda, wkv),
            ("ssm_scan", sops.ssm_scan_cuda, ssm)]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_wrappers_refuse_grad_before_the_device_check(which):
    name, fn, args = _wrapper_calls("cpu", torch.float32)[which]
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="expected a CUDA tensor"):
        fn(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2])
def test_wrappers_refuse_grad_on_the_card(cuda_device, which):
    name, fn, args = _wrapper_calls(cuda_device, torch.float32)[which]
    launches = {"flash_attention": (fops.LAUNCHES, "flash"),
                "wkv6": (wops.LAUNCHES, "wkv6"),
                "ssm_scan": (sops.LAUNCHES, "ssm_scan")}[name]
    before = launches[0][launches[1]]
    for t in args:  # any one input that requires grad is refused
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)
        t.requires_grad_(False)
    assert launches[0][launches[1]] == before
    for t in args:
        t.requires_grad_(True)
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    assert launches[0][launches[1]] == before + 1
    first = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(first).all() and not first.requires_grad


@pytest.mark.parametrize("arch", ASSIGNED)
def test_smoke_forward_and_train_step(arch):
    cfg = _cfg(arch)
    model = build_model(cfg, device="cpu", train=True)
    params, opt = init_train_state(model, seed=0)
    batch = _batch(cfg)
    loss = float(model.loss(batch)[0].detach())
    assert np.isfinite(loss) and 0 < loss < 20
    before = {n: p.detach().clone() for n, p in params.items()}
    opt, m = make_train_step(model, lr=1e-3)(opt, batch)
    assert np.isfinite(float(m["loss"])) and int(opt.step) == 1
    assert not torch.equal(params["head.w"], before["head.w"])
    moved = sum(not torch.equal(p, before[n]) for n, p in params.items())
    assert moved == len(params), (arch, moved, len(params))
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in params.values())
