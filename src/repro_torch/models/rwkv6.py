"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free, data-dependent
per-channel decay.

Port of `repro.models.rwkv6`, names kept. Time-mix uses the chunked WKV
form (GLA-style): intra-chunk is an attention-like triangular product
with relative decays, inter-chunk a rank-dh state carried from chunk to
chunk, O(S·C·dh) instead of O(S²); decode is O(1) per token from the
recurrent state. Prefill's WKV goes through `kernels.rwkv6.ops.wkv6`:
on CUDA the hand-written kernel of `csrc/wkv6.cu`, on the CPU
`wkv_chunked` (the reference's own off-TPU route, kept with `SUB` in
`kernels/rwkv6/ref.py` below the model and imported here). Decode runs
`wkv_step` in plain torch, as in the reference.

The module holds each weight the reference casts with `.astype(dt)` in
the compute dtype; `w0`, `u` and `ln_x`, which the reference uses in
float32, stay float32.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.rwkv6 import ops as wops
from ..kernels.rwkv6.ref import SUB, wkv_chunked  # noqa: F401 (names kept)
from .layers import _normal, cdtype, dense_init, frozen, load_, silu

LORA_SHIFT = 32     # token-shift ddlerp lora rank
LORA_DECAY = 64     # decay lora rank
MAX_DECAY = 5.0     # per-step |log w| clamp: decays stronger than e^-5
                    # per step are numerically indistinguishable after a
                    # few tokens; clamping keeps every factored exponent
                    # within |SUB · MAX_DECAY| = 80 < f32's exp range.


def rwkv6_init(gen: torch.Generator, cfg) -> dict:
    """Float32 values with the reference's distributions and scales (the
    numbers cannot equal jax.random's), nested as the reference's pytree."""
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    H = d // dh
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        # token-shift ddlerp
        "mu_x": full((d,), 0.5),
        "mu": full((5, d), 0.5),                      # r,k,v,w,g
        "tm_w1": dense_init(gen, d, 5 * LORA_SHIFT, scale=0.01),
        "tm_w2": _normal(gen, (5, LORA_SHIFT, d), 0.01),
        # projections
        "wr": dense_init(gen, d, d),
        "wk": dense_init(gen, d, d),
        "wv": dense_init(gen, d, d),
        "wg": dense_init(gen, d, d),
        "wo": dense_init(gen, d, d),
        # data-dependent decay
        "w0": full((d,), -1.0),
        "wA": dense_init(gen, d, LORA_DECAY, scale=0.01),
        "wB": dense_init(gen, LORA_DECAY, d, scale=0.01),
        # bonus + output norm (per-head group norm)
        "u": _normal(gen, (H, dh), 0.1),
        "ln_x": {"scale": full((d,), 1.0), "bias": full((d,), 0.0)},
        # channel mix
        "mu_rc": full((d,), 0.5),
        "mu_kc": full((d,), 0.5),
        "wr_c": dense_init(gen, d, d),
        "wk_c": dense_init(gen, d, cfg.d_ff),
        "wv_c": dense_init(gen, cfg.d_ff, d),
    }


class GroupNormAffine(nn.Module):
    """`ln_x`: the per-head group norm's scale and bias, in float32."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = frozen(torch.ones(d, dtype=torch.float32, device=device))
        self.bias = frozen(torch.zeros(d, dtype=torch.float32, device=device))


class RWKV6(nn.Module):
    """Parameters of one RWKV-6 layer (time-mix + channel-mix), with the
    reference's leaf names."""

    _FLOAT32 = ("w0", "u")

    def __init__(self, cfg, device=None):
        super().__init__()
        d, dh, dff = cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff
        shapes = {
            "mu_x": (d,), "mu": (5, d), "tm_w1": (d, 5 * LORA_SHIFT),
            "tm_w2": (5, LORA_SHIFT, d), "wr": (d, d), "wk": (d, d),
            "wv": (d, d), "wg": (d, d), "wo": (d, d), "w0": (d,),
            "wA": (d, LORA_DECAY), "wB": (LORA_DECAY, d), "u": (d // dh, dh),
            "mu_rc": (d,), "mu_kc": (d,), "wr_c": (d, d), "wk_c": (d, dff),
            "wv_c": (dff, d)}
        for name, shape in shapes.items():
            dt = torch.float32 if name in self._FLOAT32 else cdtype(cfg)
            setattr(self, name, frozen(torch.zeros(shape, dtype=dt,
                                                   device=device)))
        self.ln_x = GroupNormAffine(d, device)

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        values = rwkv6_init(gen, cfg)
        load_(self.ln_x, values.pop("ln_x"))
        load_(self, values)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Shift sequence right by one; `prev` is the carry for decode."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p: RWKV6, x: torch.Tensor, xprev: torch.Tensor) -> torch.Tensor:
    """Data-dependent lerp producing the 5 mixed inputs (r,k,v,w,g)."""
    xx = xprev - x
    base = x + xx * p.mu_x
    lora = torch.tanh(base @ p.tm_w1)
    B, S, _ = x.shape
    lora = lora.reshape(B, S, 5, LORA_SHIFT)
    delta = torch.einsum("bsfl,fld->fbsd", lora, p.tm_w2)
    mixed = x[None] + xx[None] * (p.mu[:, None, None] + delta)
    return mixed  # (5, B, S, D)


def _group_norm(p: RWKV6, y: torch.Tensor, H: int) -> torch.Tensor:
    """Per-head group norm over the head channel (ln_x in RWKV); the
    population variance, as `jnp.var`."""
    B, S, D = y.shape
    dh = D // H
    yh = y.reshape(B, S, H, dh).float()
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + 1e-5)
    out = yh.reshape(B, S, D) * p.ln_x.scale + p.ln_x.bias
    return out.to(y.dtype)


def wkv_step(r, k, v, logw, u, state):
    """One decode step: r,k,v,logw (B,H,dh); state (B,H,dh,dh)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = kf[..., None] * vf[..., None, :]
    att = state + u.float()[None, :, :, None] * kv
    y = torch.einsum("bhd,bhde->bhe", rf, att)
    state = torch.exp(logw.float())[..., None] * state + kv
    return y.to(r.dtype), state


def time_mix(p: RWKV6, cfg, x, shift_prev, state, decode: bool = False):
    """x: (B, S, D). Returns (out, new_shift, new_state); the shift carry
    is the (normed) input's last row."""
    B, S, D = x.shape
    dh = cfg.rwkv_head_dim
    H = D // dh
    xprev = _token_shift(x, shift_prev)
    xr, xk, xv, xw, xg = _ddlerp(p, x, xprev)
    r = (xr @ p.wr).reshape(B, S, H, dh)
    k = (xk @ p.wk).reshape(B, S, H, dh)
    v = (xv @ p.wv).reshape(B, S, H, dh)
    g = xg @ p.wg
    g = silu(g)  # jax.nn.silu's roundings in bf16
    logw = -torch.exp(p.w0.float()
                      + (torch.tanh(xw @ p.wA) @ p.wB).float())
    logw = logw.clamp(-MAX_DECAY, -1e-4)  # see MAX_DECAY note
    logw = logw.reshape(B, S, H, dh)
    if decode:
        y, state = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p.u,
                            state)
        y = y[:, None]
    else:
        y, state = wops.wkv6(r, k, v, logw, p.u, state,
                             chunk=cfg.rwkv_chunk)
    y = _group_norm(p, y.reshape(B, S, D), H) * g
    return y @ p.wo, x[:, -1:], state


def channel_mix(p: RWKV6, x, shift_prev):
    xprev = _token_shift(x, shift_prev)
    xx = xprev - x
    xr = x + xx * p.mu_rc
    xk = x + xx * p.mu_kc
    rr = torch.sigmoid(xr @ p.wr_c)
    kk = torch.square(torch.relu(xk @ p.wk_c))
    return rr * (kk @ p.wv_c), x[:, -1:]


def rwkv6_state_spec(cfg, batch: int):
    """Decode state, (shape, dtype) leaves: the wkv state and two
    token-shift carries per layer (no sequence axis)."""
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    H = d // dh
    return {"wkv": ((batch, H, dh, dh), torch.float32),
            "shift_tm": ((batch, 1, d), cdtype(cfg)),
            "shift_cm": ((batch, 1, d), cdtype(cfg))}
