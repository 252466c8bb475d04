"""Mamba-1 block (selective SSM) for the Jamba hybrid (arXiv:2403.19887).

Port of `repro.models.mamba`, names kept. Prefill's selective scan goes
through `kernels.ssd.ops.ssm_scan`: on CUDA the hand-written kernel of
`csrc/ssd.cu` (the state in registers, the time loop inside the kernel,
channels across the grid), on the CPU the plain `ref.ssm_scan`. Decode
runs the plain `selective_scan` at S = 1, as the reference does, and the
causal conv carries its last ck - 1 inputs.

The module holds each weight the reference casts with `.astype(dt)` in
the compute dtype; `dt_bias`, `A_log` and `D_skip`, which the reference
uses in float32, stay float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssd import ops as sops
from ..kernels.ssd.ref import selective_scan
from .layers import _normal, cdtype, dense_init, frozen, load_, silu


def dt_rank(cfg) -> int:
    return max(1, cfg.d_model // 16)


def mamba_init(gen: torch.Generator, cfg) -> dict:
    """Float32 values with the reference's distributions and scales (the
    numbers cannot equal jax.random's)."""
    d, di, ds, ck = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.conv_kernel
    r = dt_rank(cfg)
    dev = gen.device
    # S4D-real initialization for A
    A = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=dev)[None].repeat(di, 1)
    u = torch.rand((di,), generator=gen, dtype=torch.float32, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": dense_init(gen, d, 2 * di),
        "conv_w": _normal(gen, (di, 1, ck), 1.0 / math.sqrt(ck)),
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=dev),
        "x_proj": dense_init(gen, di, r + 2 * ds),
        "dt_proj": dense_init(gen, r, di, scale=r ** -0.5),
        "dt_bias": torch.log(torch.exp(dt) - 1.0 + 1e-9),
        "A_log": torch.log(A),
        "D_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d),
    }


class Mamba(nn.Module):
    """Parameters of one Mamba mixer, with the reference's leaf names."""

    _FLOAT32 = ("dt_bias", "A_log", "D_skip")

    def __init__(self, cfg, device=None):
        super().__init__()
        d, di, ds, ck = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.conv_kernel
        r = dt_rank(cfg)
        shapes = {
            "in_proj": (d, 2 * di), "conv_w": (di, 1, ck), "conv_b": (di,),
            "x_proj": (di, r + 2 * ds), "dt_proj": (r, di),
            "dt_bias": (di,), "A_log": (di, ds), "D_skip": (di,),
            "out_proj": (di, d)}
        for name, shape in shapes.items():
            dt = torch.float32 if name in self._FLOAT32 else cdtype(cfg)
            setattr(self, name, frozen(torch.zeros(shape, dtype=dt,
                                                   device=device)))

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        load_(self, mamba_init(gen, cfg))


def _causal_conv(p: Mamba, xin: torch.Tensor,
                 conv_state: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv1d; xin (B, S, di). The reference's
    shift-multiply Σ_j w_j ⊙ shift(x, j) in the compute dtype, taps in its
    order (not `F.conv1d`, whose float32 runs in TF32 under cuDNN)."""
    ck = p.conv_w.shape[-1]
    w = p.conv_w[:, 0, :].to(xin.dtype)               # (di, ck)
    if conv_state is not None:                        # decode: prepend
        x_full = torch.cat([conv_state.transpose(1, 2), xin], dim=1)
    else:
        x_full = F.pad(xin, (0, 0, ck - 1, 0))
    S_out = x_full.shape[1] - (ck - 1)
    out = 0.0
    for j in range(ck):
        # tap j multiplies inputs delayed by (ck - 1 - j)
        out = out + x_full[:, j:j + S_out] * w[None, None, :, j]
    return out + p.conv_b.to(out.dtype)[None, None, :]


def mamba_forward(p: Mamba, cfg, x: torch.Tensor,
                  state: Optional[dict] = None, decode: bool = False):
    """x: (B, S, D). state: {'h': (B, di, ds), 'conv': (B, di, ck-1)} for
    decode. Returns (out, new_state)."""
    B, S, D = x.shape
    di, ds = cfg.d_inner, cfg.d_state
    ck = cfg.conv_kernel
    r = dt_rank(cfg)

    xz = x @ p.in_proj
    xin, z = torch.split(xz, di, dim=-1)

    conv_state = state["conv"] if decode else None
    conv_out = _causal_conv(p, xin, conv_state)
    if decode:
        new_conv = torch.cat([conv_state[:, :, 1:], xin.transpose(1, 2)],
                             dim=2)
        conv_out = conv_out[:, -1:]                   # last position only
    else:
        new_conv = xin.transpose(1, 2)[:, :, -(ck - 1):]
    xin_c = silu(conv_out)

    dbc = xin_c @ p.x_proj
    dt_raw, Bv, Cv = torch.split(dbc, [r, ds, ds], dim=-1)
    dt = F.softplus((dt_raw @ p.dt_proj).float() + p.dt_bias[None, None])
    A = -torch.exp(p.A_log)

    if decode:
        y, h = selective_scan(xin_c, dt, A, Bv, Cv, p.D_skip, state["h"])
    else:
        h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
        y, h = sops.ssm_scan(xin_c, dt, A, Bv, Cv, p.D_skip, h0)
    out = (y.to(x.dtype) * silu(z)) @ p.out_proj
    return out, {"h": h, "conv": new_conv}


def mamba_state_spec(cfg, batch: int):
    """Decode state, (shape, dtype) leaves: the float32 scan state and the
    conv's last ck - 1 inputs per layer (no sequence axis)."""
    di, ds, ck = cfg.d_inner, cfg.d_state, cfg.conv_kernel
    return {"h": ((batch, di, ds), torch.float32),
            "conv": ((batch, di, ck - 1), cdtype(cfg))}
