"""Plain torch versions of the Mamba selective scan:

  h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t x_t) B_t^T    (per channel, outer)
  y_t = h_t C_t + D x_t

`ssm_scan` is the per-step scan (port of `repro.kernels.ssd.ref`, the
oracle), which the CUDA kernel computes and which the CPU route runs;
`selective_scan` the model's chunked route (`repro.models.mamba`), which
decode runs at S = 1; `scaled_err` the per-entry measure the kernel is
held to; `kernel_decay` the CUDA kernel's form of the exp
(`csrc/ssd.cu`), for a scan with the kernel's decay.
"""
from __future__ import annotations

import torch

# csrc/ssd.cu's exp: 2^z = 2^(z + 1) / 2, z + 1 = dt · A' + 1 in one fma,
# A' = float32(A · log2 e)
LOG2E = 1.4426950408889634


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def kernel_decay(dt_t: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's dA = 2^(dt · A') for `ssm_scan(decay=...)`, (Bt,
    di) dt and (di, ds) A in float32: w = dt · A' + 1 rounded once to
    float32 (here the exact product rounded to float64, then to float32:
    the last bit may differ, rarely), 2^w rounded to float32, 0 where it
    is below 2^-126 (`ex2.approx.ftz` flushes it), then halved (exactly 0
    for z < -127). Only the arithmetic around the MUFU is modelled: its
    2^w is taken exact, although the MUFU's own errs by up to 2 ulp, so
    this is not the kernel's result bit for bit. What the MUFU adds is
    measured on the card (chip_smoke's tiny-dt rows)."""
    a2 = _f32(A.double() * LOG2E)
    w = _f32(dt_t.double()[..., None] * a2.double() + 1.0)
    e = _f32(torch.exp2(w.double()))
    e = torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)
    return 0.5 * e


def ssm_scan(x, dt, A, B, C, D_skip, h0, *, dtype=None, decay=None):
    """x, dt: (Bt, S, di); A: (di, ds); B, C: (Bt, S, ds); D_skip: (di,);
    h0: (Bt, di, ds). Returns (y (Bt, S, di), h_final (Bt, di, ds)), all
    math in float32 as the reference's oracle; with `dtype` (say float64)
    the math is in `dtype` and both outputs keep it. `decay(dt_t, A)`, if
    given, makes each step's dA ((Bt, di) dt, (di, ds) A) in place of
    exp(dt · A) (say `kernel_decay`)."""
    ct = dtype or torch.float32
    xs = x.to(ct) * dt.to(ct)
    At = A.to(ct)
    h = h0.to(ct)
    ys = []
    for t in range(x.shape[1]):
        if decay is None:
            dA = torch.exp(dt[:, t].to(ct)[..., None] * At[None])
        else:
            dA = decay(dt[:, t], A).to(ct)
        h = dA * h + xs[:, t, :, None] * B[:, t].to(ct)[:, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, C[:, t].to(ct)))
    y = torch.stack(ys, dim=1)
    return y + x.to(ct) * D_skip.to(ct)[None, None], h


def selective_scan(xin, dt, A, Bv, Cv, D_skip, h0, chunk: int = 256):
    """The model's chunked route: xin, dt (B, S, di); A (di, ds); Bv, Cv
    (B, S, ds); h0 (B, di, ds). Returns (y (B, S, di) float32, h float32).

    The reference scans chunks of `chunk` steps (a `jax.checkpoint` per
    chunk, for training's memory) and asserts S % chunk == 0; the chunks
    change no arithmetic, so here any S runs, as the per-step scan."""
    return ssm_scan(xin, dt, A, Bv, Cv, D_skip, h0)


def scaled_err(got, want, x, dt, A, B, C, D_skip, h0) -> float:
    """max |got - want| per entry over its envelope, for `got` and `want`
    each a (y, h) pair. The envelope is the same scan run on |x|, |B|,
    |C|, |D| and |h0| with the same dt and A: every y and h entry is a sum
    of terms whose sizes add up to its envelope entry, so a relative
    rounding ≤ ε of each term moves the entry by at most ε times its
    envelope (times the steps a rounding survives in the state), whatever
    the entry's own size."""
    env_y, env_h = ssm_scan(x.float().abs(), dt, A, B.float().abs(),
                            C.float().abs(), D_skip.float().abs(),
                            h0.float().abs())
    err = 0.0
    for g, w, env in zip(got, want, (env_y, env_h)):
        e = (g.float() - w.float()).abs() / env.clamp_min(1e-30)
        err = max(err, e.max().item())
    return err
