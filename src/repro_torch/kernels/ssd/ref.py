"""Plain torch versions of the Mamba selective scan:

  h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t x_t) B_t^T    (per channel, outer)
  y_t = h_t C_t + D x_t

`ssm_scan` is the per-step scan (port of `repro.kernels.ssd.ref`, the
oracle), which the CUDA kernel computes and which the CPU route runs;
`selective_scan` the model's chunked route (`repro.models.mamba`), which
decode runs at S = 1; `scaled_err` the per-entry measure the kernel is
held to.
"""
from __future__ import annotations

import torch


def ssm_scan(x, dt, A, B, C, D_skip, h0, *, dtype=None):
    """x, dt: (Bt, S, di); A: (di, ds); B, C: (Bt, S, ds); D_skip: (di,);
    h0: (Bt, di, ds). Returns (y (Bt, S, di), h_final (Bt, di, ds)), all
    math in float32 as the reference's oracle; with `dtype` (say float64)
    the math is in `dtype` and both outputs keep it."""
    ct = dtype or torch.float32
    xs = x.to(ct) * dt.to(ct)
    At = A.to(ct)
    h = h0.to(ct)
    ys = []
    for t in range(x.shape[1]):
        dA = torch.exp(dt[:, t].to(ct)[..., None] * At[None])
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
