"""Plain torch versions of the WKV6 recurrence:

  y_t = r_t^T (S_{t-1} + u ⊙ k_t v_t^T)
  S_t = diag(w_t) S_{t-1} + k_t v_t^T          (w_t = exp(logw_t))

`wkv6` is the naive per-step scan (port of `repro.kernels.rwkv6.ref`,
the oracle); `wkv_chunked` the chunked form of `repro.models.rwkv6`,
which the CUDA kernel computes and which the CPU route runs; `scaled_err`
the per-entry measure the kernel is held to. `models.rwkv6` takes `SUB`
and `wkv_chunked` from here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SUB = 16            # intra-chunk sub-block for the stable factorization


def wkv6(r, k, v, logw, u, state, *, dtype=None):
    """r,k,v,logw: (B, S, H, dh); u: (H, dh); state: (B, H, dh, dh).

    Returns (y (B,S,H,dh) in r's dtype, final state float32), all math in
    float32 as the reference's oracle; with `dtype` (say float64) the
    math is in `dtype` and both outputs keep it."""
    ct = dtype or torch.float32
    uf = u.to(ct)[None, :, :, None]
    S_c = state.to(ct)
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = (x[:, t].to(ct) for x in (r, k, v, logw))
        kv = k_t[..., :, None] * v_t[..., None, :]    # (B, H, dh, dh)
        ys.append(torch.einsum("bhd,bhde->bhe", r_t, S_c + uf * kv))
        S_c = torch.exp(w_t)[..., None] * S_c + kv
    y = torch.stack(ys, dim=1)
    return (y, S_c) if dtype else (y.to(r.dtype), S_c)


def chunk_rows(S: int, chunk: int) -> int:
    """The chunk `wkv_chunked` runs: min(chunk, max(S, SUB)) rounded down
    to a multiple of SUB."""
    C = min(chunk, max(S, SUB))
    return max((C // SUB) * SUB, SUB)


def wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """Chunked WKV6: r,k,v,logw (B,S,H,dh); u (H,dh); state (B,H,dh,dh).

    Returns (y (B,S,H,dh) in r's dtype, state' float32). logw = log of
    the per-step decay < 0 (clamped to [-MAX_DECAY, 0) by the caller).

    Intra-chunk coefficients exp(lw_ex[t] − lw[s]) are factored per
    sub-block pair (b, a) around a boundary inside/next to sub-block a,
    so every materialized exponent is bounded by SUB·MAX_DECAY (a plain
    cumulative exp over a 128-row chunk would reach e^640). The chunk is
    `chunk_rows(S, chunk)`; a ragged S is zero-padded (zero r/k/v with
    zero log-decay is an exact no-op for the outputs kept and the carried
    state)."""
    B, S, H, dh = r.shape
    C = chunk_rows(S, chunk)
    pad = (-S) % C
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    nc = (S + pad) // C
    nu = C // SUB
    uf = u.float()
    strict = torch.ones(SUB, SUB, dtype=torch.bool,
                        device=r.device).tril(diagonal=-1)   # t > s
    S_carry = state.float()
    ys = []
    for c in range(nc):
        rows = slice(c * C, (c + 1) * C)
        rcf, kcf, vcf, wc = (t[:, rows].float() for t in (r, k, v, logw))
        lw = torch.cumsum(wc, dim=1)                  # inclusive
        lw_ex = lw - wc                               # exclusive

        # inter-chunk: bounded (lw_ex <= 0)
        y = torch.einsum("bthd,bhde->bthe", rcf * torch.exp(lw_ex), S_carry)

        # intra-chunk: sub-block pairs with per-pair boundary
        diag = torch.einsum("bthd,bthd->bth", rcf * uf, kcf)
        y = y + diag[..., None] * vcf
        for b in range(nu):
            t0 = b * SUB
            rb = rcf[:, t0:t0 + SUB]
            lweb = lw_ex[:, t0:t0 + SUB]
            for a in range(b + 1):
                s0 = a * SUB
                ka = kcf[:, s0:s0 + SUB]
                va = vcf[:, s0:s0 + SUB]
                lwa = lw[:, s0:s0 + SUB]
                if a == b:
                    base = lw_ex[:, t0:t0 + 1]        # start-exclusive
                else:
                    base = lw[:, s0 + SUB - 1:s0 + SUB]  # end of block a
                left = rb * torch.exp(lweb - base)    # exponent <= 0
                right = ka * torch.exp(base - lwa)
                A = torch.einsum("bthd,bshd->bhts", left, right)
                if a == b:
                    A = torch.where(strict, A, 0.0)
                y[:, t0:t0 + SUB] += torch.einsum("bhts,bshd->bthd", A, va)

        # state update: bounded (lw_last - lw <= 0, lw_last <= 0)
        lw_last = lw[:, -1]                           # (B, H, dh)
        decay_rest = torch.exp(lw_last[:, None] - lw)  # (B, C, H, dh)
        S_carry = (torch.exp(lw_last)[..., None] * S_carry
                   + torch.einsum("bshd,bshe->bhde", kcf * decay_rest, vcf))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(r.dtype), S_carry


def scaled_err(got, want, r, k, v, logw, u, state, *, chunk: int = 128
               ) -> float:
    """max |got - want| per entry over its envelope, for `got` and `want`
    each a (y, state) pair. The envelope is the same recurrence run on
    |r|, |k|, |v|, |u| and |state| with the same logw: every y and state
    entry is a sum of terms whose sizes add up to its envelope entry, so
    a relative rounding ≤ ε of each term moves the entry by at most ε
    times its envelope, in every row, whatever its own size (a late
    row's y can be far smaller than max|y|, and an entry of a
    slowly-decaying state far larger)."""
    env_y, env_s = wkv_chunked(r.float().abs(), k.float().abs(),
                               v.float().abs(), logw.float(), u.float().abs(),
                               state.float().abs(), chunk)
    err = 0.0
    for g, w, env in zip(got, want, (env_y, env_s)):
        e = (g.float() - w.float()).abs() / env.clamp_min(1e-30)
        err = max(err, e.max().item())
    return err
