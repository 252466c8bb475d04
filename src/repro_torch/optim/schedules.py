"""Learning-rate schedules.

Port of `repro.optim.schedules`: the reference's float32 arithmetic, op
for op (Python numbers enter as float32, as jax's weakly typed scalars
do), so each step's rate is the reference's float32 value bit for bit on
the CPU (its op-by-op value; under `jax.jit` XLA fuses another cosine,
which can differ in the last bit). `step` may be a tensor on the card:
the rate is then computed there, with no read back to the host.
"""
from __future__ import annotations

import math

import torch

# jax's float32 cos on the CPU is glibc's `cosf` (ARM's optimized
# routine: the angle reduced by the nearest multiple of pi/2 in float64,
# then a float64 polynomial rounded once to float32); torch's float32 cos
# differs from it in the last bit at some steps, so the schedule computes
# glibc's routine. Its constants: 2/pi · 2^24, pi/2, and the cosine and
# sine polynomials of `__sincosf_table`.
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
      float.fromhex("0x1.55553e1068f19p-5"),
      float.fromhex("-0x1.6c087e89a359dp-10"),
      float.fromhex("0x1.99343027bf8c3p-16"))
_S = (float.fromhex("-0x1.555545995a603p-3"),
      float.fromhex("0x1.1107605230bc4p-7"),
      float.fromhex("-0x1.994eb3774cf24p-13"))


def cosf(a: torch.Tensor) -> torch.Tensor:
    """cos of a float32 tensor with |a| < 120, as glibc's `cosf` rounds
    it (float32 result)."""
    x = a.to(torch.float64)
    n = (torch.trunc(x * _HPI_INV).to(torch.int64) + 0x800000) >> 24
    r = x - n.to(torch.float64) * _HPI      # in [-pi/4, pi/4]
    r2 = r * r
    # even quadrant: ±cos(r), the sign from n & 2
    r4 = r2 * r2
    c = (_C[0] + r2 * _C[1]) + r4 * _C[2] + (r4 * r2) * (_C[3] + r2 * _C[4])
    c = torch.where(n & 2 == 0, c, -c)
    # odd quadrant: sin(±r), the sign of quadrant n & 3
    rs = torch.where((n & 3 == 1) | (n & 3 == 2), -r, r)
    r3 = rs * r2
    s = (rs + r3 * _S[0]) + (r3 * r2) * (_S[1] + r2 * _S[2])
    return torch.where(n & 1 == 0, c, s).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """A 0-d float32 tensor on `step`'s device (the CPU for a number):
    linear warmup to `peak_lr` over `warmup_steps`, then a cosine decay to
    `min_ratio · peak_lr` at `total_steps`."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + cosf(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
