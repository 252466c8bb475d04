"""Where the port's bf16 jamba parts from the reference on the CPU.

    PYTHONPATH=src python tools/scan_parity.py

Compares, bit for bit, the reference's jitted `selective_scan` with the
port's plain `ssm_scan` and with a torch emulation of how XLA's CPU
backend lowers the reference's scan (exp as a Cephes polynomial with FMA
and denormals flushed to zero; h = fma(dA, h, (dt x) B); y's sum over the
state as eight FMA lanes summed pairwise; y = fma(x, D, y)), at the
reduced jamba's scan shapes and a longer one; then the softplus of dt
(torch's and jax's form against XLA's); then the bf16 jamba parity
test's logits error (prefill and four decode steps, routing replayed) at
one and two periods with the port's prefill scan plain and emulated.
Needs jax and the JAX package (a development probe, not part of the
port).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

TINY = torch.finfo(torch.float32).tiny


def xla_exp(x):
    """XLA's CPU exp in float32: a Cephes polynomial, FMAs, FTZ."""
    x = x.clamp(-88.3762626647949, 88.3762626647950)
    one = torch.ones_like(x)
    fx = torch.floor(torch.addcmul(one * 0.5, x, one * 1.44269504088896341))
    r = torch.addcmul(x, fx, one * -0.693359375)
    r = torch.addcmul(r, fx, one * 2.12194440e-4)
    z = r * r
    y = torch.full_like(x, 1.9875691500e-4)
    for c in (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
              1.6666665459e-1, 5.0000001201e-1):
        y = torch.addcmul(one * c, y, r)
    out = (torch.addcmul(r, y, z) + 1) * torch.ldexp(one, fx)
    return torch.where(out < TINY, torch.zeros_like(out), out)


def dot8(h, c):
    """Σ_s h[..., s] c[..., s]: lane s % 8 accumulates with FMA, the lanes
    summed pairwise."""
    lanes = []
    for a in range(min(8, h.shape[-1])):
        acc = torch.zeros_like(h[..., 0])
        for s in range(a, h.shape[-1], 8):
            acc = torch.addcmul(acc, h[..., s], c[..., s])
        lanes.append(acc)
    while len(lanes) > 1:
        lanes = [lanes[i] + lanes[i + 1] for i in range(0, len(lanes), 2)]
    return lanes[0]


def emulated_scan(x, dt, A, B, C, D_skip, h0, **_):
    x, dt, A, B, C, D, h = (t.float() for t in (x, dt, A, B, C, D_skip, h0))
    xs, ys = x * dt, []
    for t in range(x.shape[1]):
        dA = xla_exp(dt[:, t, :, None] * A[None])
        h = torch.addcmul(xs[:, t, :, None] * B[:, t, None, :], dA, h)
        ys.append(dot8(h, C[:, t, None, :].expand_as(h)))
    return torch.addcmul(torch.stack(ys, 1), x, D[None, None].expand_as(x)), h


def scan_bits():
    import jax
    import jax.numpy as jnp
    from repro.models.mamba import selective_scan
    from repro_torch.kernels.ssd.ref import ssm_scan
    rng = np.random.default_rng(0)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    for B, S, di, ds in ((2, 32, 256, 8), (2, 32, 256, 16), (1, 256, 256, 8)):
        x = bf(rng.normal(size=(B, S, di)))
        dt = np.log1p(np.exp(rng.normal(size=(B, S, di)) - 2)).astype(np.float32)
        A = -np.exp(rng.normal(size=(di, ds))).astype(np.float32)
        Bv, Cv = bf(rng.normal(size=(B, S, ds))), bf(rng.normal(size=(B, S, ds)))
        D = rng.normal(size=(di,)).astype(np.float32)
        h0 = (0.1 * rng.normal(size=(B, di, ds))).astype(np.float32)
        args = (x, dt, A, Bv, Cv, D, h0)
        yr, hr = (np.asarray(v) for v in jax.jit(selective_scan)(
            *(jnp.asarray(a) for a in args)))
        for name, fn in (("port", ssm_scan), ("emulated", emulated_scan)):
            y, h = fn(*(torch.from_numpy(a.copy()) for a in args))
            print(f"scan B {B} S {S} di {di} ds {ds}, {name}: y bitwise "
                  f"{(y.numpy() == yr).mean():.4f}, h bitwise "
                  f"{(h.numpy() == hr).mean():.4f}", flush=True)


def softplus_bits():
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F
    x = np.random.default_rng(0).normal(size=200_000).astype(np.float32) * 3
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    t = torch.from_numpy(x)
    jax_form = t.clamp_min(0) + torch.log1p(torch.exp(-t.abs()))
    print(f"softplus bitwise with XLA's: F.softplus "
          f"{(F.softplus(t).numpy() == want).mean():.4f}, jax's form in "
          f"torch {(jax_form.numpy() == want).mean():.4f}, torch.exp vs "
          f"XLA exp {(torch.exp(t).numpy() == np.asarray(jnp.exp(x))).mean():.4f}",
          flush=True)


class _Patch:
    def __init__(self):
        self.undo = []

    def setattr(self, obj, name, value):
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore(self):
        for obj, name, value in reversed(self.undo):
            setattr(obj, name, value)


def jamba_errors(n_layers: int, emulate: bool):
    import jax.numpy as jnp
    import test_torch_models as tm
    from repro_torch.kernels.ssd import ops as sops
    patch = _Patch()
    if emulate:
        patch.setattr(sops, "ssm_scan", emulated_scan)
    try:
        routing = tm._ReferenceRouting(patch)
        ref, params, port = tm._pair("jamba_v0_1_52b", dtype="bfloat16",
                                     n_layers=n_layers)
        ref, params = routing.unscanned(ref, params)
        toks = tm._tokens(4, port.cfg, 2, 40)
        want, wc = ref.prefill(params, jnp.asarray(toks[:, :32]), max_len=40)
        got, gc = port.prefill(torch.from_numpy(toks[:, :32]), max_len=40)
        errs = [np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()]
        for t in range(32, 36):
            nxt = toks[:, t:t + 1]
            want, wc = ref.decode_step(params, jnp.asarray(nxt), wc,
                                       jnp.int32(t))
            got, gc = port.decode_step(torch.from_numpy(nxt), gc, t)
            errs.append(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32)).max())
    finally:
        patch.restore()
    return [float(e) for e in errs], routing.flips, routing.tokens


def main() -> int:
    scan_bits()
    softplus_bits()
    for n_layers in (8, 16):
        for emulate in (False, True):
            errs, flips, tokens = jamba_errors(n_layers, emulate)
            print(f"jamba bf16, {n_layers} layers, prefill scan "
                  f"{'emulated' if emulate else 'port'}: max |logit diff| "
                  f"prefill and 4 decode steps {errs}, routing flips "
                  f"{flips}/{tokens}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
