"""rwkv6-3b's float32 rounding with depth, in both packages, on the CPU.

    PYTHONPATH=src python tools/rwkv6_depth_parity.py [WIDTH ...]

At each width (default 128, 512 and 1,024; the reduced config at 128,
heads of 64 above it) and the full depth of 32 layers (w0 = -1, the
reference's init from PRNGKey(0) carried into the port), runs 2 prompts of
64 tokens through the reference in float32, the port in float32 and the
port in float64 (every float32 cast of the module taken to float64: the
oracle), and prints each float32 route's split from the oracle: max over
positions of max|a - b| / max|b| of a final hidden row, the worst
positions, and the split without position 0. Needs jax and the JAX
package (a development probe, not part of the port).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))


def splits(width: int) -> dict:
    import jax
    import jax.numpy as jnp
    from test_torch_models import _pair
    over = dict(n_layers=32)
    if width != 128:
        over.update(d_model=width, n_heads=width // 64, d_head=64,
                    rwkv_head_dim=64, d_ff=int(width * 3.5), rwkv_chunk=128)
    ref, params, port = _pair("rwkv6_3b", **over)
    toks = np.random.default_rng(4).integers(
        0, port.cfg.vocab_size, (2, 64)).astype(np.int32)
    with jax.enable_x64(False):
        h_ref = np.asarray(jax.jit(lambda p, t: ref.forward(p, t)[0])(
            params, jnp.asarray(toks)), np.float64)
    with torch.no_grad():
        h_port = port(torch.from_numpy(toks))[0].double().numpy()
        to_float = torch.Tensor.float
        torch.Tensor.float = lambda self, *a, **k: self.double()
        try:
            h64 = port.double()(torch.from_numpy(toks))[0].numpy()
        finally:
            torch.Tensor.float = to_float

    def rows(a):
        return (np.abs(a - h64).max(-1) / np.abs(h64).max(-1)).max(0)
    out = {}
    for name, h in (("reference f32", h_ref), ("port f32", h_port)):
        r = rows(h)
        worst = np.argsort(-r)[:3]
        out[name] = dict(split=float(r.max()), worst=worst.tolist(),
                         without_row0=float(r[1:].max()))
    return out


def main(argv: list[str]) -> int:
    for width in [int(a) for a in argv] or [128, 512, 1024]:
        print(f"width {width}, 32 layers:", splits(width), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
