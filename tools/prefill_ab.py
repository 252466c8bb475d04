"""Time qwen3-0.6b's prefill with this tree's flash kernel and another.

    git show <commit>:src/repro_torch/csrc/flash.cu > build/other/flash.cu
    python3 tools/prefill_ab.py build/other/flash.cu

Builds the other `flash.cu` (same C entry point) beside this tree's,
serves qwen3-0.6b at full width (seeded weights, bf16) and times
`model.prefill` of 8 prompts of 2,048 tokens (max_len 2,080, as
chip_smoke's lm_serve) with each kernel in turn (this, other, this,
other): three prefills each by CUDA events, with the host's enqueue and
total time, then one traced prefill (card busy time, flash's share, the
top kernels). The first prefill after a switch is warm: the warm-up runs
one before. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv: list[str]) -> int:
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other_src = Path(argv[0]).resolve()
    other_so = other_src.with_suffix(".so")
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(other_so),
                        str(other_src)], capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    this = fops._library()
    other = ctypes.CDLL(str(other_so))
    other.repro_flash_fwd.argtypes = this.repro_flash_fwd.argtypes
    other.repro_flash_fwd.restype = ctypes.c_int

    cfg = get_config("qwen3-0.6b")
    model = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(cs.SEED))
    prompts = np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, (8, 2048)).astype(np.int32)
    tokens = torch.from_numpy(prompts).cuda()
    generate(model, prompts[:, :64], max_new=2, max_len=66)
    model.prefill(tokens, max_len=2080)
    for name, lib in (("this", this), ("other", other), ("this", this),
                      ("other", other)):
        fops._lib = lib
        runs = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            model.prefill(tokens, max_len=2080)
            e1.record()
            enqueue = time.perf_counter() - t0
            torch.cuda.synchronize()
            runs.append(dict(event_ms=e0.elapsed_time(e1),
                             enqueue_ms=1e3 * enqueue,
                             host_ms=1e3 * (time.perf_counter() - t0)))
        _, wall, busy, by = cs.device_trace(
            lambda: model.prefill(tokens, max_len=2080))
        top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
        cs.emit(dict(kernel=name, prefills=runs, traced_wall_ms=1e3 * wall,
                     busy_ms=None if busy is None else 1e3 * busy,
                     flash_ms=1e3 * sum(v for k, v in by.items()
                                        if "flash" in k),
                     top_ms={k[:100]: 1e3 * v for k, v in top}))
    fops._lib = this
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
