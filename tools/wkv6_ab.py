"""Time this tree's WKV6 kernel beside variants and another version, in one call.

    mkdir -p build/other
    git show <commit>:src/repro_torch/csrc/wkv6.cu > build/other/wkv6.cu
    python3 tools/wkv6_ab.py [--other build/other/wkv6.cu]
        [--variant NAME:KEY=VALUE,...] ... [--cases NAME,...] [--iters N]

Each `--variant` is this tree's `src/repro_torch/csrc/wkv6.cu` with
constants substituted in its text (the source itself is not changed):

    ET=n                value columns of a state-pass CTA (16, 32, 64)
    OUT_MIN_BLOCKS=n    the output pass's CTAs resident on an SM (its
                        launch bounds' second argument)
    FIXED_C=n           the chunk compiled with its loops unrolled (0: none)

A variant with no substitutions is the source as it stands. `--other` is a
version with the single-kernel C interface of commit 6fc5f02 and earlier
(no workspace argument). Every source is compiled by nvcc with the port's
flags (one process each, all at once) into `build/variants/`, and each
kernel's spill bytes are printed from ptxas's report; this tree's source
and its variants run through `ops.wkv6_cuda` bound to their library, the
other version through a shim for its interface. Then, for
chip_smoke's WKV6_CASES (all, or those named by `--cases`), the versions
run in turn (A, B, ..., ..., B, A), each checked against the plain version
(chip_smoke's WKV6_TOL, bitwise repeatable) and timed: `ms` by CUDA events
over `--iters` calls, and the device time of each kernel by name from the
profiler over 10 calls. With `--prefill`, rwkv6-3b is then served at full
width (seeded weights, bf16, as chip_smoke's rwkv_serve) and
`model.prefill` of 8 prompts of 2,048 tokens is timed with each version's
kernel in turn: three warm prefills by CUDA events, then one traced
(card busy time, the WKV kernels' device time). One JSON line per
result. Needs a CUDA card and nvcc; imports neither jax nor the JAX
package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CONSTANTS = ("ET", "OUT_MIN_BLOCKS", "FIXED_C")
OUT = ROOT / "build" / "variants"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def variant_source(text: str, opts: dict) -> str:
    for key, value in opts.items():
        if key not in CONSTANTS:
            raise SystemExit(f"unknown constant {key} (known: {CONSTANTS})")
        text, n = re.subn(rf"^constexpr int {key} = [^;]+;",
                          f"constexpr int {key} = {value};", text,
                          flags=re.M)
        assert n == 1, key
    return text


def bind(so: Path):
    """`ops.wkv6_cuda` on the library `so` (this tree's C interface)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import ops
    real, ops._lib = build.library, None
    build.library = lambda name: ctypes.CDLL(str(so))
    try:
        lib = ops._library()
    finally:
        build.library = real

    def call(r, k, v, logw, u, state, chunk):
        ops._lib = lib
        return ops.wkv6_cuda(r, k, v, logw, u, state, chunk=chunk)
    return call


def bind_single(so: Path):
    """The single-kernel C interface of commit 6fc5f02 and earlier: no
    workspace argument, everything else as `ops.wkv6_cuda` passes it."""
    import torch
    from repro_torch.kernels.rwkv6 import ops
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_wkv6_fwd.argtypes = [i32] + [p] * 8 + [i32] * 5 + [i64] * 15 \
        + [p]
    lib.repro_wkv6_fwd.restype = ctypes.c_int

    def call(r, k, v, logw, u, state, chunk):
        ops._check(r, k, v, logw, u, state, chunk)
        B, S, H, dh = r.shape
        y = torch.empty_like(r)
        s_out = torch.empty((B, H, dh, dh), dtype=torch.float32,
                            device=r.device)
        rc = lib.repro_wkv6_fwd(
            ops._DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(),
            v.data_ptr(), logw.data_ptr(), u.data_ptr(), state.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), B, S, H, dh,
            ops.chunk_rows(S, chunk), *r.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *logw.stride()[:3], *y.stride()[:3],
            torch.cuda.current_stream(r.device).cuda_stream)
        if rc:
            raise RuntimeError(f"wkv6: CUDA launch failed with error {rc}")
        return y, s_out
    return call


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import ref
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--cases")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--prefill", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wkv6_ab: CUDA is not available", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "wkv6.cu").read_text()
    sources = {"this": (OUT / "wkv6_this.cu", True)}
    sources["this"][0].write_text(text)
    for spec in args.variant:
        name, _, kv = spec.partition(":")
        opts = dict(x.split("=") for x in kv.split(",") if x)
        cu = OUT / f"wkv6_{name}.cu"
        cu.write_text(variant_source(text, opts))
        sources[name] = (cu, True)
    if args.other:
        cu = OUT / "wkv6_other.cu"
        cu.write_text(args.other.read_text())
        sources["other"] = (cu, False)
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(
            lambda cu: build.compile_source(cu, cu.with_suffix(".so")),
            [cu for cu, _ in sources.values()])))
    fns = {}
    for name, (cu, current) in sources.items():
        spills = cs.wkv6_spills(logs[name]) if current else \
            cs.ptxas_spills(logs[name], r"(wkv6_kernel)I(\w+?)EE")
        emit(dict(version=name, spill_bytes=spills))
        fns[name] = (bind if current else bind_single)(cu.with_suffix(".so"))
    emit(dict(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()))
    names = list(fns)
    order = names + names[::-1]
    wanted = args.cases.split(",") if args.cases else None
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
    for case, B, S, H, dh, chunk, dtype, decay, s0 in cs.WKV6_CASES:
        inputs = cs._wkv6_inputs(gen, B, S, H, dh, dtype, decay, s0)
        if wanted and case not in wanted:
            continue
        f32 = [a.float() for a in inputs]
        want = ref.wkv_chunked(*f32, chunk)
        rows: dict[str, list] = {}
        for name in order:
            fn = fns[name]
            got = fn(*inputs, chunk)
            again = fn(*inputs, chunk)
            err = ref.scaled_err(got, want, *f32, chunk=chunk)
            ok = err <= cs.WKV6_TOL[dtype] and all(
                torch.equal(a, b) for a, b in zip(got, again))
            del got, again
            run = (lambda fn=fn: fn(*inputs, chunk))
            ms = cs.cuda_ms(run, iters=args.iters)
            _, _, busy, by_name = cs.device_trace(
                lambda: [run() for _ in range(10)])
            kernels = {}
            for kname, sec in by_name.items():
                m = re.search(r"wkv6_(\w+?)_kernel|wkv6_kernel", kname)
                if m:
                    key = m.group(1) or "single"
                    kernels[key] = kernels.get(key, 0.0) + 100 * sec
            rows.setdefault(name, []).append(dict(
                ok=ok, scaled_err=err, ms=ms,
                device_ms=None if busy is None else 100 * busy,
                kernel_ms=kernels))
        emit(dict(case=case, B=B, S=S, H=H, dh=dh, dtype=dtype, **rows))
        del inputs, f32, want
        torch.cuda.empty_cache()
    if args.prefill:
        prefills(fns, order)
    return 0


def prefills(fns: dict, order: list) -> None:
    """rwkv6-3b's prefill (8 x 2,048 tokens, bf16) with each version's WKV
    kernel in turn."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.models import build_model
    cfg = get_config("rwkv6-3b")
    model = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(cs.SEED))
    tokens = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, (8, 2048)).astype(np.int32)).cuda()
    dispatch = ops.wkv6
    try:
        for name in order:
            fn = fns[name]
            ops.wkv6 = lambda r, k, v, logw, u, state, *, chunk, fn=fn: \
                fn(r, k, v, logw, u, state, chunk)
            model.prefill(tokens, max_len=2080)    # warm, at this kernel
            runs = []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                model.prefill(tokens, max_len=2080)
                e1.record()
                torch.cuda.synchronize()
                runs.append(e0.elapsed_time(e1))
            _, wall, busy, by = cs.device_trace(
                lambda: model.prefill(tokens, max_len=2080))
            emit(dict(prefill=name, event_ms=runs, traced_wall_ms=1e3 * wall,
                      busy_ms=None if busy is None else 1e3 * busy,
                      wkv6_ms=1e3 * sum(v for k, v in by.items()
                                        if "wkv6_" in k)))
    finally:
        ops.wkv6 = dispatch


if __name__ == "__main__":
    sys.exit(main())
