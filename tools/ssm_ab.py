"""Time this tree's selective-scan kernel beside variants and another version, in one call.

    mkdir -p build/other
    git show <commit>:src/repro_torch/csrc/ssd.cu > build/other/ssd.cu
    python3 tools/ssm_ab.py [--other build/other/ssd.cu]
        [--variant NAME:KEY=VALUE,...] ... [--source NAME=PATH] ...
        [--cases NAME,...] [--iters N] [--prefill]

Each `--variant` is this tree's `src/repro_torch/csrc/ssd.cu` with
constants substituted in its text (the source itself is not changed):

    STAGES=n        depth of the cp.async ring
    TC=n            steps a chunk of the ring
    MIN_BLOCKS=n    resident blocks an SM (the launch bounds' second
                    argument: caps the registers)
    T_UNROLL=n      steps of the step loop unrolled

A variant with no substitutions is the source as it stands. Each
`--source` is another `ssd.cu` with this tree's C interface (an edited
copy: say another form of the exp). `--other` is a
version with the C interface of commit cb76bdd and earlier (no alignment
argument). Every source is compiled by nvcc with the port's flags (one
process each, all at once) into `build/variants/`, and each kernel's
registers and spill bytes are printed from ptxas's report. Then, for
chip_smoke's SSM_CASES (all, or those named by `--cases`), the versions
run in turn (A, B, ..., ..., B, A), each checked against the plain version
(chip_smoke's SSM_TOL over the envelope, bitwise repeatable) and timed:
`ms` by CUDA events over `--iters` calls, and the device time from the
profiler over 10 calls. With `--prefill`, jamba-v0.1-52b cut to one period
is then served at full width (seeded weights, bf16, as chip_smoke's
hybrid_serve) and `model.prefill` of 8 prompts of 2,048 tokens is timed
with each version's scan in turn: three warm prefills by CUDA events, then
one traced (card busy time, the scans' device time). One JSON line per
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

CONSTANTS = ("STAGES", "TC", "MIN_BLOCKS", "T_UNROLL")
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
        if n != 1:
            raise SystemExit(f"constant {key} not found in ssd.cu")
    return text


def registers(log: str) -> dict:
    """Registers of each scan kernel, by template arguments."""
    regs, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*ssm_scan_kernelI(\w+?)EE",
                      ln)
        if m:
            key = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and key is not None:
            regs[key] = int(m.group(1))
            key = None
    return regs


def bind(so: Path):
    """`ops.ssm_scan_cuda` on the library `so` (this tree's C interface)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops
    real, ops._lib = build.library, None
    build.library = lambda name: ctypes.CDLL(str(so))
    try:
        lib = ops._library()
    finally:
        build.library = real
        ops._lib = None

    def call(*args):
        ops._lib = lib
        try:
            return ops.ssm_scan_cuda(*args)
        finally:
            ops._lib = None
    return call


def bind_old(so: Path):
    """The C interface of commit cb76bdd and earlier: no alignment
    argument, everything else as `ops.ssm_scan_cuda` passes it."""
    import torch
    from repro_torch.kernels.ssd import ops
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_ssm_scan_fwd.argtypes = (
        [i32] + [p] * 9 + [i32] * 4 + [i64] * 10 + [p])
    lib.repro_ssm_scan_fwd.restype = ctypes.c_int

    def call(x, dt, A, B, C, D_skip, h0):
        ops._check(x, dt, A, B, C, D_skip, h0)
        Bt, S, di = x.shape
        ds = A.shape[1]
        y = torch.empty((Bt, S, di), dtype=torch.float32, device=x.device)
        h_out = torch.empty((Bt, di, ds), dtype=torch.float32,
                            device=x.device)
        rc = lib.repro_ssm_scan_fwd(
            ops._DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(), D_skip.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), Bt, S, di, ds,
            *x.stride()[:2], *dt.stride()[:2], *B.stride()[:2],
            *C.stride()[:2], *y.stride()[:2],
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"ssm_scan: CUDA launch failed with error "
                               f"{rc}")
        return y, h_out
    return call


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ref
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--cases")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--prefill", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssm_ab: CUDA is not available", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "ssd.cu").read_text()
    sources = {"this": (OUT / "ssd_this.cu", True)}
    sources["this"][0].write_text(text)
    for spec in args.variant:
        name, _, kv = spec.partition(":")
        opts = dict(x.split("=") for x in kv.split(",") if x)
        cu = OUT / f"ssd_{name}.cu"
        cu.write_text(variant_source(text, opts))
        sources[name] = (cu, True)
    for spec in args.source:
        name, _, path = spec.partition("=")
        cu = OUT / f"ssd_{name}.cu"
        cu.write_text(Path(path).read_text())
        sources[name] = (cu, True)
    if args.other:
        cu = OUT / "ssd_other.cu"
        cu.write_text(args.other.read_text())
        sources["other"] = (cu, False)
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(
            lambda cu: build.compile_source(cu, cu.with_suffix(".so")),
            [cu for cu, _ in sources.values()])))
    fns = {}
    for name, (cu, current) in sources.items():
        emit(dict(version=name, spill_bytes=cs.ssd_spills(logs[name]),
                  registers=registers(logs[name])))
        fns[name] = (bind if current else bind_old)(cu.with_suffix(".so"))
    emit(dict(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()))
    names = list(fns)
    order = names + names[::-1]
    wanted = args.cases.split(",") if args.cases else None
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
    for case, B, S, di, ds, dtype, dt_kind, h0_scale in cs.SSM_CASES:
        inputs = cs._ssm_inputs(gen, B, S, di, ds, dtype, dt_kind, h0_scale)
        if wanted and case not in wanted:
            continue
        want = ref.ssm_scan(*inputs)
        rows: dict[str, list] = {}
        for name in order:
            fn = fns[name]
            got = fn(*inputs)
            again = fn(*inputs)
            err = ref.scaled_err(got, want, *inputs)
            ok = err <= cs.SSM_TOL and all(
                torch.equal(a, b) for a, b in zip(got, again)) and all(
                bool(torch.isfinite(t).all()) for t in got)
            del got, again
            run = (lambda fn=fn: fn(*inputs))
            ms = cs.cuda_ms(run, iters=args.iters)
            _, _, busy, _ = cs.device_trace(lambda: [run() for _ in range(10)])
            rows.setdefault(name, []).append(dict(
                ok=ok, scaled_err=err, ms=ms,
                device_ms=None if busy is None else 100 * busy))
        emit(dict(case=case, B=B, S=S, di=di, ds=ds, dtype=dtype, dt=dt_kind,
                  bound_ms=cs.ssm_bound(B, S, di, ds, dtype,
                                        cs.PEAKS["H100"])[0], **rows))
        del inputs, want
        torch.cuda.empty_cache()
    if args.prefill:
        prefills(fns, order)
    return 0


def prefills(fns: dict, order: list) -> None:
    """jamba-v0.1-52b's prefill at one period (8 x 2,048 tokens, bf16)
    with each version's scan in turn."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops
    from repro_torch.models import build_model
    cfg = get_config("jamba-v0.1-52b").with_(n_layers=8)
    model = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(cs.SEED))
    tokens = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, (8, 2048)).astype(np.int32)).cuda()
    dispatch = ops.ssm_scan
    try:
        for name in order:
            ops.ssm_scan = fns[name]
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
                      scan_ms=1e3 * sum(v for k, v in by.items()
                                        if "ssm_scan_kernel" in k)))
    finally:
        ops.ssm_scan = dispatch


if __name__ == "__main__":
    sys.exit(main())
