"""Build variants of the bfloat16 flash kernel and compare them on the card.

    python3 tools/flash_variants.py NAME[:KEY=VALUE,...] ...

Each argument names a variant of `src/repro_torch/csrc/flash.cu` made by
substituting constants in its text (the source itself is not changed):

    BN=n          kv rows per tile (at every head dim)
    STAGES=n      depth of the K/V ring
    NWG=n         consumer warpgroups (64 q rows each)
    EXPF=1        expf of the unscaled-by-log2(e) scores in place of exp2f
    SETMAXNREG=p/c  a producer warpgroup that gives its registers down to p
                  (setmaxnreg.dec) and consumers that ask for c (.inc)
    MAXNREG=n     __maxnreg__(n) in place of the launch bounds

A variant with no substitutions is the source as it stands. Every variant
is compiled by nvcc with the port's flags (one process per variant, all at
once) into `build/variants/`; the script prints each bfloat16
instantiation's registers and spills from the ptxas report, checks it at
small shapes (ragged, non-causal, GQA; per-entry error over the envelope
within chip_smoke's FLASH_TOL, bitwise repeatable), then times the five
bfloat16 cases of chip_smoke's FLASH_CASES with the variants in turn
(A, B, ..., ..., B, A), each with its error at that shape. Needs a CUDA
card and nvcc; imports neither jax nor the JAX package.
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CHECK = [(2, 512, 512, 16, 8, 128, True), (2, 512, 512, 32, 8, 64, True),
         (3, 200, 200, 4, 2, 32, True), (2, 129, 129, 4, 2, 128, True),
         (2, 300, 1024, 16, 8, 128, False), (2, 64, 100, 4, 2, 64, False)]


def variant_source(text: str, opts: dict) -> str:
    for key in ("BN", "STAGES", "NWG"):
        if key in opts:
            text, n = re.subn(rf"constexpr int {key} = [^;]+;",
                              f"constexpr int {key} = {opts[key]};", text)
            assert n == 1, key
    if opts.get("EXPF") == "1":
        text = text.replace("p.scale * 1.4426950408889634f", "p.scale")
        text = text.replace("exp2f(", "expf(")
    if "MAXNREG" in opts:
        text, n = re.subn(r"__launch_bounds__\(THREADS, 1\)",
                          f"__maxnreg__({opts['MAXNREG']})",
                          text)
        assert n == 1, "MAXNREG"
    if "SETMAXNREG" in opts:
        prod, cons = opts["SETMAXNREG"].split("/")
        text = text.replace("constexpr int THREADS = CONSUMERS + 32;",
                            "constexpr int THREADS = CONSUMERS + 128;")
        for anchor, op, regs in (
                ("    // ---- producer: one thread issues every load\n",
                 "dec", prod),
                ("    // ---- consumers: warpgroup wg owns q rows", "inc", cons)):
            i = text.index(anchor)
            i = text.index("\n", i) + 1
            text = (text[:i] + f'    asm volatile("setmaxnreg.{op}.sync.aligned'
                    f'.u32 {regs};\\n");\n' + text[i:])
    return text


def build_variant(spec, out: Path):
    from repro_torch.kernels import build
    name, opts = spec
    cu = out / f"flash_{name}.cu"
    cu.write_text(variant_source((build.CSRC / "flash.cu").read_text(), opts))
    so = cu.with_suffix(".so")
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    return name, so, r.returncode, r.stdout + r.stderr


def caller(lib):
    import torch
    f = lib.repro_flash_fwd
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    f.argtypes = ([i32, p, p, p, p, i32, i32, i32, i32, i32, i32] + [i64] * 12
                  + [i32, ctypes.c_float, p])
    f.restype = ctypes.c_int

    def run(q, k, v, causal):
        o = torch.empty_like(q)
        B, Sq, Hq, hd = q.shape
        rc = f(2, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
               Sq, k.shape[1], Hq, k.shape[2], hd, *q.stride()[:3],
               *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], int(causal),
               float(1 / math.sqrt(hd)),
               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash variant: CUDA error {rc}")
        return o
    return run


def main(argv: list[str]) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ref
    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available", file=sys.stderr)
        return 2
    specs = []
    for a in argv or ["source"]:
        name, _, kv = a.partition(":")
        specs.append((name, dict(x.split("=") for x in kv.split(",") if x)))
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda s: build_variant(s, out), specs))

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def qkv(B, Sq, Sk, Hq, Hkv, hd):
        return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd))]

    tol = cs.FLASH_TOL["bfloat16"]
    runs = {}
    for name, so, rc, log in built:
        lines = log.splitlines()
        print(f"== {name}: nvcc rc {rc}", flush=True)
        for i, ln in enumerate(lines):
            if "flash_bf16" in ln and "Compiling entry" in ln:
                hd = re.search(r"kernelILi(\d+)E", ln).group(1)
                info = " | ".join(x.strip() for x in lines[i + 1:i + 4]
                                  if "spill" in x or "Used" in x)
                print(f"  hd {hd}: {info}", flush=True)
            if "C7512" in ln or "arning" in ln:
                print("  " + ln.strip()[:200], flush=True)
        if rc:
            print(log[-2000:], flush=True)
            continue
        run = caller(ctypes.CDLL(str(so)))
        ok = True
        try:
            for *shape, causal in CHECK:
                q, k, v = qkv(*shape)
                got = run(q, k, v, causal)
                want = ref.attention(q.float(), k.float(), v.float(),
                                     causal=causal)
                ok &= (ref.scaled_err(got, want, q, k, v, causal=causal)
                       <= tol and torch.equal(got, run(q, k, v, causal)))
        except RuntimeError as e:  # a launch the card refused
            print("  " + str(e), flush=True)
            ok = False
        print("  checks", "passed" if ok else "FAILED", flush=True)
        if ok:
            runs[name] = run

    for name, B, Sq, Sk, Hq, Hkv, hd, causal, dtype in cs.FLASH_CASES:
        if dtype != "bfloat16" or not runs:
            continue
        q, k, v = qkv(B, Sq, Sk, Hq, Hkv, hd)
        want = ref.attention(q.float(), k.float(), v.float(), causal=causal)
        errs = {n: ref.scaled_err(r(q, k, v, causal), want, q, k, v,
                                  causal=causal) for n, r in runs.items()}
        del want
        ms: dict[str, list[float]] = {}
        for n in list(runs) + list(runs)[::-1]:
            ms.setdefault(n, []).append(
                cs.cuda_ms(lambda: runs[n](q, k, v, causal)))
        print(f"{name}: ms {ms}; scaled err {errs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
