"""Build variants of the flash kernels and compare them on the card.

    python3 tools/flash_variants.py [--dtype float32] NAME[:KEY=VALUE,...] ...

Each argument names a variant of `src/repro_torch/csrc/flash.cu` made by
substituting constants in its text (the source itself is not changed).
The bfloat16 kernel's (the default `--dtype bfloat16`):

    BN=n          kv rows per tile (at every head dim)
    STAGES=n      depth of the K/V ring
    NWG=n         consumer warpgroups (64 q rows each)
    EXPF=1        expf of the unscaled-by-log2(e) scores in place of exp2f
    SETMAXNREG=p/c  a producer warpgroup that gives its registers down to p
                  (setmaxnreg.dec) and consumers that ask for c (.inc)
    MAXNREG=n     __maxnreg__(n) in place of the launch bounds

and the float32 kernel's (`--dtype float32`):

    F_BN_WIDE=n   kv rows per tile at hd 128 and 192
    F_BN_NARROW=n kv rows per tile at hd 32 and 64
    F_STAGES=n    depth of the K/V ring
    F_NW=n        consumer warps (16 q rows each)
    F_PV_GROUP=n  n-tiles of P V per fresh accumulator group
    F_MAXNREG=n   __maxnreg__(n) in place of the launch bounds

and for either, SRC=path: the variant starts from that file (relative to
the repository root, e.g. another commit's flash.cu unpacked under
`build/`) in place of the source as it stands.

A variant with no substitutions is the source as it stands. Every variant
is compiled by nvcc with the port's flags (one process per variant, all at
once) into `build/variants/`; the script prints each instantiation's
registers and spills of the chosen dtype from the ptxas report, checks it
at small shapes (ragged, non-causal, GQA, MLA's (192, 128); per-entry
error over the envelope within chip_smoke's FLASH_TOL, bitwise
repeatable), then times that dtype's cases of chip_smoke's FLASH_CASES
with the variants in turn (A, B, ..., ..., B, A), each with its error at
that shape. Needs a CUDA card and nvcc; imports neither jax nor the JAX
package.
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

CHECK = [(2, 512, 512, 16, 8, 128, 128, True),
         (2, 512, 512, 32, 8, 64, 64, True), (3, 200, 200, 4, 2, 32, 32, True),
         (2, 129, 129, 4, 2, 128, 128, True),
         (2, 300, 1024, 16, 8, 128, 128, False),
         (2, 64, 100, 4, 2, 64, 64, False),
         (2, 300, 300, 8, 8, 192, 128, True)]


def variant_source(text: str, opts: dict) -> str:
    if "BN" in opts:
        text, n = re.subn(r"static constexpr int BN = DV == 128 \? \d+ : \d+;",
                          f"static constexpr int BN = {opts['BN']};", text)
        assert n == 1, "BN"
    for key in ("STAGES", "NWG", "F_BN_WIDE", "F_BN_NARROW", "F_STAGES",
                "F_NW", "F_PV_GROUP"):
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
    if "F_MAXNREG" in opts:
        text, n = re.subn(r"__launch_bounds__\(F_THREADS, 1\)",
                          f"__maxnreg__({opts['F_MAXNREG']})", text)
        assert n == 1, "F_MAXNREG"
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
    src = ROOT / opts["SRC"] if "SRC" in opts else build.CSRC / "flash.cu"
    cu.write_text(variant_source(src.read_text(), opts))
    so = cu.with_suffix(".so")
    try:
        return name, so, 0, build.compile_source(cu, so)
    except RuntimeError as e:
        return name, so, 1, str(e)


def caller(lib, code: int):
    import torch
    f = lib.repro_flash_fwd
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    f.argtypes = ([i32, p, p, p, p, i32, i32, i32, i32, i32, i32, i32]
                  + [i64] * 12
                  + [i32, ctypes.c_float, p])
    f.restype = ctypes.c_int

    def run(q, k, v, causal):
        B, Sq, Hq, hd = q.shape
        o = q.new_empty((B, Sq, Hq, v.shape[3]))
        rc = f(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
               Sq, k.shape[1], Hq, k.shape[2], hd, v.shape[3], *q.stride()[:3],
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
    dtype = "bfloat16"
    if argv[:1] == ["--dtype"]:
        dtype, argv = argv[1], argv[2:]
    kind, code = {"bfloat16": ("bf16", 2), "float32": ("f32", 1)}[dtype]
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
    dt = getattr(torch, dtype)

    def qkv(B, Sq, Sk, Hq, Hkv, hd, dv):
        return [torch.randn(s, generator=gen, device="cuda").to(dt)
                for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, dv))]

    tol = cs.FLASH_TOL[dtype]
    runs = {}
    for name, so, rc, log in built:
        lines = log.splitlines()
        print(f"== {name}: nvcc rc {rc}", flush=True)
        for i, ln in enumerate(lines):
            if f"flash_{kind}" in ln and "Compiling entry" in ln:
                hd = ":".join(re.search(r"kernelILi(\d+)ELi(\d+)E",
                                        ln).groups())
                info = " | ".join(x.strip() for x in lines[i + 1:i + 4]
                                  if "spill" in x or "Used" in x)
                print(f"  hd {hd}: {info}", flush=True)
            if "C7512" in ln or "arning" in ln:
                print("  " + ln.strip()[:200], flush=True)
        if rc:
            print(log[-2000:], flush=True)
            continue
        run = caller(ctypes.CDLL(str(so)), code)
        ok, worst = True, 0.0
        try:
            for *shape, causal in CHECK:
                q, k, v = qkv(*shape)
                got = run(q, k, v, causal)
                want = ref.attention(q.float(), k.float(), v.float(),
                                     causal=causal)
                err = ref.scaled_err(got, want, q, k, v, causal=causal)
                worst = max(worst, err)
                ok &= err <= tol and torch.equal(got, run(q, k, v, causal))
        except RuntimeError as e:  # a launch the card refused
            print("  " + str(e), flush=True)
            ok = False
        print("  checks", "passed" if ok else "FAILED",
              f"(largest scaled err {worst:.3e}, limit {tol:.3e})", flush=True)
        if ok:
            runs[name] = run

    for name, B, Sq, Sk, Hq, Hkv, hd, dv, causal, case_dtype in cs.FLASH_CASES:
        if case_dtype != dtype or not runs:
            continue
        q, k, v = qkv(B, Sq, Sk, Hq, Hkv, hd, dv)
        got = {n: r(q, k, v, causal) for n, r in runs.items()}
        errs = dict.fromkeys(runs, 0.0)
        for b in cs._batch_slices(q, k):  # the plain version's scores fit
            want = ref.attention(q[b].float(), k[b].float(), v[b].float(),
                                 causal=causal)
            for n in runs:
                errs[n] = max(errs[n], ref.scaled_err(
                    got[n][b], want, q[b], k[b], v[b], causal=causal))
            del want
        del got
        ms: dict[str, list[float]] = {}
        for n in list(runs) + list(runs)[::-1]:
            ms.setdefault(n, []).append(
                cs.cuda_ms(lambda: runs[n](q, k, v, causal)))
        print(f"{name}: ms {ms}; scaled err {errs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
