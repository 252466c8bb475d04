"""Time this tree's block-sparse gram (gram_bs) beside variants and another version, in one call.

    mkdir -p build/other
    git show <commit>:src/repro_torch/csrc/spmm.cu > build/other/spmm.cu
    git show <commit>:src/repro_torch/kernels/spmm/ops.py > build/other/spmm_ops.py
    git show <commit>:src/repro_torch/csrc/gram.cu > build/other/gram.cu
    git show <commit>:src/repro_torch/kernels/gram/ops.py > build/other/gram_ops.py
    python3 tools/spmm_ab.py [--other build/other]
        [--variant NAME:KEY=VALUE,...] ... [--waves N,N,...]
        [--cases NAME,...] [--iters N] [--fits]

`--other` is a directory holding another commit's `spmm.cu`,
`spmm_ops.py`, `gram.cu` and `gram_ops.py` (commit cb76bdd and earlier:
gram_bs's partials reduced by gram.cu's square reduce); both are built
and that commit's wrapper is loaded as a module bound to them. Each
`--variant` is this tree's `spmm.cu` and `gram_mainloop.cuh` with
constants substituted in their text (the sources themselves are not
changed):

    STAGES=n       depth of the mainloop's cp.async ring
    F64_BK=n       rows of X a float64 stage holds
    MAX_CHUNKS=n   row chunks a split may hold (the wrapper's
                   `_BS_MAX_CHUNKS` follows it)

A variant with no substitutions is the sources as they stand. Every
source is compiled by nvcc with the port's flags (one process each, all
at once) into `build/variants/`, and each gram_bs partial kernel's
registers and spill bytes are printed from ptxas's report. Then, for each
case (chip_smoke's gram_bs shapes: 100,000 x 1,000 blocky, uniform and
its 6,784-row tail, and one sparse_stream bucket of 30,770 rows; float64
unless the name says otherwise), the versions run in turn (A, B, ...,
..., B, A), each checked against the plain version (chip_smoke's TOL),
bitwise against itself with an all-ones mask and bitwise symmetric, and
timed: `ms` by CUDA events over `--iters` calls, and the device time from
the profiler over 10 calls, with each pass's share by kernel name
(`kernel_ms`); `peak_mb` is the most device memory one call adds to what
was allocated before it (its output and its split workspace). With `--waves`, this tree's kernel then runs
under each `_BS_WAVES` (the plan's items per resident block, for every
dtype) in turn,
with the plan it gives. With `--fits`, chip_smoke's sparse_lm phase (the
sparse lmDS fit, lmCG and the streamed lmDS fit, whose rows report each
fit's `peak_mem_mb`) then runs once with each version's gram_bs in the
wrapper's place. One JSON line per result. Needs a CUDA card and
nvcc; imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CONSTANTS = ("STAGES", "F64_BK", "MAX_CHUNKS")
OUT = ROOT / "build" / "variants"
# (name, rows, cols, pattern, dtype)
CASES = [("blocky", 100_000, 1000, "BLOCKY", "float64"),
         ("blocky-f32", 100_000, 1000, "BLOCKY", "float32"),
         ("blocky-bf16", 100_000, 1000, "BLOCKY", "bfloat16"),
         ("uniform", 100_000, 1000, "UNIFORM", "float64"),
         ("tail", 6784, 1000, "BLOCKY", "float64"),
         ("stream-bucket", 30_770, 1000, "BLOCKY", "float64")]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_summary(log: str) -> dict:
    """{gram_bs partial kernel: [registers, spill bytes]} from ptxas's
    report."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*gram_bs_partial_kernelI"
                      r"(\w+?)EE", ln)
        if m:
            name = m.group(1)
            out[name] = [None, None]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name][0] = int(m.group(1))
            name = None
    return out


def variant_dir(name: str, subs: dict) -> Path:
    """This tree's spmm.cu and gram_mainloop.cuh, constants substituted,
    in a directory of their own (the header beside its source)."""
    from repro_torch.kernels import build
    texts = {f: (build.CSRC / f).read_text()
             for f in ("spmm.cu", "gram_mainloop.cuh")}
    for key, val in subs.items():
        if key not in CONSTANTS:
            raise SystemExit(f"unknown constant {key} (known: {CONSTANTS})")
        hits = 0
        for f, text in texts.items():
            texts[f], k = re.subn(rf"^constexpr int {key} = \d+;",
                                  f"constexpr int {key} = {val};", text,
                                  flags=re.M)
            hits += k
        if hits != 1:
            raise SystemExit(f"constant {key} not found")
    vdir = OUT / f"spmm_{name}"
    vdir.mkdir(parents=True, exist_ok=True)
    for f, text in texts.items():
        (vdir / f).write_text(text)
    return vdir / "spmm.cu"


def bind(module, so: Path) -> None:
    """Point `module`'s ctypes library at `so`, with the argument types
    its own `_library()` sets."""
    from repro_torch.kernels import build
    real = build.library
    build.library = lambda name: ctypes.CDLL(str(so))
    try:
        module._lib = None
        module._library()
    finally:
        build.library = real


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_other(other: Path, sos: dict):
    """The other commit's spmm wrapper, importing the other commit's gram
    wrapper in place of this tree's, each bound to its own library."""
    import repro_torch.kernels.gram as gpkg
    import repro_torch.kernels.spmm  # noqa: F401  (the package of `ref`)
    ogram = load_module("repro_torch.kernels.gram._other_ops",
                        other / "gram_ops.py")
    bind(ogram, sos["other_gram"])
    saved = sys.modules["repro_torch.kernels.gram.ops"], gpkg.ops
    sys.modules["repro_torch.kernels.gram.ops"] = gpkg.ops = ogram
    try:
        ospmm = load_module("repro_torch.kernels.spmm._other_ops",
                            other / "spmm_ops.py")
    finally:
        sys.modules["repro_torch.kernels.gram.ops"], gpkg.ops = saved
    bind(ospmm, sos["other"])
    return ospmm


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.spmm import ops
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--waves")
    ap.add_argument("--cases")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--fits", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spmm_ab: CUDA is not available", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"this": variant_dir("this", {})}
    chunks = {"this": ops._BS_MAX_CHUNKS}
    for spec in args.variant:
        name, _, kv = spec.partition(":")
        subs = dict(x.split("=") for x in kv.split(",") if x)
        sources[name] = variant_dir(name, subs)
        chunks[name] = int(subs.get("MAX_CHUNKS", ops._BS_MAX_CHUNKS))
    if args.other:
        for key, f in (("other", "spmm.cu"), ("other_gram", "gram.cu")):
            d = OUT / key
            d.mkdir(parents=True, exist_ok=True)
            (d / f).write_text((args.other / f).read_text())
            sources[key] = d / f
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(
            lambda cu: build.compile_source(cu, cu.with_suffix(".so")),
            sources.values())))
    sos = {k: cu.with_suffix(".so") for k, cu in sources.items()}
    for name in sources:
        if name != "other_gram":
            emit(dict(version=name, ptxas=ptxas_summary(logs[name])))
    emit(dict(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()))

    libs, fns = {}, {}
    real = ops.gram_bs_cuda

    def this_fn(name):
        def call(x, mask):
            ops._lib = libs[name]
            ops._BS_MAX_CHUNKS = chunks[name]
            ops.gram_bs_plan.cache_clear()
            return real(x, mask)
        return call
    for name in sources:
        if name in ("other", "other_gram"):
            continue
        ops._BS_MAX_CHUNKS = chunks[name]
        bind(ops, sos[name])
        libs[name] = ops._lib
        fns[name] = this_fn(name)
    if args.other:
        fns["other"] = load_other(args.other, sos).gram_bs_cuda
    names = list(fns)
    order = names + names[::-1]
    wanted = args.cases.split(",") if args.cases else None
    import numpy as np
    from repro_torch.core.backend import sparsify, to_device
    from repro_torch.kernels.gram.ref import scaled_err
    from repro_torch.kernels.spmm import ref
    dt = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
    data = {}
    for case, m, n, pattern, dtype in CASES:
        if wanted and case not in wanted:
            continue
        key = (m, n, pattern)
        if key not in data:
            rng = np.random.default_rng(cs.SEED)
            xh, _ = cs.blocky(rng, m, n, *getattr(cs, pattern))
            xs = to_device(sparsify(xh), cs.DEVICE)
            data[key] = (xs.todense(), ops.block_mask_from_indices(xs))
        xd, mask = data[key]
        x = xd.to(dt[dtype])
        ones = torch.ones_like(mask)
        want = ref.gram(x, mask, ops.ROWS, ops.TILE)
        rows: dict[str, list] = {}
        for name in order:
            fn = fns[name]
            got = fn(x, mask)
            ok = (scaled_err(got, want, x, x) <= cs.TOL[dtype]
                  and torch.equal(got, fn(x, ones))
                  and torch.equal(got, fn(x, mask))
                  and torch.equal(got, got.mT))
            del got
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = fn(x, mask)
            torch.cuda.synchronize()
            peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
            del got
            run = (lambda fn=fn: fn(x, mask))
            ms = cs.cuda_ms(run, iters=args.iters)
            _, _, busy, by_name = cs.device_trace(
                lambda: [run() for _ in range(10)])
            kernels = {}
            for kname, sec in by_name.items():
                m_ = re.search(r"(gram_bs_plan|gram_bs_partial|"
                               r"gram_tile_reduce|gram_reduce)", kname)
                key = m_.group(1) if m_ else kname[:40]
                kernels[key] = kernels.get(key, 0.0) + 100 * sec
            rows.setdefault(name, []).append(dict(
                ok=ok, ms=ms, device_ms=None if busy is None else 100 * busy,
                kernel_ms=kernels, peak_mb=peak_mb))
        bms = cs.sparse_bounds("gram_bs", mask, m, n, 1, dtype,
                               cs.PEAKS["H100"])["bound_ms"]
        emit(dict(case=case, m=m, n=n, dtype=dtype, bound_ms=bms, **rows))
        if args.waves:
            fn = fns["this"]
            swept = {}
            base = ops._BS_WAVES
            for w in (int(v) for v in args.waves.split(",")):
                ops._BS_WAVES = dict.fromkeys(base, w)
                ops.gram_bs_plan.cache_clear()
                plan = ops.gram_bs_plan(m, n, x.dtype,
                                        torch.cuda.get_device_properties(
                                            0).multi_processor_count)
                run = (lambda: fn(x, mask))
                _, _, busy, _ = cs.device_trace(
                    lambda: [run() for _ in range(10)])
                swept[w] = dict(plan=list(plan),
                                device_ms=None if busy is None
                                else 100 * busy)
            ops._BS_WAVES = base
            ops.gram_bs_plan.cache_clear()
            emit(dict(waves=case, **{str(k): v for k, v in swept.items()}))
        del x, want
        torch.cuda.empty_cache()
    if args.fits:
        data.clear()
        fits(fns, real)
    return 0


def fits(fns: dict, real) -> None:
    """chip_smoke's sparse_lm phase once with each version's gram_bs."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.spmm import ops
    try:
        for name, fn in fns.items():
            def counted(x, mask, fn=fn, own=name != "other"):
                out = fn(x, mask)
                if not own:  # the other wrapper counts in its own module
                    ops.LAUNCHES["gram_bs"] += 1
                    ops.LAUNCHES["gram_bs_reduce"] += 1
                return out
            ops.gram_bs_cuda = counted
            emit(dict(fits=name))
            torch.cuda.empty_cache()
            cs.phase_sparse_lm()
    finally:
        ops.gram_bs_cuda = real


if __name__ == "__main__":
    sys.exit(main())
