"""Time this tree's block-sparse kernels (gram_bs, xtv_bs, spmm) beside variants and another version, in one call.

    mkdir -p build/other
    for f in spmm.cu gram.cu gram_mainloop.cuh; do
        git show <commit>:src/repro_torch/csrc/$f > build/other/$f; done
    git show <commit>:src/repro_torch/kernels/spmm/ops.py > build/other/spmm_ops.py
    git show <commit>:src/repro_torch/kernels/gram/ops.py > build/other/gram_ops.py
    python3 tools/spmm_ab.py [--kernel gram_bs,xtv_bs,spmm] [--other build/other]
        [--variant NAME:KEY=VALUE,...] ... [--waves N,N,...]
        [--columns C,C,...] [--cases NAME,...] [--iters N] [--fits]

`--other` is a directory holding another commit's `spmm.cu`,
`spmm_ops.py`, `gram.cu`, `gram_ops.py` and, from commit 89529c8 on,
`gram_mainloop.cuh` (a source includes the header beside it first); both
sources are built and that commit's wrapper is loaded as a module bound
to them. `--kernel` names the kernels to time (all three by default).
Each `--variant` is this tree's `spmm.cu` and `gram_mainloop.cuh` with
constants substituted in their text (the sources themselves are not
changed):

    STAGES=n         depth of the gram mainloop's cp.async ring
    F64_BK=n         rows of X a float64 gram stage holds
    MAX_CHUNKS=n     row chunks a gram_bs split may hold (the wrapper's
                     `_BS_MAX_CHUNKS` follows it)
    XB_UNROLL=n      xtv_bs's row loads in flight a lane
    SPMM_SLOTS=n     spmm's rows a lane holds
    SPMM_W_BYTES=n   spmm's shared staging of W
    XB_MIN_BLOCKS=n, SPMM_MIN_BLOCKS=n
                     resident blocks an SM in the kernels' launch bounds
                     (they cap the registers a thread)
    TILE_STAGES=n    depth of the tile products' cp.async ring (two or
                     more columns: xtv_bs_tile, spmm_tile)
    XBT_F64_ROWS=n   rows of X a float64 xtv_bs_tile stage holds
    SP_F64_COLS=n    columns of X a float64 spmm_tile stage holds

A variant with no substitutions is the sources as they stand; a layout
no constant sets (PERF.md §6's slab of 32 x 16 bytes) is timed as a
source copy through `--other`. Every
source is compiled by nvcc with the port's flags (one process each, all
at once) into `build/variants/`, and each kernel's registers and spill
bytes are printed from ptxas's report. Then, for each case (chip_smoke's
shapes: gram_bs at 100,000 x 1,000 blocky and uniform, the 6,784-row tail
and a sparse_stream bucket of 32,768 rows; xtv_bs at sparse_lmds' 100,000
x 1,000 blocky, sparse_lmcg's 100,000 x 2,000 blocky-wide, the bucket and
the tail; spmm at sparse_lmcg's shape and the tail; both at the lmds
point, blocky and uniform (every block populated: the mask skips
nothing); float64 unless the name says otherwise), at each v or W width
of `--columns` (1 by default; two or more take the tile products in this
tree), the versions run in turn (A, B, ..., ..., B, A),
each checked against the plain version (chip_smoke's TOL), bitwise
against itself with an all-ones mask and against a second call (gram_bs:
bitwise symmetric too), and timed: `ms` by CUDA events over `--iters`
calls, and the device time from the profiler over 10 calls, with each
pass's share by kernel name (`kernel_ms`); `peak_mb` is the most device
memory one call adds to what was allocated before it (its output and its
split workspace); `library_ms` is one `torch.matmul` of the dense layout
(a yardstick the port never calls). With `--waves`, this tree's gram_bs
and xtv_bs then run under each value of their plans' blocks per SM
(`_BS_WAVES`, `_XTV_BS_WAVES`, and `_XTV_BS_TILE_WAVES` for two or more
columns) in turn, with the plan it gives. With
`--fits`, chip_smoke's sparse_lm phase (the sparse lmDS fit, lmCG and the
streamed lmDS fit) then runs once with each version's kernels in the
wrapper's place. One JSON line per result. Needs a CUDA card and nvcc;
imports neither jax nor the JAX package.
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

CONSTANTS = ("STAGES", "F64_BK", "MAX_CHUNKS", "XB_UNROLL", "XB_MIN_BLOCKS",
             "SPMM_SLOTS", "SPMM_W_BYTES", "SPMM_MIN_BLOCKS", "TILE_STAGES",
             "XBT_F64_ROWS", "SP_F64_COLS")
KERNELS = ("gram_bs", "xtv_bs", "spmm")
OUT = ROOT / "build" / "variants"
# (name, kernel, rows, cols, pattern, dtype)
CASES = [("blocky", "gram_bs", 100_000, 1000, "BLOCKY", "float64"),
         ("blocky-f32", "gram_bs", 100_000, 1000, "BLOCKY", "float32"),
         ("blocky-bf16", "gram_bs", 100_000, 1000, "BLOCKY", "bfloat16"),
         ("uniform", "gram_bs", 100_000, 1000, "UNIFORM", "float64"),
         ("tail", "gram_bs", 6784, 1000, "BLOCKY", "float64"),
         ("stream-bucket", "gram_bs", 32_768, 1000, "BLOCKY", "float64")]
CASES += [(f"{name}{suffix}", kind, m, n, pattern, dtype)
          for kind, shapes in (
              ("xtv_bs", (("lmds", 100_000, 1000, "BLOCKY"),
                          ("lmcg", 100_000, 2000, "BLOCKY_WIDE"),
                          ("stream-bucket", 32_768, 1000, "BLOCKY"),
                          ("tail", 6784, 1000, "BLOCKY"))),
              ("spmm", (("lmcg", 100_000, 2000, "BLOCKY_WIDE"),
                        ("tail", 6784, 1000, "BLOCKY"))),
              ("xtv_bs", (("lmds-uniform", 100_000, 1000, "UNIFORM"),)),
              ("spmm", (("lmds", 100_000, 1000, "BLOCKY"),
                        ("lmds-uniform", 100_000, 1000, "UNIFORM"))))
          for name, m, n, pattern in shapes
          for suffix, dtype in (("", "float64"), ("-f32", "float32"),
                                ("-bf16", "bfloat16"))]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_summary(log: str) -> dict:
    """{kernel<template arguments>: [registers, spill bytes]} of spmm.cu's
    partial, xtv_bs, spmm and tile kernels, from ptxas's report."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(gram_bs_partial_kernel|"
                      r"xtv_bs_partial_kernel|spmm_kernel|xtv_bs_tile_kernel|"
                      r"spmm_tile_kernel)I(\w+?)EE", ln)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
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


def entry(mod, kind: str):
    return getattr(mod, f"{kind}_cuda")


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.spmm import ops
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default=",".join(KERNELS))
    ap.add_argument("--other", type=Path)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--waves")
    ap.add_argument("--columns", default="1")
    ap.add_argument("--cases")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--fits", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spmm_ab: CUDA is not available", file=sys.stderr)
        return 2
    kernels = args.kernel.split(",")
    if set(kernels) - set(KERNELS):
        raise SystemExit(f"unknown kernel in {kernels} (known: {KERNELS})")
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
            hdr = args.other / "gram_mainloop.cuh"
            if hdr.exists():
                (d / hdr.name).write_text(hdr.read_text())
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
    real = {k: entry(ops, k) for k in KERNELS}

    current = [None]

    def use(name):
        """Bind the wrapper to version `name` (plans recomputed on a
        switch only, so a timed call pays no more host time than the
        wrapper's own)."""
        if current[0] == name:
            return
        current[0] = name
        ops._lib = libs[name]
        ops._BS_MAX_CHUNKS = chunks[name]
        for plan in (ops.gram_bs_plan, ops.xtv_bs_plan, ops.xtv_bs_tile_plan,
                     ops.xtv_bs_route, ops.spmm_route):
            plan.cache_clear()

    def this_fn(name, kind):
        def call(*a):
            use(name)
            return real[kind](*a)
        return call
    for name in sources:
        if name in ("other", "other_gram"):
            continue
        ops._BS_MAX_CHUNKS = chunks[name]
        bind(ops, sos[name])
        current[0] = None
        libs[name] = ops._lib
        fns[name] = {k: this_fn(name, k) for k in KERNELS}
    if args.other:
        other = load_other(args.other, sos)
        fns["other"] = {k: entry(other, k) for k in KERNELS}
    names = list(fns)
    order = names + names[::-1]
    wanted = args.cases.split(",") if args.cases else None
    columns = [int(c) for c in args.columns.split(",")]
    peaks = cs.peaks_for(torch.cuda.get_device_name(0))[1]
    import numpy as np
    from repro_torch.core.backend import sparsify, to_device
    from repro_torch.kernels.gram.ref import scaled_err
    from repro_torch.kernels.spmm import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
    data = {}
    def run_case(case, kind, m, n, pattern, dtype, c, xd, mask, other_in):
        x = xd.to(dt[dtype])
        ones = torch.ones_like(mask)
        if kind == "gram_bs":
            args_of = lambda mk: (x, mk)
            want = ref.gram(x, mask, ops.ROWS, ops.TILE)
            a, b = x, x
            lib = lambda: torch.matmul(x.mT, x)
        elif kind == "xtv_bs":
            w = other_in[:m, :c].to(dt[dtype])
            args_of = lambda mk: (x, w, mk)
            want = ref.xtv(x, w, mask, ops.ROWS, ops.TILE)
            a, b = x, w
            lib = lambda: torch.matmul(x.mT, w)
        else:
            w = other_in[:n, :c].to(dt[dtype])
            args_of = lambda mk: (x, w, mk)
            want = ref.spmm(x, w, mask, ops.ROWS, ops.TILE)
            a, b = x.mT, w
            lib = lambda: torch.matmul(x, w)
        rows: dict[str, list] = {}
        for name in order:
            fn = fns[name][kind]
            got = fn(*args_of(mask))
            ok = (scaled_err(got, want, a, b) <= cs.TOL[dtype]
                  and torch.equal(got, fn(*args_of(ones)))
                  and torch.equal(got, fn(*args_of(mask)))
                  and (kind != "gram_bs" or torch.equal(got, got.mT)))
            del got
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = fn(*args_of(mask))
            torch.cuda.synchronize()
            peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
            del got
            run = (lambda fn=fn: fn(*args_of(mask)))
            ms = cs.cuda_ms(run, iters=args.iters)
            _, _, busy, by_name = cs.device_trace(
                lambda: [run() for _ in range(10)])
            kms = {}
            for kname, sec in by_name.items():
                m_ = re.search(r"(gram_bs_partial|gram_tile_reduce|"
                               r"gram_reduce|xtv_bs_partial|xtv_reduce|"
                               r"xtv_bs_tile|spmm_tile|spmm_kernel)", kname)
                k_ = m_.group(1) if m_ else kname[:40]
                kms[k_] = kms.get(k_, 0.0) + 100 * sec
            rows.setdefault(name, []).append(dict(
                ok=ok, ms=ms, device_ms=None if busy is None else 100 * busy,
                kernel_ms=kms, peak_mb=peak_mb))
        bnd = cs.sparse_bounds(kind, mask, m, n, c, dtype, peaks)
        emit(dict(case=case, kernel=kind, m=m, n=n, c=c, dtype=dtype,
                  bound_ms=bnd["bound_ms"],
                  library_ms=cs.cuda_ms(lib, iters=args.iters), **rows))
        if args.waves and kind in ("gram_bs", "xtv_bs"):
            fn = fns["this"][kind]
            use("this")
            knob = "_BS_WAVES" if kind == "gram_bs" else \
                "_XTV_BS_WAVES" if c == 1 else "_XTV_BS_TILE_WAVES"
            base = getattr(ops, knob)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            swept = {}
            for wv in (int(v) for v in args.waves.split(",")):
                setattr(ops, knob, wv if isinstance(base, int)
                        else dict.fromkeys(base, wv))
                current[0] = None  # the plan changed
                use("this")
                plan = ops.gram_bs_plan(m, n, x.dtype, sms) \
                    if kind == "gram_bs" else ops.xtv_bs_route(m, n, c, x.dtype,
                                                               sms)
                run = (lambda: fn(*args_of(mask)))
                _, _, busy, _ = cs.device_trace(
                    lambda: [run() for _ in range(10)])
                swept[wv] = dict(plan=plan, device_ms=None
                                 if busy is None else 100 * busy)
            setattr(ops, knob, base)
            current[0] = None
            emit(dict(waves=case, kernel=kind, c=c,
                      **{str(k): v for k, v in swept.items()}))
        del x, want

    for case, kind, m, n, pattern, dtype in CASES:
        if kind not in kernels or (wanted and case not in wanted):
            continue
        key = (m, n, pattern)
        if key not in data:
            data.clear()
            torch.cuda.empty_cache()
            rng = np.random.default_rng(cs.SEED)
            xh, _ = cs.blocky(rng, m, n, *getattr(cs, pattern))
            xs = to_device(sparsify(xh), cs.DEVICE)
            other_in = torch.from_numpy(rng.standard_normal(
                (max(m, n), max(columns)))).to(cs.DEVICE)
            data[key] = (xs.todense(), ops.block_mask_from_indices(xs),
                         other_in)
            del xh, xs
        xd, mask, other_in = data[key]
        for c in (columns if kind != "gram_bs" else [1]):
            run_case(case, kind, m, n, pattern, dtype, c, xd, mask, other_in)
    data.clear()
    torch.cuda.empty_cache()
    if "this" in libs:
        use("this")
    if args.fits:
        fits(fns, real, kernels)
    return 0


def fits(fns: dict, real: dict, kernels: list) -> None:
    """chip_smoke's sparse_lm phase once with each version's kernels."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.spmm import ops
    try:
        for name, by_kind in fns.items():
            for kind in kernels:
                def counted(*a, fn=by_kind[kind], own=name != "other",
                            kind=kind):
                    out = fn(*a)
                    if not own:  # the other wrapper counts in its own module
                        ops.LAUNCHES[kind] += 1
                    return out
                setattr(ops, f"{kind}_cuda", counted)
            emit(dict(fits=name))
            torch.cuda.empty_cache()
            cs.phase_sparse_lm()
    finally:
        for kind, fn in real.items():
            setattr(ops, f"{kind}_cuda", fn)


if __name__ == "__main__":
    sys.exit(main())
