"""Time this tree's gram/xtv kernels beside another version's, in one call.

    mkdir -p build/other
    git show <commit>:src/repro_torch/csrc/gram.cu > build/other/gram.cu
    git show <commit>:src/repro_torch/kernels/gram/ops.py > build/other/ops.py
    python3 tools/gram_ab.py build/other/gram.cu build/other/ops.py \
        [--sweep] [--variant NAME:KEY=VALUE,...] ...

Builds the other `gram.cu` with the port's nvcc flags and loads the other
`ops.py` as a module bound to it (its own wrapper, plan and host path),
then, for chip_smoke's float64 kernel shapes (the lmds bucket and its
tail, quickstart's matrix, c = 3, steplm's 20,000 x 32), runs this tree's
wrapper and the other's in turn (this, other, this, other), each checked
against the plain version (chip_smoke's TOL) and timed: `ms` by CUDA
events over 50 calls, `device_ms` from the profiler (the card's busy time
per call) and `host_us` (200 calls with no synchronise inside, divided by
200: the wrapper's host time). Then steplm at 20,000 x 32
(`max_features=4`, a reuse cache, after a warm-up fit) with each wrapper
in turn: wall seconds and launches.

    --sweep      float64 gram at 8,192 x 1,000 and at the 1,696-row tail
                 with the split count forced (1-12, 14, 16, 22) at each
                 tile width (128 x 128 and 128 x 64), beside the plan's
                 choice, and the xtv split plan's knobs
                 (`_XTV_BLOCKS_PER_SM`, `_XTV_MIN_ROWS`)
    --variant    this tree's gram.cu with constants substituted
                 (F64_BK, STAGES, XTV_UNROLL; none: the source as
                 it stands), each built beside the others, its ptxas
                 registers and spills printed, checked at small shapes
                 and timed at the main shapes in turn

One JSON line per result. Needs a CUDA card and nvcc; imports neither jax
nor the JAX package.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CASES = [("gram", 8192, 1000, 0), ("gram", 1696, 1000, 0),
         ("gram", 5000, 64, 0), ("gram", 20000, 32, 0),
         ("xtv", 8192, 1000, 1), ("xtv", 1696, 1000, 1),
         ("xtv", 5000, 64, 1), ("xtv", 8192, 1000, 3),
         ("xtv", 20000, 32, 1)]
CONSTANTS = ("F64_BK", "STAGES", "XTV_UNROLL")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvcc_build(src: Path, so: Path) -> str:
    from repro_torch.kernels import build
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                        str(src)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def bind(module, so: Path) -> None:
    """Point `module`'s ctypes library at `so`, with the argument types its
    own `_library()` sets."""
    from repro_torch.kernels import build
    real = build.library
    build.library = lambda name: ctypes.CDLL(str(so))
    try:
        module._lib = None
        module._library()
    finally:
        build.library = real


def load_other(cu: Path, ops_py: Path):
    import repro_torch.kernels.gram  # noqa: F401  (the package of `ref`)
    so = cu.with_suffix(".so")
    nvcc_build(cu, so)
    spec = importlib.util.spec_from_file_location(
        "repro_torch.kernels.gram._other_ops", ops_py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bind(mod, so)
    return mod


def ptxas_summary(log: str) -> dict:
    """{kernel: [registers, spill bytes]} of the gram partial and xtv
    kernels, from ptxas's report."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = m.group(1)
            name = k if re.search(r"partial_kernel|xtv_slab", k) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name] = [None, int(m.group(1)) + int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name in out:
            out[name][0] = int(m.group(1))
            name = None
    short = {}
    for k, v in out.items():
        m = re.search(r"(gram_\w+_partial_kernel|xtv_slab_kernel)I(\w+?)EE", k)
        short[f"{m.group(1)}<{m.group(2)}>" if m else k] = v
    return short


def measure(fn) -> dict:
    import torch
    import chip_smoke as cs
    ms = cs.cuda_ms(fn, iters=50)
    _, _, busy, _ = cs.device_trace(lambda: [fn() for _ in range(10)])
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    return dict(ms=ms, device_ms=None if busy is None else 100 * busy,
                host_us=host_us)


def inputs(m: int, n: int, c: int):
    import numpy as np
    import torch
    import chip_smoke as cs
    rng = np.random.default_rng(cs.SEED)
    x = torch.from_numpy(rng.standard_normal((m, n))).cuda()
    v = torch.from_numpy(rng.standard_normal((m, max(c, 1)))).cuda()
    return x, v


def check(mod, kind, x, v) -> float:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.gram import ref
    if kind == "gram":
        got, want, b = mod.gram_cuda(x), ref.gram(x), x
    else:
        got, want, b = mod.xtv_cuda(x, v), ref.xtv(x, v), v
    err = ref.scaled_err(got, want, x, b)
    again = mod.gram_cuda(x) if kind == "gram" else mod.xtv_cuda(x, v)
    ok = err <= cs.TOL[str(x.dtype)[6:]] and torch.equal(got, again) \
        and (kind != "gram" or torch.equal(got, got.mT))
    if not ok:
        raise AssertionError(f"{kind} {tuple(x.shape)} disagrees: {err}")
    return err


def compare(this, other) -> None:
    for kind, m, n, c in CASES:
        x, v = inputs(m, n, c)
        rows = {}
        for name, mod in (("this", this), ("other", other), ("this", this),
                          ("other", other)):
            err = check(mod, kind, x, v)
            fn = (lambda mod=mod: mod.gram_cuda(x)) if kind == "gram" else \
                (lambda mod=mod: mod.xtv_cuda(x, v))
            rows.setdefault(name, []).append(dict(measure(fn), err=err))
        emit(dict(compare=kind, m=m, n=n, c=c or None, **rows))


def steplm_runs(this, other) -> None:
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core import LineageRuntime, ReuseCache, input_tensor
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import steplm
    rng = np.random.default_rng(cs.SEED)
    xn = rng.standard_normal((20_000, 32))
    yn = (xn[:, [3, 17, 25]] @ np.array([[2.0], [-1.0], [0.5]])
          + 0.1 * rng.standard_normal((20_000, 1)))
    own = (gops.gram_cuda, gops.xtv_cuda)  # `this` is gops itself
    fns = {"this": own, "other": (other.gram_cuda, other.xtv_cuda)}

    def fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, sel = steplm(input_tensor("X", xn), input_tensor("y", yn),
                        max_features=4,
                        runtime=LineageRuntime(cache=ReuseCache()))
        return time.perf_counter() - t0, sel

    fit()  # warm-up: closures built once for both
    for name, mod in (("this", this), ("other", other), ("this", this),
                      ("other", other)):
        gops.gram_cuda, gops.xtv_cuda = fns[name]
        mod.reset_launches()
        wall, sel = fit()
        emit(dict(steplm=name, wall_s=wall, selected=sel,
                  launches=dict(mod.LAUNCHES)))
    gops.gram_cuda, gops.xtv_cuda = own


def sweep(this) -> None:
    import torch
    import chip_smoke as cs
    x, v = inputs(8192, 1000, 1)
    real = this.gram_plan
    sms = this._sm_count(x.device)
    for m in (8192, 1696):
        xm = x[:m]
        for tile_n in (128, 64):
            chosen = real(m, 1000, torch.float64, sms, tile_n)
            times = {}
            for s in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 22):
                rows = -(-m // s)
                this.gram_plan = (lambda m_, n_, d_, sms_, t_, rows=rows:
                                  (t_, -(-m_ // rows), rows))
                times[s] = cs.cuda_ms(lambda: this.gram_cuda(xm), iters=30)
            this.gram_plan = real
            emit(dict(sweep="gram", m=m, n=1000, tile_n=tile_n,
                      plan=list(chosen), ms_by_splits=times))
    # narrow X (quickstart, steplm): both tile widths at the plan's splits
    for m, n in ((5000, 64), (20000, 32)):
        xn, _ = inputs(m, n, 0)
        _, splits, rows = real(m, n, torch.float64, sms, 128)
        for tile_n in (128, 64):
            this.gram_plan = lambda *a, tn=tile_n: (tn, splits, rows)
            emit(dict(sweep="gram_narrow", m=m, n=n, tile_n=tile_n,
                      splits=splits, **measure(lambda: this.gram_cuda(xn))))
        this.gram_plan = real
    knobs = (dict(this._XTV_BLOCKS_PER_SM), this._XTV_MIN_ROWS)
    for per_sm in (1, 2, 3, 4):
        for min_rows in (128, 256, 512, 1024):
            this._XTV_BLOCKS_PER_SM[1] = per_sm
            this._XTV_MIN_ROWS = min_rows
            this.xtv_plan.cache_clear()
            emit(dict(sweep="xtv", m=8192, n=1000, blocks_per_sm=per_sm,
                      min_rows=min_rows,
                      plan=list(this.xtv_plan(8192, 1000, 1, torch.float64,
                                              sms)),
                      **measure(lambda: this.xtv_cuda(x, v))))
    this._XTV_BLOCKS_PER_SM.update(knobs[0])
    this._XTV_MIN_ROWS = knobs[1]
    this.xtv_plan.cache_clear()


def variants(this, specs: list[str]) -> None:
    import torch
    from repro_torch.kernels import build
    src = (build.CSRC / "gram.cu").read_text()
    vdir = ROOT / "build" / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for spec in specs:
        name, _, subs = spec.partition(":")
        text = src
        for kv in filter(None, subs.split(",")):
            key, val = kv.split("=")
            assert key in CONSTANTS, key
            text, k = re.subn(rf"constexpr int {key} = \d+;",
                              f"constexpr int {key} = {val};", text)
            assert k == 1, key
        path = vdir / f"gram_{name}.cu"
        path.write_text(text)
        jobs.append((name, path, path.with_suffix(".so")))
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = list(pool.map(lambda j: nvcc_build(j[1], j[2]), jobs))
    for (name, _, _), log in zip(jobs, logs):
        emit(dict(variant=name, ptxas=ptxas_summary(log)))
    small = [(300, 12), (7, 130), (100, 129), (1, 5), (2000, 257)]
    for (name, _, so) in jobs:
        bind(this, so)
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            for m, n in small:
                x, v = inputs(m, n + 1, 3)
                for kind in ("gram", "xtv"):
                    check(this, kind, x[:, 1:].to(dtype), v.to(dtype))
                    check(this, kind, x[:, :n].to(dtype), v[:, :1].to(dtype))
    for kind, m, n, c in CASES[:2] + CASES[4:5]:
        x, v = inputs(m, n, c)
        fn = (lambda: this.gram_cuda(x)) if kind == "gram" else \
            (lambda: this.xtv_cuda(x, v))
        rows = {}
        for (name, _, so) in jobs + jobs[::-1]:
            bind(this, so)
            rows.setdefault(name, []).append(measure(fn))
        emit(dict(variants=kind, m=m, n=n, c=c or None, **rows))
    this._lib = None


def main(argv: list[str]) -> int:
    import torch
    args = [a for a in argv if not a.startswith("--")]
    specs = [argv[i + 1] for i, a in enumerate(argv) if a == "--variant"]
    args = [a for a in args if a not in specs]
    if len(args) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from repro_torch.kernels.gram import ops as this
    emit(dict(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), torch=torch.__version__))
    other = load_other(Path(args[0]).resolve(), Path(args[1]).resolve())
    this._library()
    compare(this, other)
    steplm_runs(this, other)
    if "--sweep" in argv:
        sweep(this)
    if specs:
        variants(this, specs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
