"""Time this tree's gram/xtv kernels beside another version's, in one call.

    mkdir -p build/other
    git show <commit>:src/repro_torch/csrc/gram.cu > build/other/gram.cu
    git show <commit>:src/repro_torch/csrc/gram_mainloop.cuh \
        > build/other/gram_mainloop.cuh   # from commit 89529c8 on
    git show <commit>:src/repro_torch/csrc/sm90.cuh \
        > build/other/sm90.cuh            # where the commit has it
    git show <commit>:src/repro_torch/kernels/gram/ops.py > build/other/ops.py
    python3 tools/gram_ab.py [build/other/gram.cu build/other/ops.py] \
        [--sweep] [--cut] [--paths] [--gram-splits] \
        [--variant NAME:KEY=VALUE,...] ...

Builds the other `gram.cu` with the port's nvcc flags (it includes the
headers beside it first) and loads the other
`ops.py` as a module bound to it (its own wrapper, plan and host path),
then, for chip_smoke's float64 kernel shapes (the lmds bucket and its
tail, quickstart's matrix, c = 3, steplm's 20,000 x 32), runs this tree's
wrapper and the other's in turn (this, other, this, other), each checked
against the plain version (chip_smoke's TOL), against the other's result
bit for bit in float64, float32 and bfloat16 (`same_bits`), and timed:
`ms` by CUDA events over 50 calls, `device_ms` from the profiler (the
card's busy time per call) and `host_us` (200 calls with no synchronise
inside, divided by 200: the wrapper's host time). Then steplm at 20,000 x 32
(`max_features=4`, a reuse cache, after a warm-up fit) with each wrapper
in turn: wall seconds and launches. Without the other version's two
files, only the modes below run, on this tree.

    --sweep        float64 gram at 8,192 x 1,000 and at the 1,696-row tail
                   with the split count forced (1-12, 14, 16, 22) at each
                   tile width (128 x 128 and 128 x 64), beside the plan's
                   choice, and the xtv slab plan's knobs
                   (`_XTV_BLOCKS_PER_SM`, `_XTV_MIN_ROWS`)
    --cut          (needs the other version) xtv at c = 2, 3, 4 and 8 of
                   v's columns on the lmds bucket (8,192 x 1,000), the
                   lmds point's 100,000 x 1,000, CV's
                   12,500 x 1,000 fold, 3,000 x 1,001 (8-byte rows) and
                   20,000 x 34 at an offset, in float64, float32 and
                   bfloat16, this tree's and the other's in turns: against
                   a commit before the tile product (whose slab kernel
                   took v four columns a pass), the data behind the
                   route's cut (`ops.xtv_route`: the slab kernel for one
                   column, the tile product for two or more)
    --paths        the paths' wide xtv launches, float64: kmeans' AᵀX
                   (100,000 x 8 against 1,000 columns), mlogreg's c 10 and
                   the fold's 8 columns, with the plan, the bound and
                   torch.matmul's time (and the other's, in turns)
    --gram-splits  the bfloat16 gram (wgmma) at CV's (8, 12,500, 1,000)
                   stack, one 12,500 x 1,000 fold and the 8,192 x 1,000
                   bucket with the split count forced (the plan's choice
                   beside it), for the rate the plan weighs
                   (`ops._SM_FLOPS[torch.bfloat16]`), and torch.bmm's time
    --variant      this tree's gram.cu and gram_mainloop.cuh with
                   constants substituted (F64_BK, STAGES, XTV_UNROLL,
                   WG_STAGES, WG_CHAIN, WG_BK, XT_STAGES; none: the sources
                   as they stand; a WG_BK other than 64 also sets the
                   plan's `ops._WG_BK`, the unit of the bf16 splits), each
                   built beside the others under build/variants/, its
                   ptxas registers and spills printed, checked at small
                   shapes (lone, batched and folded), and timed in turns at
                   the float64 gram and xtv main shapes, the --gram-splits
                   shapes and the fold's xtv in every dtype

The batched and folded calls go straight to this tree's `gram_batched`
and `xtv_fold` (the bodies of the custom ops' vmap rules), never through
`torch.func.vmap`: the other `ops.py` registers the same custom op names
when it is loaded, and a vmapped op would run its version.

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
CONSTANTS = ("F64_BK", "STAGES", "XTV_UNROLL", "WG_STAGES", "WG_CHAIN",
             "WG_BK", "XT_STAGES")
# --cut: (m, n, offset) against c columns of v, every dtype
CUT_SHAPES = [(8192, 1000, 0), (100_000, 1000, 0), (12_500, 1000, 0),
              (3000, 1001, 0), (20_000, 34, 1)]
CUT_COLUMNS = (2, 3, 4, 8)
# --paths: the paths' wide xtv launches (m, n, c)
PATHS = [("kmeans", 100_000, 8, 1000), ("mlogreg", 100_000, 1000, 10),
         ("fold", 12_500, 1000, 8)]
# --gram-splits and the variants' bf16 gram: (batch, m, n)
GRAM_CASES = [(8, 12_500, 1000), (1, 12_500, 1000), (1, 8192, 1000)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bind(module, so: Path, bk: int = 64) -> None:
    """Point `module`'s ctypes library at `so`, with the argument types its
    own `_library()` sets (this tree's module: its bf16 gram splits whole
    stages of `bk` rows)."""
    from repro_torch.kernels import build
    if hasattr(module, "_WG_BK"):
        module._WG_BK = bk
        module.gram_plan.cache_clear()
    real = build.library
    build.library = lambda name: ctypes.CDLL(str(so))
    try:
        module._lib = None
        module._library()
    finally:
        build.library = real


def load_other(cu: Path, ops_py: Path):
    import repro_torch.kernels.gram  # noqa: F401  (the package of `ref`)
    from repro_torch.kernels import build
    so = cu.with_suffix(".so")
    build.compile_source(cu, so)
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
            name = k if re.search(r"partial_kernel|wgmma_kernel|xtv_slab|"
                                  r"xtv_tile", k) else None
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
        m = re.search(r"(gram_\w+_partial_kernel|gram_bf16_wgmma_kernel|"
                      r"xtv_slab_kernel|xtv_tile_kernel)I(\w+?)EE", k)
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


def inputs(m: int, n: int, c: int, offset: int = 0):
    """Float64 X (m, n), a column slice at `offset` of wider rows, and v
    (m, c), from chip_smoke's seed."""
    import numpy as np
    import torch
    import chip_smoke as cs
    rng = np.random.default_rng(cs.SEED)
    x = torch.from_numpy(rng.standard_normal((m, n + offset))).cuda()
    v = torch.from_numpy(rng.standard_normal((m, max(c, 1)))).cuda()
    return x[:, offset:], v


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


def same_bits(this, other, kind, x, v) -> dict:
    """Whether this tree's result equals the other version's bit for bit,
    in each dtype."""
    import torch
    out = {}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        xd, vd = x.to(dtype), v.to(dtype)
        if kind == "gram":
            a, b = this.gram_cuda(xd), other.gram_cuda(xd)
        else:
            a, b = this.xtv_cuda(xd, vd), other.xtv_cuda(xd, vd)
        out[str(dtype)[6:]] = torch.equal(a, b)
    return out


def in_turns(this, other, kind, x, v) -> dict:
    """This tree's wrapper and the other's in turns (this, other, this,
    other), each checked, then timed."""
    rows = {}
    for name, mod in (("this", this), ("other", other), ("this", this),
                      ("other", other)):
        err = check(mod, kind, x, v)
        fn = (lambda mod=mod: mod.gram_cuda(x)) if kind == "gram" else \
            (lambda mod=mod: mod.xtv_cuda(x, v))
        rows.setdefault(name, []).append(dict(measure(fn), err=err))
    return rows


def compare(this, other) -> None:
    for kind, m, n, c in CASES:
        x, v = inputs(m, n, c)
        emit(dict(compare=kind, m=m, n=n, c=c or None,
                  same_bits=same_bits(this, other, kind, x, v),
                  **in_turns(this, other, kind, x, v)))


def cut(this, other) -> None:
    import torch
    sms = this._sm_count(torch.device("cuda"))
    for m, n, off in CUT_SHAPES:
        x64, v64 = inputs(m, n, max(CUT_COLUMNS), off)
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            x = x64.to(dtype) if off == 0 else \
                torch.zeros((m, n + off), dtype=dtype,
                            device=x64.device)[:, off:].copy_(x64)
            for c in CUT_COLUMNS:
                v = v64[:, :c].to(dtype).contiguous()
                emit(dict(cut=[m, n, c], offset=off, dtype=str(dtype)[6:],
                          route=this.xtv_route(m, n, c, dtype, sms),
                          **in_turns(this, other, "xtv", x, v)))


def paths(this, other) -> None:
    import torch
    import chip_smoke as cs
    peaks = cs.peaks_for(torch.cuda.get_device_name(0))[1]
    sms = this._sm_count(torch.device("cuda"))
    for name, m, n, c in PATHS:
        x, v = inputs(m, n, c)
        bms, by = cs.bound("xtv", m, n, c, "float64", peaks)
        rows = in_turns(this, other, "xtv", x, v) if other else \
            dict(this=[dict(measure(lambda: this.xtv_cuda(x, v)),
                            err=check(this, "xtv", x, v))])
        emit(dict(path=name, shape=[m, n, c], dtype="float64",
                  route=this.xtv_route(m, n, c, x.dtype, sms), bound_ms=bms,
                  bound_by=by,
                  library_ms=cs.cuda_ms(lambda: torch.matmul(x.mT, v)),
                  **rows))


def gram_splits(this) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.gram import ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    peaks = cs.peaks_for(torch.cuda.get_device_name(0))[1]
    real = this.gram_plan
    sms = this._sm_count(torch.device("cuda"))
    for k, m, n in GRAM_CASES:
        x = torch.randn((k, m, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        fn = (lambda: this.gram_batched(x)) if k > 1 else \
            (lambda: this.gram_cuda(x[0]))
        chosen = real(m, n, torch.bfloat16, sms, this.GRAM_TILE_N, k)
        bms, by = cs.batched_bound("gram", k, m, n, 0, "bfloat16", peaks)
        rows = {}
        for s in (1, 2, 3, 4, 5, 6, 8, 11, 16):
            r = -(-m // (s * this._WG_BK)) * this._WG_BK
            s = -(-m // r)
            this.gram_plan = (lambda *a, r=r, s=s, **kw: (128, s, r))
            try:
                got = fn()
                got = got if k > 1 else got[None]
                err = max(ref.scaled_err(got[i], ref.gram(x[i].double()),
                                         x[i], x[i]) for i in range(k))
                if err > cs.TOL["bfloat16"]:
                    raise AssertionError(f"gram {k, m, n} splits {s}: {err}")
                rows[s] = measure(fn)
            finally:
                this.gram_plan = real
        emit(dict(gram_splits=[k, m, n], plan=chosen, bound_ms=bms,
                  bound_by=by, by_splits=rows,
                  library_ms=cs.cuda_ms(lambda: torch.bmm(x.mT, x))))


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
    knobs = (this._XTV_BLOCKS_PER_SM, this._XTV_MIN_ROWS)
    for per_sm in (1, 2, 3, 4):
        for min_rows in (128, 256, 512, 1024):
            this._XTV_BLOCKS_PER_SM = per_sm
            this._XTV_MIN_ROWS = min_rows
            this.xtv_plan.cache_clear()
            emit(dict(sweep="xtv", m=8192, n=1000, blocks_per_sm=per_sm,
                      min_rows=min_rows,
                      plan=list(this.xtv_plan(8192, 1000, 1, torch.float64,
                                              sms)),
                      **measure(lambda: this.xtv_cuda(x, v))))
    this._XTV_BLOCKS_PER_SM, this._XTV_MIN_ROWS = knobs
    this.xtv_plan.cache_clear()


def variants(this, specs: list[str]) -> None:
    import torch
    from repro_torch.kernels import build
    files = {f: (build.CSRC / f).read_text()
             for f in ("gram.cu", "gram_mainloop.cuh")}
    jobs = []
    for spec in specs:
        name, _, subs = spec.partition(":")
        texts = dict(files)
        bk = 64
        for kv in filter(None, subs.split(",")):
            key, val = kv.split("=")
            assert key in CONSTANTS, key
            hits = 0
            for f, text in texts.items():
                texts[f], k = re.subn(rf"constexpr int {key} = \d+;",
                                      f"constexpr int {key} = {val};", text)
                hits += k
            assert hits == 1, key
            bk = int(val) if key == "WG_BK" else bk
        vdir = ROOT / "build" / "variants" / f"gram_{name}"
        vdir.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():  # the header beside its source
            (vdir / f).write_text(text)
        path = vdir / "gram.cu"
        jobs.append((name, path, path.with_suffix(".so"), bk))
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = list(pool.map(lambda j: build.compile_source(j[1], j[2]),
                             jobs))
    for (name, *_), log in zip(jobs, logs):
        emit(dict(variant=name, ptxas=ptxas_summary(log)))
    small = [(300, 12), (7, 130), (100, 129), (1, 5), (2000, 257)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    stack = torch.randn((3, 777, 300), device="cuda", generator=gen)
    for (name, _, so, bk) in jobs:
        bind(this, so, bk)
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            for m, n in small:
                x, v = inputs(m, n + 1, 3)
                for kind in ("gram", "xtv"):
                    check(this, kind, x[:, 1:].to(dtype), v.to(dtype))
                    check(this, kind, x[:, :n].to(dtype), v[:, :1].to(dtype))
            batched_checks(this, stack.to(dtype), name)
    cases = []
    for kind, m, n, c in CASES[:2] + CASES[4:5]:
        x, v = inputs(m, n, c)
        cases.append((dict(variants=kind, m=m, n=n, c=c or None),
                      (lambda x=x: this.gram_cuda(x)) if kind == "gram" else
                      (lambda x=x, v=v: this.xtv_cuda(x, v))))
    for k, m, n in GRAM_CASES:
        x = torch.randn((k, m, n), device="cuda").to(torch.bfloat16)
        cases.append((dict(variants="gram_bf16", shape=[k, m, n]), (
            lambda x=x: this.gram_batched(x)) if k > 1 else (
            lambda x=x: this.gram_cuda(x[0]))))
    xf, vf = inputs(12_500, 1000, 8)
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        x, v = xf.to(dt), vf.mT.to(dt)[:, :, None]  # 8 v's of 1 column
        cases.append((dict(variants="fold", shape=[8, 12_500, 1000, 1],
                           dtype=str(dt)[6:]),
                      lambda x=x, v=v: this.xtv_fold(x, v)))
    for head, fn in cases:
        rows = {}
        for (name, _, so, bk) in jobs + jobs[::-1]:
            bind(this, so, bk)
            rows.setdefault(name, []).append(measure(fn))
        emit(dict(head, **rows))
    this._lib = None
    this._WG_BK = 64
    this.gram_plan.cache_clear()


def batched_checks(this, x, name: str) -> None:
    """A (k, m, n) stack's batched gram, and the fold of its elements'
    first 5 columns against X = x[0], each element within chip_smoke's
    TOL of the plain version."""
    import chip_smoke as cs
    from repro_torch.kernels.gram import ref
    g = this.gram_batched(x)
    xv = this.xtv_fold(x[0], x[:, :, :5])
    for i in range(x.shape[0]):
        e1 = ref.scaled_err(g[i], ref.gram(x[i].double()), x[i], x[i])
        e2 = ref.scaled_err(xv[i], ref.xtv(x[0].double(),
                                           x[i, :, :5].double()),
                            x[0], x[i, :, :5])
        if max(e1, e2) > cs.TOL[str(x.dtype)[6:]]:
            raise AssertionError(f"variant {name} {x.dtype}: {e1} {e2}")


def main(argv: list[str]) -> int:
    import torch
    args = [a for a in argv if not a.startswith("--")]
    specs = [argv[i + 1] for i, a in enumerate(argv) if a == "--variant"]
    args = [a for a in args if a not in specs]
    if len(args) not in (0, 2) or not torch.cuda.is_available() or \
            ("--cut" in argv and not args):
        print(__doc__, file=sys.stderr)
        return 2
    from repro_torch.kernels.gram import ops as this
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(dict(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), torch=torch.__version__))
    other = load_other(Path(args[0]).resolve(), Path(args[1]).resolve()) \
        if args else None
    this._library()
    if other:
        compare(this, other)
        steplm_runs(this, other)
    if "--sweep" in argv:
        sweep(this)
    if "--cut" in argv:
        cut(this, other)
    if "--paths" in argv:
        paths(this, other)
    if "--gram-splits" in argv:
        gram_splits(this)
    if specs:
        variants(this, specs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
