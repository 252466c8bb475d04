#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main path through the entry points a user calls and
holds every hand-written kernel against its plain PyTorch version on the
card. One JSON line per phase:

  1. device     — the card (and `nvidia-smi`'s name and power limit line)
  2. build      — compile `src/repro_torch/csrc/*.cu` for sm_90a
  3. kernel     — gram/xtv against the plain version at the path's shapes
                  in float64/float32/bfloat16, with kernel, plain, library
                  (one torch.matmul, a yardstick the port never calls) and
                  bound times
  4. quickstart — the 5000 x 64 lambda sweep with a ReuseCache: reuse
                  hits, bitwise fuse=True/fuse=False parity, PreparedScript
                  replays without rebuilds
  5. lmds       — lmDS at the paper's 100,000 x 1,000 float64 point: the
                  plan streams X in 13 row buckets, each a gram and an xtv
                  launch; beta against numpy's float64 solve; warm refits;
                  the streaming lane's host spans and a device trace
  6. steplm     — stepwise selection at 20,000 x 32, against the CPU run
  7. kernels    — the summary line of every ported kernel

then the card line of `nvidia-smi` and, last, the contract line
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero;
without CUDA (or outside a checkout) it exits non-zero before printing a
result. Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
# kernel against its plain version, per entry over the product of the
# norms of the two columns it combines (the entry's Cauchy-Schwarz
# bound): both sides read the same inputs and accumulate float64 in
# float64 and float32/bfloat16 in float32, so only summation order differs
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}

# Published dense peaks (NVIDIA data sheets): FLOP/s by input dtype and
# memory bytes/s. float64 counts the FP64 tensor-core rate; float32 the
# non-tensor rate (TF32 is off); bfloat16 the tensor-core rate.
PEAKS = {
    "H100 PCIe": dict(float64=51.2e12, float32=51.2e12, bfloat16=756e12,
                      bw=2.0e12),
    "H100 NVL": dict(float64=60e12, float32=60e12, bfloat16=835e12,
                     bw=3.9e12),
    "H100": dict(float64=67e12, float32=67e12, bfloat16=989e12,
                 bw=3.35e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks_for(name: str) -> tuple[str, dict]:
    for key, p in PEAKS.items():
        if key in name:
            return key, p
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_trace(fn):
    """Run `fn` once under `torch.profiler` (card activity only) and
    return (result, wall s, device-busy s or None, {kernel/copy name:
    device s}). Busy time is the union of the card's kernel and copy
    intervals; None when the profiler saw no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e6
    busy, end = 0.0, None
    for s0, e0 in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        if end is None or s0 > end:
            busy += e0 - s0
            end = e0
        elif e0 > end:
            busy += e0 - end
            end = e0
    return out, wall, (busy / 1e6 if events else None), by_name


def bound(kind: str, m: int, n: int, c: int, dtype: str, peaks: dict
          ) -> tuple[float, str]:
    """Least time the card could take: max(bytes / bandwidth, operations /
    peak rate), each input read once and each output written once."""
    size = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    out = 8 if dtype == "float64" else 4
    if kind == "gram":  # upper triangle incl. the diagonal
        ops, nbytes = m * n * (n + 1), m * n * size + n * n * out
    else:
        ops, nbytes = 2 * m * n * c, (m * n + m * c) * size + n * c * out
    t_ops, t_bytes = ops / peaks[dtype], nbytes / peaks["bw"]
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(peaks: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.interop import from_reference
    from repro_torch.kernels.gram import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
    rng = np.random.default_rng(SEED)
    # the streaming bucket, its ragged tail, the quickstart matrix
    cases = [("gram", 8192, 1000, 0), ("gram", 1696, 1000, 0),
             ("gram", 5000, 64, 0), ("xtv", 8192, 1000, 1),
             ("xtv", 1696, 1000, 1), ("xtv", 5000, 64, 1),
             ("xtv", 8192, 1000, 3)]
    main = {}
    for kind, m, n, c in cases:
        host = from_reference({"x": rng.standard_normal((m, n)),
                               "v": rng.standard_normal((m, max(c, 1)))},
                              "cuda")
        for name, dtype in dt.items():
            x = host["x"].to(dtype)
            if kind == "gram":
                args, kern, plain = (x,), ops.gram_cuda, ref.gram
                lib = (lambda x=x: torch.matmul(x.mT, x))
            else:
                v = host["v"].to(dtype)
                args, kern, plain = (x, v), ops.xtv_cuda, ref.xtv
                lib = (lambda x=x, v=v: torch.matmul(x.mT, v))
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            scaled = ref.scaled_err(got, want, x, args[-1])
            ok = scaled <= TOL[name]
            if kind == "gram" and not torch.equal(got, got.mT):
                ok = False
            if not torch.equal(got, kern(*args)):  # fixed-order reduction
                ok = False
            saved = dict(ops.LAUNCHES)
            ms = cuda_ms(lambda: kern(*args))
            ops.LAUNCHES.update(saved)  # timing launches are not the path's
            plain_ms = cuda_ms(lambda: plain(*args))
            library_ms = cuda_ms(lib)
            bms, by = bound(kind, m, n, max(c, 1), name, peaks)
            # the card's own time for the kernel passes (no host work)
            _, _, dev_s, _ = device_trace(
                lambda: [kern(*args) for _ in range(10)])
            ops.LAUNCHES.update(saved)
            row = dict(phase="kernel", kernel=kind, m=m, n=n, c=c or None,
                       dtype=name, max_abs_err=err, scaled_err=scaled,
                       tol=TOL[name], ok=ok, ms=ms,
                       device_ms=None if dev_s is None else 100 * dev_s,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bms, bound_by=by)
            emit(row)
            if not ok:
                raise AssertionError(f"{kind} {m}x{n} {name} disagrees with "
                                     f"its plain version: {row}")
            if (m, n, name) == (8192, 1000, "float64") and c in (0, 1):
                main[kind] = row
    return main


def phase_quickstart() -> None:
    import numpy as np
    from repro_torch.core import (LineageRuntime, PreparedScript,
                                  ReuseCache, get_jit_cache, input_tensor,
                                  ops)
    from repro_torch.kernels.gram import ops as gops
    rng = np.random.default_rng(SEED)
    xn = rng.normal(size=(5000, 64))
    yn = xn @ rng.normal(size=(64, 1)) + 0.01 * rng.normal(size=(5000, 1))
    X, y = input_tensor("X", xn), input_tensor("y", yn)
    lams = (0.01, 0.1, 1.0, 10.0)
    gops.reset_launches()
    t0 = time.perf_counter()
    rt = LineageRuntime(cache=ReuseCache())
    fused = [rt.evaluate([ops.solve(X.T @ X + lam * ops.eye(64),
                                    X.T @ y)])[0] for lam in lams]
    wall = time.perf_counter() - t0
    launches = dict(gops.LAUNCHES)
    rt2 = LineageRuntime(cache=ReuseCache(), fuse=False)
    interp = [rt2.evaluate([ops.solve(X.T @ X + lam * ops.eye(64),
                                      X.T @ y)])[0] for lam in lams]
    bitwise = all(np.array_equal(a, b) for a, b in zip(fused, interp))
    rel = max(np.max(np.abs(b - np.linalg.solve(
        xn.T @ xn + lam * np.eye(64), xn.T @ yn))) / np.max(np.abs(b))
        for b, lam in zip(fused, lams))

    def script(a, b):
        return ops.solve(ops.gram(a) + 0.1 * ops.eye(64), ops.xtv(a, b))
    ps = PreparedScript(script, [(5000, 64), (5000, 1)],
                        runtime=LineageRuntime())
    jc = get_jit_cache().stats
    ps(xn, yn)
    h0, m0 = jc.hits, jc.misses
    for k in range(3):
        ps(xn + k, yn)
    replay_hits, rebuilds = jc.hits - h0, jc.misses - m0
    row = dict(phase="quickstart", shape=[5000, 64], lambdas=list(lams),
               cache=rt.cache.stats.as_dict(), fuse_bitwise=bitwise,
               rel_err_vs_numpy=rel, wall_s=wall, launches=launches,
               prepared_replay_jit_hits=replay_hits,
               prepared_replay_rebuilds=rebuilds)
    emit(row)
    if not (rt.cache.stats.hits >= 3 and bitwise and rel <= 1e-9
            and rebuilds == 0 and replay_hits >= 3):
        raise AssertionError(f"quickstart flow failed: {row}")


def phase_lmds(m: int = 100_000, n: int = 1_000) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import (LineageRuntime, ReuseCache, costmodel,
                                  get_jit_cache, input_tensor)
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import lmDS
    reg = 1e-7
    # X and y stream together: (n + 1) float64 values per row
    c = costmodel.chunk_rows(8.0 * (n + 1))
    buckets = -(-m // c)
    rng = np.random.default_rng(SEED)
    xn = rng.standard_normal((m, n))
    yn = xn @ rng.standard_normal((n, 1)) + 0.1 * rng.standard_normal((m, 1))
    want = np.linalg.solve(xn.T @ xn + reg * np.eye(n), xn.T @ yn)
    jc = get_jit_cache().stats

    def fit(rt):
        X, y = input_tensor("X", xn), input_tensor("y", yn)
        m0 = jc.misses
        s0 = rt.stats.streaming.as_dict()
        t0s = rt.stats.streaming.spans()
        gops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beta = lmDS(X, y, reg=reg, runtime=rt)
        wall = time.perf_counter() - t0
        rel = float(np.max(np.abs(beta - want)) / np.max(np.abs(want)))
        return dict(wall_s=wall, rel_err=rel, rebuilds=jc.misses - m0,
                    launches=dict(gops.LAUNCHES),
                    streaming={k: v - s0[k] for k, v in
                               rt.stats.streaming.as_dict().items()
                               if k != "peak_live_bytes"},
                    spans={k: v - t0s[k] for k, v in
                           rt.stats.streaming.spans().items()})

    rt = LineageRuntime(cache=ReuseCache())
    cold = fit(rt)            # the main path: counts set to 0 inside
    # same runtime: the whole stream is a reuse hit. The first refit hits
    # the probed eye(1000) and builds the compensation closure for the
    # literal of its segment, as the reference does (tests/
    # test_torch_runtime.py::test_streaming_lane_matches_reference);
    # later refits build nothing
    warm = fit(rt)
    warm2 = fit(rt)
    # a fresh reuse cache: the same plan re-streams on warm closures
    rerun = fit(LineageRuntime(cache=ReuseCache()))

    # the card's busy and idle share over one more re-stream, traced
    _, trace_wall, busy, by_name = device_trace(
        lambda: fit(LineageRuntime(cache=ReuseCache())))
    traced = dict(wall_s=trace_wall, device_busy_s=busy,
                  idle_share=None if busy is None else 1 - busy / trace_wall,
                  top_device_s=dict(sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:6]))
    gops.reset_launches()
    row = dict(phase="lmds", shape=[m, n], dtype="float64", reg=reg,
               bucket_rows=c, buckets=buckets, cold=cold, warm=warm,
               warm2=warm2, rerun_fresh_cache=rerun, traced=traced)
    emit(row)
    ok = (buckets > 1 and cold["streaming"]["chunks"] == buckets
          and cold["launches"]["gram"] == buckets
          and cold["launches"]["xtv"] == buckets
          and max(cold["rel_err"], warm["rel_err"], rerun["rel_err"]) <= 1e-9
          and warm["streaming"]["full_hits"] == 1
          and warm["launches"]["gram"] == warm["launches"]["xtv"] == 0
          and warm["rebuilds"] == 1
          and warm2["streaming"]["full_hits"] == 1 and warm2["rebuilds"] == 0
          and rerun["streaming"]["chunks"] == buckets
          and rerun["rebuilds"] == 0)
    if not ok:
        raise AssertionError(f"lmDS at 100K x 1K failed: {row}")
    return cold["launches"]


def phase_steplm() -> None:
    import numpy as np
    from repro_torch.core import LineageRuntime, ReuseCache, input_tensor
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import steplm
    rng = np.random.default_rng(SEED)
    xn = rng.standard_normal((20_000, 32))
    yn = (xn[:, [3, 17, 25]] @ np.array([[2.0], [-1.0], [0.5]])
          + 0.1 * rng.standard_normal((20_000, 1)))
    gops.reset_launches()
    t0 = time.perf_counter()
    rt = LineageRuntime(cache=ReuseCache())
    beta, sel = steplm(input_tensor("X", xn), input_tensor("y", yn),
                       max_features=4, runtime=rt)
    wall = time.perf_counter() - t0
    launches = dict(gops.LAUNCHES)
    beta_cpu, sel_cpu = steplm(input_tensor("X", xn), input_tensor("y", yn),
                               max_features=4,
                               runtime=LineageRuntime(cache=ReuseCache(),
                                                      device="cpu"))
    rel = float(np.max(np.abs(beta - beta_cpu)) / np.max(np.abs(beta_cpu)))
    row = dict(phase="steplm", shape=[20_000, 32], selected=sel,
               selected_cpu=sel_cpu, rel_err_vs_cpu=rel, wall_s=wall,
               launches=launches, cache=rt.cache.stats.as_dict())
    emit(row)
    if sel != sel_cpu or rel > 1e-9 or not {3, 17, 25} <= set(sel) \
            or launches["gram"] == 0 or launches["xtv"] == 0:
        raise AssertionError(f"steplm failed: {row}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    key, peaks = peaks_for(name)
    emit(dict(phase="device", name=name, count=torch.cuda.device_count(),
              nvidia_smi=smi, peaks_of=key, peaks=peaks,
              torch=torch.__version__, cuda=torch.version.cuda))

    t0 = time.perf_counter()
    built = build.build("gram")
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=built,
              ptxas=[ln.strip() for ln in build.build_log("gram").splitlines()
                     if "registers" in ln or "spill" in ln]))

    main_rows = phase_kernels(peaks)
    phase_quickstart()
    launches = phase_lmds()
    phase_steplm()

    kernels = []
    for kind, line in (("gram", 49), ("xtv", 83)):
        r = main_rows[kind]
        kernels.append(dict(
            name=kind, route="cuda", source="src/repro_torch/csrc/gram.cu",
            replaces=f"src/repro/kernels/gram/kernel.py:{line}",
            launches=launches[kind],
            reduce_launches=launches[f"{kind}_reduce"],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    emit(dict(kernels=kernels))
    print(smi, flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=name,
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
