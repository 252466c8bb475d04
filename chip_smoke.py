#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main path through the entry points a user calls and
holds every hand-written kernel against its plain PyTorch version on the
card. One JSON line per phase:

  1. device        — the card (and `nvidia-smi`'s name and power limit)
  2. build         — compile `src/repro_torch/csrc/*.cu` (gram, spmm,
                     flash) for sm_90a, one `nvcc` per source, all started
                     together
  3. kernel        — gram/xtv against the plain version at the path's
                     shapes in float64/float32/bfloat16, with kernel, plain,
                     library (one torch.matmul, a yardstick the port never
                     calls) and bound times
  4. sparse_kernel — the block-sparse gram_bs/xtv_bs/spmm kernels against
                     their plain version at the bcoo paths' shapes (blocky,
                     uniform and a ragged tail), bitwise against the same
                     kernel with an all-ones mask, with times and bounds
                     over the dense layout and over the populated blocks
  5. flash_kernel  — the flash-attention kernel against its plain version
                     computed in float32 from the same inputs, each entry
                     within a bound of its own envelope, at the
                     serving path's shapes (qwen3-0.6b and llama3.2-1b
                     heads, ragged prompts, non-causal, float32), bitwise
                     repeatable, with kernel, plain, library (one
                     scaled_dot_product_attention, a yardstick the port
                     never calls) and bound times
  6. quickstart    — the 5000 x 64 lambda sweep with a ReuseCache: reuse
                     hits, bitwise fuse=True/fuse=False parity,
                     PreparedScript replays without rebuilds
  7. lmds          — lmDS at the paper's 100,000 x 1,000 float64 point: the
                     plan streams X in 13 row buckets, each a gram and an
                     xtv launch; beta against numpy's float64 solve; warm
                     refits; the streaming lane's host spans and a trace
  8. steplm        — stepwise selection at 20,000 x 32, against the CPU run
  9. sparse_lm     — the bcoo lane (`sparse_inputs=True`) on block-sparse
                     float64 data: lm -> lmDS at 100,000 x 1,000 in memory,
                     lmCG at 100,000 x 2,000 (20 iterations), lmDS streamed
                     at 400,000 x 1,000 in 13 bcoo buckets; betas against
                     numpy and the dense lane, launch counts, reuse
 10. lm_serve      — the dense LM family served at qwen3-0.6b's full width
                     (28 layers, bf16, seeded weights): `generate` for a
                     batch of 8 2,048-token prompts and 32 greedy tokens,
                     its own steps read for launches (one flash launch per
                     layer in prefill, none in decode) and times;
                     teacher-forced decode against prefill logits, kernel
                     against plain attention and against two planted
                     faults; tokens/s, peak memory, a traced idle share
 11. kernels       — the summary line of every ported kernel

then the card line of `nvidia-smi` and, last, the contract line
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero;
without CUDA (or outside a checkout) it exits non-zero before printing a
result. Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
DEVICE = "cuda"
# kernel against its plain version, per entry over the product of the
# norms of the two columns it combines (the entry's Cauchy-Schwarz
# bound): both sides read the same inputs and accumulate float64 in
# float64 and float32/bfloat16 in float32, so only summation order differs
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}

# flash kernel against its plain version computed in float32 from the same
# inputs, per entry over its envelope Σ p_j |v_j| (flash ref.scaled_err):
# the bf16 kernel rounds p to bf16 before PV and its output to bf16, each
# moving an entry by at most 2^-8 of its envelope, so 2^-7 bounds both;
# 2^-16 is float32's share (score sums and exp in another order), which
# is all the f32 kernel may differ by. tests/test_torch_flash.py holds a
# dropped kv block and a shifted causal mask above these limits
FLASH_TOL = {"float32": 2.0 ** -16, "bfloat16": 2.0 ** -7 + 2.0 ** -16}
# the served model in bf16 along two sound routes (flash kernel vs the
# plain attention; the prefill's kernel vs decode's plain attention over
# the cache), which differ by bf16 roundings that add up over 28 layers:
# last-position logits, max|a - b| over max|b| (SERVE_TOL), and every
# position's final hidden state, each row over its own max (HIDDEN_TOL).
# On an H100 the sound routes read <= 2.2 % and 4.7 %, and the planted
# faults (a causal mask off by one; one kv block dropped from the last q
# tile) >= 25.6 % and 38.7 %: each limit lies between the two
SERVE_TOL = 5e-2
HIDDEN_TOL = 1e-1

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


# ---------------------------------------------------------------------------
# the bcoo lane: block-sparse data, kernels, paths
# ---------------------------------------------------------------------------

ROW_GROUP, COL_GROUP = 1024, 128   # the data's block structure
BLOCKY = (0.25, 0.2)      # p_block, p_in: density 0.05 (lmDS, streamed)
BLOCKY_WIDE = (0.1, 0.1)  # density 0.01 (lmCG)
UNIFORM = (1.0, 0.05)     # every block populated: the mask skips nothing


def blocky(rng, m: int, n: int, p_block: float, p_in: float):
    """float64 X (m, n) of ROW_GROUP x COL_GROUP blocks, each populated
    with probability `p_block`, an entry of a populated block N(0, 1) with
    probability `p_in`, else 0; and the (row group, column group) map of
    populated blocks."""
    import numpy as np
    keep = rng.random((-(-m // ROW_GROUP), -(-n // COL_GROUP))) < p_block
    x = np.zeros((m, n))
    for g, row in enumerate(keep):
        cols = _group_cols(row, n)
        if cols.size:
            r0, r1 = g * ROW_GROUP, min(m, (g + 1) * ROW_GROUP)
            shape = (r1 - r0, cols.size)
            x[r0:r1, cols] = rng.standard_normal(shape) * (
                rng.random(shape) < p_in)
    return x, keep


def _group_cols(row, n: int):
    import numpy as np
    groups = np.flatnonzero(row)
    cols = (groups[:, None] * COL_GROUP + np.arange(COL_GROUP)).ravel()
    return cols[cols < n]


def blocky_gram(x, keep):
    """XᵀX in float64 on the host from the populated blocks only."""
    import numpy as np
    n = x.shape[1]
    g = np.zeros((n, n))
    for r, row in enumerate(keep):
        cols = _group_cols(row, n)
        if cols.size:
            xs = x[r * ROW_GROUP:(r + 1) * ROW_GROUP][:, cols]
            g[np.ix_(cols, cols)] += xs.T @ xs
    return g


def sparse_bounds(kind: str, mask, m: int, n: int, c: int, dtype: str,
                  peaks: dict) -> dict:
    """Least times over the dense layout and over the populated blocks
    only (what this data needs): max(bytes / bandwidth, operations / peak),
    each needed input byte read once, each output byte written once."""
    import numpy as np
    from repro_torch.kernels.spmm.ops import ROWS, TILE
    size = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    out = 8 if dtype == "float64" else 4
    pop = mask.cpu().numpy() > 0
    rows = np.minimum(ROWS, m - ROWS * np.arange(pop.shape[0]))
    width = np.minimum(TILE, n - TILE * np.arange(pop.shape[1]))
    cols = (pop * width).sum(axis=1)          # populated columns per chunk
    x_bytes = float((rows * cols).sum()) * size
    if kind == "gram_bs":
        ops = float((rows * cols * (cols + 1)).sum())
        nbytes = x_bytes + n * n * out
        dense = bound("gram", m, n, 1, dtype, peaks)
    elif kind == "xtv_bs":
        ops = 2.0 * float((rows * cols).sum()) * c
        nbytes = (x_bytes + float(rows[pop.any(axis=1)].sum()) * c * size
                  + n * c * out)
        dense = bound("xtv", m, n, c, dtype, peaks)
    else:  # spmm: X (m, n) @ W (n, c)
        ops = 2.0 * float((rows * cols).sum()) * c
        used = float(width[pop.any(axis=0)].sum())
        nbytes = x_bytes + used * c * size + m * c * out
        t_ops = 2.0 * m * n * c / peaks[dtype]
        t_bytes = ((m * n + n * c) * size + m * c * out) / peaks["bw"]
        dense = (1e3 * max(t_ops, t_bytes),
                 "operations" if t_ops >= t_bytes else "bytes")
    t_ops, t_bytes = ops / peaks[dtype], nbytes / peaks["bw"]
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_dense_ms=dense[0], bound_dense_by=dense[1])


def phase_sparse_kernels(peaks: dict, scale: int = 1) -> dict:
    """Each block-sparse kernel against its plain version at the bcoo
    paths' shapes (`scale` divides the rows, for a rehearsal)."""
    import numpy as np
    import torch
    from repro_torch.core.backend import sparsify, to_device
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.gram.ref import scaled_err
    from repro_torch.kernels.spmm import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
    m, tail = 100_000 // scale, 6784 // scale
    # (kernel, rows, cols, v/W columns, pattern)
    cases = [("gram_bs", m, 1000, 0, BLOCKY), ("gram_bs", m, 1000, 0, UNIFORM),
             ("gram_bs", tail, 1000, 0, BLOCKY),
             ("xtv_bs", m, 1000, 1, BLOCKY), ("xtv_bs", m, 2000, 1, BLOCKY_WIDE),
             ("xtv_bs", tail, 1000, 1, BLOCKY),
             ("spmm", m, 2000, 1, BLOCKY_WIDE), ("spmm", tail, 1000, 1, BLOCKY)]
    main = {}
    rng = np.random.default_rng(SEED)
    for kind, rows, cols, c, pattern in cases:
        xh, _ = blocky(rng, rows, cols, *pattern)
        xs = to_device(sparsify(xh), DEVICE)
        del xh
        xd = xs.todense()
        mask = ops.block_mask_from_indices(xs)
        if not torch.equal(mask, ref.block_mask(xd, ops.ROWS, ops.TILE)):
            raise AssertionError(f"{kind}: the mask from the indices "
                                 "differs from the dense block counts")
        ones = torch.ones_like(mask)
        zero_share = float((mask == 0).float().mean().item())
        nnz = int(mask.sum().item())
        pair_skip = None
        if kind == "gram_bs":
            pop = (mask > 0).double()
            pairs = pop.shape[1] * (pop.shape[1] + 1) / 2 * pop.shape[0]
            both = ((pop.sum(1) * (pop.sum(1) + 1)) / 2).sum().item()
            pair_skip = 1 - both / pairs
        other = torch.from_numpy(rng.standard_normal(
            (rows if kind == "xtv_bs" else cols, max(c, 1)))).to(DEVICE)
        densify_ms = cuda_ms(xs.todense, iters=5)
        mask_ms = cuda_ms(lambda: ops.block_mask_from_indices(xs), iters=5)
        for name, dtype in dt.items():
            x = xd.to(dtype)
            if kind == "gram_bs":
                kern = lambda mk, x=x: ops.gram_bs_cuda(x, mk)
                plain = lambda x=x: ref.gram(x, mask, ops.ROWS, ops.TILE)
                lib = lambda x=x: torch.matmul(x.mT, x)
                unmasked = lambda x=x: gops.gram_cuda(x)
                a, b = x, x
            else:
                w = other.to(dtype)
                if kind == "xtv_bs":
                    kern = lambda mk, x=x, w=w: ops.xtv_bs_cuda(x, w, mk)
                    plain = lambda x=x, w=w: ref.xtv(x, w, mask, ops.ROWS,
                                                     ops.TILE)
                    lib = lambda x=x, w=w: torch.matmul(x.mT, w)
                    unmasked = lambda x=x, w=w: gops.xtv_cuda(x, w)
                    a, b = x, w
                else:
                    kern = lambda mk, x=x, w=w: ops.spmm_cuda(x, w, mk)
                    plain = lambda x=x, w=w: ref.spmm(x, w, mask, ops.ROWS,
                                                      ops.TILE)
                    lib = lambda x=x, w=w: torch.matmul(x, w)
                    unmasked = None  # no dense port kernel: matmul is torch's
                    a, b = x.mT, w
            saved = dict(ops.LAUNCHES), dict(gops.LAUNCHES)
            got, want = kern(mask), plain()
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            scaled = scaled_err(got, want, a, b)
            checks = dict(tol=scaled <= TOL[name],
                          all_ones_bitwise=torch.equal(got, kern(ones)),
                          repeat_bitwise=torch.equal(got, kern(mask)))
            if kind == "gram_bs":
                checks["symmetric_bitwise"] = torch.equal(got, got.mT)
            ms = cuda_ms(lambda: kern(mask))
            _, _, dev_s, _ = device_trace(
                lambda: [kern(mask) for _ in range(10)])
            # the same X through the dense port kernel, which masks nothing
            unmasked_ms = None if unmasked is None else cuda_ms(unmasked)
            ops.LAUNCHES.update(saved[0])  # these launches are not the path's
            gops.LAUNCHES.update(saved[1])
            plain_ms = cuda_ms(plain)
            library_ms = cuda_ms(lib)
            row = dict(phase="sparse_kernel", kernel=kind, m=rows, n=cols,
                       c=c or None, pattern=dict(p_block=pattern[0],
                                                 p_in=pattern[1]),
                       density=nnz / (rows * cols),
                       dtype=name, max_abs_err=err, scaled_err=scaled,
                       tol=TOL[name], checks=checks, ok=all(checks.values()),
                       skipped_tile_share=zero_share,
                       skipped_pair_share=pair_skip, ms=ms,
                       device_ms=None if dev_s is None else 100 * dev_s,
                       plain_ms=plain_ms, library_ms=library_ms,
                       unmasked_kernel_ms=unmasked_ms,
                       **sparse_bounds(kind, mask, rows, cols, max(c, 1),
                                       name, peaks))
            if name == "float64":
                row.update(densify_ms=densify_ms, mask_ms=mask_ms)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"{kind} {rows}x{cols} {name} failed "
                                     f"its checks: {row}")
            if name == "float64" and rows == m and pattern != UNIFORM \
                    and kind not in main:
                main[kind] = row
        del xs, xd, mask, ones, other
        torch.cuda.empty_cache()
    return main


def phase_sparse_lm(scale: int = 1) -> dict:
    """The bcoo lane end to end through lm / lmCG (`scale` divides the
    rows, for a rehearsal). Returns the kernels' launches per path."""
    import numpy as np
    import torch
    from repro_torch.core import (LineageRuntime, ReuseCache, clear_jit_cache,
                                  costmodel, get_jit_cache, input_tensor)
    from repro_torch.core.backend import _bucket_nse, sparsify
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.lifecycle import lm, lmCG
    reg = 1e-7
    rng = np.random.default_rng(SEED)
    jc = get_jit_cache().stats

    def reset():
        gops.reset_launches()
        sops.reset_launches()
        torch.cuda.synchronize()

    def launches():
        return {**{k: v for k, v in sops.LAUNCHES.items()},
                "gram": gops.LAUNCHES["gram"], "xtv": gops.LAUNCHES["xtv"]}

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    def data(m, n, pattern):
        xh, keep = blocky(rng, m, n, *pattern)
        yh = (xh @ rng.standard_normal((n, 1))
              + 0.1 * rng.standard_normal((m, 1)))
        return xh, keep, yh, float(np.count_nonzero(xh)) / xh.size

    by_path = {}

    # ---- lm -> lmDS, in memory -------------------------------------------
    m, n = 100_000 // scale, 1_000
    xh, keep, yh, density = data(m, n, BLOCKY)
    want = np.linalg.solve(blocky_gram(xh, keep) + reg * np.eye(n),
                           xh.T @ yh)

    def fit(rt):
        X = input_tensor("X", xh, sparsity=density)
        y = input_tensor("y", yh)
        h0 = rt.cache.stats.hits
        reset()
        t0 = time.perf_counter()
        beta = lm(X, y, reg=reg, runtime=rt)
        return beta, dict(wall_s=time.perf_counter() - t0,
                          rel_err=rel(beta, want), launches=launches(),
                          cache_hits=rt.cache.stats.hits - h0)

    rt = LineageRuntime(cache=ReuseCache(), sparse_inputs=True)
    beta, cold = fit(rt)                 # the path: counts set to 0 inside
    _, warm = fit(rt)
    beta_interp, interp = fit(LineageRuntime(cache=ReuseCache(),
                                             sparse_inputs=True, fuse=False))
    beta_dense, dense = fit(LineageRuntime(cache=ReuseCache()))
    _, trace_wall, busy, by_name = device_trace(
        lambda: fit(LineageRuntime(cache=ReuseCache(), sparse_inputs=True)))
    t0 = time.perf_counter()
    sparsify(xh)  # the host conversion every bind of X repeats
    sparsify_s = time.perf_counter() - t0
    row = dict(phase="sparse_lm", path="sparse_lmds", shape=[m, n],
               density=density, reg=reg, sparsify_s=sparsify_s,
               cold=cold, warm=warm,
               fuse_false=interp, dense_lane=dense,
               rel_to_dense_lane=rel(beta, beta_dense),
               fuse_bitwise=bool(np.array_equal(beta, beta_interp)),
               traced=_traced(trace_wall, busy, by_name))
    emit(row)
    lc, lw = cold["launches"], warm["launches"]
    if not (cold["rel_err"] <= 1e-9 and row["rel_to_dense_lane"] <= 1e-10
            and row["fuse_bitwise"] and lc["gram_bs"] == lc["xtv_bs"] == 1
            and lc["gram"] == lc["xtv"] == lc["spmm"] == 0
            and warm["cache_hits"] >= 2 and not any(lw.values())
            and interp["launches"]["gram_bs"] == 1
            and dense["launches"]["gram"] == 1):
        raise AssertionError(f"sparse lmDS failed: {row}")
    by_path["sparse_lmds"] = lc
    del xh, keep, yh

    # ---- lm's CG branch (n > 1024): lmCG, 20 iterations ------------------
    m, n, iters = 100_000 // scale, 2_000, 20
    xh, keep, yh, density = data(m, n, BLOCKY_WIDE)
    xty = xh.T @ yh

    def cg(rt):
        X = input_tensor("X", xh, sparsity=density)
        y = input_tensor("y", yh)
        calls = [0]
        run = rt.evaluate

        def counted(outputs):
            calls[0] += 1
            return run(outputs)
        rt.evaluate = counted
        reset()
        t0 = time.perf_counter()
        beta = lmCG(X, y, reg=reg, max_iter=iters, runtime=rt)
        return beta, dict(wall_s=time.perf_counter() - t0,
                          iterations=calls[0] - 1, launches=launches())

    rt = LineageRuntime(sparse_inputs=True)
    X = input_tensor("X", xh, sparsity=density)
    r0 = rt.evaluate([X.T @ input_tensor("y", yh)])[0]
    r0_err = float(np.max(np.abs(r0 - xty)) / np.max(np.abs(xty)))
    beta_s, sparse = cg(rt)              # the path
    beta_d, dense = cg(LineageRuntime())
    ls = sparse["launches"]
    row = dict(phase="sparse_lm", path="sparse_lmcg", shape=[m, n],
               density=density, reg=reg, max_iter=iters, sparse=sparse,
               dense_lane=dense, xty_rel_err=r0_err,
               rel_to_dense_lane=rel(beta_s, beta_d))
    emit(row)
    k = sparse["iterations"]
    if not (k == dense["iterations"] == iters and r0_err <= 1e-12
            and row["rel_to_dense_lane"] <= 1e-9
            and ls["spmm"] == k and ls["xtv_bs"] == 1 + k
            and ls["gram"] == ls["xtv"] == ls["gram_bs"] == 0
            and dense["launches"]["xtv"] == 1 + k):
        raise AssertionError(f"sparse lmCG failed: {row}")
    by_path["sparse_lmcg"] = ls
    del xh, keep, yh, X

    # ---- lmDS streamed in bcoo buckets -----------------------------------
    m, n = 400_000 // scale, 1_000
    xh, keep, yh, density = data(m, n, BLOCKY)
    nnz = np.count_nonzero(xh)
    # the runtime's own sizing: bcoo X at 2 nnz/row (data + 2 int32), y dense
    c = costmodel.chunk_rows(2.0 * nnz / m * 16 + 8)
    buckets = -(-m // c)
    sigs = set()
    for s0 in range(0, m, c):
        rows = min(c, m - s0)
        sigs.add((rows, min(_bucket_nse(int(np.count_nonzero(
            xh[s0:s0 + rows]))), rows * n)))
    want = np.linalg.solve(blocky_gram(xh, keep) + reg * np.eye(n),
                           xh.T @ yh)

    def stream(rt):
        X = input_tensor("X", xh, sparsity=density)
        y = input_tensor("y", yh)
        s0, t0s = rt.stats.streaming.as_dict(), rt.stats.streaming.spans()
        reset()
        t0 = time.perf_counter()
        beta = lm(X, y, reg=reg, runtime=rt)
        return dict(wall_s=time.perf_counter() - t0, rel_err=rel(beta, want),
                    launches=launches(),
                    streaming={k: v - s0[k] for k, v in
                               rt.stats.streaming.as_dict().items()
                               if k != "peak_live_bytes"},
                    spans={k: v - t0s[k] for k, v in
                           rt.stats.streaming.spans().items()})

    clear_jit_cache()
    m0 = jc.misses
    rt = LineageRuntime(cache=ReuseCache(), sparse_inputs=True)
    cold = stream(rt)                    # the path
    cold["rebuilds"] = jc.misses - m0
    bcoo_builds = sum(1 for _, sig in get_jit_cache().keys()
                      if any(a[0] == "bcoo" for a in sig))
    warm = stream(rt)
    _, trace_wall, busy, by_name = device_trace(
        lambda: stream(LineageRuntime(cache=ReuseCache(), sparse_inputs=True)))
    row = dict(phase="sparse_lm", path="sparse_stream", shape=[m, n],
               density=density, reg=reg, bucket_rows=c, buckets=buckets,
               bucket_signatures=sorted(sigs), bcoo_closure_builds=bcoo_builds,
               cold=cold, warm=warm, traced=_traced(trace_wall, busy, by_name))
    emit(row)
    lc = cold["launches"]
    want_buckets = 13 if scale == 1 else buckets
    if not (buckets == want_buckets and cold["streaming"]["chunks"] == buckets
            and lc["gram_bs"] == lc["xtv_bs"] == buckets
            and lc["gram"] == lc["xtv"] == 0 and cold["rel_err"] <= 1e-9
            and bcoo_builds == len(sigs)
            and warm["streaming"]["full_hits"] == 1
            and not any(warm["launches"].values())):
        raise AssertionError(f"sparse streamed lmDS failed: {row}")
    by_path["sparse_stream"] = lc
    return by_path


# ---------------------------------------------------------------------------
# the dense LM family: flash attention and serving
# ---------------------------------------------------------------------------

# (name, B, Sq, Sk, Hq, Hkv, hd, causal, dtype); the first is the path's
FLASH_CASES = [
    ("qwen3-0.6b", 8, 2048, 2048, 16, 8, 128, True, "bfloat16"),
    ("llama3.2-1b", 8, 2048, 2048, 32, 8, 64, True, "bfloat16"),
    ("ragged-1000", 8, 1000, 1000, 16, 8, 128, True, "bfloat16"),
    ("ragged-17", 8, 17, 17, 16, 8, 128, True, "bfloat16"),
    ("non-causal", 8, 2048, 1024, 16, 8, 128, False, "bfloat16"),
    ("qwen3-0.6b-f32", 8, 2048, 2048, 16, 8, 128, True, "float32"),
]


def flash_bound(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
                causal: bool, dtype: str, peaks: dict) -> tuple[float, str]:
    """Least time for one attention call: the visible (q, k) pairs each
    take 2·hd operations for QKᵀ and 2·hd for PV; q, k, v read once and
    the output written once."""
    size = {"float32": 4, "bfloat16": 2}[dtype]
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    ops = 4.0 * hd * pairs * B * Hq
    nbytes = (2 * B * Sq * Hq * hd + 2 * B * Sk * Hkv * hd) * size
    t_ops, t_bytes = ops / peaks[dtype], nbytes / peaks["bw"]
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_flash_kernels(peaks: dict, cases=FLASH_CASES) -> dict:
    """The flash kernel against its plain version at the serving path's
    shapes; returns the path's row (the first case)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    main = None
    for name, B, Sq, Sk, Hq, Hkv, hd, causal, dtype in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE
                               ).to(dt[dtype])
                   for shape in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                                 (B, Sk, Hkv, hd)))
        saved = dict(ops.LAUNCHES)  # these launches are not the path's
        got = ops.flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = ref.attention(q.float(), k.float(), v.float(), causal=causal)
        err = (got.float() - want).abs().max().item()
        scaled = ref.scaled_err(got, want, q, k, v, causal=causal)
        del want
        checks = dict(
            tol=scaled <= FLASH_TOL[dtype],
            finite=bool(torch.isfinite(got).all().item()),
            repeat_bitwise=torch.equal(
                got, ops.flash_attention_cuda(q, k, v, causal=causal)))
        kern = lambda: ops.flash_attention_cuda(q, k, v, causal=causal)
        ms = cuda_ms(kern)
        _, _, dev_s, _ = device_trace(lambda: [kern() for _ in range(10)])
        ops.LAUNCHES.update(saved)
        plain_ms = cuda_ms(lambda: ref.attention(q, k, v, causal=causal),
                           iters=5)
        # the yardstick: one library call on (B, H, S, hd) copies
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        del qt, kt, vt
        bms, by = flash_bound(B, Sq, Sk, Hq, Hkv, hd, causal, dtype, peaks)
        row = dict(phase="flash_kernel", case=name, B=B, Sq=Sq, Sk=Sk, Hq=Hq,
                   Hkv=Hkv, hd=hd, causal=causal, dtype=dtype,
                   max_abs_err=err, scaled_err=scaled,
                   tol=FLASH_TOL[dtype], checks=checks,
                   ok=all(checks.values()), ms=ms,
                   device_ms=None if dev_s is None else 100 * dev_s,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
                   bound_by=by)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"flash {name} failed its checks: {row}")
        if main is None:
            main = row
        del q, k, v, got
        torch.cuda.empty_cache()
    return main


@contextlib.contextmanager
def _probed_steps():
    """Wrap the step functions `launch.serve.generate` makes, so each of
    its own steps notes the flash launches it made and CUDA events around
    it; yields the list of (kind, launches, start event, end event)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import serve
    makers = serve.make_prefill_step, serve.make_decode_step
    log = []

    def probe(kind, step):
        def run(*args):
            n0 = fops.LAUNCHES["flash"]
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(*args)
            e1.record()
            log.append((kind, fops.LAUNCHES["flash"] - n0, e0, e1))
            return out
        return run

    serve.make_prefill_step = \
        lambda *a, **kw: probe("prefill", makers[0](*a, **kw))
    serve.make_decode_step = \
        lambda *a, **kw: probe("decode", makers[1](*a, **kw))
    try:
        yield log
    finally:
        serve.make_prefill_step, serve.make_decode_step = makers


@contextlib.contextmanager
def _prefill_attention(fn):
    """Prefill attention computed by `fn(q, k, v)` inside the block: the
    plain route and the planted faults the kernel route is held against
    (the port has no option for this; decode is untouched)."""
    from repro_torch.models import attention as attn_mod
    core = attn_mod.attention_core
    attn_mod.attention_core = lambda q, k, v, **_: fn(q, k, v)
    try:
        yield
    finally:
        attn_mod.attention_core = core


def _masked_attention(mask_of):
    """Plain attention (the reference's formula) under the (Sq, Sk) mask
    `mask_of(S, device)` in place of the causal one."""
    import torch

    def attend(q, k, v):
        B, S, Hq, hd = q.shape
        Hkv = k.shape[2]
        qg = q.reshape(B, S, Hkv, Hq // Hkv, hd) * float(hd ** -0.5)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
        s = torch.where(mask_of(S, q.device), s, -1e30)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(B, S, Hq, hd)
    return attend


def _shifted_mask(S, device):
    """Off by one: each query also sees the next key."""
    import torch
    pos = torch.arange(S, device=device)
    return pos[:, None] + 1 >= pos[None, :]


def _late_block_dropped(S, device):
    """Causal, but the last 64 queries miss the 64 keys from S/2 on: one kv
    block of the kernel's last q tile."""
    import torch
    pos = torch.arange(S, device=device)
    lost = ((pos[:, None] >= S - 64) & (pos[None, :] >= S // 2)
            & (pos[None, :] < S // 2 + 64))
    return (pos[:, None] >= pos[None, :]) & ~lost


def phase_lm_serve(peaks: dict, cfg=None, batch: int = 8, prompt: int = 2048,
                   new: int = 32) -> dict:
    """The dense LM family served at qwen3-0.6b's full width (`cfg` and the
    sizes may be cut for a rehearsal). Returns the flash launches of the
    main path, by step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.attention import ref_attention
    cfg = cfg or get_config("qwen3-0.6b")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE).init(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    max_len = prompt + new
    generate(model, prompts[:, :64], max_new=2, max_len=66)  # warm cuBLAS

    # the main path: counts set to 0 just before, read just after; its own
    # steps note their launches and times
    with _probed_steps() as steps:
        fops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, prompts, max_new=new, max_len=max_len)
        wall = time.perf_counter() - t0
        launches = fops.LAUNCHES["flash"]
    peak_bytes = torch.cuda.max_memory_allocated()
    prefills = [st for st in steps if st[0] == "prefill"]
    decodes = [st for st in steps if st[0] == "decode"]
    prefill_launches = sum(st[1] for st in prefills)
    decode_launches = sum(st[1] for st in decodes)
    prefill_ms = prefills[0][2].elapsed_time(prefills[0][3])
    decode_ms = decodes[0][2].elapsed_time(decodes[-1][3]) / len(decodes)

    # teacher-forced decode against a full prefill (the reference's
    # test_decode_matches_prefill, at full width and in bf16)
    tokens = torch.from_numpy(prompts).to(dev)
    n0 = prompt - 16
    full, _ = model.prefill(tokens, max_len=prompt)
    tf, cache = model.prefill(tokens[:, :n0], max_len=prompt)
    for t in range(n0, prompt):
        tf, cache = model.decode_step(tokens[:, t:t + 1], cache, t)
    del cache
    finite = bool(torch.isfinite(full).all().item())
    scale = full.float().abs().max().item()
    tf_err = (tf.float() - full.float()).abs().max().item() / scale
    del tf

    # the kernel route against the plain attention on the card, and against
    # planted faults: last-position logits over max|logit|, and the final
    # hidden state of every position, each row over its own max
    h_kernel = model(tokens)[0]

    def route(fn):
        with _prefill_attention(fn):
            h = model(tokens)[0]
            logits, _ = model.prefill(tokens, max_len=prompt)
        row_err = ((h.float() - h_kernel.float()).abs().amax(-1)
                   / h_kernel.float().abs().amax(-1).clamp_min(1e-30))
        return dict(
            logits_rel_err=(logits.float() - full.float()).abs().max().item()
            / scale,
            hidden_rel_err=row_err.max().item(),
            argmax_agree=float((logits.argmax(-1) == full.argmax(-1))
                               .float().mean().item()))
    plain = route(lambda q, k, v: ref_attention(q, k, v, causal=True))
    controls = {name: route(_masked_attention(mask)) for name, mask in
                (("mask_shifted", _shifted_mask),
                 ("late_block_dropped", _late_block_dropped))}
    del full, h_kernel
    torch.cuda.empty_cache()
    fops.reset_launches()

    # the card's busy and idle share over the main path once more, traced
    _, trace_wall, busy, by_name = device_trace(
        lambda: generate(model, prompts, max_new=new, max_len=max_len))
    fops.reset_launches()

    # least times: every weight read once per step (bf16) plus the KV
    # cache; prefill's products at the bf16 peak
    D, L = cfg.d_model, cfg.n_layers
    per_layer = (cfg.param_counts()["attn_per_layer"]
                 + cfg.param_counts()["mlp_per_layer"])
    kv_bytes = 2 * L * batch * max_len * cfg.kv_heads * cfg.head_dim * 2
    decode_bound_ms = 1e3 * ((per_layer * L + D * cfg.vocab_size) * 2
                             + kv_bytes) / peaks["bw"]
    attn_ops = 4.0 * cfg.head_dim * cfg.n_heads * batch * L \
        * prompt * (prompt + 1) / 2
    prefill_bound_ms = 1e3 * (2.0 * per_layer * L * batch * prompt
                              + attn_ops + 2.0 * D * cfg.vocab_size * batch
                              ) / peaks["bfloat16"]
    row = dict(phase="lm_serve", arch=cfg.name, n_params=model.n_params(),
               dtype=cfg.dtype, batch=batch, prompt=prompt, new_tokens=new,
               max_len=max_len, init_s=init_s, generate_wall_s=wall,
               tokens_per_s=batch * new / wall,
               flash_launches=dict(generate=launches,
                                   prefill=prefill_launches,
                                   decode=decode_launches),
               steps=dict(prefill=len(prefills), decode=len(decodes)),
               prefill_ms=prefill_ms, prefill_bound_ms=prefill_bound_ms,
               decode_ms_per_token=decode_ms,
               decode_bound_ms=decode_bound_ms,
               peak_memory_gb=peak_bytes / 1e9, logits_finite=finite,
               tokens_in_vocab=bool(0 <= toks.min()
                                    and toks.max() < cfg.vocab_size),
               teacher_forced_rel_err=tf_err, kernel_vs_plain=plain,
               planted_faults=controls, tol=SERVE_TOL,
               hidden_tol=HIDDEN_TOL,
               traced=_traced(trace_wall, busy, by_name))
    emit(row)
    caught = all(c["logits_rel_err"] > SERVE_TOL
                 and c["hidden_rel_err"] > HIDDEN_TOL
                 for c in controls.values())
    if not (launches == prefill_launches == L and decode_launches == 0
            and len(prefills) == 1 and len(decodes) == new - 1
            and finite and row["tokens_in_vocab"]
            and toks.shape == (batch, new) and tf_err <= SERVE_TOL
            and plain["logits_rel_err"] <= SERVE_TOL
            and plain["hidden_rel_err"] <= HIDDEN_TOL and caught):
        raise AssertionError(f"lm_serve failed: {row}")
    del model
    torch.cuda.empty_cache()
    return row["flash_launches"]


def _traced(wall: float, busy, by_name: dict) -> dict:
    return dict(wall_s=wall, device_busy_s=busy,
                idle_share=None if busy is None else 1 - busy / wall,
                top_device_s=dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:6]))


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
    sources = ("gram", "spmm", "flash")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        built = dict(zip(sources, pool.map(build.build, sources)))
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=built,
              ptxas={src: [ln.strip() for ln in
                           build.build_log(src).splitlines()
                           if "registers" in ln or "spill" in ln]
                     for src in sources}))

    main_rows = phase_kernels(peaks)
    sparse_rows = phase_sparse_kernels(peaks)
    flash_row = phase_flash_kernels(peaks)
    phase_quickstart()
    launches = phase_lmds()
    phase_steplm()
    sparse_launches = phase_sparse_lm()
    serve_launches = phase_lm_serve(peaks)

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
    for kind, line in (("gram_bs", 63), ("spmm", 112), ("xtv_bs", 158)):
        r = sparse_rows[kind]
        by_path = {p: v[kind] for p, v in sparse_launches.items() if v[kind]}
        kernels.append(dict(
            name=kind, route="cuda", source="src/repro_torch/csrc/spmm.cu",
            replaces=f"src/repro/kernels/spmm/kernel.py:{line}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            reduce_launches=sum(v.get(f"{kind}_reduce", 0)
                                for v in sparse_launches.values()),
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            bound_dense_ms=r["bound_dense_ms"], library_ms=r["library_ms"]))
    r = flash_row
    kernels.append(dict(
        name="flash", route="cuda", source="src/repro_torch/csrc/flash.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:83",
        launches=serve_launches["generate"],
        launches_by_path=dict(lm_serve_prefill=serve_launches["prefill"],
                              lm_serve_decode=serve_launches["decode"]),
        max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"]))
    emit(dict(kernels=kernels))
    print(smi, flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=name,
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
