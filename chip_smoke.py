#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main path through the entry points a user calls and
holds every hand-written kernel against its plain PyTorch version on the
card. One JSON line per phase:

  1. device        — the card (and `nvidia-smi`'s name and power limit)
  2. build         — compile `src/repro_torch/csrc/*.cu` (gram, spmm,
                     flash, wkv6, ssd; gram and spmm share
                     gram_mainloop.cuh) for sm_90a, one `nvcc` per source,
                     all started together; the bf16 flash instantiations,
                     gram's float64 and bf16 partial kernels, every WKV6
                     state and output kernel, every selective-scan kernel
                     and every kernel of spmm.cu (gram_bs, xtv_bs, spmm
                     and their reduce passes) must spill nothing
                     (ptxas's report)
  3. kernel        — gram/xtv against the plain version at the path's
                     shapes in float64/float32/bfloat16 (and a column slice
                     at an offset, an odd width), bitwise repeatable, gram
                     bitwise symmetric, with kernel, plain, library (one
                     torch.matmul, a yardstick the port never calls) and
                     bound times and the wrapper's host time (`host_us`)
  4. sparse_kernel — the block-sparse gram_bs/xtv_bs/spmm kernels against
                     their plain version at the bcoo paths' shapes (blocky,
                     uniform, a sparse_stream bucket and its ragged tail),
                     bitwise against the same kernel with an all-ones mask
                     and against a second call, with times and bounds over
                     the dense layout and over the populated blocks, the
                     plans and (xtv_bs, spmm) the wrapper's host time
  5. flash_kernel  — the flash-attention kernel against its plain version
                     computed in float32 from the same inputs, each entry
                     within a bound of its own envelope, at the
                     serving path's shapes (qwen3-0.6b, llama3.2-1b and
                     jamba-v0.1-52b heads, ragged prompts, non-causal,
                     float32), bitwise
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
                     numpy and the dense lane, launch counts, reuse; each
                     lmDS fit's peak device memory; the kernels' device
                     time in a traced fit of its own
 10. lm_serve      — the dense LM family served at qwen3-0.6b's full width
                     (28 layers, bf16, seeded weights): `generate` for a
                     batch of 8 2,048-token prompts and 32 greedy tokens,
                     its own steps read for launches (one flash launch per
                     layer in prefill, none in decode) and times, then the
                     same prefill once more, warm (each serving phase);
                     teacher-forced decode against prefill logits, kernel
                     against plain attention and against two planted
                     faults; tokens/s, peak memory, a traced idle share
 11. wkv6_kernel   — (run first after the build) the WKV6 kernel (a
                     state pass and an output pass per
                     call) against its plain version (wkv_chunked)
                     computed in float32 from the same inputs, each y and
                     state entry within a bound of its own envelope:
                     rwkv6-3b's prefill shape (B 8, S 2,048, 40 heads of
                     64, chunk 128) in bf16 and float32, ragged S 1,000,
                     17 and 129 (a one-row last chunk), one 16,384-token
                     prompt, dh 32, extreme (≡ -5) and slow (~-1e-4)
                     decay, a nonzero initial state; bitwise repeatable;
                     kernel, plain and bound times, the bound at the TF32
                     tensor-core rate (no single PyTorch call computes
                     WKV6: no library time)
 12. rwkv_serve    — the ssm family served at rwkv6-3b's full width and
                     depth (32 layers, bf16, seeded weights), the same
                     traffic as lm_serve: 32 wkv6 launches in prefill, none
                     in decode; each layer's kernel call on its served
                     inputs against the plain WKV, and the routes' split
                     layer by layer against a kernel-free float64 route;
                     teacher-forced decode from the kernel's final state,
                     kernel against plain WKV and against two planted
                     faults (the state zeroed 4 positions before the end,
                     the decay off by one position); tokens/s, peak
                     memory, a traced idle share
 13. ssm_kernel    — the selective-scan kernel against its plain version
                     (ssm_scan) computed in float32 from the same inputs,
                     each y and h entry within a bound of its own envelope:
                     jamba's prefill shape (B 8, S 2,048, di 8,192, ds 16)
                     in bf16 and float32, ragged S 1,000 and 17, ds 8, a
                     nonzero initial state, a large dt (dA underflows to 0)
                     and a tiny one (slow decay) over 2,048 steps and over
                     16,384; bitwise repeatable;
                     kernel, plain and bound times (no single PyTorch call
                     computes the scan: no library time)
 14. hybrid_serve  — the hybrid family served at jamba-v0.1-52b's full
                     width, its depth cut to one period (8 layers: 7 Mamba,
                     1 attention, MoE 16 experts top-2 on every second;
                     bf16, seeded weights), lm_serve's traffic: 7 ssm_scan
                     and 1 flash launches in prefill, none in decode; each
                     layer's scan call on its served inputs against the
                     plain version; teacher-forced decode, the kernel route
                     against the plain scan and against two planted faults
                     (the state zeroed 4 positions before the end, the D
                     skip dropped), each with the kernel route's MoE
                     routing replayed and the routing flips counted;
                     tokens/s, peak memory, a traced idle share
 15. kernel (batched) — gram and xtv under torch.func.vmap: one batched
                     launch (and its reduce) over CV's fold stack (8,
                     12,500, 1,000) in float64/float32/bfloat16, xtv also
                     with one v for the batch and with one X (the batch
                     folded into v's columns); against 8 lone calls and
                     the plain version in float64, bitwise repeatable,
                     with device, bound, lone-calls' and torch.bmm times
 16. algorithms    — pca (k 10), kmeans (k 8), l2svm and mlogreg (10
                     classes) at 100,000 x 1,000 float64 on the card, each
                     against the same call on the CPU; pca's lane; wall
                     time per iteration and its host-to-device share
                     (max_iter cut to 10)
 17. cleaning      — every cleaning builtin on 100,000 x 1,000 with 1 %
                     NaNs against numpy's nan-aware functions (mice_lite
                     on 8 columns, against the CPU)
 18. rand          — a 100,000 x 1,000 sparse normal draw through the
                     runtime on the card, bitwise against the CPU's draw
                     of three row blocks
 19. grid_search   — grid_search_lm over 70 λs at 100,000 x 1,000 (Fig.
                     5): auto (its mode), forced vmap and sequential with
                     reuse, against each other and numpy's solve
 20. cv            — cross_validate_lm over 8 folds of 100,000 x 1,000
                     (Fig. 7): vmap (the fold products as batched
                     launches) against sequential with reuse; peak device
                     and host memory
 21. lifecycle_pipeline — examples/lifecycle_pipeline.py at 1,000,000
                     rows (the example's columns, rates and seed; a ~40 MB
                     raw CSV): the generated reader, schema detection,
                     outlier clipping and imputation, transformencode,
                     steplm (5 features), the 12-λ grid and 5-fold CV
                     (sequential with reuse), the β checkpointed and
                     restored onto the card; against the same run on the
                     CPU: the same features and reuse hits, betas and CV
                     errors within rtol 1e-9, the restored β bitwise;
                     seconds per stage, parse rows/s, gram/xtv launches
 22. csv_stream    — 100,000 x 200 float64 (199 features and y) written
                     at %.17g, read by read_csv_chunks in 8,192-row
                     chunks, each uploaded into the gram/xtv calls the
                     streaming lane makes per bucket, summed in row order
                     and solved: within rel 1e-9 of numpy's solve and of
                     lmDS on the assembled array; the first 16,384 rows
                     read again with chunk_io@0,1 injected: the same β
                     bitwise, 2 injected and 2 retries; parse MB/s and
                     the card's seconds
 23. serve_plan    — examples/serve_plan.py at the lmds point: lmDS on
                     100,000 x 1,000 float64 (streamed), x (1, 1,000) ->
                     (x β, sigmoid(x β)) behind ModelServer(max_batch 16,
                     max_wait_us 2,000): deploy (buckets 2-16 warmed and
                     pinned), 256 requests one after another and 256 from
                     16 threads, each bitwise the solo score and within
                     1e-12 of numpy, 0 retraces; a (16, 1,000) request;
                     serving_dispatch@0 restarts the coalescer once and
                     fails only its batch; p50/p99 latency, requests/s,
                     mean coalesce, padded lanes
 24. kernels       — the summary line of every ported kernel (the
                     block-sparse ones at the shape of most of their
                     launches, with launches x (device ms - bound ms) by
                     path; gram and xtv also batched, with their
                     launches on the CV path)

then the card line of `nvidia-smi` and, last, the contract line
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero;
without CUDA (or outside a checkout) it exits non-zero before printing a
result. Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
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
# WKV6 kernel against its plain version (wkv_chunked) computed in float32
# from the same inputs, per y and state entry over its envelope (the same
# recurrence on |r|, |k|, |v|, |u|, |state|; rwkv6 ref.scaled_err). The
# float32 kernel's products are 3xTF32 (float32-accurate), so it differs in
# summation order and in the rounding of the cumulative log-decays only (a
# chunked float32 sum reads <= 2.1e-5 against a float64 scan on the CPU);
# the bf16 kernel rounds each product's operands to TF32 once (an emulation
# of its algebra reads <= 4e-4 on the CPU) and y to bf16, at most 2^-9 of
# its envelope. tests/test_torch_rwkv6.py holds both roundings within these
# limits and a dropped sub-block pair, a decay off by one step and a state
# not carried across chunks >= 10x above them
WKV6_TOL = {"float32": 2.0 ** -12, "bfloat16": 2.0 ** -8 + 2.0 ** -12}
# rwkv6-3b's seeded weights checked in float32 along two sound routes (the
# WKV kernel vs the plain wkv_chunked; decode's wkv_step from the kernel's
# final state vs a full prefill): last-position logits over max|logit|
# (RWKV_SERVE_TOL) and every position's final hidden state, each row over
# its own max (RWKV_HIDDEN_TOL). The seeded model amplifies the rounding
# of y's row 0 (position 0, the bonus term alone) with depth: layer by
# layer on an H100, a kernel-free route (the per-step oracle in float64)
# splits from the plain route's residual stream from 5.1e-6 after layer 1
# to 0.195 after layer 32, and as far with only its row 0 swapped in,
# while the kernel route with the plain version's row 0 reaches 5.9e-4
# (0.387 without). So the hidden rows are held with row 0 pinned to the
# plain version on every route compared (each layer's kernel call holds
# row 0 within WKV6_TOL). Both limits lie between the sound route (1.6e-4
# on the logits, 5.9e-4 on the hidden rows) and the planted faults (the
# decay off by one 0.87 / 1.37, the state zeroed 4 positions before the
# end 1.36 / 1.68), on an H100; bf16 amplifies every row
# (0.42 between two kernel-free chunkings), so its end-to-end routes are
# recorded, not held. After the first layer, before depth amplifies, the
# kernel route's split must stay within RWKV_FIRST_LAYER_RATIO of the
# kernel-free route's (1.45 float32 / 0.99 bf16)
RWKV_SERVE_TOL = 1e-2
RWKV_HIDDEN_TOL = 1e-2
RWKV_FIRST_LAYER_RATIO = 4.0
# selective-scan kernel against its plain version (ssd ref.ssm_scan)
# computed in float32 from the same inputs, per y and h entry over its
# envelope (the same scan on |x|, |B|, |C|, |D|, |h0|; ssd ref.scaled_err):
# both read the same inputs (bf16 x, B, C convert exactly) and compute and
# write float32, so bf16 and float32 differ alike, in summation order, FMA
# contraction and expf's last bit only (a float32 scan reads <= 5e-6 of its
# envelope against a float64 one on the CPU, S 2,048 with a slow decay).
# tests/test_torch_ssd.py holds a dropped D skip, a state reset midway and
# a decay one step late >= 10x above it
SSM_TOL = 2.0 ** -14
# jamba cut to one period, bf16, along two sound routes (the scan kernel vs
# the plain ssm_scan; the prefill's kernel vs decode's plain
# selective_scan), the compared route's MoE routing replayed from the
# kernel route's: a rounding can flip a near-tied top-2 choice, which moves
# that token's whole row and, through the scans, its sequence's later
# positions (the flips are counted, the unpinned routes recorded).
# Last-position logits over max|logit| (HYBRID_SERVE_TOL) and every
# position's final hidden row over its own max (HYBRID_HIDDEN_TOL), as
# lm_serve's
HYBRID_SERVE_TOL = 5e-2
HYBRID_HIDDEN_TOL = 1e-1

# Published dense peaks (NVIDIA data sheets): FLOP/s by input dtype and
# memory bytes/s. float64 counts the FP64 tensor-core rate; float32 the
# non-tensor rate (TF32 is off for torch's products); bfloat16 and tf32
# the tensor-core rates (tf32 half the bf16 one)
PEAKS = {
    "H100 PCIe": dict(float64=51.2e12, float32=51.2e12, bfloat16=756e12,
                      tf32=378e12, bw=2.0e12),
    "H100 NVL": dict(float64=60e12, float32=60e12, bfloat16=835e12,
                     tf32=417.5e12, bw=3.9e12),
    "H100": dict(float64=67e12, float32=67e12, bfloat16=989e12,
                 tf32=494.7e12, bw=3.35e12),
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


def device_trace(fn, counts: dict | None = None):
    """Run `fn` once under `torch.profiler` (card activity only) and
    return (result, wall s, device-busy s or None, {kernel/copy name:
    device s}). Busy time is the union of the card's kernel and copy
    intervals; None when the profiler saw no device events. `counts`, if
    given, is filled with {kernel/copy name: number of events}."""
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
        if counts is not None:
            counts[e.name] = counts.get(e.name, 0) + 1
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


def per_call_ms(fn, calls: int = 10, tries: int = 3):
    """(card ms a call of `fn`, {kernel: ms a call}, {kernel: events})
    from a trace of `calls` calls: each kernel's mean event time times
    its events a call, so that a record the profiler drops does not lower
    the sum (late in a long run it was seen to drop some of a trace's
    records, or all of them); a trace that holds no device event is
    retaken, up to `tries` times. (None, {}, {}) if none holds one."""
    for _ in range(tries):
        counts: dict = {}
        _, _, busy, by_name = device_trace(
            lambda: [fn() for _ in range(calls)], counts)
        if busy is not None:
            per = {k: 1e3 * v / counts[k] * max(1, round(counts[k] / calls))
                   for k, v in by_name.items()}
            return sum(per.values()), per, counts
    return None, {}, {}


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


def host_us(fn, calls: int = 200) -> float:
    """Microseconds of host time per call of `fn`: `calls` back-to-back
    calls with no synchronise inside (the card runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


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
    # the streaming bucket, its ragged tail, the quickstart matrix; then
    # steplm's column slice at an offset (8-byte-aligned base, element
    # copies) and an odd width (8-byte-aligned rows)
    cases = [("gram", 8192, 1000, 0, 0), ("gram", 1696, 1000, 0, 0),
             ("gram", 5000, 64, 0, 0), ("xtv", 8192, 1000, 1, 0),
             ("xtv", 1696, 1000, 1, 0), ("xtv", 5000, 64, 1, 0),
             ("xtv", 8192, 1000, 3, 0), ("gram", 20000, 34, 0, 1),
             ("xtv", 20000, 34, 1, 1), ("gram", 3000, 1001, 0, 0),
             ("xtv", 3000, 1001, 3, 0)]
    main = {}
    for kind, m, n, c, offset in cases:
        host = from_reference(
            {"x": rng.standard_normal((m, n + offset)),
             "v": rng.standard_normal((m, max(c, 1)))}, "cuda")
        for name, dtype in dt.items():
            x = host["x"].to(dtype)[:, offset:]
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
            us = host_us(lambda: kern(*args))
            # the same call through the torch.library custom op the
            # backend takes under vmap (the dispatcher's cost on top)
            op_us = host_us(lambda: (ops.gram_op if kind == "gram"
                                     else ops.xtv_op)(*args))
            ops.LAUNCHES.update(saved)
            row = dict(phase="kernel", kernel=kind, m=m, n=n, c=c or None,
                       offset=offset or None, aligned16=ops.aligned16(x),
                       dtype=name, max_abs_err=err, scaled_err=scaled,
                       tol=TOL[name], ok=ok, ms=ms,
                       device_ms=None if dev_s is None else 100 * dev_s,
                       host_us=us, op_host_us=op_us, plain_ms=plain_ms,
                       library_ms=library_ms,
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
    paths' shapes (`scale` divides the rows, for a rehearsal). Returns the
    float64 rows of the paths' data by (kernel, rows, cols)."""
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
    bucket = 32_768 // scale  # a sparse_stream bucket (12 of them, + tail)
    # (kernel, rows, cols, v/W columns, pattern); every case draws its data
    # from one generator in list order, so a case added later goes last and
    # the earlier cases keep their data
    cases = [("gram_bs", m, 1000, 0, BLOCKY), ("gram_bs", m, 1000, 0, UNIFORM),
             ("gram_bs", tail, 1000, 0, BLOCKY),
             ("xtv_bs", m, 1000, 1, BLOCKY), ("xtv_bs", m, 2000, 1, BLOCKY_WIDE),
             ("xtv_bs", tail, 1000, 1, BLOCKY),
             ("spmm", m, 2000, 1, BLOCKY_WIDE), ("spmm", tail, 1000, 1, BLOCKY),
             ("gram_bs", bucket, 1000, 0, BLOCKY),
             ("xtv_bs", bucket, 1000, 1, BLOCKY)]
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
            sms = gops._sm_count(x.device)
            if kind == "gram_bs":  # (tile_n, splits, rows per split)
                row["plan"] = ops.gram_bs_plan(rows, cols, dtype, sms)
            else:  # the wrapper's host time a call
                row["host_us"] = host_us(lambda: kern(mask))
                ops.LAUNCHES.update(saved[0])
            if kind == "xtv_bs":  # splits
                row["plan"] = ops.xtv_bs_plan(rows, cols, max(c, 1), dtype,
                                              sms)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"{kind} {rows}x{cols} {name} failed "
                                     f"its checks: {row}")
            if name == "float64" and pattern != UNIFORM:
                main[(kind, rows, cols)] = row
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
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        beta = lm(X, y, reg=reg, runtime=rt)
        return beta, dict(wall_s=time.perf_counter() - t0,
                          rel_err=rel(beta, want), launches=launches(),
                          cache_hits=rt.cache.stats.hits - h0,
                          peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)

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
               gram_bs_device_ms=_device_ms(by_name, "gram_bs_",
                                            "gram_tile_reduce"),
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
    # a traced fit of its own: the kernels' device time
    _, trace_wall, busy, by_name = device_trace(
        lambda: cg(LineageRuntime(sparse_inputs=True)))
    ls = sparse["launches"]
    row = dict(phase="sparse_lm", path="sparse_lmcg", shape=[m, n],
               density=density, reg=reg, max_iter=iters, sparse=sparse,
               dense_lane=dense, xty_rel_err=r0_err,
               rel_to_dense_lane=rel(beta_s, beta_d),
               spmm_device_ms=_device_ms(by_name, "spmm_kernel"),
               xtv_bs_device_ms=_device_ms(by_name, "xtv_bs_partial",
                                           "xtv_reduce"),
               traced=_traced(trace_wall, busy, by_name))
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
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        beta = lm(X, y, reg=reg, runtime=rt)
        return dict(wall_s=time.perf_counter() - t0, rel_err=rel(beta, want),
                    launches=launches(),
                    peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
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
               cold=cold, warm=warm,
               gram_bs_device_ms_per_bucket=_device_ms(
                   by_name, "gram_bs_", "gram_tile_reduce") / buckets,
               traced=_traced(trace_wall, busy, by_name))
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
    ("jamba-v0.1-52b", 8, 2048, 2048, 32, 8, 128, True, "bfloat16"),
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
def _probed_steps(*counters):
    """Wrap the step functions `launch.serve.generate` makes, so each of
    its own steps notes the launches it made of each kernel in `counters`
    ((launch dict, key) pairs; flash's by default) and CUDA events around
    it; yields the list of (kind, {key: launches}, start event, end
    event)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import serve
    counters = counters or ((fops.LAUNCHES, "flash"),)
    makers = serve.make_prefill_step, serve.make_decode_step
    log = []

    def probe(kind, step):
        def run(*args):
            n0 = {key: launches[key] for launches, key in counters}
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(*args)
            e1.record()
            log.append((kind, {key: launches[key] - n0[key]
                               for launches, key in counters}, e0, e1))
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


def _warm_prefill_ms(model, tokens, max_len: int) -> float:
    """The main path's prefill is the first at its size and pays the
    caching allocator's first-use costs: the same prefill once more, warm,
    in CUDA-event milliseconds."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    model.prefill(tokens, max_len=max_len)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


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
    tile of one consumer warpgroup of the kernel's last q tile."""
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
    tokens = torch.from_numpy(prompts).to(dev)
    prefill_warm_ms = _warm_prefill_ms(model, tokens, max_len)
    prefills = [st for st in steps if st[0] == "prefill"]
    decodes = [st for st in steps if st[0] == "decode"]
    prefill_launches = sum(st[1]["flash"] for st in prefills)
    decode_launches = sum(st[1]["flash"] for st in decodes)
    prefill_ms = prefills[0][2].elapsed_time(prefills[0][3])
    decode_ms = decodes[0][2].elapsed_time(decodes[-1][3]) / len(decodes)

    # teacher-forced decode against a full prefill (the reference's
    # test_decode_matches_prefill, at full width and in bf16)
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
               prefill_ms=prefill_ms, prefill_warm_ms=prefill_warm_ms,
               prefill_bound_ms=prefill_bound_ms,
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
            and row["logits_finite"] and row["tokens_in_vocab"]
            and toks.shape == (batch, new) and tf_err <= SERVE_TOL
            and plain["logits_rel_err"] <= SERVE_TOL
            and plain["hidden_rel_err"] <= HIDDEN_TOL and caught):
        raise AssertionError(f"lm_serve failed: {row}")
    del model
    torch.cuda.empty_cache()
    return row["flash_launches"]


# ---------------------------------------------------------------------------
# the ssm family: the WKV6 kernel and RWKV-6 serving
# ---------------------------------------------------------------------------

# (name, B, S, H, dh, chunk, dtype, decay, state scale); the first is the
# path's (rwkv6-3b prefill: 40 heads of 64, chunk 128)
WKV6_CASES = [
    ("rwkv6-3b", 8, 2048, 40, 64, 128, "bfloat16", "mixed", 0.0),
    ("rwkv6-3b-f32", 8, 2048, 40, 64, 128, "float32", "mixed", 0.0),
    ("ragged-1000", 8, 1000, 40, 64, 128, "bfloat16", "mixed", 0.0),
    ("ragged-17", 8, 17, 40, 64, 128, "bfloat16", "mixed", 0.0),
    ("dh-32", 8, 2048, 4, 32, 16, "bfloat16", "mixed", 0.0),
    ("extreme-decay", 2, 2048, 8, 64, 128, "float32", "extreme", 0.0),
    ("slow-decay", 2, 2048, 8, 64, 128, "float32", "slow", 0.0),
    ("initial-state", 8, 2048, 40, 64, 128, "bfloat16", "mixed", 0.1),
    ("long-prompt", 1, 16384, 40, 64, 128, "bfloat16", "mixed", 0.0),
    ("two-chunks-129", 8, 129, 40, 64, 128, "bfloat16", "mixed", 0.0),
]
# the rate of the kernel's products by r/k/v dtype: one TF32 product for
# bf16 inputs (exact in TF32), three (3xTF32) for float32
WKV6_RATE = {"bfloat16": ("tf32", 1), "float32": ("tf32/3", 3)}


def wkv6_bound(B: int, S: int, H: int, dh: int, dtype: str, peaks: dict
               ) -> tuple[float, str, str]:
    """Least time for one WKV6 call, from the least work the recurrence
    needs, whatever the algorithm: per row and (b, h), y = rᵀS (2·dh²
    operations) and S = w ⊙ S + k vᵀ (3·dh²), at the TF32 tensor-core rate
    that the kernel's products meet their limit on (WKV6_RATE: a third of
    it for float32's 3xTF32); r, k, v read and y written once in `dtype`,
    logw, u and the state in and out in float32. Returns (ms, what bounds
    it, the rate used)."""
    size = {"float32": 4, "bfloat16": 2}[dtype]
    rate, products = WKV6_RATE[dtype]
    ops = 5.0 * dh * dh * B * S * H
    nbytes = (4 * size + 4) * B * S * H * dh + 4 * H * dh \
        + 2 * 4 * B * H * dh * dh
    t_ops, t_bytes = ops * products / peaks["tf32"], nbytes / peaks["bw"]
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", rate)


def _wkv6_inputs(gen, B, S, H, dh, dtype, decay, state_scale):
    """r, k, v in `dtype` and logw, u, state in float32, on the card: logw
    as in the reference's kernel test (clip(-exp(1.5 N), -5, -1e-4)), ≡ -5
    (its extreme-decay test), or near -1e-4 (the state carries across
    every chunk)."""
    import torch
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    r, k, v = (torch.randn((B, S, H, dh), generator=gen, device=DEVICE)
               .to(dt) for _ in range(3))
    n = torch.randn((B, S, H, dh), generator=gen, device=DEVICE)
    if decay == "extreme":
        logw = torch.full_like(n, -5.0)
    elif decay == "slow":
        logw = (-1e-4 * torch.exp(0.5 * n)).clamp(-5.0, -1e-4)
    else:
        logw = (-torch.exp(1.5 * n)).clamp(-5.0, -1e-4)
    u = torch.randn((H, dh), generator=gen, device=DEVICE) * 0.1
    state = torch.randn((B, H, dh, dh), generator=gen,
                        device=DEVICE) * state_scale
    return r, k, v, logw, u, state


def phase_wkv6_kernels(peaks: dict, cases=WKV6_CASES) -> dict:
    """The WKV6 kernel against its plain version (wkv_chunked) computed in
    float32 from the same inputs, each y and state entry within WKV6_TOL of
    its own envelope, and launching two kernels a call (the state and
    output passes, counted in the profiler's trace); returns the path's
    row (the first case)."""
    import torch
    from repro_torch.kernels.rwkv6 import ops, ref
    from repro_torch.kernels.rwkv6.ref import wkv_chunked
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    main, retaken = None, 0
    for name, B, S, H, dh, chunk, dtype, decay, s0 in cases:
        args = _wkv6_inputs(gen, B, S, H, dh, dtype, decay, s0)
        saved = dict(ops.LAUNCHES)  # these launches are not the path's
        got = ops.wkv6_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
        f32 = [a.float() for a in args]
        want = wkv_chunked(*f32, chunk)
        err = max((g.float() - w).abs().max().item()
                  for g, w in zip(got, want))
        scaled = ref.scaled_err(got, want, *f32, chunk=chunk)
        del want, f32
        again = ops.wkv6_cuda(*args, chunk=chunk)
        checks = dict(
            tol=scaled <= WKV6_TOL[dtype],
            finite=all(bool(torch.isfinite(t).all().item()) for t in got),
            repeat_bitwise=all(torch.equal(a, b) for a, b in zip(got, again)))
        del again
        kern = lambda: ops.wkv6_cuda(*args, chunk=chunk)
        ms = cuda_ms(kern, iters=10)
        # kernels a call launches, read from a trace of 10 calls: each
        # kernel's events come in whole tens, else the profiler dropped
        # some records (seen once in a whole run: 12 of 20; once all of
        # them; once one record in each of three traces in a row) and
        # the trace is taken again, up to eight times; a run in which two
        # cases need more than one retake fails
        for retries in range(8):
            counts: dict = {}
            _, _, dev_s, _ = device_trace(
                lambda: [kern() for _ in range(10)], counts)
            wkv = [n for k, n in counts.items() if "wkv6_" in k]
            if wkv and all(n % 10 == 0 for n in wkv):
                break
        ops.LAUNCHES.update(saved)
        retaken += retries > 1
        checks["trace_retakes"] = retaken < 2
        passes = sum(wkv) / 10
        checks["two_passes"] = passes == 2
        events = {re.search(r"wkv6_\w+", k).group(0): n
                  for k, n in counts.items() if "wkv6_" in k}
        plain_ms = cuda_ms(lambda: wkv_chunked(*args, chunk), iters=3,
                           warmup=1)
        bms, by, rate = wkv6_bound(B, S, H, dh, dtype, peaks)
        row = dict(phase="wkv6_kernel", case=name, B=B, S=S, H=H, dh=dh,
                   chunk=ops.chunk_rows(S, chunk), passes=passes,
                   pass_events=events, trace_retries=retries,
                   dtype=dtype, decay=decay,
                   state_scale=s0, max_abs_err=err, scaled_err=scaled,
                   tol=WKV6_TOL[dtype], checks=checks,
                   ok=all(checks.values()), ms=ms,
                   device_ms=None if dev_s is None else 100 * dev_s,
                   plain_ms=plain_ms, library_ms=None,
                   library="none: no single PyTorch call computes the WKV6 "
                           "recurrence", bound_ms=bms, bound_by=by,
                   bound_rate=rate)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"wkv6 {name} failed its checks: {row}")
        if main is None:
            main = row
        del args, got
        torch.cuda.empty_cache()
    return main


@contextlib.contextmanager
def _prefill_wkv(fn):
    """Prefill's WKV computed by `fn(r, k, v, logw, u, state, chunk)`
    inside the block: the plain route and the planted faults the kernel
    route is held against (the port has no option for this; decode's
    wkv_step is untouched)."""
    from repro_torch.kernels.rwkv6 import ops as wops
    dispatch = wops.wkv6
    wops.wkv6 = lambda r, k, v, logw, u, state, *, chunk: \
        fn(r, k, v, logw, u, state, chunk)
    try:
        yield
    finally:
        wops.wkv6 = dispatch


STATE_FAULT_AT = 4  # the state fault's distance from the prompt's end


def _state_zeroed_near_end(r, k, v, logw, u, state, chunk):
    """Plain WKV whose carried state is zeroed STATE_FAULT_AT positions
    before the prompt's end: under the seeded decays (about e^-0.37 a
    step) the last position still reads what it lost."""
    import torch
    from repro_torch.kernels.rwkv6.ref import wkv_chunked
    at = r.shape[1] - STATE_FAULT_AT
    y0, _ = wkv_chunked(r[:, :at], k[:, :at], v[:, :at], logw[:, :at],
                        u, state, chunk)
    y1, s1 = wkv_chunked(r[:, at:], k[:, at:], v[:, at:], logw[:, at:],
                         u, torch.zeros_like(state), chunk)
    return torch.cat([y0, y1], dim=1), s1


def _decay_off_by_one(r, k, v, logw, u, state, chunk):
    """Plain WKV whose exclusive cumulative log-decay is shifted by one
    position: every row reads its history through its own decay too (lw
    in place of lw − logw), the bonus term unchanged."""
    import torch
    from repro_torch.kernels.rwkv6.ref import wkv_chunked
    w = torch.exp(logw)
    y, s = wkv_chunked((r.float() * w).to(r.dtype), k, v, logw, u, state,
                       chunk)
    bonus = torch.einsum("bthd,hd,bthd->bth", r.float() * (1 - w), u,
                         k.float())
    return (y.float() + bonus[..., None] * v.float()).to(r.dtype), s


def phase_rwkv_serve(peaks: dict, cfg=None, batch: int = 8,
                     prompt: int = 2048, new: int = 32) -> dict:
    """The ssm family served at rwkv6-3b's full width and depth (`cfg` and
    the sizes may be cut for a rehearsal). Returns the wkv6 launches of the
    main path, by step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    cfg = cfg or get_config("rwkv6-3b")
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
    with _probed_steps((wops.LAUNCHES, "wkv6")) as steps:
        wops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, prompts, max_new=new, max_len=max_len)
        wall = time.perf_counter() - t0
        launches = wops.LAUNCHES["wkv6"]
    peak_bytes = torch.cuda.max_memory_allocated()
    tokens = torch.from_numpy(prompts).to(dev)
    prefill_warm_ms = _warm_prefill_ms(model, tokens, max_len)
    prefills = [st for st in steps if st[0] == "prefill"]
    decodes = [st for st in steps if st[0] == "decode"]
    prefill_launches = sum(st[1]["wkv6"] for st in prefills)
    decode_launches = sum(st[1]["wkv6"] for st in decodes)
    prefill_ms = prefills[0][2].elapsed_time(prefills[0][3])
    decode_ms = decodes[0][2].elapsed_time(decodes[-1][3]) / len(decodes)

    # the card's busy and idle share over the main path once more, traced
    _, trace_wall, busy, by_name = device_trace(
        lambda: generate(model, prompts, max_new=new, max_len=max_len))
    wops.reset_launches()
    # the timed bf16 model: each layer's WKV kernel call against the plain
    # version on its own served inputs (a measure no depth amplifies), and
    # the routes' split layer by layer; the end-to-end sound routes are
    # recorded, not held: 32 bf16 layers of the seeded model amplify
    # rounding, so the end-to-end checks run in float32
    bf16_layers = _rwkv_layers(model, tokens)
    bf16_routes = _rwkv_routes(model, tokens, faults=False)
    layer_mats = sum(p.numel() for p in model.periods[0].parameters()
                     if p.ndim >= 2)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters()) \
        - model.embed.tok.numel() * model.embed.tok.element_size()
    n_params = model.n_params()
    del model
    torch.cuda.empty_cache()

    # the checks: the same seeded weights in float32 (the kernel's float32
    # instantiation), teacher-forced decode, kernel against plain and
    # against the planted faults, read with row 0 pinned
    model = build_model(cfg.with_(dtype="float32"), device=DEVICE).init(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    layers = _rwkv_layers(model, tokens)
    routes = _rwkv_routes(model, tokens, faults=True)
    wops.reset_launches()
    del model
    torch.cuda.empty_cache()
    tf_err, plain = routes["teacher_forced_rel_err"], routes["kernel_vs_plain"]
    pinned = routes["row0_pinned"]
    controls = pinned["planted_faults"]

    # least times: every weight read once per step (bf16) plus the WKV
    # state read and written; prefill's products at the bf16 peak and the
    # WKV calls at theirs
    L, D, dh = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
    H = D // dh
    state_bytes = 2 * L * batch * H * dh * dh * 4
    decode_bound_ms = 1e3 * (weight_bytes + state_bytes) / peaks["bw"]
    wkv_ms, _, _ = wkv6_bound(batch, prompt, H, dh, cfg.dtype, peaks)
    prefill_bound_ms = 1e3 * (2.0 * layer_mats * L * batch * prompt
                              + 2.0 * D * cfg.vocab_size * batch
                              ) / peaks["bfloat16"] + L * wkv_ms
    row = dict(phase="rwkv_serve", arch=cfg.name, n_params=n_params,
               dtype=cfg.dtype, batch=batch, prompt=prompt, new_tokens=new,
               max_len=max_len, init_s=init_s, generate_wall_s=wall,
               tokens_per_s=batch * new / wall,
               wkv6_launches=dict(generate=launches,
                                  prefill=prefill_launches,
                                  decode=decode_launches),
               steps=dict(prefill=len(prefills), decode=len(decodes)),
               prefill_ms=prefill_ms, prefill_warm_ms=prefill_warm_ms,
               prefill_bound_ms=prefill_bound_ms,
               decode_ms_per_token=decode_ms,
               decode_bound_ms=decode_bound_ms,
               peak_memory_gb=peak_bytes / 1e9,
               logits_finite=routes["finite"] and bf16_routes["finite"],
               tokens_in_vocab=bool(0 <= toks.min()
                                    and toks.max() < cfg.vocab_size),
               bf16_sound_routes=dict(
                   teacher_forced_rel_err=bf16_routes[
                       "teacher_forced_rel_err"],
                   kernel_vs_plain=bf16_routes["kernel_vs_plain"]),
               layers=dict(bfloat16=bf16_layers, float32=layers),
               checks_dtype="float32", teacher_forced_rel_err=tf_err,
               kernel_vs_plain=plain, row0_pinned=pinned,
               tol=RWKV_SERVE_TOL, hidden_tol=RWKV_HIDDEN_TOL,
               traced=_traced(trace_wall, busy, by_name),
               traced_wkv6_ms=1e3 * sum(v for k, v in by_name.items()
                                        if "wkv6_" in k))
    emit(row)
    caught = all(c["logits_rel_err"] > RWKV_SERVE_TOL
                 and c["hidden_rel_err"] > RWKV_HIDDEN_TOL
                 for c in controls.values())
    # each layer's kernel call within its limit on the served inputs; after
    # the first layer (no depth to amplify yet) the kernel route splits
    # from the plain one as little as the kernel-free route does
    held = all(
        ly["kernel_scaled_err"] <= WKV6_TOL[dt]
        and ly["split"]["kernel_vs_plain"][0]
        <= RWKV_FIRST_LAYER_RATIO * ly["split"]["oracle64_vs_plain"][0]
        for dt, ly in (("bfloat16", bf16_layers), ("float32", layers)))
    if not (launches == prefill_launches == L and decode_launches == 0
            and len(prefills) == 1 and len(decodes) == new - 1
            and row["logits_finite"] and row["tokens_in_vocab"]
            and toks.shape == (batch, new) and tf_err <= RWKV_SERVE_TOL
            and plain["logits_rel_err"] <= RWKV_SERVE_TOL
            and pinned["kernel_vs_plain"]["logits_rel_err"] <= RWKV_SERVE_TOL
            and pinned["kernel_vs_plain"]["hidden_rel_err"] <= RWKV_HIDDEN_TOL
            and caught and held):
        raise AssertionError(f"rwkv_serve failed: {row}")
    return row["wkv6_launches"]


def _row0_from(route, first):
    """WKV by `route` with y's row 0 (position 0, the bonus term alone)
    taken from `first`'s."""
    def fn(r, k, v, logw, u, state, chunk):
        y, s = route(r, k, v, logw, u, state, chunk)
        y[:, 0] = first(r, k, v, logw, u, state, chunk)[0][:, 0]
        return y, s
    return fn


def _bare_kernel(r, k, v, logw, u, state, chunk):
    from repro_torch.kernels.rwkv6 import ops
    return ops.wkv6_cuda(r, k, v, logw, u, state, chunk=chunk)


def _rwkv_routes(model, tokens, faults: bool) -> dict:
    """Teacher-forced decode (prefill all but the last 8 tokens, decode
    those 8 from the kernel's final state) against a full prefill's last
    logits, and the kernel route against the plain wkv_chunked. With
    `faults`, `row0_pinned` reads every route with y's row 0 taken from
    the plain version (row 0 is where the seeded model amplifies
    rounding, see _rwkv_layers; each layer's kernel call holds it): the
    plain route and the two planted faults against the kernel's. Each
    read on the last-position logits over max|logit| and on the final
    hidden state of every position, each row over its own max."""
    import torch
    from repro_torch.kernels.rwkv6.ref import wkv_chunked
    prompt = tokens.shape[1]
    n0 = prompt - 8
    full, _ = model.prefill(tokens, max_len=prompt)
    tf, cache = model.prefill(tokens[:, :n0], max_len=prompt)
    for t in range(n0, prompt):
        tf, cache = model.decode_step(tokens[:, t:t + 1], cache, t)
    del cache
    finite = bool(torch.isfinite(full).all().item())
    tf_err = (tf.float() - full.float()).abs().max().item() \
        / full.float().abs().max().item()
    del tf, full

    def hidden(fn):
        with _prefill_wkv(fn):
            return model(tokens)[0]

    def read(h, base):
        logits, want = model.head(h[:, -1]), model.head(base[:, -1])
        row_err = ((h.float() - base.float()).abs().amax(-1)
                   / base.float().abs().amax(-1).clamp_min(1e-30))
        return dict(
            logits_rel_err=(logits.float() - want.float()).abs().max().item()
            / want.float().abs().max().item(),
            hidden_rel_err=row_err.max().item(),
            hidden_worst_position=int(row_err.amax(0).argmax().item()),
            argmax_agree=float((logits.argmax(-1) == want.argmax(-1))
                               .float().mean().item()))
    h_plain = hidden(wkv_chunked)
    out = dict(finite=finite, teacher_forced_rel_err=tf_err,
               kernel_vs_plain=read(h_plain, model(tokens)[0]))
    if faults:
        base = hidden(_row0_from(_bare_kernel, wkv_chunked))
        out["row0_pinned"] = dict(
            kernel_vs_plain=read(h_plain, base),
            planted_faults={
                name: read(hidden(_row0_from(fn, wkv_chunked)), base)
                for name, fn in (
                    ("state_zeroed_near_end", _state_zeroed_near_end),
                    ("decay_off_by_one", _decay_off_by_one))})
        del base
    del h_plain
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _after_each_layer(fn):
    """`fn(layer, x)` on the residual stream after each block of a forward
    pass inside the block (the port has no hook for this)."""
    from repro_torch.models import blocks
    forward = blocks.block_forward
    layer = itertools.count()

    def run(*args, **kw):
        out = forward(*args, **kw)
        fn(next(layer), out[0])
        return out
    blocks.block_forward = run
    try:
        yield
    finally:
        blocks.block_forward = forward


def _row_split(a, b) -> float:
    """Each row's max|a - b| over b's row max; the max over rows."""
    return ((a.float() - b.float()).abs().amax(-1)
            / b.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _rwkv_layers(model, tokens) -> dict:
    """One prefill of `tokens`, layer by layer. `kernel_scaled_err`: each
    layer's WKV kernel call against the plain wkv_chunked computed in
    float32 from the same (served) inputs, per entry over its envelope
    (ref.scaled_err). `split`: the residual stream after each layer along
    the kernel route, the plain wkv_chunked route (chunk as served) and
    routes that run no kernel (the plain version in chunks of 64; the
    per-step oracle in float64), pairs read as the hidden rows are: each
    row's max|diff| over its own max, the max over rows. Two more routes
    take y's first row (position 0, the bonus term alone) from elsewhere:
    the kernel with the plain version's row 0, and the plain version with
    the float64 oracle's. Routes that run no kernel and split as far as
    the kernel does show the model amplifying rounding with depth, not a
    kernel fault; the row-0 routes show where."""
    import torch
    from repro_torch.kernels.rwkv6 import ops, ref
    scaled = []
    split = {f"{a}_vs_{b}": [] for a, b in (
        ("oracle64", "plain"), ("chunk64", "plain"), ("chunk64", "oracle64"),
        ("kernel", "plain"), ("kernel", "oracle64"),
        ("kernel_row0_plain", "plain"), ("plain_row0_oracle64", "plain"))}

    def kernel(r, k, v, logw, u, state, chunk):
        got = ops.wkv6_cuda(r, k, v, logw, u, state, chunk=chunk)
        f32 = [t.float() for t in (r, k, v, logw, u, state)]
        scaled.append(ref.scaled_err(got, ref.wkv_chunked(*f32, chunk),
                                     *f32, chunk=chunk))
        return got

    def oracle(r, k, v, logw, u, state, chunk):
        y, s = ref.wkv6(r, k, v, logw, u, state, dtype=torch.float64)
        return y.to(r.dtype), s.float()

    plain, exact = [], []

    def read_oracle(i, x):
        exact.append(x)
        split["oracle64_vs_plain"].append(_row_split(x, plain[i]))

    def reader(name):
        def read(i, x):
            split[f"{name}_vs_plain"].append(_row_split(x, plain[i]))
            split[f"{name}_vs_oracle64"].append(_row_split(x, exact[i]))
        return read

    def chunk64(r, k, v, logw, u, state, chunk):
        return ref.wkv_chunked(r, k, v, logw, u, state, 64)

    def oracle_row0(r, k, v, logw, u, state, chunk):
        return oracle(r[:, :1], k[:, :1], v[:, :1], logw[:, :1], u, state,
                      chunk)

    def only_vs_plain(name):
        return lambda i, x: split[f"{name}_vs_plain"].append(
            _row_split(x, plain[i]))

    for fn, read in ((ref.wkv_chunked, lambda i, x: plain.append(x)),
                     (oracle, read_oracle), (chunk64, reader("chunk64")),
                     (kernel, reader("kernel")),
                     (_row0_from(_bare_kernel, ref.wkv_chunked),
                      only_vs_plain("kernel_row0_plain")),
                     (_row0_from(ref.wkv_chunked, oracle_row0),
                      only_vs_plain("plain_row0_oracle64"))):
        with _prefill_wkv(fn), _after_each_layer(read):
            model(tokens)
    del plain, exact
    torch.cuda.empty_cache()
    return dict(kernel_scaled_err=max(scaled),
                kernel_scaled_err_by_layer=scaled, split=split)


# ---------------------------------------------------------------------------
# the hybrid family: the selective-scan kernel and jamba serving
# ---------------------------------------------------------------------------

# (name, B, S, di, ds, dtype, dt, h0 scale); the first is the path's
# (jamba's prefill: B 8, S 2,048, di 8,192, ds 16)
SSM_CASES = [
    ("jamba", 8, 2048, 8192, 16, "bfloat16", "model", 0.0),
    ("jamba-f32", 8, 2048, 8192, 16, "float32", "model", 0.0),
    ("ragged-1000", 8, 1000, 8192, 16, "bfloat16", "model", 0.0),
    ("ragged-17", 8, 17, 8192, 16, "bfloat16", "model", 0.0),
    ("ds-8", 8, 2048, 8192, 8, "bfloat16", "model", 0.0),
    ("initial-state", 8, 2048, 8192, 16, "bfloat16", "model", 0.5),
    ("large-dt", 2, 2048, 8192, 16, "float32", "large", 0.5),
    ("tiny-dt", 2, 2048, 8192, 16, "float32", "tiny", 0.5),
    ("tiny-dt-16k", 1, 16384, 2048, 16, "float32", "tiny", 0.5),
]


def ssm_bound(B: int, S: int, di: int, ds: int, dtype: str, peaks: dict
              ) -> tuple[float, str]:
    """Least time for one selective-scan call, from the least work the
    scan needs: per (b, t, d, s) one exp and six float32 operations (dt·A,
    dA·h, u·B, their sum, h·C and its sum), per (b, t, d) three (u = dt·x,
    D·x and its sum); x read in `dtype`, dt read and y written in float32
    once, B and C read once per (b, t), A, D and h0 in and h out in
    float32."""
    size = {"float32": 4, "bfloat16": 2}[dtype]
    ops = 7.0 * B * S * di * ds + 3.0 * B * S * di
    nbytes = (size + 8) * B * S * di + 2 * size * B * S * ds \
        + 4 * (di * ds + di) + 2 * 4 * B * di * ds
    t_ops, t_bytes = ops / peaks["float32"], nbytes / peaks["bw"]
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _ssm_inputs(gen, B, S, di, ds, dtype, dt_kind, h0_scale):
    """x, B, C in `dtype` and dt, A, D_skip, h0 in float32, on the card, as
    the model makes them: B and C column views of one (B, S, r + 2 ds)
    tensor (r = 256, jamba's dt rank); A the S4D init -(1..ds) per channel
    times exp(0.3 N); dt log-uniform in [0.001, 0.1] as the init of
    dt_bias gives it ("model"), 200 (dt·A <= -200: dA underflows to 0,
    "large") or ~1e-4 (the state carries over the whole prompt, "tiny");
    D 1."""
    import math
    import torch
    dt_ = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    x = torch.randn((B, S, di), generator=gen, device=DEVICE).to(dt_)
    dbc = torch.randn((B, S, 256 + 2 * ds), generator=gen,
                      device=DEVICE).to(dt_)
    _, Bv, Cv = torch.split(dbc, [256, ds, ds], dim=-1)
    u = torch.rand((B, S, di), generator=gen, device=DEVICE)
    if dt_kind == "large":
        dt = torch.full_like(u, 200.0)
    elif dt_kind == "tiny":
        dt = 1e-4 * (0.5 + u)
    else:
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
    A = -torch.arange(1, ds + 1, dtype=torch.float32, device=DEVICE) \
        * torch.exp(0.3 * torch.randn((di, ds), generator=gen, device=DEVICE))
    D = torch.ones((di,), device=DEVICE)
    h0 = torch.randn((B, di, ds), generator=gen, device=DEVICE) * h0_scale
    return x, dt, A, Bv, Cv, D, h0


def phase_ssm_kernels(peaks: dict, cases=SSM_CASES) -> dict:
    """The selective-scan kernel against its plain version (ref.ssm_scan)
    computed in float32 from the same inputs, each y and h entry within
    SSM_TOL of its own envelope; returns the path's row (the first
    case)."""
    import torch
    from repro_torch.kernels.ssd import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    main = None
    for name, B, S, di, ds, dtype, dt_kind, h0_scale in cases:
        args = _ssm_inputs(gen, B, S, di, ds, dtype, dt_kind, h0_scale)
        saved = dict(ops.LAUNCHES)  # these launches are not the path's
        got = ops.ssm_scan_cuda(*args)
        torch.cuda.synchronize()
        want = ref.ssm_scan(*args)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        scaled = ref.scaled_err(got, want, *args)
        del want
        again = ops.ssm_scan_cuda(*args)
        checks = dict(
            tol=scaled <= SSM_TOL,
            finite=all(bool(torch.isfinite(t).all().item()) for t in got),
            repeat_bitwise=all(torch.equal(a, b) for a, b in zip(got, again)))
        del again
        kern = lambda: ops.ssm_scan_cuda(*args)
        ms = cuda_ms(kern, iters=10)
        _, _, dev_s, _ = device_trace(lambda: [kern() for _ in range(10)])
        ops.LAUNCHES.update(saved)
        plain_ms = cuda_ms(lambda: ref.ssm_scan(*args), iters=2, warmup=1)
        bms, by = ssm_bound(B, S, di, ds, dtype, peaks)
        row = dict(phase="ssm_kernel", case=name, B=B, S=S, di=di, ds=ds,
                   dtype=dtype, dt=dt_kind, h0_scale=h0_scale,
                   max_abs_err=err, scaled_err=scaled, tol=SSM_TOL,
                   checks=checks, ok=all(checks.values()), ms=ms,
                   device_ms=None if dev_s is None else 100 * dev_s,
                   plain_ms=plain_ms, library_ms=None,
                   library="none: no single PyTorch call computes the "
                           "selective scan", bound_ms=bms, bound_by=by)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"ssm_scan {name} failed its checks: {row}")
        if main is None:
            main = row
        del args, got
        torch.cuda.empty_cache()
    return main


@contextlib.contextmanager
def _prefill_scan(fn):
    """Prefill's selective scan computed by `fn(x, dt, A, B, C, D_skip,
    h0)` inside the block: the plain route and the planted faults the
    kernel route is held against (the port has no option for this;
    decode's selective_scan is untouched)."""
    from repro_torch.kernels.ssd import ops as sops
    dispatch = sops.ssm_scan
    sops.ssm_scan = fn
    try:
        yield
    finally:
        sops.ssm_scan = dispatch


@contextlib.contextmanager
def _moe_routing(choose):
    """Each MoE call's router made by `choose(route, p, cfg, xf)` inside
    the block, `route` being the port's own `moe.route` (the port has no
    option for this)."""
    from repro_torch.models import moe
    route = moe.route
    moe.route = lambda p, cfg, xf: choose(route, p, cfg, xf)
    try:
        yield
    finally:
        moe.route = route


def _recorded(log: list):
    """The router as it is, each call's top-k experts appended to `log`."""
    def choose(route, p, cfg, xf):
        out = route(p, cfg, xf)
        log.append(out[2])
        return out
    return choose


def _replayed(choices, flips: list):
    """The router's own probabilities at the experts `choices(call)` (the
    top-k experts of the call-th MoE call, taken from another route);
    appends to `flips` the tokens the router would have sent elsewhere."""
    calls = itertools.count()

    def choose(route, p, cfg, xf):
        probs, _, own = route(p, cfg, xf)
        idx = choices(next(calls))
        flips.append(_flipped(own, idx).sum().item())
        return probs, probs.gather(1, idx), idx
    return choose


def _flipped(a, b):
    """Tokens whose top-k choices name other experts."""
    return (a.sort(-1).values != b.sort(-1).values).any(-1)


STATE_ZEROED_AT = 4  # the state fault's distance from the prompt's end


def _scan_state_zeroed_near_end(x, dt, A, B, C, D_skip, h0):
    """Plain scan whose state is zeroed STATE_ZEROED_AT positions before
    the prompt's end, so the last position still reads what it lost."""
    import torch
    from repro_torch.kernels.ssd.ref import ssm_scan
    at = x.shape[1] - STATE_ZEROED_AT
    y0, _ = ssm_scan(x[:, :at], dt[:, :at], A, B[:, :at], C[:, :at],
                     D_skip, h0)
    y1, h = ssm_scan(x[:, at:], dt[:, at:], A, B[:, at:], C[:, at:], D_skip,
                     torch.zeros_like(h0))
    return torch.cat([y0, y1], dim=1), h


def _scan_skip_dropped(x, dt, A, B, C, D_skip, h0):
    """Plain scan without the D·x skip term."""
    import torch
    from repro_torch.kernels.ssd.ref import ssm_scan
    return ssm_scan(x, dt, A, B, C, torch.zeros_like(D_skip), h0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def phase_hybrid_serve(peaks: dict, cfg=None, batch: int = 8,
                       prompt: int = 2048, new: int = 32) -> dict:
    """The hybrid family served at jamba-v0.1-52b's full width, its depth
    cut to one period (8 layers: "mamba" at 0, 2, 6, "mamba+moe" at 1, 3,
    5, 7, "attn" at 4; `cfg` and the sizes may be cut for a rehearsal).
    Returns the ssm_scan and flash launches of the main path, by step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    cfg = cfg or get_config("jamba-v0.1-52b").with_(n_layers=8)
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
    # steps note their launches and times, and the router's choices are
    # kept (a list append: no launch, no sync) to count the experts decode
    # reads
    routing = []
    with _probed_steps((sops.LAUNCHES, "ssm_scan"),
                       (fops.LAUNCHES, "flash")) as steps, \
            _moe_routing(_recorded(routing)):
        sops.reset_launches()
        fops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, prompts, max_new=new, max_len=max_len)
        wall = time.perf_counter() - t0
        launches = dict(ssm_scan=sops.LAUNCHES["ssm_scan"],
                        flash=fops.LAUNCHES["flash"])
    peak_bytes = torch.cuda.max_memory_allocated()
    tokens = torch.from_numpy(prompts).to(dev)
    prefill_warm_ms = _warm_prefill_ms(model, tokens, max_len)
    prefills = [st for st in steps if st[0] == "prefill"]
    decodes = [st for st in steps if st[0] == "decode"]
    by_step = {kind: {key: sum(st[1][key] for st in sts) for key in launches}
               for kind, sts in (("prefill", prefills), ("decode", decodes))}
    prefill_ms = prefills[0][2].elapsed_time(prefills[0][3])
    decode_ms = decodes[0][2].elapsed_time(decodes[-1][3]) / len(decodes)
    n_moe = sum(kind.endswith("+moe") for kind in model.kinds) \
        * cfg.n_periods()
    touched = float(np.mean([len(torch.unique(idx))
                             for idx in routing[n_moe:]]))
    del routing

    # the card's busy and idle share over the main path once more, traced
    _, trace_wall, busy, by_name = device_trace(
        lambda: generate(model, prompts, max_new=new, max_len=max_len))
    sops.reset_launches()
    fops.reset_launches()

    layers = _hybrid_layers(model, tokens)
    tf = _hybrid_teacher_forced(model, tokens)
    routes = _hybrid_routes(model, tokens)
    sops.reset_launches()
    fops.reset_launches()

    # least times: prefill's products at the bf16 peak (each weight a token
    # uses, once per token; the head at the last position only), the
    # visible attention pairs, and the scans at their bound; decode reads
    # every weight but the embedding and the experts no token chose once a
    # step, and the caches
    D, V = cfg.d_model, cfg.vocab_size
    counts = cfg.param_counts()
    per_token = cfg.active_params() - counts["embed"] - counts["head"]
    n_attn = sum(kind.startswith("attn") for kind in model.kinds) \
        * cfg.n_periods()
    n_mamba = sum(kind.startswith("mamba") for kind in model.kinds) \
        * cfg.n_periods()
    attn_ops = 4.0 * cfg.head_dim * cfg.n_heads * batch * n_attn \
        * prompt * (prompt + 1) / 2
    scan_ms, _ = ssm_bound(batch, prompt, cfg.d_inner, cfg.d_state,
                           cfg.dtype, peaks)
    prefill_bound_ms = 1e3 * (2.0 * per_token * batch * prompt + attn_ops
                              + 2.0 * D * V * batch) / peaks["bfloat16"] \
        + n_mamba * scan_ms
    expert_bytes = 3 * D * (cfg.d_expert or cfg.d_ff) * 2
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters()) \
        - model.embed.tok.numel() * model.embed.tok.element_size()
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(model.init_cache(batch, max_len)))
    decode_bound_ms = 1e3 * (weight_bytes + cache_bytes - n_moe * (
        cfg.n_experts - touched) * expert_bytes) / peaks["bw"]
    n_params = model.n_params()
    del model
    torch.cuda.empty_cache()

    row = dict(phase="hybrid_serve", arch=cfg.name, n_layers=cfg.n_layers,
               kinds=cfg.layer_kinds(), n_params=n_params, dtype=cfg.dtype,
               batch=batch, prompt=prompt, new_tokens=new, max_len=max_len,
               init_s=init_s, generate_wall_s=wall,
               tokens_per_s=batch * new / wall, launches=launches,
               launches_by_step=by_step,
               steps=dict(prefill=len(prefills), decode=len(decodes)),
               prefill_ms=prefill_ms, prefill_warm_ms=prefill_warm_ms,
               prefill_bound_ms=prefill_bound_ms,
               decode_ms_per_token=decode_ms, decode_bound_ms=decode_bound_ms,
               decode_experts_touched_per_layer=touched,
               decode_host_syncs_per_step=n_moe,
               peak_memory_gb=peak_bytes / 1e9,
               tokens_in_vocab=bool(0 <= toks.min()
                                    and toks.max() < cfg.vocab_size),
               layers=layers, teacher_forced=tf, routes=routes,
               tol=HYBRID_SERVE_TOL, hidden_tol=HYBRID_HIDDEN_TOL,
               traced=_traced(trace_wall, busy, by_name))
    emit(row)
    faults = routes["planted_faults"]
    plain = routes["kernel_vs_plain"]
    caught = all(f["logits_rel_err"] > HYBRID_SERVE_TOL
                 and f["hidden_rel_err"] > HYBRID_HIDDEN_TOL
                 for f in faults.values())
    held = len(layers["kernel_scaled_err"]) == n_mamba \
        and max(layers["kernel_scaled_err"]) <= SSM_TOL
    if not (launches["ssm_scan"] == by_step["prefill"]["ssm_scan"] == n_mamba
            and launches["flash"] == by_step["prefill"]["flash"] == n_attn
            and by_step["decode"] == dict(ssm_scan=0, flash=0)
            and len(prefills) == 1 and len(decodes) == new - 1
            and routes["finite"] and row["tokens_in_vocab"]
            and toks.shape == (batch, new)
            and tf["pinned"]["logits_rel_err"] <= HYBRID_SERVE_TOL
            and plain["logits_rel_err"] <= HYBRID_SERVE_TOL
            and plain["hidden_rel_err"] <= HYBRID_HIDDEN_TOL
            and caught and held):
        raise AssertionError(f"hybrid_serve failed: {row}")
    return dict(generate=launches, **by_step)


def _hybrid_layers(model, tokens) -> dict:
    """One prefill of `tokens`: each Mamba layer's kernel call against the
    plain ref.ssm_scan computed in float32 from the same (served) inputs,
    per entry over its envelope (ref.scaled_err)."""
    from repro_torch.kernels.ssd import ops, ref
    scaled = []

    def kernel(*args):
        got = ops.ssm_scan_cuda(*args)
        scaled.append(ref.scaled_err(got, ref.ssm_scan(*args), *args))
        return got
    with _prefill_scan(kernel):
        model(tokens)
    return dict(kernel_scaled_err=scaled)


def _read(model, h, base, rows=None) -> dict:
    """The last-position logits of `h` against `base`'s, over max|logit|,
    and every position's final hidden row over its own max (the positions
    `rows` keeps, when given)."""
    logits, want = model.head(h[:, -1]), model.head(base[:, -1])
    row_err = ((h.float() - base.float()).abs().amax(-1)
               / base.float().abs().amax(-1).clamp_min(1e-30))
    if rows is not None:
        row_err = row_err[rows]
    return dict(
        logits_rel_err=(logits.float() - want.float()).abs().max().item()
        / want.float().abs().max().item(),
        hidden_rel_err=row_err.max().item() if row_err.numel() else 0.0,
        argmax_agree=float((logits.argmax(-1) == want.argmax(-1))
                           .float().mean().item()))


def _hybrid_routes(model, tokens) -> dict:
    """The kernel route (its routing recorded) against the plain
    ref.ssm_scan route and two planted faults, each with the kernel
    route's routing replayed (`routing_flips`: the tokens of each MoE call
    that it would have routed otherwise); and the plain route with its own
    routing (`free`), read over every position and over the positions
    that routed alike in every MoE layer (`alike_rows`)."""
    import torch
    from repro_torch.kernels.ssd.ref import ssm_scan
    log = []
    with _moe_routing(_recorded(log)):
        base = model(tokens)[0]

    def pinned(scan):
        flips = []
        with _prefill_scan(scan), \
                _moe_routing(_replayed(lambda c: log[c], flips)):
            h = model(tokens)[0]
        return dict(_read(model, h, base), routing_flips=flips)
    out = dict(finite=bool(torch.isfinite(base).all().item()),
               kernel_vs_plain=pinned(ssm_scan),
               planted_faults={
                   name: pinned(fn) for name, fn in (
                       ("state_zeroed_near_end", _scan_state_zeroed_near_end),
                       ("skip_dropped", _scan_skip_dropped))})
    own = []
    with _prefill_scan(ssm_scan), _moe_routing(_recorded(own)):
        h = model(tokens)[0]
    flipped = [_flipped(a, b).reshape(tokens.shape) for a, b in zip(own, log)]
    alike = ~torch.stack(flipped).any(0)
    out["free"] = dict(_read(model, h, base),
                       routing_flips=[f.sum().item() for f in flipped],
                       alike_rows=_read(model, h, base, alike)[
                           "hidden_rel_err"],
                       tokens=tokens.numel())
    return out


def _hybrid_teacher_forced(model, tokens, n_new: int = 16) -> dict:
    """Prefill all but the last `n_new` tokens (the scan kernel), decode
    those one by one (the plain selective_scan from the kernel's final
    state), against a full prefill's last logits over max|logit|: with the
    full prefill's routing replayed (`pinned`) and with the router's own
    (`free`)."""
    B, S = tokens.shape
    n0 = S - n_new
    log = []
    with _moe_routing(_recorded(log)):
        full, _ = model.prefill(tokens, max_len=S)
    n_moe, k = len(log), log[0].shape[-1]
    rows = [t.reshape(B, S, k) for t in log]

    def choices(call):
        layer, step = call % n_moe, call // n_moe
        if step == 0:
            return rows[layer][:, :n0].reshape(B * n0, k)
        return rows[layer][:, n0 + step - 1]

    def run():
        logits, cache = model.prefill(tokens[:, :n0], max_len=S)
        for t in range(n0, S):
            logits, cache = model.decode_step(tokens[:, t:t + 1], cache, t)
        return (logits.float() - full.float()).abs().max().item() \
            / full.float().abs().max().item()
    flips = []
    with _moe_routing(_replayed(choices, flips)):
        pinned = run()
    return dict(pinned=dict(logits_rel_err=pinned, routing_flips=sum(flips)),
                free=dict(logits_rel_err=run()), decoded=n_new)


# ---------------------------------------------------------------------------
# the lifecycle builtins, rand and parfor (grid search, cross validation)
# ---------------------------------------------------------------------------

LIFE_M, LIFE_N = 100_000, 1_000   # the lmds point
LIFE_ITERS = 10                   # kmeans / l2svm / mlogreg max_iter (cut)
GRID_K = 70                       # paper_hpo.k_models
CV_FOLDS = 8                      # paper_hpo.n_folds
# (batch, rows, cols) of the batched kernel rows at the paper's size (8
# folds of 100,000 x 1,000): CV's training stacks, the shape of the path's
# batched launches (7 folds a configuration), and one fold a configuration
CV_STACK = (CV_FOLDS, LIFE_M // CV_FOLDS * (CV_FOLDS - 1), LIFE_N)
BATCHED = (CV_FOLDS, LIFE_M // CV_FOLDS, LIFE_N)


def _host_peak_gb() -> float:
    """The process's peak resident host memory so far, in GB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _htod_s(by_name: dict) -> float:
    """Seconds of host-to-device copies in a trace's {name: device s}."""
    return sum(v for k, v in by_name.items() if "HtoD" in k)


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _trace_of(fn, dev):
    """On the card, a separate call of `fn` under the profiler: its wall
    (the profiler's cost included), device busy and host-to-device copy
    seconds; None elsewhere. Walls and launches are taken from untraced
    calls."""
    import torch
    if torch.device(dev).type != "cuda":
        return None
    _, wall, busy, by_name = device_trace(fn)
    htod = _htod_s(by_name)
    return dict(wall_s=wall, device_busy_s=busy, htod_s=htod,
                upload_share=htod / wall)


def _kmeans_xtv(xk, run: dict, dev) -> dict:
    """kmeans' per-cluster sums AᵀX (A one-hot, 8 columns; X 1,000) as one
    xtv at the lmds point: a narrow X and a wide v, where the xtv plan was
    tuned for one column of v. Against the plain version (float64) with
    the kernel's plan, its split workspace and torch.matmul's time."""
    import numpy as np
    import torch
    from repro_torch.kernels.gram import ops, ref
    m, n = xk.shape
    lab = np.random.default_rng(SEED).integers(0, 8, size=m)
    a = torch.from_numpy(np.eye(8)[lab]).to(dev)
    x = torch.from_numpy(xk).to(dev)
    saved = dict(ops.LAUNCHES)
    got = ops.xtv_cuda(a, x)
    err = ref.scaled_err(got, ref.xtv(a, x), a, x)
    ms = cuda_ms(lambda: ops.xtv_cuda(a, x))
    ops.LAUNCHES.update(saved)  # timing launches are not the path's
    splits, rows = ops.xtv_plan(m, 8, n, torch.float64,
                                ops._sm_count(x.device))
    bms, by = bound("xtv", m, 8, n, "float64",
                    peaks_for(torch.cuda.get_device_name(0))[1])
    return dict(shape=[m, 8, n], scaled_err=err, ok=err <= TOL["float64"],
                ms=ms, library_ms=cuda_ms(lambda: torch.matmul(a.mT, x)),
                bound_ms=bms, bound_by=by, splits=splits,
                rows_per_split=rows,
                workspace_mb=splits * 8 * n * 8 / 2**20,
                path_launches=run["launches"]["xtv"])


def phase_algorithms(dev=DEVICE, m: int = LIFE_M, n: int = LIFE_N,
                     iters: int = LIFE_ITERS) -> dict:
    """pca, kmeans, l2svm and mlogreg at the lmds point on the card, each
    against the same call on the CPU (the CPU tests' limits). Returns the
    gram/xtv launches of the card's runs."""
    import numpy as np
    import torch
    from repro_torch.core import LineageRuntime, compile_plan, input_tensor, ops
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import kmeans, l2svm, mlogreg, pca
    rng = np.random.default_rng(SEED)
    # ten leading directions of distinct variance, the rest unit
    scales = np.concatenate([np.linspace(10.0, 5.5, 10), np.ones(n - 10)])
    xn = rng.standard_normal((m, n)) * scales
    y_svm = np.sign(xn @ rng.standard_normal((n, 1)) + 1e-9)
    labels = np.argmax(xn @ rng.standard_normal((n, 10)), axis=1)
    y_oh = np.eye(10)[labels]
    centers = 3.0 * rng.standard_normal((8, n))
    xk = centers[rng.integers(0, 8, size=m)] + rng.standard_normal((m, n))

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    # the lane the compiler picks for pca's covariance
    X = input_tensor("X", xn)
    cov_plan = compile_plan([ops.gram(X - ops.colMeans(X)) * (1.0 / (m - 1))])
    lane = "chunked" if cov_plan.chunk_sliced else "in-memory"

    runs = {
        "pca": (lambda rt, a=xn: pca(input_tensor("X", a), 10, runtime=rt),
                1),
        "kmeans": (lambda rt: kmeans(input_tensor("X", xk), 8,
                                     max_iter=iters, seed=1, tol=0.0,
                                     runtime=rt), iters),
        "l2svm": (lambda rt: l2svm(input_tensor("X", xn),
                                   input_tensor("y", y_svm),
                                   max_iter=iters, tol=0.0, runtime=rt),
                  iters),
        "mlogreg": (lambda rt: mlogreg(input_tensor("X", xn),
                                       input_tensor("Y", y_oh),
                                       max_iter=iters, runtime=rt), iters),
    }
    rows, launches = {}, {}
    for name, (fn, its) in runs.items():
        rt = LineageRuntime(device=dev)
        gops.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        got = fn(rt)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches[name] = dict(gops.LAUNCHES)
        traced = _trace_of(lambda: fn(LineageRuntime(device=dev)), dev)
        t0 = time.perf_counter()
        want = fn(LineageRuntime(device="cpu"))
        cpu_s = time.perf_counter() - t0
        if name == "pca":
            s = np.where(np.sum(got[0] * want[0], axis=0) < 0, -1.0, 1.0)
            err = dict(components=float(np.max(np.abs(got[0] * s - want[0]))),
                       projections=rel(got[1] * s, want[1]))
            ok = err["components"] <= 1e-10 and err["projections"] <= 1e-10
        elif name == "kmeans":
            err = dict(centers=float(np.max(np.abs(got[0] - want[0]))),
                       assignments_differ=int(np.sum(got[1] != want[1])))
            ok = err["centers"] <= 1e-10 and err["assignments_differ"] == 0
        else:
            err = dict(rel=rel(got, want))
            ok = err["rel"] <= 1e-9
        rows[name] = dict(wall_s=wall, iterations=its,
                          s_per_iteration=wall / its, traced=traced,
                          cpu_s=cpu_s, err_vs_cpu=err,
                          launches=launches[name], ok=ok)
    kmeans_xtv = _kmeans_xtv(xk, rows["kmeans"], dev) \
        if torch.device(dev).type == "cuda" else None
    row = dict(phase="algorithms", shape=[m, n], dtype="float64",
               pca_k=10, pca_lane=lane, kmeans_k=8, mlogreg_classes=10,
               kmeans_xtv=kmeans_xtv,
               cut=dict(max_iter=iters, note="kmeans, l2svm and mlogreg stop "
                        f"after {iters} iterations (tol 0)"),
               runs=rows)
    emit(row)
    if not all(r["ok"] for r in rows.values()) or (
            kmeans_xtv is not None and not kmeans_xtv["ok"]):
        raise AssertionError(f"algorithms disagree with the CPU: {row}")
    if not (launches["pca"]["gram"] and launches["kmeans"]["xtv"]
            and launches["l2svm"]["xtv"] and launches["mlogreg"]["xtv"]):
        raise AssertionError(f"algorithms missed gram/xtv: {launches}")
    return launches


def phase_cleaning(dev=DEVICE, m: int = LIFE_M, n: int = LIFE_N) -> None:
    """Every cleaning builtin on m x n float64 with 1 % NaNs against
    numpy's nan-aware functions (mice_lite, whose 1,000 regressions a
    round do not fit the phase, on 8 columns, against the CPU)."""
    import numpy as np
    from repro_torch.core import LineageRuntime, input_tensor
    from repro_torch.lifecycle import cleaning as cl
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((m, n)) * (1.0 + np.arange(n) / n)
    x[rng.random((m, n)) < 0.01] = np.nan
    nan = np.isnan(x)
    q = np.nanquantile(x, [0.05, 0.25, 0.5, 0.75, 0.95], axis=0,
                       keepdims=True)
    mean = np.nanmean(x, axis=0, keepdims=True)
    imputed = np.where(nan, mean, x)
    lo, hi = q[1] - 1.5 * (q[3] - q[1]), q[3] + 1.5 * (q[3] - q[1])
    mu_i, sd_i = imputed.mean(0, keepdims=True), imputed.std(0, ddof=1,
                                                             keepdims=True)

    def same(got, want, rtol=1e-12):
        if got.shape != want.shape:
            return float("inf")
        gn, wn = np.isnan(got), np.isnan(want)
        if not np.array_equal(gn, wn):
            return float("inf")
        scale = max(float(np.max(np.abs(want[~wn]), initial=0.0)), 1e-300)
        return float(np.max(np.abs(got[~wn] - want[~wn]), initial=0.0)
                     / scale)

    checks = {
        "impute_by_mean": (lambda rt: cl.impute_by_mean(
            input_tensor("X", x), runtime=rt), imputed),
        "impute_by_median": (lambda rt: cl.impute_by_median(
            input_tensor("X", x), runtime=rt), np.where(nan, q[2], x)),
        "outlier_by_iqr": (lambda rt: cl.outlier_by_iqr(
            input_tensor("X", x), repair="nan", runtime=rt),
            np.where((x < lo) | (x > hi), np.nan, x)),
        "winsorize": (lambda rt: cl.winsorize(
            input_tensor("X", x), runtime=rt), np.clip(x, q[0], q[4])),
        # the mean/sd builtins are not nan-aware (as in the reference): a
        # pipeline runs them on the mean-imputed matrix
        "outlier_by_sd": (lambda rt: cl.outlier_by_sd(
            input_tensor("Xi", imputed), k=3.0, repair="flag", runtime=rt),
            (np.abs(imputed - mu_i) > 3.0 * sd_i).astype(np.float32)),
        "scale_matrix": (lambda rt: cl.scale_matrix(
            input_tensor("Xi", imputed), runtime=rt),
            (imputed - mu_i) / sd_i),
    }
    rows, ok = {}, True
    for name, (fn, want) in checks.items():
        rt = LineageRuntime(device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        got = fn(rt)
        wall = time.perf_counter() - t0
        err = same(np.asarray(got, dtype=want.dtype), want)
        good = err <= 1e-12
        rows[name] = dict(wall_s=wall, rel_err_vs_numpy=err, ok=good)
        ok &= good
    # mice_lite: chained regressions, held against the CPU run
    xm = x[:, :8].copy()
    t0 = time.perf_counter()
    got = cl.mice_lite(input_tensor("Xm", xm), n_iter=2,
                       runtime=LineageRuntime(device=dev))
    wall = time.perf_counter() - t0
    want = cl.mice_lite(input_tensor("Xm", xm), n_iter=2,
                        runtime=LineageRuntime(device="cpu"))
    err = same(got, want)
    rows["mice_lite"] = dict(wall_s=wall, shape=list(xm.shape),
                             rel_err_vs_cpu=err, ok=err <= 1e-10)
    ok &= err <= 1e-10
    row = dict(phase="cleaning", shape=[m, n], dtype="float64",
               nan_share=float(nan.mean()), builtins=rows,
               cut="mice_lite on 8 of the 1,000 columns, 2 rounds")
    emit(row)
    if not ok:
        raise AssertionError(f"cleaning builtins disagree: {row}")


def phase_rand(dev=DEVICE, shape=(LIFE_M, LIFE_N), seed: int = 42,
               block: int = 2000) -> None:
    """`ops.rand(shape, seed, "normal", sparsity=0.1)` through the runtime
    on the card, bitwise against the CPU's draw of three row blocks."""
    import numpy as np
    import torch
    from repro_torch.core import LineageRuntime, ops
    from repro_torch.core import random as trand
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    got = LineageRuntime(device=dev).evaluate(
        [ops.rand(shape, seed, "normal", sparsity=0.1)])[0]
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if torch.device(dev).type == "cuda" else None)
    m = shape[0]
    blocks = [(0, block), (m // 2 - block // 2, m // 2 + block // 2),
              (m - block, m)]
    same = []
    t0 = time.perf_counter()
    for r0, r1 in blocks:
        want = trand.rand(shape, seed, "normal", 0.1, "cpu",
                          rows=(r0, r1)).numpy()
        same.append(bool(np.array_equal(got[r0:r1].view(np.int64),
                                        want.view(np.int64))))
    cpu_s = time.perf_counter() - t0
    nz = got[got != 0]
    row = dict(phase="rand", shape=list(shape), seed=seed, dist="normal",
               sparsity=0.1, wall_s=wall, peak_device_gb=peak,
               density=float(nz.size / got.size), mean=float(nz.mean()),
               std=float(nz.std()), bitwise_vs_cpu=same, cpu_s=cpu_s,
               cut=f"the CPU draws rows {blocks} ({3 * block:,} of {m:,}; "
                   "a whole CPU draw takes ~50 s)")
    emit(row)
    if not (all(same) and abs(row["density"] - 0.1) < 1e-3
            and abs(row["std"] - 1.0) < 1e-2):
        raise AssertionError(f"rand on the card failed: {row}")


def phase_grid_search(dev=DEVICE, m: int = LIFE_M, n: int = LIFE_N,
                      k: int = GRID_K) -> dict:
    """grid_search_lm (Fig. 5) over k λs at the lmds point: auto mode,
    forced vmap and the sequential loop with a ReuseCache, against each
    other and numpy's solve."""
    import numpy as np
    from repro_torch.core import LineageRuntime, ReuseCache, input_tensor
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import grid_search_lm
    rng = np.random.default_rng(SEED + 2)
    xn = rng.standard_normal((m, n))
    yn = xn @ rng.standard_normal((n, 1)) + 0.1 * rng.standard_normal((m, 1))
    lams = list(np.logspace(-3, 4, k))
    g, b = xn.T @ xn, xn.T @ yn
    want = np.concatenate([np.linalg.solve(g + lam * np.eye(n), b)
                           for lam in lams], axis=1)
    runs, betas = {}, {}
    for mode in ("auto", "vmap", "sequential"):
        rt = LineageRuntime(cache=None if mode == "vmap" else ReuseCache(),
                            device=dev)
        gops.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        beta, _ = grid_search_lm(input_tensor("X", xn), input_tensor("y", yn),
                                 lams, runtime=rt, mode=mode)
        wall = time.perf_counter() - t0
        betas[mode] = beta
        runs[mode] = dict(
            wall_s=wall, batched_segments=rt.stats.batched_segments,
            mode_chosen=("vmap" if rt.stats.batched_segments else
                         "sequential"),
            launches=dict(gops.LAUNCHES),
            rel_err_vs_numpy=float(np.max(np.abs(beta - want))
                                   / np.max(np.abs(want))),
            reuse_hits=None if rt.cache is None else rt.cache.stats.hits)
    agree = max(float(np.max(np.abs(betas[a] - betas["vmap"]))
                      / np.max(np.abs(betas["vmap"])))
                for a in ("auto", "sequential"))
    row = dict(phase="grid_search", shape=[m, n], k=k, runs=runs,
               max_rel_diff_between_modes=agree)
    emit(row)
    ok = (agree <= 1e-8 and all(r["rel_err_vs_numpy"] <= 1e-9
                                for r in runs.values())
          and runs["vmap"]["batched_segments"] > 0
          and runs["sequential"]["batched_segments"] == 0)
    if not ok:
        raise AssertionError(f"grid search failed: {row}")
    return runs["vmap"]["launches"]


def _sparse_fold_row(kind, xd, mask, w, peaks) -> dict:
    """One masked product under torch.func.vmap over a batch of w (the
    sparse grid's X @ β over the λs): the batch folds into one launch of
    the hand kernel with k·c columns. Against k lone calls and the plain
    version (float64, within TOL), bitwise against a second call, with
    device, bound, the lone calls' summed and the library's times."""
    import torch
    from repro_torch.kernels.gram.ref import scaled_err
    from repro_torch.kernels.spmm import ops, ref
    k, rows, c = w.shape
    m, n = xd.shape
    op, lone, plain = ((ops.spmm_masked_op, ops.spmm_cuda, ref.spmm)
                       if kind == "spmm" else
                       (ops.xtv_masked_op, ops.xtv_bs_cuda, ref.xtv))
    fn = torch.func.vmap(op, in_dims=(None, 0, None))
    a = xd.mT if kind == "spmm" else xd
    cols = w.permute(1, 0, 2).reshape(rows, k * c)
    lib = ((lambda: torch.matmul(xd, cols)) if kind == "spmm" else
           (lambda: torch.matmul(xd.mT, cols)))
    saved = dict(ops.LAUNCHES)
    got = fn(xd, w, mask)
    counts = {key: ops.LAUNCHES[key] - saved[key] for key in saved
              if ops.LAUNCHES[key] != saved[key]}
    lones = [lone(xd, w[b], mask) for b in range(k)]
    plains = [plain(xd, w[b], mask, ops.ROWS, ops.TILE) for b in range(k)]
    torch.cuda.synchronize()
    err_lone = max(scaled_err(got[b], lones[b], a, w[b]) for b in range(k))
    err_plain = max(scaled_err(got[b], plains[b], a, w[b])
                    for b in range(k))
    max_abs = max((got[b] - plains[b]).abs().max().item() for b in range(k))
    bitwise = torch.equal(got, fn(xd, w, mask))
    ms = cuda_ms(lambda: fn(xd, w, mask))
    us = host_us(lambda: fn(xd, w, mask), calls=50)
    lone_ms = cuda_ms(lambda: [lone(xd, w[b], mask) for b in range(k)])
    dev_ms, pass_ms, events = per_call_ms(lambda: fn(xd, w, mask))
    ops.LAUNCHES.update(saved)  # timing launches are not the path's
    plain_ms = cuda_ms(lambda: [plain(xd, w[b], mask, ops.ROWS, ops.TILE)
                                for b in range(k)], iters=5)
    row = dict(phase="sparse_kernel", kernel=kind, route="fold", batch=k,
               m=m, n=n, c=c, dtype="float64",
               launches_per_call=counts, max_abs_err=max_abs,
               scaled_err_lone=err_lone, scaled_err_plain=err_plain,
               tol=TOL["float64"], bitwise_repeat=bitwise, ms=ms,
               device_ms=dev_ms, pass_ms=pass_ms, trace_events=events,
               host_us=us, lone_ms=lone_ms, plain_ms=plain_ms,
               library_ms=cuda_ms(lib),
               **sparse_bounds(kind, mask, m, n, k * c, "float64", peaks))
    row["ok"] = (err_lone <= TOL["float64"] and err_plain <= TOL["float64"]
                 and bitwise and counts.get(kind) == 1
                 and set(counts) <= {kind, f"{kind}_reduce"})
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"{kind} under vmap failed: {row}")
    return row


def phase_sparse_grid(peaks: dict, m: int = LIFE_M, n: int = LIFE_N,
                      k: int = GRID_K) -> dict:
    """grid_search_lm over k λs on the bcoo lane (sparse_inputs, the lmds
    point's blocky X of density 0.05), forced vmap: the λ-invariant
    gram_bs/xtv_bs once, the variant suffix's X @ β one spmm launch over
    the λs folded into columns. Against the dense lane's vmap grid on the
    same data and numpy's solve over the populated blocks; and the fold
    of spmm and xtv_bs at this shape against lone calls and the plain
    version. Returns the sparse kernels' launches in the grid run and the
    fold rows."""
    import numpy as np
    import torch
    from repro_torch.core import LineageRuntime, input_tensor
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref
    from repro_torch.lifecycle import grid_search_lm
    rng = np.random.default_rng(SEED + 6)
    xh, keep = blocky(rng, m, n, *BLOCKY)
    yh = xh @ rng.standard_normal((n, 1)) + 0.1 * rng.standard_normal((m, 1))
    density = float(np.count_nonzero(xh)) / xh.size
    lams = list(np.logspace(-3, 4, k))
    g, b = blocky_gram(xh, keep), xh.T @ yh
    want = np.concatenate([np.linalg.solve(g + lam * np.eye(n), b)
                           for lam in lams], axis=1)
    runs, betas = {}, {}
    for lane in ("sparse", "dense"):
        rt = LineageRuntime(sparse_inputs=lane == "sparse", device=DEVICE)
        gops.reset_launches()
        sops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beta, _ = grid_search_lm(
            input_tensor("X", xh, sparsity=density), input_tensor("y", yh),
            lams, runtime=rt, mode="vmap")
        wall = time.perf_counter() - t0
        betas[lane] = beta
        runs[lane] = dict(
            wall_s=wall, batched_segments=rt.stats.batched_segments,
            launches={**sops.LAUNCHES, **gops.LAUNCHES},
            rel_err_vs_numpy=float(np.max(np.abs(beta - want))
                                   / np.max(np.abs(want))))
    diff = float(np.max(np.abs(betas["sparse"] - betas["dense"]))
                 / np.max(np.abs(betas["dense"])))
    # the fold alone at the grid's shapes: X @ β (k columns of n rows) and
    # Xᵀv (k columns of m rows)
    xd = torch.from_numpy(xh).to(DEVICE)
    mask = sref.block_mask(xd, sops.ROWS, sops.TILE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    folds = {kind: _sparse_fold_row(
        kind, xd, mask, torch.randn((k, rows, 1), generator=gen,
                                    device=DEVICE, dtype=torch.float64),
        peaks) for kind, rows in (("spmm", n), ("xtv_bs", m))}
    del xd, mask
    torch.cuda.empty_cache()
    row = dict(phase="sparse_grid", shape=[m, n], density=density, k=k,
               runs=runs, rel_diff_sparse_vs_dense=diff)
    emit(row)
    ls = runs["sparse"]["launches"]
    ok = (diff <= 1e-8
          and all(r["rel_err_vs_numpy"] <= 1e-9 for r in runs.values())
          and runs["sparse"]["batched_segments"] > 0
          and ls["spmm"] == 1 and ls["gram_bs"] == 1 and ls["xtv_bs"] == 1
          and ls["gram"] == 0 and ls["xtv"] == 0)
    if not ok:
        raise AssertionError(f"sparse grid search failed: {row}")
    return dict(launches=ls, folds=folds)


def phase_cv(dev=DEVICE, m: int = LIFE_M, n: int = LIFE_N,
             folds: int = CV_FOLDS) -> dict:
    """cross_validate_lm (Fig. 7) over `folds` folds at the lmds point:
    forced vmap (the fold grams and xtvs as batched launches) against the
    sequential loop with a ReuseCache. Returns the vmap run's launches."""
    import numpy as np
    import torch
    from repro_torch.core import LineageRuntime, ReuseCache
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import cross_validate_lm, make_folds
    rng = np.random.default_rng(SEED + 3)
    xn = rng.standard_normal((m, n))
    yn = xn @ rng.standard_normal((n, 1)) + 0.1 * rng.standard_normal((m, 1))
    runs, out = {}, {}
    for mode in ("vmap", "sequential"):
        rt = LineageRuntime(cache=ReuseCache() if mode == "sequential"
                            else None, device=dev)
        fx, fy = make_folds(xn, yn, folds, seed=3)
        gops.reset_launches()
        cuda = torch.device(dev).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[mode] = cross_validate_lm(fx, fy, runtime=rt, mode=mode)
        _sync(dev)
        wall = time.perf_counter() - t0
        runs[mode] = dict(
            wall_s=wall, batched_segments=rt.stats.batched_segments,
            launches=dict(gops.LAUNCHES),
            peak_device_gb=(torch.cuda.max_memory_allocated() / 2**30
                            if cuda else None),
            peak_host_gb=_host_peak_gb())
        if cuda and mode == "vmap":
            # a second vmap run under the profiler: the batched kernels'
            # device time at the path's own shapes (its wall is not used)
            fx, fy = make_folds(xn, yn, folds, seed=3)
            _, twall, busy, by_name = device_trace(
                lambda: cross_validate_lm(
                    fx, fy, runtime=LineageRuntime(device=dev), mode=mode))
            runs[mode]["traced"] = dict(
                wall_s=twall, device_busy_s=busy, kernel_ms={
                    k: 1e3 * v for k, v in by_name.items()
                    if "gram_" in k or "xtv_" in k})
    (bv, ev), (bs, es) = out["vmap"], out["sequential"]
    diff = float(np.max(np.abs(bv - bs)) / np.max(np.abs(bs)))
    ediff = float(np.max(np.abs(np.subtract(ev, es)) / np.abs(es)))
    row = dict(phase="cv", shape=[m, n], folds=folds,
               fold_rows=m // folds, runs=runs, max_rel_diff_beta=diff,
               max_rel_diff_mse=ediff)
    emit(row)
    lv = runs["vmap"]["launches"]
    if not (diff <= 1e-8 and ediff <= 1e-8
            and runs["vmap"]["batched_segments"] > 0
            and lv["gram_batched"] > 0 and lv["xtv_batched"] > 0
            and lv["gram"] == 0):
        raise AssertionError(f"cross validation failed: {row}")
    return lv


def batched_bound(kind: str, k: int, m: int, n: int, c: int, dtype: str,
                  peaks: dict, v_batched: bool = True,
                  x_batched: bool = True) -> tuple[float, str]:
    """`bound` for a batch of k products: every input read once (a shared
    X or v once for the batch), every output written once."""
    size = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    out = 8 if dtype == "float64" else 4
    if kind == "gram":
        ops_, nbytes = k * m * n * (n + 1), k * (m * n * size + n * n * out)
    else:
        ops_ = 2 * k * m * n * c
        nbytes = ((k if x_batched else 1) * m * n * size
                  + (k if v_batched else 1) * m * c * size + k * n * c * out)
    t_ops, t_bytes = ops_ / peaks[dtype], nbytes / peaks["bw"]
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_batched_kernels(peaks: dict, stack=CV_STACK,
                          fold=BATCHED) -> dict:
    """gram and xtv under torch.func.vmap: one batched launch (plus its
    reduce). At CV's training-stack shape `stack` in float64, the path's
    own launches; at `fold` in float64/float32/bfloat16, with xtv's
    broadcast-v and fold routes. Each against k lone calls (within TOL)
    and the plain version computed in float64 from the same inputs
    (within TOL), bitwise against a second call, with device, bound, the
    lone calls' summed and the library's (torch.bmm) times. Returns the
    stack rows by kernel."""
    import numpy as np
    import torch
    from repro_torch.interop import from_reference
    from repro_torch.kernels.gram import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
    # the stack drawn on the card (5.6 GB in float64), the fold on the host
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    k0, m0, n0 = stack
    inputs = {
        stack: {"x": torch.randn(stack, generator=gen, device="cuda",
                                 dtype=torch.float64),
                "v": torch.randn((k0, m0, 1), generator=gen, device="cuda",
                                 dtype=torch.float64)}}
    rng = np.random.default_rng(SEED + 4)
    k1, m1, n1 = fold
    inputs[fold] = from_reference({"x": rng.standard_normal(fold),
                                   "v": rng.standard_normal((k1, m1, 1))},
                                  "cuda")
    cases = [(stack, "gram", "batched", "float64"),
             (stack, "xtv", "batched", "float64")] \
        + [(fold, "gram", "batched", name) for name in dt] \
        + [(fold, "xtv", "batched", name) for name in dt] \
        + [(fold, "xtv", "broadcast", "float64"),
           (fold, "xtv", "fold", "float64")]

    def plan(kind, route, x):
        k, m, n = x.shape
        sms = ops._sm_count(x.device)
        if kind == "gram":
            return ops.gram_plan(m, n, x.dtype, sms, ops.GRAM_TILE_N, k)
        if route == "fold":  # one xtv of k columns
            return ops.xtv_plan(m, n, k, x.dtype, sms)
        return ops.xtv_plan(m, n, 1, x.dtype, sms, k)

    main = {}
    for shape, kind, route, name in cases:
        k, m, n = shape
        x = inputs[shape]["x"].to(dt[name])
        v = inputs[shape]["v"].to(dt[name])
        if kind == "gram":
            fn = (lambda x=x: torch.func.vmap(ops.gram_op)(x))
            lone = (lambda x=x: [ops.gram_cuda(x[i]) for i in range(k)])
            lib = (lambda x=x: torch.bmm(x.mT, x))
            pairs = [(x[i], x[i]) for i in range(k)]
            bms, by = batched_bound("gram", k, m, n, 0, name, peaks)
        elif route == "batched":
            fn = (lambda x=x, v=v: torch.func.vmap(ops.xtv_op)(x, v))
            lone = (lambda x=x, v=v: [ops.xtv_cuda(x[i], v[i])
                                      for i in range(k)])
            lib = (lambda x=x, v=v: torch.bmm(x.mT, v))
            pairs = [(x[i], v[i]) for i in range(k)]
            bms, by = batched_bound("xtv", k, m, n, 1, name, peaks)
        elif route == "broadcast":
            fn = (lambda x=x, v=v: torch.func.vmap(
                ops.xtv_op, in_dims=(0, None))(x, v[0]))
            lone = (lambda x=x, v=v: [ops.xtv_cuda(x[i], v[0])
                                      for i in range(k)])
            lib = (lambda x=x, v=v: torch.matmul(x.mT, v[0]))
            pairs = [(x[i], v[0]) for i in range(k)]
            bms, by = batched_bound("xtv", k, m, n, 1, name, peaks,
                                    v_batched=False)
        else:  # fold: one X, a batch of v
            fn = (lambda x=x, v=v: torch.func.vmap(
                ops.xtv_op, in_dims=(None, 0))(x[0], v))
            lone = (lambda x=x, v=v: [ops.xtv_cuda(x[0], v[i])
                                      for i in range(k)])
            lib = (lambda x=x, v=v: torch.matmul(x[0].mT, v))
            pairs = [(x[0], v[i]) for i in range(k)]
            bms, by = batched_bound("xtv", k, m, n, 1, name, peaks,
                                    x_batched=False)
        saved = dict(ops.LAUNCHES)
        got = fn()
        counts = {key: ops.LAUNCHES[key] - saved[key] for key in saved
                  if ops.LAUNCHES[key] != saved[key]}
        lones = lone()
        torch.cuda.synchronize()
        err_lone = max(ref.scaled_err(got[i], lones[i], a, b)
                       for i, (a, b) in enumerate(pairs))
        # plain version in float64 from the same inputs: at 12,500 rows
        # two float32 summation orders (this kernel's, cuBLAS's) differ by
        # up to ~1.6e-5 of the column-norm scale, so the float32 plain
        # run is reported (scaled_err_plain) and the float64 one is held
        plain64 = [ref.gram(a.double()) if kind == "gram"
                   else ref.xtv(a.double(), b.double()) for a, b in pairs]
        err64 = max(ref.scaled_err(got[i], plain64[i], a, b)
                    for i, (a, b) in enumerate(pairs))
        plain = [ref.gram(a) if kind == "gram" else ref.xtv(a, b)
                 for a, b in pairs]
        err_plain = max(ref.scaled_err(got[i], plain[i], a, b)
                        for i, (a, b) in enumerate(pairs))
        max_abs = max((got[i].double() - plain64[i]).abs().max().item()
                      for i in range(k))
        bitwise = torch.equal(got, fn())
        ok = err_lone <= TOL[name] and err64 <= TOL[name] and bitwise
        if kind == "gram" and not torch.equal(got, got.mT):
            ok = False
        ms = cuda_ms(fn)
        lone_ms = cuda_ms(lone)
        plain_ms = cuda_ms(lambda: [ref.gram(a) if kind == "gram"
                                    else ref.xtv(a, b) for a, b in pairs])
        library_ms = cuda_ms(lib)
        dev_ms, pass_ms, events = per_call_ms(fn)
        us = host_us(fn, calls=20)
        ops.LAUNCHES.update(saved)  # timing launches are not the path's
        row = dict(phase="kernel", kernel=f"{kind}_batched", route=route,
                   case="cv_stack" if shape == stack else "cv_fold",
                   batch=k, m=m, n=n, c=None if kind == "gram" else 1,
                   dtype=name, launches_per_call=counts,
                   max_abs_err=max_abs, scaled_err_lone=err_lone,
                   scaled_err_plain64=err64, scaled_err_plain=err_plain,
                   tol=TOL[name], bitwise_repeat=bitwise, ok=ok, ms=ms,
                   device_ms=dev_ms, pass_ms=pass_ms, trace_events=events,
                   host_us=us,
                   lone_ms=lone_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=by,
                   plan=plan(kind, route, x))
        emit(row)
        if not ok:
            raise AssertionError(f"{kind} {route} {name} failed: {row}")
        # one launch of the batched kernel (the fold: of the lone xtv)
        # and at most one of its reduce, nothing else
        one = ("xtv" if route == "fold" else f"{kind}_batched")
        if counts.get(one) != 1 or any(
                key not in (one, f"{one}_reduce") or c != 1
                for key, c in counts.items()):
            raise AssertionError(f"{kind} {route} {name}: launches per "
                                 f"call {counts}, not one batched launch")
        if shape == stack:
            main[f"{kind}_batched"] = row
        del x, v, got, lones, plain64, plain
    del inputs
    torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------------------
# the lifecycle's two ends: CSV ingestion, frames, checkpoints; plan serving
# ---------------------------------------------------------------------------

LIFE_ROWS = 1_000_000             # examples/lifecycle_pipeline.py: 4,000
CSV_SHAPE = (100_000, 200)        # 199 features and y, float64
CSV_CHUNK = 8192                  # rows a chunk (read_csv_chunks)
CSV_PREFIX = 16_384               # rows of the file the faulted read takes
LIFE_COLUMNS = [("age", "f64"), ("income", "f64"), ("tenure", "f64"),
                ("region", "str"), ("score", "f64")]


def messy_csv(path: str, n: int) -> None:
    """examples/lifecycle_pipeline.py's `synthesize_messy_csv` (same
    columns, rates, seed and draws, in the same order), its row loop's
    draws taken at once: a raw file with a categorical column, 2 % gross
    income outliers and 5 % of incomes missing."""
    import numpy as np
    rng = np.random.default_rng(42)
    age = rng.integers(18, 80, n).astype(float)
    income = rng.lognormal(10, 0.5, n)
    income[rng.random(n) < 0.02] *= 50
    tenure = rng.exponential(5, n)
    region = rng.choice(["north", "south", "east", "west"], n)
    score = (0.04 * age + 0.8 * np.log(income) - 0.2 * tenure
             + (region == "north") * 1.5 + rng.normal(0, 0.3, n))
    missing = rng.random(n) < 0.05
    rows = [f"{a:.0f},{'' if m else f'{i:.2f}'},{t:.3f},{r},{s:.4f}"
            for a, i, t, r, s, m in zip(age.tolist(), income.tolist(),
                                        tenure.tolist(), region.tolist(),
                                        score.tolist(), missing.tolist())]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def _pipeline(cols: dict, dev, ckpt_dir: str) -> dict:
    """The example's steps after ingestion on `dev`: schema, cleaning,
    transformencode, steplm, the 12-λ grid and 5-fold CV (sequential with
    reuse), then the chosen β checkpointed and restored onto `dev`."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import restore, save
    from repro_torch.core import LineageRuntime, ReuseCache, input_tensor
    from repro_torch.core.hetero import DataTensor, transformencode
    from repro_torch.lifecycle import (cross_validate_lm, grid_search_lm,
                                       impute_by_mean, make_folds,
                                       outlier_by_iqr, steplm)
    secs = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        secs[name] = time.perf_counter() - t0
        return out

    dt = stage("schema", lambda: DataTensor.from_dict(
        {k: cols[k] for k in ("age", "income", "tenure", "region")},
        types={"region": "str"}))

    def clean():
        rt = LineageRuntime(device=dev)
        x = outlier_by_iqr(input_tensor("Xraw", dt.numeric_matrix()),
                           k=3.0, repair="clip", runtime=rt)
        return impute_by_mean(input_tensor("Xclip", x), runtime=rt)
    x_num = stage("clean", clean)
    for j, name in enumerate(("age", "income", "tenure")):
        dt.columns[dt.names.index(name)] = x_num[:, j]
    x, meta = stage("transformencode", lambda: transformencode(
        dt, {"age": "scale", "income": "scale", "tenure": "scale",
             "region": "dummycode"}))
    y = cols["score"][:, None]
    rt = LineageRuntime(cache=ReuseCache(), device=dev)
    X, Y = input_tensor("X", x), input_tensor("y", y)
    beta_sel, selected = stage("steplm", lambda: steplm(
        X, Y, max_features=5, runtime=rt))
    lambdas = np.logspace(-3, 2, 12).tolist()
    betas, losses = stage("grid", lambda: grid_search_lm(
        X, Y, lambdas, runtime=rt, mode="sequential"))
    best = int(np.argmin(losses))
    fx, fy = make_folds(x, y, 5, seed=0)
    _, cv_errs = stage("cv", lambda: cross_validate_lm(
        fx, fy, reg=lambdas[best], runtime=rt, mode="sequential"))
    beta = betas[:, best:best + 1]

    def checkpoint():
        save(ckpt_dir, 0, {"beta": beta},
             lineage={"lambda": lambdas[best], "features": meta.out_names,
                      "cv_mse": [float(e) for e in cv_errs]})
        back, manifest = restore(ckpt_dir, {"beta": torch.zeros(
            beta.shape, dtype=torch.float64, device=dev)})
        return back["beta"], manifest
    restored, manifest = stage("checkpoint", checkpoint)
    return dict(seconds=secs, schema=dt.schema, names=meta.out_names,
                selected=selected, beta_sel=beta_sel, betas=betas,
                cv_errs=np.asarray(cv_errs), reuse=rt.cache.stats.as_dict(),
                restored_device=str(restored.device),
                restored_bitwise=bool(restored.cpu().numpy().tobytes()
                                      == np.ascontiguousarray(beta).tobytes()),
                lineage_ok=manifest["lineage"]["features"] == meta.out_names)


def phase_lifecycle_pipeline(dev=DEVICE, n: int = LIFE_ROWS) -> dict:
    """examples/lifecycle_pipeline.py at `n` rows: the generated reader
    parses the raw CSV once (host numpy), then the pipeline runs on the
    card and, held against it, on the CPU. Returns the card run's gram/xtv
    launches."""
    import tempfile

    import numpy as np
    from repro_torch.data.csv_io import make_reader
    from repro_torch.kernels.gram import ops as gops
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "customers.csv")
        t0 = time.perf_counter()
        messy_csv(path, n)
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        reader = make_reader({"delimiter": ",", "columns": LIFE_COLUMNS})
        t0 = time.perf_counter()
        cols = reader(path)
        parse_s = time.perf_counter() - t0
        gops.reset_launches()
        card = _pipeline(cols, dev, os.path.join(tmp, "ckpt_card"))
        launches = dict(gops.LAUNCHES)
        cpu = _pipeline(cols, "cpu", os.path.join(tmp, "ckpt_cpu"))

    def rel(k):
        return float(np.max(np.abs(card[k] - cpu[k]) / np.abs(cpu[k])))
    row = dict(phase="lifecycle_pipeline", rows=n, csv_bytes=nbytes,
               write_s=write_s, parse_s=parse_s, parse_rows_per_s=n / parse_s,
               parse_mb_per_s=nbytes / parse_s / 1e6,
               seconds=card["seconds"], seconds_cpu=cpu["seconds"],
               launches=launches, schema=card["schema"],
               selected=card["selected"], selected_cpu=cpu["selected"],
               features=card["names"], reuse=card["reuse"],
               reuse_cpu=cpu["reuse"],
               rel_beta_sel=rel("beta_sel"), rel_betas=rel("betas"),
               rel_cv_errs=rel("cv_errs"),
               restored_device=card["restored_device"],
               restored_bitwise=card["restored_bitwise"],
               cut=f"rows {n:,} (the example's 4,000)")
    emit(row)
    if not (card["selected"] == cpu["selected"]
            and card["reuse"] == cpu["reuse"] and card["reuse"]["hits"] > 0
            and card["schema"] == cpu["schema"]
            and 1 <= len(card["selected"]) <= 5
            and max(rel("beta_sel"), rel("betas"), rel("cv_errs")) <= 1e-9
            and card["restored_bitwise"] and card["lineage_ok"]
            and card["restored_device"].startswith(str(dev))
            and launches["gram"] > 0 and launches["xtv"] > 0):
        raise AssertionError(f"lifecycle pipeline failed: {row}")
    return launches


def _stream_fit(path: str, dev, reg: float, fault_log=None) -> dict:
    """read_csv_chunks at CSV_CHUNK rows; each chunk's X and y uploaded
    and fed to the gram and xtv calls the streaming lane makes per bucket,
    the partials summed on the host in row order, as the lane sums them,
    and solved."""
    import numpy as np
    import torch
    from repro_torch.data.csv_io import read_csv_chunks
    from repro_torch.kernels.gram import ops as gops
    g = b = None
    parse_s = card_s = 0.0
    t0 = time.perf_counter()
    for _, chunk in read_csv_chunks(path, CSV_CHUNK, fault_log=fault_log):
        t1 = time.perf_counter()
        parse_s += t1 - t0
        xc = torch.from_numpy(np.ascontiguousarray(chunk[:, :-1])).to(dev)
        yc = torch.from_numpy(np.ascontiguousarray(chunk[:, -1:])).to(dev)
        pg, pb = gops.gram(xc).cpu().numpy(), gops.xtv(xc, yc).cpu().numpy()
        g, b = (pg, pb) if g is None else (g + pg, b + pb)
        t0 = time.perf_counter()
        card_s += t0 - t1
    parse_s += time.perf_counter() - t0
    beta = np.linalg.solve(g + reg * np.eye(g.shape[0]), b)
    return dict(beta=beta, parse_s=parse_s, card_s=card_s)


def phase_csv_stream(dev=DEVICE, shape=CSV_SHAPE, prefix: int = CSV_PREFIX
                     ) -> dict:
    """A float64 CSV written at %.17g streamed through read_csv_chunks
    into the gram/xtv chunk partials and solved: against numpy's solve
    and lmDS on the assembled array; then a prefix of the file read again
    with two chunk-IO faults injected, bitwise the clean read's β. Returns
    the chunk loop's launches."""
    import tempfile

    import numpy as np
    from repro_torch.core import LineageRuntime, faults, input_tensor
    from repro_torch.data.csv_io import write_csv
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import lmDS
    m, n = shape
    reg = 1e-7
    rng = np.random.default_rng(SEED + 7)
    xn = rng.standard_normal((m, n - 1))
    yn = xn @ rng.standard_normal((n - 1, 1)) + 0.1 * rng.standard_normal(
        (m, 1))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xy.csv")
        t0 = time.perf_counter()
        nbytes = write_csv(path, np.hstack([xn, yn]), fmt="%.17g")
        write_s = time.perf_counter() - t0
        gops.reset_launches()
        t0 = time.perf_counter()
        run = _stream_fit(path, dev, reg)
        wall = time.perf_counter() - t0
        launches = dict(gops.LAUNCHES)
        want = np.linalg.solve(xn.T @ xn + reg * np.eye(n - 1), xn.T @ yn)
        lm = lmDS(input_tensor("Xs", xn), input_tensor("ys", yn), reg=reg,
                  runtime=LineageRuntime(device=dev))
        # the faulted read: the file's first `prefix` rows, clean and with
        # the first byte window's read failing twice (retried)
        ppath = os.path.join(tmp, "prefix.csv")
        with open(path, "rb") as src, open(ppath, "wb") as dst:
            for _ in range(prefix):
                dst.write(src.readline())
        clean = _stream_fit(ppath, dev, reg)
        flog = faults.FaultLog()
        with faults.inject("seed=1;chunk_io@0,1") as plan:
            faulted = _stream_fit(ppath, dev, reg, fault_log=flog)
    rel_np = float(np.max(np.abs(run["beta"] - want)) / np.max(np.abs(want)))
    rel_lm = float(np.max(np.abs(run["beta"] - lm)) / np.max(np.abs(lm)))
    chunks = -(-m // CSV_CHUNK)
    row = dict(phase="csv_stream", shape=[m, n], csv_bytes=nbytes,
               write_s=write_s, chunk_rows=CSV_CHUNK, chunks=chunks,
               wall_s=wall, parse_s=run["parse_s"],
               parse_mb_per_s=nbytes / run["parse_s"] / 1e6,
               card_s=run["card_s"], launches=launches,
               rel_err_vs_numpy=rel_np, rel_err_vs_lmds=rel_lm,
               faulted=dict(rows=prefix, fired=dict(plan.fired),
                            injected=flog.injected, retries=flog.retries,
                            backoff_s=flog.backoff_s,
                            bitwise=bool(np.array_equal(faulted["beta"],
                                                        clean["beta"]))),
               cut=f"the faulted read takes the first {prefix:,} rows")
    emit(row)
    if not (rel_np <= 1e-9 and rel_lm <= 1e-9
            and launches["gram"] == launches["xtv"] == chunks
            and row["faulted"]["bitwise"] and flog.injected == 2
            and flog.retries == 2 and plan.fired == {"chunk_io": 2}):
        raise AssertionError(f"CSV stream failed: {row}")
    return launches


def phase_serve_plan(dev=DEVICE, m: int = 100_000, n: int = 1_000,
                     requests: int = 256, clients: int = 16) -> dict:
    """examples/serve_plan.py at the lmds point: lmDS trained on the
    card (X streamed in 13 buckets), x (1, n) -> (x β, sigmoid(x β))
    compiled once and deployed behind ModelServer(max_batch=16,
    max_wait_us=2000); requests one after another, then from `clients`
    threads; every score bitwise the solo score and within 1e-12 of
    numpy's x @ β; a (16, n) block request; one injected coalescer crash.
    Returns the training's gram/xtv launches."""
    import threading

    import numpy as np
    import torch
    from repro_torch.core import (LineageRuntime, PreparedScript, costmodel,
                                  faults, get_jit_cache, input_tensor, ops)
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import lmDS
    from repro_torch.serving import ModelServer
    # X and y stream together: (n + 1) float64 values per row
    buckets = -(-m // costmodel.chunk_rows(8.0 * (n + 1)))
    rng = np.random.default_rng(SEED + 11)
    xn = rng.standard_normal((m, n))
    yn = xn @ rng.standard_normal((n, 1)) + 0.01 * rng.standard_normal((m, 1))
    rt = LineageRuntime(device=dev)
    gops.reset_launches()
    t0 = time.perf_counter()
    beta = lmDS(input_tensor("X", xn), input_tensor("y", yn), reg=1e-3,
                runtime=rt)
    train_s = time.perf_counter() - t0
    launches = dict(gops.LAUNCHES)
    B = input_tensor("beta", beta)

    def scoring(x):
        yhat = ops.matmul(x, B)
        return yhat, ops.sigmoid(yhat)

    script = PreparedScript(scoring, [(1, n)], runtime=rt)
    server = ModelServer(script, max_batch=16, max_wait_us=2000.0)
    jc = get_jit_cache().stats
    pinned0 = jc.pinned
    t0 = time.perf_counter()
    server.deploy()
    deploy_s = time.perf_counter() - t0
    pinned = jc.pinned - pinned0
    rows = rng.standard_normal((2 * requests, 1, n))
    preds: list = [None] * (2 * requests)
    lat = np.zeros(2 * requests)

    def score(i):
        t = time.perf_counter()
        preds[i] = server.score(rows[i], timeout=60.0)
        lat[i] = time.perf_counter() - t

    try:
        t0 = time.perf_counter()
        for i in range(requests):
            score(i)
        seq_s = time.perf_counter() - t0
        seq_log = rt.stats.serving.as_dict()

        def client(c):
            for i in range(requests + c, 2 * requests, clients):
                score(i)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        conc_s = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve_plan: a client thread hung")
        log = rt.stats.serving.as_dict()
        conc_log = {k: log[k] - seq_log[k] for k in
                    ("requests", "batches", "padded", "retraces")}
        conc_log["mean_coalesce"] = conc_log["requests"] / conc_log["batches"]
        f0 = (rt.stats.faults.restarts, rt.stats.faults.injected)
        with faults.inject("seed=1;serving_dispatch@0"):
            try:
                server.score(rows[0], timeout=60.0)
                crashed = False
            except faults.InjectedFault:
                crashed = True
            after, = server.score(rows[1], timeout=60.0)[:1]
        fault = dict(crashed_batch_failed=crashed,
                     restarts=rt.stats.faults.restarts - f0[0],
                     injected=rt.stats.faults.injected - f0[1],
                     next_score_bitwise=bool(np.array_equal(
                         after, preds[1][0])))
        explain = server.explain().splitlines()[0]
    finally:
        server.shutdown()
    # every served score against the same row scored alone, then numpy
    solo = [script(rows[i]) for i in range(2 * requests)]
    bitwise = all(np.array_equal(a, b) for i in range(2 * requests)
                  for a, b in zip(preds[i], solo[i], strict=True))
    got = np.concatenate([p[0] for p in preds])
    want = rows[:, 0, :] @ beta
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    sig = np.concatenate([p[1] for p in preds])
    rel_sig = float(np.max(np.abs(sig - 1.0 / (1.0 + np.exp(-want)))))
    # one (16, n) block request through its own server
    block = rng.standard_normal((16, n))
    script16 = PreparedScript(scoring, [(16, n)], runtime=rt)
    with ModelServer(script16, max_batch=16, max_wait_us=2000.0) as srv16:
        yb, _ = srv16.score(block, timeout=60.0)
    want_b = block @ beta
    rel_block = float(np.max(np.abs(yb - want_b)) / np.max(np.abs(want_b)))
    # why the port sums a one-row product in a fixed order: torch.matmul's
    # rows apart between a vmapped bucket and the same rows one by one
    xs = torch.from_numpy(rows[:16]).to(dev)
    bt = torch.from_numpy(beta).to(dev)
    lone = torch.stack([torch.matmul(x, bt) for x in xs])
    apart = {b: int((torch.func.vmap(lambda x: torch.matmul(x, bt))(xs[:b])
                     != lone[:b]).sum()) for b in (2, 4, 8, 16)}
    ms = 1e3 * lat
    row = dict(phase="serve_plan", shape=[m, n], train_s=train_s,
               train_buckets=buckets, launches=launches, deploy_s=deploy_s, server=explain,
               warm_buckets=[2, 4, 8, 16], pinned=pinned,
               sequential=dict(requests=requests, wall_s=seq_s,
                               requests_per_s=requests / seq_s,
                               p50_ms=float(np.percentile(ms[:requests], 50)),
                               p99_ms=float(np.percentile(ms[:requests], 99)),
                               serving=seq_log),
               concurrent=dict(requests=requests, clients=clients,
                               wall_s=conc_s,
                               requests_per_s=requests / conc_s,
                               p50_ms=float(np.percentile(ms[requests:], 50)),
                               p99_ms=float(np.percentile(ms[requests:], 99)),
                               serving=conc_log),
               serving=log, bitwise_vs_solo=bitwise, rel_err_vs_numpy=rel,
               sigmoid_abs_err=rel_sig, block_rel_err=rel_block,
               fault=fault, torch_matmul_rows_apart=apart, cut="none")
    emit(row)
    if not (bitwise and rel <= 1e-12 and rel_sig <= 1e-12
            and rel_block <= 1e-12 and log["retraces"] == 0
            and pinned == 4 and log["requests"] == 2 * requests
            and fault == dict(crashed_batch_failed=True, restarts=1,
                              injected=1, next_score_bitwise=True)
            and buckets > 1
            and launches["gram"] == launches["xtv"] == buckets):
        raise AssertionError(f"serve_plan failed: {row}")
    return launches


def ptxas_spills(log: str, entry: str) -> dict:
    """Spill bytes (stores + loads) of each kernel whose mangled name
    matches `entry`, keyed by the pattern's groups, from ptxas's report
    in the build log."""
    import re
    spills, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*" + entry, ln)
        if m:
            key = ":".join(m.groups())
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and key is not None:
            spills[key] = int(m.group(1)) + int(m.group(2))
            key = None
    return spills


def flash_bf16_spills(log: str) -> dict:
    """Spill bytes of each bfloat16 flash instantiation, by head dim."""
    return {int(hd): v for hd, v in
            ptxas_spills(log, r"flash_bf16_kernelILi(\d+)E").items()}


def gram_spills(log: str) -> dict:
    """Spill bytes of each float64 and bfloat16 gram partial kernel, by
    dtype and template arguments (tile width, copy width)."""
    return ptxas_spills(log, r"gram_(f64|bf16)_partial_kernelI(\w+?)EE")


def wkv6_spills(log: str) -> dict:
    """Spill bytes of each WKV6 state and output kernel, by pass and
    template arguments (dtype, head dim, chunk compiled in)."""
    return ptxas_spills(log, r"wkv6_(state|output)_kernelI(\w+?)EE")


def ssd_spills(log: str) -> dict:
    """Spill bytes of each selective-scan kernel, by template arguments
    (dtype, d_state, copy width)."""
    return ptxas_spills(log, r"ssm_scan_kernelI(\w+?)EE")


def spmm_spills(log: str) -> dict:
    """Spill bytes of each kernel of spmm.cu (the gram_bs partial and
    reduce passes, the xtv_bs partial and reduce passes, spmm), by kernel
    and template arguments."""
    return ptxas_spills(log, r"(gram_bs_partial_kernel|xtv_bs_partial_kernel"
                             r"|spmm_kernel|gram_tile_reduce_kernel"
                             r"|xtv_reduce_kernel)I(\w+?)EE")


def _device_ms(by_name: dict, *names: str) -> float:
    """Milliseconds of card time of the kernels whose names hold any of
    `names`, from a trace's {kernel name: device s}."""
    return 1e3 * sum(v for k, v in by_name.items()
                     if any(n in k for n in names))


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
    sources = ("gram", "spmm", "flash", "wkv6", "ssd")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        built = dict(zip(sources, pool.map(build.build, sources)))
    spills = flash_bf16_spills(build.build_log("flash"))
    gspills = gram_spills(build.build_log("gram"))
    wspills = wkv6_spills(build.build_log("wkv6"))
    sspills = ssd_spills(build.build_log("ssd"))
    mspills = spmm_spills(build.build_log("spmm"))
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=built,
              ptxas={src: [ln.strip() for ln in
                           build.build_log(src).splitlines()
                           if "registers" in ln or "spill" in ln]
                     for src in sources},
              flash_bf16_spill_bytes=spills, gram_spill_bytes=gspills,
              wkv6_spill_bytes=wspills, ssd_spill_bytes=sspills,
              spmm_spill_bytes=mspills))
    if sorted(spills) != [32, 64, 128] or any(spills.values()):
        raise AssertionError(f"bf16 flash instantiations spill: {spills}")
    # 2 tile widths x 2 copy widths of each
    if len(gspills) != 8 or any(gspills.values()):
        raise AssertionError(f"gram f64/bf16 partial kernels spill: "
                             f"{gspills}")
    # 2 passes x 2 dtypes x 2 head dims x (the unrolled chunk, any chunk)
    if len(wspills) != 16 or any(wspills.values()):
        raise AssertionError(f"wkv6 kernels spill: {wspills}")
    # 2 dtypes x 3 d_states x 2 copy widths
    if len(sspills) != 12 or any(sspills.values()):
        raise AssertionError(f"selective-scan kernels spill: {sspills}")
    # gram_bs: the partial pass at 3 dtypes x 2 tile widths x 2 copy
    # widths, the filled reduce at 2 accumulation dtypes x 2 widths; xtv_bs
    # and spmm at 3 dtypes x 2 load widths x (c = 1, XC columns a pass),
    # the xtv reduce at 2 accumulation dtypes
    count = {"gram_": 16, "xtv_bs_": 12, "spmm_": 12, "xtv_reduce": 2}
    for prefix, want in count.items():
        got = {k: v for k, v in mspills.items() if k.startswith(prefix)}
        if len(got) != want or any(got.values()):
            raise AssertionError(f"{prefix}* kernels of spmm.cu spill (or "
                                 f"are not all built): {got}")

    # the WKV6 phase counts each call's kernels in profiler traces: it
    # runs first, since after a hundred earlier traces in one process the
    # profiler was seen to drop one record of every trace of a case (on
    # an H100, two runs in a row; the phase alone never did)
    wkv6_row = phase_wkv6_kernels(peaks)
    main_rows = phase_kernels(peaks)
    sparse_rows = phase_sparse_kernels(peaks)
    flash_row = phase_flash_kernels(peaks)
    ssm_row = phase_ssm_kernels(peaks)
    batched_rows = phase_batched_kernels(peaks)
    phase_quickstart()
    launches = phase_lmds()
    phase_steplm()
    sparse_launches = phase_sparse_lm()
    algo_launches = phase_algorithms()
    phase_cleaning()
    phase_rand()
    grid_launches = phase_grid_search()
    sparse_grid = phase_sparse_grid(peaks)
    cv_launches = phase_cv()
    life_launches = phase_lifecycle_pipeline()
    csv_launches = phase_csv_stream()
    plan_launches = phase_serve_plan()
    serve_launches = phase_lm_serve(peaks)
    rwkv_launches = phase_rwkv_serve(peaks)
    hybrid_launches = phase_hybrid_serve(peaks)

    kernels = []
    for kind, line in (("gram", 49), ("xtv", 83)):
        r = main_rows[kind]
        kernels.append(dict(
            name=kind, route="cuda", source="src/repro_torch/csrc/gram.cu",
            replaces=f"src/repro/kernels/gram/kernel.py:{line}",
            launches=launches[kind],
            reduce_launches=launches[f"{kind}_reduce"],
            launches_by_path=dict(
                lmds=launches[kind],
                **{a: v[kind] for a, v in algo_launches.items()},
                grid_search_vmap=grid_launches[kind],
                cv_vmap=cv_launches[kind],
                lifecycle_pipeline=life_launches[kind],
                csv_stream=csv_launches[kind],
                serve_plan_train=plan_launches[kind]),
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            device_ms=r["device_ms"], host_us=r["host_us"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    # the same kernels under torch.func.vmap: one launch over a batch, at
    # the CV path's training stacks (8, 87,500, 1,000) float64; per path,
    # launches x (device ms - bound ms) at that shape
    for kind, line in (("gram", 49), ("xtv", 83)):
        r = batched_rows[f"{kind}_batched"]
        dev_ms = r["ms"] if r["device_ms"] is None else r["device_ms"]
        kernels.append(dict(
            name=f"{kind}_batched", route="cuda",
            source="src/repro_torch/csrc/gram.cu",
            replaces=f"src/repro/kernels/gram/kernel.py:{line}",
            launches=cv_launches[f"{kind}_batched"],
            reduce_launches=cv_launches[f"{kind}_batched_reduce"],
            launches_by_path=dict(
                cv_vmap=cv_launches[f"{kind}_batched"],
                grid_search_vmap=grid_launches[f"{kind}_batched"]),
            shape=[r["batch"], r["m"], r["n"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            device_ms=r["device_ms"], lone_ms=r["lone_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            excess_ms_by_path=dict(
                cv_vmap=cv_launches[f"{kind}_batched"]
                * (dev_ms - r["bound_ms"]))))
    # each kernel's row at the shape of most of its launches; per path,
    # launches x (device ms - bound ms) at that path's shapes (a stream
    # bucket for all but the stream's last launch, its 6,784-row tail)
    at = {"gram_bs": (100_000, 1000), "xtv_bs": (100_000, 2000),
          "spmm": (100_000, 2000)}
    shapes = {"sparse_lmds": (100_000, 1000), "sparse_lmcg": (100_000, 2000),
              "sparse_stream": (32_768, 1000),
              "sparse_grid_vmap": (100_000, 1000)}
    for kind, line in (("gram_bs", 63), ("spmm", 112), ("xtv_bs", 158)):
        r = sparse_rows[(kind, *at[kind])]
        by_path = {p: v[kind] for p, v in sparse_launches.items() if v[kind]}
        if sparse_grid["launches"][kind]:
            by_path["sparse_grid_vmap"] = sparse_grid["launches"][kind]

        def over(rows, cols, kind=kind):
            r = sparse_rows[(kind, rows, cols)]
            dev = r["ms"] if r["device_ms"] is None else r["device_ms"]
            return dev - r["bound_ms"]

        def excess(path, k, kind=kind):
            if path == "sparse_grid_vmap" and kind == "spmm":
                # the fold: one launch of 70 columns (its own row)
                r = sparse_grid["folds"]["spmm"]
                dev = r["ms"] if r["device_ms"] is None else r["device_ms"]
                return k * (dev - r["bound_ms"])
            if path != "sparse_stream":
                return k * over(*shapes[path])
            return (k - 1) * over(*shapes[path]) + over(6784, 1000)
        kernels.append(dict(
            name=kind, route="cuda", source="src/repro_torch/csrc/spmm.cu",
            replaces=f"src/repro/kernels/spmm/kernel.py:{line}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            reduce_launches=sum(v.get(f"{kind}_reduce", 0)
                                for v in sparse_launches.values()),
            shape=list(at[kind]),
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            bound_dense_ms=r["bound_dense_ms"], library_ms=r["library_ms"],
            excess_ms_by_path={p: excess(p, k) for p, k in by_path.items()}))
    r = flash_row
    flash_by_path = dict(
        lm_serve_prefill=serve_launches["prefill"],
        lm_serve_decode=serve_launches["decode"],
        hybrid_serve_prefill=hybrid_launches["prefill"]["flash"],
        hybrid_serve_decode=hybrid_launches["decode"]["flash"])
    kernels.append(dict(
        name="flash", route="cuda", source="src/repro_torch/csrc/flash.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:83",
        launches=sum(flash_by_path.values()),
        launches_by_path=flash_by_path,
        max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"]))
    r = wkv6_row
    kernels.append(dict(
        name="wkv6", route="cuda", source="src/repro_torch/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6/kernel.py:99",
        launches=rwkv_launches["generate"],
        launches_by_path=dict(rwkv_serve_prefill=rwkv_launches["prefill"],
                              rwkv_serve_decode=rwkv_launches["decode"]),
        max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], bound_rate=r["bound_rate"],
        passes=r["passes"], trace_retries=r["trace_retries"],
        library_ms=r["library_ms"], library=r["library"]))
    r = ssm_row
    kernels.append(dict(
        name="ssm_scan", route="cuda", source="src/repro_torch/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:68",
        launches=hybrid_launches["generate"]["ssm_scan"],
        launches_by_path=dict(
            hybrid_serve_prefill=hybrid_launches["prefill"]["ssm_scan"],
            hybrid_serve_decode=hybrid_launches["decode"]["ssm_scan"]),
        max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        library=r["library"]))
    emit(dict(kernels=kernels))
    print(smi, flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=name,
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
