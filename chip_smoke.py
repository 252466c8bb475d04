#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main path through the entry points a user calls and
holds every hand-written kernel against its plain PyTorch version on the
card. One JSON line per phase:

  1. device        — the card (and `nvidia-smi`'s name and power limit)
  2. build         — compile `src/repro_torch/csrc/*.cu` (gram, spmm,
                     flash, wkv6, ssd; gram and spmm share
                     gram_mainloop.cuh, which with flash includes
                     sm90.cuh) for sm_90a, one `nvcc` per source,
                     all started together; the bf16 flash instantiations
                     (hd 32, 64, 128 and MLA's q/k 192 with v 128) and
                     MLA's float32 one,
                     gram's float64 partial kernels, its bf16 wgmma
                     kernels and xtv tile products, every WKV6
                     state and output kernel, every selective-scan kernel
                     and every kernel of spmm.cu (gram_bs, xtv_bs, spmm
                     and their reduce passes) must spill nothing
                     (ptxas's report)
  3. kernel        — gram/xtv against the plain version at the path's
                     shapes in float64/float32/bfloat16 (and a column slice
                     at an offset, an odd width), bitwise repeatable, gram
                     bitwise symmetric, with kernel, plain, library (one
                     torch.matmul, a yardstick the port never calls) and
                     bound times, the wrapper's host time (`host_us`), the
                     plan or route and one launch of the routed kernel a
                     call; then xtv of two or more columns on the tile
                     product (`WIDE_XTV`): kmeans' AᵀX (100,000 x 8
                     against 1,000 columns) and mlogreg's c 10 in float64,
                     the CV fold's 12,500 x 1,000 against 8 columns and a
                     ragged c of 9 and 129 (odd width, offset slice) in
                     every dtype
  4. sparse_kernel — the block-sparse gram_bs/xtv_bs/spmm kernels against
                     their plain version at the bcoo paths' shapes (blocky,
                     uniform, a sparse_stream bucket and its ragged tail),
                     bitwise against the same kernel with an all-ones mask
                     and against a second call, with times and bounds over
                     the dense layout and over the populated blocks, the
                     plans and (xtv_bs, spmm) the wrapper's host time
  5. flash_kernel  — the flash-attention kernel against its plain version
                     computed in float32 from the same inputs (over batch
                     slices), each entry within a bound of its own
                     envelope, at the serving paths' shapes (qwen3-0.6b,
                     llama3.2-1b and jamba-v0.1-52b heads, ragged prompts,
                     non-causal, float32; deepseek-v2-236b's MLA heads of
                     q/k 192 and v 128 in bf16 and float32 and ragged,
                     llama-3.2-vision-90b's cross-attention over 1,024
                     image tokens, musicgen-large's and deepseek-moe-16b's
                     heads), bitwise
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
                     time in a traced fit of its own (lmCG's: 5
                     iterations)
 10. lm_serve      — the dense LM family served at qwen3-0.6b's full width
                     (28 layers, bf16, seeded weights): `generate` for a
                     batch of 8 2,048-token prompts and 32 greedy tokens,
                     its own steps read for launches (one flash launch per
                     layer in prefill, none in decode) and times, then the
                     same prefill once more, warm (each serving phase);
                     teacher-forced decode against prefill logits, kernel
                     against plain attention and against two planted
                     faults; tokens/s, peak memory, a traced idle share;
                     its `cost` line: the prefill counted by
                     `launch.hlocost` on the card and on "meta", FLOPs,
                     bytes and transcendentals equal, each kernel launched
                     and charged, FLOPs over model_flops_per_device, the
                     warm prefill ms over the roofline's t_compute,
                     t_memory and their max (also rwkv_serve's with wkv6,
                     hybrid_serve's with the scan and flash)
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
                     after the first layer against a kernel-free float64
                     route;
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
                     (max_iter cut to 10; a traced fit of 3)
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
 24. pipeline      — the asynchronous pipeline (pipeline depth 2, the
                     default) against depth 1 in one process: at the lmds
                     point a cold lmDS fit at each depth from a fresh
                     ReuseCache and a cleared closure cache (β bitwise,
                     13 + 13 gram/xtv launches each, the same chunks, both
                     meters, peak live bytes under CHUNK_MEM_BUDGET, peak
                     device memory, a traced idle share), and a chunk_io
                     fault on the prefetch worker that degrades to the
                     synchronous loop (same β, no thread left); the bcoo
                     stream (sparse_lm's 400,000 x 1,000) at both depths,
                     β bitwise; serve_plan's 16 clients at both depths
                     (rebatches > 0 at depth 2, the same bits, 0
                     retraces, p50/p99 and requests/s of each)
 25. federated     — lmDS_federated at the lmds point over 4 sites (25,000
                     rows a site): β within rel 1e-9 of numpy's solve and
                     of the local lmDS, the exchange log byte for byte the
                     eager oracle's, one gram and one xtv launch per site,
                     a warm rerun off the reuse cache (no launch, no
                     exchange); steplm_federated at 20,000 x 32 selecting
                     the local run's columns; the reference's combined
                     fault scenario (site_rpc, site_dead, chunk_io,
                     compile) bitwise the clean run with its counters; an
                     8-λ federated grid under parfor with one exchange
                     round per site per fed instruction
 26. sharded       — lmDS at the lmds point compiled under
                     use_mesh(data=8) with 8 logical devices laid over the
                     card: X sharded (neither streamed nor chunked), 8 gram
                     and 8 xtv launches (counted in a trace), β within rel
                     1e-9 of numpy's solve and of the local lmDS, the
                     fitted values X β (one reshard) within 1e-9, the shard
                     meter equal to the compile-time formulas, a refit
                     bitwise; a shard_gram sum dropping the last shard and
                     a reshard gathering in reverse order, each caught;
                     the card's own count (1) runs the unshard closures (1
                     + 1 launches, the same values); an 8-λ grid under
                     use_mesh(config=8), mode "shard" against "vmap";
                     walls, per-shard device ms against the bound, the
                     traced idle share, peak device memory
 27. moe_serve     — the moe family served at deepseek-moe-16b's full width
                     and depth (28 layers: one dense, 27 MoE of 64 experts
                     top-6 and 2 shared; bf16, seeded weights), lm_serve's
                     prompts and 8 greedy tokens (32 before moe_ep_serve
                     came in): 28 flash launches in prefill, none in decode;
                     teacher-forced decode, the kernel route against the
                     plain attention (over batch slices) and two planted
                     faults, each with the kernel route's MoE routing
                     replayed and the flips counted; experts touched per
                     decode step; tokens/s, peak memory, a traced idle
                     share
 27b. moe_ep_serve — on moe_serve's model (no second build): 8 logical
                     devices laid over the card, make_mesh((2, 4), ("data",
                     "model")) and hints enabled, so every MoE layer takes
                     the expert-parallel `moe_forward_ep` (16 experts a
                     model rank, 960 slots an expert a data rank in
                     prefill): moe_serve's prompts and 8 greedy tokens, 28
                     flash launches and 27 EP calls a prefill, 27 EP calls
                     a decode step; teacher-forced EP decode against the
                     local path's (its routing replayed); each MoE layer's
                     EP output on its prefill inputs against the local
                     algorithm with the dropped replicas weighted 0 (the
                     capacity rule copied here), and against a planted
                     fault (the model sum without the last rank); the
                     dropped replicas; host reads a decode step on both
                     paths (sync debug mode); prefill and decode ms, peak
                     memory
 28. mla_serve     — MLA served at deepseek-v2-236b's full width, its depth
                     cut to the dense first layer and 4 MoE layers (160
                     experts top-6), moe_serve's checks: 5 launches of the
                     (192, 128) flash instantiation in prefill, absorbed
                     decode over the latent cache, and the first layer's
                     absorbed decode against its expanded prefill
 29. vlm_serve     — llama-3.2-vision-90b at full width, one period (4
                     self-attention layers, 1 cross-attention layer over
                     an (8, 1,024, 8,192) image; the gate drawn nonzero
                     from the seed), the same checks: 4 causal and 1
                     non-causal flash launches in prefill
 30. audio_serve   — musicgen-large at full width and depth (48 layers) on
                     (8, 2,048, 4) EnCodec prompts: 32 steps of 4 codebook
                     tokens, 48 flash launches in prefill, the same checks
 31. train         — lm-100m at full width (8 layers, d 640, vocab
                     32,768, float32, TF32 off) through
                     `repro_torch.launch.train.main` with the reference
                     trainer's defaults: 100 steps of batch 8 × 256, a
                     checkpoint at 50; the loss falls; a second run given
                     only the step-50 checkpoint ends bitwise on the
                     first's step-100 checkpoint, parameters and losses;
                     the first step's loss and every gradient against a
                     float64 twin, with a rolled loss chunk and attention
                     seeing one position ahead planted beyond the limits.
                     qwen3-0.6b at full width in bf16 with float32
                     masters, batch 8 × 2,048, 5 steps: finite losses,
                     after each step a serving model loaded from the
                     masters computes the training model's hidden states
                     bitwise, the first step's gradients against the
                     float32 model's (a rolled chunk planted beyond). Each:
                     ms a step, tokens/s, peak memory, a traced step's
                     idle share and top ops, a step counted by
                     `launch.hlocost` (lm-100m's product FLOPs equal to
                     FlopCounterMode's), its product FLOPs at the dtype's
                     peak as its bound. No kernel launches: the wrappers
                     refuse a gradient
 32. fedavg        — FedAvgTrainer over 4 sites of lm-100m at full width
                     (float32, remat off), each site a TokenPipeline shard
                     of the train phase's data (batch 8 × 256), a sync
                     every 8 rounds, 16 rounds, `loss_fn` through
                     Model.loss by functional_call; int8 compression off
                     and on: the loss falls in both, the wire bytes' ratio
                     exactly (n + 4·L) / (4·n); quantize_int8 on the card
                     bitwise the CPU's on a seeded delta of the model's
                     size; the error-feedback residual after 50 rounds
                     under TestCompression's 1e-3 at that size, and beyond
                     it with the residual not carried (planted); ms a
                     local step and a sync
 33. elastic_restore — the int8 run's anchor saved with store.save and
                     restored twice with shardings=: onto make_mesh((4,
                     2)) with 2-D weights over ("data", "model"), onto
                     make_mesh((2, 4)) over ("model", None), 1-D leaves
                     replicated; every logical device's shard bitwise the
                     block of the saved array (a plain copy of jax's
                     rule); save and restore seconds
 34. dryrun        — (run first after the build, on "meta": no card
                     work) one dry-run cell at full width,
                     `launch.dryrun.lower_cell` for qwen3-0.6b × train_4k
                     on the production (16, 16) mesh over 256 logical
                     devices, its RooflineCell at the H100's constants
 35. kernels       — the summary line of every ported kernel (the
                     block-sparse ones at the shape of most of their
                     launches, with launches x (device ms - bound ms) by
                     path; gram and xtv with their launches on the
                     sharded paths and a shard's device ms against its
                     bound, and batched, with their launches on the CV
                     path; the xtv tile product at kmeans' AᵀX with its
                     launches on every path (kmeans and mlogreg in
                     algorithms) and mlogreg's and the fold's rows; flash
                     with its launches
                     on every serving path, moe_ep_serve's included, and
                     MLA's instantiation)

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
# layer on an H100, a kernel-free route (the per-step oracle in float64;
# it now runs the first layer only, and the plain route in chunks of 64
# reads the depths) splits from the plain route's residual stream
# from 5.1e-6 after layer 1 to 0.195 after layer 32, and as far with only
# its row 0 swapped in,
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



def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks_for(name: str) -> tuple[str, dict]:
    """(key, peaks) of the card `name`: NVIDIA's published dense peaks,
    FLOP/s by input dtype and memory bytes/s (`launch.roofline.PEAKS`)."""
    from repro_torch.launch.roofline import peaks_for as find
    return find(name)


def _t(work: tuple, rate: float, bw: float) -> tuple[float, str]:
    """(ms, what bounds it) of (operations, bytes) at `rate` and `bw`."""
    t_ops, t_bytes = work[0] / rate, work[1] / bw
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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


# the kernel of `torch.cuda._sleep`, which opens every trace
SENTINEL = "spin_kernel"
# traces taken, and those whose sentinel record the profiler lost
PROFILER = {"traces": 0, "sentinels_lost": 0}


def device_trace(fn, counts: dict | None = None):
    """Run `fn` once under `torch.profiler` (card activity only) and
    return (result, wall s, device-busy s or None, {kernel/copy name:
    device s}). Busy time is the union of the card's kernel and copy
    intervals; None when the profiler saw no device events. `counts`, if
    given, is filled with {kernel/copy name: number of events}.

    A sentinel kernel opens the trace and is left out of the result: on
    an H100 the profiler has been seen to lose the first kernel record
    of every trace of one case, eight traces in a row (the first WKV6
    state pass each time), and the sentinel takes that place. PROFILER
    counts the sentinels lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    PROFILER["traces"] += 1
    PROFILER["sentinels_lost"] += not any(SENTINEL in e.name for e in events)
    events = [e for e in events if SENTINEL not in e.name]
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


def retaken_trace(fn, calls: int = 1, tries: int = 3, whole=None):
    """A trace of `calls` calls of `fn` (`device_trace`), taken again
    while it holds no device event or `whole(counts)` is false, up to
    `tries` times (late in a long run the profiler was seen to drop some
    of a trace's records, or all of them): (wall s, device-busy s or
    None, {kernel: device s}, {kernel: events}, takes). The last take is
    returned if none was whole."""
    for take in range(1, tries + 1):
        counts: dict = {}
        _, wall, busy, by_name = device_trace(
            lambda: [fn() for _ in range(calls)], counts)
        if busy is not None and (whole is None or whole(counts)):
            break
    return wall, busy, by_name, counts, take


def per_call_ms(fn, calls: int = 10, tries: int = 3):
    """(card ms a call of `fn`, {kernel: ms a call}, {kernel: events})
    from a `retaken_trace` of `calls` calls: each kernel's mean event time
    times its events a call, so that a record the profiler drops does not
    lower the sum. (None, {}, {}) if no take holds a device event."""
    _, busy, by_name, counts, _ = retaken_trace(fn, calls, tries)
    if busy is None:
        return None, {}, {}
    per = {k: 1e3 * v / counts[k] * max(1, round(counts[k] / calls))
           for k, v in by_name.items()}
    return sum(per.values()), per, counts


def bound(kind: str, m: int, n: int, c: int, dtype: str, peaks: dict
          ) -> tuple[float, str]:
    """Least time the card could take: max(bytes / bandwidth, operations /
    peak rate), each input read once and each output written once
    (`launch.kernel_model.gram_work` / `xtv_work`)."""
    from repro_torch.launch import kernel_model as km
    work = km.gram_work(m, n, dtype) if kind == "gram" \
        else km.xtv_work(m, n, c, dtype)
    return _t(work, peaks[dtype], peaks["bw"])


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


# the wide xtv rows of the kernel phase (two or more columns of v: the tile
# product), (name, m, n, c, offset, dtypes): kmeans' per-cluster sums AᵀX
# (A 8 columns, X 1,000) and mlogreg's gradient (10 classes) at the lmds
# point in float64, CV's fold (one 12,500 x 1,000 X against 8 v's folded
# into columns) in every dtype, a ragged c of 9 and 129 on the odd width
# and on steplm's offset slice
WIDE_XTV = [("kmeans", 100_000, 8, 1000, 0, ("float64",)),
            ("mlogreg", 100_000, 1000, 10, 0, ("float64",)),
            ("fold", 12_500, 1000, 8, 0, None),
            ("ragged", 3000, 1001, 9, 0, None),
            ("ragged", 3000, 1001, 129, 0, None),
            ("ragged", 20000, 34, 9, 1, None),
            ("ragged", 20000, 34, 129, 1, None)]


def _kernel_row(kind: str, x, v, name: str, peaks: dict, m: int, n: int,
                c: int, offset: int, **extra) -> dict:
    """One kernel row: gram or xtv on (x, v) against the plain version
    within TOL, bitwise on a second call (gram bitwise symmetric), its
    launches a call by kernel, ms, device ms, the wrapper's and the
    custom op's host time, plain, library (one torch.matmul) and bound
    times. Raises if it fails."""
    import torch
    from repro_torch.kernels.gram import ops, ref
    if kind == "gram":
        args, kern, plain = (x,), ops.gram_cuda, ref.gram
        lib = (lambda: torch.matmul(x.mT, x))
    else:
        args, kern, plain = (x, v), ops.xtv_cuda, ref.xtv
        lib = (lambda: torch.matmul(x.mT, v))
    saved = dict(ops.LAUNCHES)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    counts = {k: ops.LAUNCHES[k] - saved[k] for k in saved
              if ops.LAUNCHES[k] != saved[k]}
    err = (got.double() - want.double()).abs().max().item()
    scaled = ref.scaled_err(got, want, x, args[-1])
    ok = scaled <= TOL[name]
    if kind == "gram" and not torch.equal(got, got.mT):
        ok = False
    bitwise = torch.equal(got, kern(*args))  # fixed-order reduction
    ok = ok and bitwise
    ms = cuda_ms(lambda: kern(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    library_ms = cuda_ms(lib)
    bms, by = bound(kind, m, n, max(c, 1), name, peaks)
    # the card's own time for the kernel passes (no host work)
    _, _, dev_s, _ = device_trace(lambda: [kern(*args) for _ in range(10)])
    us = host_us(lambda: kern(*args))
    # the same call through the torch.library custom op the backend takes
    # under vmap (the dispatcher's cost on top)
    op_us = host_us(lambda: (ops.gram_op if kind == "gram"
                             else ops.xtv_op)(*args))
    ops.LAUNCHES.update(saved)  # timing launches are not the path's
    sms = ops._sm_count(x.device)
    plan = ops.gram_plan(m, n, x.dtype, sms, ops.GRAM_TILE_N) \
        if kind == "gram" else ops.xtv_route(m, n, max(c, 1), x.dtype, sms)
    row = dict(phase="kernel", kernel=kind, **extra, m=m, n=n, c=c or None,
               offset=offset or None, aligned16=ops.aligned16(x),
               dtype=name, plan=plan, launches_per_call=counts,
               max_abs_err=err, scaled_err=scaled, tol=TOL[name],
               bitwise_repeat=bitwise, ok=ok, ms=ms,
               device_ms=None if dev_s is None else 100 * dev_s,
               host_us=us, op_host_us=op_us, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bms, bound_by=by)
    emit(row)
    if not ok:
        raise AssertionError(f"{kind} {m}x{n} {name} disagrees with its "
                             f"plain version: {row}")
    # one launch of the routed kernel (and at most one of its reduce)
    one = "gram" if kind == "gram" else \
        ("xtv_tile" if plan[0] == "tile" else "xtv")
    if counts.get(one) != 1 or any(k not in (one, f"{one}_reduce")
                                   or cnt != 1 for k, cnt in counts.items()):
        raise AssertionError(f"{kind} {m}x{n} {name}: launches per call "
                             f"{counts}, not one {one} launch")
    return row


def phase_kernels(peaks: dict) -> dict:
    """gram/xtv against the plain version at the paths' shapes (`cases`,
    from the numpy seed), then the wide xtv rows (`WIDE_XTV`, drawn on the
    card). Returns the lmds bucket's rows by kernel and the wide rows by
    name ("xtv_tile:<name>", float64 where the row has it)."""
    import numpy as np
    import torch
    from repro_torch.interop import from_reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
    rng = np.random.default_rng(SEED)
    # the streaming bucket, its ragged tail, the quickstart matrix; then
    # steplm's column slice at an offset (8-byte-aligned base, element
    # copies) and an odd width (8-byte-aligned rows); then, in float64
    # only, the sharded lane's shapes at the lmds point: a shard of
    # 12,500 rows (97 row blocks of 128 and a tail of 84) and the whole
    # 100,000 rows its unshard fallback launches on
    cases = [("gram", 8192, 1000, 0, 0), ("gram", 1696, 1000, 0, 0),
             ("gram", 5000, 64, 0, 0), ("xtv", 8192, 1000, 1, 0),
             ("xtv", 1696, 1000, 1, 0), ("xtv", 5000, 64, 1, 0),
             ("xtv", 8192, 1000, 3, 0), ("gram", 20000, 34, 0, 1),
             ("xtv", 20000, 34, 1, 1), ("gram", 3000, 1001, 0, 0),
             ("xtv", 3000, 1001, 3, 0)]
    sharded = [("gram", 12500, 1000, 0, 0), ("xtv", 12500, 1000, 1, 0),
               ("gram", 100000, 1000, 0, 0), ("xtv", 100000, 1000, 1, 0)]
    cases = ([(*case, None) for case in cases]
             + [(*case, ("float64",)) for case in sharded])
    main = {}
    for kind, m, n, c, offset, dtypes in cases:
        host = from_reference(
            {"x": rng.standard_normal((m, n + offset)),
             "v": rng.standard_normal((m, max(c, 1)))}, "cuda")
        for name, dtype in dt.items():
            if dtypes is not None and name not in dtypes:
                continue
            x = host["x"].to(dtype)[:, offset:]
            v = host["v"].to(dtype)
            row = _kernel_row(kind, x, v, name, peaks, m, n, c, offset)
            if (m, n, name) == (8192, 1000, "float64") and c in (0, 1):
                main[kind] = row
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for label, m, n, c, offset, dtypes in WIDE_XTV:
        x64 = torch.randn((m, n + offset), generator=gen, device="cuda",
                          dtype=torch.float64)
        v64 = torch.randn((m, c), generator=gen, device="cuda",
                          dtype=torch.float64)
        for name, dtype in dt.items():
            if dtypes is not None and name not in dtypes:
                continue
            row = _kernel_row("xtv", x64.to(dtype)[:, offset:],
                              v64.to(dtype), name, peaks, m, n, c, offset,
                              case=label)
            if name == "float64" and label != "ragged":
                main[f"xtv_tile:{label}"] = row
        del x64, v64
    torch.cuda.empty_cache()
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


# the lmds point's data and numpy's float64 solve, made once for the
# phases that fit it (lmds, pipeline, federated) and dropped after them
_LMDS_POINT: dict = {}
LMDS_REG = 1e-7


def _lmds_point(m: int, n: int):
    """(X, y, numpy's float64 β) of the lmds point, seeded."""
    import numpy as np
    got = _LMDS_POINT.get((m, n))
    if got is None:
        rng = np.random.default_rng(SEED)
        xn = rng.standard_normal((m, n))
        yn = (xn @ rng.standard_normal((n, 1))
              + 0.1 * rng.standard_normal((m, 1)))
        want = np.linalg.solve(xn.T @ xn + LMDS_REG * np.eye(n), xn.T @ yn)
        got = _LMDS_POINT[(m, n)] = (xn, yn, want)
    return got


def phase_lmds(m: int = 100_000, n: int = 1_000) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import (LineageRuntime, ReuseCache, costmodel,
                                  get_jit_cache, input_tensor)
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import lmDS
    reg = LMDS_REG
    # X and y stream together: (n + 1) float64 values per row
    c = costmodel.chunk_rows(8.0 * (n + 1))
    buckets = -(-m // c)
    xn, yn, want = _lmds_point(m, n)
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
# the asynchronous pipeline and federated placement
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _depth(d: int):
    """`REPRO_PIPELINE_DEPTH` set to `d` for a block."""
    old = os.environ.get("REPRO_PIPELINE_DEPTH")
    os.environ["REPRO_PIPELINE_DEPTH"] = str(d)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_PIPELINE_DEPTH", None)
        else:
            os.environ["REPRO_PIPELINE_DEPTH"] = old


def _prefetch_threads() -> list:
    import threading
    return [t.name for t in threading.enumerate()
            if t.name.startswith("chunk-prefetch") and t.is_alive()]


def phase_pipeline(dev=DEVICE, m: int = 100_000, n: int = 1_000) -> dict:
    """The asynchronous pipeline at the lmds point: a cold lmDS fit at
    pipeline depth 1 and at depth 2 in one process, each with a fresh
    ReuseCache and a cleared closure cache — β bitwise across the depths,
    13 gram + 13 xtv launches each, the same chunk counts, both meters
    (`StreamLog.spans()`, `PipelineLog.as_dict()`), peak live bytes under
    CHUNK_MEM_BUDGET, peak device memory, and a traced idle share at each
    depth; then a chunk_io fault on the prefetch worker, which degrades to
    the synchronous loop with the same β and no thread left. Returns the
    launches of each depth's fit."""
    import numpy as np
    import torch
    from repro_torch.core import (LineageRuntime, ReuseCache, clear_jit_cache,
                                  costmodel, faults, input_tensor)
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import lmDS
    xn, yn, want = _lmds_point(m, n)
    buckets = -(-m // costmodel.chunk_rows(8.0 * (n + 1)))

    def fit(spec=None, traced=False):
        clear_jit_cache()
        rt = LineageRuntime(cache=ReuseCache(), device=dev)
        X, y = input_tensor("X", xn), input_tensor("y", yn)
        gops.reset_launches()
        _sync(dev)
        if dev != "cpu":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with faults.inject(spec):
            beta = lmDS(X, y, reg=LMDS_REG, runtime=rt)
        wall = time.perf_counter() - t0
        out = dict(wall_s=wall,
                   rel_err=float(np.max(np.abs(beta - want))
                                 / np.max(np.abs(want))),
                   launches=dict(gops.LAUNCHES),
                   streaming=rt.stats.streaming.as_dict(),
                   spans=rt.stats.streaming.spans(),
                   pipeline=rt.stats.pipeline.as_dict(),
                   faults=dict(injected=rt.stats.faults.injected,
                               degradations=rt.stats.faults.degradations),
                   peak_mem_mb=(torch.cuda.max_memory_allocated() / 2**20
                                if dev != "cpu" else None))
        return beta, out

    rows = {}
    betas = {}
    for d in (1, 2):
        with _depth(d):
            betas[d], rows[d] = fit()          # the path: counts set to 0
            _, wall, busy, by_name = device_trace(lambda: fit())
            rows[d]["traced"] = _traced(wall, busy, by_name)
    with _depth(2):
        beta_f, faulted = fit("seed=2;chunk_io@1")
    faulted["threads_left"] = _prefetch_threads()
    budget = costmodel.CHUNK_MEM_BUDGET
    row = dict(phase="pipeline", path="lmds", shape=[m, n], buckets=buckets,
               chunk_mem_budget=budget, depth1=rows[1], depth2=rows[2],
               bitwise=bool(np.array_equal(betas[1], betas[2])),
               prefetch_fault=dict(
                   faulted, bitwise=bool(np.array_equal(beta_f, betas[2]))))
    emit(row)
    ok = row["bitwise"] and row["prefetch_fault"]["bitwise"]
    for d in (1, 2):
        r = rows[d]
        ok = ok and (r["launches"]["gram"] == r["launches"]["xtv"] == buckets
                     and r["streaming"]["chunks"] == buckets
                     and r["streaming"]["chunks_reused"] == 0
                     and r["streaming"]["peak_live_bytes"] <= budget
                     and r["rel_err"] <= 1e-9)
    p2 = rows[2]["pipeline"]
    ok = ok and (rows[1]["pipeline"]["async_segments"] == 0
                 and p2["prefetch_hits"] == buckets
                 and p2["async_segments"] >= buckets
                 and faulted["faults"] == dict(injected=1, degradations=1)
                 and faulted["streaming"]["chunks"] == buckets
                 and faulted["launches"]["gram"] == buckets
                 and not faulted["threads_left"])
    if not ok:
        raise AssertionError(f"pipeline at the lmds point failed: {row}")
    return {f"pipeline_depth{d}": rows[d]["launches"] for d in (1, 2)}


def phase_federated(dev=DEVICE, m: int = 100_000, n: int = 1_000,
                    sites: int = 4, grid=(0.01, 0.1, 1.0, 10.0, 0.05, 0.5,
                                          5.0, 50.0)) -> dict:
    """Federated placement on the card: lmDS_federated at the lmds point
    over 4 sites (X 800 MB, 25,000 rows a site) against numpy's float64
    solve and the local lmDS, its exchange log against the eager oracle's
    byte for byte, one gram and one xtv launch per site, a warm rerun off
    the reuse cache (no launch, no exchange); steplm_federated at 20,000 x
    32 against the local run's columns; the reference's combined fault
    scenario (site_rpc, site_dead, chunk_io, compile) bitwise the clean
    run; a federated λ grid under parfor, one exchange round per site per
    fed instruction. Returns the launches per path."""
    import tempfile

    import numpy as np
    from repro_torch.core import (LineageRuntime, ReuseCache, clear_jit_cache,
                                  faults, federated_input, input_tensor)
    from repro_torch.core.federated import FederatedTensor, federated_lmds
    from repro_torch.data.csv_io import read_csv_chunks, write_csv
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import (grid_search_lm, lmDS, lmDS_federated,
                                       steplm, steplm_federated)
    xn, yn, want = _lmds_point(m, n)

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    by_path = {}
    # ---- lmDS over 4 sites ------------------------------------------------
    oracle = FederatedTensor.partition_rows(xn, sites)
    t0 = time.perf_counter()
    beta_oracle = federated_lmds(oracle, yn, reg=LMDS_REG)
    oracle_s = time.perf_counter() - t0
    fed = FederatedTensor.partition_rows(xn, sites)
    rt = LineageRuntime(cache=ReuseCache(), device=dev)
    gops.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    beta = lmDS_federated(fed, yn, reg=LMDS_REG, runtime=rt)   # the path
    cold_s = time.perf_counter() - t0
    cold_launches = dict(gops.LAUNCHES)
    cold_ex = rt.stats.exchange.as_dict()
    gops.reset_launches()
    t0 = time.perf_counter()
    beta_warm = lmDS_federated(fed, yn, reg=LMDS_REG, runtime=rt)
    warm_s = time.perf_counter() - t0
    warm_launches = dict(gops.LAUNCHES)
    beta_local = lmDS(input_tensor("X", xn), input_tensor("y", yn),
                      reg=LMDS_REG, runtime=LineageRuntime(device=dev))
    _, trace_wall, busy, by_name = device_trace(
        lambda: lmDS_federated(fed, yn, reg=LMDS_REG,
                               runtime=LineageRuntime(device=dev)))
    lmds_row = dict(
        phase="federated", path="lmds", shape=[m, n], sites=sites,
        site_rows=[b - a for a, b in fed.ranges], oracle_s=oracle_s,
        cold_s=cold_s, warm_s=warm_s, rel_err_vs_numpy=rel(beta, want),
        rel_err_vs_local=rel(beta, beta_local),
        rel_err_vs_oracle=rel(beta, beta_oracle),
        launches=cold_launches, warm_launches=warm_launches,
        exchange=cold_ex, oracle_exchange=oracle.log.as_dict(),
        warm_exchange=rt.stats.exchange.as_dict(),
        warm_bitwise=bool(np.array_equal(beta, beta_warm)),
        cache=rt.cache.stats.as_dict(),
        resident_mb=sum(s._resident[2].numel() * 8 for s in fed.sites
                        if s._resident is not None) / 2**20,
        traced=_traced(trace_wall, busy, by_name))
    emit(lmds_row)
    if not (lmds_row["rel_err_vs_numpy"] <= 1e-9
            and lmds_row["rel_err_vs_local"] <= 1e-9
            and cold_ex == oracle.log.as_dict()
            and cold_launches["gram"] == cold_launches["xtv"] == sites
            and lmds_row["warm_exchange"] == cold_ex
            and lmds_row["warm_bitwise"]
            and warm_launches["gram"] == warm_launches["xtv"] == 0
            and rt.cache.stats.hits >= 2):
        raise AssertionError(f"federated lmDS failed: {lmds_row}")
    by_path["federated_lmds"] = cold_launches
    del fed, oracle

    # ---- steplm over 4 sites at 20,000 x 32 ------------------------------
    rng = np.random.default_rng(SEED)
    xs = rng.standard_normal((20_000, 32))
    ys = (xs[:, [3, 17, 25]] @ np.array([[2.0], [-1.0], [0.5]])
          + 0.1 * rng.standard_normal((20_000, 1)))
    gops.reset_launches()
    t0 = time.perf_counter()
    rt = LineageRuntime(cache=ReuseCache(), device=dev)
    sbeta, sel = steplm_federated(FederatedTensor.partition_rows(xs, sites),
                                  ys, max_features=4, runtime=rt)
    step_s = time.perf_counter() - t0
    step_launches = dict(gops.LAUNCHES)
    lbeta, lsel = steplm(input_tensor("X", xs), input_tensor("y", ys),
                         max_features=4,
                         runtime=LineageRuntime(cache=ReuseCache(),
                                                device=dev))
    step_row = dict(phase="federated", path="steplm", shape=[20_000, 32],
                    sites=sites, selected=sel, selected_local=lsel,
                    rel_err_vs_local=rel(sbeta, lbeta), wall_s=step_s,
                    launches=step_launches,
                    exchange=dict(total=rt.stats.exchange.total,
                                  rounds=rt.stats.exchange.rounds),
                    cache=rt.cache.stats.as_dict())
    emit(step_row)
    if not (sel == lsel and step_row["rel_err_vs_local"] <= 1e-9
            and step_launches["gram"] > 0 and rt.cache.stats.hits > 0):
        raise AssertionError(f"federated steplm failed: {step_row}")
    by_path["federated_steplm"] = step_launches

    # ---- the reference's combined fault scenario -------------------------
    frng = np.random.default_rng(SEED + 7)
    data = np.hstack([frng.normal(size=(208, 7)), frng.normal(size=(208, 1))])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "d.csv")
        write_csv(path, data)

        def run(spec):
            clear_jit_cache()
            rt = LineageRuntime(device=dev)
            with faults.inject(spec) as plan:
                parts = [c for _, c in read_csv_chunks(
                    path, 64, chunk_bytes=1 << 12,
                    fault_log=rt.stats.faults)]
                d = np.vstack(parts)
                w = lmDS_federated(
                    FederatedTensor.partition_rows(d[:, :-1], 4), d[:, -1:],
                    intercept=True, runtime=rt)
            f = rt.stats.faults
            return w, dict(injected=f.injected, retries=f.retries,
                           timeouts=f.timeouts,
                           degradations=f.degradations, shed=f.shed,
                           restarts=f.restarts), \
                dict(plan.fired) if plan else {}

        spec = ("seed=13;site_dead:site=3;site_rpc@2;"
                "chunk_io@0,1;compile@0")
        w0, _, _ = run(None)
        w1, c1, fired = run(spec)
        w2, c2, _ = run(spec)
    fault_row = dict(phase="federated", path="combined_faults", spec=spec,
                     counters=c1, fired=fired,
                     bitwise_vs_clean=bool(np.array_equal(w0, w1)),
                     rerun_bitwise=bool(np.array_equal(w1, w2)),
                     rerun_counters_equal=c1 == c2)
    emit(fault_row)
    if not (fault_row["bitwise_vs_clean"] and fault_row["rerun_bitwise"]
            and c1 == c2 == dict(injected=13, retries=10, timeouts=0,
                                 degradations=3, shed=0, restarts=0)
            and fired == {"chunk_io": 2, "compile": 1, "site_rpc": 1,
                          "site_dead": 9}):
        raise AssertionError(f"federated fault scenario failed: {fault_row}")

    # ---- a federated λ grid under parfor ---------------------------------
    def grid_run(lams, mode, cache=False):
        fx = FederatedTensor.partition_rows(xn, sites)
        rt = LineageRuntime(cache=ReuseCache() if cache else None,
                            device=dev)
        gops.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        betas, losses = grid_search_lm(
            federated_input("gX", fx), input_tensor("gy", yn), list(lams),
            runtime=rt, mode=mode)
        return (betas, losses, rt.stats.exchange.as_dict(),
                dict(gops.LAUNCHES), time.perf_counter() - t0,
                rt.stats.batched_segments)

    bb, bl, bex, blaunch, bwall, bsegs = grid_run(grid, "vmap")  # the path
    _, _, one_ex, _, _, _ = grid_run(grid[:1], "sequential")
    sb, sl, sex, slaunch, swall, _ = grid_run(grid, "sequential",
                                               cache=True)
    grid_row = dict(phase="federated", path="grid", shape=[m, n],
                    sites=sites, k=len(grid), vmap_wall_s=bwall,
                    sequential_wall_s=swall, batched_segments=bsegs,
                    rounds_per_site=bex["rounds_per_site"],
                    one_config_rounds_per_site=one_ex["rounds_per_site"],
                    sequential_rounds=sex["rounds"],
                    exchange_bytes=bex["total"],
                    sequential_exchange_bytes=sex["total"],
                    launches=blaunch, sequential_launches=slaunch,
                    rel_beta_vs_sequential=rel(bb, sb),
                    rel_loss_vs_sequential=rel(np.asarray(bl),
                                               np.asarray(sl)))
    emit(grid_row)
    if not (bex["rounds_per_site"] == one_ex["rounds_per_site"]
            and sex["rounds"] > bex["rounds"]
            and bex["total"] == sex["total"] and bsegs > 0
            and grid_row["rel_beta_vs_sequential"] <= 1e-8
            and grid_row["rel_loss_vs_sequential"] <= 1e-8
            and blaunch["gram"] == blaunch["xtv"] == sites):
        raise AssertionError(f"federated grid failed: {grid_row}")
    by_path["federated_grid_vmap"] = blaunch
    return by_path


# ---------------------------------------------------------------------------
# sharded placement: MeshSpec over logical devices laid over the card
# ---------------------------------------------------------------------------

# the dense gram/xtv kernels' passes, by the names the profiler reports
GRAM_PASSES = ("gram_f64_partial", "gram_tile_reduce")
XTV_PASSES = ("xtv_slab", "xtv_reduce")


@contextlib.contextmanager
def _planted(op: str, builder):
    """The backend's kernel builder of `op` swapped for `builder` for a
    block (a planted fault), every cached kernel and closure dropped on
    the way in and out."""
    from repro_torch.core import backend, clear_jit_cache
    old = backend._KERNEL_BUILDERS[op]
    backend._KERNEL_BUILDERS[op] = builder
    backend._kernel_cached.cache_clear()
    clear_jit_cache()
    try:
        yield
    finally:
        backend._KERNEL_BUILDERS[op] = old
        backend._kernel_cached.cache_clear()
        clear_jit_cache()


def _pass_trace(fn, launches: dict) -> dict:
    """A `retaken_trace` of `fn`, taken again until it holds each gram/xtv
    pass as often as the wrappers counted its launches (`launches`).
    `whole` is false when no take did: the caller fails and the row
    reports the events seen."""
    want = {p: launches[k if "reduce" not in p else f"{k}_reduce"]
            for k, ps in (("gram", GRAM_PASSES), ("xtv", XTV_PASSES))
            for p in ps}

    def passes(counts):
        return {p: sum(v for k, v in counts.items() if p in k) for p in want}
    wall, busy, by_name, counts, takes = retaken_trace(
        fn, whole=lambda c: passes(c) == want)
    got = passes(counts)
    return dict(trace=(wall, busy, by_name), events=got, want=want,
                tries=takes, whole=got == want)


def _kernel_times(tr: dict, m: int, n: int, peaks: dict) -> dict:
    """Per launch of gram and of xtv over an (m, n) float64 X in a
    `_pass_trace`: each pass's mean device ms an event, summed over the
    kernel's passes, beside the bound."""
    by_name, out = tr["trace"][2], {}
    for kind, passes, c in (("gram", GRAM_PASSES, 0), ("xtv", XTV_PASSES, 1)):
        ev = {p: tr["events"][p] for p in passes}
        ms = sum(_device_ms(by_name, p) / ev[p] for p in passes if ev[p])
        bms, by = bound(kind, m, n, max(c, 1), "float64", peaks)
        out[kind] = dict(shape=[m, n], events=ev, device_ms=ms,
                         bound_ms=bms, bound_by=by)
    return out


def _drop_last_partial(attrs):
    """shard_gram whose sum over the shards leaves out the last one."""
    from repro_torch.core import backend

    def run(x):
        acc = backend._gram(x[0])
        for b in x[1:-1]:
            acc = acc + backend._gram(b)
        return acc
    return run


def _reversed_gather(attrs):
    """reshard gathering the row blocks in reverse shard order."""
    import torch
    return lambda x: torch.cat(list(reversed(x)))


def phase_sharded(peaks: dict, dev=DEVICE, m: int = 100_000, n: int = 1_000,
                  d: int = 8, grid=(0.01, 0.1, 1.0, 10.0, 0.05, 0.5, 5.0,
                                    50.0)) -> dict:
    """Sharded placement at the lmds point, on the card: lmDS compiled
    under `use_mesh(data=8)` with 8 logical devices laid over the card —
    the plan shards X (neither streamed nor chunked), runs 8 gram and 8
    xtv launches (a trace counts them), β within rel 1e-9 of numpy's
    float64 solve and of the local (streamed) lmDS, the fitted values
    X β (a sharded root: one reshard) within 1e-9 of numpy's,
    `stats.shard` equal to the compile-time formulas over the plan, a
    second fit bitwise the first; a shard_gram sum that drops the last
    shard and a reshard that gathers in reverse order, each failing its
    check; with the card's own device count (1) the same mesh runs the
    unshard closures (1 + 1 launches, the same values); an 8-λ grid
    under `use_mesh(config=8)` in mode "shard" against mode "vmap".
    Returns the launches per path."""
    import numpy as np
    import torch
    from repro_torch.core import (LineageRuntime, backend, compile_plan,
                                  costmodel, input_tensor, ops)
    from repro_torch.distributed import logical_devices, use_mesh
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.lifecycle import grid_search_lm, lmDS
    xn, yn, want = _lmds_point(m, n)
    cuda = torch.device(dev).type == "cuda"

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    def program(X, y):  # lmDS's DAG (lifecycle/regression.py)
        return ops.solve(X.T @ X + LMDS_REG * ops.eye(n), X.T @ y)

    def fit(devices: int):
        """A cold lmDS fit under use_mesh(data=d) on a fresh runtime with
        `devices` logical devices: (β, wall s, launches, shard meter)."""
        with logical_devices(devices), use_mesh(data=d):
            rt = LineageRuntime(device=dev)
            gops.reset_launches()
            _sync(dev)
            t0 = time.perf_counter()
            beta = lmDS(input_tensor("X", xn), input_tensor("y", yn),
                        reg=LMDS_REG, runtime=rt)
            wall = time.perf_counter() - t0
        return beta, wall, dict(gops.LAUNCHES), rt.stats.shard.as_dict()

    def fitted(beta, devices: int):
        """X β under the mesh: a sharded matmul and its reshard."""
        with logical_devices(devices), use_mesh(data=d):
            rt = LineageRuntime(device=dev)
            out = rt.evaluate([input_tensor("X", xn)
                               @ input_tensor("b", beta)])[0]
        return out, rt.stats.shard.as_dict()

    # ---- the plan: X sharded, never streamed ------------------------------
    with use_mesh(data=d):
        plan = compile_plan([program(input_tensor("X", xn),
                                     input_tensor("y", yn))])
    segs = plan.segments_for(False)
    formulas = dict(sharded_segments=0, config_sharded_segments=0,
                    reshards=0, collectives=0, collective_bytes=0)
    for seg in segs:
        if seg.sharded:
            formulas["sharded_segments"] += 1
            for ins in seg.instructions:
                if ins.node.op == backend.RESHARD_OP:
                    formulas["reshards"] += 1
                elif ins.node.op in backend.SHARD_REDUCE_OPS:
                    formulas["collectives"] += 1
                formulas["collective_bytes"] += costmodel.collective_bytes(
                    ins.node)
    plan_ok = (not plan.chunk_sliced and not any(s.chunked for s in segs)
               and {"shard_gram", "shard_xtv"} <= set(plan.count_ops()))

    # ---- data-axis sharding: the path -------------------------------------
    beta_local = lmDS(input_tensor("X", xn), input_tensor("y", yn),
                      reg=LMDS_REG, runtime=LineageRuntime(device=dev))
    live_gb = None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        live_gb = torch.cuda.memory_allocated() / 1e9
    beta, cold_s, launches, meter = fit(d)          # the path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    beta2, warm_s, _, _ = fit(d)
    fit_x, fit_meter = fitted(beta, d)
    want_fit = xn @ beta

    def beta_ok(b):
        return rel(b, want) <= 1e-9 and rel(b, beta_local) <= 1e-9

    def fitted_ok(f):
        return rel(f, want_fit) <= 1e-9

    # per-shard launches in a trace of one more fit
    traced, per_shard, trace_ok = None, {}, True
    if cuda:
        tr = _pass_trace(lambda: fit(d), launches)
        traced = dict(_traced(*tr["trace"]), tries=tr["tries"],
                      whole=tr["whole"], events=tr["events"])
        per_shard = _kernel_times(tr, m // d, n, peaks)
        trace_ok = tr["whole"]

    # ---- planted faults, each beyond its limit ----------------------------
    with _planted("shard_gram", _drop_last_partial):
        beta_bad, _, _, _ = fit(d)
    with _planted(backend.RESHARD_OP, _reversed_gather):
        fit_bad, _ = fitted(beta, d)
    faults_caught = dict(dropped_partial=not beta_ok(beta_bad),
                         dropped_partial_rel=rel(beta_bad, want),
                         reversed_gather=not fitted_ok(fit_bad),
                         reversed_gather_rel=rel(fit_bad, want_fit))

    # ---- degradation: the card's own device count -------------------------
    beta_1, one_s, launches_1, meter_1 = fit(1)
    fit_1, fit_meter_1 = fitted(beta, 1)
    whole = {}
    if cuda:  # the one gram and xtv over the whole X, traced
        tr = _pass_trace(lambda: fit(1), launches_1)
        whole = _kernel_times(tr, m, n, peaks)
        trace_ok = trace_ok and tr["whole"]

    # ---- the bucket axis: an 8-λ grid over config=8 -----------------------
    lams = list(grid)
    grid_runs = {}
    with logical_devices(len(lams)), use_mesh(config=len(lams)):
        for mode in ("shard", "vmap"):
            rt = LineageRuntime(device=dev)
            gops.reset_launches()
            _sync(dev)
            t0 = time.perf_counter()
            gb, gl = grid_search_lm(input_tensor("gX", xn),
                                    input_tensor("gy", yn), lams,
                                    runtime=rt, mode=mode)
            grid_runs[mode] = dict(
                wall_s=time.perf_counter() - t0, betas=gb,
                losses=np.asarray(gl), launches=dict(gops.LAUNCHES),
                shard=rt.stats.shard.as_dict(),
                batched_segments=rt.stats.batched_segments)
    g_sh, g_vm = grid_runs["shard"], grid_runs["vmap"]
    grid_row = dict(
        k=len(lams), shard_wall_s=g_sh["wall_s"], vmap_wall_s=g_vm["wall_s"],
        config_sharded_segments=g_sh["shard"]["config_sharded_segments"],
        rel_beta_vs_vmap=rel(g_sh["betas"], g_vm["betas"]),
        rel_loss_vs_vmap=rel(g_sh["losses"], g_vm["losses"]),
        shard_launches=g_sh["launches"], vmap_launches=g_vm["launches"])

    row = dict(
        phase="sharded", shape=[m, n], mesh=dict(data=d), dtype="float64",
        plan_sharded_not_streamed=plan_ok,
        segments=[s.summary() for s in segs],
        cold_s=cold_s, warm_s=warm_s, peak_device_gb=peak_gb,
        live_before_gb=live_gb,
        rel_err_vs_numpy=rel(beta, want),
        rel_err_vs_local=rel(beta, beta_local),
        fitted_rel_err=rel(fit_x, want_fit),
        bitwise_rerun=bool(np.array_equal(beta, beta2)),
        launches=launches, shard=meter, formulas=formulas,
        fitted_shard=fit_meter, per_shard=per_shard, traced=traced, faults=faults_caught,
        unshard=dict(wall_s=one_s, launches=launches_1, shard=meter_1,
                     whole_x=whole,
                     fitted_shard=fit_meter_1,
                     rel_beta_vs_sharded=rel(beta_1, beta),
                     rel_fitted_vs_sharded=rel(fit_1, fit_x)),
        grid=grid_row)
    emit(row)
    ok = (plan_ok and beta_ok(beta) and fitted_ok(fit_x)
          and row["bitwise_rerun"] and meter == formulas
          and fit_meter["reshards"] == 1
          and launches["gram"] == launches["xtv"] == d and trace_ok
          and faults_caught["dropped_partial"]
          and faults_caught["reversed_gather"]
          and sum(meter_1.values()) == 0 and sum(fit_meter_1.values()) == 0
          and launches_1["gram"] == launches_1["xtv"] == 1
          and rel(beta_1, beta) <= 1e-9 and rel(fit_1, fit_x) <= 1e-9
          and grid_row["config_sharded_segments"] > 0
          and grid_row["rel_beta_vs_vmap"] <= 1e-9
          and grid_row["rel_loss_vs_vmap"] <= 1e-9)
    if not ok:
        raise AssertionError(f"sharded placement failed: {row}")
    return dict(sharded_lmds=launches, sharded_unshard=launches_1,
                sharded_grid_shard=g_sh["launches"]), per_shard


# ---------------------------------------------------------------------------
# the bcoo lane: block-sparse data, kernels, paths
# ---------------------------------------------------------------------------

ROW_GROUP, COL_GROUP = 1024, 128   # the data's block structure
BLOCKY = (0.25, 0.2)      # p_block, p_in: density 0.05 (lmDS, streamed)
BLOCKY_WIDE = (0.1, 0.1)  # density 0.01 (lmCG)
TRACED_CG_ITERS = 5       # iterations of lmCG's traced fit (the path: 20)
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
    each needed input byte read once, each output byte written once
    (`launch.kernel_model`'s `*_bs_work`, `spmm_work`, `matmul_work`)."""
    from repro_torch.launch import kernel_model as km
    if kind == "gram_bs":
        work = km.gram_bs_work(mask, m, n, dtype)
        dense = bound("gram", m, n, 1, dtype, peaks)
    elif kind == "xtv_bs":
        work = km.xtv_bs_work(mask, m, n, c, dtype)
        dense = bound("xtv", m, n, c, dtype, peaks)
    else:  # spmm: X (m, n) @ W (n, c)
        work = km.spmm_work(mask, m, n, c, dtype)
        dense = _t(km.matmul_work(m, n, c, dtype), peaks[dtype], peaks["bw"])
    bms, by = _t(work, peaks[dtype], peaks["bw"])
    return dict(bound_ms=bms, bound_by=by,
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
    rows, for a rehearsal); the streamed fit also at pipeline depth 1
    (the `pipeline` row of path sparse_stream). Returns the kernels'
    launches per path."""
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

    def cg(rt, its=iters):
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
        beta = lmCG(X, y, reg=reg, max_iter=its, runtime=rt)
        return beta, dict(wall_s=time.perf_counter() - t0,
                          iterations=calls[0] - 1, launches=launches())

    rt = LineageRuntime(sparse_inputs=True)
    X = input_tensor("X", xh, sparsity=density)
    r0 = rt.evaluate([X.T @ input_tensor("y", yh)])[0]
    r0_err = float(np.max(np.abs(r0 - xty)) / np.max(np.abs(xty)))
    beta_s, sparse = cg(rt)              # the path
    beta_d, dense = cg(LineageRuntime())
    # a traced fit of its own, TRACED_CG_ITERS iterations (20 until
    # moe_ep_serve came in): the kernels' device time
    _, trace_wall, busy, by_name = device_trace(
        lambda: cg(LineageRuntime(sparse_inputs=True), TRACED_CG_ITERS))
    ls = sparse["launches"]
    row = dict(phase="sparse_lm", path="sparse_lmcg", shape=[m, n],
               density=density, reg=reg, max_iter=iters,
               traced_iterations=TRACED_CG_ITERS, sparse=sparse,
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
        return beta, dict(
            wall_s=time.perf_counter() - t0, rel_err=rel(beta, want),
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
    beta_d2, cold = stream(rt)           # the path, at depth 2 (default)
    cold["rebuilds"] = jc.misses - m0
    bcoo_builds = sum(1 for _, sig in get_jit_cache().keys()
                      if any(a[0] == "bcoo" for a in sig))
    cold["pipeline"] = rt.stats.pipeline.as_dict()
    _, warm = stream(rt)
    # the same cold fit at depth 1: the pipelined lane's bcoo buckets
    # (sparsified on the prefetch worker) give its bits
    with _depth(1):
        rt1 = LineageRuntime(cache=ReuseCache(), sparse_inputs=True)
        beta_d1, depth1 = stream(rt1)
        depth1["pipeline"] = rt1.stats.pipeline.as_dict()
    prow = dict(phase="pipeline", path="sparse_stream", shape=[m, n],
                buckets=buckets, depth1=depth1, depth2=cold,
                bitwise=bool(np.array_equal(beta_d1, beta_d2)))
    emit(prow)
    if not (prow["bitwise"] and depth1["launches"] == cold["launches"]
            and depth1["streaming"]["chunks"] == buckets
            and cold["pipeline"]["prefetch_hits"] == buckets
            and depth1["pipeline"]["async_segments"] == 0):
        raise AssertionError(f"sparse stream across depths failed: {prow}")
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
    by_path["sparse_stream_depth1"] = depth1["launches"]
    return by_path


# ---------------------------------------------------------------------------
# the dense LM family: flash attention and serving
# ---------------------------------------------------------------------------

# (name, B, Sq, Sk, Hq, Hkv, hd (q/k), dv, causal, dtype); the first is
# the path's. deepseek-v2-236b's are MLA's (192, 128) instantiation,
# llama-3.2-vision-90b's its cross-attention over 1,024 image tokens
FLASH_CASES = [
    ("qwen3-0.6b", 8, 2048, 2048, 16, 8, 128, 128, True, "bfloat16"),
    ("llama3.2-1b", 8, 2048, 2048, 32, 8, 64, 64, True, "bfloat16"),
    ("jamba-v0.1-52b", 8, 2048, 2048, 32, 8, 128, 128, True, "bfloat16"),
    ("ragged-1000", 8, 1000, 1000, 16, 8, 128, 128, True, "bfloat16"),
    ("ragged-17", 8, 17, 17, 16, 8, 128, 128, True, "bfloat16"),
    ("non-causal", 8, 2048, 1024, 16, 8, 128, 128, False, "bfloat16"),
    ("qwen3-0.6b-f32", 8, 2048, 2048, 16, 8, 128, 128, True, "float32"),
    ("deepseek-v2-236b", 8, 2048, 2048, 128, 128, 192, 128, True,
     "bfloat16"),
    ("deepseek-v2-236b-f32", 8, 2048, 2048, 128, 128, 192, 128, True,
     "float32"),
    ("mla-ragged-1000", 8, 1000, 1000, 128, 128, 192, 128, True,
     "bfloat16"),
    ("mla-ragged-17", 8, 17, 17, 128, 128, 192, 128, True, "bfloat16"),
    ("llama-3.2-vision-90b-xattn", 8, 2048, 1024, 64, 8, 128, 128, False,
     "bfloat16"),
    ("musicgen-large", 8, 2048, 2048, 32, 32, 64, 64, True, "bfloat16"),
    ("deepseek-moe-16b", 8, 2048, 2048, 16, 16, 128, 128, True, "bfloat16"),
]
# the MLA case whose row the kernels line carries beside the path's
FLASH_MLA_CASE = "deepseek-v2-236b"
# float32 scores of one plain-version call in a slice of the batch: at
# MLA's 128 heads and S 2,048 the whole batch's would take 17.2 GB
PLAIN_SCORE_BYTES = 2e9


def flash_bound(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
                dv: int, causal: bool, dtype: str, peaks: dict
                ) -> tuple[float, str]:
    """Least time for one attention call: the visible (q, k) pairs each
    take 2·hd operations for QKᵀ and 2·dv for PV; q, k, v read once and
    the output written once (`launch.kernel_model.flash_work`)."""
    from repro_torch.launch import kernel_model as km
    return _t(km.flash_work(B, Sq, Sk, Hq, Hkv, hd, dv, causal, dtype),
              peaks[dtype], peaks["bw"])


def _batch_slices(q, k):
    """Slices of the batch whose float32 scores take at most
    PLAIN_SCORE_BYTES (one sequence at least)."""
    per = q.shape[1] * q.shape[2] * k.shape[1] * 4
    step = max(1, int(PLAIN_SCORE_BYTES // per))
    return [slice(i, i + step) for i in range(0, q.shape[0], step)]


def _sliced(fn):
    """`fn(q, k, v, causal)` computed over slices of the batch (the plain
    attention's float32 scores stay near PLAIN_SCORE_BYTES)."""
    import torch

    def attend(q, k, v, causal=True):
        return torch.cat([fn(q[b], k[b], v[b], causal)
                          for b in _batch_slices(q, k)])
    return attend


def phase_flash_kernels(peaks: dict, cases=FLASH_CASES) -> dict:
    """The flash kernel against its plain version at the serving paths'
    shapes; returns {case name: row} (the first case is the path's). The
    plain version runs over slices of the batch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = {}
    plain = _sliced(lambda q, k, v, c: ref.attention(q, k, v, causal=c))
    for name, B, Sq, Sk, Hq, Hkv, hd, dv, causal, dtype in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE
                               ).to(dt[dtype])
                   for shape in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                                 (B, Sk, Hkv, dv)))
        saved = dict(ops.LAUNCHES)  # these launches are not the path's
        got = ops.flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, scaled = 0.0, 0.0
        for b in _batch_slices(q, k):
            want = ref.attention(q[b].float(), k[b].float(), v[b].float(),
                                 causal=causal)
            err = max(err, (got[b].float() - want).abs().max().item())
            scaled = max(scaled, ref.scaled_err(got[b], want, q[b], k[b],
                                                v[b], causal=causal))
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
        plain_ms = cuda_ms(lambda: plain(q, k, v, causal), iters=5)
        # the yardstick: one library call on (B, H, S, ·) copies, v at its
        # own width
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        del qt, kt, vt
        bms, by = flash_bound(B, Sq, Sk, Hq, Hkv, hd, dv, causal, dtype,
                              peaks)
        row = dict(phase="flash_kernel", case=name, B=B, Sq=Sq, Sk=Sk, Hq=Hq,
                   Hkv=Hkv, hd=hd, dv=dv, causal=causal, dtype=dtype,
                   max_abs_err=err, scaled_err=scaled,
                   tol=FLASH_TOL[dtype], checks=checks,
                   ok=all(checks.values()), ms=ms,
                   device_ms=None if dev_s is None else 100 * dev_s,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bms, bound_by=by)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"flash {name} failed its checks: {row}")
        rows[name] = row
        del q, k, v, got
        torch.cuda.empty_cache()
    return rows


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


def nvidia_smi() -> str:
    """The card's name and power limit as `nvidia-smi` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cost_reading(path: str, model, cfg, tokens, max_len: int,
                 prefill_ms: float, **kernels) -> dict:
    """The path's prefill counted by `launch.hlocost` on the card, then
    the same prefill on "meta" (the dry run's route: nothing allocated,
    each hand kernel's meta implementation charged as its launch): FLOPs,
    bytes and transcendentals must be equal, and each kernel named in
    `kernels` (charge name -> (its LAUNCHES, key)) launched and charged
    in the counted prefill. Emits and returns the `cost` line: the card's
    counts, FLOPs over `model_flops_per_device`, the measured warm
    prefill ms over the roofline's t_compute, t_memory and their max (at
    the published peaks of NVIDIA H100 80GB HBM3 at 700 W; the card's
    name and power limit beside)."""
    import torch
    from repro_torch.launch import hlocost, roofline
    from repro_torch.models import build_model
    before = {k: d[key] for k, (d, key) in kernels.items()}
    card = hlocost.count(model.prefill, tokens, max_len=max_len)
    torch.cuda.synchronize()
    launched = {k: d[key] - before[k] for k, (d, key) in kernels.items()}
    meta = hlocost.count(build_model(cfg, "meta").prefill,
                         torch.empty(tokens.shape, dtype=tokens.dtype,
                                     device="meta"), max_len=max_len)
    B, S = tokens.shape[:2]
    mf, _ = roofline.model_flops_per_device(cfg, "prefill", B, S, 1)
    cell = roofline.RooflineCell(
        arch=cfg.name, shape=f"prefill {B}x{S}", mesh="1", n_devices=1,
        kind="prefill", hlo_flops=card.flops, hlo_bytes=card.bytes,
        model_flops=mf, tokens=B * S, dtype=cfg.dtype)
    t_c, t_m = 1e3 * cell.t_compute, 1e3 * cell.t_memory
    keys = ("flops", "bytes", "transcendentals")
    charged = {k: card.by_op[k] for k in kernels}
    row = dict(cost=path, arch=cfg.name, batch=B, prompt=S,
               card={k: getattr(card, k) for k in keys},
               meta={k: getattr(meta, k) for k in keys},
               card_equals_meta=all(getattr(card, k) == getattr(meta, k)
                                    for k in keys),
               product_flops=card.product_flops,
               peak_live_bytes=card.peak_bytes,
               kernels={k: dict(launches=launched[k], charges=charged[k][0],
                                flops=charged[k][1], bytes=charged[k][2])
                        for k in kernels},
               model_flops=mf, flops_over_model_flops=card.flops / mf,
               prefill_ms=prefill_ms, t_compute_ms=t_c, t_memory_ms=t_m,
               prefill_over_t_compute=prefill_ms / t_c,
               prefill_over_t_memory=prefill_ms / t_m,
               prefill_over_max=prefill_ms / max(t_c, t_m),
               peaks_of=roofline.CARD, card_now=nvidia_smi())
    if not row["card_equals_meta"]:
        row["by_op_differs"] = {
            op: [card.by_op.get(op), meta.by_op.get(op)]
            for op in sorted(set(card.by_op) | set(meta.by_op))
            if card.by_op.get(op) != meta.by_op.get(op)}
    emit(row)
    if not (row["card_equals_meta"]
            and all(v["launches"] > 0 and v["charges"] == v["launches"]
                    for v in row["kernels"].values())):
        raise AssertionError(f"{path}: the cost counts failed: {row}")
    return row


def _warm_prefill_ms(model, tokens, max_len: int, image_embeds=None
                     ) -> float:
    """The main path's prefill is the first at its size and pays the
    caching allocator's first-use costs: the same prefill once more, warm,
    in CUDA-event milliseconds."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    model.prefill(tokens, max_len=max_len, image_embeds=image_embeds)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


@contextlib.contextmanager
def _prefill_attention(fn):
    """Prefill attention computed by `fn(q, k, v, causal)` inside the
    block: the plain route and the planted faults the kernel route is held
    against (the port has no option for this; decode is untouched). Every
    caller of `attention_core` sees it: GQA, MLA and the cross-attention
    layers (which import the module, not the name)."""
    from repro_torch.models import attention as attn_mod
    core = attn_mod.attention_core
    attn_mod.attention_core = lambda q, k, v, *, causal, **_: fn(
        q, k, v, causal)
    try:
        yield
    finally:
        attn_mod.attention_core = core


def _plain_attention(q, k, v, causal=True):
    from repro_torch.models.attention import ref_attention
    return ref_attention(q, k, v, causal=causal)


def _masked_attention(mask_of):
    """Plain attention (the reference's formula) under the (Sq, Sk) mask
    `mask_of(S, device)` in place of the causal one; non-causal calls (the
    cross-attention) are left plain."""
    import torch

    def attend(q, k, v, causal=True):
        if not causal:
            return _plain_attention(q, k, v, causal=False)
        B, S, Hq, hd = q.shape
        Hkv = k.shape[2]
        qg = q.reshape(B, S, Hkv, Hq // Hkv, hd) * float(hd ** -0.5)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
        s = torch.where(mask_of(S, q.device), s, -1e30)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(
            B, S, Hq, v.shape[-1])
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
    cost_reading("lm_serve", model, cfg, tokens, max_len, prefill_warm_ms,
                 flash=(fops.LAUNCHES, "flash"))
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
    plain = route(_plain_attention)
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
    logw, u and the state in and out in float32
    (`launch.kernel_model.wkv6_work`). Returns (ms, what bounds it, the
    rate used)."""
    from repro_torch.launch import kernel_model as km
    rate, products = WKV6_RATE[dtype]
    ops, nbytes = km.wkv6_work(B, S, H, dh, dtype)
    return _t((ops * products, nbytes), peaks["tf32"], peaks["bw"]) + (rate,)


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
        lost = PROFILER["sentinels_lost"]

        def whole_tens(counts):
            wkv = [n for k, n in counts.items() if "wkv6_" in k]
            return bool(wkv) and all(n % 10 == 0 for n in wkv)
        _, dev_s, _, counts, takes = retaken_trace(kern, 10, 8, whole_tens)
        wkv = [n for k, n in counts.items() if "wkv6_" in k]
        retries = takes - 1
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
                   sentinels_lost=PROFILER["sentinels_lost"] - lost,
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
    cost_reading("rwkv_serve", model, cfg, tokens, max_len, prefill_warm_ms,
                 wkv6=(wops.LAUNCHES, "wkv6"))
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
    # the routes' split after the first layer (as the float32 checks
    # below); 32 bf16 layers of the seeded model amplify rounding, so the
    # end-to-end checks run in float32 (the bf16 end-to-end routes, which
    # were recorded, not held, are cut for the script's time since
    # moe_ep_serve came in)
    bf16_layers = _rwkv_layers(model, tokens, depth=1)
    bf16_finite = bool(torch.isfinite(
        model.prefill(tokens, max_len=max_len)[0]).all().item())
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
    # every layer's kernel call is held; the routes' splits are read
    # after the first layer, the one the check holds (the deeper splits
    # were recorded, not held: cut for the script's time when the sharded
    # phase came in)
    layers = _rwkv_layers(model, tokens, depth=1)
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
               logits_finite=routes["finite"] and bf16_finite,
               tokens_in_vocab=bool(0 <= toks.min()
                                    and toks.max() < cfg.vocab_size),
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


class _Deep(Exception):
    """Ends a forward pass after the layers a route is read over."""


def _rwkv_layers(model, tokens, depth=None) -> dict:
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
    kernel fault; the row-0 routes show where. The kernel route runs every
    layer; the others stop after `depth` layers (all when None), the
    per-step float64 oracle after the first, which the first-layer check
    reads (run over all 32 layers, the oracle was the phase's costliest
    route, cut to keep the script's time when the train phase came in)."""
    import torch
    from repro_torch.kernels.rwkv6 import ops, ref
    depth = depth or len(model.periods) * len(model.kinds)
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
            if i < len(exact):
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

    def upto(n, read, run_on=False):
        """`read` over the first n layers; then end the pass, unless the
        route must run on (the kernel's per-layer errors)."""
        def limited(i, x):
            if i < n:
                read(i, x)
            elif not run_on:
                raise _Deep
        return limited

    for fn, read in ((ref.wkv_chunked, upto(depth, lambda i, x:
                                             plain.append(x))),
                     (oracle, upto(1, read_oracle)),
                     (chunk64, upto(depth, reader("chunk64"))),
                     (kernel, upto(depth, reader("kernel"), run_on=True)),
                     (_row0_from(_bare_kernel, ref.wkv_chunked),
                      upto(depth, only_vs_plain("kernel_row0_plain"))),
                     (_row0_from(ref.wkv_chunked, oracle_row0),
                      upto(depth, only_vs_plain("plain_row0_oracle64")))):
        with _prefill_wkv(fn), _after_each_layer(read):
            try:
                model(tokens)
            except _Deep:
                pass
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
    float32 (`launch.kernel_model.ssm_work`)."""
    from repro_torch.launch import kernel_model as km
    return _t(km.ssm_work(B, S, di, ds, dtype), peaks["float32"],
              peaks["bw"])


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
        # the check's plain call above is its warm-up (16,384 steps take
        # ~4 s a call)
        plain_ms = cuda_ms(lambda: ref.ssm_scan(*args), iters=2, warmup=0)
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
    from repro_torch.kernels.ssd.ref import ssm_scan
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
    cost_reading("hybrid_serve", model, cfg, tokens, max_len,
                 prefill_warm_ms, ssm=(sops.LAUNCHES, "ssm_scan"),
                 flash=(fops.LAUNCHES, "flash"))
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
    tf = _teacher_forced(model, tokens)
    routes = _routes(model, tokens, _prefill_scan, ssm_scan, {
        "state_zeroed_near_end": _scan_state_zeroed_near_end,
        "skip_dropped": _scan_skip_dropped})
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


def _routes(model, tokens, swap, plain, faults: dict,
            image_embeds=None) -> dict:
    """The kernel route (its MoE routing recorded) against the plain route
    (`swap(plain)`: `_prefill_scan` or `_prefill_attention`) and the
    planted faults (`swap(fn)` for each of `faults`), each with the kernel
    route's routing replayed (`routing_flips`: the tokens of each MoE call
    that it would have routed otherwise). The plain route with its own
    routing, recorded but never held, was cut for the script's time
    when moe_ep_serve came in."""
    import torch
    log = []
    with _moe_routing(_recorded(log)):
        base = model(tokens, image_embeds=image_embeds)[0]

    def pinned(fn):
        flips = []
        with swap(fn), _moe_routing(_replayed(lambda c: log[c], flips)):
            h = model(tokens, image_embeds=image_embeds)[0]
        return dict(_read(model, h, base), routing_flips=flips)
    return dict(finite=bool(torch.isfinite(base).all().item()),
                kernel_vs_plain=pinned(plain),
                planted_faults={name: pinned(fn)
                                for name, fn in faults.items()})


def _teacher_forced(model, tokens, n_new: int = 16,
                    image_embeds=None) -> dict:
    """Prefill all but the last `n_new` positions (the kernel), decode
    those one by one (the plain decode paths over the caches), against a
    full prefill's last logits over max|logit|, with the full prefill's
    MoE routing replayed (`pinned`). The same run with the router's own
    routing, recorded but never held, was cut for the script's time when
    moe_ep_serve came in."""
    B, S = tokens.shape[:2]
    n0 = S - n_new
    log = []
    with _moe_routing(_recorded(log)):
        full, _ = model.prefill(tokens, max_len=S, image_embeds=image_embeds)

    def run():
        logits, cache = model.prefill(tokens[:, :n0], max_len=S,
                                      image_embeds=image_embeds)
        for t in range(n0, S):
            logits, cache = model.decode_step(tokens[:, t:t + 1], cache, t)
        return (logits.float() - full.float()).abs().max().item() \
            / full.float().abs().max().item()
    if not log:
        return dict(pinned=dict(logits_rel_err=run(), routing_flips=0),
                    decoded=n_new)
    n_moe, k = len(log), log[0].shape[-1]
    rows = [t.reshape(B, S, k) for t in log]

    def choices(call):
        layer, step = call % n_moe, call // n_moe
        if step == 0:
            return rows[layer][:, :n0].reshape(B * n0, k)
        return rows[layer][:, n0 + step - 1]
    flips = []
    with _moe_routing(_replayed(choices, flips)):
        pinned = run()
    return dict(pinned=dict(logits_rel_err=pinned, routing_flips=sum(flips)),
                decoded=n_new)


# ---------------------------------------------------------------------------
# the rest of the served model zoo: moe (DeepSeekMoE; MLA), vlm, audio
# ---------------------------------------------------------------------------

# the served families along two sound routes (the flash kernel vs the
# plain attention over batch slices; the prefill's kernel vs decode's
# plain paths over the caches), MoE routing replayed from the kernel
# route, as lm_serve's and hybrid_serve's: last-position logits over
# max|logit| and every position's final hidden row over its own max. A
# route passes when both readings are within their limits; a planted
# fault is caught when its route does not, i.e. when either reading is
# beyond its limit. On an H100 the sound routes read <= 3.1 % (logits)
# and 5.5 % (hidden rows), the faults >= 19.8 % on the hidden rows
# (dropped block) and >= 115 % (shifted mask); the shifted mask leaves
# the last query's own attention as it was (it has no next key), so at
# 5 layers (mla_serve, vlm_serve) it moves the last logits by only
# 3.3-4.5 %, under FAMILY_SERVE_TOL, while every other row moves by more
# than its own size
FAMILY_SERVE_TOL = 5e-2
FAMILY_HIDDEN_TOL = 1e-1
# MLA's absorbed decode against its expanded prefill, one layer, the last
# position, over its max; the two faults `_mla_absorbed` plants must read
# beyond it. On an H100 at mla_serve's inputs the sound decode reads
# 0.0068 (bf16 rounding), the dropped RoPE score 0.375 and the scale
# 1/sqrt(dn) 0.320: the limit leaves the first 3x and the faults 16x
MLA_ABSORBED_TOL = 2e-2


def _attn_layers(cfg) -> list:
    """Every layer's kind, the first dense layers' included."""
    return (["attn+mlp_first"] * cfg.first_dense_layers
            + cfg.layer_kinds() * cfg.n_periods())


def _family_bounds(model, cfg, batch: int, prompt: int, max_len: int,
                   touched: float, peaks: dict) -> tuple[float, float]:
    """(prefill, decode) least times. Prefill at the bf16 peak: each
    weight a token uses once per token (an xattn layer's wk, wv once per
    image token), the visible attention pairs at 2·(d_qk + d_v) each, the
    head at the last position. Decode: every weight but the embedding and
    the experts no token chose, read once a step, and the caches
    (`launch.roofline.serve_work`)."""
    from repro_torch.launch import roofline
    embed = sum(p.numel() * p.element_size()
                for p in model.embed.parameters())
    weights = sum(p.numel() * p.element_size()
                  for p in model.parameters()) - embed
    caches = sum(t.numel() * t.element_size()
                 for t in _leaves(model.init_cache(batch, max_len)))
    ops, nbytes = roofline.serve_work(cfg, batch, prompt, weights, caches,
                                      touched)
    return 1e3 * ops / peaks["bfloat16"], 1e3 * nbytes / peaks["bw"]


@contextlib.contextmanager
def _mla_queries(fault):
    """MLA's queries (q_nope, q_rope) passed through `fault` inside the
    block (the port has no option for this)."""
    from repro_torch.models import mla
    queries = mla._queries
    mla._queries = lambda *a: fault(*queries(*a))
    try:
        yield
    finally:
        mla._queries = queries


def _mla_absorbed(model, tokens) -> dict:
    """The first MLA layer on its served inputs (the first dense layer's
    norm1 of the embedded prompt): absorbed decode of the last position
    over the latent cache of the others against the expanded prefill's
    (the flash kernel's) output there, over its max (the reference's
    test_mla_decode_matches_expanded, at full width in bf16); and the same
    with two faults planted in decode alone: the RoPE score term dropped
    (q_rope zeroed) and the scores scaled by 1/sqrt(dn) in place of
    1/sqrt(dn + dr) (both query parts times sqrt((dn + dr)/dn))."""
    import math
    import torch
    from repro_torch.models import mla
    cfg = model.cfg
    blk = model.prefix[0]
    x = blk.norm1(model.embed(tokens))
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(
        B, S)
    full, (ckv, kr) = mla.mla_forward(blk.attn, cfg, x, pos)
    want = full[:, -1].float()

    def rel_err(fault) -> float:
        cache = (ckv.clone(), kr.clone())
        for t in cache:  # the last position is decode's to write
            t[:, S - 1:] = 0
        with _mla_queries(fault):
            step, _ = mla.mla_decode(blk.attn, cfg, x[:, S - 1:], cache,
                                     S - 1)
        return ((step[:, 0].float() - want).abs().max().item()
                / want.abs().max().item())

    c = math.sqrt((cfg.head_dim + cfg.rope_head_dim) / cfg.head_dim)
    return dict(rel_err=rel_err(lambda qn, qr: (qn, qr)), positions=S,
                planted_faults=dict(
                    rope_score_dropped=rel_err(
                        lambda qn, qr: (qn, torch.zeros_like(qr))),
                    scale_sqrt_dn=rel_err(lambda qn, qr: (qn * c, qr * c))))


def _serve_family(peaks: dict, phase: str, cfg, cut: dict, batch: int,
                  prompt: int, new: int, then=None) -> dict:
    """One served family at `cfg` (the cuts listed in `cut`), lm_serve's
    traffic: `generate` for `batch` prompts of `prompt` tokens (MusicGen:
    `encodec_tokens`' 4 codebooks with the delay pattern; the vision
    model: `vision_embeddings`' image, uploaded once in bf16) and `new`
    greedy tokens; its own steps read for flash launches (one per
    attention layer in prefill, none in decode) and times; the same
    prefill once more, warm; teacher-forced decode of the last new // 2
    positions against the prefill; the kernel route against the plain
    attention and two planted faults, MoE routing replayed; tokens/s,
    peak memory, a traced idle share;
    then `then(model, prompts, local)` on the same model, `local` holding
    the row's prefill and decode times. Returns the flash launches of the
    main path, by step."""
    import numpy as np
    import torch
    from repro_torch.data.frontends import encodec_tokens, vision_embeddings
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.layers import cdtype
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    model = build_model(cfg, device=DEVICE).init(gen)
    gates = []
    for period in model.periods:  # open the image layers (init shuts them)
        for key, blk in period.items():
            if key.endswith(":xattn"):
                blk.xattn.gate.uniform_(0.5, 1.5, generator=gen)
                gates.append(blk.xattn.gate.item())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if cfg.n_codebooks:
        prompts = encodec_tokens(batch, prompt, cfg.vocab_size,
                                 cfg.n_codebooks, seed=SEED)
    else:
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    img = None
    if cfg.family == "vlm":
        img = torch.from_numpy(vision_embeddings(
            batch, cfg.n_image_tokens, cfg.d_model, seed=SEED)).to(
                dev, cdtype(cfg))
    max_len = prompt + new
    generate(model, prompts[:, :64], max_new=2, max_len=66,
             image_embeds=img)  # warm cuBLAS

    # the main path: counts set to 0 just before, read just after; its own
    # steps note their launches and times, and the router's choices are
    # kept (a list append: no launch, no sync) to count the experts decode
    # reads
    routing = []
    with _probed_steps() as steps, _moe_routing(_recorded(routing)):
        fops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, prompts, max_new=new, max_len=max_len,
                        image_embeds=img)
        wall = time.perf_counter() - t0
        launches = fops.LAUNCHES["flash"]
    peak_bytes = torch.cuda.max_memory_allocated()
    tokens = torch.from_numpy(prompts).to(dev)
    prefill_warm_ms = _warm_prefill_ms(model, tokens, max_len, img)
    prefills = [st for st in steps if st[0] == "prefill"]
    decodes = [st for st in steps if st[0] == "decode"]
    by_step = {kind: sum(st[1]["flash"] for st in sts)
               for kind, sts in (("prefill", prefills), ("decode", decodes))}
    prefill_ms = prefills[0][2].elapsed_time(prefills[0][3])
    decode_ms = decodes[0][2].elapsed_time(decodes[-1][3]) / len(decodes)
    kinds = _attn_layers(cfg)
    n_moe = sum(k.endswith("+moe") for k in kinds)
    touched = float(np.mean([len(torch.unique(idx))
                             for idx in routing[n_moe:]])) if n_moe else 0.0
    del routing

    # the card's busy and idle share over the main path once more, traced
    _, trace_wall, busy, by_name = device_trace(
        lambda: generate(model, prompts, max_new=new, max_len=max_len,
                         image_embeds=img))
    fops.reset_launches()

    tf = _teacher_forced(model, tokens, n_new=new // 2, image_embeds=img)
    routes = _routes(model, tokens, _prefill_attention,
                     _sliced(_plain_attention), {
                         "mask_shifted": _sliced(_masked_attention(
                             _shifted_mask)),
                         "late_block_dropped": _sliced(_masked_attention(
                             _late_block_dropped))},
                     image_embeds=img)
    absorbed = _mla_absorbed(model, tokens) if cfg.attn_type == "mla" \
        else None
    fops.reset_launches()
    prefill_bound_ms, decode_bound_ms = _family_bounds(
        model, cfg, batch, prompt, max_len, touched, peaks)
    n_params = model.n_params()

    n_attn = sum(k.startswith("attn") or k == "xattn" for k in kinds)
    shape = (batch, new) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    row = dict(phase=phase, arch=cfg.name, n_layers=cfg.n_layers,
               kinds=kinds if len(kinds) <= 8 else None, cut=cut,
               n_params=n_params, dtype=cfg.dtype, batch=batch,
               prompt=prompt, new_tokens=new, max_len=max_len,
               image_tokens=None if img is None else cfg.n_image_tokens,
               xattn_gates=gates or None, init_s=init_s,
               generate_wall_s=wall, tokens_per_s=batch * new / wall,
               flash_launches=dict(generate=launches, **by_step),
               steps=dict(prefill=len(prefills), decode=len(decodes)),
               prefill_ms=prefill_ms, prefill_warm_ms=prefill_warm_ms,
               prefill_bound_ms=prefill_bound_ms,
               decode_ms_per_token=decode_ms, decode_bound_ms=decode_bound_ms,
               decode_experts_touched_per_layer=touched if n_moe else None,
               decode_host_syncs_per_step=n_moe,
               peak_memory_gb=peak_bytes / 1e9,
               tokens_in_vocab=bool(0 <= toks.min()
                                    and toks.max() < cfg.vocab_size),
               token_shape=list(toks.shape), teacher_forced=tf,
               routes=routes, mla_absorbed_vs_expanded=absorbed,
               tol=FAMILY_SERVE_TOL, hidden_tol=FAMILY_HIDDEN_TOL,
               absorbed_tol=MLA_ABSORBED_TOL,
               traced=_traced(trace_wall, busy, by_name))
    emit(row)
    faults = routes["planted_faults"]
    plain = routes["kernel_vs_plain"]
    caught = all(f["logits_rel_err"] > FAMILY_SERVE_TOL
                 or f["hidden_rel_err"] > FAMILY_HIDDEN_TOL
                 for f in faults.values())
    if not (launches == by_step["prefill"] == n_attn
            and by_step["decode"] == 0
            and len(prefills) == 1 and len(decodes) == new - 1
            and routes["finite"] and row["tokens_in_vocab"]
            and toks.shape == shape
            and tf["pinned"]["logits_rel_err"] <= FAMILY_SERVE_TOL
            and plain["logits_rel_err"] <= FAMILY_SERVE_TOL
            and plain["hidden_rel_err"] <= FAMILY_HIDDEN_TOL and caught
            and (absorbed is None
                 or (absorbed["rel_err"] <= MLA_ABSORBED_TOL
                     and all(e > MLA_ABSORBED_TOL for e in
                             absorbed["planted_faults"].values())))
            and (cfg.family != "vlm" or min(gates) > 0)):
        raise AssertionError(f"{phase} failed: {row}")
    if then is not None:
        then(model, prompts, dict(
            prefill_ms=prefill_ms, prefill_warm_ms=prefill_warm_ms,
            decode_ms_per_token=decode_ms, peak_memory_gb=peak_bytes / 1e9,
            decode_host_syncs_per_step=n_moe))
    del model
    torch.cuda.empty_cache()
    return row["flash_launches"]


def phase_moe_serve(peaks: dict, cfg=None, batch: int = 8,
                    prompt: int = 2048, new: int = 8) -> tuple:
    """The moe family served at deepseek-moe-16b's full width and depth
    (28 layers: one dense, d_ff 10,944; 27 MoE of 64 experts top-6 and 2
    shared; 16 heads of 128; `cfg` and the sizes may be cut for a
    rehearsal): 28 flash launches a prefill; then, on the same model, the
    expert-parallel path (`_moe_ep_serve`). 8 greedy tokens (32 until
    moe_ep_serve came in: a decode step is ~0.47 s, host-bound). Returns
    (the flash launches of moe_serve's main path, moe_ep_serve's row)."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config("deepseek-moe-16b")
    ep = []
    launches = _serve_family(
        peaks, "moe_serve", cfg, dict(new_tokens=[32, new]), batch, prompt,
        new,
        then=lambda model, prompts, local: ep.append(
            _moe_ep_serve(peaks, model, prompts, local)))
    return launches, ep[0]


def phase_mla_serve(peaks: dict, cfg=None, batch: int = 8,
                    prompt: int = 2048, new: int = 32) -> dict:
    """MLA served at deepseek-v2-236b's full width, its depth cut to the
    dense first layer and 4 MoE layers (160 experts top-6, 2 shared;
    latent 512, q rank 1,536, 128 heads of q/k 192 and v 128): 5 launches
    of the (192, 128) flash instantiation a prefill, absorbed decode over
    the (B, max_len, 512 + 64) latent cache."""
    from repro_torch.configs import get_config
    full = get_config("deepseek-v2-236b")
    cfg = cfg or full.with_(n_layers=5)
    return _serve_family(peaks, "mla_serve", cfg,
                         dict(n_layers=[full.n_layers, cfg.n_layers]),
                         batch, prompt, new)


def phase_vlm_serve(peaks: dict, cfg=None, batch: int = 8,
                    prompt: int = 2048, new: int = 32) -> dict:
    """Cross-attention served at llama-3.2-vision-90b's full width, its
    depth cut to one period (4 self-attention layers and 1 xattn layer,
    64/8 heads of 128, d_ff 28,672) over `vision_embeddings`' (8, 1,024,
    8,192) image; the xattn gate drawn nonzero from the seed (the
    reference initialises it to 0, which would hide the image from every
    check): 4 causal and 1 non-causal flash launches a prefill."""
    from repro_torch.configs import get_config
    full = get_config("llama-3.2-vision-90b")
    cfg = cfg or full.with_(n_layers=full.cross_attn_period)
    return _serve_family(peaks, "vlm_serve", cfg,
                         dict(n_layers=[full.n_layers, cfg.n_layers],
                              xattn_gate="U(0.5, 1.5) from the seed, not 0"),
                         batch, prompt, new)


def phase_audio_serve(peaks: dict, cfg=None, batch: int = 8,
                      prompt: int = 2048, new: int = 32) -> dict:
    """The audio family served at musicgen-large's full width and depth
    (48 layers, 32 heads of 64) on `encodec_tokens`' (8, 2,048, 4)
    prompts: 32 steps of 4 codebook tokens, 48 flash launches a
    prefill."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config("musicgen-large")
    return _serve_family(peaks, "audio_serve", cfg, {}, batch, prompt, new)


# ---------------------------------------------------------------------------
# the moe family on the (data, model) mesh: the expert-parallel MoE
# ---------------------------------------------------------------------------

EP_MESH = (2, 4)          # (data, model): 8 logical devices over the card
EP_NEW = 8                # the EP path's greedy tokens (moe_serve's 32, cut)
EP_TEACHER = 8            # teacher-forced decode steps, EP against local
# each MoE layer's EP output on its served prefill inputs against the plain
# version (the local algorithm, the dropped replicas' weights zeroed,
# summed in float32), over max|out|; the planted fault (the model sum
# without the last rank) must read beyond it
EP_LAYER_TOL = 2e-2


@contextlib.contextmanager
def _ep_probe(inputs: list | None = None):
    """Count the calls of `moe.moe_forward_ep` inside the block (a dict
    {"calls": n}, as the launch counters are), and, when `inputs` is
    given, keep each call's (MoE module, x)."""
    from repro_torch.models import moe
    ep = moe.moe_forward_ep
    count = {"calls": 0}

    def probe(p, cfg, x):
        count["calls"] += 1
        if inputs is not None:
            inputs.append((p, x))
        return ep(p, cfg, x)
    moe.moe_forward_ep = probe
    try:
        yield count
    finally:
        moe.moe_forward_ep = ep


@contextlib.contextmanager
def _ep_mesh():
    """The EP path's mesh: 8 logical devices laid over the card,
    make_mesh(EP_MESH, ("data", "model")), hints enabled on it."""
    from repro_torch.distributed import logical_devices
    from repro_torch.distributed.hints import disable_hints, enable_hints
    from repro_torch.launch.mesh import make_mesh
    with logical_devices(8):
        mesh = make_mesh(EP_MESH, ("data", "model"))
        enable_hints(mesh)
        try:
            yield mesh
        finally:
            disable_hints()


@contextlib.contextmanager
def _model_sum_without_last_rank():
    """The planted fault: EP's sum over `model` leaves out the last rank."""
    from repro_torch.models import moe
    total = moe._model_sum
    moe._model_sum = lambda parts: total(parts[:-1])
    try:
        yield
    finally:
        moe._model_sum = total


def _kept(top_idx, n_experts: int, capacity_factor: float):
    """A plain copy of the reference's capacity rule on one data rank's
    routing (T, k): a replica (token-major) is kept when fewer than Ce
    earlier replicas chose its expert, Ce = max(int(T·k / E · cf + 7) //
    8 · 8, 8) in Python floats."""
    import torch
    T, k = top_idx.shape
    ce = max(int(T * k / n_experts * capacity_factor + 7) // 8 * 8, 8)
    flat = top_idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, n_experts)
    pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    return (pos < ce).reshape(T, k)


def _moe_dropped_plain(p, cfg, x, dp: int):
    """One MoE layer's plain output on x (B, S, D) with `dp` data ranks:
    each rank's tokens routed by the port's router, the replicas the
    capacity rule drops weighted 0, every expert's tokens through its
    products one expert at a time, the weighted rows summed in float32;
    the shared experts as the layer adds them. Returns (out, dropped
    replicas)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.layers import mlp, silu
    B, S, D = x.shape
    dt = x.dtype
    xf = x.reshape(B * S, D)
    t_loc = B * S // dp
    outs, dropped = [], 0
    for d in range(dp):
        xd = xf[d * t_loc:(d + 1) * t_loc]
        _, top_vals, top_idx = moe.route(p, cfg, xd)
        weights = top_vals / torch.clamp_min(
            top_vals.sum(-1, keepdim=True), 1e-9)
        keep = _kept(top_idx, cfg.n_experts, cfg.capacity_factor)
        dropped += int((~keep).sum().item())
        weights = torch.where(keep, weights, 0.0)
        out = torch.zeros((t_loc, D), dtype=torch.float32, device=x.device)
        for e in range(cfg.n_experts):
            sel = top_idx == e
            rows = sel.any(1).nonzero()[:, 0]
            if not len(rows):
                continue
            w = (weights * sel).sum(1)[rows]
            xe = xd[rows]
            h = silu(xe @ p.w_gate[e].to(dt)) * (xe @ p.w_up[e].to(dt))
            eo = h @ p.w_down[e].to(dt)
            out.index_add_(0, rows, (eo * w[:, None].to(dt)).float())
        outs.append(out.to(dt))
    out = torch.cat(outs)
    if cfg.n_shared_experts:
        out = out + mlp(p.shared, xf)
    return out.reshape(B, S, D), dropped


def _ep_layers(model, tokens) -> dict:
    """One EP prefill of `tokens` with every MoE layer's input kept; then
    each layer's EP output on its input against `_moe_dropped_plain`, and
    with the planted fault, over max|out|."""
    import torch
    from repro_torch.models import moe
    cfg = model.cfg
    inputs = []
    with _ep_probe(inputs):
        model(tokens)
    errs, faults, dropped = [], [], []
    for p, x in inputs:
        want, n = _moe_dropped_plain(p, cfg, x, EP_MESH[0])
        scale = want.float().abs().max().item()
        got = moe.moe_forward_ep(p, cfg, x)[0]
        errs.append((got.float() - want.float()).abs().max().item() / scale)
        with _model_sum_without_last_rank():
            bad = moe.moe_forward_ep(p, cfg, x)[0]
        faults.append((bad.float() - want.float()).abs().max().item()
                      / scale)
        dropped.append(n)
    del inputs
    torch.cuda.empty_cache()
    return dict(layers=len(errs), rel_err_max=max(errs),
                rel_err=errs, dropped_replicas=dropped,
                dropped_total=sum(dropped),
                replicas_per_layer=tokens.numel() * cfg.moe_top_k,
                planted_fault=dict(model_sum_without_last_rank=min(faults)))


def _host_reads(fn) -> dict:
    """Host reads (synchronizing CUDA operations: `.item()`, `.tolist()`,
    a copy to the host) in one call of `fn`, counted by PyTorch's sync
    debug mode: {"step": all of them, "moe": those made inside the MoE
    layers' `moe_forward`}."""
    import warnings
    import torch
    from repro_torch.models import moe
    forward = moe.moe_forward
    inside = [0]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")

        def reads() -> int:
            return sum("called a synchronizing CUDA operation"
                   in str(w.message) for w in seen)

        def probe(*args):
            n0 = reads()
            out = forward(*args)
            inside[0] += reads() - n0
            return out
        moe.moe_forward = probe
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            moe.moe_forward = forward
        return dict(step=reads(), moe=inside[0])


def _ep_decode(model, tokens, n_new: int) -> dict:
    """Teacher-forced decode of the last `n_new` positions from one local
    prefill of the rest: the local path (its routing recorded), then EP
    from a copy of the same caches with that routing replayed on every
    data rank, the last step's logits over max|logit|; the host reads of
    one decode step on each path."""
    from torch.utils import _pytree as pytree
    B, S = tokens.shape
    n0 = S - n_new
    _, cache = model.prefill(tokens[:, :n0], max_len=S)
    copy = pytree.tree_map(lambda t: t.clone(), cache)
    spare = pytree.tree_map(lambda t: t.clone(), cache)
    log = []
    with _moe_routing(_recorded(log)):
        for t in range(n0, S):
            local, cache = model.decode_step(tokens[:, t:t + 1], cache, t)
    local_reads = _host_reads(lambda: model.decode_step(
        tokens[:, n0:n0 + 1], spare, n0))
    dp = EP_MESH[0]
    rows = B // dp
    k = log[0].shape[-1]

    def choices(call):  # EP routes each data rank's tokens in turn
        return log[call // dp].reshape(B, k)[
            (call % dp) * rows:(call % dp + 1) * rows]
    flips = []
    with _ep_mesh(), _ep_probe() as ep:
        with _moe_routing(_replayed(choices, flips)):
            for t in range(n0, S):
                got, copy = model.decode_step(tokens[:, t:t + 1], copy, t)
        calls = ep["calls"]
        ep_reads = _host_reads(lambda: model.decode_step(
            tokens[:, n0:n0 + 1], spare, n0))
    return dict(decoded=n_new, ep_calls=calls,
                logits_rel_err=(got.float() - local.float()).abs().max().item()
                / local.float().abs().max().item(),
                routing_flips=sum(flips),
                host_reads_per_step=dict(local=local_reads, ep=ep_reads))


def _moe_ep_serve(peaks: dict, model, prompts, local: dict) -> dict:
    """moe_ep_serve: the served model of moe_serve (no second build) on
    8 logical devices, make_mesh(EP_MESH, ("data", "model")) and hints
    enabled, so every MoE layer takes `moe_forward_ep` (data 2 × model 4:
    16 of the 64 experts a model rank, Ce 960 slots an expert a data rank
    in prefill, 8 in decode); `generate` for moe_serve's prompts and
    EP_NEW greedy tokens, its steps read for flash launches and EP calls;
    teacher-forced EP decode against the local path's; each MoE layer's
    EP output on its prefill inputs against the plain version and against
    a planted fault. `local` holds moe_serve's own prefill and decode
    times. Returns the row."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.serve import generate
    t_phase = time.perf_counter()
    cfg = model.cfg
    batch, prompt = prompts.shape
    max_len = prompt + EP_NEW
    tokens = torch.from_numpy(prompts).to(DEVICE)
    n_moe = sum(k.endswith("+moe") for k in _attn_layers(cfg))
    with _ep_mesh():
        # the main path: counts set to 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _ep_probe() as ep, _probed_steps(
                (fops.LAUNCHES, "flash"), (ep, "calls")) as steps:
            fops.reset_launches()
            ep["calls"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = generate(model, prompts, max_new=EP_NEW, max_len=max_len)
            wall = time.perf_counter() - t0
            launches, calls = fops.LAUNCHES["flash"], ep["calls"]
        peak_bytes = torch.cuda.max_memory_allocated()
        prefill_warm_ms = _warm_prefill_ms(model, tokens, max_len)
        prefills = [st for st in steps if st[0] == "prefill"]
        decodes = [st for st in steps if st[0] == "decode"]
        by_step = {kind: {key: sum(st[1][key] for st in sts)
                          for key in ("flash", "calls")}
                   for kind, sts in (("prefill", prefills),
                                     ("decode", decodes))}
        prefill_ms = prefills[0][2].elapsed_time(prefills[0][3])
        decode_ms = decodes[0][2].elapsed_time(decodes[-1][3]) \
            / len(decodes)
        _, trace_wall, busy, by_name = device_trace(
            lambda: model.prefill(tokens, max_len=max_len))
        layers = _ep_layers(model, tokens)
    fops.reset_launches()
    tf = _ep_decode(model, tokens, EP_TEACHER)
    fops.reset_launches()
    row = dict(phase="moe_ep_serve", arch=cfg.name, mesh=dict(
        zip(("data", "model"), EP_MESH)), logical_devices=8,
               experts_per_rank=cfg.n_experts // EP_MESH[1],
               capacity_factor=cfg.capacity_factor, batch=batch,
               prompt=prompt, new_tokens=EP_NEW, max_len=max_len,
               generate_wall_s=wall, tokens_per_s=batch * EP_NEW / wall,
               flash_launches=dict(generate=launches,
                                   prefill=by_step["prefill"]["flash"],
                                   decode=by_step["decode"]["flash"]),
               ep_calls=dict(generate=calls,
                             prefill=by_step["prefill"]["calls"],
                             decode=by_step["decode"]["calls"],
                             moe_layers=n_moe),
               steps=dict(prefill=len(prefills), decode=len(decodes)),
               prefill_ms=prefill_ms, prefill_warm_ms=prefill_warm_ms,
               decode_ms_per_token=decode_ms, local=local,
               peak_memory_gb=peak_bytes / 1e9,
               tokens_in_vocab=bool(0 <= toks.min()
                                    and toks.max() < cfg.vocab_size),
               token_shape=list(toks.shape), prefill_layers=layers,
               prefill_traced=_traced(trace_wall, busy, by_name),
               teacher_forced=tf, tol=FAMILY_SERVE_TOL,
               layer_tol=EP_LAYER_TOL,
               seconds=time.perf_counter() - t_phase)
    emit(row)
    reads = tf["host_reads_per_step"]
    if not (launches == by_step["prefill"]["flash"] == len(_attn_layers(cfg))
            and by_step["decode"]["flash"] == 0
            and by_step["prefill"]["calls"] == n_moe
            and calls == n_moe * (1 + len(decodes))
            and len(prefills) == 1 and len(decodes) == EP_NEW - 1
            and row["tokens_in_vocab"] and toks.shape == (batch, EP_NEW)
            and tf["ep_calls"] == n_moe * EP_TEACHER
            and tf["logits_rel_err"] <= FAMILY_SERVE_TOL
            and reads["local"]["moe"] >= n_moe and reads["ep"]["moe"] == 0
            and reads["ep"]["step"] == reads["local"]["step"]
            - reads["local"]["moe"]
            and layers["layers"] == n_moe
            and layers["rel_err_max"] <= EP_LAYER_TOL
            and layers["planted_fault"]["model_sum_without_last_rank"]
            > EP_LAYER_TOL):
        raise AssertionError(f"moe_ep_serve failed: {row}")
    return row


# ---------------------------------------------------------------------------
# federated training (FedAvg, int8 with error feedback) and elastic restore
# ---------------------------------------------------------------------------

FED_SITES = 4
FED_SYNC_EVERY = 8
FED_ROUNDS = 16           # 2 syncs
FED_LR = 1e-3             # FedAvgTrainer's default
# tests/test_substrate.py::TestCompression's bound on the error-feedback
# residual after 50 rounds of 0.01-scaled normals
EF_ROUNDS = 50
EF_BOUND = 1e-3


class _LossOf:
    """`loss_fn(params, batch)` of `model.loss` at `params` (name ->
    tensor), through `torch.func.functional_call`."""

    def __init__(self, model):
        import torch

        class Loss(torch.nn.Module):
            def __init__(self, m):
                super().__init__()
                self.m = m

            def forward(self, batch):
                return self.m.loss(batch)
        self.module = Loss(model)

    def __call__(self, params, batch):
        import torch
        return torch.func.functional_call(
            self.module, {f"m.{k}": v for k, v in params.items()}, (batch,))


def _ef_residual(n: int, carry: bool, dev) -> float:
    """max|Σ g - Σ dequantize(q)| after EF_ROUNDS rounds of seeded
    0.01-scaled normals of `n` entries; `carry` False drops the error
    feedback (the planted fault: the residual is not carried)."""
    import torch
    from repro_torch.distributed import compress
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = torch.zeros(n, device=dev)
    true = torch.zeros(n, device=dev)
    sent = torch.zeros(n, device=dev)
    for _ in range(EF_ROUNDS):
        g = torch.randn(n, generator=gen, device=dev) * 0.01
        q, s, new_err = compress.quantize_int8(g, err)
        err = new_err if carry else torch.zeros_like(err)
        sent += compress.dequantize(q, s)
        true += g
    return (true - sent).abs().max().item()


def phase_fedavg(peaks: dict, cfg=None, batch: int = 8, seq: int = 256,
                 rounds: int = FED_ROUNDS) -> dict:
    """FedAvg of lm-100m at full width over FED_SITES sites on the card
    (`cfg` and the sizes may be cut for a rehearsal): every site a
    `TokenPipeline` shard of the train phase's data, sync every
    FED_SYNC_EVERY rounds, `loss_fn` through `Model.loss` by
    `functional_call`; run with int8 compression off and on. Holds: the
    loss falls in both, the int8 run's wire bytes over the float32 run's
    equal (n + 4·L) / (4·n) exactly; `quantize_int8` on the card equals
    the CPU's bitwise on a seeded delta of the model's size; the error-
    feedback residual bound at that size, and the planted fault (the
    residual not carried) beyond it. Returns (row, the int8 run's
    anchor)."""
    from fractions import Fraction

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed import compress
    from repro_torch.distributed.fedavg import FedAvgTrainer
    from repro_torch.launch.steps import init_train_state
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    # remat off: a checkpointed period recomputes after functional_call
    # has put the model's own weights back, so its gradient would be the
    # model's, not the site's
    cfg = (cfg or get_config("lm-100m")).with_(remat=False)
    model = build_model(cfg, DEVICE, train=True)
    params, _ = init_train_state(model, seed=SEED)
    params = {k: v.detach().clone() for k, v in params.items()}
    model.requires_grad_(False)
    loss_fn = _LossOf(model)
    pipes = [TokenPipeline(vocab=cfg.vocab_size, batch=batch, seq_len=seq,
                           seed=SEED, shard=s, n_shards=FED_SITES)
             for s in range(FED_SITES)]
    n = sum(v.numel() for v in params.values())
    n_leaves = len(params)
    runs, anchor = {}, None
    for compressed in (False, True):
        tr = FedAvgTrainer(loss_fn=loss_fn, n_sites=FED_SITES,
                           sync_every=FED_SYNC_EVERY, lr=FED_LR,
                           compress_int8=compressed)
        tr.init({k: v.clone() for k, v in params.items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, syncs, sync_s = [], 0, 0.0
        t0 = time.perf_counter()
        for r in range(rounds):
            losses.append([tr.local_step(s, pipes[s].batch_at(r))
                           for s in range(FED_SITES)])
            t1 = time.perf_counter()
            synced = tr.maybe_sync()
            torch.cuda.synchronize()
            sync_s += (time.perf_counter() - t1) if synced else 0.0
            syncs += synced
        wall = time.perf_counter() - t0
        runs["int8" if compressed else "float32"] = dict(
            losses_first=losses[0], losses_last=losses[-1], syncs=syncs,
            bytes_exchanged=tr.bytes_exchanged,
            ms_per_local_step=1e3 * (wall - sync_s) / (rounds * FED_SITES),
            sync_ms=1e3 * sync_s / max(syncs, 1), wall_s=wall,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        if compressed:
            anchor = tr.anchor
        del tr
        torch.cuda.empty_cache()
    ratio = Fraction(runs["int8"]["bytes_exchanged"],
                     runs["float32"]["bytes_exchanged"])

    # quantize_int8 on the card against the CPU, on a seeded delta and a
    # seeded residual shaped as the model's parameters
    gen = torch.Generator().manual_seed(SEED)
    delta = {k: 1e-3 * torch.randn(v.shape, generator=gen)
             for k, v in params.items()}
    err = {k: 1e-5 * torch.randn(v.shape, generator=gen)
           for k, v in params.items()}
    want = compress.compress_tree(delta, err)
    got = compress.compress_tree(
        {k: v.to(DEVICE) for k, v in delta.items()},
        {k: v.to(DEVICE) for k, v in err.items()})
    bitwise = all(torch.equal(g[k].cpu(), w[k]) for g, w in zip(got, want)
                  for k in delta)
    del delta, err, want, got
    ef = _ef_residual(n, True, DEVICE)
    ef_fault = _ef_residual(n, False, DEVICE)
    del model, params
    torch.cuda.empty_cache()
    row = dict(phase="fedavg", arch=cfg.name, sites=FED_SITES,
               sync_every=FED_SYNC_EVERY, rounds=rounds, batch=batch,
               seq=seq, lr=FED_LR, cut=dict(remat=False), params=n,
               leaves=n_leaves, runs=runs,
               wire_ratio=float(ratio),
               wire_ratio_exact=ratio == Fraction(n + 4 * n_leaves, 4 * n),
               quantize_card_equals_cpu=bitwise,
               ef_residual=ef, ef_bound=EF_BOUND,
               planted_fault=dict(error_feedback_dropped=ef_fault))
    emit(row)
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    if not (all(r["syncs"] == rounds // FED_SYNC_EVERY >= 2
                and mean(r["losses_last"]) < mean(r["losses_first"])
                for r in runs.values())
            and row["wire_ratio_exact"] and bitwise
            and ef < EF_BOUND < ef_fault):
        raise AssertionError(f"fedavg failed: {row}")
    return row, anchor


def _block(arr, mesh_shape: tuple, spec: tuple, device: int):
    """The block of `arr` that logical device `device` holds on a
    ("data", "model") mesh of `mesh_shape` (device ids row-major over the
    grid) under `spec` (one axis name or None a dimension): a plain copy of
    jax's rule, to hold the port's placement against."""
    import numpy as np
    axes = ("data", "model")
    at = dict(zip(axes, np.unravel_index(device, mesh_shape)))
    idx = []
    for d, name in zip(arr.shape, tuple(spec) + (None,) * arr.ndim):
        if name is None:
            idx.append(slice(None))
            continue
        size = d // mesh_shape[axes.index(name)]
        idx.append(slice(int(at[name]) * size, (int(at[name]) + 1) * size))
    return arr[tuple(idx)]


def phase_elastic_restore(anchor: dict) -> dict:
    """The int8 FedAvg anchor saved with `store.save`, then restored twice
    with `shardings=`: onto make_mesh((4, 2)) with each 2-D weight split
    over ("data", "model"), and onto make_mesh((2, 4)) with ("model",
    None); 1-D leaves replicated. Every logical device's shard must equal
    the slice of the saved array bitwise."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.distributed import NamedSharding, logical_devices
    from repro_torch.launch.mesh import make_mesh
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = store.save(d, FED_ROUNDS, anchor)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        saved = {}
        for meta in manifest["leaves"]:
            with np.load(os.path.join(path, f"shard_{meta['shard']}.npz")
                         ) as npz:
                saved[meta["index"]] = npz[meta["key"]]
        names = sorted(anchor)  # the checkpoint's leaf order
        restores = {}
        with logical_devices(8):
            for shape, spec in (((4, 2), ("data", "model")),
                                ((2, 4), ("model", None))):
                mesh = make_mesh(shape, ("data", "model"))
                shardings = {k: NamedSharding(mesh, spec if v.ndim == 2
                                              else ())
                             for k, v in anchor.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                back, _ = store.restore(d, anchor, shardings=shardings)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                equal, checked = True, 0
                for i, k in enumerate(names):
                    placed = back[k]
                    arr = saved[i]
                    for dev_id, shard in enumerate(placed.shards):
                        want = _block(arr, shape, placed.sharding.spec,
                                      dev_id)
                        got = shard.cpu().numpy()
                        equal &= (got.shape == want.shape
                                  and got.tobytes() == want.tobytes())
                        checked += 1
                split = sum(placed.shards[0].numel() < placed.value.numel()
                            for placed in back.values())
                restores[f"{shape}"] = dict(
                    spec=list(spec), restore_s=restore_s,
                    shards_checked=checked, leaves_split=split,
                    on_device=all(v.value.device.type
                                  == torch.device(DEVICE).type
                                  for v in back.values()),
                    bitwise=equal)
                del back
    row = dict(phase="elastic_restore", leaves=len(anchor),
               checkpoint_bytes=nbytes, save_s=save_s, restores=restores)
    emit(row)
    if not all(r["bitwise"] and r["on_device"] and r["leaves_split"] > 0
               and r["shards_checked"] == 8 * len(anchor)
               for r in restores.values()):
        raise AssertionError(f"elastic_restore failed: {row}")
    return row


# ---------------------------------------------------------------------------
# the lifecycle builtins, rand and parfor (grid search, cross validation)
# ---------------------------------------------------------------------------

LIFE_M, LIFE_N = 100_000, 1_000   # the lmds point
LIFE_ITERS = 10                   # kmeans / l2svm / mlogreg max_iter (cut)
TRACED_ITERS = 3                  # iterations of their traced fits
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
    xtv at the lmds point: a narrow X and a wide v, the tile product with
    v in the 128-wide tiles and A in 8-wide ones. Against the plain
    version (float64) with the kernel's route and plan, its split
    workspace and torch.matmul's time."""
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
    route = ops.xtv_route(m, 8, n, torch.float64, ops._sm_count(x.device))
    splits, rows = route[-2:]
    bms, by = bound("xtv", m, 8, n, "float64",
                    peaks_for(torch.cuda.get_device_name(0))[1])
    return dict(shape=[m, 8, n], scaled_err=err, ok=err <= TOL["float64"],
                ms=ms, library_ms=cuda_ms(lambda: torch.matmul(a.mT, x)),
                bound_ms=bms, bound_by=by, route=route, splits=splits,
                rows_per_split=rows,
                workspace_mb=(splits > 1) * splits * 8 * n * 8 / 2**20,
                path_launches=run["launches"]["xtv_tile"])


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
        "pca": (lambda rt, its, a=xn: pca(input_tensor("X", a), 10,
                                          runtime=rt), 1),
        "kmeans": (lambda rt, its: kmeans(input_tensor("X", xk), 8,
                                          max_iter=its, seed=1, tol=0.0,
                                          runtime=rt), iters),
        "l2svm": (lambda rt, its: l2svm(input_tensor("X", xn),
                                        input_tensor("y", y_svm),
                                        max_iter=its, tol=0.0, runtime=rt),
                  iters),
        "mlogreg": (lambda rt, its: mlogreg(input_tensor("X", xn),
                                            input_tensor("Y", y_oh),
                                            max_iter=its, runtime=rt),
                    iters),
    }
    rows, launches = {}, {}
    for name, (fn, its) in runs.items():
        rt = LineageRuntime(device=dev)
        gops.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        got = fn(rt, its)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches[name] = dict(gops.LAUNCHES)
        # the traced fit runs TRACED_ITERS iterations (all until
        # moe_ep_serve came in): its upload share
        traced = _trace_of(lambda: fn(LineageRuntime(device=dev),
                                      min(its, TRACED_ITERS)), dev)
        t0 = time.perf_counter()
        want = fn(LineageRuntime(device="cpu"), its)
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
                          traced_iterations=min(its, TRACED_ITERS),
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
    # kmeans' AᵀX (8 x 1,000 columns) and mlogreg's gradient (10 classes)
    # on the tile product, l2svm's one column on the slab kernel
    if not (launches["pca"]["gram"] and launches["kmeans"]["xtv_tile"]
            and launches["l2svm"]["xtv"] and launches["mlogreg"]["xtv_tile"]):
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
    X or v once for the batch), every output written once
    (`launch.kernel_model`'s `gram_batched_work` / `xtv_batched_work`)."""
    from repro_torch.launch import kernel_model as km
    work = km.gram_batched_work(k, m, n, dtype) if kind == "gram" \
        else km.xtv_batched_work(k, m, n, c, dtype, v_batched, x_batched)
    return _t(work, peaks[dtype], peaks["bw"])


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
            return ops.xtv_route(m, n, k, x.dtype, sms)
        return ops.xtv_route(m, n, 1, x.dtype, sms, k)

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
        # one launch of the batched kernel (the fold: of the lone tile
        # product, k columns) and at most one of its reduce, nothing else
        one = ("xtv_tile" if route == "fold" else f"{kind}_batched")
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
    The server runs at pipeline depth 2 (the issue/completion split); the
    same concurrent traffic then goes through a depth-1 server (the
    inline dispatcher) on the same closures: the same bits, with both
    depths' p50/p99 and requests/s in a `pipeline` row. Returns the
    training's gram/xtv launches."""
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
    with _depth(2):
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
        rebatches = rt.stats.pipeline.rebatches
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
    # the same 16-client traffic through a depth-1 server (the inline
    # dispatcher) on the same closures
    rt1 = LineageRuntime(device=dev)
    script1 = PreparedScript(scoring, [(1, n)], runtime=rt1)
    preds1: list = [None] * requests
    lat1 = np.zeros(requests)
    with _depth(1):
        with ModelServer(script1, max_batch=16, max_wait_us=2000.0) as srv1:
            def client1(c):
                for i in range(c, requests, clients):
                    t = time.perf_counter()
                    preds1[i] = srv1.score(rows[requests + i], timeout=60.0)
                    lat1[i] = time.perf_counter() - t
            threads = [threading.Thread(target=client1, args=(c,))
                       for c in range(clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300.0)
            conc1_s = time.perf_counter() - t0
            pipelined1 = srv1._pipelined
    ms1 = 1e3 * lat1
    depth_bitwise = all(np.array_equal(a, b) for i in range(requests)
                        for a, b in zip(preds1[i], preds[requests + i],
                                        strict=True))
    prow = dict(phase="pipeline", path="serve_plan", clients=clients,
                requests=requests, rebatches=rebatches,
                retraces=log["retraces"] + rt1.stats.serving.retraces,
                bitwise_across_depths=depth_bitwise,
                depth2=dict(p50_ms=float(np.percentile(ms[requests:], 50)),
                            p99_ms=float(np.percentile(ms[requests:], 99)),
                            requests_per_s=requests / conc_s,
                            mean_coalesce=conc_log["mean_coalesce"]),
                depth1=dict(p50_ms=float(np.percentile(ms1, 50)),
                            p99_ms=float(np.percentile(ms1, 99)),
                            requests_per_s=requests / conc1_s,
                            mean_coalesce=rt1.stats.serving.requests
                            / max(rt1.stats.serving.batches, 1)))
    emit(prow)
    if not (rebatches > 0 and depth_bitwise and prow["retraces"] == 0
            and not pipelined1):
        raise AssertionError(f"serve_plan across depths failed: {prow}")
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


# ---------------------------------------------------------------------------
# training: lm-100m at full width through the trainer, qwen3-0.6b in bf16
# ---------------------------------------------------------------------------

# lm-100m's first step in float32 against a float64 twin of the same model,
# weights and batch (its products, residual stream and gradients in
# float64; the norms, RoPE, softmax and the loss's logsumexp compute in
# float32, as the model's code says): the loss relative to the twin's
# (TRAIN_LOSS_TOL) and each parameter's gradient, max|g - g64| over
# max|g64| (TRAIN_GRAD_TOL). Planted faults: the first loss chunk's labels
# rolled by one position, and attention that sees one position ahead
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-3
# qwen3-0.6b's first step in bf16 (float32 masters) against the same step
# with the model in float32, each gradient over its leaf's max; the
# planted fault is the rolled loss chunk
BF16_TRAIN_GRAD_TOL = 1e-1
# the reference trainer's defaults at lm-100m, 100 steps, a checkpoint at
# 50
TRAIN_FLAGS = ["--arch", "lm-100m", "--steps", "100", "--batch", "8",
               "--seq-len", "256", "--lr", "3e-4", "--warmup", "20",
               "--ckpt-every", "50", "--seed", str(SEED), "--log-every", "10"]


def _loss_grads(model, batch):
    """(loss, {name: gradient}) of `model.loss(batch)` over every
    parameter."""
    import torch
    names, params = zip(*model.named_parameters())
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


def _worst_grad(got, want) -> dict:
    """The leaf with the largest max|got - want| over max|want|."""
    errs = {n: ((got[n].double() - w.double()).abs().max()
                / w.double().abs().max().clamp_min(1e-30)).item()
            for n, w in want.items()}
    name = max(errs, key=errs.get)
    return dict(leaf=name, err=errs[name])


def _roll_chunk(batch, chunk):
    """The first loss chunk's labels rolled by one position."""
    import numpy as np
    labels = batch["labels"].copy()
    labels[:, :chunk] = np.roll(labels[:, :chunk], 1, axis=1)
    return dict(batch, labels=labels)


@contextlib.contextmanager
def _peeking_attention():
    """Causal attention seeing one position ahead (the mask off by one),
    on whichever route training takes: a planted fault."""
    from repro_torch.models import attention as attn_mod
    orig = attn_mod.attention_core

    def peek(q, k, v, *, causal, cfg, impl=None, q_offset=0):
        if not causal:
            return orig(q, k, v, causal=causal, cfg=cfg, impl=impl,
                        q_offset=q_offset)
        return attn_mod.ref_attention(q, k, v, causal=True,
                                      q_offset=q_offset + 1)
    attn_mod.attention_core = peek
    try:
        yield
    finally:
        attn_mod.attention_core = orig


def _step_cost(step_fn, opt, batch, against_flop_counter: bool = False
               ) -> dict:
    """One train step on `batch` counted by `launch.hlocost` (its products
    in the forward, the checkpointed recompute and the backward, every
    other op, the optimizer's): the counter holds no tensor, so the step
    runs in a plain step's memory. With `against_flop_counter` the step
    runs inside `torch.utils.flop_counter.FlopCounterMode` as well, whose
    count must equal the counter's product FLOPs (that mode keeps the
    checkpointed activations alive: 4.3x a plain step's live memory, so
    it counts small models only)."""
    from repro_torch.launch import hlocost
    from torch.utils.flop_counter import FlopCounterMode
    fc = FlopCounterMode(display=False) if against_flop_counter \
        else contextlib.nullcontext()
    with fc:
        totals = hlocost.count(step_fn, opt, batch)
    out = dict(flops=totals.flops, bytes=totals.bytes,
               transcendentals=totals.transcendentals,
               product_flops=totals.product_flops,
               peak_live_bytes=totals.peak_bytes)
    if against_flop_counter:
        out["flop_counter_flops"] = float(fc.get_total_flops())
        if out["flop_counter_flops"] != totals.product_flops:
            raise AssertionError(f"the counter's product FLOPs differ "
                                 f"from FlopCounterMode's: {out}")
    return out


def phase_dryrun(arch: str = "qwen3-0.6b", shape: str = "train_4k") -> dict:
    """One dry-run cell at full width: `launch.dryrun.lower_cell` for
    `arch` × `shape` on the production (16, 16) mesh over 256 logical
    devices, counted on "meta" (nothing allocated, no card work); its
    `RooflineCell` at the published peaks of NVIDIA H100 80GB HBM3 at
    700 W."""
    import math
    from repro_torch.distributed import logical_devices
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_production_mesh
    with logical_devices(256):
        _, totals, cell = lower_cell(arch, shape, make_production_mesh(),
                                     verbose=False)
    row = dict(phase="dryrun", cell=cell.to_dict(),
               table=roofline.format_table([cell]).splitlines(),
               peaks_of=roofline.CARD)
    emit(row)
    if not (cell.n_devices == 256 and cell.tokens > 0
            and all(math.isfinite(v) and v > 0 for v in (
                cell.hlo_flops, cell.hlo_bytes, cell.coll_wire_bytes,
                cell.model_flops, cell.arg_bytes, cell.temp_bytes))
            and totals.unknown_trip_counts == 0
            and 0.5 < cell.flops_ratio <= 1.0):
        raise AssertionError(f"the dry-run cell failed: {row}")
    return row


def _ckpt_leaves(path: str) -> list:
    """A checkpoint directory's leaves as numpy, in the stored order."""
    import numpy as np
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for leaf in manifest["leaves"]:
        with np.load(os.path.join(path, f"shard_{leaf['shard']}.npz")) as z:
            out.append(z[leaf["key"]])
    return out


def _refusals() -> dict:
    """{kernel: True} where its CUDA wrapper, handed an input that requires
    grad in grad mode, raises for want of a backward."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.kernels.ssd import ops as sops

    def z(*shape):
        return torch.zeros(shape, device=DEVICE)
    calls = {"flash": (fops.flash_attention_cuda,
                       (z(1, 64, 2, 64), z(1, 64, 2, 64), z(1, 64, 2, 64))),
             "wkv6": (wops.wkv6_cuda,
                      (z(1, 64, 2, 64), z(1, 64, 2, 64), z(1, 64, 2, 64),
                       z(1, 64, 2, 64) - 0.5, z(2, 64), z(1, 2, 64, 64))),
             "ssm_scan": (sops.ssm_scan_cuda,
                          (z(1, 64, 32), z(1, 64, 32), z(32, 16) - 1,
                           z(1, 64, 16), z(1, 64, 16), z(32),
                           z(1, 32, 16)))}
    refused = {}
    for name, (fn, args) in calls.items():
        args[0].requires_grad_(True)
        try:
            fn(*args)
            refused[name] = False
        except RuntimeError as e:
            refused[name] = "no backward" in str(e)
    return refused


def _lm_train(peaks: dict, flags: list) -> dict:
    """lm-100m: the first step against its float64 twin and the planted
    faults, then the trainer uninterrupted and resumed at its checkpoint."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train as trainer
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import build_model
    args = trainer.parse_args(flags)
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    pipe = TokenPipeline(vocab=cfg.vocab_size, batch=args.batch,
                         seq_len=args.seq_len, seed=args.seed)

    model = build_model(cfg, DEVICE, train=True)
    init_train_state(model, seed=args.seed)
    batch = pipe.batch_at(0)
    twin = build_model(cfg.with_(dtype="float64"), DEVICE)
    twin.load_state_dict(model.state_dict())
    twin.double().requires_grad_(True)
    loss64, g64 = _loss_grads(twin, batch)
    del twin

    def against_twin(b=batch, ctx=contextlib.nullcontext):
        with ctx():
            loss, g = _loss_grads(model, b)
        return dict(loss=loss.item(),
                    loss_rel_err=abs(loss.double() - loss64).item()
                    / abs(loss64.item()),
                    worst_grad=_worst_grad(g, g64))
    first = against_twin()
    faults = dict(labels_rolled=against_twin(_roll_chunk(batch,
                                                         cfg.loss_chunk)),
                  attention_peeks=against_twin(ctx=_peeking_attention))
    n_params = model.n_params()
    del model, g64
    torch.cuda.empty_cache()

    # the main path: uninterrupted; then a second run given only the first
    # run's step-50 checkpoint (the first run died there) continues to 100
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_a = trainer.main(flags + ["--ckpt-dir", f"{tmp}/a"])
        wall = time.perf_counter() - t0
        peak_bytes = torch.cuda.max_memory_allocated()
        half = f"step_{args.ckpt_every:08d}"
        shutil.copytree(f"{tmp}/a/{half}", f"{tmp}/b/{half}")
        run_b = trainer.main(flags + ["--ckpt-dir", f"{tmp}/b"])
        last = f"step_{args.steps:08d}"
        same_ckpt = all(
            x.dtype == y.dtype and x.tobytes() == y.tobytes()
            for x, y in zip(_ckpt_leaves(f"{tmp}/a/{last}"),
                            _ckpt_leaves(f"{tmp}/b/{last}"), strict=True))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resumed = dict(
        start_step=run_b["start_step"], checkpoint=same_ckpt,
        params=all(torch.equal(p, q) for p, q in zip(
            run_a["model"].parameters(), run_b["model"].parameters())),
        losses=run_b["losses"] == run_a["losses"][run_b["start_step"]:])
    losses = run_a["losses"]
    step_ms = float(np.median(run_a["step_ms"][10:]))

    # one step more, traced, and its products counted
    step_fn = make_train_step(run_a["model"], lr=args.lr)
    nxt = pipe.batch_at(args.steps)
    opt = run_a["opt_state"]
    _, trace_wall, busy, by_name = device_trace(lambda: step_fn(opt, nxt))
    cost = _step_cost(step_fn, opt, nxt, against_flop_counter=True)
    flops = cost["product_flops"]
    del run_a, run_b, step_fn, opt
    torch.cuda.empty_cache()
    return dict(
        arch=cfg.name, n_params=n_params, dtype=cfg.dtype, batch=args.batch,
        seq=args.seq_len, steps=args.steps, ckpt_every=args.ckpt_every,
        wall_s=wall, loss_first5=float(np.mean(losses[:5])),
        loss_last5=float(np.mean(losses[-5:])), step_ms=step_ms,
        tokens_per_s=args.batch * args.seq_len / (step_ms / 1e3),
        peak_memory_gb=peak_bytes / 1e9, flops_per_step=flops, cost=cost,
        bound_ms=1e3 * flops / peaks["float32"], bound_by="operations",
        first_step=first, planted_faults=faults, resumed_bitwise=resumed,
        traced=_traced(trace_wall, busy, by_name))


def _bf16_train(peaks: dict, cfg, batch: int, seq: int, steps: int) -> dict:
    """qwen3-0.6b in bf16 with float32 masters: the first step's gradients
    against the float32 model's, then `steps` train steps, each followed
    by the check that the weights a step computes with are the masters
    cast (a serving model loaded from them gives the same hidden states,
    bitwise)."""
    import numpy as np
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import build_model
    model = build_model(cfg, DEVICE, train=True)
    params, opt = init_train_state(model, seed=SEED)
    pipe = TokenPipeline(vocab=cfg.vocab_size, batch=batch, seq_len=seq,
                         seed=SEED)
    b0 = pipe.batch_at(0)
    _, g16 = _loss_grads(model, b0)
    f32 = build_model(cfg.with_(dtype="float32"), DEVICE, train=True)
    f32.load_state_dict(model.state_dict())
    _, g32 = _loss_grads(f32, b0)
    del f32
    grad = _worst_grad(g16, g32)
    del g16
    _, gf = _loss_grads(model, _roll_chunk(b0, cfg.loss_chunk))
    fault = _worst_grad(gf, g32)
    del gf, g32
    torch.cuda.empty_cache()

    serve = build_model(cfg, DEVICE)
    serve_gb = sum(p.numel() * p.element_size()
                   for p in serve.parameters()) / 1e9
    probe = torch.as_tensor(b0["tokens"][:1]).to(DEVICE)
    step_fn = make_train_step(model, lr=3e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, cast_ok = [], [], []
    for s in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        opt, m = step_fn(opt, pipe.batch_at(s))
        ev[1].record()
        losses.append(float(m["loss"]))
        times.append(ev[0].elapsed_time(ev[1]))
        serve.load_state_dict(model.state_dict())
        with torch.no_grad():
            weights = all(torch.equal(q, p.to(q.dtype)) for p, q in zip(
                model.parameters(), serve.parameters()))
            hidden = torch.equal(model._forward(probe, plain=True)[0],
                                 serve._forward(probe, plain=True)[0])
        cast_ok.append(weights and hidden)
    peak_bytes = torch.cuda.max_memory_allocated()
    wq = params["periods.0.0:attn.attn.wq"].detach()
    off_grid = (wq != wq.to(torch.bfloat16).float()).float().mean().item()
    masters = all(p.dtype == torch.float32 for p in params.values())
    nxt = pipe.batch_at(steps)
    _, trace_wall, busy, by_name = device_trace(lambda: step_fn(opt, nxt))
    cost = _step_cost(step_fn, opt, nxt)
    flops = cost["product_flops"]
    step_ms = float(np.median(times[1:] or times))
    del model, serve, params, opt, step_fn
    torch.cuda.empty_cache()
    return dict(
        arch=cfg.name, dtype=cfg.dtype, batch=batch, seq=seq, steps=steps,
        losses=losses, step_ms=step_ms, step_ms_each=times,
        tokens_per_s=batch * seq / (step_ms / 1e3),
        peak_memory_gb=peak_bytes / 1e9, serving_copy_gb=serve_gb,
        flops_per_step=flops, cost=cost,
        bound_ms=1e3 * flops / peaks["bfloat16"], bound_by="operations",
        first_step_vs_float32=grad,
        planted_fault=fault, masters_float32=masters,
        masters_off_bf16_grid=off_grid, weights_are_masters_cast=cast_ok,
        traced=_traced(trace_wall, busy, by_name))


def phase_train(peaks: dict, reduced: bool = False, bf16_cfg=None,
                bf16_batch: int = 8, bf16_seq: int = 2048,
                bf16_steps: int = 5) -> dict:
    """Training on the card: lm-100m at full width through
    `repro_torch.launch.train.main`, then qwen3-0.6b in bf16 (`reduced`
    and `bf16_cfg` with its sizes cut both for a rehearsal). Returns the
    model kernels' launches on the path: none, training takes the plain
    routes (the wrappers refuse a gradient)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.kernels.ssd import ops as sops
    torch.backends.cuda.matmul.allow_tf32 = False
    refused = _refusals()
    flags = TRAIN_FLAGS + ["--device", DEVICE] + (["--reduced"] if reduced
                                                  else [])
    for mod in (fops, wops, sops):
        mod.reset_launches()
    lm = _lm_train(peaks, flags)
    emit(dict(phase="train", part="lm", **lm))
    qwen = _bf16_train(peaks, bf16_cfg or get_config("qwen3-0.6b"),
                       bf16_batch, bf16_seq, bf16_steps)
    emit(dict(phase="train", part="bf16", **qwen))
    launches = dict(flash=fops.LAUNCHES["flash"], wkv6=wops.LAUNCHES["wkv6"],
                    ssm_scan=sops.LAUNCHES["ssm_scan"])
    row = dict(phase="train", launches=launches,
               wrappers_refuse_grad=refused,
               tol=dict(loss=TRAIN_LOSS_TOL, grad=TRAIN_GRAD_TOL,
                        bf16_grad=BF16_TRAIN_GRAD_TOL))
    emit(row)
    # every fault beyond a limit, and every limit below a fault
    first, faults = lm["first_step"], lm["planted_faults"]
    beyond = [(f["loss_rel_err"] > TRAIN_LOSS_TOL,
               f["worst_grad"]["err"] > TRAIN_GRAD_TOL)
              for f in faults.values()]
    caught = all(map(any, beyond)) and all(map(any, zip(*beyond)))
    if not (all(refused.values()) and not any(launches.values())
            and lm["loss_last5"] < lm["loss_first5"]
            and first["loss_rel_err"] <= TRAIN_LOSS_TOL
            and first["worst_grad"]["err"] <= TRAIN_GRAD_TOL and caught
            and all(v is True for k, v in lm["resumed_bitwise"].items()
                    if k != "start_step")
            and lm["resumed_bitwise"]["start_step"] == lm["ckpt_every"]
            and all(abs(x) < float("inf") for x in qwen["losses"])
            and qwen["first_step_vs_float32"]["err"] <= BF16_TRAIN_GRAD_TOL
            and qwen["planted_fault"]["err"] > BF16_TRAIN_GRAD_TOL
            and qwen["masters_float32"] and qwen["masters_off_bf16_grid"] > 0.5
            and all(qwen["weights_are_masters_cast"])):
        raise AssertionError(f"train failed: {row}, lm {lm}, bf16 {qwen}")
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


def flash_spills(log: str, dtype: str) -> dict:
    """Spill bytes of each flash instantiation of `dtype` ("bf16" or
    "f32"), keyed "{q/k head dim}:{v head dim}"."""
    return ptxas_spills(log, rf"flash_{dtype}_kernelILi(\d+)ELi(\d+)E")


def gram_spills(log: str) -> dict:
    """Spill bytes of each float64 gram partial kernel (tile width, copy
    width), bfloat16 wgmma gram kernel (tile width) and xtv tile product
    (dtype, W's tile width), by kernel and template arguments."""
    return ptxas_spills(log, r"(gram_f64_partial_kernel|gram_bf16_wgmma_kernel"
                             r"|xtv_tile_kernel)I(\w+?)EE")


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
    # the train phase's bit-exact restart runs with deterministic
    # algorithms, whose cuBLAS check PyTorch makes against this variable
    # once, at the process's first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    key, peaks = peaks_for(name)
    emit(dict(phase="device", name=name, count=torch.cuda.device_count(),
              nvidia_smi=smi, peaks_of=key, peaks=peaks,
              torch=torch.__version__, cuda=torch.version.cuda))

    t0 = time.perf_counter()
    sources = ("gram", "spmm", "flash", "wkv6", "ssd")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        built = dict(zip(sources, pool.map(build.build, sources)))
    spills = flash_spills(build.build_log("flash"), "bf16")
    fspills = flash_spills(build.build_log("flash"), "f32")
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
              flash_bf16_spill_bytes=spills, flash_f32_spill_bytes=fspills,
              gram_spill_bytes=gspills,
              wkv6_spill_bytes=wspills, ssd_spill_bytes=sspills,
              spmm_spill_bytes=mspills))
    pairs = ["128:128", "192:128", "32:32", "64:64"]
    if sorted(spills) != pairs or any(spills.values()):
        raise AssertionError(f"bf16 flash instantiations spill (or are not "
                             f"all built): {spills}")
    # MLA's float32 instantiation (a new shape of the FMA kernel)
    if sorted(fspills) != pairs or fspills["192:128"]:
        raise AssertionError(f"the float32 (192, 128) flash instantiation "
                             f"spills (or is not built): {fspills}")
    # float64 partial: 2 tile widths x 2 copy widths; the bf16 wgmma
    # gram: 2 tile widths; the xtv tile product: 3 dtypes x 4 widths of W
    want = {"gram_f64_partial_kernel": 4, "gram_bf16_wgmma_kernel": 2,
            "xtv_tile_kernel": 12}
    if any(len([k for k in gspills if k.startswith(name)]) != n
           for name, n in want.items()) or any(gspills.values()):
        raise AssertionError(f"gram.cu's float64 partial, bf16 wgmma or xtv "
                             f"tile kernels spill (or are not all built): "
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

    # the WKV6 and sharded phases count kernels in profiler traces: they
    # run first, since after a hundred earlier traces in one process the
    # profiler was seen to drop one record of every trace of a case (on
    # an H100, two runs in a row; the sharded phase's traces too, after
    # federated); run first, WKV6 once lost the first record of every
    # trace of its last case, which device_trace's sentinel now absorbs.
    # The sharded phase adds 4 traces before WKV6's
    seconds: dict = {}  # wall seconds of each phase

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        name = phase.__name__.removeprefix("phase_")
        seconds[name] = time.perf_counter() - t
        emit(dict(timed=name, seconds=seconds[name],
                  since_build_s=time.perf_counter() - t0))
        return out

    timed(phase_dryrun)
    shard_launches, per_shard = timed(phase_sharded, peaks)
    wkv6_row = timed(phase_wkv6_kernels, peaks)
    main_rows = timed(phase_kernels, peaks)
    sparse_rows = timed(phase_sparse_kernels, peaks)
    flash_rows = timed(phase_flash_kernels, peaks)
    ssm_row = timed(phase_ssm_kernels, peaks)
    batched_rows = timed(phase_batched_kernels, peaks)
    timed(phase_quickstart)
    launches = timed(phase_lmds)
    pipe_launches = timed(phase_pipeline)
    timed(phase_steplm)
    fed_launches = timed(phase_federated)
    _LMDS_POINT.clear()
    sparse_launches = timed(phase_sparse_lm)
    algo_launches = timed(phase_algorithms)
    timed(phase_cleaning)
    timed(phase_rand)
    grid_launches = timed(phase_grid_search)
    sparse_grid = timed(phase_sparse_grid, peaks)
    cv_launches = timed(phase_cv)
    life_launches = timed(phase_lifecycle_pipeline)
    csv_launches = timed(phase_csv_stream)
    plan_launches = timed(phase_serve_plan)
    serve_launches = timed(phase_lm_serve, peaks)
    rwkv_launches = timed(phase_rwkv_serve, peaks)
    hybrid_launches = timed(phase_hybrid_serve, peaks)
    moe_launches, ep_row = timed(phase_moe_serve, peaks)
    seconds["moe_ep_serve (in moe_serve)"] = ep_row["seconds"]
    family_launches = dict(moe_serve=moe_launches,
                           moe_ep_serve=ep_row["flash_launches"],
                           mla_serve=timed(phase_mla_serve, peaks),
                           vlm_serve=timed(phase_vlm_serve, peaks),
                           audio_serve=timed(phase_audio_serve, peaks))
    train_launches = timed(phase_train, peaks)
    _, anchor = timed(phase_fedavg, peaks)
    timed(phase_elastic_restore, anchor)
    del anchor
    emit(dict(phase="timing", seconds=seconds,
              total_s=time.perf_counter() - t0, profiler=PROFILER))

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
                serve_plan_train=plan_launches[kind],
                **{p: v[kind] for p, v in pipe_launches.items()},
                **{p: v[kind] for p, v in fed_launches.items()},
                **{p: v[kind] for p, v in shard_launches.items()}),
            per_shard=per_shard.get(kind),
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            device_ms=r["device_ms"], host_us=r["host_us"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    # xtv of two or more columns: the tile product (lone, folded and
    # batched launches), at kmeans' AᵀX with mlogreg's and the fold's rows
    # beside it; its launches by path (a path's dict may lack the keys:
    # then 0)
    paths = dict(lmds=launches, **algo_launches, grid_search_vmap=grid_launches,
                 cv_vmap=cv_launches, lifecycle_pipeline=life_launches,
                 csv_stream=csv_launches, serve_plan_train=plan_launches,
                 **pipe_launches, **fed_launches, **shard_launches)
    tile_rows = {k.split(":")[1]: r for k, r in main_rows.items()
                 if k.startswith("xtv_tile:")}
    r = tile_rows["kmeans"]
    kernels.append(dict(
        name="xtv_tile", route="cuda", source="src/repro_torch/csrc/gram.cu",
        replaces="src/repro/kernels/gram/kernel.py:83",
        launches=sum(v.get("xtv_tile", 0) + v.get("xtv_tile_batched", 0)
                     for v in paths.values()),
        reduce_launches=sum(v.get("xtv_tile_reduce", 0)
                            + v.get("xtv_tile_batched_reduce", 0)
                            for v in paths.values()),
        launches_by_path={p: v.get("xtv_tile", 0) + v.get("xtv_tile_batched", 0)
                          for p, v in paths.items()},
        shape=[r["m"], r["n"], r["c"]], plan=r["plan"],
        max_abs_err=r["max_abs_err"], ms=r["ms"],
        device_ms=r["device_ms"], host_us=r["host_us"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        rows={name: dict(shape=[q["m"], q["n"], q["c"]], plan=q["plan"],
                         ms=q["ms"], device_ms=q["device_ms"],
                         host_us=q["host_us"], bound_ms=q["bound_ms"],
                         library_ms=q["library_ms"])
              for name, q in tile_rows.items()}))
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
              "sparse_stream_depth1": (32_768, 1000),
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
            if path not in ("sparse_stream", "sparse_stream_depth1"):
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
    r = flash_rows[FLASH_CASES[0][0]]
    flash_by_path = dict(
        lm_serve_prefill=serve_launches["prefill"],
        lm_serve_decode=serve_launches["decode"],
        hybrid_serve_prefill=hybrid_launches["prefill"]["flash"],
        hybrid_serve_decode=hybrid_launches["decode"]["flash"],
        train=train_launches["flash"])
    for path, fl in family_launches.items():
        flash_by_path[f"{path}_prefill"] = fl["prefill"]
        flash_by_path[f"{path}_decode"] = fl["decode"]
    # MLA's (192, 128) instantiation at deepseek-v2-236b's prefill shape
    m = flash_rows[FLASH_MLA_CASE]
    kernels.append(dict(
        name="flash", route="cuda", source="src/repro_torch/csrc/flash.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:83",
        launches=sum(flash_by_path.values()),
        launches_by_path=flash_by_path,
        max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        instantiations={"192:128": dict(
            case=m["case"], launches=family_launches["mla_serve"]["prefill"],
            max_abs_err=m["max_abs_err"], ms=m["ms"],
            device_ms=m["device_ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"],
            library_ms=m["library_ms"])}))
    r = wkv6_row
    kernels.append(dict(
        name="wkv6", route="cuda", source="src/repro_torch/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6/kernel.py:99",
        launches=rwkv_launches["generate"],
        launches_by_path=dict(rwkv_serve_prefill=rwkv_launches["prefill"],
                              rwkv_serve_decode=rwkv_launches["decode"],
                              train=train_launches["wkv6"]),
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
            hybrid_serve_decode=hybrid_launches["decode"]["ssm_scan"],
            train=train_launches["ssm_scan"]),
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
