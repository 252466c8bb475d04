"""Compile-time per-node cost model (SystemDS §3.2 cost-based compilation).

Estimates the execution cost of a single HOP from its size/sparsity
metadata alone, *before* anything runs. Consumers:

  * probe-point selection (`repro_torch.core.compiler`) — an
    intermediate is a lineage-reuse probe point only when its estimated
    cost clears the cache's worth-keeping threshold
    (`reuse.MIN_CACHE_COST_S`), so segments stay maximal between probes;
  * chunked placement — `should_chunk` / `chunk_rows` decide when a
    leaf streams and how many rows each bucket holds.

  * parfor arbitration — `batched_cost_s` / `sequential_cost_s` price
    the vmapped grid against the sequential-reuse loop
    (`repro_torch.core.batching.choose_mode`);
  * serving — `coalesce_wait_s` prices the coalescer's window
    (`repro_torch.serving.ModelServer`);
  * fault policy — `max_retries` / `retry_backoff_s` bound the chunk-IO
    retry ladder (`repro_torch.data.csv_io`).

Port of `repro.core.costmodel` for the lanes this package runs (local,
chunked, the batched parfor lane, serving and the fault policy). The
constants, environment names and formulas are the reference's,
unchanged, so both packages compile identical plans, choose the same
parfor mode and hold a request for the same window; they are NOT tuned
for the GPU. The federated and sharded sections of the reference
(`fed_timeout_s` and `config_shard_cost_s` included) come with those
lanes.

One deliberate difference: `pipeline_depth()` resolves to 1 (the
synchronous lane, the only one ported) and refuses an explicit
``REPRO_PIPELINE_DEPTH >= 2``.
"""
from __future__ import annotations

import os

import numpy as np

from .dag import Node
from .reuse import MIN_CACHE_COST_S

# Calibration: effective single-stream rates for the local backend
# (the reference's values, kept so plans stay identical).
PEAK_FLOPS = 4e9     # flop/s
PEAK_BW = 2e10       # bytes/s

# Per-op launch overhead (seconds): BLAS-class / factorization kernels
# pay a real dispatch+sync constant; cheap elementwise ops are fusable
# and nearly free to re-issue.
HEAVY_OP_BASE_S = 25e-6
LIGHT_OP_BASE_S = 1e-6

# Ops with BLAS/LAPACK-class launch cost regardless of operand size.
HEAVY_OPS = frozenset({
    "matmul", "gram", "xtv", "solve", "cholesky", "inv",
})

# An intermediate becomes a lineage-reuse probe point when its estimated
# cost clears the cache's own worth-keeping threshold.
PROBE_MIN_COST_S = MIN_CACHE_COST_S


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _exec_sparsity(n: Node) -> float:
    """Density the executor can exploit for operand `n`: the density of
    the BCOO-formatted leaf at the end of a structure-preserving chain,
    else 1.0. Mode-independent (read whatever `sparse_inputs` is), as in
    the reference, so probe sets match across runtimes."""
    from . import backend
    if not backend.HAS_SPARSE:
        return 1.0
    cur = n
    while cur.op != "input":
        i = backend.bcoo_passthrough_arg(cur)
        if i is None:
            return 1.0  # produced by a dense-output op
        cur = cur.inputs[i]
    if backend.leaf_format(cur) == backend.BCOO:
        return max(cur.sparsity, 1e-6)
    return 1.0


def node_flops(n: Node) -> float:
    """Estimated floating-point work of one HOP (sparsity-aware)."""
    op = n.op
    out = _numel(n.shape)
    if op == "matmul":
        a, b = n.inputs
        k = a.shape[-1]
        return 2.0 * out * k * min(_exec_sparsity(a), _exec_sparsity(b))
    if op == "gram":
        (a,) = n.inputs
        m = a.shape[0]
        return 2.0 * out * m * _exec_sparsity(a)
    if op == "xtv":
        a, v = n.inputs
        m = a.shape[0]
        return 2.0 * out * m * _exec_sparsity(a)
    if op in ("solve", "inv"):
        k = n.inputs[0].shape[0]
        return (2.0 / 3.0) * k ** 3 + 2.0 * k * k * out
    if op == "cholesky":
        k = n.shape[0]
        return k ** 3 / 3.0
    if op in ("sum", "mean", "max", "min", "trace", "nnz", "colSums",
              "rowSums", "colMeans", "rowMeans", "colMaxs", "colMins",
              "colVars", "cumsum"):
        return float(max((_numel(i.shape) for i in n.inputs), default=out))
    # elementwise / structural / generators: ~1 flop per output element
    return float(out)


def node_bytes(n: Node) -> float:
    """Estimated memory traffic: inputs read + output written, at the
    format-aware sizes from `Node.est_bytes`."""
    return float(n.est_bytes() + sum(i.est_bytes() for i in n.inputs))


def est_cost_s(n: Node) -> float:
    """Estimated wall-clock seconds to execute one HOP standalone."""
    if n.op.startswith("chunk_") or n.op == "combine":
        return chunk_cost_s(n)
    base = HEAVY_OP_BASE_S if n.op in HEAVY_OPS else LIGHT_OP_BASE_S
    return base + max(node_flops(n) / PEAK_FLOPS, node_bytes(n) / PEAK_BW)


def _dense_bytes(n: Node) -> float:
    return float(_numel(n.shape)) * np.dtype(n.dtype).itemsize


# ---------------------------------------------------------------------------
# Chunked (out-of-core) placement: streaming row-partitioned execution
# under an explicit device-memory budget
# ---------------------------------------------------------------------------

# Device-memory budget for the streaming executor's live working set.
# Row-partitionable plans whose leaves exceed this are lowered to
# per-chunk segments with streaming combine; env-overridable so CI can
# force chunking on toy data (`REPRO_CHUNK_MEM_BUDGET=65536`).
CHUNK_MEM_BUDGET = int(os.environ.get("REPRO_CHUNK_MEM_BUDGET",
                                      str(256 << 20)))

# One in-flight chunk's live set is roughly the raw slice, its
# row-preserving transforms inside the fused segment, and the partial
# accumulators — budget a fixed multiple of the raw slice bytes.
CHUNK_LIVE_FACTOR = 4

# Floor on the chunk row bucket: below this the per-chunk dispatch
# overhead swamps any memory win.
CHUNK_MIN_ROWS = 16

# Per-chunk control-program overhead on the streaming path: host slice +
# fingerprint + one warm-executable dispatch with a device sync.
CHUNK_DISPATCH_S = 30e-6


def leaf_row_bytes(n: Node) -> float:
    """Per-row payload bytes of a row-partitioned leaf, format-aware (a
    leaf the format rule would pin to BCOO charges its stored payload,
    as in the reference, whether or not sparse execution is enabled)."""
    from . import backend
    itemsize = np.dtype(n.dtype).itemsize
    cols = n.shape[1] if len(n.shape) > 1 else 1
    if backend.HAS_SPARSE and len(n.shape) == 2 \
            and backend.leaf_format(n) == backend.BCOO:
        nse_per_row = float(cols) * max(n.sparsity, 1e-6)
        return max(nse_per_row * (itemsize + 8), 1.0)  # data + 2×int32
    return float(cols) * itemsize


def chunk_rows(row_bytes: float) -> int:
    """Chunk row-count for a streaming pass: the largest power of two
    whose live working set (CHUNK_LIVE_FACTOR × slice bytes) fits in
    CHUNK_MEM_BUDGET. Independent of the total row count, so appending
    rows leaves existing chunk boundaries (and their cached partials)
    intact, and every full chunk shares one cached segment closure."""
    target = CHUNK_MEM_BUDGET / (CHUNK_LIVE_FACTOR * max(row_bytes, 1.0))
    c = 1 << max(int(target).bit_length() - 1, 0)
    return max(c, CHUNK_MIN_ROWS)


# ---------------------------------------------------------------------------
# Serving (repro_torch.serving): coalesced-dispatch cost and the adaptive
# batching-delay policy — padding waste traded against queue delay
# ---------------------------------------------------------------------------

def _serve_bucket(k: int) -> int:
    """Power-of-two vmap bucket for k coalesced requests. Mirrors
    `batching.bucket_size` (duplicated here because `batching` imports
    this module) — serving replays warm under exactly those buckets."""
    return 2 if k <= 2 else 1 << (k - 1).bit_length()


def serve_batch_cost_s(invariant: list[Node], variant: list[Node],
                       bucket: int) -> float:
    """Estimated seconds for ONE coalesced serving dispatch.

    Same cost structure as `batched_cost_s` — the `PARFOR_DISPATCH_S`
    control-program constant is paid once for the whole coalesced
    batch, the request-invariant prefix runs once, and every
    request-variant instruction does `bucket`× the per-request work.
    The padding waste is priced in: a batch of k requests padded to a
    `bucket` > k executes `bucket - k` wasted lanes, which is what the
    coalescer's delay policy weighs against queue time.
    """
    return batched_cost_s(invariant, variant, bucket)


def coalesce_gain_s(invariant: list[Node], variant: list[Node],
                    k: int, max_batch: int) -> float:
    """Seconds saved by absorbing ONE more request into a pending batch
    of k instead of letting it pay its own dispatch later.

    Three regimes:
      * k below the current bucket — the next request rides a padding
        lane that is already paid for: the full cost of a solo dispatch
        is saved;
      * k exactly on a bucket boundary — absorbing one more request
        doubles the vmap bucket, so the marginal batched work eats into
        the solo-dispatch saving;
      * k at `max_batch` — nothing to gain, dispatch now.
    """
    if k >= max_batch:
        return 0.0
    solo = serve_batch_cost_s(invariant, variant, _serve_bucket(1))
    b = _serve_bucket(k)
    if k < b:
        return solo
    marginal = (serve_batch_cost_s(invariant, variant, 2 * b)
                - serve_batch_cost_s(invariant, variant, b))
    return max(solo - marginal, 0.0)


def coalesce_wait_s(invariant: list[Node], variant: list[Node],
                    k: int, max_batch: int, max_wait_s: float) -> float:
    """Adaptive batching delay: how much LONGER a coalescer holding k
    queued requests should wait for the next arrival.

    Waiting dt seconds delays all k held requests (total queue-delay
    cost k·dt); absorbing the next arrival saves `coalesce_gain_s`.
    Break-even at dt = gain / k — the budget shrinks as the batch
    fills, so a nearly-full batch dispatches almost immediately while a
    lone request is willing to wait for company. Clamped to the
    operator-set `max_wait_s` policy ceiling (the p99 guard).
    """
    if k >= max_batch:
        return 0.0
    gain = coalesce_gain_s(invariant, variant, k, max_batch)
    return min(max_wait_s, gain / max(k, 1))


# ---------------------------------------------------------------------------
# Fault policy: bounded exponential backoff for the retry ladders (chunk
# IO here; site RPCs with the federated lane)
# ---------------------------------------------------------------------------

# Exponential-backoff base: sleep RETRY_BASE_S * 2^(attempt-1) before
# re-attempt k. Small — the local transport has no congestion to yield
# to; real deployments raise it via env.
RETRY_BASE_S = 0.01

# Bounded retries per IO read (re-attempts after the first try).
# Exhaustion hands over to the degradation ladder.
MAX_RETRIES = 2


def retry_base_s() -> float:
    return float(os.environ.get("REPRO_RETRY_BASE_S", RETRY_BASE_S))


def max_retries() -> int:
    return int(os.environ.get("REPRO_MAX_RETRIES", MAX_RETRIES))


def retry_backoff_s(attempt: int) -> float:
    """Backoff before re-attempt `attempt` (1-based): exponential in
    the attempt number, bounded by the caller's `max_retries` loop."""
    return retry_base_s() * (2.0 ** max(attempt - 1, 0))


def pipeline_depth() -> int:
    """Resolved dispatch depth for the runtime's segment executor.

    Only the synchronous lane (depth 1) is ported, so unset/0/1 all
    resolve to 1 — what the reference runs at ``REPRO_PIPELINE_DEPTH=1``.
    An explicit request for the asynchronous lane raises instead of
    being silently ignored. Read per plan run, like the reference."""
    env = int(os.environ.get("REPRO_PIPELINE_DEPTH", "0") or 0)
    if env >= 2:
        raise NotImplementedError(
            f"REPRO_PIPELINE_DEPTH={env}: the asynchronous pipelined lane "
            "(the streaming prefetch worker and the serving completion "
            "worker) is not ported yet (ROADMAP Queue 1 item 10); unset "
            "it or set it to 1")
    return 1


def should_chunk(n: Node) -> bool:
    """True when a leaf is worth streaming: a 2-D row-partitioned local
    leaf whose (format-aware) payload exceeds the memory budget."""
    if n.op != "input" or n.placement != "local" or len(n.shape) != 2:
        return False
    if n.attr("batch") is not None:
        return False
    rows = n.shape[0]
    payload = rows * leaf_row_bytes(n)
    return payload > CHUNK_MEM_BUDGET and rows > chunk_rows(
        leaf_row_bytes(n))


def _chunk_flops(n: Node) -> float:
    """Total flops of the underlying full-data computation of a chunk
    partial-aggregate op (chunking changes residency, not arithmetic)."""
    op = n.op
    out = _numel(n.shape)
    if op in ("chunk_gram", "chunk_xtv"):
        return 2.0 * out * n.inputs[0].shape[0]
    if op in ("chunk_colsums", "chunk_sum"):
        return float(max((_numel(i.shape) for i in n.inputs), default=out))
    return node_flops(n)


def chunk_cost_s(n: Node) -> float:
    """Estimated seconds for one chunked instruction: the base-op
    roofline over the full data plus the per-chunk dispatch overhead of
    the streaming loop. `combine` is a light accumulator handoff."""
    if n.op == "combine":
        return LIGHT_OP_BASE_S + _dense_bytes(n) / PEAK_BW
    rows = n.inputs[0].shape[0] if n.inputs and n.inputs[0].shape else 1
    c = chunk_rows(leaf_row_bytes(n.inputs[0])) if n.inputs else 1
    n_chunks = max(-(-rows // c), 1)
    base = HEAVY_OP_BASE_S if n.op in ("chunk_gram", "chunk_xtv") \
        else LIGHT_OP_BASE_S
    return base + n_chunks * CHUNK_DISPATCH_S + max(
        _chunk_flops(n) / PEAK_FLOPS, node_bytes(n) / PEAK_BW)


# ---------------------------------------------------------------------------
# Task-parallel batched execution (§5 parfor): vmap-vs-sequential
# arbitration for the config axis
# ---------------------------------------------------------------------------

# Control-program overhead per configuration on the sequential path: one
# plan compile + leaf binding + per-segment python dispatch with a device
# sync (the reference's calibration).
PARFOR_DISPATCH_S = 300e-6

# Memory ceiling for the vmapped config-variant suffix: every variant
# intermediate is materialized `bucket` times at once, so giants must
# fall back to the sequential loop instead of thrashing.
VMAP_MEM_BUDGET = 1 << 30


def _work_s(n: Node) -> float:
    """Roofline term of one HOP (est_cost_s minus the launch constant)."""
    return max(node_flops(n) / PEAK_FLOPS, node_bytes(n) / PEAK_BW)


def batched_cost_s(invariant: list[Node], variant: list[Node],
                   bucket: int) -> float:
    """Estimated seconds for one batched (vmapped) execution.

    The config-invariant prefix runs once at per-config size; every
    config-variant instruction pays its launch constant ONCE but does
    `bucket`× the per-config work (the batch axis is padded up to a
    power-of-two bucket, so the padding waste is part of the estimate —
    that is what lets a memory-bound giant lose to the sequential loop
    when the bucket overshoots k).
    """
    total = PARFOR_DISPATCH_S  # one plan dispatch for the whole grid
    for n in invariant:
        total += est_cost_s(n)
    for n in variant:
        base = HEAVY_OP_BASE_S if n.op in HEAVY_OPS else LIGHT_OP_BASE_S
        total += base + bucket * _work_s(n)
    return total


def sequential_cost_s(roots_list: list[list[Node]],
                      reuse_active: bool) -> float:
    """Estimated seconds for the sequential path over k configs.

    Walks every per-config DAG and sums per-node estimates,
    deduplicating across configs exactly where the sequential runtime
    would: with an active reuse cache, a repeated intermediate whose
    cost clears the probe threshold is served from the cache after its
    first computation. Value identity is the lineage hash with
    uid-based leaf identity — the same notion the cache keys on.
    """
    from .dag import _lhash_rec  # uid-keyed memo is shareable: uids are global
    seen: set[str] = set()
    memo: dict[int, str] = {}
    total = len(roots_list) * PARFOR_DISPATCH_S
    for roots in roots_list:
        order: list[Node] = []
        seen_uid: set[int] = set()

        def rec(n: Node) -> None:
            if n.uid in seen_uid:
                return
            seen_uid.add(n.uid)
            for i in n.inputs:
                rec(i)
            order.append(n)

        for r in roots:
            rec(r)
        for n in order:
            if n.op in ("input", "literal"):
                continue
            h = _lhash_rec(n, {}, memo)
            c = est_cost_s(n)
            if h in seen:
                if reuse_active and c >= PROBE_MIN_COST_S:
                    continue  # cache hit on the sequential path
            else:
                seen.add(h)
            total += c
    return total
