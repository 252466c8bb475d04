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
    and site-RPC retry ladders, `fed_timeout_s` the per-site timeout;
  * federated placement — `fed_cost_s` / `collect_cost_s` gate each
    `fed_*` lowering against collecting its operand
    (`repro_torch.core.compiler.lower_federated`);
  * the asynchronous pipeline — `pipeline_depth` (auto = 2, as in the
    reference) and `prefetch_depth` set how far the runtime runs ahead
    of the device;
  * sharded placement — `shard_cost_s` / `reshard_cost_s` gate each
    `lower_distributed` lowering against resharding its operands,
    `collective_bytes` is the runtime's shard meter, and
    `config_shard_cost_s` prices a parfor bucket sharded over the
    mesh's `config` axis.

Port of `repro.core.costmodel` for every lane of the DSL (local,
chunked, federated, sharded, the batched parfor lane, serving, the
pipeline and the fault policy). The constants, environment names and
formulas are the reference's, unchanged, so both packages compile
identical plans, choose the same parfor mode, resolve the same pipeline
depth and hold a request for the same window; they are NOT tuned for the
GPU (the sharded section's interconnect rate included: the port's
logical devices share one card).
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

# Federated placement calibration: effective master<->site link
# bandwidth and per-site round-trip latency. Deliberately below local
# memory bandwidth — moving bytes across the federation boundary is the
# dominant cost the placement pass must weigh (§3.3 "exchange
# constraints"), so collect decisions are cost-based, not syntactic.
NET_BW = 1e9          # bytes/s across the exchange boundary
FED_TRIP_S = 50e-6    # per-site round-trip launch latency

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
    if n.op == "collect" or n.op.startswith("fed_"):
        return fed_cost_s(n)
    if n.op.startswith("shard_") or n.op == "reshard" \
            or n.placement == "sharded":
        return shard_cost_s(n)
    if n.op.startswith("chunk_") or n.op == "combine":
        return chunk_cost_s(n)
    base = HEAVY_OP_BASE_S if n.op in HEAVY_OPS else LIGHT_OP_BASE_S
    return base + max(node_flops(n) / PEAK_FLOPS, node_bytes(n) / PEAK_BW)


def _dense_bytes(n: Node) -> float:
    return float(_numel(n.shape)) * np.dtype(n.dtype).itemsize


# ---------------------------------------------------------------------------
# Federated placement costs (§3.3): exchange bytes as a first-class term
# ---------------------------------------------------------------------------

def fed_exchange_bytes(n: Node) -> tuple[float, float]:
    """(bytes master->sites, bytes sites->master) for one `fed_*` /
    `collect` instruction — the compile-time estimate of what the
    runtime's `ExchangeLog` will meter."""
    sites = int(n.attr("n_sites", 1) or 1)
    op = n.op
    out_b = _dense_bytes(n)
    if op == "collect":
        return 0.0, _dense_bytes(n.inputs[0])
    if op == "fed_gram":
        return 0.0, sites * out_b
    if op in ("fed_xtv", "fed_vm"):
        fed_args = set(n.attr("fed_args", (0,)))
        sent = sum(_dense_bytes(i) for pos, i in enumerate(n.inputs)
                   if pos not in fed_args)  # row-aligned operands, sliced
        return sent, sites * out_b
    if op == "fed_mv":
        w = n.inputs[1]
        return sites * _dense_bytes(w), out_b  # broadcast w, rbind result
    if op == "fed_colsums":
        return 0.0, sites * out_b
    if op == "fed_map":
        # fed_args/gen_args index the *inner argument list*; n.inputs is
        # that list with generated operands removed — walk the inner
        # positions and advance through inputs exactly like the runtime
        # executor does, so this estimate matches what ExchangeLog meters
        fed_args = set(n.attr("fed_args", ()))
        gens = {g[0] for g in n.attr("gen_args", ())}
        sent = 0.0
        inputs = iter(n.inputs)
        for pos in range(int(n.attr("n_args", len(n.inputs)))):
            if pos in gens:
                continue  # generated on site — never sent
            i = next(inputs)
            if pos in fed_args or i.shape == ():
                continue  # on-site already / scalar constant
            b = _dense_bytes(i)
            sent += sites * b if i.shape[0] == 1 else b  # broadcast : slice
        return sent, 0.0  # output stays federated — nothing comes back
    return 0.0, 0.0


def _fed_flops(n: Node) -> float:
    """Total across sites of the per-site local work."""
    op = n.op
    out = _numel(n.shape)
    if op == "fed_gram":
        return 2.0 * out * n.inputs[0].shape[0]
    if op in ("fed_xtv", "fed_vm"):
        m = max(i.shape[0] for i in n.inputs)
        return 2.0 * out * m
    if op == "fed_mv":
        return 2.0 * out * n.inputs[0].shape[1]
    if op in ("fed_colsums", "fed_map"):
        return float(max((_numel(i.shape) for i in n.inputs), default=out))
    return 0.0  # collect: pure data movement


def fed_cost_s(n: Node) -> float:
    """Estimated seconds for a federated instruction: per-site launch
    round trips + exchange bytes over the federation link + the per-site
    local compute (sites work in parallel)."""
    sites = int(n.attr("n_sites", 1) or 1)
    to_b, from_b = fed_exchange_bytes(n)
    compute = _fed_flops(n) / sites / PEAK_FLOPS
    return sites * FED_TRIP_S + (to_b + from_b) / NET_BW + compute


def collect_cost_s(fed_value: Node, n_sites: int) -> float:
    """Cost of materializing a federated value at the master — the
    explicit boundary the placement pass inserts for non-lowerable
    consumers, and the baseline every `fed_*` lowering must beat."""
    return n_sites * FED_TRIP_S + _dense_bytes(fed_value) / NET_BW


# ---------------------------------------------------------------------------
# Sharded placement costs: collectives over the device mesh as
# first-class terms, weighed against the roofline `est_cost_s`
# ---------------------------------------------------------------------------

# Per-hop device-interconnect bandwidth (the reference's value, kept so
# plans stay identical). Well above the federation link (NET_BW) and
# below local memory bandwidth — collectives are cheap but not free,
# which is what makes small outputs shard and huge ones pay.
ICI_BW = 1e10          # bytes/s per link

# Sharded segment dispatch overhead: device-collective setup costs more
# than a plain launch, so tiny plans must not shard.
SHARD_LAUNCH_S = 50e-6

# Leaves below this dense footprint are never worth row-sharding: the
# dispatch overhead alone beats any per-shard compute win.
SHARD_MIN_LEAF_BYTES = 1 << 20


def allreduce_bytes(n: Node, d: int) -> int:
    """Total bytes crossing device links for a ring all-reduce of this
    node's output over a `d`-device axis: 2·B·(d-1). The compile-time
    estimate behind the runtime's `ShardLog.collective_bytes` meter."""
    return int(2.0 * _dense_bytes(n) * max(d - 1, 0))


def allgather_bytes(n: Node, d: int) -> int:
    """Total link bytes to all-gather a value to global size B on every
    device: B·(d-1) — the `reshard` boundary's meter estimate."""
    return int(_dense_bytes(n) * max(d - 1, 0))


def collective_bytes(n: Node) -> int:
    """Estimated link bytes one sharded instruction moves (0 for
    row-preserving sharded ops — they need no collective at all)."""
    d = int(n.attr("n_dev", 1) or 1)
    if n.op == "reshard":
        return allgather_bytes(n, d)
    if n.op.startswith("shard_"):
        return allreduce_bytes(n, d)
    return 0


def _shard_flops(n: Node) -> float:
    """Total flops of the underlying computation of a shard op (the
    per-device share is this / n_dev — shards work in parallel)."""
    op = n.op
    out = _numel(n.shape)
    if op in ("shard_gram", "shard_xtv"):
        return 2.0 * out * n.inputs[0].shape[0]
    if op in ("shard_colsums", "shard_sum"):
        return float(max((_numel(i.shape) for i in n.inputs), default=out))
    return node_flops(n)  # row-preserving sharded ops keep their base op


def shard_cost_s(n: Node) -> float:
    """Estimated seconds for one sharded instruction: sharded launch +
    the per-device roofline share + the collective (ring time over `d`
    parallel links)."""
    d = int(n.attr("n_dev", 1) or 1)
    if n.op == "reshard":
        return SHARD_LAUNCH_S + allgather_bytes(n, d) / (d * ICI_BW)
    compute = max(_shard_flops(n) / d / PEAK_FLOPS,
                  node_bytes(n) / d / PEAK_BW)
    coll = collective_bytes(n) / (d * ICI_BW)
    base = SHARD_LAUNCH_S if n.op.startswith("shard_") else LIGHT_OP_BASE_S
    return base + compute + coll


def reshard_cost_s(x: Node, d: int) -> float:
    """Cost of materializing a row-sharded value as a replicated local
    one (the all-gather) — the boundary `lower_distributed` inserts for
    non-lowerable consumers, and the baseline every sharded lowering
    must beat (the shard-level analogue of `collect_cost_s`)."""
    return SHARD_LAUNCH_S + _dense_bytes(x) * max(d - 1, 0) / (d * ICI_BW)


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
# Asynchronous pipelined dispatch: how deep the runtime may run ahead of
# the device
# ---------------------------------------------------------------------------

# Spawning/joining a prefetch worker and keeping a second bucket live
# costs roughly one chunk dispatch of control-program overhead; below
# that, pipelining is pure tax.
PIPELINE_MIN_GAIN_S = CHUNK_DISPATCH_S


def pipeline_depth() -> int:
    """Resolved async-dispatch depth for the runtime's segment executor.

    ``REPRO_PIPELINE_DEPTH`` is the deployment surface: ``1`` forces the
    fully synchronous lane (every dispatch waits for the device),
    ``>=2`` forces async dispatch with that much chunk-prefetch
    lookahead. Unset/0 means auto, which resolves to 2, as in the
    reference: deferring the device sync to plan roots costs nothing in
    the worst case, so only an explicit operator override pins the
    runtime to the blocking path.

    Read per plan run, not at import, so one process can compare both
    modes."""
    env = int(os.environ.get("REPRO_PIPELINE_DEPTH", "0") or 0)
    if env >= 1:
        return env
    return 2


def pipeline_gain_s(row_bytes: float) -> float:
    """Estimated host-prep seconds per streaming bucket that depth>=2
    prefetch can overlap with device compute: slicing + block-checksum
    traffic of one bucket at memory bandwidth (the prep is bandwidth-
    bound — two passes over the slice payload)."""
    return 2.0 * chunk_rows(row_bytes) * max(row_bytes, 1.0) / PEAK_BW


def prefetch_depth(row_bytes: float, n_chunks: int) -> int:
    """Chunk-prefetch lookahead for one streaming scope.

    An explicit ``REPRO_PIPELINE_DEPTH`` wins (capped at the chunk
    count). In auto mode the gate is economic: prefetch only when there
    is more than one bucket AND the overlappable host prep per bucket
    clears the control-program cost of running the worker at all
    (`PIPELINE_MIN_GAIN_S`). Depth 1 is always the fallback and means
    the exact synchronous loop."""
    env = int(os.environ.get("REPRO_PIPELINE_DEPTH", "0") or 0)
    if env >= 1:
        return max(1, min(env, n_chunks))
    if n_chunks < 2 or pipeline_gain_s(row_bytes) <= PIPELINE_MIN_GAIN_S:
        return 1
    return min(2, n_chunks)


# ---------------------------------------------------------------------------
# Fault policy: per-site timeouts + bounded exponential backoff for the
# retry ladders (chunk IO, site RPCs)
# ---------------------------------------------------------------------------

# Per-site RPC timeout. Generous by default — a first call includes the
# per-site closure build, and a clean run must never trip the ladder.
# In-process sites cannot be preempted, so the timeout binds at the
# attempt boundary: a late result is discarded, counted, and the call
# retried.
FED_TIMEOUT_S = 30.0

# Exponential-backoff base: sleep RETRY_BASE_S * 2^(attempt-1) before
# re-attempt k. Small — the local transport has no congestion to yield
# to; real deployments raise it via env.
RETRY_BASE_S = 0.01

# Bounded retries per site call / IO read (re-attempts after the first
# try). Exhaustion hands over to the degradation ladder.
MAX_RETRIES = 2


def fed_timeout_s() -> float:
    """Per-site RPC timeout (env ``REPRO_FED_TIMEOUT_S``), read per
    call like the pipeline knobs so one process can compare policies."""
    return float(os.environ.get("REPRO_FED_TIMEOUT_S", FED_TIMEOUT_S))


def retry_base_s() -> float:
    return float(os.environ.get("REPRO_RETRY_BASE_S", RETRY_BASE_S))


def max_retries() -> int:
    return int(os.environ.get("REPRO_MAX_RETRIES", MAX_RETRIES))


def retry_backoff_s(attempt: int) -> float:
    """Backoff before re-attempt `attempt` (1-based): exponential in
    the attempt number, bounded by the caller's `max_retries` loop."""
    return retry_base_s() * (2.0 ** max(attempt - 1, 0))


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


def config_shard_cost_s(invariant: list[Node], variant: list[Node],
                        bucket: int, c: int) -> float:
    """Estimated seconds for the batched grid with the bucket axis
    sharded over the mesh's `config` axis (`c` devices): the invariant
    prefix still runs once replicated, each variant instruction pays a
    sharded launch but only `bucket / c` of the per-config work."""
    total = PARFOR_DISPATCH_S
    for n in invariant:
        total += est_cost_s(n)
    per_dev = max(bucket // max(c, 1), 1)
    for n in variant:
        base = HEAVY_OP_BASE_S if n.op in HEAVY_OPS else LIGHT_OP_BASE_S
        total += base + SHARD_LAUNCH_S + per_dev * _work_s(n)
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
