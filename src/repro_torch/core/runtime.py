"""LineageRuntime: the control program (SystemDS §3.2 Fig. 3-3).

Port of `repro.core.runtime`. Interprets compiled plans instruction by
instruction (`fuse=False`) or segment by segment (`fuse=True`),
maintains the intermediate environment (buffer pool with liveness-based
frees), traces lineage for every executed operation, and probes/populates
the lineage reuse cache (§4.1). Chunked plans stream their oversized
leaves through the device one row bucket at a time.

Device: a runtime computes on one torch device, `cuda` unless the caller
asks for another (`LineageRuntime(device="cpu")`, as the tests do). It
never falls back to the CPU: without a GPU, the default raises. Bound
leaves stay host numpy arrays (as in the reference) and are uploaded at
dispatch; results come back as numpy arrays.

Asynchronous pipeline (`costmodel.pipeline_depth()`, 2 unless
``REPRO_PIPELINE_DEPTH`` says otherwise, as in the reference): at depth
>= 2 a segment dispatch returns as soon as its kernels are queued on the
device (no `backend.synchronize`); the host waits only at the plan's
roots, at a host op (which reads its operands) and where a streamed
bucket's partials are read back, and that wait is metered as
`PipelineLog.block_s`. Dead intermediates this run produced are donated
(`_donation_mask`, defined in `PipelineLog`), and a streamed segment
runs double-buffered (`_run_chunked_pipelined`). Depth 1 is the
synchronous lane: every dispatch waits for the device, and nothing of
the pipeline is metered. Both depths run the same closures on the same
operands and add the streamed partials on the host in bucket order, so
their results are the same bits.

Sparse lane (`sparse_inputs=True`): leaves the compiler pins to `bcoo`
are sparsified on the host at every bind (`backend.sparsify`) and
uploaded as `BCOO` values; each closure's kernels are selected from the
plan's formats, segment keys carry the boundary formats, and a reuse hit
is coerced to the format the plan assigned. The streaming lane charges a
bcoo leaf its sparse bytes per row and sparsifies each bucket it uploads.

Federated plans (§3.3) execute here too: `fed_*` instructions emitted by
the compiler's placement pass loop over the bound `FederatedTensor`'s
sites, run each site's local work as a cached closure
(`LocalSite.execute`: the same kernels, so a site's gram is one launch
of the hand-written gram kernel on its partition), and meter every byte
crossing the federation boundary into `stats.exchange` — per site,
identically across fuse modes and pipeline depths. Site calls go through
the fault policy's ladder (`_site_call`: per-site timeout, bounded
retries, then recompute of a dead site's work on the master from its
surviving data through the same closure, so a degraded run is bitwise
the clean one), and their latencies and heartbeats through the
StepMonitor (`stats.faults`).

Batched lane (`evaluate_batch`, the §5 `parfor`): a `BatchedPlan`
(`repro_torch.core.batching`) runs its config-invariant prefix once
through the ordinary segment machinery and each config-variant segment
as one `torch.func.vmap` closure over the padded bucket axis (cached
under a `|vmap:{axes}` key; gram and xtv inside are one batched launch
each); a host op (`quantile`) in the variant suffix loops over the true
configs on the host and is padded back into the bucket, and a federated
instruction sends its batched operands to each site in one payload.

Serving lane (`replay_batch`, behind `repro_torch.serving.ModelServer`):
a serving `BatchedPlan` (`PreparedScript.prepare_batched`) replays k
stacked requests through the same vmapped closures, padded to a
power-of-two bucket; request leaves are bound per call, never through
the global leaf registry, and reuse probes key on the request content.

Fault policy (`repro_torch.core.faults`, metered in `stats.faults`): a
segment whose closure build fails (`CompileFailedError`) runs its
instructions through the `fuse=False` interpreter's kernels and counts
one degradation; vmapped segments re-raise, as in the reference. A
prefetch worker that dies mid-stream (`chunk_io` at `chunk_prefetch`)
costs the pipeline, never the answer: the stream finishes on the
synchronous loop.

Sharded lane (a plan compiled under a `MeshSpec` with ``data > 1``, see
`repro_torch.distributed.mesh`): the run resolves the plan's mesh once
against this runtime's device. Where it resolves, each sharded segment
runs as one closure over the mesh's logical devices in lockstep
(`segments.build_sharded_segment_fn`: per-shard kernels — on the card the
hand-written gram/xtv, one launch per shard — and fixed-order sums), is
keyed by mesh shape and specs (`jit_cache.mesh_key_tag`) and is metered
into `stats.shard` from the compile-time collective formulas; where it
does not (fewer devices than the mesh), the segment runs its
local-equivalent `|unshard` closure and meters nothing. A parfor plan in
`mode="shard"` splits its vmapped bucket axis over the mesh's `config`
axis the same way (`build_config_sharded_segment_fn`), or runs plain
vmap where the mesh does not resolve or the bucket does not divide.
Sharded segments are never donated, never deferred into the pipeline's
ownership set, and a failed build re-raises (no eager equivalent of the
same closure), as in the reference.

`PreparedScript` is the JMLC analogue: trace a python function once into
a DAG with placeholder leaves, then re-execute with new in-memory inputs
(plan compiled once; lineage recomputed per input so reuse stays sound).
"""
from __future__ import annotations

import hashlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from . import backend, costmodel, faults
from .compiler import Plan, compile_plan
from .dag import (LEAVES, LTensor, Node, _fingerprint, _lhash_rec,
                  _slice_fingerprint, input_tensor)
from .faults import CompileFailedError, FaultLog, SiteFailedError
from .federated import ExchangeLog, FederatedTensor, LocalSite
from .jit_cache import get_jit_cache
from .reuse import ReuseCache
from .reuse import nbytes as _reuse_nbytes


@dataclass
class ShardLog:
    """Shard-level analogue of the federation's `ExchangeLog`: counts
    sharded segment dispatches and the collectives they carry. Bytes come
    from the compile-time cost-model formulas (ring all-reduce /
    all-gather total link bytes over the `data` axis), so the meter is
    deterministic and auditable against exactly the exchanges the
    compiler priced when it accepted each lowering."""

    sharded_segments: int = 0         # sharded segment dispatches
    config_sharded_segments: int = 0  # bucket-axis (config) dispatches
    reshards: int = 0                 # reshard (gather) boundaries run
    collectives: int = 0              # summing shard_* reduces run
    collective_bytes: int = 0         # total link bytes (cost-model est.)

    @property
    def total(self) -> int:
        return (self.sharded_segments + self.config_sharded_segments
                + self.reshards + self.collectives)

    def as_dict(self) -> dict:
        return dict(sharded_segments=self.sharded_segments,
                    config_sharded_segments=self.config_sharded_segments,
                    reshards=self.reshards,
                    collectives=self.collectives,
                    collective_bytes=self.collective_bytes)


@dataclass
class StreamLog:
    """Out-of-core streaming meter (chunked segments): row buckets
    dispatched vs served from the chunk-level lineage cache, payload
    bytes moved through device memory, and the high-water mark of
    resident state (one live chunk's inputs plus the running partial
    aggregates)."""

    chunked_segments: int = 0  # streaming scopes entered (per run)
    chunks: int = 0            # row-bucket executions dispatched
    chunks_reused: int = 0     # buckets served from chunk-level lineage
    combines: int = 0          # partial-aggregate accumulations
    bytes_streamed: int = 0    # input payload bytes moved per dispatch
    peak_live_bytes: int = 0   # max resident: live chunk + accumulators
    full_hits: int = 0         # whole-stream reuse short-circuits
    # host-clock seconds of each step of the bucket loop; port-only, kept
    # out of `as_dict` so the counters compare with the reference's
    fingerprint_s: float = 0.0  # content fingerprints (reuse keys)
    upload_s: float = 0.0       # bucket slices (sparsified for a bcoo
                                # leaf) copied host -> device
    dispatch_s: float = 0.0     # segment closure on a bucket, device synced
    download_s: float = 0.0     # partials device -> host numpy
    combine_s: float = 0.0      # host adds of the partials

    @property
    def total(self) -> int:
        return (self.chunked_segments + self.chunks + self.chunks_reused
                + self.full_hits)

    def as_dict(self) -> dict:
        return dict(chunked_segments=self.chunked_segments,
                    chunks=self.chunks,
                    chunks_reused=self.chunks_reused,
                    combines=self.combines,
                    bytes_streamed=self.bytes_streamed,
                    peak_live_bytes=self.peak_live_bytes,
                    full_hits=self.full_hits)

    def spans(self) -> dict:
        """Where the bucket loop's host time went, in seconds."""
        return dict(fingerprint_s=self.fingerprint_s,
                    upload_s=self.upload_s, dispatch_s=self.dispatch_s,
                    download_s=self.download_s, combine_s=self.combine_s)


@dataclass
class ServingLog:
    """Observability of the `repro_torch.serving` request path:
    queue/coalesce behaviour and the warm-path hygiene counter. Updated
    by the `ModelServer` owning this runtime — all mutation happens on
    the one thread that replays batches (the dispatcher at pipeline depth
    1, the completion worker at depth >= 2) and, for `rejected` /
    `queue_peak`, under its queue lock."""

    requests: int = 0        # requests scored (excludes rejections)
    batches: int = 0         # coalesced dispatches
    max_coalesce: int = 0    # largest coalesced batch observed
    padded: int = 0          # padding lanes executed (bucket - k waste)
    queue_peak: int = 0      # deepest queue observed at enqueue time
    rejected: int = 0        # bounded-queue rejections (backpressure)
    # closure-cache misses taken by a dispatch AFTER deploy-time warmup.
    # The deploy contract is build-off-the-request-path: this MUST stay 0
    # in steady state
    retraces: int = 0
    queue_wait_s: float = 0.0  # total enqueue->dispatch delay
    busy_s: float = 0.0        # seconds the dispatch stage spent replaying

    @property
    def total(self) -> int:
        return self.requests + self.rejected

    def as_dict(self) -> dict:
        out = dict(requests=self.requests, batches=self.batches,
                   max_coalesce=self.max_coalesce, padded=self.padded,
                   queue_peak=self.queue_peak, rejected=self.rejected,
                   retraces=self.retraces,
                   queue_wait_s=round(self.queue_wait_s, 6),
                   busy_s=round(self.busy_s, 6))
        if self.batches:
            out["mean_coalesce"] = round(self.requests / self.batches, 2)
        return out


@dataclass
class PipelineLog:
    """Asynchronous-dispatch meter (pipeline depth >= 2).

    At depth >= 2 the segment executor stops waiting for the device at
    segment boundaries: `dispatch_s` is host time spent *issuing*
    segment closures (their kernels run behind), `block_s` is host time
    actually blocked on the device — reading results back at plan roots,
    reading a streamed bucket's partials back — and `prefetch_s` is
    worker time spent prepping streaming buckets concurrently with
    device compute. Every counter stays 0 at depth 1
    (`REPRO_PIPELINE_DEPTH=1`), so the depth-1 `as_dict()` carries no
    `pipeline` section, as in the reference.

    *Donation.* PyTorch has no `donate_argnums`; a donated buffer here
    is a reference the runtime gives up. At depth >= 2, for each
    argument position in `LineageRuntime._donation_mask` (an input this
    segment reads last, produced by a closure this run and referenced by
    no reuse-cache entry), the runtime drops its own reference before
    the closure runs and the donating closure drops its reference right
    after the kernel that reads it last, so the caching allocator can
    hand that block to a later output of the same segment.
    `donated_buffers` and `donated_bytes` count those positions and
    their bytes — on the same plan, the reference's counts. Leaves,
    reuse-cache entries, bcoo values and the batched and serving
    dispatches are never donated.
    """

    async_segments: int = 0   # dispatches returned without a device sync
    dispatch_s: float = 0.0   # host seconds issuing async dispatches
    block_s: float = 0.0      # host seconds blocked on the device
    prefetch_s: float = 0.0   # worker seconds prepping buckets (overlapped)
    prefetch_issued: int = 0  # bucket preps handed to the worker
    prefetch_hits: int = 0    # prepped buckets consumed by a dispatch
    prefetch_cancelled: int = 0  # prepped buckets discarded (error
                                 # shutdown before the worker took them)
    donated_buffers: int = 0  # dead intermediates donated (see above)
    donated_bytes: int = 0    # their payload bytes
    rebatches: int = 0        # serving batches coalesced while another
                              # batch was still in flight

    @property
    def total(self) -> int:
        return (self.async_segments + self.prefetch_issued
                + self.donated_buffers + self.rebatches)

    def as_dict(self) -> dict:
        out = dict(async_segments=self.async_segments,
                   dispatch_s=round(self.dispatch_s, 6),
                   block_s=round(self.block_s, 6),
                   prefetch_s=round(self.prefetch_s, 6),
                   prefetch_issued=self.prefetch_issued,
                   prefetch_hits=self.prefetch_hits,
                   prefetch_cancelled=self.prefetch_cancelled,
                   donated_buffers=self.donated_buffers,
                   donated_bytes=self.donated_bytes,
                   rebatches=self.rebatches)
        # share of pipeline host time spent on overlappable work (issuing
        # dispatches, prepping buckets) vs blocked on the device; 1.0
        # means the host never waited
        busy = self.dispatch_s + self.prefetch_s
        wall = busy + self.block_s
        out["overlap_ratio"] = round(busy / wall, 4) if wall > 0 else 0.0
        return out


@dataclass
class RuntimeStats:
    instructions: int = 0
    executed: int = 0      # instructions actually computed (not reused)
    reused: int = 0
    exec_time: float = 0.0
    segments: int = 0        # segments dispatched on the fused path
    batched_segments: int = 0  # vmapped config-variant segments (parfor)
    jit_cache_hits: int = 0  # warm cached-closure lookups
    trace_time: float = 0.0  # seconds spent building segment closures
    # bytes crossing the federation boundary (fed_* / collect
    # instructions), metered per site; identical across fuse modes
    exchange: ExchangeLog = field(default_factory=ExchangeLog)
    # request-path meter, populated when this runtime backs a
    # `repro_torch.serving.ModelServer`
    serving: ServingLog = field(default_factory=ServingLog)
    # out-of-core streaming meter, populated by chunked plans
    streaming: StreamLog = field(default_factory=StreamLog)
    # async-dispatch meter (deferred sync / donation / prefetch /
    # rebatching), populated only at pipeline depth >= 2
    pipeline: PipelineLog = field(default_factory=PipelineLog)
    # mesh-lowered execution meter (reshards / collective bytes) — the
    # shard-level analogue of `exchange`
    shard: ShardLog = field(default_factory=ShardLog)
    # fault-policy meter (`repro_torch.core.faults`): injections
    # observed, retries, timeouts, degradations, serving sheds and
    # restarts, plus the per-site / per-dispatch latency monitors and
    # the site heartbeats
    faults: FaultLog = field(default_factory=FaultLog)

    def as_dict(self):
        """The reference's keys; each meter appears only when non-zero,
        as there."""
        out = dict(instructions=self.instructions, executed=self.executed,
                   reused=self.reused, exec_time_s=round(self.exec_time, 6),
                   segments=self.segments,
                   batched_segments=self.batched_segments,
                   jit_cache_hits=self.jit_cache_hits,
                   trace_time_s=round(self.trace_time, 6))
        if self.exchange.total:
            out["exchange"] = self.exchange.as_dict()
        if self.serving.total:
            out["serving"] = self.serving.as_dict()
        if self.shard.total:
            out["shard"] = self.shard.as_dict()
        if self.streaming.total:
            out["streaming"] = self.streaming.as_dict()
        if self.pipeline.total:
            out["pipeline"] = self.pipeline.as_dict()
        if self.faults.total:
            out["faults"] = self.faults.as_dict()
        out["jit_cache"] = get_jit_cache().stats.as_dict()
        return out


@dataclass
class _RunCtx:
    """Per-run execution context of the async pipeline.

    `depth` is the resolved `costmodel.pipeline_depth()` for this run (1
    = the synchronous lane; every gate in the executor keys off it).
    `owned` tracks uids whose CURRENT value is a tensor produced by a
    segment closure *this run* and referenced nowhere the runtime cannot
    see — the run-time half of the donation decision: a uid is donatable
    only while it is here, and leaves it the moment the reuse cache
    takes a reference (`put`). Leaf values, cache hits, host-path and
    streamed outputs are never admitted. Kept per run (not on the
    runtime) so concurrent `run_plan` calls on one runtime cannot alias
    each other's ownership."""

    depth: int = 1
    owned: set = field(default_factory=set)


@dataclass
class _BatchCtx:
    """Execution context of a batched (`parfor`) plan: which value uids
    carry the leading config axis, and how wide the padded axis is."""

    bplan: Any                 # repro_torch.core.batching.BatchedPlan
    batch: int                 # true number of configurations (k)
    bucket: int                # padded batch width (power-of-two)
    bvals: frozenset           # uids with a leading batch axis
    cshard: int = 1            # bucket-axis shards (mesh `config` axis);
                               # 1 = plain vmap, >1 = split over it


def _pad_axis0(t: torch.Tensor, bucket: int) -> torch.Tensor:
    """Re-pad a true-k host-op or federated result back to the bucket
    width (repeating the last config, like `batching.pad_batch`) so it
    slots into the downstream vmapped closures built for the bucket."""
    pad = bucket - t.shape[0]
    if pad <= 0:
        return t
    return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])


# ---------------------------------------------------------------------------
# Bucket staging for the pipelined streaming lane (CUDA only; on the CPU
# an upload is `backend.to_device` and a read-back `backend.to_numpy`)
# ---------------------------------------------------------------------------

# (device index) -> (upload stream, download stream)
_COPY_STREAMS: dict[int, tuple] = {}


def _copy_streams(device: torch.device):
    key = device.index
    got = _COPY_STREAMS.get(key)
    if got is None:
        got = _COPY_STREAMS[key] = (torch.cuda.Stream(device),
                                    torch.cuda.Stream(device))
    return got


def _pinned(a) -> Any:
    """A host bucket slice (numpy array or CPU `BCOO`) copied into page-
    locked memory, the only source a host-to-device copy can overlap
    compute from (a copy from pageable memory blocks the host). Runs on
    the prefetch worker: host memory only, no stream work."""
    if isinstance(a, backend.SparseMatrix):
        return backend.SparseMatrix(
            a.data.pin_memory(), a.indices.pin_memory(), a.shape,
            a.indices_sorted, a.unique_indices)
    return backend.to_device(a, torch.device("cpu")).pin_memory()


def _upload_async(a, device: torch.device, up, compute):
    """Copy a pinned bucket slice to `device` on the upload stream `up`;
    the compute stream waits for the copy, and the tensor is marked as
    used there, so the caching allocator does not hand its block out
    again while a kernel still reads it."""
    with torch.cuda.stream(up):
        if isinstance(a, backend.SparseMatrix):
            t = backend.SparseMatrix(
                a.data.to(device, non_blocking=True),
                a.indices.to(device, non_blocking=True), a.shape,
                a.indices_sorted, a.unique_indices)
            bufs = (t.data, t.indices)
        else:
            t = a.to(device, non_blocking=True)
            bufs = (t,)
    compute.wait_stream(up)
    for b in bufs:
        b.record_stream(compute)
    return t


def _download_async(outs, down, compute):
    """Queue the copy of a bucket's partials into page-locked host
    memory on the download stream `down`, behind the bucket's kernels
    (an event on the compute stream), so the host reads them while the
    next bucket computes. Returns (host tensors, the copy's event)."""
    outs = [backend.densify(o) for o in outs]
    ready = torch.cuda.Event()
    ready.record(compute)
    hs = []
    with torch.cuda.stream(down):
        down.wait_event(ready)
        for o in outs:
            h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            h.copy_(o, non_blocking=True)
            o.record_stream(down)
            hs.append(h)
        done = torch.cuda.Event()
        done.record(down)
    return hs, done


def _host_parts(hs) -> tuple:
    """numpy views of downloaded partials (bf16 through `to_numpy`)."""
    return tuple(backend.to_numpy(h) if h.dtype == torch.bfloat16
                 else h.numpy() for h in hs)


class LineageRuntime:
    """Executes plans with lineage tracing and optional reuse."""

    def __init__(self, cache: Optional[ReuseCache] = None,
                 opt_level: int = 2, sparse_inputs: bool = False,
                 fuse: bool = True, device=None):
        # sparse_inputs: allow the BCOO physical representation (off by
        # default, as in the reference)
        self.cache = cache
        self.opt_level = opt_level
        self.sparse_inputs = sparse_inputs
        self.fuse = fuse
        self.device = backend.resolve_device(device)
        self.stats = RuntimeStats()

    # ------------------------------------------------------------------
    def evaluate(self, outputs: Sequence[LTensor]) -> list[np.ndarray]:
        plan = compile_plan(list(outputs),
                            reuse_enabled=self.cache is not None,
                            opt_level=self.opt_level)
        return self.run_plan(plan)

    # ------------------------------------------------------------------
    def run_plan(self, plan: Plan,
                 leaf_values: Optional[dict[int, Any]] = None,
                 leaf_lineage: Optional[dict[int, str]] = None
                 ) -> list[np.ndarray]:
        values, lin = self._bind_leaves(plan, leaf_values, leaf_lineage)
        if self.fuse:
            rctx = _RunCtx(depth=costmodel.pipeline_depth())
            self._run_segments(plan, values, lin, rctx=rctx)
            if rctx.depth >= 2:
                # plan roots are THE sync point of the async pipeline:
                # segment dispatches above returned without waiting, so
                # the device backlog drains here, metered
                t0 = time.perf_counter()
                outs = [backend.to_numpy(values[i])
                        for i in plan.output_ids]
                self.stats.pipeline.block_s += time.perf_counter() - t0
                return outs
        else:
            self._run_instructions(plan, values, lin)
        return [backend.to_numpy(values[i]) for i in plan.output_ids]

    # ------------------------------------------------------------------
    def evaluate_batch(self, bplan) -> list[list[np.ndarray]]:
        """Execute a `BatchedPlan` (see `repro_torch.core.batching`): the
        config-invariant prefix runs once through the ordinary segment
        machinery (same closures, same reuse probes as single-config
        plans), config-variant segments run vmapped over the padded
        batch axis. Returns one output list per configuration, in grid
        order, padding sliced off.

        Batched execution is inherently fused — the vmapped suffix IS a
        segment closure — so this path is used regardless of
        `self.fuse` (the interpreter equivalent of a batched plan is the
        sequential per-config loop, which `parfor` falls back to)."""
        from .batching import pad_batch
        plan = bplan.plan
        bctx = _BatchCtx(bplan=bplan, batch=bplan.batch,
                         bucket=bplan.bucket,
                         bvals=bplan.batched_value_uids)
        ms = plan.mesh_spec
        if bplan.mode == "shard" and ms is not None:
            # shard the bucket axis over the mesh's `config` axis;
            # gracefully degrade to plain vmap when the mesh cannot be
            # realized (too few devices) or the bucket does not divide
            if (ms.config > 1 and ms.resolve() is not None
                    and bplan.bucket % ms.config == 0):
                bctx.cshard = ms.config
        leaf_values = {
            uid: pad_batch(np.asarray(LEAVES.values[uid]), bplan.bucket)
            for uid in bplan.batched_leaf_uids}
        values, lin = self._bind_leaves(plan, leaf_values, None)
        rctx = _RunCtx(depth=costmodel.pipeline_depth())
        self._run_segments(plan, values, lin, bctx=bctx, rctx=rctx)
        return self._unpack_batch(plan, values, bctx, rctx=rctx)

    def _unpack_batch(self, plan: Plan, values: dict[int, Any],
                      bctx: _BatchCtx, rctx: Optional[_RunCtx] = None
                      ) -> list[list[np.ndarray]]:
        """Split a batched run's outputs into one list per config, in
        order, with the bucket padding sliced off. At pipeline depth
        >= 2 this is the batched path's sync point: the invariant prefix
        and the vmapped suffix were dispatched without waiting, and the
        device backlog drains here, metered as `block_s`."""
        t0 = time.perf_counter()
        k = bctx.batch
        per_config: list[list[np.ndarray]] = [[] for _ in range(k)]
        for uid in plan.output_ids:
            arr = backend.to_numpy(values[uid])
            if uid in bctx.bvals:
                for j in range(k):
                    per_config[j].append(arr[j])
            else:
                # config-invariant output: every config gets its own
                # copy, matching the sequential path's independent
                # arrays (callers may mutate results in place)
                for j in range(k):
                    per_config[j].append(arr if j == 0 else arr.copy())
        if rctx is not None and rctx.depth >= 2:
            self.stats.pipeline.block_s += time.perf_counter() - t0
        return per_config

    # ------------------------------------------------------------------
    def replay_batch(self, bplan, stacked: Sequence[Any],
                     k: int) -> list[list[np.ndarray]]:
        """Replay a serving `BatchedPlan` (see `batching.compile_serving`)
        on k stacked request bindings — the low-latency scoring entry.

        `stacked` holds one ``(k,) + arg_shape`` array per argument,
        aligned with `bplan.leaf_order`. The batch is padded up to the
        power-of-two bucket (repeating the last request, exactly like
        `parfor`) so every dispatch lands on a warm vmapped closure:
        batch size and bucket are call-time properties — the segment set
        is k-independent and the closure cache re-specializes per bucket
        via the concrete argument signature. Nothing is read from or
        written to the global leaf registry for the request leaves, so
        concurrent plans cannot alias request data; padding is sliced
        off before results are returned (each request's outputs leave
        the device once, at the plan's roots)."""
        from .batching import bucket_size, pad_batch
        plan = bplan.plan
        bucket = bucket_size(k)
        bctx = _BatchCtx(bplan=bplan, batch=k, bucket=bucket,
                         bvals=bplan.batched_value_uids)
        leaf_values = {
            uid: pad_batch(np.asarray(a), bucket)
            for uid, a in zip(bplan.leaf_order, stacked, strict=True)}
        leaf_lineage = None
        if self.cache is not None:
            # reuse probes must key on the request content, not the
            # released placeholder lineage — mirror PreparedScript
            leaf_lineage = {
                uid: f"req:{_fingerprint(np.asarray(a))}"
                for uid, a in zip(bplan.leaf_order, stacked)}
        values, lin = self._bind_leaves(plan, leaf_values, leaf_lineage)
        rctx = _RunCtx(depth=costmodel.pipeline_depth())
        self._run_segments(plan, values, lin, bctx=bctx, rctx=rctx)
        return self._unpack_batch(plan, values, bctx, rctx=rctx)

    # ------------------------------------------------------------------
    def _bind_leaves(self, plan: Plan,
                     leaf_values: Optional[dict[int, Any]],
                     leaf_lineage: Optional[dict[int, str]]
                     ) -> tuple[dict[int, Any], dict[int, str]]:
        """Bind every input leaf to its host array, sparsified (per bind,
        never memoized, so in-place mutation of the source is seen) where
        the plan pins it to bcoo. Leaves stay on the host here: `_arg`
        uploads each one at its first dispatch, and chunk-sliced leaves
        consumed only by the streaming lane stay host-dense — the bucket
        loop sparsifies and uploads one bucket at a time. A federated
        leaf binds its `FederatedTensor`: partitions never move unless a
        `collect` instruction says so."""
        values: dict[int, Any] = {}
        lin: dict[int, str] = {}
        if self.cache is not None:  # lineage only drives reuse probing
            lin = dict(LEAVES.lineage)
            if leaf_lineage:
                lin.update(leaf_lineage)
        fmts = plan.formats_for(self.sparse_inputs)
        stream_host: set[int] = set()
        if plan.chunk_sliced and self.fuse:
            non_chunk = {u for ins in plan.instructions
                         if ins.target != "chunked"
                         for u in ins.input_ids}
            stream_host = {u for u in plan.chunk_sliced
                           if u not in non_chunk}
        for ins in plan.instructions:
            for inp in ins.node.inputs:
                if inp.op == "input" and inp.uid not in values:
                    if leaf_values and inp.uid in leaf_values:
                        src = leaf_values[inp.uid]
                    elif inp.uid in LEAVES.values:
                        src = LEAVES.values[inp.uid]
                    else:
                        raise KeyError(
                            f"unbound input leaf {inp.attr('name')}")
                    if isinstance(src, FederatedTensor):
                        values[inp.uid] = src
                        continue
                    arr = np.asarray(src)
                    if (fmts.get(inp.uid) == backend.BCOO
                            and inp.uid not in stream_host):
                        arr = backend.sparsify(arr)
                    values[inp.uid] = arr
        for r in plan.roots:  # outputs that are themselves leaves
            if r.op == "input" and r.uid not in values:
                if leaf_values and r.uid in leaf_values:
                    values[r.uid] = leaf_values[r.uid]
                else:
                    values[r.uid] = LEAVES.values[r.uid]
        return values, lin

    def _arg(self, values: dict[int, Any], uid: int):
        """The value of `uid` as a tensor (or BCOO) on this runtime's
        device, uploading a host value once (the upload replaces it in
        the environment, so later consumers reuse the device copy)."""
        v = values[uid]
        if not isinstance(v, (torch.Tensor, backend.SparseMatrix)) \
                or v.device != self.device:
            v = backend.to_device(v, self.device)
            values[uid] = v
        return v

    # ------------------------------------------------------------------
    def _run_instructions(self, plan: Plan, values: dict[int, Any],
                          lin: dict[int, str]) -> None:
        """Per-instruction interpreter (the `fuse=False` path); probes and
        populates the reuse cache at the same cost-gated probe points the
        segment executor uses, so hit behaviour is identical."""
        fmts = plan.formats_for(self.sparse_inputs)
        lmemo: dict[int, str] = {}
        for ins in plan.instructions:
            self.stats.instructions += 1
            node = ins.node
            lhash = None
            if self.cache is not None and ins.probe:
                lhash = _lhash_rec(node, lin, lmemo)
                hit = self.cache.probe(lhash)
                if hit is not None:
                    values[ins.out_id] = _coerce_format(
                        hit, fmts.get(ins.out_id, backend.DENSE))
                    self.stats.reused += 1
                    self._free(values, ins.last_use_of)
                    continue
            t0, tt0 = time.perf_counter(), self.stats.trace_time
            out = self._exec_one(ins, values, fmts)
            # per-site closure builds (federated ops) book into
            # trace_time inside LocalSite.execute — keep them out of
            # exec_time, mirroring _execute_cached's split
            self.stats.executed += 1
            self.stats.exec_time += (time.perf_counter() - t0
                                     - (self.stats.trace_time - tt0))
            values[ins.out_id] = out
            if lhash is not None:
                # compile-time admission and estimated cost: identical
                # across fuse modes (see the reference)
                self.cache.put(lhash, out, ins.est_cost_s, gated=False)
            self._free(values, ins.last_use_of)

    # ------------------------------------------------------------------
    def _run_segments(self, plan: Plan, values: dict[int, Any],
                      lin: dict[int, str],
                      bctx: Optional[_BatchCtx] = None,
                      rctx: Optional[_RunCtx] = None) -> None:
        """Segment executor: maximal fusable runs replayed through cached
        closures. With an active reuse cache, probe points are
        segment-final: the cache is probed before a probe-final segment
        runs — a hit skips the whole segment — and populated from its
        output afterwards.

        With a `_BatchCtx` (batched `parfor` plans), segmentation is
        variance-aware and config-variant segments run as
        `torch.func.vmap` closures over the padded batch axis, cached
        under a vmap-tagged key so they never collide with the
        unbatched closure of the same segment body.

        At pipeline depth >= 2 (`_RunCtx.depth`) dispatches return
        without waiting for the device, and dead-after-segment tensors
        owned by this run are donated (see `PipelineLog`) — the donation
        mask is part of the closure-cache key, so a donating closure can
        never serve a call whose arguments must stay live."""
        if rctx is None:
            rctx = _RunCtx()
        reuse = self.cache is not None
        segments = (bctx.bplan.segments_for(reuse) if bctx is not None
                    else plan.segments_for(reuse))
        fmts = plan.formats_for(self.sparse_inputs)
        jcache = get_jit_cache()
        lmemo: dict[int, str] = {}
        # resolve the plan's mesh once per run; None means not enough
        # devices — sharded segments then run their local-equivalent
        # (unshard) closures, the same values
        mesh_spec = plan.mesh_spec
        lmesh = mesh_spec.resolve() if mesh_spec is not None else None
        for seg in segments:
            batched = bctx is not None and seg.variant
            self.stats.segments += 1
            if batched:
                self.stats.batched_segments += 1
            self.stats.instructions += len(seg.instructions)
            last = seg.instructions[-1]
            seg_key = seg.key
            # physical formats are part of the closure; all-dense
            # segments share one closure across sparse_inputs modes
            # (internal formats derive from the boundary ones)
            boundary = (*seg.input_uids, *seg.output_uids)
            if fmts and any(u in fmts for u in boundary):
                fsig = ",".join(fmts.get(u, backend.DENSE)
                                for u in boundary)
                seg_key = f"{seg_key}|f:{fsig}"
            if seg.chunked:
                if batched:
                    # the compiler chunks only leaf reductions, which
                    # never read a batched leaf; a variant stream would
                    # slice the config axis as rows
                    raise NotImplementedError(
                        f"a config-variant streamed segment "
                        f"({seg.summary()}) has no batched lane")
                # streaming lane: dispatch the segment once per row
                # bucket and sum the partial aggregates
                self._run_chunked_segment(plan, seg, seg_key, fmts, values,
                                          lin, lmemo, jcache, rctx=rctx)
                self._free(values, seg.frees)
                continue
            if batched:
                axes = "".join("0" if u in bctx.bvals else "-"
                               for u in seg.input_uids)
                seg_key = f"{seg_key}|vmap:{axes}"
                if bctx.cshard > 1:
                    # bucket axis split over the mesh's config axis: a
                    # different closure than plain vmap
                    seg_key = (f"{seg_key}|cshard:{bctx.cshard}x"
                               f"{mesh_spec.key_tag()}")
                    self.stats.shard.config_sharded_segments += 1
            if seg.sharded:
                if lmesh is not None:
                    from .jit_cache import mesh_key_tag
                    from .segments import shard_specs
                    in_t, out_t = shard_specs(seg)
                    seg_key += mesh_key_tag(mesh_spec.key_tag(),
                                            in_t, out_t)
                    self._meter_shard_segment(seg)
                else:
                    seg_key += "|unshard"  # local-equivalent fallback
            vctx = bctx if batched else None
            # host-path segments (always single-instruction) read their
            # operands themselves: a federated operand never uploads
            host_op = last.node.op in backend.NON_TRACEABLE_OPS
            args = None if host_op else [self._arg(values, u)
                                         for u in seg.input_uids]
            lhash = None
            if reuse and last.probe:
                lhash = _lhash_rec(last.node, lin, lmemo)
                hit = self.cache.probe(lhash)
                if hit is not None:
                    values[last.out_id] = _coerce_format(
                        hit, fmts.get(last.out_id, backend.DENSE))
                    self.stats.reused += 1
                    rest = tuple(u for u in seg.output_uids
                                 if u != last.out_id)
                    if rest:
                        self._run_compensation(seg, seg_key, fmts, args,
                                               rest, last.out_id, jcache,
                                               values, bctx=vctx,
                                               lmesh=lmesh, rctx=rctx)
                    self._free(values, seg.frees)
                    continue
            if host_op:
                # the SAME `_exec_one` the interpreter uses: federated
                # orchestration / collect boundaries dispatch per-site
                # closures and meter the exchange; quantile runs on the
                # host
                t0, tt0 = time.perf_counter(), self.stats.trace_time
                outs = (self._exec_one(last, values, fmts, bctx=vctx),)
                # per-site builds booked into trace_time by
                # LocalSite.execute; exec_time gets the rest
                self.stats.exec_time += (time.perf_counter() - t0
                                         - (self.stats.trace_time - tt0))
                self.stats.executed += 1
            else:
                # note: the REAL bctx, not the variant-gated one — in a
                # batched (parfor/serving) plan even invariant-prefix
                # segments keep their plain keys
                don = self._donation_mask(seg, values, rctx, bctx)
                release = None
                if don:
                    seg_key = f"{seg_key}|don:" + ",".join(map(str, don))
                    plog = self.stats.pipeline
                    plog.donated_buffers += len(don)
                    plog.donated_bytes += sum(
                        _reuse_nbytes(args[i]) for i in don)

                    def release(seg=seg, don=don):
                        for i in don:
                            values.pop(seg.input_uids[i], None)
                try:
                    outs = self._execute_cached(
                        seg_key, self._seg_builder(seg, fmts, vctx,
                                                   donate=don,
                                                   lmesh=lmesh),
                        args, jcache, rctx=rctx, donate=don,
                        release=release)
                except CompileFailedError as e:
                    # degradation ladder: a segment whose closure build
                    # failed runs its instructions eagerly through the
                    # fuse=False kernels (parity by construction);
                    # vmapped/sharded segments have no eager equivalent
                    # of the same closure and re-raise
                    e.args = (f"{e.args[0]} [{seg.summary()}]",)
                    if batched or seg.sharded:
                        raise
                    outs = self._interpret_segment(seg, values, fmts, e)
                else:
                    if rctx.depth >= 2 and not seg.sharded and not (
                            batched and bctx.cshard > 1):
                        # closure outputs this run produced and still
                        # owns — donation candidates for their last
                        # consumer
                        rctx.owned.update(seg.output_uids)
                self.stats.executed += len(seg.instructions)
            for uid, val in zip(seg.output_uids, outs, strict=True):
                values[uid] = val
            if lhash is not None:
                self.cache.put(lhash, values[last.out_id],
                               last.est_cost_s, gated=False)
                # the reuse cache now references this tensor: it must
                # never be donated out from under a future hit
                rctx.owned.discard(last.out_id)
            self._free(values, seg.frees)

    # ------------------------------------------------------------------
    def _seg_builder(self, seg, fmts: dict,
                     bctx: Optional[_BatchCtx] = None,
                     drop_output: Optional[int] = None,
                     donate: tuple = (), lmesh=None):
        """Deferred closure builder, only called on a jit-cache miss:
        plain for invariant segments (donating when `donate` is set),
        vmap-wrapped for config-variant ones, run per shard for
        mesh-lowered ones (with a local-equivalent closure when the mesh
        does not resolve), and per bucket slice around the vmap for
        bucket-sharded batched segments."""
        from .segments import (build_batched_segment_fn,
                               build_config_sharded_segment_fn,
                               build_segment_fn, build_sharded_segment_fn)
        if seg.sharded:
            if lmesh is not None:
                return lambda: build_sharded_segment_fn(
                    seg, self.device, fmts, lmesh.data,
                    drop_output=drop_output)
            return lambda: build_segment_fn(
                seg, self.device, fmts, drop_output=drop_output,
                unshard=True)
        if bctx is None:
            return lambda: build_segment_fn(seg, self.device, fmts,
                                            drop_output=drop_output,
                                            donate=donate)
        if bctx.cshard > 1:
            return lambda: build_config_sharded_segment_fn(
                seg, self.device, fmts, bctx.bvals, bctx.cshard,
                drop_output=drop_output)
        return lambda: build_batched_segment_fn(
            seg, self.device, fmts, bctx.bvals, drop_output=drop_output)

    # ------------------------------------------------------------------
    def _meter_shard_segment(self, seg) -> None:
        """Account one mesh dispatch of a sharded segment into
        `stats.shard` — walked from the compile-time instruction stream,
        so the meter matches the cost model's collective formulas."""
        log = self.stats.shard
        log.sharded_segments += 1
        for ins in seg.instructions:
            op = ins.node.op
            if op == backend.RESHARD_OP:
                log.reshards += 1
                log.collective_bytes += costmodel.collective_bytes(
                    ins.node)
            elif op in backend.SHARD_REDUCE_OPS:
                log.collectives += 1
                log.collective_bytes += costmodel.collective_bytes(
                    ins.node)

    # ------------------------------------------------------------------
    @staticmethod
    def _donation_mask(seg, values: dict[int, Any], rctx: _RunCtx,
                       bctx: Optional[_BatchCtx]) -> tuple[int, ...]:
        """Argument positions safe to donate on this dispatch.

        Structural candidacy (`Segment.donatable_positions`: this segment
        frees the uid, i.e. nothing in the plan reads it afterwards)
        intersected with run-time ownership: the tensor must have been
        produced by a segment closure THIS run (`_RunCtx.owned` — never a
        bound leaf, reuse-cache hit, or value the cache took a reference
        to) and be dense (BCOO values and federated handles are never
        donated). Sharded dispatches are excluded wholesale, as in the
        reference (their inputs enter split into row views). Batched
        (vmap/serving) dispatches are excluded too: their
        mask would depend on per-request reuse-probe outcomes, and a mask
        flip changes the closure key — a rebuild on a pinned serving hot
        path, which deploy warmup guarantees never happens."""
        if rctx.depth < 2 or bctx is not None or seg.sharded:
            return ()
        cand = seg.donatable_positions()
        if not cand:
            return ()
        return tuple(
            i for i in cand
            if seg.input_uids[i] in rctx.owned
            and not backend.is_sparse(values[seg.input_uids[i]]))

    # ------------------------------------------------------------------
    def _execute_cached(self, seg_key: str, build_fn, args, jcache,
                        rctx: Optional[_RunCtx] = None,
                        donate: tuple = (), release=None):
        """Run one segment closure through the jit cache (lookup, build
        on miss, execute), accounting build and execution time. A failed
        build is raised as `CompileFailedError` (the segment loop's
        degradation ladder) unless the fault policy is off.

        Pipeline depth 1 (or no `rctx`): wait for the device — the
        synchronous lane. Depth >= 2: return the outputs as soon as their
        kernels are queued; the wait happens at plan roots / host reads,
        and the dispatch cost is metered into `stats.pipeline`. A
        donating closure (`donate`) is handed the argument list itself
        after `release()` dropped the environment's references."""
        key, exe = jcache.lookup(seg_key, args, self.device)
        if exe is None:
            try:
                exe, dt_build = jcache.compile(key, build_fn)
            except Exception as e:
                if faults.policy_enabled():
                    raise CompileFailedError(seg_key, e) from e
                raise
            self.stats.trace_time += dt_build
        else:
            self.stats.jit_cache_hits += 1
        t0 = time.perf_counter()
        if donate:
            release()
            outs = exe(args)
        else:
            outs = exe(*args)
        if rctx is None or rctx.depth < 2:
            backend.synchronize(self.device)
            self.stats.exec_time += time.perf_counter() - t0
        else:
            dt = time.perf_counter() - t0
            self.stats.exec_time += dt
            plog = self.stats.pipeline
            plog.async_segments += 1
            plog.dispatch_s += dt
        return outs

    # ------------------------------------------------------------------
    def _run_compensation(self, seg, seg_key: str, fmts: dict, args,
                          rest: tuple, probe_uid: int, jcache,
                          values: dict[int, Any],
                          bctx: Optional[_BatchCtx] = None,
                          lmesh=None,
                          rctx: Optional[_RunCtx] = None) -> None:
        """Execute a probe-hit segment's remaining outputs (the segment
        with the cached value dead-code eliminated). Never donates — the
        compensation key derives from the plain segment key."""
        try:
            outs = self._execute_cached(
                f"{seg_key}|comp",
                self._seg_builder(seg, fmts, bctx, drop_output=probe_uid,
                                  lmesh=lmesh),
                args, jcache, rctx=rctx)
        except CompileFailedError as e:
            e.args = (f"{e.args[0]} [{seg.summary()}]",)
            if bctx is not None or seg.sharded:
                raise
            # eager fallback computes ALL segment outputs; deliver only
            # the non-probe ones (the hit already filled probe_uid)
            allouts = self._interpret_segment(seg, values, fmts, e)
            by_uid = dict(zip(seg.output_uids, allouts, strict=True))
            outs = tuple(by_uid[u] for u in rest)
        # interpreter-equivalent accounting: it would execute every
        # instruction except the one reused
        self.stats.executed += len(seg.instructions) - 1
        for uid, val in zip(rest, outs, strict=True):
            values[uid] = val

    # ------------------------------------------------------------------
    def _interpret_segment(self, seg, values: dict[int, Any],
                           fmts: dict, err: CompileFailedError) -> tuple:
        """Graceful-degradation lane for a failed closure build: run the
        segment's instructions eagerly through `_exec_one` — the SAME
        kernels the fuse=False interpreter dispatches. Intermediates
        live in a private overlay; only the segment's declared outputs
        are returned."""
        flog = self.stats.faults
        flog.degradations += 1
        if isinstance(err.cause, faults.InjectedFault):
            flog.injected += 1
        env = dict(values)  # shallow overlay: refs only
        for ins in seg.instructions:
            env[ins.out_id] = self._exec_one(ins, env, fmts)
        return tuple(env[u] for u in seg.output_uids)

    # ------------------------------------------------------------------
    def _run_chunked_segment(self, plan: Plan, seg, seg_key: str,
                             fmts: dict, values: dict[int, Any],
                             lin: dict[int, str], lmemo: dict[int, str],
                             jcache, rctx: Optional[_RunCtx] = None
                             ) -> None:
        """Streaming executor for a chunked-target segment.

        The segment's sliced inputs (`plan.chunk_sliced`) stay on the
        host and are visited in row buckets of `costmodel.chunk_rows`
        rows (from the actual per-row payload, a bcoo leaf charged its
        sparse data + int32 index bytes); each bucket is sparsified where
        the plan pins the leaf to bcoo and uploaded, the segment closure
        runs on it, and its partial aggregates come back to host numpy,
        where they are summed in bucket order. The bucket size is a
        power of two independent of the total row count, so every full
        bucket shares one cached closure and appending rows never shifts
        the earlier bucket boundaries.

        Reuse happens at two granularities, as in the reference: every
        probe-flagged output is probed before any bucket runs (all hits
        skip the stream), and each bucket's partial tuple is cached under
        a key of the segment, the row range and content fingerprints of
        the bucket's slices (plus the replicated operands), so appending
        or correcting rows recomputes only the affected buckets.

        At pipeline depth >= 2 (`costmodel.prefetch_depth` > 1) the
        stream runs double-buffered (`_run_chunked_pipelined`); depth 1
        takes the synchronous loop below. Both add the same partials in
        the same order, so their results are the same bits."""
        reuse = self.cache is not None
        log = self.stats.streaming
        out_set = set(seg.output_uids)
        out_ins = {ins.out_id: ins for ins in seg.instructions
                   if ins.out_id in out_set}
        # ---- full-aggregate probes ----
        lhashes: dict[int, str] = {}
        hits: dict[int, Any] = {}
        if reuse:
            for uid in seg.output_uids:
                if not out_ins[uid].probe:
                    continue
                lh = _lhash_rec(out_ins[uid].node, lin, lmemo)
                lhashes[uid] = lh
                got = self.cache.probe(lh)
                if got is not None:
                    hits[uid] = got
        # short-circuit iff every output is a cache hit or a
        # chunk-invariant generator that rode along
        if hits and all(uid in hits or not out_ins[uid].node.inputs
                        for uid in seg.output_uids):
            for uid in seg.output_uids:
                if uid in hits:
                    values[uid] = _coerce_format(
                        hits[uid], fmts.get(uid, backend.DENSE))
                else:
                    values[uid] = backend.kernel_for_node(
                        out_ins[uid].node, self.device)()
            self.stats.reused += len(hits)
            self.stats.executed += len(seg.output_uids) - len(hits)
            log.full_hits += 1
            return

        sliced = [u for u in seg.input_uids if u in plan.chunk_sliced]
        if not sliced:  # nothing to stream over: one whole-input dispatch
            outs = self._execute_cached(
                seg_key, self._seg_builder(seg, fmts),
                [self._arg(values, u) for u in seg.input_uids], jcache)
            for uid, val in zip(seg.output_uids, outs, strict=True):
                values[uid] = val
            self.stats.executed += len(seg.instructions)
            return

        log.chunked_segments += 1
        # a sparse interior value entering the stream densifies here
        # (leaves are kept host-dense by _bind_leaves; a bound leaf stays
        # the registry's own array, whose fingerprint table applies)
        host = {u: backend.to_numpy(values[u]) for u in sliced}
        rows = host[sliced[0]].shape[0]
        for u in sliced[1:]:
            if host[u].shape[0] != rows:
                raise ValueError(
                    f"chunked segment {seg.index}: sliced inputs "
                    f"disagree on rows ({host[u].shape[0]} vs {rows})")
        row_bytes = 0.0
        for u in sliced:
            a = host[u]
            if fmts.get(u) == backend.BCOO:
                # BCOO slice payload: data + 2 int32 index columns,
                # charged at 2x for the nse power-of-two padding bucket
                nnz = int(np.count_nonzero(a))
                row_bytes += (2.0 * nnz / max(rows, 1)
                              * (a.dtype.itemsize + 8))
            else:
                row_bytes += a.nbytes / max(rows, 1)
        c = costmodel.chunk_rows(row_bytes)
        n_chunks = max(1, -(-rows // c))
        # replicated operands are fingerprinted once: they are part of
        # every chunk's identity (a changed mean shifts every bucket)
        rep_fp = ""
        if reuse:
            t0 = time.perf_counter()
            rep_fp = "|".join(
                _fingerprint(backend.to_numpy(values[u]))
                for u in seg.input_uids if u not in host)
            log.fingerprint_s += time.perf_counter() - t0
        cost_each = (sum(i.est_cost_s for i in out_ins.values())
                     / n_chunks)
        builder = self._seg_builder(seg, fmts)
        # per-output accumulation: chunk_* partials SUM across buckets; an
        # escaping chunked-placement value CONCATs back to full rows; a
        # target-neutral generator that rode along KEEPs its first value
        modes = {}
        for uid in seg.output_uids:
            n = out_ins[uid].node
            if n.op.startswith("chunk_"):
                modes[uid] = "sum"
            elif n.placement == "chunked":
                modes[uid] = "concat"
            else:
                modes[uid] = "keep"
        accs: dict[int, Any] = {u: None for u in seg.output_uids}

        def _accumulate(parts, live: int) -> None:
            t0 = time.perf_counter()
            for uid, p in zip(seg.output_uids, parts, strict=True):
                prev = accs[uid]
                mode = modes[uid]
                if mode == "concat":
                    accs[uid] = [p] if prev is None else prev + [p]
                elif prev is None:
                    accs[uid] = p
                elif mode == "sum":
                    accs[uid] = prev + p
                    log.combines += 1
                # "keep": chunk-invariant — the first value stands
            log.combine_s += time.perf_counter() - t0
            acc_bytes = sum(_reuse_nbytes(v) for v in accs.values()
                            if v is not None)
            log.peak_live_bytes = max(log.peak_live_bytes, live + acc_bytes)

        pdepth = 1
        if rctx is not None and rctx.depth >= 2:
            pdepth = costmodel.prefetch_depth(row_bytes, n_chunks)
        if pdepth <= 1:
            # ---- synchronous loop (bitwise and meter identical at
            # REPRO_PIPELINE_DEPTH=1) ----
            for s in range(0, rows, c):
                e = min(s + c, rows)
                parts, ckey, live = None, None, 0
                if reuse:
                    t0 = time.perf_counter()
                    fps = ",".join(_fingerprint(host[u][s:e])
                                   for u in sliced)
                    log.fingerprint_s += time.perf_counter() - t0
                    ckey = hashlib.sha1(
                        f"chunkpart|{seg_key}|{s}:{e}|{rep_fp}|{fps}"
                        .encode()).hexdigest()
                    parts = self.cache.probe(ckey)
                    if parts is not None:
                        log.chunks_reused += 1
                if parts is None:
                    parts, live = self._run_bucket_sync(
                        seg, seg_key, fmts, values, host, s, e, builder,
                        jcache)
                    if ckey is not None:
                        self.cache.put(ckey, parts, cost_each, gated=False)
                _accumulate(parts, live)
        else:
            self._run_chunked_pipelined(
                seg, seg_key, fmts, values, jcache, host, sliced,
                rows, c, reuse, rep_fp, cost_each, builder,
                _accumulate, row_bytes, rctx)
        for uid, m in modes.items():
            if m == "concat" and accs[uid] is not None:
                accs[uid] = np.concatenate(accs[uid], axis=0)
        # cached full aggregates win; streamed accumulators fill the rest
        # and populate the cache
        for uid in seg.output_uids:
            if uid in hits:
                values[uid] = _coerce_format(
                    hits[uid], fmts.get(uid, backend.DENSE))
            else:
                values[uid] = accs[uid]
                if uid in lhashes:
                    self.cache.put(lhashes[uid], accs[uid],
                                   out_ins[uid].est_cost_s, gated=False)
        self.stats.reused += len(hits)
        self.stats.executed += len(seg.instructions) - len(hits)

    def _run_bucket_sync(self, seg, seg_key: str, fmts: dict,
                         values: dict[int, Any], host: dict, s: int, e: int,
                         builder, jcache) -> tuple[tuple, int]:
        """One bucket of the synchronous loop: slice (and sparsify),
        upload, dispatch and wait, and read the partials back to host
        numpy (their only consumer is the host-side sum; host adds keep
        warm, all-buckets-reused runs off the device). Returns (partials,
        payload bytes)."""
        log = self.stats.streaming
        t0 = time.perf_counter()
        args, live = [], 0
        for u in seg.input_uids:
            if u in host:
                a = host[u][s:e]
                if fmts.get(u) == backend.BCOO:
                    a = backend.sparsify(a)
                live += _reuse_nbytes(a)
                args.append(backend.to_device(a, self.device))
            else:
                args.append(self._arg(values, u))
        t1 = time.perf_counter()
        outs = self._execute_cached(seg_key, builder, args, jcache)
        t2 = time.perf_counter()
        parts = tuple(backend.to_numpy(o) for o in outs)
        log.upload_s += t1 - t0
        log.dispatch_s += t2 - t1
        log.download_s += time.perf_counter() - t2
        log.chunks += 1
        log.bytes_streamed += live
        return parts, live

    # ------------------------------------------------------------------
    def _run_chunked_pipelined(self, seg, seg_key: str, fmts: dict,
                               values: dict[int, Any], jcache,
                               host: dict[int, np.ndarray],
                               sliced: list, rows: int, c: int,
                               reuse: bool, rep_fp: str,
                               cost_each: float, builder,
                               accumulate, row_bytes: float,
                               rctx: _RunCtx) -> None:
        """Double-buffered bucket loop (pipeline depth >= 2).

        Division of labour — the reference's, so every shared structure
        stays single-threaded: the MAIN thread resolves each bucket's
        fingerprints (near-free from the leaf's block-sum table when the
        bucket is 4096-byte aligned, `dag._slice_fingerprint`; direct
        hashing otherwise — both bitwise the synchronous loop's
        `_fingerprint`, so chunk-cache keys and hits are depth-invariant),
        probes the reuse cache, uploads, dispatches, accumulates and
        meters; the single WORKER thread (`chunk-prefetch`) only slices
        and sparsifies a MISS bucket's host arguments and, on CUDA,
        copies them into page-locked memory, while the device computes
        the previous bucket. The worker touches no stream and no device
        memory, so which stream it would start on does not matter. Hit
        buckets never reach the worker.

        On CUDA a bucket's upload runs from its page-locked copy on a
        copy stream the compute stream waits for (an upload from pageable
        memory would block the host), and the bucket's partials are
        copied back into page-locked memory on a second copy stream
        behind its kernels; the main thread reads them — metered as
        `block_s` — only after it has dispatched the NEXT bucket, so the
        read-back and the host add overlap that bucket's compute. The
        partials are added on the host in bucket order, exactly as the
        synchronous loop adds them. A page-locked staging block is
        reused only after the copy that read it completed (the pinned
        allocator records the copy's stream), and a device block read on
        another stream than the one it was made on is marked used there
        (`record_stream`).

        `peak_live_bytes` charges the consuming bucket's actual bytes
        PLUS the next in-flight miss bucket's estimated payload, as the
        reference does, so the meter reflects two live buckets under
        `CHUNK_MEM_BUDGET`.

        A worker exception surfaces on the main thread at
        `Future.result()`; under the fault policy the stream degrades
        mid-flight to the synchronous loop (injected or real worker death
        costs the pipeline, never the answer), with the policy off it
        propagates raw. Either way the `finally` cancels queued preps
        (counted as `prefetch_cancelled`) and joins the worker, so an
        error never leaves a thread behind or a bucket dropped."""
        log = self.stats.streaming
        plog = self.stats.pipeline
        dev = self.device
        cuda = dev.type == "cuda"
        compute = up = down = None
        if cuda:
            compute = torch.cuda.current_stream(dev)
            up, down = _copy_streams(dev)
        # block-sum tables are only valid when the bound value IS the
        # registered leaf buffer; an override/densified copy falls back
        # to hashing
        tables = {}
        for u in sliced:
            a = host[u]
            if (LEAVES.values.get(u) is a
                    and a.flags["C_CONTIGUOUS"] and a.ndim >= 1):
                tables[u] = LEAVES.fp_tables.get(u)
            else:
                tables[u] = None
        # replicated operands: on the device once, before the worker
        # starts (the worker never touches `values`)
        rep = {u: self._arg(values, u) for u in seg.input_uids
               if u not in host}

        def _bucket_fp(u: int, s: int, e: int) -> str:
            sl = host[u][s:e]
            t = tables[u]
            if t is not None:
                fp = _slice_fingerprint(sl, t, s * host[u].strides[0])
                if fp is not None:
                    return fp
            return _fingerprint(sl)

        def _ckey(s: int, e: int) -> str:
            t0 = time.perf_counter()
            fps = ",".join(_bucket_fp(u, s, e) for u in sliced)
            log.fingerprint_s += time.perf_counter() - t0
            return hashlib.sha1(
                f"chunkpart|{seg_key}|{s}:{e}|{rep_fp}|{fps}"
                .encode()).hexdigest()

        def _prep(s: int, e: int):
            # worker-side injection point: a chunk_io firing here kills
            # this prep — the consumer degrades the rest of the stream to
            # the synchronous loop (whose re-preps are injection-free, so
            # recovery always completes)
            faults.io_entry("chunk_prefetch")
            t0 = time.perf_counter()
            staged, live = {}, 0
            for u in sliced:
                a = host[u][s:e]
                if fmts.get(u) == backend.BCOO:
                    a = backend.sparsify(a)
                live += _reuse_nbytes(a)
                staged[u] = _pinned(a) if cuda else a
            return staged, live, time.perf_counter() - t0

        def _finish(entry) -> None:
            # accumulate one bucket, in bucket order: a dispatched one
            # waits for its partials' read-back first
            ckey, parts, handle, live = entry
            if parts is None:
                t0 = time.perf_counter()
                if cuda:
                    hs, done = handle
                    done.synchronize()
                    parts = _host_parts(hs)
                else:
                    parts = tuple(backend.to_numpy(o) for o in handle)
                dt = time.perf_counter() - t0
                plog.block_s += dt
                log.download_s += dt
                if ckey is not None:
                    self.cache.put(ckey, parts, cost_each, gated=False)
            accumulate(parts, live)

        spans = [(s, min(s + c, rows)) for s in range(0, rows, c)]
        pdepth = costmodel.prefetch_depth(row_bytes, len(spans))
        ex = ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="chunk-prefetch")
        inflight: deque = deque()  # (s, e, ckey, parts, fut)
        pending: deque = deque()   # (ckey, parts, read-back, live) in order
        nxt = 0
        try:
            while inflight or nxt < len(spans):
                # keep pdepth buckets resolved/in flight ahead of the
                # consumer; fingerprint+probe here, arg prep for misses
                # on the worker
                while len(inflight) < pdepth and nxt < len(spans):
                    s, e = spans[nxt]
                    nxt += 1
                    ckey, parts, fut = None, None, None
                    if reuse:
                        ckey = _ckey(s, e)
                        parts = self.cache.probe(ckey)
                        if parts is not None:
                            log.chunks_reused += 1
                    if parts is None:
                        fut = ex.submit(_prep, s, e)
                        plog.prefetch_issued += 1
                    inflight.append((s, e, ckey, parts, fut))
                s, e, ckey, parts, fut = inflight.popleft()
                live, handle = 0, None
                if parts is None:
                    try:
                        staged, live, dt_prep = fut.result()
                    except Exception as err:
                        if not faults.policy_enabled():
                            raise
                        # degradation ladder: the prefetch worker died
                        # mid-stream — finish the buckets already
                        # dispatched, then reclaim this span plus every
                        # queued/unscheduled one and finish on the
                        # synchronous loop
                        flog = self.stats.faults
                        if isinstance(err, faults.InjectedFault):
                            flog.injected += 1
                        flog.degradations += 1
                        while pending:
                            _finish(pending.popleft())
                        tail = [(s, e, ckey, None)]
                        while inflight:
                            s2, e2, ck2, p2, f2 = inflight.popleft()
                            if f2 is not None and f2.cancel():
                                plog.prefetch_cancelled += 1
                            tail.append((s2, e2, ck2, p2))
                        tail.extend((s3, e3, None, None)
                                    for s3, e3 in spans[nxt:])
                        nxt = len(spans)
                        for s2, e2, ck2, p2 in tail:
                            live2 = 0
                            if p2 is None and reuse and ck2 is None:
                                # spans the pipeline never resolved:
                                # probe the chunk cache like the sync
                                # loop would (same keys, same hits)
                                ck2 = _ckey(s2, e2)
                                p2 = self.cache.probe(ck2)
                                if p2 is not None:
                                    log.chunks_reused += 1
                            if p2 is None:
                                p2, live2 = self._run_bucket_sync(
                                    seg, seg_key, fmts, values, host, s2,
                                    e2, builder, jcache)
                                if ck2 is not None:
                                    self.cache.put(ck2, p2, cost_each,
                                                   gated=False)
                            accumulate(p2, live2)
                        return
                    plog.prefetch_hits += 1
                    plog.prefetch_s += dt_prep
                    t0 = time.perf_counter()
                    args = [(_upload_async(staged[u], dev, up, compute)
                             if cuda else backend.to_device(staged[u], dev))
                            if u in staged else rep[u]
                            for u in seg.input_uids]
                    del staged
                    t1 = time.perf_counter()
                    outs = self._execute_cached(seg_key, builder, args,
                                                jcache, rctx=rctx)
                    del args
                    t2 = time.perf_counter()
                    handle = (_download_async(outs, down, compute)
                              if cuda else outs)
                    del outs
                    log.upload_s += t1 - t0
                    log.dispatch_s += t2 - t1
                    log.download_s += time.perf_counter() - t2
                    log.chunks += 1
                    log.bytes_streamed += live
                # charge the NEXT in-flight miss bucket alongside this
                # one: its args are (being) materialized concurrently
                nxt_live = 0
                if inflight and inflight[0][3] is None:
                    n_rows = inflight[0][1] - inflight[0][0]
                    nxt_live = int(n_rows * row_bytes)
                pending.append((ckey, parts, handle, live + nxt_live))
                # accumulate every bucket before the newest dispatched
                # one: its read-back overlaps the newest one's compute
                while pending and (len(pending) > 1
                                   or pending[0][1] is not None):
                    _finish(pending.popleft())
            while pending:
                _finish(pending.popleft())
        finally:
            while inflight:
                _, _, _, _, fut = inflight.popleft()
                if fut is not None and fut.cancel():
                    plog.prefetch_cancelled += 1
            ex.shutdown(wait=True)

    # ------------------------------------------------------------------
    def _exec_one(self, ins, values: dict[int, Any], fmts: dict,
                  bctx: Optional[_BatchCtx] = None):
        """Execute one instruction eagerly and wait for the device — the
        single implementation shared by the interpreter loop and the
        segment executor's host path: federated ops route to the site
        orchestrator, everything else runs its registry kernel.

        `bctx` (batched plans) marks operands carrying the config axis:
        federated ops take their batched path (one exchange round per
        site for the whole grid); a host op (quantile) loops over the
        TRUE k configs on the host (order statistics on concrete values
        cannot vmap) and its result is padded back into the bucket,
        never recomputed for the padding configs."""
        node = ins.node
        if node.op in backend.FED_OPS or node.op == backend.COLLECT_OP:
            return self._exec_federated(ins, values, bctx=bctx)
        kern = backend.kernel_for_node(
            node, self.device,
            in_fmts=tuple(fmts.get(u, backend.DENSE)
                          for u in ins.input_ids),
            out_fmt=fmts.get(ins.out_id, backend.DENSE),
            # eager execution holds GLOBAL values: shard-exec ops run
            # their local-equivalent base kernels
            unshard=node.op in backend.SHARD_EXEC_OPS)
        args = [self._arg(values, u) for u in ins.input_ids]
        if bctx is not None:
            bpos = {i for i, u in enumerate(ins.input_ids)
                    if u in bctx.bvals}
            rows = [kern(*[a[j] if i in bpos else a
                           for i, a in enumerate(args)])
                    for j in range(bctx.batch)]
            out = _pad_axis0(torch.stack(rows, dim=0), bctx.bucket)
        else:
            out = kern(*args)
        backend.synchronize(self.device)
        return out

    # ------------------------------------------------------------------
    def _site_call(self, op: str, i: int, rpc, local=None):
        """One federated site RPC under the fault policy: per-site
        timeout + bounded exponential-backoff retry, then the
        degradation ladder. Returns ``(result, degraded)``.

        `rpc(stats)` performs the site call (stats is `self.stats` on
        the first attempt, None on re-attempts so retries cannot
        double-book closure-cache/build meters); `local()` is the
        collect-and-recompute fallback run when every attempt failed but
        the site's DATA survives. In-process sites cannot be preempted,
        so the timeout binds at the attempt boundary: a call slower than
        `costmodel.fed_timeout_s()` has its (late) result discarded and
        is retried — sound because site kernels are pure, a recompute
        yields the same value. Latencies route through the `StepMonitor`
        straggler flagging and successful calls heartbeat the site. With
        the policy off this is a bare passthrough (raw error
        propagation)."""
        if not faults.policy_enabled():
            return rpc(self.stats), False
        flog = self.stats.faults
        timeout = costmodel.fed_timeout_s()
        last_err: Optional[BaseException] = None
        for attempt in range(costmodel.max_retries() + 1):
            if attempt:
                pause = costmodel.retry_backoff_s(attempt)
                flog.retries += 1
                flog.backoff_s += pause
                if pause > 0:
                    time.sleep(pause)
            t0 = time.perf_counter()
            try:
                out = rpc(self.stats if attempt == 0 else None)
            except Exception as e:
                flog.record_site(i, time.perf_counter() - t0, ok=False)
                if isinstance(e, faults.InjectedFault):
                    flog.injected += 1
                last_err = e
                continue
            dt = time.perf_counter() - t0
            flog.record_site(i, dt)
            if dt > timeout:
                flog.timeouts += 1
                last_err = TimeoutError(
                    f"site {i} exceeded {timeout}s during {op!r}")
                continue
            return out, False
        plan = faults.active_plan()
        if local is None or (plan is not None and plan.data_lost(i)):
            raise SiteFailedError(i, op, detail=str(last_err))
        flog.degradations += 1
        return local(), True

    def _recompute_local(self, s: LocalSite, i: int, op: str, args: tuple,
                         attrs: tuple, vmap_axes):
        """Degradation-ladder step for a dead site whose data survives:
        pull the partition to the master — metered as a collect
        (`add_in` + one round) — and run the site's work locally through
        the SAME cached closure (`site=None` is never injected), so a
        degraded run is bitwise the clean run."""
        log = self.stats.exchange
        log.add_in(s.data, site=i)
        log.add_round(i)
        return s.execute(op, args, attrs=attrs, stats=self.stats,
                         vmap_axes=vmap_axes, site=None,
                         device=self.device)

    @staticmethod
    def _data_plane_check(op: str, i: int) -> None:
        """Raise `SiteFailedError` when site `i`'s data plane is gone
        (`site_lost`) — guards pure data movement (collect) and the
        recompute ladder, which both read `site.data` directly."""
        if not faults.policy_enabled():
            return
        plan = faults.active_plan()
        if plan is not None and plan.data_lost(i):
            raise SiteFailedError(i, op)

    # ------------------------------------------------------------------
    def _exec_federated(self, ins, values: dict[int, Any],
                        bctx: Optional[_BatchCtx] = None):
        """Execute one federated instruction (or a `collect` boundary).

        Master-side orchestration: loop over sites, run each site's local
        work as a cached closure (`LocalSite.execute` — the kernel
        registry + the process-wide closure cache, so a site's gram runs
        the same kernels as local plans and repeated runs replay warm
        closures), and meter every byte crossing the federation boundary
        into `stats.exchange`, per site. Every (instruction, site) pair
        that actually exchanges bytes counts one *round*. Site results
        are added in site order, on the device.

        With a `_BatchCtx`, batched *local* operands (fed operands are
        never batched — `batching.choose_mode` guarantees it) travel as
        ONE stacked payload per site and the site's work runs vmapped
        over the config axis: a k-configuration grid costs one round per
        site per instruction, not k."""
        node = ins.node
        op = node.op
        dev = self.device
        log = self.stats.exchange
        args = [values[u] for u in ins.input_ids]
        bpos = (frozenset(i for i, u in enumerate(ins.input_ids)
                          if u in bctx.bvals)
                if bctx is not None else frozenset())

        if op == backend.COLLECT_OP:
            fed = args[0]
            fed._require_sites(op)
            batched = getattr(fed, "batch", None) is not None
            parts = []
            for i, s in enumerate(fed.sites):
                # collect is pure data movement: only a lost DATA plane
                # can fail it (a dead compute plane still serves reads)
                self._data_plane_check(op, i)
                log.add_in(s.data, site=i)
                log.add_round(i)
                parts.append(s.on(dev))
            # batched site layout is (k, rows_i, c): rows concat on axis 1
            out = torch.cat(parts, dim=1 if batched else 0)
            return _pad_axis0(out, bctx.bucket) if batched else out

        if op == "fed_gram":
            fed = args[0]
            fed._require_sites(op)
            batched = getattr(fed, "batch", None) is not None
            vmap_axes = (0,) if batched else None
            out = None
            for i, s in enumerate(fed.sites):
                g, deg = self._site_call(
                    op, i,
                    lambda st, s=s, i=i: s.execute(
                        "gram", (s,), stats=st, vmap_axes=vmap_axes,
                        site=i, device=dev),
                    local=lambda s=s, i=i: self._recompute_local(
                        s, i, "gram", (s,), (), vmap_axes))
                if not deg:  # exchange metered on success only
                    log.add_in(g, site=i)
                    log.add_round(i)
                out = g if out is None else out + g
            return _pad_axis0(out, bctx.bucket) if batched else out

        if op in ("fed_xtv", "fed_vm"):
            # x^T v with any subset of {x, v} federated: per-site partial
            # products summed at the master; row-aligned local operands
            # are sent sliced (only the relevant rows travel). Batched
            # local operands are sliced along the row axis of each
            # config: v[:, a:b] — one stacked send per site.
            fed_pos = set(node.attr("fed_args", (0,)))
            fed = args[min(fed_pos)]
            fed._require_sites(op)
            self._check_alignment(op, [args[p] for p in sorted(fed_pos)])
            # batched positions: local operands flagged by the plan plus
            # federated operands whose site layout carries a config axis
            bat = set(bpos) | {p for p in fed_pos
                               if getattr(args[p], "batch", None)}
            # a batched operand is sliced to the TRUE k before anything
            # crosses the wire — the bucket padding must not inflate the
            # exchange
            args = [v if pos in fed_pos else
                    (backend.densify(v)[:bctx.batch] if pos in bat
                     else backend.densify(v))
                    for pos, v in enumerate(args)]
            vmap_axes = (tuple(0 if pos in bat else None
                               for pos in range(len(args)))
                         if bat else None)
            out = None
            for i, (a, b) in enumerate(fed.ranges):
                site_args, sent = [], []
                for pos, v in enumerate(args):
                    if pos in fed_pos:
                        site_args.append(v.sites[i])
                    else:
                        sl = v[:, a:b] if pos in bat else v[a:b]
                        sent.append(sl)
                        site_args.append(sl)
                s = fed.sites[i]
                sa = tuple(site_args)
                r, deg = self._site_call(
                    op, i,
                    lambda st, s=s, i=i, sa=sa: s.execute(
                        "xtv", sa, stats=st, vmap_axes=vmap_axes, site=i,
                        device=dev),
                    local=lambda s=s, i=i, sa=sa: self._recompute_local(
                        s, i, "xtv", sa, (), vmap_axes))
                if not deg:  # exchange metered on success only
                    for sl in sent:
                        log.add_out(sl, site=i)
                    log.add_in(r, site=i)
                    log.add_round(i)
                out = r if out is None else out + r
            return _pad_axis0(out, bctx.bucket) if bat else out

        if op == "fed_mv":
            fed, w = args
            fed._require_sites(op)
            w = backend.densify(w)
            fed_b = getattr(fed, "batch", None) is not None
            w_b = 1 in bpos
            batched = fed_b or w_b
            if w_b:  # send the true k configs, never the padding
                w = w[:bctx.batch]
            vmap_axes = ((0 if fed_b else None, 0 if w_b else None)
                         if batched else None)
            parts = []
            for i, s in enumerate(fed.sites):
                r, deg = self._site_call(
                    op, i,
                    lambda st, s=s, i=i: s.execute(
                        "matmul", (s, w), stats=st, vmap_axes=vmap_axes,
                        site=i, device=dev),
                    local=lambda s=s, i=i: self._recompute_local(
                        s, i, "matmul", (s, w), (), vmap_axes))
                if not deg:
                    log.add_out(w, site=i)  # broadcast (whole grid)
                    log.add_in(r, site=i)   # rbind of per-site results
                    log.add_round(i)
                parts.append(r)
            # per-site results are (rows_i, n) — or (k, rows_i, n)
            # batched — so the row concat axis shifts with the batch
            out = torch.cat(parts, dim=1 if batched else 0)
            return _pad_axis0(out, bctx.bucket) if batched else out

        if op == "fed_colsums":
            fed = args[0]
            fed._require_sites(op)
            batched = getattr(fed, "batch", None) is not None
            vmap_axes = (0,) if batched else None
            out = None
            for i, s in enumerate(fed.sites):
                r, deg = self._site_call(
                    op, i,
                    lambda st, s=s, i=i: s.execute(
                        "colSums", (s,), stats=st, vmap_axes=vmap_axes,
                        site=i, device=dev),
                    local=lambda s=s, i=i: self._recompute_local(
                        s, i, "colSums", (s,), (), vmap_axes))
                if not deg:
                    log.add_in(r, site=i)
                    log.add_round(i)
                out = r if out is None else out + r
            return _pad_axis0(out, bctx.bucket) if batched else out

        if op == "fed_map":
            return self._exec_fed_map(node, args, log, bctx=bctx,
                                      bpos=bpos)

        raise NotImplementedError(f"federated op {op!r}")

    def _exec_fed_map(self, node, args: list, log: ExchangeLog,
                      bctx: Optional[_BatchCtx] = None,
                      bpos: frozenset = frozenset()) -> FederatedTensor:
        """Row-preserving op applied per site: the output is a new
        `FederatedTensor` over the same ranges — no aggregate exchange.
        Local operands travel by shape: scalars and `full` generators
        cost nothing (generated on site, here directly on the device),
        broadcast rows go to every site, row-aligned matrices are sent
        sliced.

        Batched (`parfor`) operands — local values flagged by the plan
        (`bpos`) or federated operands already carrying the stacked
        layout — travel as ONE (k, …) payload per site and the site's
        work runs vmapped over the config axis; the output federated
        tensor then carries the stacked (k, rows_i, c) site layout
        (`FederatedTensor.batch`), which the other fed_* instructions'
        batched paths consume. Only the TRUE k crosses the wire."""
        dev = self.device
        inner = node.attr("inner")
        n_args = node.attr("n_args")
        fed_pos = set(node.attr("fed_args", ()))
        gens = {p: (v, k, dt) for p, v, k, dt in node.attr("gen_args", ())}
        iattrs = dict(node.attr("iattrs", ()))
        slot: dict[int, Any] = {}
        bslots: set[int] = set()  # inner positions carrying the config axis
        it = iter(enumerate(args))
        for pos in range(n_args):
            if pos not in gens:
                ai, v = next(it)
                if pos in fed_pos:
                    slot[pos] = v
                    if getattr(v, "batch", None) is not None:
                        bslots.add(pos)
                else:
                    # densify local operands once, outside the site
                    # loop; batched ones sliced to the TRUE k up front
                    v = backend.densify(v)
                    if ai in bpos:
                        v = v[:bctx.batch]
                        bslots.add(pos)
                    slot[pos] = v
        batched = bool(bslots)
        vmap_axes = (tuple(0 if pos in bslots else None
                           for pos in range(n_args))
                     if batched else None)
        feds = [slot[p] for p in sorted(fed_pos)]
        fed = feds[0]
        fed._require_sites("fed_map")
        self._check_alignment("fed_map", feds)
        new_sites = []
        for i, (a, b) in enumerate(fed.ranges):
            rows_i = b - a
            ia = dict(iattrs)
            if inner == "slice":
                # rebase the absolute row range onto this site's rows
                idx = list(ia["index"])
                idx[0] = (0, rows_i, 0)
                ia["index"] = tuple(idx)
            site_args, to_send = [], []
            for pos in range(n_args):
                if pos in gens:
                    val, k, dt = gens[pos]
                    site_args.append(torch.full(
                        (rows_i, int(k)), val,
                        dtype=backend.torch_dtype(dt), device=dev))
                elif pos in fed_pos:
                    site_args.append(slot[pos].sites[i])
                else:
                    v = slot[pos]
                    shp = tuple(getattr(v, "shape", ()))
                    # route by the per-config shape: a batched operand
                    # carries a leading (k, …) axis on top of it
                    ishp = shp[1:] if pos in bslots else shp
                    if ishp == () or ishp[0] == 1:
                        if ishp != () or pos in bslots:
                            to_send.append(v)  # broadcast payload
                        site_args.append(v)
                    else:
                        sl = (v[:, a:b] if pos in bslots else v[a:b])
                        to_send.append(sl)
                        site_args.append(sl)
            s = fed.sites[i]
            sa, attrs = tuple(site_args), tuple(sorted(ia.items()))
            out_i, deg = self._site_call(
                "fed_map", i,
                lambda st, s=s, i=i, sa=sa, attrs=attrs: s.execute(
                    inner, sa, attrs=attrs, stats=st,
                    vmap_axes=vmap_axes, site=i, device=dev),
                local=lambda s=s, i=i, sa=sa, attrs=attrs:
                    self._recompute_local(s, i, inner, sa, attrs,
                                          vmap_axes))
            if not deg and to_send:
                # purely on-site fed_map work (generators, fed operands)
                # exchanges nothing and counts no round; exchange is
                # metered on success only
                for payload in to_send:
                    log.add_out(payload, site=i)
                log.add_round(i)
            new_sites.append(LocalSite(out_i))
        return FederatedTensor(sites=new_sites, ranges=list(fed.ranges),
                               ncols=node.shape[1],
                               batch=bctx.batch if batched else None)

    @staticmethod
    def _check_alignment(op: str, feds: list) -> None:
        ranges = feds[0].ranges
        for f in feds[1:]:
            if list(f.ranges) != list(ranges):
                raise ValueError(
                    f"{op}: federated operands are partitioned "
                    f"differently ({f.ranges} vs {ranges}); joint "
                    "federated execution requires aligned row ranges")

    @staticmethod
    def _free(values: dict[int, Any], uids: tuple[int, ...]):
        for uid in uids:
            values.pop(uid, None)


def _coerce_format(value: Any, fmt: str) -> Any:
    """Align a reuse-cache hit with the plan's assigned physical format:
    lineage hashes identify values, not representations, so a cache
    shared across runtimes (or sparse_inputs settings) can hand back a
    dense value where this plan assigned BCOO, or the reverse."""
    if fmt == backend.BCOO and not backend.is_sparse(value):
        return backend.sparsify(backend.to_numpy(value))
    if fmt == backend.DENSE and backend.is_sparse(value):
        return value.todense()
    return value


# ---------------------------------------------------------------------------
# Module-level convenience (a default runtime without reuse)
# ---------------------------------------------------------------------------

_default_runtime: Optional[LineageRuntime] = None


def get_runtime() -> LineageRuntime:
    """The default runtime, built on first use exactly like
    `LineageRuntime()`: on CUDA, raising without a GPU."""
    global _default_runtime
    if _default_runtime is None:
        _default_runtime = LineageRuntime()
    return _default_runtime


def set_runtime(rt: LineageRuntime) -> None:
    global _default_runtime
    _default_runtime = rt


def evaluate(*outputs: LTensor, runtime: Optional[LineageRuntime] = None
             ) -> list[np.ndarray]:
    rt = runtime or get_runtime()
    return rt.evaluate(list(outputs))


def value(x: LTensor, runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    return evaluate(x, runtime=runtime)[0]


# ---------------------------------------------------------------------------
# PreparedScript (JMLC-style precompiled script, §3.1)
# ---------------------------------------------------------------------------

class PreparedScript:
    """Compile a DSL function once; execute repeatedly with new inputs.
    `prepare_batched` compiles its serving form (`repro_torch.serving`)."""

    def __init__(self, fn: Callable[..., Any],
                 arg_shapes: Sequence[tuple[int, ...]],
                 arg_dtypes: Optional[Sequence[Any]] = None,
                 runtime: Optional[LineageRuntime] = None,
                 arg_sparsities: Optional[Sequence[float]] = None):
        # arg_sparsities: declared density per argument (JMLC-style
        # metadata); placeholders are zeros, so default to dense (1.0)
        self.runtime = runtime or get_runtime()
        self._fn = fn
        self._arg_shapes = [tuple(int(d) for d in s) for s in arg_shapes]
        self._arg_dtypes = [np.dtype(d) for d in (
            arg_dtypes or [np.float64] * len(arg_shapes))]
        self._arg_sparsities = list(
            arg_sparsities or [1.0] * len(arg_shapes))
        # shape-variation memo: bound-shapes tuple -> None (accepted) or
        # the rejection message (see _check_shapes)
        self._shape_verdicts: dict[tuple, Optional[str]] = {}
        self._leaves = [
            input_tensor(f"arg{i}", np.zeros(s, dtype=d), sparsity=sp)
            for i, (s, d, sp) in enumerate(
                zip(self._arg_shapes, self._arg_dtypes,
                    self._arg_sparsities, strict=True))]
        outs = fn(*self._leaves)
        if isinstance(outs, LTensor):
            outs = [outs]
        self._outputs = list(outs)
        self.plan = compile_plan(
            self._outputs, reuse_enabled=self.runtime.cache is not None,
            opt_level=self.runtime.opt_level)

    # ------------------------------------------------------------------
    def validate_args(self, arrays: Sequence[Any],
                      exact_shapes: bool = False) -> list[np.ndarray]:
        """Validate bindings against the declared `arg_shapes` /
        `arg_dtypes` at bind time, with a clear `ValueError`. A dtype that
        safe-casts to the declared one is converted; a shape may deviate
        only along axes the plan never constrains (see `_check_shapes`)."""
        if len(arrays) != len(self._leaves):
            raise ValueError(
                f"PreparedScript expects {len(self._leaves)} argument(s), "
                f"got {len(arrays)}")
        out: list[np.ndarray] = []
        mismatch = False
        for i, (arr, shape, dtype) in enumerate(
                zip(arrays, self._arg_shapes, self._arg_dtypes)):
            arr = np.asarray(arr)
            if arr.dtype != dtype:
                if not np.can_cast(arr.dtype, dtype, casting="safe"):
                    raise ValueError(
                        f"PreparedScript arg{i}: bound dtype {arr.dtype} "
                        f"does not safe-cast to the declared {dtype}")
                arr = arr.astype(dtype)
            if arr.shape != shape:
                if exact_shapes or len(arr.shape) != len(shape):
                    raise ValueError(
                        f"PreparedScript arg{i}: bound shape {arr.shape} "
                        f"!= declared {shape}")
                mismatch = True
            out.append(arr)
        if mismatch:
            self._check_shapes(tuple(a.shape for a in out))
        return out

    def _check_shapes(self, shapes: tuple) -> None:
        """Accept deviating bound shapes iff re-tracing the script at the
        bound shapes yields the same instruction stream up to leaf
        renaming (generator shapes included). Verdicts are memoized."""
        verdict = self._shape_verdicts.get(shapes)
        if verdict is None and shapes in self._shape_verdicts:
            return  # previously accepted
        if verdict is None:
            verdict = self._probe_shapes(shapes)
            self._shape_verdicts[shapes] = verdict
        if verdict is not None:
            raise ValueError(verdict)

    def _probe_shapes(self, shapes: tuple) -> Optional[str]:
        declared = tuple(self._arg_shapes)
        try:
            leaves = [
                input_tensor(f"arg{i}", np.zeros(s, dtype=d), sparsity=sp)
                for i, (s, d, sp) in enumerate(
                    zip(shapes, self._arg_dtypes, self._arg_sparsities))]
            outs = self._fn(*leaves)
            if isinstance(outs, LTensor):
                outs = [outs]
            probe = compile_plan(
                list(outs), reuse_enabled=self.runtime.cache is not None,
                opt_level=self.runtime.opt_level)
        except Exception as e:
            return (f"PreparedScript: bound shapes {shapes} != declared "
                    f"{declared} and re-tracing at the bound shapes "
                    f"failed ({type(e).__name__}: {e})")
        reject = (f"PreparedScript: bound shapes {shapes} deviate from "
                  f"the declared {declared} along axes the plan "
                  "constrains (generator shapes, slice bounds, or "
                  "shape-dependent rewrites differ)")
        a_ins, b_ins = self.plan.instructions, probe.instructions
        if len(a_ins) != len(b_ins):
            return reject
        # positional uid correspondence: declared-plan uid -> probe uid
        pair: dict[int, int] = {
            la.node.uid: lb.node.uid
            for la, lb in zip(self._leaves, leaves)}
        for ia, ib in zip(a_ins, b_ins):
            na, nb = ia.node, ib.node
            if (na.op != nb.op or na.attrs != nb.attrs
                    or na.dtype != nb.dtype
                    or len(ia.input_ids) != len(ib.input_ids)):
                return reject
            if not na.inputs and na.shape != nb.shape:
                return reject  # generator output shape is kernel-baked
            for ua, ub in zip(ia.input_ids, ib.input_ids):
                if pair.setdefault(ua, ub) != ub:
                    return reject
            if pair.setdefault(ia.out_id, ib.out_id) != ib.out_id:
                return reject
        for ua, ub in zip(self.plan.output_ids, probe.output_ids):
            if pair.get(ua) != ub:
                return reject
        return None

    def __call__(self, *arrays) -> list[np.ndarray]:
        arrays = self.validate_args(arrays)
        leaf_values: dict[int, Any] = {}
        leaf_lineage: dict[int, str] = {}
        # content fingerprints keep reuse sound across re-binds; only a
        # reuse cache needs them
        need_lineage = self.runtime.cache is not None
        for leaf, arr in zip(self._leaves, arrays):
            leaf_values[leaf.node.uid] = arr
            if need_lineage:
                leaf_lineage[leaf.node.uid] = \
                    f"{leaf.node.attr('name')}:{_fingerprint(arr)}"
        return self.runtime.run_plan(self.plan, leaf_values, leaf_lineage)

    # ------------------------------------------------------------------
    def prepare_batched(self):
        """Compile the serving form of this script: the same function
        traced over *batched* request leaves, returning a
        `batching.BatchedPlan` replayable at any batch size through
        `LineageRuntime.replay_batch`. This is the deploy-time entry
        `repro_torch.serving.ModelServer` warms its power-of-two vmap
        buckets from — closure builds move off the request path."""
        from .batching import compile_serving
        return compile_serving(
            self._fn, self._arg_shapes, self._arg_dtypes,
            self._arg_sparsities,
            reuse_enabled=self.runtime.cache is not None,
            opt_level=self.runtime.opt_level)


# ---------------------------------------------------------------------------
# Lineage trace export (§4.1 — debugging / versioning over lineage)
# ---------------------------------------------------------------------------

def lineage_trace(x: LTensor) -> str:
    """Serialize the lineage DAG in a SystemDS-log-like text format."""
    lines: list[str] = []
    seen: dict[int, int] = {}

    def rec(n: Node) -> int:
        if n.uid in seen:
            return seen[n.uid]
        args = [rec(i) for i in n.inputs]
        idx = len(lines)
        seen[n.uid] = idx
        if n.op == "input":
            lid = LEAVES.lineage.get(n.uid, f"input:{n.attr('name')}")
            lines.append(f"({idx}) L·input {lid}")
        elif n.op == "literal":
            lines.append(f"({idx}) L·lit {n.attr('value')}")
        else:
            attrs = {k: v for k, v in n.attrs if k != "index"}
            ref = " ".join(f"({a})" for a in args)
            lines.append(f"({idx}) L·{n.op} {ref} {attrs or ''}".rstrip())
        return idx

    rec(x.node)
    return "\n".join(lines)
