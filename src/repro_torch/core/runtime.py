"""LineageRuntime: the control program (SystemDS §3.2 Fig. 3-3).

Port of `repro.core.runtime`, synchronous lane. Interprets compiled
plans instruction by instruction (`fuse=False`) or segment by segment
(`fuse=True`), maintains the intermediate environment (buffer pool with
liveness-based frees), traces lineage for every executed operation, and
probes/populates the lineage reuse cache (§4.1). Chunked plans stream
their oversized leaves through the device one row bucket at a time.

Device: a runtime computes on one torch device, `cuda` unless the caller
asks for another (`LineageRuntime(device="cpu")`, as the tests do). It
never falls back to the CPU: without a GPU, the default raises. Bound
leaves stay host numpy arrays (as in the reference) and are uploaded at
dispatch; results come back as numpy arrays.

Sparse lane (`sparse_inputs=True`): leaves the compiler pins to `bcoo`
are sparsified on the host at every bind (`backend.sparsify`) and
uploaded as `BCOO` values; each closure's kernels are selected from the
plan's formats, segment keys carry the boundary formats, and a reuse hit
is coerced to the format the plan assigned. The streaming lane charges a
bcoo leaf its sparse bytes per row and sparsifies each bucket it uploads.

Batched lane (`evaluate_batch`, the §5 `parfor`): a `BatchedPlan`
(`repro_torch.core.batching`) runs its config-invariant prefix once
through the ordinary segment machinery and each config-variant segment
as one `torch.func.vmap` closure over the padded bucket axis (cached
under a `|vmap:{axes}` key; gram and xtv inside are one batched launch
each); a host op (`quantile`) in the variant suffix loops over the true
configs on the host and is padded back into the bucket.

Serving lane (`replay_batch`, behind `repro_torch.serving.ModelServer`):
a serving `BatchedPlan` (`PreparedScript.prepare_batched`) replays k
stacked requests through the same vmapped closures, padded to a
power-of-two bucket; request leaves are bound per call, never through
the global leaf registry, and reuse probes key on the request content.

Fault policy (`repro_torch.core.faults`, metered in `stats.faults`): a
segment whose closure build fails (`CompileFailedError`) runs its
instructions through the `fuse=False` interpreter's kernels and counts
one degradation; vmapped segments re-raise, as in the reference.

Not ported yet (each refuses rather than degrading silently): federated
execution (ROADMAP Queue 1 item 8), the asynchronous pipeline (item 10)
and sharded execution (item 12), which also takes the reference's
bucket-axis sharding (`mode="shard"` runs as plain vmap, as the
reference does without a mesh).

`PreparedScript` is the JMLC analogue: trace a python function once into
a DAG with placeholder leaves, then re-execute with new in-memory inputs
(plan compiled once; lineage recomputed per input so reuse stays sound).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from . import backend, costmodel, faults
from .compiler import Plan, compile_plan
from .dag import LEAVES, LTensor, Node, _fingerprint, _lhash_rec, input_tensor
from .faults import CompileFailedError, FaultLog
from .jit_cache import get_jit_cache
from .reuse import ReuseCache
from .reuse import nbytes as _reuse_nbytes


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
    its single dispatcher thread (and, for `rejected`/`queue_peak`, under
    its queue lock)."""

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
class RuntimeStats:
    instructions: int = 0
    executed: int = 0      # instructions actually computed (not reused)
    reused: int = 0
    exec_time: float = 0.0
    segments: int = 0        # segments dispatched on the fused path
    batched_segments: int = 0  # vmapped config-variant segments (parfor)
    jit_cache_hits: int = 0  # warm cached-closure lookups
    trace_time: float = 0.0  # seconds spent building segment closures
    # request-path meter, populated when this runtime backs a
    # `repro_torch.serving.ModelServer`
    serving: ServingLog = field(default_factory=ServingLog)
    # out-of-core streaming meter, populated by chunked plans
    streaming: StreamLog = field(default_factory=StreamLog)
    # fault-policy meter (`repro_torch.core.faults`): injections
    # observed, retries, degradations, serving sheds and restarts, plus
    # the dispatch latency monitor
    faults: FaultLog = field(default_factory=FaultLog)

    def as_dict(self):
        """The reference's keys; each meter appears only when non-zero,
        as there. The exchange/shard/pipeline meters belong to lanes not
        ported, so they never appear."""
        out = dict(instructions=self.instructions, executed=self.executed,
                   reused=self.reused, exec_time_s=round(self.exec_time, 6),
                   segments=self.segments,
                   batched_segments=self.batched_segments,
                   jit_cache_hits=self.jit_cache_hits,
                   trace_time_s=round(self.trace_time, 6))
        if self.serving.total:
            out["serving"] = self.serving.as_dict()
        if self.streaming.total:
            out["streaming"] = self.streaming.as_dict()
        if self.faults.total:
            out["faults"] = self.faults.as_dict()
        out["jit_cache"] = get_jit_cache().stats.as_dict()
        return out


@dataclass
class _BatchCtx:
    """Execution context of a batched (`parfor`) plan: which value uids
    carry the leading config axis, and how wide the padded axis is."""

    bplan: Any                 # repro_torch.core.batching.BatchedPlan
    batch: int                 # true number of configurations (k)
    bucket: int                # padded batch width (power-of-two)
    bvals: frozenset           # uids with a leading batch axis


def _pad_axis0(t: torch.Tensor, bucket: int) -> torch.Tensor:
    """Re-pad a true-k host-op result back to the bucket width (repeating
    the last config, like `batching.pad_batch`) so it slots into the
    downstream vmapped closures built for the bucket."""
    pad = bucket - t.shape[0]
    if pad <= 0:
        return t
    return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])


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
        costmodel.pipeline_depth()  # refuses an async depth up front
        values, lin = self._bind_leaves(plan, leaf_values, leaf_lineage)
        if self.fuse:
            self._run_segments(plan, values, lin)
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
        costmodel.pipeline_depth()  # refuses an async depth up front
        plan = bplan.plan
        bctx = _BatchCtx(bplan=bplan, batch=bplan.batch,
                         bucket=bplan.bucket,
                         bvals=bplan.batched_value_uids)
        leaf_values = {
            uid: pad_batch(np.asarray(LEAVES.values[uid]), bplan.bucket)
            for uid in bplan.batched_leaf_uids}
        values, lin = self._bind_leaves(plan, leaf_values, None)
        self._run_segments(plan, values, lin, bctx=bctx)
        return self._unpack_batch(plan, values, bctx)

    @staticmethod
    def _unpack_batch(plan: Plan, values: dict[int, Any],
                      bctx: _BatchCtx) -> list[list[np.ndarray]]:
        """Split a batched run's outputs into one list per config, in
        order, with the bucket padding sliced off."""
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
        costmodel.pipeline_depth()  # refuses an async depth up front
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
        self._run_segments(plan, values, lin, bctx=bctx)
        return self._unpack_batch(plan, values, bctx)

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
        loop sparsifies and uploads one bucket at a time."""
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
            t0 = time.perf_counter()
            out = self._exec_one(ins, values, fmts)
            self.stats.executed += 1
            self.stats.exec_time += time.perf_counter() - t0
            values[ins.out_id] = out
            if lhash is not None:
                # compile-time admission and estimated cost: identical
                # across fuse modes (see the reference)
                self.cache.put(lhash, out, ins.est_cost_s, gated=False)
            self._free(values, ins.last_use_of)

    # ------------------------------------------------------------------
    def _run_segments(self, plan: Plan, values: dict[int, Any],
                      lin: dict[int, str],
                      bctx: Optional[_BatchCtx] = None) -> None:
        """Segment executor: maximal fusable runs replayed through cached
        closures. With an active reuse cache, probe points are
        segment-final: the cache is probed before a probe-final segment
        runs — a hit skips the whole segment — and populated from its
        output afterwards.

        With a `_BatchCtx` (batched `parfor` plans), segmentation is
        variance-aware and config-variant segments run as
        `torch.func.vmap` closures over the padded batch axis, cached
        under a vmap-tagged key so they never collide with the
        unbatched closure of the same segment body."""
        reuse = self.cache is not None
        segments = (bctx.bplan.segments_for(reuse) if bctx is not None
                    else plan.segments_for(reuse))
        fmts = plan.formats_for(self.sparse_inputs)
        jcache = get_jit_cache()
        lmemo: dict[int, str] = {}
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
                                          lin, lmemo, jcache)
                self._free(values, seg.frees)
                continue
            if batched:
                axes = "".join("0" if u in bctx.bvals else "-"
                               for u in seg.input_uids)
                seg_key = f"{seg_key}|vmap:{axes}"
            vctx = bctx if batched else None
            args = [self._arg(values, u) for u in seg.input_uids]
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
                                               values, bctx=vctx)
                    self._free(values, seg.frees)
                    continue
            if last.node.op in backend.NON_TRACEABLE_OPS:
                # host-path segment (always single-instruction): the SAME
                # `_exec_one` the interpreter uses
                t0 = time.perf_counter()
                outs = (self._exec_one(last, values, fmts, bctx=vctx),)
                self.stats.exec_time += time.perf_counter() - t0
                self.stats.executed += 1
            else:
                try:
                    outs = self._execute_cached(
                        seg_key, self._seg_builder(seg, fmts, vctx), args,
                        jcache)
                except CompileFailedError as e:
                    # degradation ladder: a segment whose closure build
                    # failed runs its instructions eagerly through the
                    # fuse=False kernels (parity by construction);
                    # vmapped segments have no eager equivalent and
                    # re-raise
                    e.args = (f"{e.args[0]} [{seg.summary()}]",)
                    if batched:
                        raise
                    outs = self._interpret_segment(seg, values, fmts, e)
                self.stats.executed += len(seg.instructions)
            for uid, val in zip(seg.output_uids, outs, strict=True):
                values[uid] = val
            if lhash is not None:
                self.cache.put(lhash, values[last.out_id],
                               last.est_cost_s, gated=False)
            self._free(values, seg.frees)

    # ------------------------------------------------------------------
    def _seg_builder(self, seg, fmts: dict,
                     bctx: Optional[_BatchCtx] = None,
                     drop_output: Optional[int] = None):
        """Deferred closure builder, only called on a jit-cache miss:
        plain for invariant segments, vmap-wrapped for config-variant
        ones."""
        from .segments import build_batched_segment_fn, build_segment_fn
        if bctx is not None:
            return lambda: build_batched_segment_fn(
                seg, self.device, fmts, bctx.bvals, drop_output=drop_output)
        return lambda: build_segment_fn(seg, self.device, fmts,
                                        drop_output=drop_output)

    # ------------------------------------------------------------------
    def _execute_cached(self, seg_key: str, build_fn, args, jcache):
        """Run one segment closure through the jit cache (lookup, build
        on miss, execute, wait for the device), accounting build and
        execution time. A failed build is raised as `CompileFailedError`
        (the segment loop's degradation ladder) unless the fault policy
        is off."""
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
        outs = exe(*args)
        backend.synchronize(self.device)
        self.stats.exec_time += time.perf_counter() - t0
        return outs

    # ------------------------------------------------------------------
    def _run_compensation(self, seg, seg_key: str, fmts: dict, args,
                          rest: tuple, probe_uid: int, jcache,
                          values: dict[int, Any],
                          bctx: Optional[_BatchCtx] = None) -> None:
        """Execute a probe-hit segment's remaining outputs (the segment
        with the cached value dead-code eliminated)."""
        try:
            outs = self._execute_cached(
                f"{seg_key}|comp",
                self._seg_builder(seg, fmts, bctx, drop_output=probe_uid),
                args, jcache)
        except CompileFailedError as e:
            e.args = (f"{e.args[0]} [{seg.summary()}]",)
            if bctx is not None:
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
                             jcache) -> None:
        """Streaming executor for a chunked-target segment (the
        synchronous loop of `repro.core.runtime._run_chunked_segment`).

        The segment's sliced inputs (`plan.chunk_sliced`) stay on the
        host and are visited in row buckets of `costmodel.chunk_rows`
        rows (from the actual per-row payload, a bcoo leaf charged its
        sparse data + int32 index bytes); each bucket is sparsified where
        the plan pins the leaf to bcoo and uploaded,
        the segment closure runs on it, and its partial aggregates come
        back to host numpy, where they are summed. The bucket size is a
        power of two independent of the total row count, so every full
        bucket shares one cached closure and appending rows never shifts
        the earlier bucket boundaries.

        Reuse happens at two granularities, as in the reference: every
        probe-flagged output is probed before any bucket runs (all hits
        skip the stream), and each bucket's partial tuple is cached under
        a key of the segment, the row range and content fingerprints of
        the bucket's slices (plus the replicated operands), so appending
        or correcting rows recomputes only the affected buckets."""
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
        # (leaves are kept host-dense by _bind_leaves)
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

        for s in range(0, rows, c):
            e = min(s + c, rows)
            parts, ckey, live = None, None, 0
            if reuse:
                t0 = time.perf_counter()
                fps = ",".join(_fingerprint(host[u][s:e]) for u in sliced)
                log.fingerprint_s += time.perf_counter() - t0
                ckey = hashlib.sha1(
                    f"chunkpart|{seg_key}|{s}:{e}|{rep_fp}|{fps}"
                    .encode()).hexdigest()
                parts = self.cache.probe(ckey)
                if parts is not None:
                    log.chunks_reused += 1
            if parts is None:
                t0 = time.perf_counter()
                args = []
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
                # partials come back to HOST arrays, as in the reference:
                # their only consumer is the `combine` boundary, and host
                # adds keep warm (all-buckets-reused) runs off the device
                parts = tuple(backend.to_numpy(o) for o in outs)
                log.upload_s += t1 - t0
                log.dispatch_s += t2 - t1
                log.download_s += time.perf_counter() - t2
                log.chunks += 1
                log.bytes_streamed += live
                if ckey is not None:
                    self.cache.put(ckey, parts, cost_each, gated=False)
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
            log.combine_s += time.perf_counter() - t0
            acc_bytes = sum(_reuse_nbytes(v) for v in accs.values()
                            if v is not None)
            log.peak_live_bytes = max(log.peak_live_bytes, live + acc_bytes)
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

    # ------------------------------------------------------------------
    def _exec_one(self, ins, values: dict[int, Any], fmts: dict,
                  bctx: Optional[_BatchCtx] = None):
        """Execute one instruction eagerly and wait for the device — the
        single implementation shared by the interpreter loop and the
        segment executor's host path.

        `bctx` (batched plans) marks operands carrying the config axis:
        a host op (quantile) loops over the TRUE k configs on the host
        (order statistics on concrete values cannot vmap) and its
        result is padded back into the bucket, never recomputed for the
        padding configs."""
        kern = backend.kernel_for_node(
            ins.node, self.device,
            in_fmts=tuple(fmts.get(u, backend.DENSE)
                          for u in ins.input_ids),
            out_fmt=fmts.get(ins.out_id, backend.DENSE))
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
