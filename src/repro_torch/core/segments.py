"""Segmentation pass: instruction stream -> maximal fusable segments.

Port of `repro.core.segments` for every lane (local, federated, sharded,
chunked, batched). The topologically ordered instruction list produced
by `compile_plan` is
partitioned into *segments*, each of which lowers to one closure over
the `repro_torch.core.backend` kernel registry, cached in
`repro_torch.core.jit_cache` under the segment's structural key.

Segment boundaries are forced by:

  * reuse-probe points — with an active `ReuseCache`, instructions whose
    compile-time cost estimate clears the cache's worth-keeping
    threshold end their segment so the probed value stays observable
    (except in the chunked lane, whose streaming executor probes every
    probe-flagged output itself);
  * execution-target changes — `local`, `distributed`, `federated` and
    `chunked` instructions never share a segment (scalar generators are
    target-neutral and join either side). A `chunked` segment is run by
    the streaming executor once per row bucket;
  * shard-exec flips — instructions lowered for the device mesh
    (`placement='sharded'` values, `shard_*` reduces, `reshard`
    boundaries) never share a segment with memory-based `distributed`
    instructions; a maximal shard-exec run lowers to ONE sharded closure
    (`build_sharded_segment_fn`) that runs the whole chain — row-wise
    riders, per-shard partial reduce, the sum over the shards — over the
    mesh's logical devices in lockstep;
  * non-traceable ops — anything in `backend.NON_TRACEABLE_OPS` (the
    `fed_*` / `collect` site orchestration and the host `quantile`) runs
    in its own segment, on the host path;
  * config-variance flips — for batched plans
    (`repro_torch.core.batching`), instructions whose value carries the
    batch axis (`variant_uids`) never share a segment with
    config-invariant ones: the invariant prefix runs ordinary closures
    (shared with single-config plans through the closure cache) ONCE
    per grid, while variant segments are wrapped in `torch.func.vmap`
    by the runtime (`build_batched_segment_fn`).

The segmentation rules and the canonical structural key are the
reference's, so the same plan yields the same segments and the same
keys in both packages (`Plan.explain()` prints them).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import torch

from . import backend
from .dag import Node, structural_key

if TYPE_CHECKING:  # avoid circular import; Plan imports this lazily
    from .compiler import Plan


@dataclass
class Segment:
    """A maximal fusable run of instructions."""

    index: int
    instructions: list
    input_uids: tuple[int, ...]   # external values read (leaves or earlier
                                  # segment outputs), first-use order
    output_uids: tuple[int, ...]  # values that must be observable outside
                                  # (plan outputs + cross-segment uses)
    output_nodes: tuple[Node, ...]
    frees: tuple[int, ...]        # uids dead after this segment
    target: str                   # 'local' | 'distributed' | 'federated'
                                  # | 'chunked'
    key: str                      # canonical structural hash
    variant: bool = False         # carries the config batch axis (vmapped)
    sharded: bool = False         # shard-exec lane: run per shard over
                                  # the device mesh's data axis
    chunked: bool = False         # streaming lane: the runtime dispatches
                                  # this closure once per row chunk and
                                  # sums the partial aggregates

    @property
    def fused(self) -> bool:
        return len(self.instructions) > 1

    def donatable_positions(self) -> tuple[int, ...]:
        """Argument positions that are donation *candidates*: inputs
        whose uid this segment frees — i.e. it is their compile-time
        last consumer, so after dispatch nothing in the plan can read
        them again. The structural half of the donation decision; the
        runtime intersects it with run-time ownership (only tensors
        produced by segment closures this run and not referenced by the
        reuse cache may be donated — see
        `LineageRuntime._donation_mask`)."""
        dead = set(self.frees)
        return tuple(i for i, u in enumerate(self.input_uids)
                     if u in dead)

    def summary(self) -> str:
        """One-line human identity of this segment, with its lanes
        (`+vmap` for a config-variant segment, `+shard` for a sharded
        one, `+chunk` for a streamed one), for error messages where the
        structural hash alone tells an operator nothing."""
        ops = [ins.node.op for ins in self.instructions]
        shown = ",".join(ops[:6]) + (",…" if len(ops) > 6 else "")
        lanes = "".join(tag for flag, tag in
                        ((self.variant, "+vmap"), (self.sharded, "+shard"),
                         (self.chunked, "+chunk")) if flag)
        return (f"segment#{self.index}[{self.target}{lanes}] "
                f"ops={shown} ins={len(self.instructions)}")


def _target_neutral(ins) -> bool:
    """Scalar generators (literals, folded constants) cost nothing on any
    target; letting them join either side keeps heavy runs contiguous."""
    return not ins.input_ids and ins.node.shape == ()


def _shard_exec(ins) -> bool:
    """Instruction executes on the device mesh (inside a sharded
    closure): either its value keeps the row-sharded placement or it is
    one of the explicit shard-exec ops (per-shard reduce + sum,
    reshard)."""
    return (ins.node.placement == "sharded"
            or ins.node.op in backend.SHARD_EXEC_OPS)


def _segment_key(instructions, input_uids, output_positions,
                 target: str) -> str:
    """Uid-independent structural hash of the segment's computation:
    external inputs are seeded into the `structural_key` memo by
    position, and the exported positions are part of the key."""
    memo = {uid: f"@in{i}" for i, uid in enumerate(input_uids)}
    body = ";".join(structural_key(ins.node, memo) for ins in instructions)
    outs = ",".join(str(p) for p in output_positions)
    return hashlib.sha1(
        f"seg1|{target}|{body}|outs={outs}".encode()).hexdigest()


def segment_plan(plan: "Plan", reuse_active: bool,
                 variant_uids: Optional[frozenset[int]] = None
                 ) -> list[Segment]:
    """Partition `plan.instructions` into segments (pure, static).

    `variant_uids` (batched plans only) forces boundaries where the
    config-variance of adjacent instructions differs — target-neutral
    scalar generators still join either side; inside a vmapped segment
    they run unbatched, so letting them ride along costs nothing."""
    def is_var(ins) -> bool:
        return variant_uids is not None and ins.out_id in variant_uids

    groups: list[list] = []
    group_targets: list[str] = []
    group_variant: list[bool] = []
    group_sharded: list[bool] = []
    cur_target: Optional[str] = None  # None while the group is all-neutral
    cur_variant: Optional[bool] = None
    cur_sharded: Optional[bool] = None
    for ins in plan.instructions:
        neutral = _target_neutral(ins)
        start_new = (
            not groups
            # a probe point must be segment-final so its value is
            # observable for cache probe/put — except in the chunked
            # lane, where the streaming executor probes every
            # probe-flagged segment OUTPUT itself
            or (reuse_active and groups[-1][-1].probe
                and groups[-1][-1].target != "chunked")
            or groups[-1][-1].node.op in backend.NON_TRACEABLE_OPS
            or ins.node.op in backend.NON_TRACEABLE_OPS
            or (not neutral and cur_target is not None
                and ins.target != cur_target)
            or (not neutral and cur_variant is not None
                and is_var(ins) != cur_variant)
            # shard-exec instructions never fuse with memory-based
            # 'distributed' instructions: the former run per shard, the
            # latter on whole values
            or (not neutral and cur_sharded is not None
                and _shard_exec(ins) != cur_sharded))
        if start_new:
            groups.append([ins])
            group_targets.append(ins.target)
            group_variant.append(is_var(ins))
            group_sharded.append(_shard_exec(ins))
            cur_target = None if neutral else ins.target
            cur_variant = None if neutral else is_var(ins)
            cur_sharded = None if neutral else _shard_exec(ins)
        else:
            groups[-1].append(ins)
            if not neutral and cur_target is None:
                cur_target = ins.target
                group_targets[-1] = ins.target
            if not neutral and cur_variant is None:
                cur_variant = is_var(ins)
            if not neutral and cur_sharded is None:
                cur_sharded = _shard_exec(ins)
                group_sharded[-1] = _shard_exec(ins)
            if is_var(ins):
                group_variant[-1] = True

    consumer_segs: dict[int, set[int]] = {}
    for si, group in enumerate(groups):
        for ins in group:
            for uid in ins.input_ids:
                consumer_segs.setdefault(uid, set()).add(si)

    out_ids = set(plan.output_ids)
    segments: list[Segment] = []
    for si, group in enumerate(groups):
        in_group = {ins.out_id for ins in group}
        input_uids: list[int] = []
        seen_in: set[int] = set()
        for ins in group:
            for uid in ins.input_ids:
                if uid not in in_group and uid not in seen_in:
                    seen_in.add(uid)
                    input_uids.append(uid)
        consumed_elsewhere = {uid for uid, segs in consumer_segs.items()
                              if segs - {si}}
        output_uids, output_nodes, output_positions = [], [], []
        for pos, ins in enumerate(group):
            if ins.out_id in out_ids or ins.out_id in consumed_elsewhere:
                output_uids.append(ins.out_id)
                output_nodes.append(ins.node)
                output_positions.append(pos)
        frees: list[int] = []
        seen_f: set[int] = set()
        for ins in group:
            for uid in ins.last_use_of:
                # purely segment-internal values never materialize in the
                # runtime environment; only report frees of visible values
                if uid in in_group and uid not in output_uids:
                    continue
                if uid not in seen_f:
                    seen_f.add(uid)
                    frees.append(uid)
        segments.append(Segment(
            index=si, instructions=list(group),
            input_uids=tuple(input_uids),
            output_uids=tuple(output_uids),
            output_nodes=tuple(output_nodes),
            frees=tuple(frees),
            target=group_targets[si],
            key=_segment_key(group, input_uids, output_positions,
                             group_targets[si]
                             + ("+sh" if group_sharded[si] else "")),
            variant=group_variant[si],
            sharded=group_sharded[si],
            chunked=group_targets[si] == "chunked"))
    return segments


def _steps(seg: Segment, device: torch.device,
           formats: Optional[dict[int, str]], out_uids: tuple,
           unshard: bool = False) -> list:
    """(out uid, input uids, kernel) for each instruction `out_uids`
    need — every one unless an output was dropped, whose exclusive
    producers are dead-code eliminated — with each kernel selected from
    the compile-time formats of its inputs and output."""
    fmts = formats or {}
    instructions = seg.instructions
    if len(out_uids) < len(seg.output_uids):
        needed = set(out_uids)
        keep = []
        for ins in reversed(seg.instructions):
            if ins.out_id in needed:
                keep.append(ins)
                needed.update(ins.input_ids)
        instructions = keep[::-1]
    return [(ins.out_id, ins.input_ids,
             backend.kernel_for_node(
                 ins.node, device,
                 in_fmts=tuple(fmts.get(u, backend.DENSE)
                               for u in ins.input_ids),
                 out_fmt=fmts.get(ins.out_id, backend.DENSE),
                 unshard=unshard))
            for ins in instructions]


def build_segment_fn(seg: Segment, device: torch.device,
                     formats: Optional[dict[int, str]] = None,
                     drop_output: Optional[int] = None,
                     donate: tuple[int, ...] = (), unshard: bool = False):
    """Lower a segment to one closure over the kernel registry.

    The result takes the segment's external inputs positionally (order of
    `seg.input_uids`, as tensors on `device`) and returns the tuple of
    `seg.output_uids` values. It runs the kernels eagerly in instruction
    order — the same calls, in the same order, as the per-instruction
    interpreter, which is why `fuse=True` and `fuse=False` agree bit for
    bit. Each step's kernel is selected from the compile-time formats
    (`formats`: uid -> 'dense' | 'bcoo', absent meaning dense) of its
    inputs and output, so BCOO values flow through the closure.

    `drop_output` builds the *compensation* variant used on a reuse-cache
    hit in a multi-output segment: the given uid (served from the cache)
    is removed from the outputs and every instruction not needed for the
    remaining ones is dead-code eliminated.

    `donate` builds the *donating* variant (pipeline depth >= 2, see
    `LineageRuntime._donation_mask`): it takes ONE argument, the list of
    inputs, and clears each donated position of that list right after
    the step that reads it last, so with the caller's own references
    dropped the caching allocator can hand the block to a later output
    of the same segment. The kernels, their order and so the bits are
    those of the plain closure.

    `unshard` builds the local-equivalent variant of a sharded segment
    (the mesh does not resolve at run time): shard-exec kernels are
    swapped for their single-device base ops (`backend.SHARD_BASE_OPS`;
    `reshard` becomes the identity), so the closure computes the same
    global values without splitting anything.
    """
    out_uids = tuple(u for u in seg.output_uids if u != drop_output)
    steps = _steps(seg, device, formats, out_uids, unshard)
    in_pos = {uid: i for i, uid in enumerate(seg.input_uids)}

    if not donate:
        def run(*args):
            env: dict[int, object] = {}
            for out_id, input_ids, kern in steps:
                env[out_id] = kern(*[env[u] if u in env
                                     else args[in_pos[u]]
                                     for u in input_ids])
            return tuple(env[u] for u in out_uids)

        return run

    last_read = {p: -1 for p in donate}
    for k, (_, input_ids, _) in enumerate(steps):
        for u in input_ids:
            p = in_pos.get(u)
            if p in last_read:
                last_read[p] = k
    release: list[list[int]] = [[] for _ in range(len(steps) + 1)]
    for p, k in last_read.items():
        release[k + 1].append(p)  # k = -1: never read, released first

    def run_donating(box: list):
        for p in release[0]:
            box[p] = None
        env: dict[int, object] = {}
        for k, (out_id, input_ids, kern) in enumerate(steps):
            env[out_id] = kern(*[env[u] if u in env else box[in_pos[u]]
                                 for u in input_ids])
            for p in release[k + 1]:
                box[p] = None
        return tuple(env[u] for u in out_uids)

    return run_donating


def build_batched_segment_fn(seg: Segment, device: torch.device,
                             formats: Optional[dict[int, str]],
                             batched_uids: frozenset,
                             drop_output: Optional[int] = None):
    """Lower a config-variant segment to one `torch.func.vmap`-wrapped
    closure.

    Inputs carrying the batch axis (batched leaves and earlier variant
    segment outputs — `batched_uids`) map over dim 0; config-invariant
    inputs broadcast (`in_dims` None), so the prefix's gram/xtv is
    computed once and shared across the whole batch. Outputs mirror the
    same split. gram and xtv are custom ops with a vmap rule
    (`repro_torch.kernels.gram.ops`): under this closure each is ONE
    batched launch over the bucket, not one launch a config. The result
    is cached through the ordinary closure cache (with a vmap-tagged
    key, see the runtime)."""
    fn = build_segment_fn(seg, device, formats, drop_output=drop_output)
    out_uids = tuple(u for u in seg.output_uids if u != drop_output)
    in_dims = tuple(0 if u in batched_uids else None
                    for u in seg.input_uids)
    out_dims = tuple(0 if u in batched_uids else None for u in out_uids)
    return torch.func.vmap(fn, in_dims=in_dims, out_dims=out_dims)


def shard_specs(seg: Segment) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """Per-boundary shard specs of a sharded segment.

    Returns ('s'/'r' tag per external input, same per output). Input
    tags come from the consumers' compile-time `sin` attrs (written by
    `compiler.lower_distributed`): 's' = split on the mesh's data axis
    (leading dim), 'r' = replicated. Untouched inputs (only consumed by
    ops without a `sin`, e.g. literals feeding a neutral rider) default
    to replicated. Output tags follow the value's placement: a `sharded`
    output leaves the segment still row-split; everything else (summed
    values, reshard results) is replicated.
    """
    tags: dict[int, str] = {}
    for ins in seg.instructions:
        sin = ins.node.attr("sin")
        if not sin:
            continue
        for uid, tag in zip(ins.input_ids, sin):
            prev = tags.setdefault(uid, tag)
            if prev != tag:
                raise ValueError(
                    f"conflicting shard specs for value %{uid} in "
                    f"segment {seg.index}: {prev!r} vs {tag!r}")
    in_tags = tuple(tags.get(u, "r") for u in seg.input_uids)
    out_tags = tuple("s" if n.placement == "sharded" else "r"
                     for n in seg.output_nodes)
    return in_tags, out_tags


def split_rows(x: torch.Tensor, d: int) -> backend.Shards:
    """`x`'s rows as d equal blocks in order: views (`narrow`), no copy."""
    r = x.shape[0] // d
    return backend.Shards(x.narrow(0, i * r, r) for i in range(d))


def build_sharded_segment_fn(seg: Segment, device: torch.device,
                             formats: Optional[dict[int, str]], d: int,
                             drop_output: Optional[int] = None):
    """Lower a shard-exec segment to one closure that runs it in lockstep
    over the mesh's `data` axis (the reference's `shard_map` over the
    same specs, as one process over the mesh's logical devices).

    Inputs tagged 's' are split into `d` row blocks (the mesh's `data`
    axis; views, no copy); every row-preserving instruction runs its
    ordinary kernel on each block, in shard order; the shard reduces run
    their base op's
    kernel on each block and sum the partials in shard order, and
    `reshard` concatenates the blocks (`backend._lockstep_reduce`, the
    `reshard` kernel) — the only cross-shard steps, exactly the
    exchanges the cost model priced when it accepted the lowering.
    Outputs tagged 's' leave the closure concatenated into one global
    tensor."""
    in_tags, out_tags = shard_specs(seg)
    outs = [(u, t) for u, t in zip(seg.output_uids, out_tags)
            if u != drop_output]
    steps = _steps(seg, device, formats, tuple(u for u, _ in outs))
    collective = {ins.out_id for ins in seg.instructions
                  if ins.node.op in backend.SHARD_EXEC_OPS}

    def run(*args):
        env: dict[int, object] = {
            uid: split_rows(a, d) if t == "s" else a
            for uid, t, a in zip(seg.input_uids, in_tags, args)}
        for out_id, input_ids, kern in steps:
            xs = [env[u] for u in input_ids]
            if out_id in collective or not any(
                    isinstance(x, backend.Shards) for x in xs):
                env[out_id] = kern(*xs)
            else:
                env[out_id] = backend.Shards(
                    kern(*[x[i] if isinstance(x, backend.Shards) else x
                           for x in xs]) for i in range(d))
        return tuple(torch.cat(list(env[u])) if t == "s" else env[u]
                     for u, t in outs)

    return run


def build_config_sharded_segment_fn(seg: Segment, device: torch.device,
                                    formats: Optional[dict[int, str]],
                                    batched_uids: frozenset, c: int,
                                    drop_output: Optional[int] = None):
    """Lower a config-variant segment to the vmapped closure run once per
    slice of the bucket axis over the mesh's `config` axis (`c` logical
    devices): each takes bucket/c configs (batched inputs split along dim 0, in
    order; config-invariant inputs shared), and the stacked outputs are
    concatenated in order. No cross-slice step — the configs are
    embarrassingly parallel; a config-invariant output is the first
    slice's."""
    fn = build_batched_segment_fn(seg, device, formats, batched_uids,
                                  drop_output=drop_output)
    out_uids = tuple(u for u in seg.output_uids if u != drop_output)
    split = tuple(u in batched_uids for u in seg.input_uids)
    stacked = tuple(u in batched_uids for u in out_uids)

    def run(*args):
        parts = list(zip(*[
            fn(*[a.chunk(c)[j] if s else a for a, s in zip(args, split)])
            for j in range(c)]))
        return tuple(torch.cat(p) if s else p[0]
                     for p, s in zip(parts, stacked))

    return run
