"""Segmentation pass: instruction stream -> maximal fusable segments.

Port of `repro.core.segments` for the local and chunked lanes. The
topologically ordered instruction list produced by `compile_plan` is
partitioned into *segments*, each of which lowers to one closure over
the `repro_torch.core.backend` kernel registry, cached in
`repro_torch.core.jit_cache` under the segment's structural key.

Segment boundaries are forced by:

  * reuse-probe points — with an active `ReuseCache`, instructions whose
    compile-time cost estimate clears the cache's worth-keeping
    threshold end their segment so the probed value stays observable
    (except in the chunked lane, whose streaming executor probes every
    probe-flagged output itself);
  * execution-target changes — `local`, `distributed` and `chunked`
    instructions never share a segment (scalar generators are
    target-neutral and join either side). A `chunked` segment is run by
    the streaming executor once per row bucket;
  * non-traceable ops — anything in `backend.NON_TRACEABLE_OPS` (the
    host `quantile`) runs in its own segment, on the host path.

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
    target: str                   # 'local' | 'distributed' | 'chunked'
    key: str                      # canonical structural hash
    chunked: bool = False         # streaming lane: the runtime dispatches
                                  # this closure once per row chunk and
                                  # sums the partial aggregates

    @property
    def fused(self) -> bool:
        return len(self.instructions) > 1


def _target_neutral(ins) -> bool:
    """Scalar generators (literals, folded constants) cost nothing on any
    target; letting them join either side keeps heavy runs contiguous."""
    return not ins.input_ids and ins.node.shape == ()


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


def segment_plan(plan: "Plan", reuse_active: bool) -> list[Segment]:
    """Partition `plan.instructions` into segments (pure, static)."""
    groups: list[list] = []
    group_targets: list[str] = []
    cur_target: Optional[str] = None  # None while the group is all-neutral
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
                and ins.target != cur_target))
        if start_new:
            groups.append([ins])
            group_targets.append(ins.target)
            cur_target = None if neutral else ins.target
        else:
            groups[-1].append(ins)
            if not neutral and cur_target is None:
                cur_target = ins.target
                group_targets[-1] = ins.target

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
                             group_targets[si]),
            chunked=group_targets[si] == "chunked"))
    return segments


def build_segment_fn(seg: Segment, device: torch.device,
                     drop_output: Optional[int] = None):
    """Lower a segment to one closure over the kernel registry.

    The result takes the segment's external inputs positionally (order of
    `seg.input_uids`, as tensors on `device`) and returns the tuple of
    `seg.output_uids` values. It runs the kernels eagerly in instruction
    order — the same calls, in the same order, as the per-instruction
    interpreter, which is why `fuse=True` and `fuse=False` agree bit for
    bit.

    `drop_output` builds the *compensation* variant used on a reuse-cache
    hit in a multi-output segment: the given uid (served from the cache)
    is removed from the outputs and every instruction not needed for the
    remaining ones is dead-code eliminated.
    """
    out_uids = tuple(u for u in seg.output_uids if u != drop_output)
    instructions = seg.instructions
    if drop_output is not None:
        needed = set(out_uids)
        keep = []
        for ins in reversed(seg.instructions):
            if ins.out_id in needed:
                keep.append(ins)
                needed.update(ins.input_ids)
        instructions = keep[::-1]
    steps = [(ins.out_id, ins.input_ids,
              backend.kernel_for_node(ins.node, device))
             for ins in instructions]
    in_pos = {uid: i for i, uid in enumerate(seg.input_uids)}

    def run(*args):
        env: dict[int, object] = {}
        for out_id, input_ids, kern in steps:
            env[out_id] = kern(*[env[u] if u in env else args[in_pos[u]]
                                 for u in input_ids])
        return tuple(env[u] for u in out_uids)

    return run
