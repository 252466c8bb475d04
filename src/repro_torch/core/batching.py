"""Task-parallel batched execution (SystemDS §5 `parfor`).

Port of `repro.core.batching`. Takes k structurally
identical HOP DAGs that differ only in scalar literals and/or leaf
bindings — a λ grid, CV fold selections, seeds — and compiles them into
ONE plan over a *template* DAG:

  * varying scalars / leaves are hoisted into batched leaves
    (`dag.batch_input`: the node keeps the per-config element shape,
    the binding is the stacked ``(k,) + shape`` array);
  * the template compiles through the ordinary stack (rewrites →
    format assignment → segmentation), once, instead of k times;
  * instructions are split into a **config-invariant prefix** (no
    batched leaf in their transitive inputs — gram/xtv computed once
    and broadcast into the batch) and a **config-variant suffix**, which
    the runtime executes through `torch.func.vmap` over the batch axis
    (`LineageRuntime.evaluate_batch`); gram and xtv under vmap are one
    batched launch each (`repro_torch.kernels.gram.ops`);
  * the batch axis is padded up to a power-of-two *bucket* (pad rows
    repeat the last config) so a growing grid re-uses warm cached
    closures instead of rebuilding per k.

`choose_mode` is the cost-model arbitration, with the reference's gates
and constants, so both packages choose the same mode for the same plan.

The serving half (`compile_serving`, `stack_requests`) traces one scoring
function over batched request leaves instead of merging k DAGs; the
runtime replays it at any batch size (`LineageRuntime.replay_batch`).

The user-facing entry points are `repro_torch.lifecycle.validation.parfor`
and `repro_torch.serving.ModelServer`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from . import costmodel
from .compiler import Plan, compile_plan
from .dag import LEAVES, LTensor, Node, batch_input, is_batched_leaf


class BatchingError(ValueError):
    """The k configuration plans cannot be merged into one template
    (structural mismatch, unstackable leaves, ...). Callers fall back
    to the sequential per-config path."""


def bucket_size(k: int) -> int:
    """Batch sizes are bucketed to powers of two (min 2) so growing
    grids hit warm closures: k=9..16 all build for 16."""
    return 2 if k <= 2 else 1 << (k - 1).bit_length()


# ---------------------------------------------------------------------------
# Template extraction: k DAGs -> one DAG with batched leaves
# ---------------------------------------------------------------------------

def merge_roots(roots_list: Sequence[Sequence[Node]]
                ) -> tuple[list[Node], frozenset[int], int]:
    """Canonicalize k per-config root lists into one template.

    Walks the k DAGs in lockstep. Positions where all configs share a
    node (same uid) — or rebuild the same structure over shared leaves
    — stay as-is (config-invariant). Positions that differ are hoisted:

      * literals with differing values  -> batched scalar leaf
      * input leaves with differing uids -> batched leaf stacking the
        k bound arrays (shapes/dtypes must agree)
      * `rand` generators differing only in their seed -> batched leaf
        of the k draws

    Any other divergence (different op/attrs/shape, unstackable
    bindings) raises `BatchingError`.

    Returns (template_roots, batched_leaf_uids, k).
    """
    k = len(roots_list)
    if k < 2:
        raise BatchingError("batching needs >= 2 configurations")
    n_out = {len(r) for r in roots_list}
    if len(n_out) != 1:
        raise BatchingError(f"configs produce differing output counts {n_out}")

    memo: dict[tuple[int, ...], Node] = {}
    batched: set[int] = set()

    def hoist_literals(nodes: tuple[Node, ...]) -> Node:
        vals = [float(n.attr("value")) for n in nodes]
        dtype = np.result_type(*(n.dtype for n in nodes))
        leaf = batch_input(None, np.asarray(vals, dtype=dtype))
        batched.add(leaf.node.uid)
        return leaf.node

    def hoist_rand(nodes: tuple[Node, ...]) -> Node:
        """Seed grids: `rand` generators differing only in their seed
        are drawn per config (the same bit-exact kernel the sequential
        path runs in-plan; drawn on the host, since the draw is the
        same on every device) and stacked into a batched leaf."""
        from . import backend
        cpu = torch.device("cpu")
        arrays = [backend.to_numpy(backend.kernel_for_node(n, cpu)())
                  for n in nodes]
        leaf = batch_input("seeds", np.stack(arrays, axis=0),
                           sparsity=max(n.sparsity for n in nodes))
        batched.add(leaf.node.uid)
        return leaf.node

    def hoist_leaves(nodes: tuple[Node, ...]) -> Node:
        arrays = []
        for n in nodes:
            v = LEAVES.values.get(n.uid)
            if v is None or not isinstance(v, np.ndarray):
                raise BatchingError(
                    f"leaf {n.attr('name')!r} has no stackable binding "
                    f"({type(v).__name__})")
            arrays.append(v)
        shapes = {a.shape for a in arrays}
        if len(shapes) != 1:
            raise BatchingError(
                f"varying leaves have differing shapes {sorted(shapes)}")
        stacked = np.stack(arrays, axis=0)
        sp = max(n.sparsity for n in nodes)
        leaf = batch_input(nodes[0].attr("name"), stacked, sparsity=sp)
        batched.add(leaf.node.uid)
        return leaf.node

    def merge(nodes: tuple[Node, ...]) -> Node:
        first = nodes[0]
        if all(n.uid == first.uid for n in nodes):
            return first  # literally shared across configs
        key = tuple(n.uid for n in nodes)
        got = memo.get(key)
        if got is not None:
            return got
        if any(n.op != first.op for n in nodes):
            raise BatchingError(
                f"structural mismatch: {sorted({n.op for n in nodes})}")
        if any(n.shape != first.shape or n.dtype != first.dtype
               for n in nodes):
            raise BatchingError(
                f"op {first.op!r} differs in shape/dtype across configs")
        if first.op == "literal":
            vals = {n.attr("value") for n in nodes}
            out = first if len(vals) == 1 else hoist_literals(nodes)
        elif first.op == "input":
            out = hoist_leaves(nodes)
        elif (first.op == "rand"
              and len({n.attr("seed") for n in nodes}) > 1
              and len({tuple(kv for kv in n.attrs if kv[0] != "seed")
                       for n in nodes}) == 1):
            # identical-seed rand nodes fall through to the generic
            # branch below and stay config-invariant
            out = hoist_rand(nodes)
        else:
            if any(n.attrs != first.attrs for n in nodes):
                raise BatchingError(
                    f"op {first.op!r} differs in attrs across configs")
            children = tuple(
                merge(tuple(n.inputs[i] for n in nodes))
                for i in range(len(first.inputs)))
            if all(c is i for c, i in zip(children, first.inputs)):
                out = first
            else:
                out = Node(op=first.op, inputs=children, attrs=first.attrs,
                           shape=first.shape, dtype=first.dtype,
                           sparsity=max(n.sparsity for n in nodes),
                           placement=first.placement)
        memo[key] = out
        return out

    template = [merge(tuple(roots[i] for roots in roots_list))
                for i in range(n_out.pop())]
    return template, frozenset(batched), k


# ---------------------------------------------------------------------------
# BatchedPlan: a Plan plus the config axis
# ---------------------------------------------------------------------------

@dataclass
class BatchedPlan:
    """A compiled template plan with its batch metadata.

    `variant_uids` marks every instruction whose transitive inputs
    reach a batched leaf — the config-variant suffix the runtime vmaps;
    everything else is the config-invariant prefix, executed exactly
    like an ordinary plan (same closure-cache keys, same reuse probes,
    so repeated grids share warm closures and cached gram/xtv with
    single-config runs).
    """

    plan: Plan
    batch: int                       # k — the true number of configs
    bucket: int                      # padded batch size (power of two)
    batched_leaf_uids: frozenset[int]
    variant_uids: frozenset[int]
    # 'vmap' | 'sequential' | 'shard' (cost-chosen or forced); 'shard'
    # runs as plain vmap here: the port has no device mesh yet (ROADMAP
    # Queue 1 item 12), as the reference degrades without one
    mode: str = "vmap"
    # serving plans (`compile_serving`): batched leaf uids in argument
    # order, so `LineageRuntime.replay_batch` can bind positional
    # request stacks without consulting the global leaf registry
    leaf_order: tuple = ()
    _segments: dict = field(default_factory=dict, repr=False)

    @property
    def batched_value_uids(self) -> frozenset[int]:
        """All uids carrying a leading batch axis at runtime."""
        return self.batched_leaf_uids | self.variant_uids

    def release_leaves(self) -> None:
        """Unbind the hoisted stacked arrays from the global leaf
        registry. `parfor` calls this once the plan has executed (or
        the arbitration fell back to sequential): the (k, ...) stacks
        are parfor-internal temporaries, and leaving one per call in
        `LEAVES` would grow resident memory without bound across a
        long session. After release the plan cannot be re-executed."""
        for uid in self.batched_leaf_uids | set(self.leaf_order):
            LEAVES.values.pop(uid, None)
            LEAVES.lineage.pop(uid, None)

    def segments_for(self, reuse_active: bool):
        """Variance-aware segmentation (memoized): segment boundaries
        additionally break where config-invariant flips to
        config-variant, so the prefix runs ordinary closures and the
        suffix vmapped ones."""
        reuse_active = bool(reuse_active)
        got = self._segments.get(reuse_active)
        if got is None:
            from .segments import segment_plan
            got = segment_plan(self.plan, reuse_active=reuse_active,
                               variant_uids=self.variant_uids)
            self._segments[reuse_active] = got
        return got

    def explain(self, reuse_active: Optional[bool] = None,
                sparse: bool = False) -> str:
        """EXPLAIN dump mirroring `Plan.explain`, annotated with the
        batch structure: hoisted batched leaves, `[config-invariant]`
        prefix segments, and `[batch=k]` vmapped segments."""
        plan = self.plan
        if reuse_active is None:
            reuse_active = plan.reuse_enabled
        fmts = plan.formats_for(sparse)
        lines = [f"batched plan: k={self.batch} bucket={self.bucket} "
                 f"mode={self.mode}"]
        listed: set[int] = set()
        for ins in plan.instructions:
            for inp in ins.node.inputs:
                if inp.uid in self.batched_leaf_uids \
                        and inp.uid not in listed:
                    listed.add(inp.uid)
                    tag = " [hoisted scalar]" if inp.shape == () else ""
                    lines.append(
                        f"%{inp.uid} = batched-leaf '{inp.attr('name')}' "
                        f"k={inp.attr('batch')} elem={inp.shape}{tag}")
        for seg in self.segments_for(reuse_active):
            outs = ",".join(f"%{u}" for u in seg.output_uids)
            kind = "fused" if len(seg.instructions) > 1 else "single"
            tag = (f"[batch={self.batch}]" if seg.variant
                   else "[config-invariant]")
            lines.append(
                f"-- segment {seg.index} [{seg.target}] {kind} "
                f"{len(seg.instructions)} op(s) {tag} "
                f"key={seg.key[:10]} -> {outs}")
            lines.extend(f"  {plan._ins_line(ins, reuse_active, fmts)}"
                         for ins in seg.instructions)
        lines.append("outputs: "
                     + ", ".join(f"%{i}" for i in plan.output_ids))
        return "\n".join(lines)


def _variant_uids(plan: Plan) -> frozenset[int]:
    """Forward pass: an instruction is config-variant iff any transitive
    input is a batched leaf."""
    variant: set[int] = set()
    for ins in plan.instructions:
        for uid, inp in zip(ins.input_ids, ins.node.inputs):
            if uid in variant or is_batched_leaf(inp):
                variant.add(ins.out_id)
                break
    return frozenset(variant)


def compile_batched(config_outputs: Sequence[Sequence[LTensor]], *,
                    reuse_enabled: bool = False,
                    opt_level: int = 2) -> BatchedPlan:
    """Compile k per-config output lists into one `BatchedPlan`.

    Raises `BatchingError` when the configs cannot be merged; callers
    (see `lifecycle.validation.parfor`) fall back to the sequential
    per-config loop.
    """
    roots_list = [[o.node for o in outs] for outs in config_outputs]
    template, _, k = merge_roots(roots_list)
    plan = compile_plan([LTensor(r) for r in template],
                        reuse_enabled=reuse_enabled, opt_level=opt_level)
    return _finalize_bplan(plan, k)


def _finalize_bplan(plan: Plan, k: int) -> BatchedPlan:
    """Wrap a compiled template plan into a `BatchedPlan`.

    Rewrites rebuild nodes but never fold batched leaves (they are
    inputs, not literals) — recompute the reachable batched set and
    variance on the final instruction stream; a batched leaf that is
    itself a plan root (identity configs) has no consuming instruction
    but still carries the batch axis."""
    live_batched = set()
    for ins in plan.instructions:
        for inp in ins.node.inputs:
            if is_batched_leaf(inp):
                live_batched.add(inp.uid)
    for r in plan.roots:
        if is_batched_leaf(r):
            live_batched.add(r.uid)
    return BatchedPlan(plan=plan, batch=k, bucket=bucket_size(k),
                       batched_leaf_uids=frozenset(live_batched),
                       variant_uids=_variant_uids(plan))


def compile_serving(fn, arg_shapes: Sequence[tuple], arg_dtypes=None,
                    arg_sparsities=None, *, reuse_enabled: bool = False,
                    opt_level: int = 2) -> BatchedPlan:
    """Compile a scoring function once into a *serving* `BatchedPlan`.

    The serving counterpart of `compile_batched`, without the
    `merge_roots` pass: every request executes the SAME plan with
    different leaf bindings, so there is nothing to merge — `fn` is
    traced directly over batched placeholder leaves (`dag.batch_input`
    with a ``(1,) + shape`` zero stack, element shape = the declared
    per-request shape). Every transitive consumer of a request leaf is
    request-variant and lowers to vmapped segments; anything else
    (model weights, folded constants) is the request-invariant prefix.

    The returned plan carries `leaf_order` (batched-leaf uid per
    argument position) and is replayed at ANY batch size through
    `LineageRuntime.replay_batch`: batch k and its power-of-two bucket
    are call-time properties — the segment set is k-independent and
    closures re-specialize per bucket via the closure cache's concrete
    argument signature, which is exactly what lets a server warm every
    bucket at deploy time and replay live traffic with zero retraces.

    Placeholder stacks are zeros, so `arg_sparsities` defaults to dense
    (1.0) like `PreparedScript` — formats are declared, not guessed.
    """
    dtypes = list(arg_dtypes) if arg_dtypes is not None \
        else [np.float64] * len(arg_shapes)
    sps = list(arg_sparsities) if arg_sparsities is not None \
        else [1.0] * len(arg_shapes)
    leaves = [
        batch_input(f"req{i}", np.zeros((1,) + tuple(s), dtype=d),
                    sparsity=sp)
        for i, (s, d, sp) in enumerate(zip(arg_shapes, dtypes, sps,
                                           strict=True))]
    outs = fn(*leaves)
    if isinstance(outs, LTensor):
        outs = [outs]
    plan = compile_plan(list(outs), reuse_enabled=reuse_enabled,
                        opt_level=opt_level)
    bplan = _finalize_bplan(plan, 1)
    bplan.bucket = bucket_size(1)
    bplan.leaf_order = tuple(leaf.node.uid for leaf in leaves)
    return bplan


# ---------------------------------------------------------------------------
# Cost-model arbitration: vmapped batch vs sequential-reuse loop
# ---------------------------------------------------------------------------

def choose_mode(bplan: BatchedPlan,
                roots_list: Sequence[Sequence[Node]],
                reuse_active: bool,
                sparse_inputs: bool = False) -> str:
    """Pick 'vmap' or 'sequential' for a batched plan.

    Feasibility gate first: a BCOO format assigned to a config-variant
    value has no vmap path (sparse batch axes are unsupported — the
    invariant prefix may stay sparse). (The reference also sends a
    config-variant federated instruction outside its batchable set
    sequential; the port compiles no federated instruction.)

    Then the cost gate: estimated vmapped cost (launch constants paid
    once, roofline work × bucket, padding waste included) vs the
    sequential-reuse loop (per-config dispatch overhead, cross-config
    cache hits deduplicated). A memory guard rejects suffixes whose
    bucket-replicated intermediates overflow `VMAP_MEM_BUDGET`. The
    reference's third option, sharding the bucket over a mesh's
    `config` axis, needs a mesh (ROADMAP Queue 1 item 12); without one
    it never wins there either.
    """
    plan = bplan.plan
    variant = bplan.variant_uids
    if not variant:
        return "sequential"  # nothing varies — plain loop, full reuse
    var_ins = [i for i in plan.instructions if i.out_id in variant]
    inv_ins = [i for i in plan.instructions if i.out_id not in variant]
    fmts = plan.formats_for(sparse_inputs)
    if any(u in fmts for u in bplan.batched_value_uids):
        return "sequential"
    var_bytes = sum(ins.node.est_bytes() for ins in var_ins)
    if bplan.bucket * var_bytes > costmodel.VMAP_MEM_BUDGET:
        return "sequential"
    bat = costmodel.batched_cost_s([i.node for i in inv_ins],
                                   [i.node for i in var_ins], bplan.bucket)
    seq = costmodel.sequential_cost_s(list(roots_list), reuse_active)
    return "sequential" if seq < bat else "vmap"


def pad_batch(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a stacked (k, ...) array to (bucket, ...) by repeating the
    last configuration — numerically safe for every kernel (duplicate
    λ solves, duplicate folds) and sliced off before results surface."""
    k = arr.shape[0]
    if k >= bucket:
        return arr
    pad = np.repeat(arr[-1:], bucket - k, axis=0)
    return np.concatenate([arr, pad], axis=0)


def stack_requests(request_arg_lists: Sequence[Sequence[np.ndarray]],
                   n_args: int) -> list[np.ndarray]:
    """Stack k per-request argument lists into the one-array-per-arg
    layout `LineageRuntime.replay_batch` consumes."""
    return [np.stack([reqs[i] for reqs in request_arg_lists])
            for i in range(n_args)]
