"""Plan compiler: HOP DAG -> ordered runtime instructions (SystemDS §3.2).

Port of `repro.core.compiler` for the local and chunked lanes: rewrites
+ size propagation happen on the DAG, memory estimates pick an
execution target per instruction, and the result is a topologically
ordered instruction sequence executed by
`repro_torch.core.runtime.LineageRuntime`. The passes, their order and
their cost gates are the reference's, so both packages compile
identical instruction streams (modulo node uids) and identical
`Plan.explain()` text.

Compile-time physical decisions:

  * format assignment (`assign_formats` / `Plan.formats_for`) — values
    are pinned to `dense` or `bcoo` from their sparsity estimates (the
    sparse lane itself is not ported; `sparse=False` maps all-dense);
  * probe-point selection (`Instruction.probe`) — only intermediates
    whose estimated cost clears the reuse cache's worth-keeping
    threshold become lineage-reuse probe points;
  * chunked placement (`lower_chunked`) — row-partitionable reductions
    over leaves exceeding `costmodel.CHUNK_MEM_BUDGET` lower to
    streaming partial aggregates (`chunk_gram`, `chunk_xtv`,
    `chunk_colsums`, `chunk_sum`) closed by an explicit `combine`
    boundary.

Federated leaves and meshes with a `data` axis > 1 (the reference's
`lower_federated` / `lower_distributed`) are refused with
`NotImplementedError` — never silently compiled as local.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import costmodel
from .dag import ELEMENTWISE_BINARY, ELEMENTWISE_UNARY, LTensor, Node, make_node
from .rewrites import run_rewrites

# Default per-operation local memory budget: inputs+output of an op above
# this threshold are flagged `distributed` (the reference's target name;
# the port runs them locally, as the reference does without a mesh).
LOCAL_MEM_BUDGET = 2 << 30


@dataclass
class Instruction:
    node: Node
    out_id: int
    input_ids: tuple[int, ...]
    target: str  # 'local' | 'distributed' | 'chunked'
    last_use_of: tuple[int, ...] = ()  # uids freed after this instruction
    probe: bool = False   # lineage-reuse probe point (cost-gated)
    est_cost_s: float = 0.0  # compile-time cost estimate behind `probe`


@dataclass
class Plan:
    instructions: list[Instruction]
    output_ids: list[int]
    roots: list[Node]
    est_bytes_peak: int = 0
    reuse_enabled: bool = False
    # streaming metadata from `lower_chunked`: value uid -> total row
    # count, for every input the streaming executor row-slices per
    # chunk; empty for non-chunked plans
    chunk_sliced: dict = field(default_factory=dict)
    # segmentation memo: {reuse_active: [Segment, ...]}
    _segments: dict = field(default_factory=dict, repr=False)
    # format-assignment memo: {sparse_enabled: {uid: fmt}}
    _formats: dict = field(default_factory=dict, repr=False)

    def count_ops(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for ins in self.instructions:
            out[ins.node.op] = out.get(ins.node.op, 0) + 1
        return out

    def segments_for(self, reuse_active: bool):
        """Fusable segments of this plan (lazily computed, memoized).
        With an active reuse cache, cost-gated probe points force
        segment boundaries. See `repro_torch.core.segments`."""
        reuse_active = bool(reuse_active)
        got = self._segments.get(reuse_active)
        if got is None:
            from .segments import segment_plan
            got = segment_plan(self, reuse_active=reuse_active)
            self._segments[reuse_active] = got
        return got

    def formats_for(self, sparse: bool) -> dict[int, str]:
        """Compile-time physical format per value uid (lazily memoized);
        only non-dense assignments are recorded."""
        sparse = bool(sparse)
        got = self._formats.get(sparse)
        if got is None:
            got = assign_formats(self, sparse)
            self._formats[sparse] = got
        return got

    def _ins_line(self, ins: Instruction, reuse_active: bool = False,
                  fmts: Optional[dict] = None) -> str:
        fmts = fmts or {}

        def ref(uid: int, node: Optional[Node] = None) -> str:
            if node is not None and node.placement == "chunked":
                return f"%{uid}:chunk"  # streamed one row bucket at a time
            f = fmts.get(uid, "dense")
            return f"%{uid}" if f == "dense" else f"%{uid}:{f}"

        args = ",".join(ref(u, nd)
                        for u, nd in zip(ins.input_ids, ins.node.inputs))
        attrs = {k: v for k, v in ins.node.attrs
                 if k not in ("index", "iattrs", "sin")}
        fmt = fmts.get(ins.out_id, "dense")
        tags = f" fmt={fmt}" if fmt != "dense" else ""
        if ins.node.placement == "chunked":
            tags += " chunked"
        if ins.node.op == "combine":
            tags += " [combine-boundary]"
        if reuse_active and ins.probe:
            tags += " [reuse-probe]"
        return (f"%{ins.out_id} = [{ins.target[0].upper()}] "
                f"{ins.node.op}({args}) {ins.node.shape} "
                f"sp={ins.node.sparsity:.3f}{tags} "
                f"{attrs if attrs else ''}").rstrip()

    def explain(self, segments: bool = True,
                reuse_active: Optional[bool] = None,
                sparse: bool = False) -> str:
        """EXPLAIN-style plan dump (SystemDS -explain) with segment
        annotations, physical formats and reuse-probe boundaries — the
        same text the reference prints for the same plan (modulo uids).
        `reuse_active` defaults to the flag the plan was compiled with."""
        if reuse_active is None:
            reuse_active = self.reuse_enabled
        fmts = self.formats_for(sparse)
        lines = []
        if segments and self.instructions:
            for seg in self.segments_for(reuse_active):
                outs = ",".join(f"%{u}" for u in seg.output_uids)
                kind = "fused" if len(seg.instructions) > 1 else "single"
                if seg.chunked:
                    kind += " [chunked]"
                lines.append(
                    f"-- segment {seg.index} [{seg.target}] {kind} "
                    f"{len(seg.instructions)} op(s) key={seg.key[:10]} "
                    f"-> {outs}")
                lines.extend(f"  {self._ins_line(ins, reuse_active, fmts)}"
                             for ins in seg.instructions)
        else:
            lines.extend(self._ins_line(ins, reuse_active, fmts)
                         for ins in self.instructions)
        lines.append("outputs: " + ", ".join(f"%{i}" for i in self.output_ids))
        return "\n".join(lines)


def assign_formats(plan: "Plan", sparse: bool) -> dict[int, str]:
    """Format-assignment pass: pin every value to `dense` or `bcoo` (a
    forward walk using the propagated sparsity estimates; see
    `repro.core.compiler.assign_formats`). Kept so `explain(sparse=True)`
    reads like the reference; the runtime refuses `sparse_inputs=True`
    until the sparse kernels are ported."""
    from . import backend
    fmt: dict[int, str] = {}
    if not sparse or not backend.HAS_SPARSE:
        return fmt  # empty mapping ≡ all dense
    seen_leaves: set[int] = set()
    for ins in plan.instructions:
        for inp in ins.node.inputs:
            if inp.op == "input" and inp.uid not in seen_leaves:
                seen_leaves.add(inp.uid)
                lf = backend.leaf_format(inp)
                if lf != backend.DENSE:
                    fmt[inp.uid] = lf
        in_fmts = tuple(fmt.get(u, backend.DENSE) for u in ins.input_ids)
        of = backend.infer_format(ins.node, in_fmts)
        if of != backend.DENSE:
            fmt[ins.out_id] = of
    return fmt


def _refuse_unported_placements(roots: list[Node], mesh) -> None:
    """Raise for the placements whose passes are not ported yet, instead
    of compiling their leaves as local values."""
    if mesh is not None and getattr(mesh, "data", 1) > 1:
        raise NotImplementedError(
            f"mesh with data={mesh.data}: sharded placement "
            "(lower_distributed) is not ported yet (ROADMAP Queue 1 "
            "item 12)")
    for n in topo_order(roots):
        if n.placement != "local":
            raise NotImplementedError(
                f"{n!r} has placement {n.placement!r}: federated placement "
                "(lower_federated) is not ported yet (ROADMAP Queue 1 "
                "item 8)")


# ---------------------------------------------------------------------------
# Chunked placement (out-of-core streaming, ROADMAP item 4): split
# row-partitionable reductions over budget-exceeding leaves into
# per-chunk partial aggregates with an explicit combine boundary
# ---------------------------------------------------------------------------

# Row-preserving HOPs that stay chunked (fuse into the per-chunk
# segment): each output row depends only on the matching input rows, so
# the op commutes with row chunking (the reference's `fed_map` class).
_CHUNK_MAP_OPS = (ELEMENTWISE_BINARY | ELEMENTWISE_UNARY
                  | {"replace_nan", "where", "slice", "cbind"})

# reduction op -> its streaming partial-aggregate instruction
_CHUNK_REDUCE_OPS = {
    "gram": "chunk_gram", "xtv": "chunk_xtv",
    "colSums": "chunk_colsums", "sum": "chunk_sum",
}


def lower_chunked(roots: list[Node]
                  ) -> tuple[list[Node], dict[int, int]]:
    """Placement-assignment pass for out-of-core streaming: when a
    row-partitionable reduction's leaves exceed `costmodel
    .CHUNK_MEM_BUDGET`, lower it to a per-chunk partial aggregate
    (`chunk_*`) closed by an explicit `combine` boundary, and mark the
    row-preserving prefix `placement='chunked'` so it fuses into the
    per-chunk jit segment the runtime streams row buckets through.

    Chunks are *temporal* partitions: one cached segment closure
    visits every row bucket in turn, so only partial aggregates (and one
    live chunk) are ever device-resident. The pass is dual-track: every node keeps its ordinary
    local form alongside an optional chunked form, and only a lowered
    reduction commits the chunked track into the plan — a consumer
    outside the row-decomposable class (`quantile`'s sort-based order
    statistics, row-shaped roots) simply keeps the local form, which is
    the materialization fallback. colMeans/mean lower through
    chunk_colsums/chunk_sum × 1/m, exactly like the fed/shard recipes,
    so zero rows in a ragged tail chunk can never skew a mean. A
    verbatim port of `repro.core.compiler.lower_chunked`.

    Returns (new roots, sliced map): value uid -> total rows for every
    input the streaming executor must row-slice per chunk.
    """
    # fast path: no over-budget local leaves anywhere -> nothing to do
    seen: set[int] = set()
    stack = list(roots)
    any_cand = False
    while stack and not any_cand:
        n = stack.pop()
        if n.uid in seen:
            continue
        seen.add(n.uid)
        any_cand = costmodel.should_chunk(n)
        stack.extend(n.inputs)
    if not any_cand:
        return roots, {}

    # uid -> (local form, chunked form | None)
    memo: dict[int, tuple[Node, Optional[Node]]] = {}
    sliced: dict[int, int] = {}
    combined: dict[int, Node] = {}  # shared combine boundaries per core

    def is_chk(x: Optional[Node]) -> bool:
        # the chunked track is the non-None memo slot: an over-budget
        # leaf is its own chunked form (it keeps placement 'local' —
        # the uid keys its binding), interior forms carry
        # placement='chunked'
        return x is not None

    def combine_of(core: Node) -> Node:
        got = combined.get(core.uid)
        if got is None:
            got = make_node("combine", (core,), core.shape, core.dtype,
                            core.sparsity)
            combined[core.uid] = got
        return got

    def chunk_rows_of(x: Node) -> int:
        return sliced.get(x.uid, x.shape[0] if x.shape else 0)

    def chunk_operand(loc: Node, chk: Optional[Node], m: int
                      ) -> Optional[Node]:
        """Resolve one operand of a chunked op: the chunked form when it
        carries the same row partitioning, a row-sliced local value when
        row-aligned, a passthrough for scalars / broadcast rows —
        None when the operand cannot enter the per-chunk segment."""
        if is_chk(chk) and chk.shape and chk.shape[0] == m:
            # record the row count even for chunked forms: if the value
            # ends up crossing a streaming-scope boundary (consumed by a
            # later chunked segment through a local combine), the
            # runtime materializes it piecewise and re-slices it there
            sliced.setdefault(chk.uid, m)
            return chk
        if loc.shape == () or (len(loc.shape) == 2 and loc.shape[0] == 1):
            return loc  # scalar / broadcast row: replicated per chunk
        if (len(loc.shape) == 2 and loc.shape[0] == m) \
                or loc.shape == (m,):
            sliced[loc.uid] = m  # row-aligned: sliced per chunk
            return loc
        if len(loc.shape) == 1 and loc.shape[0] != m:
            return loc  # column-space vector, replicated
        return None

    def _lower_chunk_map(n: Node, pairs) -> Optional[Node]:
        m = next(chunk_rows_of(c) for _, c in pairs if is_chk(c))
        if len(n.shape) != 2 or n.shape[0] != m:
            return None  # output must keep the row partitioning
        if n.op == "slice":
            idx = n.attr("index")
            if not idx or idx[0] != (0, m, 0):
                return None  # only full-row column slices stay chunked
        if n.op == "cbind" and n.attr("axis") != 1:
            return None
        ops = [chunk_operand(loc, chk, m) for loc, chk in pairs]
        if any(o is None for o in ops):
            return None
        return make_node(n.op, tuple(ops), n.shape, n.dtype, n.sparsity,
                         placement="chunked", **dict(n.attrs))

    def try_lower(n: Node, pairs) -> Optional[Node]:
        """Return the local-valued replacement for a reduction over a
        chunked operand (combine of a streaming partial), or None."""
        op = n.op
        loc0, chk0 = pairs[0]
        if op in ("gram", "colSums", "colMeans", "sum", "mean") \
                and not is_chk(chk0):
            return None
        if op == "gram":
            core = make_node("chunk_gram", (chk0,), n.shape, n.dtype,
                             n.sparsity, placement="chunked")
            return combine_of(core)
        if op == "xtv":
            m = chunk_rows_of(chk0) if is_chk(chk0) else None
            if m is None:
                return None
            ops = [chunk_operand(loc, chk, m) for loc, chk in pairs]
            if any(o is None for o in ops):
                return None
            core = make_node("chunk_xtv", tuple(ops), n.shape, n.dtype,
                             n.sparsity, placement="chunked")
            return combine_of(core)
        if op == "matmul" and n.inputs[0].op == "t":
            # t(X) @ v with X on the chunked track: the unfused xtv
            # shape (fuse_tsmm declines 1-D v) streams identically —
            # X^T v = Σ_chunks X_i^T v_i
            xloc, xchk = memo.get(n.inputs[0].inputs[0].uid,
                                  (n.inputs[0].inputs[0], None))
            if not is_chk(xchk):
                return None
            m = chunk_rows_of(xchk)
            xop = chunk_operand(xloc, xchk, m)
            vop = chunk_operand(*pairs[1], m)
            if xop is None or vop is None:
                return None
            core = make_node("chunk_xtv", (xop, vop), n.shape, n.dtype,
                             n.sparsity, placement="chunked")
            return combine_of(core)
        if op in ("colSums", "colMeans"):
            cs = make_node("chunk_colsums", (chk0,), (1, n.shape[-1]),
                           n.dtype, 1.0, placement="chunked")
            comb = combine_of(cs)
            if op == "colSums":
                return comb
            inv_m = make_node("literal", (), (), n.dtype, 1.0,
                              value=1.0 / loc0.shape[0])
            return make_node("mul", (comb, inv_m), n.shape, n.dtype, 1.0)
        if op in ("sum", "mean"):
            ss = make_node("chunk_sum", (chk0,), (), n.dtype, 1.0,
                           placement="chunked")
            comb = combine_of(ss)
            if op == "sum":
                return comb
            inv = make_node("literal", (), (), n.dtype, 1.0,
                            value=1.0 / max(1, loc0.numel))
            return make_node("mul", (comb, inv), n.shape, n.dtype, 1.0)
        return None

    def rec(n: Node) -> tuple[Node, Optional[Node]]:
        got = memo.get(n.uid)
        if got is not None:
            return got
        if not n.inputs:
            chk = None
            if costmodel.should_chunk(n):
                chk = n  # leaf stays local-placed; uid keys its binding
                sliced[n.uid] = n.shape[0]
            memo[n.uid] = (n, chk)
            return memo[n.uid]
        pairs = [rec(i) for i in n.inputs]
        locs = tuple(p[0] for p in pairs)
        if all(a is b for a, b in zip(locs, n.inputs)):
            loc = n
        else:
            loc = Node(op=n.op, inputs=locs, attrs=n.attrs, shape=n.shape,
                       dtype=n.dtype, sparsity=n.sparsity)
        chk = None
        # the matmul(t(X), v) shape reaches its chunked operand through
        # the transpose, which carries no chunked track of its own
        through_t = (n.op == "matmul" and n.inputs[0].op == "t"
                     and is_chk(memo.get(
                         n.inputs[0].inputs[0].uid, (None, None))[1]))
        if any(is_chk(c) for _, c in pairs) or through_t:
            # streaming always beats materializing here: the reduction's
            # operand exceeds CHUNK_MEM_BUDGET by the leaf gate, so the
            # local form is exactly the blow-the-budget baseline
            lowered = try_lower(n, pairs)
            if lowered is not None:
                memo[n.uid] = (lowered, None)
                return memo[n.uid]
            if n.op in _CHUNK_MAP_OPS:
                chk = _lower_chunk_map(n, pairs)
                if chk is not None:
                    sliced_rows = next(chunk_rows_of(c)
                                       for _, c in pairs if is_chk(c))
                    sliced.setdefault(chk.uid, sliced_rows)
        memo[n.uid] = (loc, chk)
        return memo[n.uid]

    # roots must be local: the local track is the materialization
    # fallback for everything the reduction lowering did not commit
    new_roots = [rec(r)[0] for r in roots]
    live = {n.uid for n in topo_order(new_roots)}
    return new_roots, {u: m for u, m in sliced.items() if u in live}


def _chunk_exec(n: Node) -> bool:
    """True for instructions that execute on the streaming path."""
    return n.placement == "chunked" or n.op.startswith("chunk_")


def _cluster_chunked(order: list[Node]) -> list[Node]:
    """Dependency-preserving reorder that clusters chunked-target
    instructions into maximal runs, so one streaming pass computes every
    partial aggregate of a scope (lmDS's gram AND xtv) instead of
    re-reading the data per reduction. Plain Kahn scheduling with a
    two-level priority: stay in the current execution lane, break ties
    by original topological position — plans without chunked
    instructions never reach this (order is returned unchanged by the
    caller's gate), so existing segmentations are untouched.
    """
    import heapq
    pos = {n.uid: i for i, n in enumerate(order)}
    indeg = {n.uid: 0 for n in order}
    consumers: dict[int, list[Node]] = {n.uid: [] for n in order}
    for n in order:
        for i in n.inputs:
            if i.uid in pos:
                indeg[n.uid] += 1
                consumers[i.uid].append(n)
    heaps: dict[bool, list] = {True: [], False: []}
    for n in order:
        if indeg[n.uid] == 0:
            heapq.heappush(heaps[_chunk_exec(n)], (pos[n.uid], n))
    out: list[Node] = []
    lane = False
    while heaps[True] or heaps[False]:
        if not heaps[lane]:
            lane = not lane
        _, n = heapq.heappop(heaps[lane])
        out.append(n)
        for c in consumers[n.uid]:
            indeg[c.uid] -= 1
            if indeg[c.uid] == 0:
                heapq.heappush(heaps[_chunk_exec(c)], (pos[c.uid], c))
    return out


def topo_order(roots: list[Node]) -> list[Node]:
    seen: set[int] = set()
    order: list[Node] = []

    def rec(n: Node):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for i in n.inputs:
            rec(i)
        order.append(n)

    for r in roots:
        rec(r)
    return order


def compile_plan(outputs: list[LTensor], *, reuse_enabled: bool = False,
                 opt_level: int = 2,
                 local_budget: int = LOCAL_MEM_BUDGET,
                 mesh: Optional[object] = None) -> Plan:
    roots = [o.node for o in outputs]
    roots = run_rewrites(roots, reuse_enabled=reuse_enabled,
                         opt_level=opt_level)
    # where the reference runs lower_federated / lower_distributed
    _refuse_unported_placements(roots, mesh)
    # out-of-core streaming: its budget gate keeps it inert for
    # in-memory plans
    roots, chunk_sliced = lower_chunked(roots)
    order = topo_order(roots)
    if chunk_sliced:
        # cluster chunked instructions so one streaming pass serves
        # every partial aggregate of a scope (gram AND xtv share a read)
        order = _cluster_chunked(order)

    # liveness: last consumer of each node frees it (buffer-pool eviction)
    last_consumer: dict[int, int] = {}
    for idx, n in enumerate(order):
        for i in n.inputs:
            last_consumer[i.uid] = idx
    root_ids = {r.uid for r in roots}
    frees_at: dict[int, list[int]] = {}
    for uid, idx in last_consumer.items():
        if uid not in root_ids:
            frees_at.setdefault(idx, []).append(uid)

    instructions: list[Instruction] = []
    peak = 0
    live = 0
    live_sizes: dict[int, int] = {}  # uid -> bytes counted into `live`
    for idx, n in enumerate(order):
        if n.op == "input":
            continue
        op_bytes = n.est_bytes() + sum(i.est_bytes() for i in n.inputs)
        if _chunk_exec(n):
            target = "chunked"  # streaming lane (budget-lowered)
        else:
            target = "distributed" if op_bytes > local_budget else "local"
        cost = costmodel.est_cost_s(n)
        instructions.append(Instruction(
            node=n, out_id=n.uid,
            input_ids=tuple(i.uid for i in n.inputs),
            target=target,
            last_use_of=tuple(frees_at.get(idx, ())),
            # chunked-placement prefix values exist only one row bucket
            # at a time inside the streaming executor — they are never
            # materialized, so they can never be probed or cached. The
            # chunk_* partial aggregates (small, materialized segment
            # outputs) stay probe-eligible; the streaming executor
            # probes them before dispatching any chunk, so a warm cache
            # skips the whole stream.
            probe=(cost >= costmodel.PROBE_MIN_COST_S
                   and not (n.placement == "chunked"
                            and not n.op.startswith("chunk_"))),
            est_cost_s=cost))
        sz = n.est_bytes()
        live_sizes[n.uid] = sz
        live += sz
        peak = max(peak, live)
        for uid in frees_at.get(idx, ()):
            # frees of input leaves were never counted into `live`
            live -= live_sizes.pop(uid, 0)

    return Plan(instructions=instructions,
                output_ids=[r.uid for r in roots], roots=roots,
                est_bytes_peak=peak, reuse_enabled=reuse_enabled,
                chunk_sliced=chunk_sliced)
