"""Plan compiler: HOP DAG -> ordered runtime instructions (SystemDS §3.2).

Port of `repro.core.compiler` for every placement (local, federated,
sharded and chunked): rewrites + size propagation happen on the DAG, memory estimates
pick an execution target per instruction, and the result is a
topologically ordered instruction sequence executed by
`repro_torch.core.runtime.LineageRuntime`. The passes, their order and
their cost gates are the reference's, so both packages compile
identical instruction streams (modulo node uids) and identical
`Plan.explain()` text.

Compile-time physical decisions:

  * format assignment (`assign_formats` / `Plan.formats_for`) — values
    are pinned to `dense` or `bcoo` from their sparsity estimates
    (`sparse=False` maps all-dense);
  * probe-point selection (`Instruction.probe`) — only intermediates
    whose estimated cost clears the reuse cache's worth-keeping
    threshold become lineage-reuse probe points;
  * placement assignment (`lower_federated`) — placement propagates from
    federated input leaves; eligible patterns (gram, xtv, mv, vm,
    colSums/colMeans, row-preserving elementwise/structural ops) lower
    to `fed_*` instructions when the exchange-aware cost model says
    federation beats collecting, with explicit `collect` boundaries
    otherwise;
  * mesh placement (`lower_distributed`) — large row-shardable dense
    leaves propagate `placement='sharded'` over the device mesh's
    `data` axis; partial reductions lower to per-shard compute + a sum
    over the shards (`shard_gram`, `shard_xtv`, ...) and row-preserving
    ops stay inside sharded segments, with cost-gated `reshard`
    boundaries everywhere else;
  * chunked placement (`lower_chunked`) — row-partitionable reductions
    over leaves exceeding `costmodel.CHUNK_MEM_BUDGET` lower to
    streaming partial aggregates (`chunk_gram`, `chunk_xtv`,
    `chunk_colsums`, `chunk_sum`) closed by an explicit `combine`
    boundary.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from dataclasses import replace as _dc_replace
from typing import Optional

from . import costmodel
from .dag import (ELEMENTWISE_BINARY, ELEMENTWISE_UNARY, SPARSE_THRESHOLD,
                  LTensor, Node, make_node)
from .rewrites import run_rewrites

# Default per-operation local memory budget: inputs+output of an op above
# this threshold are flagged `distributed` (the reference's target name;
# the port runs them locally, as the reference does without a mesh; the
# sharded lane's instructions carry the same target).
LOCAL_MEM_BUDGET = 2 << 30


@dataclass
class Instruction:
    node: Node
    out_id: int
    input_ids: tuple[int, ...]
    target: str  # 'local' | 'distributed' | 'federated' | 'chunked'
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
    # the device mesh the plan was compiled against (a
    # `repro_torch.distributed.mesh.MeshSpec`, or None for local-only
    # plans); the runtime resolves it per run and falls back to
    # local-equivalent execution when devices are missing
    mesh_spec: Optional[object] = None
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
            if node is not None and node.placement == "federated":
                return f"%{uid}:fed"  # value lives row-partitioned on sites
            if node is not None and node.placement == "sharded":
                return f"%{uid}:sh"  # value lives row-sharded on the mesh
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
        if ins.node.placement == "federated":
            tags += " fed"
        if ins.node.placement == "sharded":
            tags += " sharded"
        if ins.node.placement == "chunked":
            tags += " chunked"
        if ins.node.op == "collect":
            tags += " [collect-boundary]"
        if ins.node.op == "reshard":
            tags += " [reshard-boundary]"
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
        annotations, physical formats, federated placement (`[F]`
        targets, `:fed` values, `[collect-boundary]`), sharded placement
        (`:sh` values, ` sharded`, `[reshard-boundary]`, `[sharded]`
        segments) and reuse-probe
        boundaries — the same text the reference prints for the same plan
        (modulo uids).
        `reuse_active` defaults to the flag the plan was compiled with."""
        if reuse_active is None:
            reuse_active = self.reuse_enabled
        fmts = self.formats_for(sparse)
        lines = []
        if segments and self.instructions:
            for seg in self.segments_for(reuse_active):
                outs = ",".join(f"%{u}" for u in seg.output_uids)
                kind = "fused" if len(seg.instructions) > 1 else "single"
                if seg.sharded:
                    kind += " [sharded]"
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
    `repro.core.compiler.assign_formats`); the runtime selects each
    kernel from it when `sparse_inputs=True`."""
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


# ---------------------------------------------------------------------------
# Placement assignment (SystemDS §3.3/§4.3): federated as a compiler
# placement alongside local | distributed
# ---------------------------------------------------------------------------

# Elementwise / structural HOPs whose output keeps the row partitioning
# of their federated operand(s): they lower to `fed_map` (per-site
# execution, no aggregate exchange). `slice` qualifies only for full-row
# column slices; `cbind` only along axis 1 with row-aligned operands.
_FED_MAP_OPS = (ELEMENTWISE_BINARY | ELEMENTWISE_UNARY
                | {"replace_nan", "where", "slice", "cbind"})


def _site_count(n: Node, nsites: dict[int, int]) -> int:
    return int(nsites.get(n.uid, n.attr("n_sites", 1) or 1))


def lower_federated(roots: list[Node]) -> list[Node]:
    """Placement-assignment pass: propagate `placement='federated'` from
    federated input leaves over the DAG and lower eligible patterns into
    `fed_*` instructions; insert explicit, cost-modeled `collect`
    boundaries everywhere else.

    Runs after the algebraic rewrites — so `t(X) @ X` over a federated X
    has already been fused to `gram(X)` and lowers to `fed_gram`, the
    paper's Example 2 (fed instructions are *generated by the
    optimizer*, never hand-written). Each candidate lowering is gated by
    the cost model: the federated form (per-site compute + aggregate
    exchange) must beat collecting the operand and running locally
    (`costmodel.fed_cost_s` vs `costmodel.collect_cost_s`), so placement
    decisions are cost-based, not syntactic. A `collect` inserted for
    one consumer is shared by all of them.
    """
    # fast path: no federated leaves anywhere -> nothing to do
    seen: set[int] = set()
    stack = list(roots)
    has_fed = False
    while stack and not has_fed:
        n = stack.pop()
        if n.uid in seen:
            continue
        seen.add(n.uid)
        has_fed = n.placement == "federated"
        stack.extend(n.inputs)
    if not has_fed:
        return roots

    memo: dict[int, Node] = {}
    nsites: dict[int, int] = {}     # uid of federated value -> site count
    collected: dict[int, Node] = {}  # shared collect boundaries

    def is_fed(x: Node) -> bool:
        return x.placement == "federated"

    def collect_of(x: Node) -> Node:
        got = collected.get(x.uid)
        if got is None:
            got = make_node("collect", (x,), x.shape, x.dtype, x.sparsity,
                            n_sites=_site_count(x, nsites))
            collected[x.uid] = got
        return got

    def shared_sites(fed_inputs: list[Node]) -> Optional[int]:
        counts = {_site_count(x, nsites) for x in fed_inputs}
        return counts.pop() if len(counts) == 1 else None

    def try_lower(n: Node, ins: tuple[Node, ...]
                  ) -> Optional[tuple[Node, Node]]:
        """Return (replacement node, fed core used for the cost gate),
        or None when no federated lowering exists for this pattern."""
        op = n.op
        feds = [x for x in ins if is_fed(x)]
        sites = shared_sites(feds)
        if sites is None:  # partitionings disagree -> no joint lowering
            return None
        if op == "gram" and is_fed(ins[0]):
            core = make_node("fed_gram", ins, n.shape, n.dtype, n.sparsity,
                             n_sites=sites)
            return core, core
        if op == "xtv":
            fed_args = tuple(i for i, x in enumerate(ins) if is_fed(x))
            # v^T X (the vm pattern) when only the second operand is
            # federated; X^T v (xtv) otherwise — one runtime executor,
            # two instruction names so EXPLAIN reads like the paper's
            fed_op = "fed_vm" if fed_args == (1,) else "fed_xtv"
            core = make_node(fed_op, ins, n.shape, n.dtype, n.sparsity,
                             n_sites=sites, fed_args=fed_args)
            return core, core
        if op == "matmul" and is_fed(ins[0]) and not is_fed(ins[1]):
            core = make_node("fed_mv", ins, n.shape, n.dtype, n.sparsity,
                             n_sites=sites)
            return core, core
        if op in ("colSums", "colMeans") and is_fed(ins[0]):
            cs = make_node("fed_colsums", ins, (1, n.shape[-1]), n.dtype,
                           1.0, n_sites=sites)
            if op == "colSums":
                return cs, cs
            inv_m = make_node("literal", (), (), n.dtype, 1.0,
                              value=1.0 / ins[0].shape[0])
            return (make_node("mul", (cs, inv_m), n.shape, n.dtype, 1.0),
                    cs)
        if op in _FED_MAP_OPS:
            return _lower_fed_map(n, ins, sites)
        return None

    def _lower_fed_map(n: Node, ins: tuple[Node, ...], sites: int
                       ) -> Optional[tuple[Node, Node]]:
        m = next(x for x in ins if is_fed(x)).shape[0]
        if len(n.shape) != 2 or n.shape[0] != m:
            return None  # output must keep the row partitioning
        if n.op == "slice":
            idx = n.attr("index")
            if not idx or idx[0] != (0, m, 0):
                return None  # only full-row column slices stay federated
        if n.op == "cbind" and n.attr("axis") != 1:
            return None
        new_inputs: list[Node] = []
        fed_args: list[int] = []
        gen_args: list[tuple[int, float, int, str]] = []
        for pos, x in enumerate(ins):
            if is_fed(x):
                fed_args.append(pos)
                new_inputs.append(x)
            elif x.op == "full" and len(x.shape) == 2 and x.shape[0] == m:
                # row-aligned generator: produced per-site, never sent
                # (matches the eager intercept idiom of appending a ones
                # column at each site); dtype travels along so an f32
                # plan is not silently promoted by an f64 default
                gen_args.append((pos, float(x.attr("value")), x.shape[1],
                                 str(x.dtype)))
            elif x.shape == () or (len(x.shape) == 2
                                   and x.shape[0] in (1, m)):
                new_inputs.append(x)  # scalar / broadcast row / aligned
            else:
                return None
        iattrs = tuple(kv for kv in n.attrs)
        core = make_node("fed_map", tuple(new_inputs), n.shape, n.dtype,
                         n.sparsity, placement="federated", inner=n.op,
                         iattrs=iattrs, n_args=len(ins),
                         n_sites=sites, fed_args=tuple(fed_args),
                         gen_args=tuple(gen_args))
        return core, core

    def rec(n: Node) -> Node:
        got = memo.get(n.uid)
        if got is not None:
            return got
        if not n.inputs:
            if is_fed(n):
                nsites[n.uid] = _site_count(n, nsites)
            memo[n.uid] = n
            return n
        ins = tuple(rec(i) for i in n.inputs)
        fed_inputs = [x for x in ins if is_fed(x)]
        if not fed_inputs:
            if all(a is b for a, b in zip(ins, n.inputs)):
                out = n
            else:
                out = Node(op=n.op, inputs=ins, attrs=n.attrs, shape=n.shape,
                           dtype=n.dtype, sparsity=n.sparsity)
            memo[n.uid] = out
            return out
        cand = try_lower(n, ins)
        if cand is not None:
            out, core = cand
            # cost gate: federated execution vs collect-then-local
            collect_s = sum(
                0.0 if x.uid in collected else
                costmodel.collect_cost_s(x, _site_count(x, nsites))
                for x in fed_inputs) + costmodel.est_cost_s(n)
            if costmodel.est_cost_s(core) <= collect_s:
                if is_fed(out):
                    nsites[out.uid] = _site_count(core, nsites)
                memo[n.uid] = out
                return out
        # fallback: explicit collect boundary, then the op runs locally
        loc = tuple(collect_of(x) if is_fed(x) else x for x in ins)
        out = Node(op=n.op, inputs=loc, attrs=n.attrs, shape=n.shape,
                   dtype=n.dtype, sparsity=n.sparsity)
        memo[n.uid] = out
        return out

    new_roots = [rec(r) for r in roots]
    # plan outputs must be local: materialize federated roots
    return [collect_of(r) if is_fed(r) else r for r in new_roots]


# ---------------------------------------------------------------------------
# Sharded placement (SystemDS's distributed/Spark lane, here a device
# mesh): row-shard large dense leaves over the mesh's `data` axis and
# lower eligible patterns to instructions run per shard
# ---------------------------------------------------------------------------

# Row-preserving HOPs that stay sharded (run on each row block): the
# same op class `fed_map` computes, plus row aggregates (each shard owns
# whole rows, so rowSums needs no collective). `rbind` is excluded — per-shard
# concatenation would interleave the global row order.
_SHARD_MAP_OPS = (_FED_MAP_OPS | {"rowSums", "rowMeans"})

# name of the mesh's row axis; mirrors
# repro_torch.distributed.mesh.DATA_AXIS
_DATA_AXIS = "data"


def lower_distributed(roots: list[Node], d: int) -> list[Node]:
    """Placement-assignment pass for the device mesh: propagate
    `placement='sharded'` from large row-shardable dense input leaves
    over the DAG and lower eligible patterns to shard-exec instructions;
    insert explicit, cost-modeled `reshard` boundaries everywhere else.

    Mirrors `lower_federated` — the mesh's `data` axis plays the role of
    the federation's sites. Partial-reduction ops (gram, xtv, colSums,
    sum) lower to per-shard compute + a sum over the shards
    (`shard_gram` etc.); row-preserving ops (`_SHARD_MAP_OPS`, matmul
    with a replicated rhs, row aggregates) keep the sharded placement
    and run on each row block inside the sharded segment, with per-input
    specs recorded in the `sin` attr ('s' = split on the data axis, 'r' =
    replicated). Each lowering is gated by the cost model: the sharded
    form (per-shard roofline + collective bytes over the interconnect)
    must beat resharding the operands and running locally
    (`costmodel.shard_cost_s` vs `costmodel.reshard_cost_s`). A
    `reshard` (gather back to a replicated value) inserted for one
    consumer is shared by all of them. Runs after `lower_federated`;
    federated subgraphs are left untouched (their local `collect`
    outputs may still feed sharded consumers as replicated operands).
    A verbatim port of `repro.core.compiler.lower_distributed`.
    """
    from repro_torch.distributed.sharding import rows_shardable

    from . import backend

    def leaf_shardable(n: Node) -> bool:
        return (n.op == "input" and n.placement == "local"
                and n.attr("batch") is None and len(n.shape) == 2
                and rows_shardable(n.shape, d)
                and backend.leaf_format(n) == backend.DENSE
                and costmodel._dense_bytes(n)
                >= costmodel.SHARD_MIN_LEAF_BYTES)

    # fast path: no shardable leaves anywhere -> nothing to do
    seen: set[int] = set()
    stack = list(roots)
    any_cand = False
    while stack and not any_cand:
        n = stack.pop()
        if n.uid in seen:
            continue
        seen.add(n.uid)
        any_cand = leaf_shardable(n)
        stack.extend(n.inputs)
    if not any_cand:
        return roots

    memo: dict[int, Node] = {}
    resharded: dict[int, Node] = {}  # shared reshard boundaries
    varmemo: dict[int, bool] = {}    # uid -> depends on a batched leaf

    def is_sh(x: Node) -> bool:
        return x.placement == "sharded"

    def is_var(n: Node) -> bool:
        got = varmemo.get(n.uid)
        if got is None:
            from .dag import is_batched_leaf
            got = is_batched_leaf(n) or any(is_var(i) for i in n.inputs)
            varmemo[n.uid] = got
        return got

    def maybe_bcoo(x: Node) -> bool:
        # conservatively refuse operands the format pass could pin to
        # BCOO — the shard specs assume dense global values
        return (backend.HAS_SPARSE and len(x.shape) == 2
                and x.sparsity < SPARSE_THRESHOLD
                and x.numel >= backend.SPARSE_MIN_NUMEL)

    def reshard_of(x: Node) -> Node:
        got = resharded.get(x.uid)
        if got is None:
            got = make_node("reshard", (x,), x.shape, x.dtype, x.sparsity,
                            axis=_DATA_AXIS, n_dev=d, sin=("s",))
            resharded[x.uid] = got
        return got

    def classify(x: Node, m: int) -> Optional[str]:
        """In-spec tag for one operand of a row-preserving sharded op:
        's' (split rows on the data axis) or 'r' (replicated)."""
        if is_sh(x):
            return "s" if x.shape[0] == m else None
        if x.shape == ():
            return "r"
        if len(x.shape) == 2 and x.shape[0] == 1:
            return "r"  # broadcast row, replicated on every shard
        if (len(x.shape) == 2 and x.shape[0] == m
                and x.shape[0] % d == 0 and not maybe_bcoo(x)):
            return "s"  # row-aligned local value: split by the in-spec
        return None

    def _lower_row_op(n: Node, ins: tuple[Node, ...]
                         ) -> Optional[tuple[Node, Node]]:
        m = next(x for x in ins if is_sh(x)).shape[0]
        if len(n.shape) != 2 or n.shape[0] != m:
            return None  # output must keep the row partitioning
        if n.op == "slice":
            idx = n.attr("index")
            if not idx or idx[0] != (0, m, 0):
                return None  # only full-row column slices stay sharded
        if n.op == "cbind" and n.attr("axis") != 1:
            return None
        # note: non-scalar generators (`full` row columns etc.) keep
        # their local placement — segmentation puts them in a local
        # segment and the global value enters the sharded segment split
        # by its in-spec, so a shard never builds a global-shaped
        # generator
        sin = []
        for x in ins:
            tag = classify(x, m)
            if tag is None:
                return None
            sin.append(tag)
        extra = dict(n.attrs)
        extra.update(sin=tuple(sin), n_dev=d)
        core = make_node(n.op, ins, n.shape, n.dtype, n.sparsity,
                         placement="sharded", **extra)
        return core, core

    def try_lower(n: Node, ins: tuple[Node, ...]
                  ) -> Optional[tuple[Node, Node]]:
        """Return (replacement node, shard core used for the cost gate),
        or None when no sharded lowering exists for this pattern."""
        op = n.op
        if op == "gram" and is_sh(ins[0]):
            core = make_node("shard_gram", ins, n.shape, n.dtype,
                             n.sparsity, axis=_DATA_AXIS, n_dev=d,
                             sin=("s",))
            return core, core
        if op == "xtv":
            m = ins[0].shape[0]
            if all(classify(x, m) == "s" for x in ins):
                core = make_node("shard_xtv", ins, n.shape, n.dtype,
                                 n.sparsity, axis=_DATA_AXIS, n_dev=d,
                                 sin=("s", "s"))
                return core, core
            return None
        if (op == "matmul" and is_sh(ins[0]) and not is_sh(ins[1])
                and len(n.shape) == 2 and not maybe_bcoo(ins[1])):
            # (m,k) @ (k,p) with a replicated rhs is row-preserving
            core = make_node("matmul", ins, n.shape, n.dtype, n.sparsity,
                             placement="sharded", n_dev=d, sin=("s", "r"))
            return core, core
        if op in ("colSums", "colMeans") and is_sh(ins[0]):
            cs = make_node("shard_colsums", ins, (1, n.shape[-1]),
                           n.dtype, 1.0, axis=_DATA_AXIS, n_dev=d,
                           sin=("s",))
            if op == "colSums":
                return cs, cs
            inv_m = make_node("literal", (), (), n.dtype, 1.0,
                              value=1.0 / ins[0].shape[0])
            return (make_node("mul", (cs, inv_m), n.shape, n.dtype, 1.0),
                    cs)
        if op in ("sum", "mean") and is_sh(ins[0]):
            ss = make_node("shard_sum", ins, (), n.dtype, 1.0,
                           axis=_DATA_AXIS, n_dev=d, sin=("s",))
            if op == "sum":
                return ss, ss
            inv = make_node("literal", (), (), n.dtype, 1.0,
                            value=1.0 / max(1, ins[0].numel))
            return (make_node("mul", (ss, inv), n.shape, n.dtype, 1.0),
                    ss)
        if op in _SHARD_MAP_OPS:
            return _lower_row_op(n, ins)
        return None

    def rec(n: Node) -> Node:
        got = memo.get(n.uid)
        if got is not None:
            return got
        if not n.inputs:
            if leaf_shardable(n):
                n = _dc_replace(n, placement="sharded")  # uid preserved:
                # the runtime's LEAVES binding is keyed by uid
            memo[n.uid] = n
            return n
        ins = tuple(rec(i) for i in n.inputs)
        sh_inputs = [x for x in ins if is_sh(x)]
        if not sh_inputs:
            if all(a is b for a, b in zip(ins, n.inputs)):
                out = n
            else:
                out = Node(op=n.op, inputs=ins, attrs=n.attrs,
                           shape=n.shape, dtype=n.dtype,
                           sparsity=n.sparsity)
            memo[n.uid] = out
            return out
        # config-variant nodes (downstream of a batched leaf) are the
        # `config` axis's business — keep data sharding to the invariant
        # prefix so a segment is never both vmapped and row-sharded
        cand = None if is_var(n) else try_lower(n, ins)
        if cand is not None:
            out, core = cand
            # cost gate: sharded execution vs reshard-then-local
            resh_s = sum(
                0.0 if x.uid in resharded else
                costmodel.reshard_cost_s(x, d)
                for x in sh_inputs) + costmodel.est_cost_s(n)
            if costmodel.est_cost_s(core) <= resh_s:
                memo[n.uid] = out
                return out
        # fallback: explicit reshard boundary, then the op runs locally
        loc = tuple(reshard_of(x) if is_sh(x) else x for x in ins)
        out = Node(op=n.op, inputs=loc, attrs=n.attrs, shape=n.shape,
                   dtype=n.dtype, sparsity=n.sparsity)
        memo[n.uid] = out
        return out

    new_roots = [rec(r) for r in roots]
    # plan outputs must be replicated/local: reshard sharded roots
    return [reshard_of(r) if is_sh(r) else r for r in new_roots]


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
    # placement assignment runs after the rewrites so fused patterns
    # (t(X)@X -> gram) are visible to the federated lowering
    roots = lower_federated(roots)
    if mesh is None:
        from repro_torch.distributed.mesh import get_mesh
        mesh = get_mesh()
    if mesh is not None and getattr(mesh, "data", 1) > 1:
        roots = lower_distributed(roots, int(mesh.data))
    # out-of-core streaming runs last: it only touches leaves the
    # federated/sharded passes left local, and its budget gate keeps it
    # inert for in-memory plans
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
        if n.op == "collect" or n.op.startswith("fed_"):
            target = "federated"
        elif (n.placement == "sharded" or n.op == "reshard"
                or n.op.startswith("shard_")):
            target = "distributed"  # shard-exec lane (mesh-lowered)
        elif _chunk_exec(n):
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
                mesh_spec=mesh, chunk_sliced=chunk_sliced)
