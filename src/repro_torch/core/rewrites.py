"""Compiler rewrites over the HOP DAG (SystemDS §3.2 "multiple rounds of
rewrites" + §4.1 "compiler-assisted reuse").

Passes (applied in `repro_torch.core.compiler.compile_plan`; a verbatim
port of `repro.core.rewrites`):
  1. algebraic simplifications  — t(t(X))→X, sum(t(X))→sum(X), x*1→x, ...
  2. fused-operator detection   — t(X)@X → gram(X)   [tsmm]
                                  t(X)@y → xtv(X, y)
  3. matmul-chain reordering    — optimal parenthesization (DP on dims)
  4. reuse-enabling distribution (only when a reuse cache is active):
       gram(rbind(A,B,..))   → gram(A)+gram(B)+...            [CV, Fig. 7]
       xtv(rbind(A..), rbind(y..)) → Σ xtv(Ai, yi)            [CV, Fig. 7]
       gram(cbind(X, c))     → block([[gram(X), xtv(X,c)],
                                      [t(xtv(X,c)), gram(c)]]) [steplm, Ex. 1]
  5. common-subexpression elimination (structural hashing)

Each pass is a bottom-up DAG rebuild; DCE falls out of rebuilding only
reachable nodes.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .dag import Node, make_node, structural_key

# ---------------------------------------------------------------------------
# Generic bottom-up transformer
# ---------------------------------------------------------------------------


def transform(roots: list[Node], fn: Callable[[Node], Node]) -> list[Node]:
    """Rebuild the DAG bottom-up, applying `fn` to each node whose inputs
    were (possibly) rewritten. `fn` receives a node with *new* inputs and
    returns a replacement node (or the node itself)."""
    memo: dict[int, Node] = {}

    def rec(n: Node) -> Node:
        got = memo.get(n.uid)
        if got is not None:
            return got
        if n.inputs:
            new_inputs = tuple(rec(i) for i in n.inputs)
            if any(a is not b for a, b in zip(new_inputs, n.inputs)):
                n2 = Node(op=n.op, inputs=new_inputs, attrs=n.attrs,
                          shape=n.shape, dtype=n.dtype, sparsity=n.sparsity,
                          placement=n.placement)
            else:
                n2 = n
        else:
            n2 = n
        out = fn(n2)
        memo[n.uid] = out
        return out

    return [rec(r) for r in roots]


def use_counts(roots: list[Node]) -> dict[int, int]:
    counts: dict[int, int] = {}
    seen: set[int] = set()

    def rec(n: Node):
        for i in n.inputs:
            counts[i.uid] = counts.get(i.uid, 0) + 1
            if i.uid not in seen:
                seen.add(i.uid)
                rec(i)

    for r in roots:
        counts[r.uid] = counts.get(r.uid, 0) + 1
        if r.uid not in seen:
            seen.add(r.uid)
            rec(r)
    return counts


# ---------------------------------------------------------------------------
# Pass 1: algebraic simplification
# ---------------------------------------------------------------------------

def _is_literal(n: Node, value=None) -> bool:
    return n.op == "literal" and (value is None or n.attr("value") == value)


def simplify(n: Node) -> Node:
    op = n.op
    # t(t(X)) -> X
    if op == "t" and n.inputs[0].op == "t":
        return n.inputs[0].inputs[0]
    # sum(t(X)) -> sum(X); trace(t(X)) -> trace(X)
    if op in ("sum", "trace", "mean", "nnz") and n.inputs[0].op == "t":
        return make_node(op, (n.inputs[0].inputs[0],), n.shape, n.dtype,
                         n.sparsity)
    # x * 1 -> x ; x + 0 -> x ; x / 1 -> x ; x - 0 -> x (shape-safe cases)
    if op in ("mul", "div") and len(n.inputs) == 2:
        a, b = n.inputs
        if _is_literal(b, 1.0) and a.shape == n.shape:
            return a
        if op == "mul" and _is_literal(a, 1.0) and b.shape == n.shape:
            return b
    if op in ("add", "sub") and len(n.inputs) == 2:
        a, b = n.inputs
        if _is_literal(b, 0.0) and a.shape == n.shape:
            return a
        if op == "add" and _is_literal(a, 0.0) and b.shape == n.shape:
            return b
    # literal-literal folding for scalars
    if op in ("add", "sub", "mul", "div", "pow") and len(n.inputs) == 2 and \
            all(_is_literal(i) for i in n.inputs) and n.shape == ():
        a, b = (i.attr("value") for i in n.inputs)
        try:
            v = {"add": a + b, "sub": a - b, "mul": a * b,
                 "div": a / b if b != 0 else np.nan, "pow": a ** b}[op]
            return make_node("literal", (), (), n.dtype,
                             0.0 if v == 0 else 1.0, value=float(v))
        except Exception:
            pass
    return n


# ---------------------------------------------------------------------------
# Pass 2: fused operators (tsmm / xtv)
# ---------------------------------------------------------------------------

def fuse_tsmm(n: Node) -> Node:
    if n.op != "matmul":
        return n
    a, b = n.inputs
    if a.op == "t":
        x = a.inputs[0]
        if x.uid == b.uid and len(x.shape) == 2:
            # t(X) @ X -> gram(X)
            return make_node("gram", (x,), n.shape, n.dtype, n.sparsity)
        if len(x.shape) == 2 and len(b.shape) == 2:
            # t(X) @ Y -> xtv(X, Y) (fused, avoids materializing transpose)
            return make_node("xtv", (x, b), n.shape, n.dtype, n.sparsity)
    return n


# ---------------------------------------------------------------------------
# Pass 3: matmul chain reordering (dynamic programming)
# ---------------------------------------------------------------------------

def reorder_matmul_chains(roots: list[Node]) -> list[Node]:
    counts = use_counts(roots)

    def collect(n: Node, factors: list[Node]):
        """Flatten a matmul tree into its chain factors; only descend through
        intermediate products with a single consumer (splitting shared
        products would defeat CSE/reuse)."""
        if n.op == "matmul" and counts.get(n.uid, 1) <= 1:
            collect(n.inputs[0], factors)
            collect(n.inputs[1], factors)
        else:
            factors.append(n)

    def optimal(factors: list[Node]) -> Node:
        k = len(factors)
        dims = [f.shape[0] for f in factors] + [factors[-1].shape[-1]]
        cost = [[0.0] * k for _ in range(k)]
        split = [[0] * k for _ in range(k)]
        for span in range(1, k):
            for i in range(k - span):
                j = i + span
                cost[i][j] = float("inf")
                for s in range(i, j):
                    c = (cost[i][s] + cost[s + 1][j]
                         + dims[i] * dims[s + 1] * dims[j + 1])
                    if c < cost[i][j]:
                        cost[i][j] = c
                        split[i][j] = s

        def build(i: int, j: int) -> Node:
            if i == j:
                return factors[i]
            s = split[i][j]
            lhs, rhs = build(i, s), build(s + 1, j)
            shape = lhs.shape[:-1] + rhs.shape[1:]
            return make_node("matmul", (lhs, rhs), shape,
                             np.result_type(lhs.dtype, rhs.dtype), 1.0)

        return build(0, k - 1)

    def fn(n: Node) -> Node:
        if n.op != "matmul":
            return n
        factors: list[Node] = []
        collect(n, factors)
        if len(factors) <= 2:
            return n
        if any(len(f.shape) != 2 for f in factors):
            return n
        return optimal(factors)

    return transform(roots, fn)


# ---------------------------------------------------------------------------
# Pass 4: reuse-enabling distribution (compensation-plan rewrites)
# ---------------------------------------------------------------------------

def distribute_for_reuse(n: Node) -> Node:
    # gram(rbind(A, B, ...)) -> gram(A) + gram(B) + ...
    if n.op == "gram" and n.inputs[0].op == "rbind" \
            and n.inputs[0].attr("axis") == 0:
        parts = n.inputs[0].inputs
        if len(parts) >= 2:
            acc = None
            for p in parts:
                g = make_node("gram", (p,), n.shape, n.dtype, n.sparsity)
                acc = g if acc is None else make_node(
                    "add", (acc, g), n.shape, n.dtype, n.sparsity)
            return acc
    # xtv(rbind(A..), rbind(y..)) with aligned splits -> Σ xtv(Ai, yi)
    if n.op == "xtv" and n.inputs[0].op == "rbind" and \
            n.inputs[1].op == "rbind":
        xs, ys = n.inputs[0].inputs, n.inputs[1].inputs
        if len(xs) == len(ys) >= 2 and \
                all(a.shape[0] == b.shape[0] for a, b in zip(xs, ys)):
            acc = None
            for a, b in zip(xs, ys):
                p = make_node("xtv", (a, b), n.shape, n.dtype, 1.0)
                acc = p if acc is None else make_node(
                    "add", (acc, p), n.shape, n.dtype, 1.0)
            return acc
    # gram(cbind(X, c)) -> block composition reusing gram(X)  [steplm]
    if n.op == "gram" and n.inputs[0].op == "cbind" \
            and n.inputs[0].attr("axis") == 1:
        parts = n.inputs[0].inputs
        if len(parts) == 2 and parts[1].shape[1] <= 4 <= parts[0].shape[1]:
            x, c = parts
            gx = make_node("gram", (x,), (x.shape[1], x.shape[1]),
                           n.dtype, n.sparsity)
            xc = make_node("xtv", (x, c), (x.shape[1], c.shape[1]),
                           n.dtype, 1.0)
            cx = make_node("t", (xc,), (c.shape[1], x.shape[1]), n.dtype, 1.0)
            gc = make_node("gram", (c,), (c.shape[1], c.shape[1]),
                           n.dtype, 1.0)
            top = make_node("cbind", (gx, xc),
                            (x.shape[1], n.shape[1]), n.dtype, 1.0, axis=1)
            bot = make_node("cbind", (cx, gc),
                            (c.shape[1], n.shape[1]), n.dtype, 1.0, axis=1)
            return make_node("rbind", (top, bot), n.shape, n.dtype, 1.0,
                             axis=0)
    return n


# ---------------------------------------------------------------------------
# Pass 5: CSE
# ---------------------------------------------------------------------------

def cse(roots: list[Node]) -> list[Node]:
    canon: dict[str, Node] = {}
    memo: dict[int, str] = {}

    def fn(n: Node) -> Node:
        key = structural_key(n, memo)
        got = canon.get(key)
        if got is not None and got.shape == n.shape:
            return got
        canon[key] = n
        return n

    return transform(roots, fn)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

def run_rewrites(roots: list[Node], reuse_enabled: bool,
                 opt_level: int = 2) -> list[Node]:
    if opt_level >= 1:
        roots = transform(roots, simplify)
        roots = transform(roots, fuse_tsmm)
    if opt_level >= 2:
        roots = reorder_matmul_chains(roots)
        # re-run fusion: reordering can expose new t(X)@X patterns
        roots = transform(roots, fuse_tsmm)
    if reuse_enabled and opt_level >= 1:
        roots = transform(roots, distribute_for_reuse)
        roots = transform(roots, simplify)
    roots = cse(roots)
    return roots
