"""The port's sparse `bcoo` lane against the reference.

Mirrors every test of tests/test_formats.py (its block-sparse kernel
cases live in tests/test_torch_spmm.py) on the same numpy data, made from
a seed, through `repro` (jax, CPU, at pipeline depth 1) and `repro_torch`
(`device="cpu"`), with the reference's tolerances: format assignment,
dense/sparse registry parity, fused sparse plans, reuse probes and hits
equal across fuse modes, sparse cache accounting, declared formats in
`PreparedScript`, fresh sparse batches on warm closures, in-place
mutation, cross-format cache hits, and sparsity estimates in [0, 1].
Counters that are not timings must equal the reference's. Beyond the
reference file: `sparsify` of both packages bit for bit, the sparse
streaming lmDS parity with equal chunk counts and closure builds, and
`lm` -> `lmCG` on a sparse X.
"""
import re

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro.core as R
import repro_torch.core as T
from repro.core import backend as rb
from repro.core import costmodel as rcm
from repro.core.compiler import compile_plan as r_compile
from repro.core.rewrites import run_rewrites as r_rewrites
from repro.lifecycle import regression as rreg
from repro_torch.core import backend as tb
from repro_torch.core import costmodel as tcm
from repro_torch.core.compiler import compile_plan as t_compile
from repro_torch.core.dag import SPARSE_THRESHOLD
from repro_torch.core.rewrites import run_rewrites as t_rewrites
from repro_torch.interop import bcoo_from_reference
from repro_torch.lifecycle import regression as treg

PKGS = {"ref": R, "port": T}
COMPILE = {"ref": r_compile, "port": t_compile}


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


def _rt(key, **kw):
    if key == "port":
        return T.LineageRuntime(device="cpu", **kw)
    return R.LineageRuntime(**kw)


def _sparse_mat(rng, m, n, density):
    return rng.normal(size=(m, n)) * (rng.random((m, n)) < density)


def _formats(plan, sparse=True) -> str:
    """Each instruction's op with its input and output formats, and the
    `explain(sparse=...)` text, uids renumbered by first appearance."""
    fm = plan.formats_for(sparse)
    lines = [f"{i.node.op}("
             + ",".join(fm.get(u, "dense") for u in i.input_ids)
             + f")->{fm.get(i.out_id, 'dense')}" for i in plan.instructions]
    lines.append(plan.explain(sparse=sparse))
    ids: dict[str, int] = {}
    return re.sub(r"%(\d+)",
                  lambda m: f"%{ids.setdefault(m.group(1), len(ids))}",
                  "\n".join(lines))


def _both_plans(build, opt_level=2):
    """(port plan, reference plan) of `build(pk)` on each package."""
    plans = {key: COMPILE[key](build(pk), opt_level=opt_level)
             for key, pk in PKGS.items()}
    assert _formats(plans["port"]) == _formats(plans["ref"])
    assert _formats(plans["port"], False) == _formats(plans["ref"], False)
    return plans["port"]


# ---------------------------------------------------------------------------
# format assignment
# ---------------------------------------------------------------------------

class TestFormatAssignment:
    def test_sparse_leaf_assigned_bcoo(self, rng):
        xn = _sparse_mat(rng, 128, 64, 0.05)
        leaf = {}

        def build(pk):
            leaf[pk] = pk.input_tensor("Xs", xn)
            return [pk.ops.gram(leaf[pk])]
        plan = _both_plans(build)
        fmts = plan.formats_for(True)
        assert fmts[leaf[T].node.uid] == tb.BCOO
        (gram_ins,) = [i for i in plan.instructions if i.node.op == "gram"]
        assert fmts.get(gram_ins.out_id, tb.DENSE) == tb.DENSE

    def test_dense_or_small_leaves_stay_dense(self, rng):
        dn, sn = rng.normal(size=(128, 64)), _sparse_mat(rng, 8, 8, 0.05)
        plan = _both_plans(lambda pk: [
            pk.ops.sum_(pk.ops.gram(pk.input_tensor("Xd", dn)))
            + pk.ops.sum_(pk.ops.gram(pk.input_tensor("Xt", sn)))])
        assert plan.formats_for(True) == {}

    def test_sparse_disabled_means_empty_mapping(self, rng):
        xn = _sparse_mat(rng, 128, 64, 0.05)
        plan = _both_plans(
            lambda pk: [pk.ops.gram(pk.input_tensor("Xs", xn))])
        assert plan.formats_for(False) == {}

    def test_structure_preserving_ops_keep_bcoo(self, rng):
        xn = _sparse_mat(rng, 128, 64, 0.05)
        plan = _both_plans(lambda pk: [pk.ops.sum_(
            pk.ops.abs_(-(pk.input_tensor("Xs", xn).T)) * 2.0)],
            opt_level=0)
        fmts = plan.formats_for(True)
        by_op = {}
        for ins in plan.instructions:
            by_op.setdefault(ins.node.op, fmts.get(ins.out_id, tb.DENSE))
        assert by_op == {"t": tb.BCOO, "neg": tb.BCOO, "abs": tb.BCOO,
                         "literal": tb.DENSE, "mul": tb.BCOO,
                         "sum": tb.DENSE}

    def test_non_scalar_mul_densifies(self, rng):
        xn, wn = _sparse_mat(rng, 128, 64, 0.05), rng.normal(size=(128, 64))
        plan = _both_plans(lambda pk: [pk.ops.sum_(
            pk.input_tensor("Xs", xn) * pk.input_tensor("W", wn))],
            opt_level=0)
        (mul_ins,) = [i for i in plan.instructions if i.node.op == "mul"]
        assert plan.formats_for(True).get(mul_ins.out_id, tb.DENSE) \
            == tb.DENSE

    def test_explain_annotates_formats(self, rng):
        xn = _sparse_mat(rng, 128, 64, 0.05)
        plan = _both_plans(
            lambda pk: [pk.ops.gram(-pk.input_tensor("Xs", xn))])
        txt = plan.explain(sparse=True)
        assert ":bcoo" in txt and "fmt=bcoo" in txt
        assert ":bcoo" not in plan.explain()

    def test_threshold_shared_with_cost_model(self):
        assert tb.SPARSE_THRESHOLD is SPARSE_THRESHOLD
        assert SPARSE_THRESHOLD == rb.SPARSE_THRESHOLD
        assert tb.SPARSE_MIN_NUMEL == rb.SPARSE_MIN_NUMEL
        assert tb.ZERO_PRESERVING_UNARY == rb.ZERO_PRESERVING_UNARY


# ---------------------------------------------------------------------------
# dense/sparse kernel parity across the registry
# ---------------------------------------------------------------------------

def _registry_pipeline(pk, x, y):
    """Touches matmul/gram/xtv/add/mul + slice/cbind/rbind densify
    boundaries and unary/aggregate kernels (tests/test_formats.py)."""
    ops = pk.ops
    g = ops.gram(x)                       # bcoo -> dense
    b = ops.xtv(x, y)                     # bcoo,dense -> dense
    z = x @ (b * 0.5)                     # bcoo matmul dense
    s = ops.abs_(-x) * 2.0                # stays bcoo
    sl = x[4:60, 1:33]                    # densify boundary
    cat = ops.cbind(ops.colSums(z), ops.colMaxs(z))
    stacked = ops.rbind(sl, sl)
    return [ops.sum_(g), ops.sum_(b), ops.sum_(z), ops.sum_(s),
            ops.sum_(stacked), cat, ops.sqrt(ops.abs_(g)) + g * g]


def _counters(rt):
    d = rt.stats.as_dict()
    return {k: v for k, v in d.items()
            if not k.endswith("_s") and k != "jit_cache"}


class TestDenseSparseParity:
    @pytest.mark.parametrize("density", [0.01, 0.05, 0.2])
    @pytest.mark.parametrize("fuse", [True, False])
    def test_registry_parity(self, rng, density, fuse):
        xn = _sparse_mat(rng, 128, 64, density)
        yn = rng.normal(size=(128, 1))
        out = {}
        for key, pk in PKGS.items():
            exprs = _registry_pipeline(pk, pk.input_tensor("X", xn),
                                       pk.input_tensor("y", yn))
            dense = _rt(key, fuse=True, sparse_inputs=False).evaluate(exprs)
            rt = _rt(key, fuse=fuse, sparse_inputs=True)
            out[key] = (rt.evaluate(exprs), _counters(rt))
            for a, b in zip(out[key][0], dense):
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10)
        for a, b in zip(out["port"][0], out["ref"][0]):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10)
        assert out["port"][1] == out["ref"][1]

    def test_sparse_plan_fuses(self, rng):
        xn = _sparse_mat(rng, 128, 64, 0.05)
        yn = rng.normal(size=(128, 1))
        stats = {}
        for key, pk in PKGS.items():
            rt = _rt(key, fuse=True, sparse_inputs=True)
            rt.evaluate(_registry_pipeline(pk, pk.input_tensor("X", xn),
                                           pk.input_tensor("y", yn)))
            stats[key] = (rt.stats.segments, rt.stats.instructions)
        segments, instructions = stats["port"]
        assert segments < instructions / 2
        assert stats["port"] == stats["ref"]

    def test_sparse_reuse_hits_match_interpreter(self, rng):
        xn = _sparse_mat(rng, 256, 64, 0.05)
        yn = rng.normal(size=(256, 1))
        stats, outs = {}, {}
        for key, pk in PKGS.items():
            for fuse in (True, False):
                rt = _rt(key, cache=pk.ReuseCache(), fuse=fuse,
                         sparse_inputs=True)
                x, y = pk.input_tensor("X", xn), pk.input_tensor("y", yn)
                for lam in (0.1, 1.0, 10.0):
                    beta = pk.ops.solve(
                        pk.ops.gram(x) + float(lam) * pk.ops.eye(64),
                        pk.ops.xtv(x, y))
                    out = rt.evaluate([beta])[0]
                c = rt.cache.stats
                stats[key, fuse] = (c.probes, c.hits, c.misses)
                outs[key, fuse] = out
                assert c.hits >= 4  # gram+xtv per extra lambda
        assert stats["port", True] == stats["port", False] \
            == stats["ref", True]
        ref = np.linalg.solve(xn.T @ xn + 10.0 * np.eye(64), xn.T @ yn)
        np.testing.assert_allclose(outs["port", True], ref, rtol=1e-8,
                                   atol=1e-9)
        assert np.array_equal(outs["port", True], outs["port", False])
        np.testing.assert_allclose(outs["port", True], outs["ref", True],
                                   rtol=1e-9, atol=1e-10)


# ---------------------------------------------------------------------------
# sparsify: the same BCOO buffers in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,density,dtype", [
    (128, 64, 0.05, np.float64), (300, 70, 0.2, np.float64),
    (64, 64, 0.0, np.float64), (16, 16, 1.0, np.float64),
    (256, 40, 0.1, np.float32), (1000, 9, 0.03, np.float64)])
def test_sparsify_matches_reference_bit_for_bit(rng, m, n, density, dtype):
    xn = _sparse_mat(rng, m, n, density).astype(dtype)
    want = rb.sparsify(xn)
    got = tb.sparsify(xn)
    theirs = bcoo_from_reference(np.asarray(want.data),
                                 np.asarray(want.indices), want.shape, "cpu",
                                 want.indices_sorted, want.unique_indices)
    assert got.shape == theirs.shape and got.nse == want.nse
    assert got.indices.dtype == theirs.indices.dtype
    assert np.array_equal(got.indices.numpy(), theirs.indices.numpy())
    assert got.data.dtype == theirs.data.dtype
    assert np.array_equal(got.data.numpy(), theirs.data.numpy())
    assert (got.indices_sorted, got.unique_indices) \
        == (want.indices_sorted, want.unique_indices)
    assert np.array_equal(got.todense().numpy(), xn)
    assert np.array_equal(got.T.todense().numpy(), xn.T)
    assert not got.T.indices_sorted
    tb.block_ready(got)  # a CPU value has nothing to wait for


def test_sparsify_leaves_non_matrices_dense():
    v = np.arange(5.0)
    assert tb.sparsify(v) is not None and not tb.is_sparse(tb.sparsify(v))
    assert np.array_equal(np.asarray(tb.sparsify(v)), v)


# ---------------------------------------------------------------------------
# sparse cache accounting (reuse.nbytes)
# ---------------------------------------------------------------------------

class TestSparseCacheAccounting:
    def test_bcoo_nbytes_is_sparse_size(self, rng):
        from jax.experimental import sparse as jsparse
        from repro.core.reuse import nbytes as r_nbytes
        from repro_torch.core.reuse import nbytes
        xn = _sparse_mat(rng, 256, 256, 0.02)
        xb = jsparse.BCOO.fromdense(np.asarray(xn))
        ours = bcoo_from_reference(np.asarray(xb.data),
                                   np.asarray(xb.indices), xb.shape, "cpu")
        got = nbytes(ours)
        assert got == r_nbytes(xb) \
            == int(xb.data.nbytes) + int(xb.indices.nbytes)
        assert 64 < got < xn.nbytes  # not the stub, not the dense size
        assert nbytes(tb.sparsify(xn)) == r_nbytes(rb.sparsify(xn))

    def test_nbytes_fallbacks(self):
        from repro_torch.core.reuse import nbytes
        assert nbytes(np.zeros((4, 4))) == 128

        class SizeOnly:
            size, dtype = 10, np.dtype(np.float64)
        assert nbytes(SizeOnly()) == 80
        assert nbytes(object()) == 64

    def test_prepared_script_formats_are_declared_not_guessed(self, rng):
        xn = rng.normal(size=(128, 64))
        xs = _sparse_mat(rng, 128, 64, 0.05)
        for key, pk in PKGS.items():
            ps = pk.PreparedScript(lambda a, pk=pk: pk.ops.gram(a),
                                   [(128, 64)],
                                   runtime=_rt(key, sparse_inputs=True))
            assert ps.plan.formats_for(True) == {}  # dense by default
            np.testing.assert_allclose(ps(xn)[0], xn.T @ xn, rtol=1e-10)
            ps2 = pk.PreparedScript(lambda a, pk=pk: pk.ops.gram(a),
                                    [(128, 64)],
                                    runtime=_rt(key, sparse_inputs=True),
                                    arg_sparsities=[0.05])
            assert list(ps2.plan.formats_for(True).values()) == ["bcoo"]
            np.testing.assert_allclose(ps2(xs)[0], xs.T @ xs, rtol=1e-10)

    def test_fresh_sparse_batches_share_warm_executables(self, rng):
        batches = [_sparse_mat(rng, 256, 64, 0.05) for _ in range(4)]
        assert len({np.count_nonzero(b) for b in batches}) > 1
        counts = {}
        for key, pk in PKGS.items():
            pk.clear_jit_cache()
            rt = _rt(key, sparse_inputs=True)
            ps = pk.PreparedScript(lambda a, pk=pk: pk.ops.gram(a),
                                   [(256, 64)], runtime=rt,
                                   arg_sparsities=[0.05])
            jc = pk.get_jit_cache().stats
            h0, m0 = jc.hits, jc.misses
            np.testing.assert_allclose(ps(batches[0])[0],
                                       batches[0].T @ batches[0], rtol=1e-10)
            trace_after_first = rt.stats.trace_time
            hits_before = rt.stats.jit_cache_hits
            for b in batches[1:]:
                np.testing.assert_allclose(ps(b)[0], b.T @ b, rtol=1e-10)
            assert rt.stats.trace_time == trace_after_first  # no rebuild
            assert rt.stats.jit_cache_hits >= hits_before + 3
            counts[key] = (jc.hits - h0, jc.misses - m0)
        assert counts["port"] == counts["ref"]

    def test_inplace_mutation_seen_by_sparse_bind(self, rng):
        x = _sparse_mat(rng, 128, 64, 0.05)
        rt = _rt("port", sparse_inputs=True)
        ps = T.PreparedScript(lambda a: T.ops.sum_(a), [(128, 64)],
                              runtime=rt, arg_sparsities=[0.05])
        first = ps(x)[0]
        x *= 3.0
        np.testing.assert_allclose(ps(x)[0], first * 3.0, rtol=1e-12)

    def test_cache_hit_coerced_to_assigned_format(self, rng):
        xn = _sparse_mat(rng, 2048, 128, 0.05)
        hits = {}
        for key, pk in PKGS.items():
            def expr_of(t, pk=pk):
                return pk.ops.sum_(pk.ops.gram(pk.ops.abs_(t)))
            x = pk.input_tensor("Xc", xn)
            ref = _rt(key, fuse=True,
                      sparse_inputs=False).evaluate([expr_of(x)])[0]
            cache = pk.ReuseCache()
            for first, second in ((False, True), (True, False)):
                cache.clear()
                _rt(key, cache=cache, sparse_inputs=first).evaluate(
                    [expr_of(x)])
                r2 = _rt(key, cache=cache, sparse_inputs=second)
                out = r2.evaluate([expr_of(x)])[0]
                assert r2.cache.stats.hits > 0  # the cross-format hit
                np.testing.assert_allclose(out, ref, rtol=1e-9)
            hits[key] = cache.stats.as_dict()
        assert {k: v for k, v in hits["port"].items() if k != "time_saved_s"} \
            == {k: v for k, v in hits["ref"].items() if k != "time_saved_s"}

    def test_coerced_hit_feeds_a_sparse_kernel(self, rng):
        # a dense cached t(X) served to a plan that pinned it to bcoo is
        # sparsified at the probe, so the bcoo gram variant takes it
        xn = _sparse_mat(rng, 2048, 128, 0.05)
        x = T.input_tensor("Xc", xn)
        cache = T.ReuseCache()
        expr = T.ops.sum_(T.ops.gram(T.ops.abs_(x)))
        _rt("port", cache=cache).evaluate([expr])
        hit = next(iter(cache.entries.values())).value
        from repro_torch.core.runtime import _coerce_format
        sp = _coerce_format(hit, tb.BCOO)
        assert tb.is_sparse(sp)
        assert np.array_equal(sp.todense().numpy(), hit.numpy())
        assert _coerce_format(sp, tb.DENSE).equal(hit)

    def test_cached_sparse_intermediate_accounted_sparse(self, rng):
        from repro_torch.core.reuse import nbytes
        xn = _sparse_mat(rng, 256, 64, 0.02)
        rt = _rt("port", cache=T.ReuseCache(), fuse=True, sparse_inputs=True)
        rt.evaluate([T.ops.gram(T.input_tensor("X", xn))])
        assert rt.cache.stats.bytes_cached == \
            sum(e.size for e in rt.cache.entries.values())
        assert all(e.size == nbytes(e.value)
                   for e in rt.cache.entries.values())


# ---------------------------------------------------------------------------
# streaming: the sparse lmDS three-way parity, and lm -> lmCG
# ---------------------------------------------------------------------------

def test_lmds_three_way_parity_sparse(rng, monkeypatch):
    """Streaming (bcoo buckets) vs materialized-fused vs interpreter, in
    both packages: beta within 1e-10 of numpy's solve (the reference
    test's tolerance), and per package the same streaming meter, reuse
    counters and closure builds from a cleared cache."""
    m, n = 8192, 32
    xn = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.1)
    yn = rng.normal(size=(m,))
    ref = np.linalg.solve(xn.T @ xn + 1e-3 * np.eye(n), xn.T @ yn)
    out = {}
    for key, pk in PKGS.items():
        lmDS = (treg if key == "port" else rreg).lmDS
        runs = []
        for mode in ("stream", "interp", "mat"):
            cm = tcm if key == "port" else rcm
            monkeypatch.setattr(cm, "CHUNK_MEM_BUDGET",
                                1 << 30 if mode == "mat" else 1 << 16)
            pk.clear_jit_cache()
            jc = pk.get_jit_cache().stats
            m0 = jc.misses
            rt = _rt(key, cache=pk.ReuseCache(), fuse=mode != "interp",
                     sparse_inputs=True)
            beta = np.asarray(lmDS(pk.input_tensor("X", xn),
                                   pk.input_tensor("y", yn), reg=1e-3,
                                   runtime=rt)).ravel()
            assert np.abs(beta - ref).max() < 1e-10
            runs.append((rt.stats.streaming.as_dict(), _counters(rt),
                         rt.cache.stats.as_dict()["probes"],
                         jc.misses - m0, beta))
        out[key] = runs
    stream = out["port"][0][0]
    assert stream["chunks"] > 1
    assert out["port"][1][0]["chunks"] == out["port"][2][0]["chunks"] == 0
    for p, r in zip(out["port"], out["ref"]):
        assert p[:4] == r[:4]
        assert np.abs(p[4] - r[4]).max() < 1e-10


def test_lm_sends_a_wide_sparse_x_to_lmcg(rng):
    m, n = 1500, 1040  # n > 1024: lm takes lmCG
    xn = _sparse_mat(rng, m, n, 0.03)
    yn = xn @ rng.normal(size=(n, 1)) + 0.1 * rng.normal(size=(m, 1))
    out = {}
    for key, pk in PKGS.items():
        rt = _rt(key, sparse_inputs=True)
        mod = treg if key == "port" else rreg
        out[key] = mod.lm(pk.input_tensor("X", xn),
                          pk.input_tensor("y", yn), reg=1e-3, runtime=rt)
    direct = np.linalg.solve(xn.T @ xn + 1e-3 * np.eye(n), xn.T @ yn)
    rel = np.max(np.abs(out["port"] - out["ref"])) / np.max(np.abs(out["ref"]))
    assert rel <= 1e-9
    assert np.max(np.abs(out["port"] - direct)) / np.max(np.abs(direct)) \
        <= 1e-6


# ---------------------------------------------------------------------------
# property: sparsity estimates stay in [0, 1] through rewrites
# ---------------------------------------------------------------------------

def _walk(nodes):
    seen, out = set(), []

    def rec(n):
        if n.uid in seen:
            return
        seen.add(n.uid)
        out.append(n)
        for i in n.inputs:
            rec(i)

    for n in nodes:
        rec(n)
    return out


@st.composite
def sparse_expr_strategy(draw):
    density = draw(st.floats(0.0, 1.0))
    seed = draw(st.integers(0, 2 ** 16))
    steps = draw(st.lists(
        st.sampled_from(["neg", "abs", "sqrtabs", "mulself", "addself",
                         "scale", "gramlike", "slice", "cat"]),
        min_size=1, max_size=5))
    return density, seed, steps


def _build_sparse(ops, x, steps):
    cur = x
    for s in steps:
        if s == "neg":
            cur = -cur
        elif s == "abs":
            cur = ops.abs_(cur)
        elif s == "sqrtabs":
            cur = ops.sqrt(ops.abs_(cur))
        elif s == "mulself":
            cur = cur * cur
        elif s == "addself":
            cur = cur + cur
        elif s == "scale":
            cur = cur * 3.0
        elif s == "gramlike":
            cur = cur.T @ cur
        elif s == "slice":
            cur = cur[: max(2, cur.shape[0] // 2)]
        elif s == "cat":
            cur = ops.rbind(cur, cur)
    return cur


@settings(max_examples=30, deadline=None)
@given(sparse_expr_strategy())
def test_sparsity_estimates_stay_in_unit_interval(params):
    density, seed, steps = params
    rng = np.random.default_rng(seed)
    xn = rng.normal(size=(12, 12)) * (rng.random((12, 12)) < density)
    est = {}
    for key, pk, rewrite in (("ref", R, r_rewrites), ("port", T, t_rewrites)):
        expr = _build_sparse(pk.ops, pk.input_tensor("Xp", xn), steps)
        est[key] = []
        for reuse in (False, True):
            roots = rewrite([expr.node], reuse_enabled=reuse, opt_level=2)
            for node in _walk(roots):
                assert 0.0 <= node.sparsity <= 1.0, (node.op, node.sparsity)
                est[key].append((node.op, node.sparsity))
    assert est["port"] == est["ref"]
