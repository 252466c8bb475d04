"""Task-parallel batched execution (`parfor`): the port against the
reference. Mirrors tests/test_parfor.py (template merging, invariant /
variant segmentation, vmapped execution parity against the
sequential-reuse and interpreter paths, bucketed warm closures,
cost-model arbitration) with the port on the CPU, and holds each result
against the reference's on the same seeded data (the reference at
pipeline depth 1): grid and CV betas within rtol 1e-8 / atol 1e-10 across
the vmap, sequential and `fuse=False` modes and across the packages, the
same variant/invariant segment splits and `explain()` text (modulo
uids), the same `choose_mode` decisions, and batched segments wherever
the reference runs them. The federated grids touch each site once per
federated instruction whatever the grid size, with the reference's
exchange bytes and rounds. The benchmark aggregation is not
mirrored."""
import re

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import batching as rbat
from repro.core.federated import FederatedTensor as RFed
from repro.core import costmodel as rcm
from repro.lifecycle import validation as rval
from repro_torch.core import batching as tbat
from repro_torch.core import costmodel as tcm
from repro_torch.core.dag import LEAVES as TLEAVES
from repro_torch.core.dag import batch_input, is_batched_leaf
from repro_torch.core.federated import FederatedTensor
from repro_torch.lifecycle import validation as tval

LAMBDAS = [0.01, 0.1, 1.0, 10.0]
PKGS = {"ref": (R, rbat, rval), "port": (T, tbat, tval)}


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


def _rt(key, **kw):
    return (T.LineageRuntime(device="cpu", **kw) if key == "port"
            else R.LineageRuntime(**kw))


def canon(text: str) -> str:
    """uids renumbered in order of first appearance, and the generated
    names of hoisted leaves ('cfg<counter>': each package counts its own
    leaves) without their counter."""
    ids: dict[str, int] = {}
    text = re.sub(r"'cfg\d+'", "'cfg'", text)
    return re.sub(r"%(\d+)",
                  lambda m: f"%{ids.setdefault(m.group(1), len(ids))}", text)


def _grid_runs(key, xn, yn, lambdas, sparse=False):
    """(batched, sequential-reuse, interpreter) results of one package."""
    pk, _, val = PKGS[key]
    runs = []
    for mode, kw in (("vmap", {}), ("sequential", {"cache": pk.ReuseCache()}),
                     ("sequential", {"fuse": False})):
        rt = _rt(key, sparse_inputs=sparse, **kw)
        X = pk.input_tensor("gX", xn, sparsity=0.05 if sparse else None)
        betas, losses = val.grid_search_lm(X, pk.input_tensor("gy", yn),
                                           lambdas, runtime=rt, mode=mode)
        runs.append((betas, losses, rt))
    return runs


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)


class TestTemplateMerge:
    def test_bucket_sizes(self):
        assert [tbat.bucket_size(k) for k in (1, 2, 3, 5, 8, 9, 16, 17)] \
            == [2, 2, 4, 8, 8, 16, 16, 32]

    def test_batched_leaf(self):
        lam = batch_input("lams", np.array([0.1, 1.0, 10.0]))
        assert is_batched_leaf(lam.node)
        assert lam.shape == ()          # element shape, not stacked
        assert lam.node.attr("batch") == 3

    def test_batch_input_rejects_scalar(self):
        with pytest.raises(ValueError):
            batch_input("bad", np.float64(3.0))

    def test_merge_hoists_varying_literal(self, rng):
        x = T.input_tensor("mX", rng.normal(size=(32, 4)))
        bplan = tbat.compile_batched(
            [[T.ops.gram(x) + lam * T.ops.eye(4)] for lam in LAMBDAS])
        assert bplan.batch == 4 and bplan.bucket == 4
        assert len(bplan.batched_leaf_uids) == 1
        assert bplan.variant_uids
        gram_ins = next(i for i in bplan.plan.instructions
                        if i.node.op == "gram")
        assert gram_ins.out_id not in bplan.variant_uids

    def test_merge_hoists_varying_leaves(self, rng):
        arrs = [rng.normal(size=(16, 3)) for _ in range(3)]
        leaves = [T.input_tensor(f"vl{i}", a) for i, a in enumerate(arrs)]
        bplan = tbat.compile_batched([[T.ops.colSums(lv)] for lv in leaves])
        assert len(bplan.batched_leaf_uids) == 1
        per_config = _rt("port").evaluate_batch(bplan)
        for a, (got,) in zip(arrs, per_config):
            np.testing.assert_allclose(got, a.sum(0, keepdims=True))

    def test_seed_grid_hoists_rand(self):
        """rand generators differing only in seed batch as a stacked
        leaf; parity with the sequential path (the same bit-exact draw
        in-plan) and with the reference."""
        seeds = [3, 5, 7]
        out = {}
        for key, (pk, _, val) in PKGS.items():
            def model(seed, pk=pk):
                r = pk.ops.rand((16, 4), seed=seed, dist="normal")
                return pk.ops.colSums(r * r)
            rt = _rt(key)
            batched = val.parfor(seeds, model, runtime=rt, mode="vmap")
            assert rt.stats.batched_segments > 0
            seq = val.parfor(seeds, model, runtime=_rt(key),
                             mode="sequential")
            for (b,), (s,) in zip(batched, seq):
                np.testing.assert_allclose(b, s, rtol=1e-12)
            out[key] = batched
        for (p,), (r,) in zip(out["port"], out["ref"]):
            np.testing.assert_allclose(p, r, rtol=1e-12)

    def test_identical_seed_rand_stays_invariant(self):
        def model(lam):
            r = T.ops.rand((16, 4), seed=7, dist="normal")
            return T.ops.sum_(r * float(lam))
        bplan = tbat.compile_batched([[model(lam)] for lam in LAMBDAS])
        assert len(bplan.batched_leaf_uids) == 1     # just the λ grid
        rand_ins = next(i for i in bplan.plan.instructions
                        if i.node.op == "rand")
        assert rand_ins.out_id not in bplan.variant_uids

    def test_passthrough_leaf_output_and_no_aliasing(self, rng):
        zn = rng.normal(size=(4, 4))
        z = T.input_tensor("ptZ", zn)
        x = T.input_tensor("ptX", rng.normal(size=(32, 4)))
        outs = tval.parfor(LAMBDAS,
                           lambda lam: (T.ops.colSums(x * float(lam)), z,
                                        T.ops.colSums(x)),
                           mode="vmap", runtime=_rt("port"))
        for per_cfg in outs:
            np.testing.assert_allclose(per_cfg[1], zn)
        assert outs[0][2] is not outs[1][2]
        assert not np.shares_memory(outs[0][2], outs[1][2])

    def test_vmap_mode_single_config_raises(self, rng):
        x = T.input_tensor("k1X", rng.normal(size=(8, 4)))
        with pytest.raises(tbat.BatchingError):
            tval.parfor([0.1], lambda lam: T.ops.sum_(x * float(lam)),
                        mode="vmap", runtime=_rt("port"))

    def test_parfor_releases_hoisted_leaves(self, rng):
        x = T.input_tensor("rlX", rng.normal(size=(32, 4)))
        for mode in ("vmap", "auto"):
            before = len(TLEAVES.values)
            tval.parfor(LAMBDAS, lambda lam: T.ops.colSums(x * float(lam)),
                        mode=mode, runtime=_rt("port"))
            assert len(TLEAVES.values) == before

    def test_identity_configs_return_per_config_leaves(self, rng):
        arrs = [rng.normal(size=(4, 2)) for _ in range(2)]
        leaves = [T.input_tensor(f"id{i}", a) for i, a in enumerate(arrs)]
        outs = tval.parfor([0, 1], lambda i: leaves[i], mode="vmap",
                           runtime=_rt("port"))
        for (got,), want in zip(outs, arrs):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want)

    def test_batched_host_op_parity(self, rng):
        """A host op (quantile) in the config-variant suffix: looped per
        TRUE config on the host (k = 3), padded back into the bucket of
        4; parity with the sequential path and with the reference."""
        xn = np.abs(rng.normal(size=(64, 6)))
        lams = [0.5, 1.0, 2.0]
        out = {}
        for key, (pk, _, val) in PKGS.items():
            x = pk.input_tensor("qX", xn)

            def model(lam, pk=pk, x=x):
                return pk.ops.sum_(pk.ops.quantile(x * float(lam), 0.5))
            rt = _rt(key)
            batched = val.parfor(lams, model, mode="vmap", runtime=rt)
            assert rt.stats.batched_segments > 0
            seq = val.parfor(lams, model, mode="sequential",
                             runtime=_rt(key))
            for (b,), (s,) in zip(batched, seq):
                np.testing.assert_allclose(b, s, rtol=1e-12)
            out[key] = batched
        for (p,), (r,) in zip(out["port"], out["ref"]):
            np.testing.assert_allclose(p, r, rtol=1e-12)

    def test_structural_mismatch_raises(self, rng):
        x = T.input_tensor("sX", rng.normal(size=(16, 3)))
        with pytest.raises(tbat.BatchingError):
            tbat.compile_batched([[T.ops.colSums(x)], [T.ops.rowSums(x)]])

    def test_shape_mismatch_raises(self, rng):
        a = T.input_tensor("sa", rng.normal(size=(16, 3)))
        b = T.input_tensor("sb", rng.normal(size=(8, 3)))
        with pytest.raises(tbat.BatchingError):
            tbat.compile_batched([[T.ops.colSums(a)], [T.ops.colSums(b)]])

    def test_parfor_falls_back_on_mismatch(self, rng):
        x = T.input_tensor("fbX", rng.normal(size=(16, 3)))
        rt = _rt("port")
        outs = tval.parfor([0, 1], lambda i: T.ops.colSums(x) if i == 0
                           else T.ops.rowSums(x), runtime=rt)
        assert rt.stats.batched_segments == 0
        assert outs[0][0].shape == (1, 3) and outs[1][0].shape == (16, 1)

    def test_parfor_vmap_mode_propagates_error(self, rng):
        x = T.input_tensor("veX", rng.normal(size=(16, 3)))
        with pytest.raises(tbat.BatchingError):
            tval.parfor([0, 1], lambda i: T.ops.colSums(x) if i == 0
                        else T.ops.rowSums(x), mode="vmap",
                        runtime=_rt("port"))

    def test_parfor_mode_validation(self):
        with pytest.raises(ValueError):
            tval.parfor([1], lambda c: T.ops.ones((2, 2)), mode="nope")


class TestGridSearchParity:
    @pytest.mark.parametrize("sparse", [False, True])
    def test_three_way_parity(self, rng, sparse):
        if sparse:
            xn = rng.normal(size=(256, 32)) \
                * (rng.uniform(size=(256, 32)) < 0.05)
        else:
            xn = rng.normal(size=(120, 10))
        yn = rng.normal(size=(xn.shape[0], 1))
        runs = {key: _grid_runs(key, xn, yn, LAMBDAS, sparse)
                for key in PKGS}
        (bb, lb, rt_b), (bs, ls, _), (bi, li, _) = runs["port"]
        assert rt_b.stats.batched_segments \
            == runs["ref"][0][2].stats.batched_segments > 0
        _close(bb, bs)
        _close(bb, bi)
        np.testing.assert_allclose(lb, ls, rtol=1e-8)
        np.testing.assert_allclose(lb, li, rtol=1e-8)
        for (pb, pl, _), (rb_, rl, _) in zip(runs["port"], runs["ref"]):
            _close(pb, rb_)
            np.testing.assert_allclose(pl, rl, rtol=1e-8)

    def test_shard_mode_runs_as_vmap(self, rng):
        """No device mesh: mode='shard' degrades to plain vmap, as the
        reference's does without one."""
        xn, yn = rng.normal(size=(60, 5)), rng.normal(size=(60, 1))
        rt = _rt("port")
        got, _ = tval.grid_search_lm(T.input_tensor("shX", xn),
                                     T.input_tensor("shy", yn), LAMBDAS,
                                     runtime=rt, mode="shard")
        assert rt.stats.batched_segments > 0
        want, _ = tval.grid_search_lm(T.input_tensor("shX", xn),
                                      T.input_tensor("shy", yn), LAMBDAS,
                                      runtime=_rt("port"), mode="vmap")
        np.testing.assert_array_equal(got, want)

    def test_grid_matches_numpy_reference(self, rng):
        xn = rng.normal(size=(120, 10))
        yn = rng.normal(size=(120, 1))
        betas, _ = tval.grid_search_lm(T.input_tensor("rX", xn),
                                       T.input_tensor("ry", yn), LAMBDAS,
                                       mode="vmap", runtime=_rt("port"))
        for j, lam in enumerate(LAMBDAS):
            ref = np.linalg.solve(xn.T @ xn + lam * np.eye(10), xn.T @ yn)
            np.testing.assert_allclose(betas[:, j:j + 1], ref,
                                       rtol=1e-6, atol=1e-9)

    def test_cv_three_way_parity(self, rng):
        xn = rng.normal(size=(160, 6))   # 4 equal folds of 40
        yn = rng.normal(size=(160, 1))
        results = {}
        for key, (pk, _, val) in PKGS.items():
            res = []
            for mode, kw in (("vmap", {}),
                             ("sequential", {"cache": pk.ReuseCache()}),
                             ("sequential", {"fuse": False})):
                rt = _rt(key, **kw)
                fx, fy = val.make_folds(xn, yn, 4, seed=3)
                res.append(val.cross_validate_lm(fx, fy, runtime=rt,
                                                 mode=mode)
                           + (rt.stats.batched_segments,))
            results[key] = res
        (bb, eb, nb), (bs, es, _), (bi, ei, _) = results["port"]
        assert nb == results["ref"][0][2] > 0
        _close(bb, bs)
        _close(bb, bi)
        np.testing.assert_allclose(eb, es, rtol=1e-8)
        np.testing.assert_allclose(eb, ei, rtol=1e-8)
        for (pb, pe, _), (rb_, re_, _) in zip(results["port"],
                                              results["ref"]):
            _close(pb, rb_)
            np.testing.assert_allclose(pe, re_, rtol=1e-8)

    def test_cv_unequal_folds_fall_back(self, rng):
        xn = rng.normal(size=(163, 5))   # array_split -> 41,41,41,40
        yn = rng.normal(size=(163, 1))
        fx, fy = tval.make_folds(xn, yn, 4, seed=4)
        rt = _rt("port", cache=T.ReuseCache())
        betas, errs = tval.cross_validate_lm(fx, fy, runtime=rt)
        assert rt.stats.batched_segments == 0   # sequential fallback
        assert betas.shape == (5, 4) and len(errs) == 4

    def test_make_folds_match_the_reference(self, rng):
        xn, yn = rng.normal(size=(50, 3)), rng.normal(size=(50, 1))
        tx, ty = tval.make_folds(xn, yn, 3, seed=9)
        rx, ry = rval.make_folds(xn, yn, 3, seed=9)
        for a, b in zip(tx + ty, rx + ry):
            np.testing.assert_array_equal(TLEAVES.values[a.node.uid],
                                          R.dag.LEAVES.values[b.node.uid])

    def test_invariant_output_shared_across_configs(self, rng):
        x = T.input_tensor("ioX", rng.normal(size=(32, 4)))
        rt = _rt("port")
        outs = tval.parfor(LAMBDAS,
                           lambda lam: (T.ops.colSums(x),
                                        T.ops.sum_(x * float(lam))),
                           runtime=rt, mode="vmap")
        ref = np.asarray(outs[0][0])
        for per_cfg, lam in zip(outs, LAMBDAS):
            np.testing.assert_allclose(per_cfg[0], ref)
            np.testing.assert_allclose(
                per_cfg[1], float(lam) * rt.evaluate([T.ops.sum_(x)])[0])


class TestBatchedSegments:
    @staticmethod
    def _bplan(key, xn, yn, lambdas=LAMBDAS, reuse=False):
        pk, bat, _ = PKGS[key]
        x, y = pk.input_tensor("segX", xn), pk.input_tensor("segy", yn)

        def model(lam):
            A = pk.ops.gram(x) + float(lam) * pk.ops.eye(xn.shape[1])
            return pk.ops.solve(A, pk.ops.xtv(x, y))
        return bat.compile_batched([[model(lam)] for lam in lambdas],
                                   reuse_enabled=reuse)

    def test_variance_splits_segments(self, rng):
        xn, yn = rng.normal(size=(64, 8)), rng.normal(size=(64, 1))
        bplan = self._bplan("port", xn, yn)
        segs = bplan.segments_for(False)
        assert any(s.variant for s in segs)
        assert any(not s.variant for s in segs)
        for s in segs:
            ops_in_seg = {i.node.op for i in s.instructions}
            if s.variant:
                assert "gram" not in ops_in_seg and "xtv" not in ops_in_seg
                assert "+vmap" in s.summary()
            else:
                assert "solve" not in ops_in_seg
        ref = self._bplan("ref", xn, yn).segments_for(False)
        assert [(s.variant, len(s.instructions)) for s in segs] == \
            [(s.variant, len(s.instructions)) for s in ref]

    @pytest.mark.parametrize("reuse", [False, True])
    def test_explain_matches_the_reference(self, rng, reuse):
        xn, yn = rng.normal(size=(64, 8)), rng.normal(size=(64, 1))
        txt = {key: self._bplan(key, xn, yn, reuse=reuse).explain()
               for key in PKGS}
        for tag in ("[batch=4]", "[config-invariant]", "batched-leaf",
                    "[hoisted scalar]"):
            assert tag in txt["port"]
        assert canon(txt["port"]) == canon(txt["ref"])

    def test_warm_closures_within_bucket(self, rng):
        """k=5 and k=7 share the bucket-of-8 padded shapes: the second
        grid replays the first grid's cached closures."""
        T.clear_jit_cache()
        xn, yn = rng.normal(size=(96, 8)), rng.normal(size=(96, 1))
        X, y = T.input_tensor("wX", xn), T.input_tensor("wy", yn)
        rt1 = _rt("port")
        tval.grid_search_lm(X, y, [float(i + 1) for i in range(5)],
                            runtime=rt1, mode="vmap")
        assert rt1.stats.trace_time > 0
        st = T.get_jit_cache().stats
        misses_before, hits_before = st.misses, st.hits
        rt2 = _rt("port")
        tval.grid_search_lm(X, y, [float(i + 1) for i in range(7)],
                            runtime=rt2, mode="vmap")
        assert st.misses == misses_before      # nothing rebuilt
        assert st.hits > hits_before
        assert rt2.stats.trace_time == 0.0

    def test_reuse_probe_hits_on_repeated_grid(self, rng):
        """Variant probe points hash over the batched-leaf lineage: an
        identical grid re-run is a full cache hit, with the reference's
        probe and hit counts."""
        xn, yn = rng.normal(size=(64, 8)), rng.normal(size=(64, 1))
        stats = {}
        for key, (pk, _, _) in PKGS.items():
            bplan = self._bplan(key, xn, yn, reuse=True)
            rt = _rt(key, cache=pk.ReuseCache())
            first = rt.evaluate_batch(bplan)
            hits0 = rt.cache.stats.hits
            again = rt.evaluate_batch(bplan)
            assert rt.cache.stats.hits > hits0
            for a, b in zip(first, again):
                np.testing.assert_allclose(a[0], b[0])
            stats[key] = (rt.cache.stats.probes, rt.cache.stats.hits,
                          rt.stats.batched_segments)
        assert stats["port"] == stats["ref"]


class TestCostModel:
    @staticmethod
    def _configs(key, xn, k):
        pk = PKGS[key][0]
        x = pk.input_tensor("cmX", xn)
        return [[pk.ops.colSums(x * float(i + 1))] for i in range(k)]

    @staticmethod
    def _modes(key, outs, reuse):
        bat = PKGS[key][1]
        bplan = bat.compile_batched(outs)
        roots = [[o.node for o in os_] for os_ in outs]
        return bat.choose_mode(bplan, roots, reuse)

    def test_constants_are_the_reference_ones(self):
        assert tcm.PARFOR_DISPATCH_S == rcm.PARFOR_DISPATCH_S
        assert tcm.VMAP_MEM_BUDGET == rcm.VMAP_MEM_BUDGET

    @pytest.mark.parametrize("k,want", [(5, "sequential"), (8, "vmap")])
    def test_memory_bound_giant_decisions(self, rng, k, want):
        """k=5 pads to a bucket of 8: 8x the memory-bound work loses to 5
        sequential passes; k=8 (no padding waste) goes vmap. Both
        packages decide alike, and their cost estimates agree."""
        xn = rng.normal(size=(4000, 512))
        got = {}
        for key in PKGS:
            outs = self._configs(key, xn, k)
            got[key] = self._modes(key, outs, False)
            bat = PKGS[key][1]
            bplan = bat.compile_batched(outs)
            var = [i.node for i in bplan.plan.instructions
                   if i.out_id in bplan.variant_uids]
            inv = [i.node for i in bplan.plan.instructions
                   if i.out_id not in bplan.variant_uids]
            cm = tcm if key == "port" else rcm
            got[key + "_cost"] = (
                cm.batched_cost_s(inv, var, bplan.bucket),
                cm.sequential_cost_s([[o.node for o in os_]
                                      for os_ in outs], False))
        assert got["port"] == got["ref"] == want
        np.testing.assert_allclose(got["port_cost"], got["ref_cost"],
                                   rtol=1e-12)

    def test_small_solve_grid_goes_vmap(self, rng):
        xn, yn = rng.normal(size=(64, 8)), rng.normal(size=(64, 1))
        got = {}
        for key in PKGS:
            pk = PKGS[key][0]
            x, y = pk.input_tensor("svX", xn), pk.input_tensor("svy", yn)
            outs = [[pk.ops.solve(pk.ops.gram(x) + lam * pk.ops.eye(8),
                                  pk.ops.xtv(x, y))] for lam in LAMBDAS]
            got[key] = self._modes(key, outs, True)
        assert got["port"] == got["ref"] == "vmap"

    def test_vmap_mem_budget_guard(self, rng, monkeypatch):
        xn = rng.normal(size=(4000, 512))
        outs = {key: self._configs(key, xn, 8) for key in PKGS}
        for key in PKGS:
            assert self._modes(key, outs[key], False) == "vmap"
        monkeypatch.setattr(tcm, "VMAP_MEM_BUDGET", 1 << 20)
        monkeypatch.setattr(rcm, "VMAP_MEM_BUDGET", 1 << 20)
        for key in PKGS:
            assert self._modes(key, outs[key], False) == "sequential"

    def test_bcoo_variant_value_goes_sequential(self, rng):
        """A config-variant value the format pass pins to bcoo (a sparse
        leaf times a hoisted λ keeps BCOO) has no vmap lane: sequential
        in both packages on the sparse lane, vmap on the dense one."""
        xn = rng.normal(size=(128, 64)) * (rng.random((128, 64)) < 0.05)
        for key in PKGS:
            pk, bat, _ = PKGS[key]
            x = pk.input_tensor("spX", xn, sparsity=0.05)
            outs = [[pk.ops.colSums(x * float(lam))] for lam in LAMBDAS]
            bplan = bat.compile_batched(outs)
            roots = [[o.node for o in os_] for os_ in outs]
            assert bat.choose_mode(bplan, roots, False, True) == \
                "sequential"
            assert bat.choose_mode(bplan, roots, False, False) == "vmap"

    def test_parfor_auto_respects_cost_fallback(self, rng):
        rt = _rt("port")
        outs = tval.parfor(range(5),
                           lambda i: T.ops.colSums(
                               T.input_tensor("pcX" if i == 0 else None,
                                              rng.normal(size=(8, 4)))
                               * float(i + 1)),
                           runtime=rt, mode="auto")
        assert len(outs) == 5

    def test_no_variant_suffix_goes_sequential(self, rng):
        xn = rng.normal(size=(16, 4))
        for key in PKGS:
            pk, bat, _ = PKGS[key]
            x = pk.input_tensor("nvX", xn)
            outs = [[pk.ops.colSums(x)], [pk.ops.colSums(x)]]
            bplan = bat.compile_batched(outs)
            assert not bplan.variant_uids
            assert self._modes(key, outs, False) == "sequential"


class TestBatchedKernelRules:
    """The gram/xtv vmap rules behind the variant suffix, on the CPU: the
    custom ops under torch.func.vmap against per-slice calls (the plain
    version batched), and an emulation of the card's batched plan (each
    element's row splits from the batch-wide plan, its partials summed
    in split order; xtv's through the grouped reduce order), whose
    workspace slots are disjoint. The card's own kernels are held
    against both in tests/test_torch_gram.py and chip_smoke.py."""

    @staticmethod
    def _emulated_gram(x, sms=132):
        from repro_torch.kernels.gram import ops as gops
        from repro_torch.kernels.gram import ref as gref
        k, m, n = x.shape
        tile_n, splits, rows = gops.gram_plan(m, n, x.dtype, sms, 128, k)
        acc = gref.acc_dtype(x.dtype)
        out = []
        for b in range(k):
            xb = x[b].to(acc)
            g = None
            for s in range(splits):
                part = xb[s * rows:(s + 1) * rows]
                p = part.mT @ part
                g = p if g is None else g + p
            out.append(torch.triu(g) + torch.triu(g, 1).mT)
        return torch.stack(out), (tile_n, splits, rows)

    @staticmethod
    def _emulated_xtv(x, v, sms=132):
        from repro_torch.kernels.gram import ops as gops
        from test_torch_spmm import _xtv_reduce_order
        k, m, n = x.shape
        vb = v if v.ndim == 3 else v.expand(k, *v.shape)
        splits, rows = gops.xtv_plan(m, n, vb.shape[2], x.dtype, sms, k)
        out = []
        for b in range(k):
            parts = [x[b, s * rows:(s + 1) * rows].mT
                     @ vb[b, s * rows:(s + 1) * rows]
                     for s in range(splits)]
            out.append(_xtv_reduce_order(parts))
        return torch.stack(out), splits

    @pytest.mark.parametrize("k,m,n", [(3, 300, 12), (5, 1696, 70),
                                       (2, 1, 5)])
    def test_gram_rule(self, rng, k, m, n):
        from repro_torch.kernels.gram import ops as gops
        from repro_torch.kernels.gram import ref as gref
        x = torch.from_numpy(rng.normal(size=(k, m, n)))
        got = torch.func.vmap(gops.gram_op)(x)
        lone = torch.stack([gops.gram(x[b]) for b in range(k)])
        emu, _ = self._emulated_gram(x)
        for b in range(k):
            assert gref.scaled_err(got[b], lone[b], x[b], x[b]) <= 1e-12
            assert gref.scaled_err(emu[b], lone[b], x[b], x[b]) <= 1e-12
        assert torch.equal(got, got.mT)

    @pytest.mark.parametrize("route", ["both", "broadcast", "fold"])
    def test_xtv_rule(self, rng, route):
        from repro_torch.kernels.gram import ops as gops
        from repro_torch.kernels.gram import ref as gref
        k, m, n, c = 4, 2000, 40, 3
        x = torch.from_numpy(rng.normal(size=(k, m, n)))
        v = torch.from_numpy(rng.normal(size=(k, m, c)))
        if route == "both":
            got = torch.func.vmap(gops.xtv_op)(x, v)
            pairs = [(x[b], v[b]) for b in range(k)]
            emu, _ = self._emulated_xtv(x, v)
        elif route == "broadcast":
            got = torch.func.vmap(gops.xtv_op, in_dims=(0, None))(x, v[0])
            pairs = [(x[b], v[0]) for b in range(k)]
            emu, _ = self._emulated_xtv(x, v[0])
        else:  # one X, a batch of v: folded into k·c columns
            got = torch.func.vmap(gops.xtv_op, in_dims=(None, 0))(x[0], v)
            pairs = [(x[0], v[b]) for b in range(k)]
            emu = None
        for b, (xb, vb) in enumerate(pairs):
            want = gops.xtv(xb, vb)
            assert gref.scaled_err(got[b], want, xb, vb) <= 1e-12
            if emu is not None:
                assert gref.scaled_err(emu[b], want, xb, vb) <= 1e-12

    @pytest.mark.parametrize("kind", ["spmm", "xtv"])
    def test_sparse_fold_rule(self, rng, kind):
        """A sparse grid's variant suffix (X @ β over the λs, X bcoo): the
        masked ops under torch.func.vmap fold the batch into the dense
        operand's columns, against per-slice calls of the masked product;
        a batched sparse operand is refused (it has no batched lane)."""
        from repro_torch.kernels.gram import ref as gref
        from repro_torch.kernels.spmm import ops as sops
        from repro_torch.kernels.spmm import ref as sref
        k, m, n, c = 5, 700, 150, 2
        keep = np.kron(rng.random((3, 3)) < 0.5, np.ones((256, 64)))
        xd = torch.from_numpy(rng.normal(size=(m, n)) * keep[:m, :n])
        mask = sref.block_mask(xd, sops.ROWS, sops.TILE)
        rows = n if kind == "spmm" else m
        w = torch.from_numpy(rng.normal(size=(k, rows, c)))
        op, lone = ((sops.spmm_masked_op, sops.spmm_dense_masked)
                    if kind == "spmm" else
                    (sops.xtv_masked_op, sops.xtv_dense_masked))
        got = torch.func.vmap(op, in_dims=(None, 0, None))(xd, w, mask)
        for b in range(k):
            want = lone(xd, w[b], mask)
            a = xd.mT if kind == "spmm" else xd
            assert gref.scaled_err(got[b], want, a, w[b]) <= 1e-12
        with pytest.raises(NotImplementedError, match="batched sparse"):
            torch.func.vmap(op, in_dims=(0, 0, None))(
                xd.expand(k, m, n), w, mask)

    @pytest.mark.parametrize("k,m,n", [(8, 12_500, 1000), (3, 8192, 1000),
                                       (70, 1000, 64)])
    def test_batched_plans_cover_the_batch(self, k, m, n):
        """One plan for the whole batch: every element's rows covered
        once, no empty split; the workspace slot (element, split, tile)
        of each block distinct and inside the allocation; a batch of one
        keeps the lone call's plan (the unbatched kernels' bits)."""
        from repro_torch.kernels.gram import ops as gops
        for dt in (torch.float64, torch.float32, torch.bfloat16):
            tile_n, splits, rows = gops.gram_plan(m, n, dt, 132, 128, k)
            assert (splits - 1) * rows < m <= splits * rows
            tiles = gops.gram_tiles(n, tile_n)
            slots = {(b * splits + s) * tiles + t for b in range(k)
                     for s in range(splits) for t in range(tiles)}
            assert len(slots) == k * splits * tiles == max(slots) + 1
            assert gops.gram_plan(m, n, dt, 132, 128, 1) == \
                gops.gram_plan(m, n, dt, 132, 128)
            xs, xr = gops.xtv_plan(m, n, 1, dt, 132, k)
            assert (xs - 1) * xr < m <= xs * xr
            assert gops.xtv_plan(m, n, 1, dt, 132, 1) == \
                gops.xtv_plan(m, n, 1, dt, 132)


def test_variant_streamed_segment_is_refused(rng, monkeypatch):
    """A grid whose variant value meets a chunked reduction (xtv(X, y·λ)
    with X above CHUNK_MEM_BUDGET) has no batched lane: the reference
    fails on the stream's row counts, the port refuses by name; the
    sequential mode runs in both and agrees (ROADMAP Queue 3 item 28)."""
    monkeypatch.setattr(rcm, "CHUNK_MEM_BUDGET", 1 << 16)
    monkeypatch.setattr(tcm, "CHUNK_MEM_BUDGET", 1 << 16)
    xn, yn = rng.normal(size=(4096, 8)), rng.normal(size=(4096, 1))
    lams = [0.5, 2.0, 3.0]
    seq = {}
    for key, (pk, _, val) in PKGS.items():
        X, y = pk.input_tensor("vcX", xn), pk.input_tensor("vcy", yn)

        def model(lam, pk=pk, X=X, y=y):
            return pk.ops.xtv(X, y * float(lam))
        err = NotImplementedError if key == "port" else ValueError
        with pytest.raises(err):
            val.parfor(lams, model, runtime=_rt(key), mode="vmap")
        seq[key] = val.parfor(lams, model, runtime=_rt(key),
                              mode="sequential")
    for (p,), (r,), lam in zip(seq["port"], seq["ref"], lams):
        _close(p, r)
        _close(p, xn.T @ (yn * lam))


class TestFederatedGrid:
    """tests/test_parfor.py::TestFederatedGrid, in both packages."""

    FEDS = {"ref": RFed, "port": FederatedTensor}

    def _run(self, key, xn, yn, lams, mode, cache=False):
        pk, _, val = PKGS[key]
        fed = self.FEDS[key].partition_rows(xn, 3)
        rt = _rt(key, cache=pk.ReuseCache() if cache else None)
        X = pk.federated_input("tfX", fed)
        y = pk.input_tensor("tfy", yn)
        betas, losses = val.grid_search_lm(X, y, lams, runtime=rt,
                                           mode=mode)
        return np.asarray(betas), np.asarray(losses), rt.stats.exchange

    def test_one_round_per_site_independent_of_k(self, rng):
        xn = rng.normal(size=(300, 12))
        yn = rng.normal(size=(300, 1))
        lams = [0.1, 0.5, 1.0, 5.0]           # k=4 == bucket: exact
        out = {}
        for key in PKGS:
            b_bat, l_bat, ex_bat = self._run(key, xn, yn, lams, "vmap")
            _, _, ex_one = self._run(key, xn, yn, lams[:1], "sequential")
            b_seq, l_seq, ex_seq = self._run(key, xn, yn, lams,
                                             "sequential", cache=True)
            _close(b_bat, b_seq)
            np.testing.assert_allclose(l_bat, l_seq, rtol=1e-8)
            # rounds: same as a single-config run, k-independent
            assert ex_bat.rounds_per_site == ex_one.rounds_per_site
            assert ex_seq.rounds > ex_bat.rounds
            # payload: one batched exchange == k sequential exchanges'
            # bytes (gram/xtv exchanged once on both paths)
            assert ex_bat.total == ex_seq.total
            out[key] = (b_bat, l_bat, ex_bat.as_dict(), ex_seq.as_dict())
        _close(out["port"][0], out["ref"][0])
        np.testing.assert_allclose(out["port"][1], out["ref"][1],
                                   rtol=1e-8)
        assert out["port"][2:] == out["ref"][2:]

    def test_non_pow2_k_exchanges_true_k_payload(self, rng):
        """k=3 pads to a bucket of 4 for closure shapes, but only the
        TRUE 3 configs ever cross the federation boundary."""
        xn = rng.normal(size=(200, 8))
        yn = rng.normal(size=(200, 1))
        lams = [0.1, 1.0, 10.0]
        out = {}
        for key in PKGS:
            b_bat, l_bat, ex_bat = self._run(key, xn, yn, lams, "vmap")
            b_seq, l_seq, ex_seq = self._run(key, xn, yn, lams,
                                             "sequential", cache=True)
            _close(b_bat, b_seq)
            np.testing.assert_allclose(l_bat, l_seq, rtol=1e-8)
            assert ex_bat.total == ex_seq.total
            assert ex_seq.rounds > ex_bat.rounds
            out[key] = ex_bat.as_dict()
        assert out["port"] == out["ref"]

    def test_fed_exchange_bytes_scale_with_k_not_rounds(self, rng):
        xn = rng.normal(size=(200, 8))
        yn = rng.normal(size=(200, 1))
        _, _, ex4 = self._run("port", xn, yn, [0.1, 0.5, 1.0, 5.0], "vmap")
        _, _, ex8 = self._run(
            "port", xn, yn, [0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0],
            "vmap")
        assert ex8.rounds == ex4.rounds
        assert ex8.total > ex4.total   # payload grows, trips do not

    @pytest.mark.parametrize("depth", ["1", "2"])
    def test_batched_fed_map_grid_matches_reference(self, rng, monkeypatch,
                                                    depth):
        """A grid whose variant operand meets a fed_map (X * λ, then
        colSums): the batched site layout (k, rows_i, c) and its
        exchange, against the sequential loop and the reference."""
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
        xn = rng.normal(size=(90, 5))
        lams = [0.5, 2.0, 3.0]
        out = {}
        for key in PKGS:
            pk, _, val = PKGS[key]
            X = pk.federated_input(
                "fmX", self.FEDS[key].partition_rows(xn, 3))

            def model(lam, pk=pk, X=X):
                return pk.ops.colSums(X * float(lam))
            rt = _rt(key)
            bat = val.parfor(lams, model, runtime=rt, mode="vmap")
            assert rt.stats.batched_segments > 0
            seq = val.parfor(lams, model, runtime=_rt(key),
                             mode="sequential")
            for (b,), (q,) in zip(bat, seq):
                _close(b, q)
            out[key] = (bat, rt.stats.exchange.as_dict())
        for (p,), (r,) in zip(out["port"][0], out["ref"][0]):
            _close(p, r)
        assert out["port"][1] == out["ref"][1]
