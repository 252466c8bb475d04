"""Federated placement: the port's `repro_torch.core.federated`, its
`lower_federated` pass and its federated executor against the reference.

Mirrors tests/test_federated.py (the eager `FederatedTensor` oracle and
its exchange accounting; the FedAvg trainer is not ported) and
tests/test_fed_placement.py (plans compiled through the DAG -> cost
model -> segment stack, parity three ways, exchange accounting, reuse,
validation), on the CPU. Each case also runs the reference on the same
seeded numpy data: plans compare equal under `canon` (every compile-time
decision and the `explain()` text, uids renumbered), lineage traces are
equal, results agree within the reference tests' tolerances, and the
exchange log — bytes per site and rounds — equals both the reference's
and the eager oracle's exactly. The compiled-path classes run at
pipeline depths 1 and 2, the reference at the port's depth; everything
else at depth 1.
"""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st
from test_torch_compiler import canon

import repro.core as R
import repro_torch.core as T
from repro.core.federated import FederatedTensor as RFed
from repro.core.federated import federated_lmds as rfederated_lmds
from repro.lifecycle import lmDS_federated as rlmDS_federated
from repro.lifecycle import pca as rpca
from repro.lifecycle import steplm_federated as rsteplm_federated
from repro_torch.core import (FederatedTensor, LineageRuntime, ReuseCache,
                              federated_input, get_jit_cache, input_tensor,
                              ops)
from repro_torch.core.compiler import compile_plan
from repro_torch.core.federated import LocalSite, federated_lmds
from repro_torch.lifecycle import lmDS_federated, steplm, steplm_federated

PKGS = {"ref": R, "port": T}
FEDS = {"ref": RFed, "port": FederatedTensor}


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


@pytest.fixture(params=["1", "2"])
def depth(request, monkeypatch):
    """Both pipeline depths, for the port and the reference alike."""
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", request.param)
    return request.param


def _rt(key, **kw):
    if key == "port":
        return LineageRuntime(device="cpu", **kw)
    return R.LineageRuntime(**kw)


def _lmds_graph(pk, X, Y, reg=1e-6):
    n = X.shape[1]
    return pk.ops.solve(pk.ops.gram(X) + reg * pk.ops.eye(n),
                        pk.ops.xtv(X, Y))


@pytest.fixture
def data(rng):
    x = rng.normal(size=(211, 7))  # ragged row count across sites
    y = x @ rng.normal(size=(7, 1)) + 0.01 * rng.normal(size=(211, 1))
    return x, y


@pytest.fixture
def fed(rng):
    x = rng.normal(size=(97, 8))   # deliberately ragged row count
    return x, FederatedTensor.partition_rows(x, 4)


# ---------------------------------------------------------------------------
# tests/test_federated.py: the eager oracle
# ---------------------------------------------------------------------------

class TestFederatedOps:
    def test_mv(self, fed, rng):
        x, f = fed
        v = rng.normal(size=(8, 1))
        np.testing.assert_allclose(f.fed_mv(v), x @ v, rtol=1e-10)

    def test_vm(self, fed, rng):
        x, f = fed
        v = rng.normal(size=(97, 1))
        np.testing.assert_allclose(f.fed_vm(v), v.T @ x, rtol=1e-10)

    def test_gram(self, fed):
        x, f = fed
        np.testing.assert_allclose(f.fed_gram(), x.T @ x, rtol=1e-10)

    def test_xtv(self, fed, rng):
        x, f = fed
        y = rng.normal(size=(97, 1))
        np.testing.assert_allclose(f.fed_xtv(y), x.T @ y, rtol=1e-10)

    def test_colsums(self, fed):
        x, f = fed
        np.testing.assert_allclose(f.fed_colsums(),
                                   x.sum(axis=0, keepdims=True))

    def test_oracle_and_log_match_reference(self, fed, rng):
        x, f = fed
        r = RFed.partition_rows(x, 4)
        v, w = rng.normal(size=(8, 1)), rng.normal(size=(97, 1))
        for a, b in ((f.fed_mv(v), r.fed_mv(v)),
                     (f.fed_vm(w), r.fed_vm(w)),
                     (f.fed_gram(), r.fed_gram()),
                     (f.fed_xtv(w), r.fed_xtv(w)),
                     (f.fed_colsums(), r.fed_colsums()),
                     (f.collect(), r.collect())):
            assert np.array_equal(a, b)
        assert f.log.as_dict() == r.log.as_dict()
        assert f.ranges == r.ranges


class TestEagerExchangeAccounting:
    def test_gram_exchange_is_data_independent(self, rng):
        """The paper's point: only n×n aggregates leave the sites."""
        for rows in (100, 1000):
            x = rng.normal(size=(rows, 8))
            f = FederatedTensor.partition_rows(x, 4)
            f.fed_gram()
            assert f.log.from_sites == 4 * 8 * 8 * 8  # 4 sites × n² f64
            assert f.log.to_sites == 0                # data never moves

    def test_vm_sends_only_slices(self, rng):
        x = rng.normal(size=(100, 8))
        f = FederatedTensor.partition_rows(x, 4)
        v = rng.normal(size=(100, 1))
        f.fed_vm(v)
        assert f.log.to_sites == 100 * 8  # the full vector split once

    def test_mv_broadcast_cost(self, rng):
        x = rng.normal(size=(100, 8))
        f = FederatedTensor.partition_rows(x, 4)
        f.fed_mv(rng.normal(size=(8, 1)))
        assert f.log.to_sites == 4 * 8 * 8  # v broadcast to 4 sites


class TestFederatedLmDS:
    def test_matches_centralized(self, rng):
        x = rng.normal(size=(200, 6))
        y = x @ rng.normal(size=(6, 1)) + 0.01 * rng.normal(size=(200, 1))
        f = FederatedTensor.partition_rows(x, 3)
        b = federated_lmds(f, y, reg=1e-6)
        ref = np.linalg.solve(x.T @ x + 1e-6 * np.eye(6), x.T @ y)
        np.testing.assert_allclose(b, ref, rtol=1e-8)
        assert np.array_equal(
            b, rfederated_lmds(RFed.partition_rows(x, 3), y, reg=1e-6))

    def test_intercept(self, rng):
        x = rng.normal(size=(120, 4))
        y = rng.normal(size=(120, 1))
        b = federated_lmds(FederatedTensor.partition_rows(x, 2), y,
                           intercept=True)
        assert b.shape == (5, 1)


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 8), st.integers(10, 200), st.integers(1, 12),
       st.integers(0, 10 ** 6))
def test_partition_invariance_property(n_sites, rows, cols, seed):
    """Federated results must not depend on the partitioning."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, cols))
    f1 = FederatedTensor.partition_rows(x, min(n_sites, rows))
    f2 = FederatedTensor.partition_rows(x, 1)
    np.testing.assert_allclose(f1.fed_gram(), f2.fed_gram(), rtol=1e-8,
                               atol=1e-9)
    v = rng.normal(size=(cols, 1))
    np.testing.assert_allclose(f1.fed_mv(v), f2.fed_mv(v), rtol=1e-8,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# tests/test_fed_placement.py: federation as a compiler placement
# ---------------------------------------------------------------------------

class TestPlacementCompilation:
    def _plans(self, data, build):
        x, y = data
        return {k: PKGS[k].compile_plan(
            build(PKGS[k], PKGS[k].federated_input(
                "X", FEDS[k].partition_rows(x, 3)),
                PKGS[k].input_tensor("y", y)))
            for k in PKGS}

    def test_explain_shows_fed_instructions(self, data):
        plans = self._plans(data, lambda pk, X, Y: [_lmds_graph(pk, X, Y)])
        plan = plans["port"]
        txt = plan.explain()
        assert "fed_gram" in txt and "fed_xtv" in txt
        assert "[F]" in txt          # federated execution target
        assert ":fed" in txt         # federated value placement
        ops_seen = plan.count_ops()
        assert "gram" not in ops_seen and "xtv" not in ops_seen
        assert "collect" not in ops_seen  # lmDS federates end-to-end
        assert canon(plan) == canon(plans["ref"])

    @pytest.mark.parametrize("prog", ["rowsums", "two", "chain", "icpt",
                                      "pca"])
    def test_plans_match_reference(self, data, prog):
        builds = {
            "rowsums": lambda pk, X, Y: [pk.ops.rowSums(X)],
            "two": lambda pk, X, Y: [pk.ops.rowSums(X), pk.ops.cumsum(X)],
            "chain": lambda pk, X, Y: [
                pk.ops.colSums(pk.ops.abs_(X) * 2.0)],
            "icpt": lambda pk, X, Y: [_lmds_graph(
                pk, pk.ops.cbind(X, pk.ops.ones((X.shape[0], 1))), Y)],
            "pca": lambda pk, X, Y: [pk.ops.gram(X - pk.ops.colMeans(X))],
        }
        plans = self._plans(data, builds[prog])
        assert canon(plans["port"]) == canon(plans["ref"])

    def test_non_lowerable_consumer_gets_collect_boundary(self, data):
        x, _ = data
        X = federated_input("X", FederatedTensor.partition_rows(x, 3))
        plan = compile_plan([ops.rowSums(X)])  # no federated lowering
        assert plan.count_ops().get("collect") == 1
        assert "[collect-boundary]" in plan.explain()

    def test_collect_shared_across_consumers(self, data):
        x, _ = data
        X = federated_input("X", FederatedTensor.partition_rows(x, 3))
        # two non-lowerable consumers -> one shared collect
        plan = compile_plan([ops.rowSums(X), ops.cumsum(X)])
        assert plan.count_ops().get("collect") == 1

    def test_row_preserving_chain_stays_federated(self, data):
        x, _ = data
        X = federated_input("X", FederatedTensor.partition_rows(x, 4))
        out = ops.colSums(ops.abs_(X) * 2.0)
        plan = compile_plan([out])
        counts = plan.count_ops()
        assert counts.get("fed_map", 0) == 2     # abs, scalar mul
        assert counts.get("fed_colsums") == 1
        assert "collect" not in counts           # nothing materializes

    def test_fed_instruction_targets_are_federated(self, data):
        x, y = data
        fed = FederatedTensor.partition_rows(x, 3)
        plan = compile_plan([_lmds_graph(T, federated_input("X", fed),
                                         input_tensor("y", y))])
        for ins in plan.instructions:
            is_fed_op = (ins.node.op.startswith("fed_")
                         or ins.node.op == "collect")
            assert (ins.target == "federated") == is_fed_op
        # federated instructions are single-op segments; local work fuses
        segs = plan.segments_for(False)
        for seg in segs:
            if seg.target == "federated":
                assert len(seg.instructions) == 1
        assert any(seg.fused for seg in segs)

    def test_lineage_trace_matches_reference(self, data):
        x, y = data
        traces = {}
        for k, pk in PKGS.items():
            X = pk.federated_input("X", FEDS[k].partition_rows(x, 3))
            traces[k] = pk.lineage_trace(
                _lmds_graph(pk, X, pk.input_tensor("y", y)))
        assert traces["port"] == traces["ref"]


@pytest.mark.usefixtures("depth")
class TestFederatedParity:
    def test_lmds_three_ways(self, data):
        """fused vs interpreter vs eager numpy oracle vs dense solve, and
        the reference's compiled run."""
        x, y = data
        ref = np.linalg.solve(x.T @ x + 1e-6 * np.eye(7), x.T @ y)
        oracle = federated_lmds(FederatedTensor.partition_rows(x, 3), y,
                                reg=1e-6)
        rb = rlmDS_federated(
            RFed.partition_rows(x, 3), y, reg=1e-6,
            runtime=R.LineageRuntime())
        got = {}
        for fuse in (True, False):
            fed = FederatedTensor.partition_rows(x, 3)
            rt = LineageRuntime(fuse=fuse, device="cpu")
            b = lmDS_federated(fed, y, reg=1e-6, runtime=rt)
            np.testing.assert_allclose(b, ref, rtol=1e-8)
            np.testing.assert_allclose(b, oracle, rtol=1e-8)
            np.testing.assert_allclose(b, rb, rtol=1e-10)
            got[fuse] = b
        assert np.array_equal(got[True], got[False])

    def test_lmds_intercept(self, data):
        x, y = data
        xi = np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)
        ref = np.linalg.solve(xi.T @ xi + 1e-6 * np.eye(8), xi.T @ y)
        fed = FederatedTensor.partition_rows(x, 3)
        b = lmDS_federated(fed, y, reg=1e-6, intercept=True,
                           runtime=LineageRuntime(device="cpu"))
        np.testing.assert_allclose(b, ref, rtol=1e-8)

    def test_steplm_matches_local(self, data):
        x, y = data
        rt_local = LineageRuntime(device="cpu")
        beta_l, sel_l = steplm(input_tensor("X", x), input_tensor("y", y),
                               max_features=3, runtime=rt_local)
        rb, rsel = rsteplm_federated(
            RFed.partition_rows(x, 3), y, max_features=3,
            runtime=R.LineageRuntime(cache=R.ReuseCache()))
        for fuse in (True, False):
            fed = FederatedTensor.partition_rows(x, 3)
            rt = LineageRuntime(fuse=fuse, cache=ReuseCache(), device="cpu")
            beta_f, sel_f = steplm_federated(fed, y, max_features=3,
                                             runtime=rt)
            assert sel_f == sel_l == rsel
            np.testing.assert_allclose(beta_f, beta_l, rtol=1e-7)
            np.testing.assert_allclose(beta_f, rb, rtol=1e-10)
            assert rt.cache.stats.hits > 0  # federated partial reuse

    def test_steplm_reuse_and_exchange_match_reference(self, data):
        x, y = data

        def run(key):
            rt = _rt(key, cache=PKGS[key].ReuseCache())
            fn = steplm_federated if key == "port" else rsteplm_federated
            fn(FEDS[key].partition_rows(x, 3), y, max_features=3,
               runtime=rt)
            c = rt.cache.stats
            return (c.probes, c.hits, c.misses,
                    rt.stats.exchange.as_dict())

        assert run("port") == run("ref")

    def test_float32_plan_keeps_dtype(self, rng):
        """Per-site generated operands carry the generator's dtype — an
        f32 federated plan must not be silently promoted to f64."""
        x = rng.normal(size=(120, 5)).astype(np.float32)
        X = federated_input("f32X", FederatedTensor.partition_rows(x, 2))
        out = ops.gram(ops.cbind(ops.ones((120, 1), np.float32), X))
        g = LineageRuntime(device="cpu").evaluate([out])[0]
        assert g.dtype == np.float32
        xi = np.concatenate([np.ones((120, 1), np.float32), x], axis=1)
        np.testing.assert_allclose(g, xi.T @ xi, rtol=1e-4)

    def test_pca_federated(self, rng):
        from repro_torch.lifecycle import pca
        x = rng.normal(size=(160, 5)) @ np.diag([4.0, 2.0, 1.0, 0.5, 0.1])
        comps_l, proj_l = pca(input_tensor("X", x), k=2,
                              runtime=LineageRuntime(device="cpu"))
        fed = FederatedTensor.partition_rows(x, 4)
        comps_f, proj_f = pca(federated_input("Xf", fed), k=2,
                              runtime=LineageRuntime(device="cpu"))
        np.testing.assert_allclose(np.abs(comps_f), np.abs(comps_l),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.abs(proj_f), np.abs(proj_l),
                                   rtol=1e-6, atol=1e-8)
        rc, rp = rpca(
            R.federated_input("Xf", RFed.partition_rows(x, 4)), k=2,
            runtime=R.LineageRuntime())
        np.testing.assert_allclose(np.abs(comps_f), np.abs(rc),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.abs(proj_f), np.abs(rp),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.usefixtures("depth")
class TestExchangeAccounting:
    def _run(self, key, x, y, fuse, intercept=False):
        fed = FEDS[key].partition_rows(x, 3)
        rt = _rt(key, fuse=fuse)
        fn = lmDS_federated if key == "port" else rlmDS_federated
        fn(fed, y, reg=1e-6, intercept=intercept, runtime=rt)
        return rt.stats.exchange.as_dict()

    def test_bytes_identical_across_fuse_modes(self, data):
        x, y = data
        assert self._run("port", x, y, True) == \
            self._run("port", x, y, False)

    @pytest.mark.parametrize("fuse", [True, False])
    @pytest.mark.parametrize("intercept", [False, True])
    def test_bytes_match_eager_oracle_exactly(self, data, intercept,
                                              fuse):
        """The acceptance criterion: the compiled plan exchanges exactly
        the bytes the eager `federated_lmds` oracle does — per site — and
        the reference's compiled plan does."""
        x, y = data
        f = FederatedTensor.partition_rows(x, 3)
        federated_lmds(f, y, reg=1e-6, intercept=intercept)
        compiled = self._run("port", x, y, fuse, intercept=intercept)
        assert compiled == f.log.as_dict()
        assert compiled == self._run(
            "ref", x, y, fuse, intercept=intercept)

    def test_costmodel_fed_map_estimate_matches_runtime(self, data):
        """`fed_args`/`gen_args` index the inner argument list while the
        node's inputs are compacted — the compile-time exchange estimate
        must walk positions the way the executor does."""
        from repro.core import costmodel as rcm
        from repro_torch.core import costmodel
        x, _ = data
        X = federated_input("gX", FederatedTensor.partition_rows(x, 3))
        out = ops.colSums(ops.cbind(ops.ones((x.shape[0], 1)), X))
        plan = compile_plan([out])
        fm = next(i.node for i in plan.instructions
                  if i.node.op == "fed_map")
        assert costmodel.fed_exchange_bytes(fm) == (0.0, 0.0)
        assert costmodel.FED_TRIP_S == rcm.FED_TRIP_S
        assert costmodel.NET_BW == rcm.NET_BW
        rt = LineageRuntime(device="cpu")
        rt.evaluate([out])
        assert rt.stats.exchange.to_sites == 0  # ones generated on site

    def test_fed_map_exchanges_nothing_for_onsite_work(self, data):
        x, _ = data
        X = federated_input("X", FederatedTensor.partition_rows(x, 3))
        rt = LineageRuntime(device="cpu")
        rt.evaluate([ops.colSums(ops.abs_(X))])
        ex = rt.stats.exchange
        assert ex.to_sites == 0                 # nothing broadcast
        assert ex.from_sites == 3 * x.shape[1] * 8  # one row per site

    @pytest.mark.parametrize("prog", ["mv", "vm", "collect", "bcast"])
    def test_other_instructions_match_reference(self, data, prog):
        """fed_mv, fed_vm, collect and a broadcast-row fed_map: results
        within rel 1e-10 and exchange logs equal to the reference's."""
        x, y = data
        w = np.linspace(-1.0, 1.0, x.shape[1])[:, None]
        row = np.linspace(0.5, 1.5, x.shape[1])[None, :]

        def build(pk, X):
            if prog == "mv":
                return [X @ pk.input_tensor("w", w)]
            if prog == "vm":
                return [pk.ops.xtv(pk.input_tensor("v", y), X)]
            if prog == "collect":
                return [pk.ops.rowSums(X)]
            return [pk.ops.colSums(X * pk.input_tensor("r", row))]

        def run(key):
            pk = PKGS[key]
            rt = _rt(key)
            out = rt.evaluate(build(pk, pk.federated_input(
                "X", FEDS[key].partition_rows(x, 3))))[0]
            return np.asarray(out), rt.stats.exchange.as_dict()

        got, ex = run("port")
        want, rex = run("ref")
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
        assert ex == rex


@pytest.mark.usefixtures("depth")
class TestFederatedReuse:
    def _hpo(self, x, y, fuse):
        X = federated_input("hpoX", FederatedTensor.partition_rows(x, 3))
        Y = input_tensor("hpoy", y)
        rt = LineageRuntime(fuse=fuse, cache=ReuseCache(), device="cpu")
        for lam in (0.1, 1.0, 10.0):
            rt.evaluate([_lmds_graph(T, X, Y, reg=lam)])
        return rt

    def test_hit_parity_across_fuse_modes(self, data):
        x, y = data
        rt_f, rt_i = self._hpo(x, y, True), self._hpo(x, y, False)
        sf, si = rt_f.cache.stats, rt_i.cache.stats
        assert (sf.probes, sf.hits, sf.misses) == \
            (si.probes, si.hits, si.misses)
        assert sf.hits >= 4  # fed_gram + fed_xtv reused for 2 lambdas

    def test_reuse_hit_skips_exchange(self, data):
        """A lineage hit on a federated intermediate skips the sites
        entirely — no recompute, no exchange, in both modes."""
        x, y = data
        for fuse in (True, False):
            rt = self._hpo(x, y, fuse)
            one = LineageRuntime(fuse=fuse, device="cpu")
            one.evaluate([_lmds_graph(
                T, federated_input("oX", FederatedTensor.partition_rows(
                    x, 3)), input_tensor("oy", y), reg=0.1)])
            assert rt.stats.exchange.as_dict() == \
                one.stats.exchange.as_dict()

    def test_per_site_work_hits_jit_cache_on_repeat(self, data):
        x, y = data
        X = federated_input("wX", FederatedTensor.partition_rows(x, 3))
        Y = input_tensor("wy", y)
        from repro_torch.core import clear_jit_cache
        clear_jit_cache()          # deterministic cold start
        rt = LineageRuntime(device="cpu")
        plan = compile_plan([_lmds_graph(T, X, Y)])
        rt.run_plan(plan)          # build the per-site closures
        assert rt.stats.trace_time > 0  # per-site builds booked here
        st_ = get_jit_cache().stats
        before = st_.hits
        hits_before = rt.stats.jit_cache_hits
        trace_before = rt.stats.trace_time
        rt.run_plan(plan)          # warm replay
        # >= 6 warm per-site lookups (gram + xtv on 3 sites) plus the
        # local segments
        assert st_.hits - before >= 6
        assert rt.stats.jit_cache_hits - hits_before >= 6
        assert rt.stats.trace_time == trace_before  # nothing rebuilt

    def test_site_partition_uploaded_once(self, data):
        """A site keeps its partition on the runtime's device after the
        first call; the upload is never metered as an exchange."""
        x, y = data
        fed = FederatedTensor.partition_rows(x, 3)
        rt = LineageRuntime(device="cpu")
        lmDS_federated(fed, y, reg=1e-6, runtime=rt)
        held = [s._resident[2] for s in fed.sites]
        ex = rt.stats.exchange.as_dict()
        rt2 = LineageRuntime(device="cpu")
        lmDS_federated(fed, y, reg=1e-6, runtime=rt2)
        assert all(s._resident[2] is h for s, h in zip(fed.sites, held))
        assert rt2.stats.exchange.as_dict() == ex
        assert ex["from_sites"] == 3 * (7 * 7 + 7) * 8  # aggregates only


class TestValidation:
    def test_zero_site_tensor_raises(self):
        f = FederatedTensor(sites=[], ranges=[], ncols=4)
        for op in (lambda: f.fed_colsums(), lambda: f.fed_vm(np.ones((4, 1))),
                   lambda: f.fed_xtv(np.ones((0, 1))), lambda: f.fed_gram(),
                   lambda: f.fed_mv(np.ones((4, 1))), lambda: f.collect()):
            with pytest.raises(ValueError, match="zero sites"):
                op()

    def test_partition_rows_validates_site_count(self, rng):
        x = rng.normal(size=(5, 3))
        with pytest.raises(ValueError, match="n_sites"):
            FederatedTensor.partition_rows(x, 6)  # n_sites > nrows
        with pytest.raises(ValueError, match="n_sites"):
            FederatedTensor.partition_rows(x, 0)
        with pytest.raises(ValueError, match="matrix"):
            FederatedTensor.partition_rows(np.ones(5), 2)

    def test_misaligned_federated_operands_raise(self, rng):
        x = rng.normal(size=(100, 4))
        f1 = FederatedTensor.partition_rows(x, 2)        # 50/50
        f2 = FederatedTensor(                            # 30/70
            sites=[LocalSite(x[:30]), LocalSite(x[30:])],
            ranges=[(0, 30), (30, 100)], ncols=4)
        out = federated_input("a", f1) * federated_input("b", f2)
        with pytest.raises(ValueError, match="aligned"):
            LineageRuntime(device="cpu").evaluate([ops.colSums(out)])

    def test_prepared_script_arity_error(self, rng):
        from repro_torch.core import PreparedScript
        ps = PreparedScript(lambda a: a * 2.0, [(4, 4)],
                            runtime=LineageRuntime(device="cpu"))
        with pytest.raises(ValueError, match="argument"):
            ps(np.ones((4, 4)), np.ones((4, 4)))
