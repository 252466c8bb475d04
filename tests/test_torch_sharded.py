"""Sharded placement: the port's mesh (`repro_torch.distributed.mesh`),
`lower_distributed`, its sharded segments and shard meter against the
reference.

Mirrors tests/test_sharded.py class by class, in-process: where the
reference forces an 8-device host mesh in a subprocess, the port lays 8
logical devices over the CPU (`logical_devices(8)`, restored after each
case), and its sharded closures run every shard of a segment in
lockstep. Plans compiled under `MeshSpec(data=d)` for d in {2, 4, 8}
compare equal to the reference's under `canon` (every compile-time
decision and the `explain()` text, uids renumbered); cost-model values
are the reference's floats exactly; sharded results agree with the
reference's local results within the reference tests' tolerances; the
shard meter equals the reference's collective formulas walked over the
reference's plan. The port's own: a sharded run is bitwise repeatable
and bitwise across pipeline depths 1 and 2, a sharded leaf is neither
streamed nor donated, a `compile` fault on a sharded segment re-raises,
and the `fuse=False` interpreter runs shard-exec ops unsharded.
"""
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from test_torch_compiler import canon

import repro.core as R
import repro_torch.core as T
from repro.core import costmodel as rcm
from repro.distributed import MeshSpec as RMeshSpec
from repro.distributed import use_mesh as ruse_mesh
from repro_torch.core import backend, costmodel, faults
from repro_torch.core.compiler import compile_plan, lower_distributed
from repro_torch.core.faults import CompileFailedError
from repro_torch.distributed import (MeshSpec, auto_mesh, device_count,
                                     get_mesh, logical_devices,
                                     rows_shardable, safe_spec, use_mesh)

PKGS = {"ref": R, "port": T}
MESHES = {"ref": RMeshSpec, "port": MeshSpec}


@pytest.fixture(autouse=True)
def sync_lane(monkeypatch):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", "1")


@pytest.fixture
def eight():
    """8 logical devices over the CPU, for one case."""
    with logical_devices(8):
        yield


def _rt(key="port", **kw):
    if key == "port":
        return T.LineageRuntime(device="cpu", **kw)
    return R.LineageRuntime(**kw)


def _segs(plan):
    return plan.segments_for(False)


def _ops_in(plan) -> set:
    return {ins.node.op for seg in _segs(plan) for ins in seg.instructions}


def _big(pk, name: str, rows: int = 4096, cols: int = 64, seed: int = 7):
    return pk.input_tensor(name, np.random.default_rng(seed).normal(
        size=(rows, cols)))


def _lmds(pk, X, y, n=64):
    A = pk.ops.gram(X) + 1e-3 * pk.ops.eye(n)
    beta = pk.ops.solve(A, pk.ops.xtv(X, y))
    resid = y - X @ beta
    return [beta, pk.ops.sum_(resid * resid)]


def _meter(plan, cm, bk) -> dict:
    """The shard meter one run of `plan` must show: its sharded segments'
    reduces and reshards, bytes from the cost model's formulas."""
    out = dict(sharded_segments=0, config_sharded_segments=0, reshards=0,
               collectives=0, collective_bytes=0)
    for seg in _segs(plan):
        if not seg.sharded:
            continue
        out["sharded_segments"] += 1
        for ins in seg.instructions:
            if ins.node.op == bk.RESHARD_OP:
                out["reshards"] += 1
                out["collective_bytes"] += cm.collective_bytes(ins.node)
            elif ins.node.op in bk.SHARD_REDUCE_OPS:
                out["collectives"] += 1
                out["collective_bytes"] += cm.collective_bytes(ins.node)
    return out


def _ref_meter(roots_fn, d) -> dict:
    from repro.core import backend as rbk
    plan = R.compile_plan(roots_fn(R), mesh=RMeshSpec(data=d))
    return _meter(plan, rcm, rbk)


# ---------------------------------------------------------------------------
# TestMeshSpec (+ tests/test_distributed.py's safe_spec case)
# ---------------------------------------------------------------------------

class TestMeshSpec:
    def test_shape_and_key_tag(self):
        ms = MeshSpec(data=8, config=2)
        assert ms.ndev == 16 and ms.shape == (8, 2)
        assert ms.key_tag() == "d8xc2" == RMeshSpec(8, 2).key_tag()
        assert MeshSpec(data=4).key_tag() != ms.key_tag()

    @pytest.mark.parametrize("axes", [dict(data=0), dict(config=0),
                                      dict(data=-1, config=2)])
    def test_rejects_bad_axes(self, axes):
        with pytest.raises(ValueError):
            MeshSpec(**axes)
        with pytest.raises(ValueError):
            RMeshSpec(**axes)

    def test_unrealizable_mesh_resolves_none(self):
        # a CPU runtime sees 1 device: graceful degradation, never an
        # error — as the reference's one-device process
        assert device_count() == 1
        assert MeshSpec(data=8).resolve() is None
        assert RMeshSpec(data=8).jax_mesh() is None
        with logical_devices(8):
            lm = MeshSpec(data=8).resolve()
            assert (lm.data, lm.config) == (8, 1)
            assert MeshSpec(data=4, config=2).resolve() is not None
            assert MeshSpec(data=16).resolve() is None
            assert MeshSpec().resolve() is None  # < 2 devices
        assert device_count() == 1  # restored

    def test_use_mesh_and_auto_mesh(self):
        assert get_mesh() is None
        with use_mesh(data=4, config=2) as ms:
            assert get_mesh() is ms and ms.shape == (4, 2)
        assert get_mesh() is None
        with logical_devices(8):
            assert auto_mesh() == MeshSpec(data=8)
            assert auto_mesh(config=2) == MeshSpec(4, 2)
        assert auto_mesh() == MeshSpec(data=1)

    def test_safe_spec_drops_nondivisible(self):
        from repro.distributed.sharding import safe_spec as rsafe_spec

        class _StubMesh:  # safe_spec only reads mesh.shape sizes
            shape = {"data": 4, "model": 2}
        mesh = _StubMesh()
        assert safe_spec((8, 6), ("data", "model"), mesh) == \
            ("data", "model")
        assert safe_spec((7, 6), ("data", "model"), mesh) == \
            (None, "model")
        for shape, spec in (((8, 6), ("data", "model")),
                            ((7, 6), ("data", "model")),
                            ((8, 3), (("data", "model"), None)),
                            ((16, 5), (("data", "model"), "model")),
                            ((4,), ("data", "model"))):
            assert safe_spec(shape, spec, mesh) == \
                tuple(rsafe_spec(shape, P(*spec), mesh))

    @pytest.mark.parametrize("shape,d", [((4096, 64), 8), ((4100, 64), 8),
                                         ((7, 3), 8), ((8, 3), 8),
                                         ((64,), 4), ((64, 2), 1), ((), 2)])
    def test_rows_shardable_matches_reference(self, shape, d):
        from repro.distributed.sharding import rows_shardable as rrows
        assert rows_shardable(shape, d) == rrows(shape, d)


# ---------------------------------------------------------------------------
# TestLowerDistributed: the reference's programs, plans equal at d 2/4/8
# ---------------------------------------------------------------------------

def _sparse_x(pk):
    x = np.random.default_rng(3).normal(size=(4096, 64))
    x[x < 1.5] = 0.0  # ~93% zero -> format pass pins BCOO
    return pk.input_tensor("sp_X", x)


PROGRAMS = {
    "small_leaf": lambda pk: [pk.ops.gram(_big(pk, "sm_X", 64, 16))],
    "nondivisible": lambda pk: [pk.ops.gram(_big(pk, "nd_X", 4100, 64))],
    "sparse_leaf": lambda pk: [pk.ops.gram(_sparse_x(pk))],
    "gram": lambda pk: [pk.ops.gram(_big(pk, "g_X"))],
    "xtv_colsums_sum": lambda pk: [
        pk.ops.xtv(_big(pk, "r_X"), _big(pk, "r_y", 4096, 1)),
        pk.ops.colMeans(_big(pk, "r_X")), pk.ops.sum_(_big(pk, "r_X"))],
    "row_preserving": lambda pk: [pk.ops.sum_(
        (lambda r: r * r)(_big(pk, "m_X") @ pk.input_tensor(
            "m_w", np.random.default_rng(5).normal(size=(64, 1))) - 1.0))],
    "transpose": lambda pk: [pk.ops.t(_big(pk, "t_X"))],
    "sharded_root": lambda pk: [pk.ops.abs_(_big(pk, "ab_X")),
                                pk.ops.abs_(_big(pk, "ab_X")) * 2.0],
    "lmds": lambda pk: _lmds(pk, _big(pk, "l_X", seed=0),
                             _big(pk, "l_y", 4096, 1, seed=1)),
    "center_and_scale": lambda pk: (lambda X: [
        pk.ops.gram(X - pk.ops.colMeans(X)), pk.ops.rowSums(X),
        pk.ops.colSums(X[:, 0:8])])(_big(pk, "c_X")),
}


def _plans(program, d, reuse=False):
    return {k: pk.compile_plan(PROGRAMS[program](pk), mesh=MESHES[k](data=d),
                               reuse_enabled=reuse)
            for k, pk in PKGS.items()}


class TestLowerDistributed:
    @pytest.mark.parametrize("d", [2, 4, 8])
    @pytest.mark.parametrize("program", sorted(PROGRAMS))
    def test_plans_and_explain_equal_reference(self, program, d):
        plans = _plans(program, d)
        assert canon(plans["ref"]) == canon(plans["port"])
        assert plans["port"].mesh_spec == MeshSpec(data=d)

    @pytest.mark.parametrize("program", ["lmds", "xtv_colsums_sum"])
    def test_reuse_plans_equal_reference(self, program):
        plans = _plans(program, 8, reuse=True)
        assert canon(plans["ref"]) == canon(plans["port"])

    @pytest.mark.parametrize("program", ["small_leaf", "nondivisible",
                                         "sparse_leaf"])
    def test_unshardable_leaf_stays_local(self, program):
        # small (8 KB < SHARD_MIN_LEAF_BYTES), 4100 % 8 != 0, or pinned
        # to BCOO: the pass must not touch the plan
        roots = [o.node for o in PROGRAMS[program](T)]
        assert lower_distributed(roots, 8) is roots

    def test_gram_lowers_to_shard_gram(self):
        plan = _plans("gram", 8)["port"]
        assert "shard_gram" in _ops_in(plan)
        assert any(seg.sharded for seg in _segs(plan))
        assert "[sharded]" in plan.explain()

    def test_xtv_colsums_sum_lower(self):
        got = _ops_in(_plans("xtv_colsums_sum", 8)["port"])
        assert {"shard_xtv", "shard_colsums", "shard_sum"} <= got
        assert "colMeans" not in got and "sum" not in got

    def test_row_preserving_ops_keep_sharding(self):
        plan = _plans("row_preserving", 8)["port"]
        assert "shard_sum" in _ops_in(plan)
        sharded = [seg for seg in _segs(plan) if seg.sharded]
        assert sharded and any(seg.fused for seg in sharded)
        assert "reshard" not in _ops_in(plan)

    @pytest.mark.parametrize("program", ["transpose", "sharded_root"])
    def test_reshard_boundaries(self, program):
        plan = _plans(program, 8)["port"]
        assert "reshard" in _ops_in(plan)
        assert "[reshard-boundary]" in plan.explain()
        assert ":sh" in plan.explain()

    def test_no_mesh_means_no_sharding(self):
        plan = compile_plan(PROGRAMS["gram"](T), mesh=MeshSpec(data=1))
        assert "shard_gram" not in _ops_in(plan)

    def test_plan_records_mesh_spec(self):
        ms = MeshSpec(data=8)
        plan = compile_plan(PROGRAMS["gram"](T), mesh=ms)
        assert plan.mesh_spec is ms
        with use_mesh(data=4):
            plan = compile_plan(PROGRAMS["gram"](T))
        assert plan.mesh_spec == MeshSpec(data=4)
        assert "shard_gram" in _ops_in(plan)

    def test_sharded_leaf_is_never_streamed(self, monkeypatch):
        # lower_distributed runs before lower_chunked: a sharded leaf is
        # not local, so the streaming pass leaves it alone
        for cm in (costmodel, rcm):
            monkeypatch.setattr(cm, "CHUNK_MEM_BUDGET", 1 << 16)
        plans = _plans("lmds", 8)
        assert canon(plans["ref"]) == canon(plans["port"])
        x_uid = next(ins.input_ids[0] for ins in plans["port"].instructions
                     if ins.node.op == "shard_gram")
        assert x_uid not in plans["port"].chunk_sliced
        assert not any(seg.chunked for seg in _segs(plans["port"]))
        local = compile_plan(PROGRAMS["lmds"](T))
        assert any(seg.chunked for seg in _segs(local))


# ---------------------------------------------------------------------------
# TestShardCostModel
# ---------------------------------------------------------------------------

class TestShardCostModel:
    def test_collective_byte_formulas(self):
        from repro.core.dag import make_node as rmake
        from repro_torch.core.dag import make_node
        for mk, cm in ((make_node, costmodel), (rmake, rcm)):
            n = mk("input", (), (128, 64), np.dtype(np.float64), 1.0,
                   name="cb_X")
            b = 128 * 64 * 8
            assert cm.allreduce_bytes(n, 8) == 2 * b * 7
            assert cm.allgather_bytes(n, 8) == b * 7
            r = mk("reshard", (n,), n.shape, n.dtype, 1.0,
                   axis="data", n_dev=8, sin=("s",))
            assert cm.collective_bytes(r) == cm.allgather_bytes(n, 8)
            assert cm.collective_bytes(n) == 0

    @pytest.mark.parametrize("program", ["lmds", "xtv_colsums_sum",
                                         "sharded_root", "center_and_scale"])
    @pytest.mark.parametrize("d", [2, 8])
    def test_costs_equal_reference(self, program, d):
        plans = _plans(program, d)
        pairs = list(zip(plans["ref"].instructions,
                         plans["port"].instructions, strict=True))
        for ri, ti in pairs:
            assert ri.node.op == ti.node.op
            assert costmodel.est_cost_s(ti.node) == rcm.est_cost_s(ri.node)
            assert costmodel.collective_bytes(ti.node) == \
                rcm.collective_bytes(ri.node)
            if ti.node.placement == "sharded" or ti.node.op in (
                    backend.SHARD_EXEC_OPS):
                assert costmodel.shard_cost_s(ti.node) == \
                    rcm.shard_cost_s(ri.node)
            for rx, tx in zip(ri.node.inputs, ti.node.inputs):
                assert costmodel.reshard_cost_s(tx, d) == \
                    rcm.reshard_cost_s(rx, d)

    @pytest.mark.parametrize("c", [2, 4, 8])
    def test_config_shard_cost_equals_reference(self, c):
        from repro.core import batching as rbat
        from repro_torch.core import batching as tbat
        xn = np.random.default_rng(1).normal(size=(512, 16))
        yn = np.random.default_rng(2).normal(size=(512, 1))
        got = {}
        for key, pk, bat in (("ref", R, rbat), ("port", T, tbat)):
            X, y = pk.input_tensor("X", xn), pk.input_tensor("y", yn)
            outs = [[pk.ops.solve(pk.ops.gram(X) + lam * pk.ops.eye(16),
                                  pk.ops.xtv(X, y))]
                    for lam in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8)]
            bp = bat.compile_batched(outs)
            inv = [i.node for i in bp.plan.instructions
                   if i.out_id not in bp.variant_uids]
            var = [i.node for i in bp.plan.instructions
                   if i.out_id in bp.variant_uids]
            cm = rcm if key == "ref" else costmodel
            got[key] = (cm.config_shard_cost_s(inv, var, bp.bucket, c),
                        cm.batched_cost_s(inv, var, bp.bucket))
            bp.release_leaves()
        assert got["ref"] == got["port"]

    def test_shard_gram_beats_reshard_then_local(self):
        X = _big(T, "cg_X")
        g = T.ops.gram(X).node
        sg = next(ins.node for ins in compile_plan(
            [T.ops.gram(X)], mesh=MeshSpec(data=8)).instructions
            if ins.node.op == "shard_gram")
        assert costmodel.est_cost_s(sg) <= (
            costmodel.reshard_cost_s(X.node, 8) + costmodel.est_cost_s(g))

    def test_mesh_key_tags_never_collide(self):
        from repro.core.jit_cache import mesh_key_tag as rtag
        from repro_torch.core.jit_cache import mesh_key_tag
        a = mesh_key_tag("d8xc1", ("s", "r"), ("r",))
        b = mesh_key_tag("d4xc2", ("s", "r"), ("r",))
        c = mesh_key_tag("d8xc1", ("s", "s"), ("r",))
        assert len({a, b, c}) == 3
        assert "|mesh:d8xc1|in:sr|out:r" == a == rtag("d8xc1", ("s", "r"),
                                                       ("r",))

    def test_structural_key_separates_shard_lane(self):
        p_sh = compile_plan([T.ops.gram(_big(T, "sk_a"))],
                            mesh=MeshSpec(data=8))
        p_lo = compile_plan([T.ops.gram(_big(T, "sk_b"))],
                            mesh=MeshSpec(data=1))
        assert {s.key for s in _segs(p_sh)}.isdisjoint(
            {s.key for s in _segs(p_lo)})
        assert all(s.summary().count("+shard") == s.sharded
                   for s in _segs(p_sh))


# ---------------------------------------------------------------------------
# TestUnshardFallback: the mesh does not resolve (1 device)
# ---------------------------------------------------------------------------

def _lmds_data(seed=11):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(4096, 64)), rng.normal(size=(4096, 1))


class TestUnshardFallback:
    """A sharded plan stays executable when the mesh does not resolve:
    local-equivalent closures, zero meter."""

    def test_parity_and_zero_meter(self):
        xn, yn = _lmds_data()
        ref = _rt("ref").evaluate(_lmds(R, R.input_tensor("fb_X", xn),
                                        R.input_tensor("fb_y", yn)))
        with use_mesh(data=8):
            plan = compile_plan(_lmds(T, T.input_tensor("fb_X2", xn),
                                      T.input_tensor("fb_y2", yn)))
        assert any(seg.sharded for seg in _segs(plan))
        rt = _rt()
        out = rt.run_plan(plan)
        assert rt.stats.shard.total == 0  # fallback, not sharded exec
        assert "shard" not in rt.stats.as_dict()
        keys = [k[0] for k in T.get_jit_cache().keys()]
        assert any(k.endswith("|unshard") for k in keys)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        for a, b in zip(_rt(fuse=False).run_plan(plan), ref):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# TestBatchedFedMap
# ---------------------------------------------------------------------------

class TestBatchedFedMap:
    def test_parfor_vmap_over_federated_map(self):
        from repro_torch.lifecycle.validation import parfor
        xn = np.random.default_rng(2).normal(size=(300, 12))
        lams = [0.5, 1.5, 2.5, 3.5]
        X = T.federated_input("bfm_X", T.FederatedTensor.partition_rows(
            xn, 3))
        out = parfor(lams, lambda lam: T.ops.colSums(T.ops.abs_(X)
                                                     * float(lam)),
                     runtime=_rt(), mode="vmap")
        for lam, (got,) in zip(lams, out):
            np.testing.assert_allclose(
                got, np.abs(xn).sum(axis=0, keepdims=True) * lam,
                rtol=1e-9, atol=1e-12)

    def test_batched_collect_of_fed_map(self):
        from repro_torch.lifecycle.validation import parfor
        xn = np.random.default_rng(4).normal(size=(90, 6))
        X = T.federated_input("bfc_X", T.FederatedTensor.partition_rows(
            xn, 3))
        out = parfor([1.0, 2.0, 3.0], lambda s: X * float(s),
                     runtime=_rt(), mode="vmap")
        for s, (got,) in zip([1.0, 2.0, 3.0], out):
            np.testing.assert_allclose(got, xn * s, rtol=1e-12)


# ---------------------------------------------------------------------------
# TestEightDeviceMesh: sharded execution over 8 logical devices
# ---------------------------------------------------------------------------

class TestEightDeviceMesh:
    def test_lmds_three_way_parity_and_meter(self, eight):
        xn, yn = _lmds_data(0)
        ref = _rt("ref").evaluate(_lmds(R, R.input_tensor("X", xn),
                                        R.input_tensor("y", yn)))
        with use_mesh(data=8):
            plan = compile_plan(_lmds(T, T.input_tensor("X2", xn),
                                      T.input_tensor("y2", yn)))
            rt = _rt()
            out = rt.run_plan(plan)
            rt_i = _rt(fuse=False)
            out_i = rt_i.run_plan(plan)
        assert any(s.sharded for s in _segs(plan))
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        for a, b in zip(out_i, ref):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        # one dispatch of each sharded segment, bytes equal to the
        # compile-time formulas — the reference's, over its own plan
        want = _meter(plan, costmodel, backend)
        assert rt.stats.shard.as_dict() == want
        assert want == _ref_meter(lambda pk: _lmds(
            pk, pk.input_tensor("X3", xn), pk.input_tensor("y3", yn)), 8)
        assert want["collective_bytes"] > 0
        assert rt.stats.as_dict()["shard"] == want
        # the interpreter holds global values: shard-exec ops unsharded
        assert rt_i.stats.shard.total == 0

    def test_pca_parity(self, eight):
        from repro.lifecycle.algorithms import pca as rpca
        from repro_torch.lifecycle.algorithms import pca
        rng = np.random.default_rng(1)
        xn = rng.normal(size=(4096, 48)) * rng.uniform(0.5, 4.0, size=48)
        c_ref, p_ref = rpca(R.input_tensor("X", xn), k=4,
                            runtime=_rt("ref"))
        with use_mesh(data=8):
            rt = _rt()
            c_sh, p_sh = pca(T.input_tensor("X2", xn), k=4, runtime=rt)
        assert rt.stats.shard.sharded_segments > 0
        np.testing.assert_allclose(c_sh, c_ref, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(p_sh, p_ref, rtol=1e-8, atol=1e-10)

    def test_grid_config_shard_parity(self, eight):
        from repro.lifecycle.validation import grid_search_lm as rgrid
        from repro_torch.lifecycle.validation import grid_search_lm
        rng = np.random.default_rng(1)
        xn, yn = rng.normal(size=(512, 16)), rng.normal(size=(512, 1))
        lams = [0.1 * (i + 1) for i in range(8)]
        b_ref, l_ref = rgrid(R.input_tensor("X", xn), R.input_tensor("y", yn),
                             lams, runtime=_rt("ref"), mode="vmap")
        with use_mesh(data=1, config=8):
            rt = _rt()
            b_sh, l_sh = grid_search_lm(T.input_tensor("X2", xn),
                                        T.input_tensor("y2", yn), lams,
                                        runtime=rt, mode="shard")
        assert rt.stats.shard.config_sharded_segments > 0
        assert rt.stats.shard.sharded_segments == 0
        assert any("|cshard:8xd1xc8" in k[0]
                   for k in T.get_jit_cache().keys())
        np.testing.assert_allclose(b_sh, b_ref, rtol=1e-9)
        np.testing.assert_allclose(l_sh, l_ref, rtol=1e-9)

    def test_grid_shard_degrades_to_vmap_without_devices(self):
        from repro_torch.lifecycle.validation import grid_search_lm
        rng = np.random.default_rng(1)
        xn, yn = rng.normal(size=(512, 16)), rng.normal(size=(512, 1))
        lams = [0.1 * (i + 1) for i in range(8)]
        out = {}
        for mode in ("vmap", "shard"):
            with use_mesh(config=8):
                rt = _rt()
                out[mode] = grid_search_lm(T.input_tensor("X", xn),
                                           T.input_tensor("y", yn), lams,
                                           runtime=rt, mode=mode)
            assert rt.stats.shard.total == 0 and rt.stats.batched_segments
        for a, b in zip(out["vmap"], out["shard"]):
            assert np.array_equal(a, b)

    def test_choose_mode_matches_reference(self, eight):
        from repro.core import batching as rbat
        from repro_torch.core import batching as tbat
        xn = np.random.default_rng(1).normal(size=(512, 16))
        yn = np.random.default_rng(2).normal(size=(512, 1))
        modes = {}
        for key, pk, bat, um in (("ref", R, rbat, ruse_mesh),
                                 ("port", T, tbat, use_mesh)):
            X, y = pk.input_tensor("X", xn), pk.input_tensor("y", yn)
            outs = [[pk.ops.solve(pk.ops.gram(X) + lam * pk.ops.eye(16),
                                  pk.ops.xtv(X, y))]
                    for lam in np.linspace(0.1, 0.8, 8)]
            with um(config=8):
                bp = bat.compile_batched(outs)
            modes[key] = bat.choose_mode(
                bp, [[o.node for o in c] for c in outs], False)
            bp.release_leaves()
        assert modes["ref"] == modes["port"]

    def test_jit_cache_no_collision_across_mesh_shapes(self, eight):
        xn = np.random.default_rng(0).normal(size=(4096, 64))
        T.clear_jit_cache()
        ref = _rt().evaluate([T.ops.gram(T.input_tensor("X", xn))])[0]
        outs = []
        for d in (8, 4, 2):
            with use_mesh(data=d):
                plan = compile_plan([T.ops.gram(T.input_tensor(f"X{d}",
                                                               xn))])
                outs.append(_rt().run_plan(plan)[0])
        keys = {k[0] for k in T.get_jit_cache().keys()}
        mesh_tags = {k.split("|mesh:")[1].split("|")[0]
                     for k in keys if "|mesh:" in k}
        assert mesh_tags == {"d8xc1", "d4xc1", "d2xc1"}, mesh_tags
        for o in outs:
            np.testing.assert_allclose(o, ref, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# The port's own: bits, exclusions, explain
# ---------------------------------------------------------------------------

def _sharded_lmds(xn, yn, depth, monkeypatch, **rt_kw):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
    with use_mesh(data=8):
        rt = _rt(**rt_kw)
        out = rt.evaluate(_lmds(T, T.input_tensor("bx", xn),
                                T.input_tensor("by", yn)))
    return out, rt


class TestShardedRuntime:
    def test_bitwise_across_runs_and_depths(self, eight, monkeypatch):
        xn, yn = _lmds_data(3)
        runs = [_sharded_lmds(xn, yn, d, monkeypatch)
                for d in ("1", "2", "2", "1")]
        for out, rt in runs:
            assert rt.stats.shard.sharded_segments == 3
            for a, b in zip(out, runs[0][0]):
                assert np.array_equal(a, b)
        # depth 2 deferred the local segments only
        assert runs[1][1].stats.pipeline.async_segments > 0

    def test_reuse_cache_serves_sharded_values(self, eight):
        xn, yn = _lmds_data(4)
        rt = _rt(cache=T.ReuseCache())
        X, y = T.input_tensor("rx", xn), T.input_tensor("ry", yn)
        with use_mesh(data=8):
            first = rt.evaluate(_lmds(T, X, y))
            again = rt.evaluate(_lmds(T, X, y))
        assert rt.cache.stats.hits > 0 and rt.stats.reused > 0
        for a, b in zip(first, again):
            assert np.array_equal(a, b)

    def test_sharded_segments_are_never_donated(self, eight, monkeypatch):
        # w = beta * 2 is produced this run by a local segment and dies
        # in the sharded matmul's segment: a donation candidate the
        # sharded lane must refuse
        import dataclasses

        import torch
        from repro_torch.core.runtime import LineageRuntime, _RunCtx
        xn, yn = _lmds_data(5)

        def prog(X, y):
            beta = T.ops.solve(T.ops.gram(X) + 1e-3 * T.ops.eye(64),
                               T.ops.xtv(X, y))
            r = X @ (beta * 2.0) - y
            return [T.ops.sum_(r * r)]
        plan = compile_plan(prog(T.input_tensor("dx", xn),
                                 T.input_tensor("dy", yn)),
                            mesh=MeshSpec(data=8))
        seg = next(s for s in _segs(plan)
                   if s.sharded and s.donatable_positions())
        rctx = _RunCtx(depth=2, owned={seg.input_uids[i]
                                       for i in seg.donatable_positions()})
        values = {u: torch.zeros(1) for u in seg.input_uids}
        assert LineageRuntime._donation_mask(seg, values, rctx, None) == ()
        assert LineageRuntime._donation_mask(
            dataclasses.replace(seg, sharded=False), values, rctx, None)
        out = {}
        for depth in ("1", "2"):
            monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
            rt = _rt()
            out[depth] = rt.run_plan(plan)[0]
            assert rt.stats.shard.sharded_segments > 0
        # depth 2 deferred and donated local segments only: no sharded
        # closure was ever keyed as a donating one
        assert rt.stats.pipeline.async_segments > 0
        assert not any("|mesh:" in k[0] and "|don:" in k[0]
                       for k in T.get_jit_cache().keys())
        assert np.array_equal(out["1"], out["2"])

    @pytest.mark.parametrize("mesh", [None, 8])
    def test_compile_fault_on_sharded_segment_reraises(self, eight, mesh):
        # the first segment is sharded under the mesh: its failed build
        # re-raises; the same fault on a local segment degrades
        xn, yn = _lmds_data(6)
        T.clear_jit_cache()
        plan = compile_plan(_lmds(T, T.input_tensor("fx", xn),
                                  T.input_tensor("fy", yn)),
                            mesh=MeshSpec(data=mesh) if mesh else None)
        assert _segs(plan)[0].sharded == (mesh is not None)
        rt = _rt()
        with faults.inject("compile@0"):
            if mesh:
                with pytest.raises(CompileFailedError, match=r"\+shard"):
                    rt.run_plan(plan)
            else:
                rt.run_plan(plan)
                assert rt.stats.faults.degradations == 1

    def test_lockstep_kernels_run_every_shard_in_order(self):
        import torch
        from repro_torch.core.dag import make_node
        from repro_torch.core.segments import split_rows
        t = torch.from_numpy(np.random.default_rng(7).normal(size=(16, 3)))
        blocks = split_rows(t, 8)
        assert isinstance(blocks, backend.Shards) and len(blocks) == 8
        # views of the global tensor, no copy
        assert all(b.data_ptr() == t[2 * i].data_ptr()
                   for i, b in enumerate(blocks))
        x = make_node("input", (), (16, 3), np.dtype(np.float64), 1.0,
                      name="ls_X")

        def kern(op, shape):
            return backend.kernel_for_node(
                make_node(op, (x,), shape, x.dtype, 1.0, axis="data",
                          n_dev=8, sin=("s",)), "cpu")
        assert torch.equal(kern("reshard", (16, 3))(blocks), t)
        want = blocks[0].T @ blocks[0]
        for b in blocks[1:]:
            want = want + b.T @ b  # ascending shard order
        assert torch.equal(kern("shard_gram", (3, 3))(blocks), want)
        # unshard: the base op on the global value
        assert torch.equal(backend.kernel_for_node(
            make_node("shard_gram", (x,), (3, 3), x.dtype, 1.0,
                      axis="data", n_dev=8, sin=("s",)), "cpu",
            unshard=True)(t), t.T @ t)
