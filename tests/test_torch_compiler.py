"""Plan parity: the port compiles the reference's plans.

The same DSL programs are built in `repro` and in `repro_torch` over the
same numpy data and compiled by each package's `compile_plan`. Node uids
come from per-package counters, so plans are compared after renumbering
every `%uid` by first appearance: the instruction streams (op, inputs,
shape, dtype, target, probe flag, cost estimate, frees), the formats,
`chunk_sliced` and the `explain()` text (segment keys included) must then
be identical — with and without a reuse cache, and with
`CHUNK_MEM_BUDGET` at 64 KiB in both packages so lmDS streams.
"""
import re

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core import costmodel as rcm
from repro_torch.core import costmodel as tcm

PKGS = {"ref": R, "port": T}


def canon(plan) -> str:
    """Every compile-time decision of a plan as text, uids renumbered."""
    lines = []
    for ins in plan.instructions:
        n = ins.node
        lines.append(
            f"%{ins.out_id} {n.op} {','.join(f'%{u}' for u in ins.input_ids)}"
            f" {n.shape} {n.dtype} {n.placement} {ins.target} {ins.probe} "
            f"{ins.est_cost_s!r} frees={','.join(f'%{u}' for u in ins.last_use_of)}"
            f" attrs={[kv for kv in n.attrs if kv[0] != 'name']}")
    lines.append("outputs " + ",".join(f"%{u}" for u in plan.output_ids))
    lines.append("sliced " + ",".join(
        f"%{u}:{m}" for u, m in sorted(plan.chunk_sliced.items())))
    for sparse in (False, True):
        fm = plan.formats_for(sparse)
        lines.append(f"formats[{sparse}] " + ",".join(
            f"%{u}:{f}" for u, f in sorted(fm.items())))
    for reuse in (False, True):
        lines.append(plan.explain(reuse_active=reuse))
        lines.append(plan.explain(segments=False, reuse_active=reuse,
                                  sparse=True))
    text = "\n".join(lines)
    ids: dict[str, int] = {}
    return re.sub(r"%(\d+)",
                  lambda m: f"%{ids.setdefault(m.group(1), len(ids))}", text)


def _data(m=4096, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, n)), rng.normal(size=(m, 1))


def quickstart(pk, xn, yn):
    X, y = pk.input_tensor("X", xn), pk.input_tensor("y", yn)
    n = xn.shape[1]
    return [pk.ops.solve(X.T @ X + 0.1 * pk.ops.eye(n), X.T @ y)]


def lmds_intercept(pk, xn, yn):
    X, y = pk.input_tensor("X", xn), pk.input_tensor("y", yn)
    X = pk.ops.cbind(X, pk.ops.ones((X.shape[0], 1)))
    n = X.shape[1]
    return [pk.ops.solve(X.T @ X + 1e-7 * pk.ops.eye(n), X.T @ y)]


def steplm_step(pk, xn, yn):
    """One candidate model of steplm's second round: cbind of the
    intercept, a selected column and a candidate column."""
    X, y = pk.input_tensor("X", xn), pk.input_tensor("y", yn)
    m = xn.shape[0]
    base = pk.ops.cbind(pk.ops.ones((m, 1)), X[:, 2:3])
    Xc = pk.ops.cbind(base, X[:, 5:6])
    beta = pk.ops.solve(pk.ops.gram(Xc) + 1e-7 * pk.ops.eye(3),
                        pk.ops.xtv(Xc, y))
    resid = y - Xc @ beta
    return [beta, pk.ops.sum_(resid * resid)]


def cleaning_mix(pk, xn, yn):
    """Elementwise prefix, aggregates and a host quantile in one plan."""
    X = pk.input_tensor("X", xn)
    Z = (X - pk.ops.colMeans(X)) / pk.ops.sqrt(pk.ops.colVars(X))
    q = pk.ops.quantile(Z, 0.75)
    return [pk.ops.colSums(pk.ops.where(Z > q, q, Z)), pk.ops.sum_(Z * Z)]


def pca_program(pk, xn, yn):
    """pca's two plans (lifecycle/algorithms.py): the covariance of the
    centred X and the projection onto bound components."""
    X = pk.input_tensor("X", xn)
    n = xn.shape[0]
    Xc = X - pk.ops.colMeans(X)
    comps = pk.input_tensor("pca_comps", np.eye(xn.shape[1])[:, :2])
    return [pk.ops.gram(Xc) * (1.0 / (n - 1)), Xc @ comps]


def cleaning_repairs(pk, xn, yn):
    """The repair builtins' programs in one plan: outlier_by_iqr's fences
    and NaN repair, impute_by_mean's mask algebra, winsorize's clamp and
    outlier_by_sd's flags."""
    X = pk.input_tensor("X", xn)
    q1, q3 = pk.ops.quantile(X, 0.25), pk.ops.quantile(X, 0.75)
    lo, hi = q1 - 1.5 * (q3 - q1), q3 + 1.5 * (q3 - q1)
    bad = (X < lo)._bin(X > hi, "or")
    mask = X._bin(X, "ne")
    x0 = pk.ops.replace_nan(X, 0.0)
    mu = pk.ops.colSums(x0) / pk.ops.maximum(
        X.shape[0] - pk.ops.colSums(mask), 1.0)
    wins = pk.ops.minimum(pk.ops.maximum(X, pk.ops.quantile(X, 0.05)),
                          pk.ops.quantile(X, 0.95))
    sd = pk.ops.abs_(X - pk.ops.colMeans(X)) > 3.0 * pk.ops.sqrt(
        pk.ops.colVars(X))
    return [pk.ops.where(bad, float("nan"), X), x0 + mask * mu, wins, sd]


PROGRAMS = [quickstart, lmds_intercept, steplm_step, cleaning_mix,
            pca_program, cleaning_repairs]


@pytest.mark.parametrize("reuse", [False, True])
@pytest.mark.parametrize("prog", PROGRAMS, ids=lambda p: p.__name__)
def test_in_memory_plans_identical(prog, reuse):
    xn, yn = _data(512, 6)
    plans = {k: pk.compile_plan(prog(pk, xn, yn), reuse_enabled=reuse)
             for k, pk in PKGS.items()}
    assert not plans["port"].chunk_sliced
    assert canon(plans["ref"]) == canon(plans["port"])


@pytest.mark.parametrize("reuse", [False, True])
@pytest.mark.parametrize("prog", [quickstart, lmds_intercept, cleaning_mix],
                         ids=lambda p: p.__name__)
def test_streaming_plans_identical(monkeypatch, prog, reuse):
    monkeypatch.setattr(rcm, "CHUNK_MEM_BUDGET", 1 << 16)
    monkeypatch.setattr(tcm, "CHUNK_MEM_BUDGET", 1 << 16)
    xn, yn = _data()
    plans = {k: pk.compile_plan(prog(pk, xn, yn), reuse_enabled=reuse)
             for k, pk in PKGS.items()}
    port = plans["port"]
    assert port.chunk_sliced and "[chunked]" in port.explain()
    assert canon(plans["ref"]) == canon(port)


def test_streaming_lmds_clusters_one_scope(monkeypatch):
    monkeypatch.setattr(tcm, "CHUNK_MEM_BUDGET", 1 << 16)
    xn, yn = _data()
    plan = T.compile_plan(quickstart(T, xn, yn), reuse_enabled=True)
    ops = plan.count_ops()
    assert ops.get("chunk_gram") == 1 and ops.get("chunk_xtv") == 1
    assert ops.get("combine") == 2
    chunked = [s for s in plan.segments_for(True) if s.chunked]
    assert len(chunked) == 1
    assert {i.node.op for i in chunked[0].instructions} >= {
        "chunk_gram", "chunk_xtv"}


@pytest.mark.parametrize("reuse", [False, True])
def test_prepared_script_plans_identical(reuse):
    def script(pk):
        def fn(a, b):
            return pk.ops.solve(pk.ops.gram(a) + 0.5 * pk.ops.eye(6),
                                pk.ops.xtv(a, b))
        return fn
    rts = {"ref": R.LineageRuntime(cache=R.ReuseCache() if reuse else None),
           "port": T.LineageRuntime(cache=T.ReuseCache() if reuse else None,
                                    device="cpu")}
    plans = {k: pk.PreparedScript(script(pk), [(64, 6), (64, 1)],
                                  runtime=rts[k]).plan
             for k, pk in PKGS.items()}
    assert canon(plans["ref"]) == canon(plans["port"])


def test_data_mesh_compiles_the_reference_plan():
    """A `data=4` mesh lowers lmDS's products to the sharded placement, in
    both packages alike (tests/test_torch_sharded.py holds every program
    of the reference's sharded tests at d 2, 4 and 8)."""
    from repro.distributed import MeshSpec as RMeshSpec
    from repro_torch.distributed import MeshSpec
    xn, yn = _data(4096, 64)
    plans = {k: pk.compile_plan(quickstart(pk, xn, yn), mesh=mesh(data=4))
             for (k, pk), mesh in zip(PKGS.items(), (RMeshSpec, MeshSpec))}
    assert canon(plans["ref"]) == canon(plans["port"])
    assert {"shard_gram", "shard_xtv"} <= set(plans["port"].count_ops())


@pytest.mark.parametrize("reuse", [False, True])
def test_batched_grid_plans_identical(reuse):
    """grid_search_lm's template over a λ grid (lifecycle/validation.py):
    the same template plan, variant set, segment split and batched
    `explain()` text in both packages (hoisted leaves' generated names
    carry each package's own counter and are compared without it)."""
    from repro.core import batching as rbat
    from repro_torch.core import batching as tbat
    xn, yn = _data(512, 6)
    text = {}
    for key, pk, bat in (("ref", R, rbat), ("port", T, tbat)):
        X, y = pk.input_tensor("X", xn), pk.input_tensor("y", yn)

        def model(lam, pk=pk, X=X, y=y):
            beta = pk.ops.solve(pk.ops.gram(X) + lam * pk.ops.eye(6),
                                pk.ops.xtv(X, y))
            resid = y - X @ beta
            return [beta, pk.ops.sum_(resid * resid)]
        bplan = bat.compile_batched([model(lam) for lam in
                                     (0.01, 0.1, 1.0, 10.0, 100.0)],
                                    reuse_enabled=reuse)
        segs = ",".join(f"{int(s.variant)}{len(s.instructions)}"
                        for s in bplan.segments_for(reuse))
        text[key] = "\n".join([
            canon(bplan.plan), f"bucket {bplan.bucket} segments {segs}",
            re.sub(r"'cfg\d+'", "'cfg'", bplan.explain())])
        text[key] = re.sub(
            r"%(\d+)", lambda m, ids={}: f"%{ids.setdefault(m.group(1), len(ids))}",
            text[key])
    assert "[batch=5]" in text["port"]
    assert text["port"] == text["ref"]
