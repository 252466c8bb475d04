"""The dry run (`repro_torch.launch.dryrun`), the rule tables
(`repro_torch.distributed.legacy_rules`) and the last names of the port
against the reference.

TestShardingRules: every port parameter's spec equals its reference
leaf's, less the stacked period axis, for every assigned arch at reduced
width on a (data 2, model 4) mesh (the builders read only the mesh's axis
sizes); `batch_specs` and `cache_specs` leaf by leaf the same way;
`Model.param_shapes` against the reference's.

TestMiniDryRun (`tests/test_distributed.py`'s two cells): the reference's
dry run needs a forced 8-device host, which must be set before jax
starts, and one XLA compile of a cell takes about a minute here: one
subprocess for the file (a module-scoped fixture, started first so the
port's counts run beside it) compiles the first cell and reads its
`memory_analysis()` and its hlocost FLOPs; for the multi-pod cell it
reckons `n_devices`, `model_flops`, `tokens` and the argument bytes its
shardings give, without a compile (on the first cell those bytes equal
`memory_analysis()`'s). The port counts both on "meta" under
`logical_devices(8)`: `n_devices`, `model_flops` and `tokens` bitwise,
argument bytes within 1 %, the first cell's FLOPs per device within 15 %
of the reference's (the measured ratio is in PERF.md).

Also: a cell of each family counted on "meta" without error (MoE on its
local path and expert-parallel, the recurrences on their kernels'
meta implementations), the depth extrapolation exact against a full
count, the CLI, `kernel_model`'s substitution report, and
`backend.has_kernel` against the reference's.
"""
import json
import math
import os
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_config
from repro.core import backend as ref_backend
from repro.distributed import sharding as ref_sharding
from repro.launch import shapes as ref_shapes
from repro.models import build_model as ref_build_model

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core import backend
from repro_torch.distributed import (batch_specs, cache_specs,
                                     logical_devices, param_specs)
from repro_torch.launch import dryrun, kernel_model
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import input_specs
from repro_torch.models import build_model
from _torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = r'''
import json, math, sys
import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed import sharding as shard_mod
from repro.launch import roofline
from repro.launch.dryrun import lower_cell
from repro.launch.mesh import data_axes, make_mesh
from repro.launch.shapes import input_specs
from repro.launch.steps import train_state_shapes
from repro.models import build_model


def arg_bytes(cfg, mesh):
    """The train step's arguments' per-device bytes by their shardings."""
    model = build_model(cfg)
    specs = input_specs(cfg, "train_4k", model)
    params, opt = train_state_shapes(model)
    trees = [(params, shard_mod.param_specs(params, mesh)),
             (opt, shard_mod.param_specs(opt, mesh)),
             (specs["batch"], shard_mod.batch_specs(specs["batch"], mesh,
                                                    data_axes(mesh)))]
    total = 0
    for tree, spec in trees:
        sizes = jax.tree_util.tree_map(
            lambda l, s: math.prod(NamedSharding(mesh, s).shard_shape(
                l.shape)) * np.dtype(l.dtype).itemsize, tree, spec)
        total += sum(jax.tree_util.tree_leaves(sizes))
    return int(total)


out = {}
cells = {"qwen": ("qwen3-0.6b", (2, 4), ("data", "model")),
         "llama": ("llama3.2-1b", (2, 2, 2), ("pod", "data", "model"))}
for name, (arch, shape, axes) in cells.items():
    cfg = get_config(arch).reduced().with_(vocab_size=1024, n_layers=4)
    mesh = make_mesh(shape, axes)
    mf, tokens = roofline.model_flops_per_device(cfg, "train", 256, 4096,
                                                 mesh.devices.size)
    out[name] = dict(n_devices=int(mesh.devices.size), model_flops=mf,
                     tokens=tokens, shard_arg_bytes=arg_bytes(cfg, mesh))
    if name == "qwen":  # the one compile
        _, comp, cell = lower_cell(arch, "train_4k", mesh, verbose=False,
                                   cfg_override=cfg, hints=True)
        out[name].update(
            cell_n_devices=cell.n_devices, cell_model_flops=cell.model_flops,
            cell_tokens=cell.tokens, hlo_flops=cell.hlo_flops,
            arg_bytes=comp.memory_analysis().argument_size_in_bytes)
with open(OUT, "w") as f:
    json.dump(out, f)
print("OK")
'''


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's numbers of TestMiniDryRun's cells, from a
    subprocess started with the file's first test (the other tests run
    beside its compile; TestMiniDryRun's come last and wait for it)."""
    out = str(tmp_path_factory.mktemp("dryrun") / "reference.json")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.Popen(
        [sys.executable, "-c", f"OUT = {out!r}\n" + _REFERENCE],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    result = {}

    def get():
        if not result:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "OK" in stdout, \
                stdout[-2000:] + stderr[-4000:]
            with open(out) as f:
                result.update(json.load(f))
        return result
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


class _StubMesh:  # the builders read only the axis sizes
    def __init__(self, **shape):
        self.shape = shape


MESH = _StubMesh(data=2, model=4)


def _ref_tree(tree, specs):
    """{key path: (leaf shape, spec)} of a reference tree and its spec tree
    (dict keys sorted as jax flattens them; no specs: empty ones)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sflat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0] if specs is not None \
        else [(None, P())] * len(flat)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            (tuple(leaf.shape), tuple(s))
            for (p, leaf), (_, s) in zip(flat, sflat, strict=True)}


def _port_tree(tree, specs, path=()):
    out = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(_port_tree(tree[k], specs[k], path + (str(k),)))
    elif isinstance(tree, (list, tuple)) and not (
            len(tree) == 2 and isinstance(tree[1], torch.dtype)):
        for i, (v, s) in enumerate(zip(tree, specs, strict=True)):
            out.update(_port_tree(v, s, path + (str(i),)))
    else:
        out[path] = (tuple(tree[0]), tuple(specs))
    return out


def _port_key(name: str) -> tuple:
    """A port parameter name as the reference's key path, the period
    index dropped (the reference stacks periods on a leading axis)."""
    parts = name.split(".")
    if parts[0] == "periods":
        return ("periods",) + tuple(parts[2:])
    return tuple(parts)


# ---------------------------------------------------------------------------
# TestShardingRules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_match_reference(arch):
    """Every port leaf's spec (and shape) equals its reference leaf's,
    less the stacked axis; every reference leaf has its port leaves."""
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    rshapes = ref_build_model(rcfg).param_shapes()
    want = _ref_tree(rshapes, ref_sharding.param_specs(rshapes, MESH))
    shapes = build_model(cfg, "meta").param_shapes()
    specs = param_specs(shapes, MESH)
    seen = set()
    for name, (shape, _) in shapes.items():
        key = _port_key(name)
        wshape, wspec = want[key]
        if key[0] == "periods":  # the reference's leading period axis
            assert wspec[:1] in ((), (None,))
            wshape, wspec = wshape[1:], wspec[1:]
        assert (shape, specs[name]) == (wshape, wspec), name
        seen.add(key)
    assert seen == set(want)


def test_param_specs_shapes():
    """TestShardingRules' own case on the port's names: wq on (data,
    model), no leading period axis; the head on (data, model)."""
    cfg = get_config("qwen3-0.6b").reduced()
    with logical_devices(1):
        mesh = make_mesh((1, 1), ("data", "model"))
    specs = param_specs(build_model(cfg, "meta").param_shapes(), mesh)
    assert specs["periods.0.0:attn.attn.wq"] == ("data", "model")
    assert specs["head.w"] == ("data", "model")
    assert specs["final_norm.scale"] == ()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b", "rwkv6-3b",
                                  "llama3.2-vision-90b", "musicgen-large"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "long_500k"])
def test_batch_and_cache_specs_match_reference(arch, shape):
    """`batch_specs` of the step's inputs and `cache_specs` of the decode
    caches, leaf by leaf the reference's (the caches keep their leading
    period axis in both packages), with the reference's axes."""
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    model, rmodel = build_model(cfg, "meta"), ref_build_model(rcfg)
    mesh = _StubMesh(pod=2, data=2, model=4)
    dax = ("pod", "data")
    specs, rspecs = (input_specs(cfg, shape, model),
                     ref_shapes.input_specs(rcfg, shape, rmodel))
    if shape == "train_4k":
        tree, rtree = specs["batch"], rspecs["batch"]
        got = _port_tree(tree, batch_specs(tree, mesh, dax))
        want = _ref_tree(rtree, ref_sharding.batch_specs(rtree, mesh, dax))
    else:
        tree, rtree = specs["caches"], rspecs["caches"]
        got = _port_tree(tree, cache_specs(tree, mesh, specs["B"], dax))
        want = _ref_tree(rtree, ref_sharding.cache_specs(rtree, mesh,
                                                         rspecs["B"], dax))
    assert got == want


def test_model_param_shapes_match_reference():
    """`Model.param_shapes` against the reference's, less the stacked
    axis, allocating nothing."""
    cfg = get_config("deepseek-v2-236b")
    got = build_model(cfg, "meta").param_shapes()
    want = _ref_tree(ref_build_model(ref_config("deepseek-v2-236b"))
                     .param_shapes(), None)
    assert len(got) > len(want) > 0
    for name, (shape, dtype) in got.items():
        key = _port_key(name)
        wshape = want[key][0]
        assert shape == (wshape[1:] if key[0] == "periods" else wshape)
        assert dtype == torch.bfloat16 or shape[-1:] == (cfg.d_model,) \
            or dtype == torch.float32


# ---------------------------------------------------------------------------
# every family on meta; the depth extrapolation; the CLI
# ---------------------------------------------------------------------------

FAMILIES = [
    ("deepseek-moe-16b", "prefill_32k", False),   # moe, local (meta sizes)
    ("deepseek-moe-16b", "decode_32k", True),     # moe, expert-parallel
    ("deepseek-v2-236b", "decode_32k", False),    # mla
    ("rwkv6-3b", "train_4k", False),              # ssm, plain recurrence
    ("rwkv6-3b", "prefill_32k", False),           # ssm, the kernel's meta
    ("jamba-v0.1-52b", "prefill_32k", True),      # hybrid, scan + EP
    ("jamba-v0.1-52b", "long_500k", False),       # hybrid decode
    ("llama3.2-vision-90b", "prefill_32k", False),  # vlm
    ("musicgen-large", "decode_32k", False),      # audio
    ("phi3-medium-14b", "prefill_32k", False),    # dense
]


@pytest.mark.parametrize("arch,shape,hints", FAMILIES)
def test_family_cell_counts_on_meta(arch, shape, hints):
    with logical_devices(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        _, totals, cell = dryrun.lower_cell(
            arch, shape, mesh, verbose=False,
            cfg_override=get_config(arch).reduced(), hints=hints)
    assert cell.hlo_flops > 0 and cell.hlo_bytes > 0
    assert cell.arg_bytes > 0 and cell.out_bytes > 0
    assert all(math.isfinite(v) for v in (cell.t_compute, cell.t_memory,
                                          cell.t_collective))
    if "train" in shape and "rwkv" in arch:
        assert totals.regions["scan"] > 0      # the plain recurrence
    if "prefill" in shape and arch in ("rwkv6-3b", "jamba-v0.1-52b"):
        kernel = "wkv6" if arch == "rwkv6-3b" else "ssm"
        assert totals.by_op[kernel][0] > 0     # the kernel's meta charge
    if hints and "moe" in arch:
        assert cell.per_collective["all-reduce"] > 0


def test_depth_extrapolation_is_exact():
    """Counted with no period and with one, scaled by the periods: the
    full depth's FLOPs, bytes and transcendentals."""
    cfg = get_config("jamba-v0.1-52b").reduced().with_(n_layers=24)
    specs = input_specs(cfg, "prefill_32k", build_model(cfg, "meta"))
    specs = dict(specs, tokens=((2, 256), torch.int32), B=2, S=256)
    full = dryrun._count(cfg, specs)
    extra = dryrun.count_cell(cfg, specs)
    for k in ("flops", "bytes", "transcendentals"):
        assert getattr(extra, k) == pytest.approx(getattr(full, k),
                                                  rel=1e-12)


def test_cli_counts_a_production_cell(tmp_path, monkeypatch, capsys):
    """`python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
    train_4k --mesh single` at full width over 256 logical devices."""
    out = str(tmp_path / "cells.json")
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "qwen3-0.6b", "--shape", "train_4k", "--mesh",
        "single", "--out", out])
    assert dryrun.main() == 0
    printed = capsys.readouterr().out
    assert "1 counted, 0 skipped" in printed and "t_comp(ms)" in printed
    with open(out) as f:
        cell = json.load(f)["cells"][0]
    assert (cell["n_devices"], cell["mesh"], cell["dtype"]) == \
        (256, "16x16", "bfloat16")
    assert 0.5 < cell["flops_ratio"] <= 1.0


def test_kernel_model_report(monkeypatch, capsys):
    """`python -m repro_torch.launch.kernel_model rwkv6-3b train_4k`: the
    plain recurrence's bytes replaced by the kernel's I/O."""
    monkeypatch.setattr(sys, "argv", ["kernel_model", "rwkv6-3b",
                                      "train_4k"])
    kernel_model.main()
    printed = capsys.readouterr().out
    assert "scan region bytes" in printed and "SUBSTITUTED" in printed


def test_has_kernel_matches_reference():
    ops = sorted(set(ref_backend._KERNEL_BUILDERS) | {"no_such_op", "gram"})
    assert [backend.has_kernel(op) for op in ops] == \
        [ref_backend.has_kernel(op) for op in ops]


# ---------------------------------------------------------------------------
# TestMiniDryRun
# ---------------------------------------------------------------------------

CELLS = {
    "qwen": ("qwen3-0.6b", (2, 4), ("data", "model")),
    "llama": ("llama3.2-1b", (2, 2, 2), ("pod", "data", "model")),
}


def _port_cell(name):
    arch, shape, axes = CELLS[name]
    cfg = get_config(arch).reduced().with_(vocab_size=1024, n_layers=4)
    with logical_devices(8):
        mesh = make_mesh(shape, axes)
        _, totals, cell = dryrun.lower_cell(arch, "train_4k", mesh,
                                            verbose=False, cfg_override=cfg,
                                            hints=True)
    return totals, cell


@pytest.mark.parametrize("name", sorted(CELLS, reverse=True))
def test_mini_dry_run_matches_reference(name, reference):
    """The port's count of TestMiniDryRun's cells on "meta" against the
    reference's compiled dry run."""
    totals, cell = _port_cell(name)
    ref = reference()[name]
    assert cell.n_devices == ref["n_devices"] == 8
    assert cell.model_flops == ref["model_flops"]
    assert cell.tokens == ref["tokens"]
    assert abs(cell.arg_bytes - ref["shard_arg_bytes"]) \
        <= 0.01 * ref["shard_arg_bytes"]
    assert cell.hlo_flops > 0 and cell.t_memory > 0 and cell.temp_bytes > 0
    assert totals.unknown_trip_counts == 0 and cell.coll_wire_bytes > 0
    if name == "qwen":  # the compiled cell
        assert (ref["cell_n_devices"], ref["cell_model_flops"],
                ref["cell_tokens"]) == (cell.n_devices, cell.model_flops,
                                        cell.tokens)
        assert ref["shard_arg_bytes"] == ref["arg_bytes"]
        assert abs(cell.arg_bytes - ref["arg_bytes"]) <= 0.01 * \
            ref["arg_bytes"]
        assert abs(cell.hlo_flops - ref["hlo_flops"]) \
            <= 0.15 * ref["hlo_flops"], cell.hlo_flops / ref["hlo_flops"]
