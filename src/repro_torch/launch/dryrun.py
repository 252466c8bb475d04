"""Dry run: count one step of every (arch × shape × mesh) cell on "meta".

Port of `repro.launch.dryrun`. For each cell:
  * build the model on the "meta" device (nothing is allocated) and the
    step's inputs from `launch.shapes.input_specs`,
  * lay its parameters, optimizer state, batch and caches over the named
    mesh (`launch.mesh`, logical devices) by the rule tables
    (`distributed.legacy_rules`),
  * count the step under `launch.hlocost.CostTotals`,
  * emit a `launch.roofline.RooflineCell` at the H100's constants.

The port has no partitioner: nothing splits the step's ops over the mesh.
The per-device figures follow one stated partition model:
  * FLOPs, bytes and transcendentals are the global count over
    `n_devices` (every op's work split evenly, none repeated);
  * argument and output bytes are the exact shard sizes the specs give
    (`arg_bytes`, `out_bytes`);
  * collectives come from the placement: each parameter split over the
    data axes (FSDP) is all-gathered over its data group before use (once
    a forward; in training again for the backward, and its float32
    gradient reduce-scattered), and every product whose contraction the
    specs split over `model` reduces its output there
    (`hlocost.product_collective`: the embedding's one-hot product and
    the 2-D weights, forward, recomputed forward with `cfg.remat`, and
    the backward's input gradient), plus what the step charges itself
    (the expert-parallel MoE's model sum);
  * `temp_bytes` is the peak of live bytes the counter tracks.

The step is counted at two depths, the prefix layers with no period and
with one, and the difference is multiplied by the config's period count:
every period does the same work (the reference's layer scan, whose body
its hlocost multiplies by the trip count), so the FLOPs, bytes and
transcendentals are the full depth's exactly; `temp_bytes` is that
line's estimate.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --all --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.distributed import logical_devices
from repro_torch.distributed import sharding as shard_mod
from repro_torch.distributed.legacy_rules import _is_leaf
from repro_torch.distributed.hints import _STATE as hints_state
from repro_torch.distributed.hints import disable_hints, enable_hints
from repro_torch.launch import hlocost, roofline
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.shapes import SHAPES, cell_supported, input_specs
from repro_torch.launch.steps import make_train_step, train_state_shapes
from repro_torch.models import build_model
from repro_torch.optim.adamw import adamw_init, trainable_params

# 2-D leaves the rule tables place that are not the right operand of a
# product over tokens
_NOT_PRODUCTS = (r"rwkv\.u$", r"mamba\.A_log$", r"embed\.tok$")


def _names(names) -> tuple:
    if names is None:
        return ()
    return names if isinstance(names, tuple) else (names,)


def _leaves(tree, specs):
    """(leaf, spec) pairs of a tree of (shape, dtype) leaves and its
    spec tree of the same structure."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k])
    elif isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        for v, s in zip(tree, specs, strict=True):
            yield from _leaves(v, s)
    else:
        yield tree, specs


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's shard of every (shape, dtype) leaf of `tree`
    laid out by `specs` (a leaf's dimension over the product of its spec
    axes' sizes)."""
    total = 0
    for (shape, dtype), spec in _leaves(tree, specs):
        n = 1
        for i, d in enumerate(shape):
            names = spec[i] if i < len(spec) else None
            n *= d // math.prod(mesh.shape[a] for a in _names(names))
        total += n * dtype.itemsize
    return total


def _placement_collectives(params, specs, mesh, kind: str, tokens: int,
                           head_rows: int, remat: bool) -> None:
    """Charge the partition model's collectives (module docstring) to the
    active counters: FSDP gathers and scatters of every parameter split
    over the data axes, and the product rule for every product weight
    whose contraction the specs split."""
    dax = data_axes(mesh)
    dpa = dax if len(dax) > 1 else (dax[0] if dax else None)
    forwards = (2 if remat else 1) if kind == "train" else 1
    for name, (shape, dtype) in params.items():
        spec = specs[name]
        size = dtype.itemsize
        numel = math.prod(shape)
        data = [a for names in spec for a in _names(names) if a in dax]
        other = [a for names in spec for a in _names(names)
                 if a not in dax]
        if data:  # FSDP: gather over the data group, scatter the grads
            group = math.prod(mesh.shape[a] for a in data)
            gathered = numel * size / math.prod(mesh.shape[a]
                                                for a in other)
            for _ in range(2 if kind == "train" else 1):
                hlocost.collective("all-gather", gathered, group)
            if kind == "train":
                hlocost.collective(
                    "reduce-scatter", numel * 4 / math.prod(
                        mesh.shape[a] for a in data + other), group)
        # the product rule, on the gathered weight
        w = tuple(None if not names else tuple(
            a for a in _names(names) if a not in dax) or None
            for names in spec)
        if name.endswith("embed.tok") and len(shape) == 2:
            # a lookup: the one-hot (tokens, V) times the (V, D) table
            for _ in range(forwards):
                hlocost.product_collective((dpa, w[0]), w, (dpa, w[1]),
                                           mesh, (tokens, shape[1]), dtype)
            continue
        if len(shape) != 2 or not any(w) \
                or any(re.search(p, name) for p in _NOT_PRODUCTS):
            continue
        uses = head_rows if name.endswith("head.w") else tokens
        for _ in range(forwards):
            hlocost.product_collective((dpa, w[0]), w, (dpa, w[1]), mesh,
                                       (uses, shape[1]), dtype)
        if kind == "train":  # the input's gradient: dy @ Wᵀ
            hlocost.product_collective((dpa, w[1]), (w[1], w[0]),
                                       (dpa, w[0]), mesh, (uses, shape[0]),
                                       dtype)


def _meta(spec):
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype, device="meta")


def _count(cfg, specs: dict) -> hlocost.CostTotals:
    """The counted step of `cfg` on "meta" for the inputs `specs`."""
    kind = specs["kind"]
    model = build_model(cfg, "meta", train=kind == "train")
    with hlocost.CostTotals() as totals:
        if kind == "train":
            batch = {k: _meta(v) for k, v in specs["batch"].items()}
            opt = adamw_init(trainable_params(model))
            make_train_step(model)(opt, batch)
        elif kind == "prefill":
            img = specs.get("image_embeds")
            model.prefill(_meta(specs["tokens"]), max_len=specs["S"],
                          image_embeds=None if img is None else _meta(img))
        else:
            caches = model.init_cache(specs["B"], specs["S"])
            model.decode_step(_meta(specs["token"]), caches, specs["S"] - 1)
    return totals


def count_cell(cfg, specs: dict) -> hlocost.CostTotals:
    """The step's counts at `cfg`'s full depth: counted with no period and
    with one, the difference multiplied by the period count (the periods
    do the same work)."""
    n = cfg.n_periods()
    if n <= 1:
        return _count(cfg, specs)
    c0 = _count(cfg.with_(n_layers=cfg.first_dense_layers), specs)
    c1 = _count(cfg.with_(n_layers=cfg.first_dense_layers + cfg.period),
                specs)
    totals = hlocost.CostTotals()
    totals.add(c0, 1 - n)
    totals.add(c1, n)
    totals.peak_bytes = int((1 - n) * c0.peak_bytes + n * c1.peak_bytes)
    return totals


def lower_cell(arch: str, shape_name: str, mesh, *, verbose: bool = True,
               cfg_override=None, hints: bool = False):
    """Returns (step inputs, totals, cell) for one (arch, shape, mesh):
    the step's input specs, its global `hlocost.CostTotals` (with the
    placement's collectives, per device) and its `RooflineCell`. The
    hints' state is restored on return (the reference leaves its hints
    enabled: its dry run runs in a process of its own)."""
    saved = dict(hints_state)
    try:
        return _lower_cell(arch, shape_name, mesh, verbose=verbose,
                           cfg_override=cfg_override, hints=hints)
    finally:  # the model code reads the hints' mesh: leave it as found
        hints_state.update(saved)


def _lower_cell(arch: str, shape_name: str, mesh, *, verbose: bool,
                cfg_override, hints: bool):
    if hints:
        enable_hints(mesh)
    else:
        disable_hints()
    cfg = cfg_override or get_config(arch)
    meta_model = build_model(cfg, "meta")
    specs = input_specs(cfg, shape_name, meta_model)
    dax = data_axes(mesh)
    n_dev = mesh.size
    kind, B, S = specs["kind"], specs["B"], specs["S"]

    if kind == "train":
        params_s, opt_s = train_state_shapes(meta_model)
        p_specs = shard_mod.param_specs(params_s, mesh)
        o_specs = shard_mod.param_specs(opt_s, mesh)
        b_specs = shard_mod.batch_specs(specs["batch"], mesh, dax)
        arg = (shard_bytes(params_s, p_specs, mesh)
               + shard_bytes(opt_s, o_specs, mesh)
               + shard_bytes(specs["batch"], b_specs, mesh))
        # the updated parameters and moments, the step, 4 f32 metrics
        out = arg - shard_bytes(specs["batch"], b_specs, mesh) + 4 * 4
        tokens = B * S
    else:
        params_s = meta_model.param_shapes()
        p_specs = shard_mod.param_specs(params_s, mesh)
        caches = meta_model.cache_shapes(B, S)
        c_specs = shard_mod.cache_specs(caches, mesh, B, dax)
        tok = specs["tokens"] if kind == "prefill" else specs["token"]
        ins = {"t": tok}
        if "image_embeds" in specs:
            ins["i"] = specs["image_embeds"]
        i_specs = shard_mod.batch_specs(ins, mesh, dax)
        logits = ((B,) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
                  + (cfg.vocab_size,), torch.float32)
        l_specs = shard_mod.batch_specs({"l": logits}, mesh, dax)
        out = shard_bytes({"l": logits}, l_specs, mesh) \
            + shard_bytes(caches, c_specs, mesh)
        arg = shard_bytes(params_s, p_specs, mesh) \
            + shard_bytes(ins, i_specs, mesh)
        if kind == "decode":  # the caches in, and cur_len
            arg += shard_bytes(caches, c_specs, mesh) + 4
        tokens = B * S if kind == "prefill" else B

    t0 = time.time()
    totals = count_cell(cfg, specs)
    with totals:  # the placement's collectives, per device
        _placement_collectives(params_s, p_specs, mesh, kind, tokens,
                               tokens if kind == "train" else B, cfg.remat)
    dt = time.time() - t0

    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    mf, ntok = roofline.model_flops_per_device(cfg, kind, B, S, n_dev)
    cell = roofline.RooflineCell(
        arch=cfg.name, shape=shape_name, mesh=mesh_name, n_devices=n_dev,
        kind=kind,
        hlo_flops=totals.flops / n_dev, hlo_bytes=totals.bytes / n_dev,
        coll_wire_bytes=totals.collective_wire_bytes,
        coll_raw_bytes=totals.collective_raw_bytes,
        per_collective=dict(totals.per_collective),
        by_group_size={str(k): v for k, v in totals.by_group_size.items()},
        unknown_trips=totals.unknown_trip_counts,
        arg_bytes=arg, out_bytes=out,
        temp_bytes=int(totals.peak_bytes / n_dev),
        model_flops=mf, tokens=ntok, compile_seconds=dt,
        dtype=cfg.dtype)
    if verbose:
        print(f"  shards: args={arg/2**30:.2f}GiB out={out/2**30:.2f}GiB "
              f"temp={cell.temp_bytes/2**30:.2f}GiB per device")
        print(f"  hlocost: flops={totals.flops:.3e} bytes={totals.bytes:.3e}"
              f" coll_wire={totals.collective_wire_bytes:.3e} "
              f"(global; per device / {n_dev})")
        print(f"  roofline (NVIDIA H100 80GB HBM3, 700 W): "
              f"t_comp={cell.t_compute*1e3:.3f}ms "
              f"t_mem={cell.t_memory*1e3:.3f}ms "
              f"t_coll={cell.t_collective*1e3:.3f}ms "
              f"-> {cell.bottleneck}-bound "
              f"(MODEL/HLO={cell.flops_ratio:.3f}, "
              f"roofline={cell.roofline_fraction*100:.1f}%)  "
              f"[count {dt:.1f}s]")
    return specs, totals, cell


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None, help="JSON results path")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--hints", action="store_true",
                    help="enable sharding hints (optimized, non-baseline)")
    args = ap.parse_args()

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells, failures, skips = [], [], []
    for multi in meshes:
        with logical_devices(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi)
            mesh_name = "x".join(str(s) for s in mesh.shape.values())
            for arch in archs:
                cfg = get_config(arch)
                for shape_name in shapes:
                    ok, why = cell_supported(cfg, shape_name)
                    tag = f"{cfg.name} × {shape_name} × {mesh_name}"
                    if not ok:
                        print(f"SKIP {tag}: {why}")
                        skips.append({"cell": tag, "reason": why})
                        continue
                    print(f"DRYRUN {tag}")
                    try:
                        _, _, cell = lower_cell(arch, shape_name, mesh,
                                                hints=args.hints)
                        if args.hints:
                            cell.mesh += "+hints"
                        cells.append(cell)
                    except Exception as e:  # noqa: BLE001
                        traceback.print_exc()
                        failures.append({"cell": tag,
                                         "error": repr(e)[:500]})

    print()
    print(roofline.format_table(cells))
    print(f"\n{len(cells)} counted, {len(skips)} skipped (documented), "
          f"{len(failures)} FAILED")
    for f in failures:
        print("  FAIL:", f["cell"], f["error"][:160])
    if args.out:
        existing = []
        if args.append and os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)["cells"]
        with open(args.out, "w") as f:
            json.dump({"cells": existing + [c.to_dict() for c in cells],
                       "skips": skips, "failures": failures}, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
