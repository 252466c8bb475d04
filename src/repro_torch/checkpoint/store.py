"""Atomic, elastic checkpointing.

Port of `repro.checkpoint.store`, with `torch.utils._pytree` in place of
`jax.tree_util`. The files on disk keep the reference's layout, so a
checkpoint written by one package restores in the other:

Layout: <dir>/step_<n>/ containing
  manifest.json  — tree structure, leaf shapes/dtypes, step, lineage note
  shard_<i>.npz  — leaf arrays, chunked ~512 MB per file

Atomicity: written to step_<n>.tmp, fsync'd, then renamed — a crashed
writer never corrupts the latest checkpoint (restart.py relies on this).

Leaf order is jax's: a dict's children in sorted key order, so `leaf_i`
names the same leaf in both packages. Leaves are stored as full host
arrays (tensors are copied off their device on save); `restore` places
each leaf on the device of its counterpart in `like`, or on `device=`
when given, and hands a numpy `like` leaf back as numpy, as the
reference does.

bfloat16: numpy has no bfloat16 without `ml_dtypes`, which the port does
not need. A bf16 leaf is stored as its 16-bit pattern (the ``|V2`` raw
type the reference's `ml_dtypes` arrays take in an npz) under the
manifest dtype ``"bfloat16"``; restore reads any ``"bfloat16"`` leaf,
``|V2`` or uint16, back into `torch.bfloat16` through a bit view, so the
numbers never pass through float32.

Lineage: the manifest carries a `lineage` blob (run id, data-pipeline
state, rng) — SystemDS §4.1 model versioning applied to training runs.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

SHARD_BYTES = 512 << 20
BF16 = "bfloat16"


def _canonical(tree: Any) -> Any:
    """`tree` with every plain dict's keys in sorted order — the order
    in which `jax.tree_util` flattens a dict (torch's pytree keeps
    insertion order)."""
    if type(tree) is dict:
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_canonical(v) for v in tree)
    return tree


def _flatten(tree) -> tuple[list, Any]:
    return pytree.tree_flatten(_canonical(tree))


def _to_host(leaf: Any) -> tuple[np.ndarray, str]:
    """(array to store, manifest dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
            return bits.view("V2"), BF16
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == BF16:  # an ml_dtypes array
        return np.ascontiguousarray(arr).view(np.uint16).view("V2"), BF16
    return arr, str(arr.dtype)


def _place(arr: np.ndarray, dtype: str, like_leaf: Any,
           device: Optional[torch.device]) -> Any:
    """One restored leaf where `restore` promises it: on `device`, else
    on the device of a tensor `like` leaf, else as the stored numpy array
    (a bf16 leaf then stays its raw 16-bit pattern, as the reference's
    restore returns it)."""
    if device is None and not isinstance(like_leaf, torch.Tensor):
        return arr
    if dtype == BF16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device if device is not None else like_leaf.device)


def save(ckpt_dir: str, step: int, tree: Any,
         lineage: Optional[dict] = None, keep_last: int = 3) -> str:
    leaves, treedef = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {
        "step": int(step),
        "treedef": str(treedef),
        "n_leaves": len(leaves),
        "leaves": [],
        "lineage": lineage or {},
    }
    shard, shard_bytes, shard_id = {}, 0, 0

    def flush():
        nonlocal shard, shard_bytes, shard_id
        if shard:
            np.savez(os.path.join(tmp, f"shard_{shard_id}.npz"), **shard)
            shard, shard_bytes = {}, 0
            shard_id += 1

    for i, leaf in enumerate(leaves):
        arr, dtype = _to_host(leaf)
        manifest["leaves"].append({
            "index": i, "shape": list(arr.shape), "dtype": dtype,
            "shard": shard_id, "key": f"leaf_{i}"})
        shard[f"leaf_{i}"] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= SHARD_BYTES:
            flush()
    flush()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _cleanup(ckpt_dir, keep_last)
    return final


def _cleanup(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            device=None) -> tuple[Any, dict]:
    """Restore into the structure of `like` (a pytree of tensors or
    numpy arrays). Each leaf goes to the device of its tensor
    counterpart in `like`, or to `device` when given; a numpy `like`
    leaf gets the stored numpy array back."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves, treedef = _flatten(like)
    if len(like_leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint {path} holds {len(manifest['leaves'])} leaves, "
            f"`like` has {len(like_leaves)}")
    dev = None if device is None else torch.device(device)
    shard_cache: dict[int, Any] = {}
    leaves = []
    try:
        for meta, like_leaf in zip(manifest["leaves"], like_leaves):
            sid = meta["shard"]
            if sid not in shard_cache:
                shard_cache[sid] = np.load(
                    os.path.join(path, f"shard_{sid}.npz"))
            leaves.append(_place(shard_cache[sid][meta["key"]],
                                 meta["dtype"], like_leaf, dev))
    finally:
        for npz in shard_cache.values():
            npz.close()
    return pytree.tree_unflatten(leaves, treedef), manifest
