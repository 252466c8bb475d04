"""Checkpoints: the port's `repro_torch.checkpoint` (store and
`run_with_restarts`) on its own and across packages. Round trips of
float64/float32/bfloat16/int32 leaves are bitwise; the on-disk layout is
the reference's, so a checkpoint written by either package restores in
the other bit for bit (bfloat16 as its 16-bit pattern, never through
float32). Mirrors tests/test_restart.py::TestRunWithRestarts with a torch
step function."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as rstore
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.checkpoint import store as tstore
from repro_torch.checkpoint.restart import (Preemption, TrainState,
                                            run_with_restarts)


def bits(x) -> bytes:
    """The raw bytes of a leaf, whatever package or dtype holds it."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy().tobytes()
    a = np.asarray(x)
    if a.dtype.itemsize == 2 and a.dtype.kind in "Vf" \
            and a.dtype != np.float16:
        a = a.view(np.uint16)
    return a.tobytes()


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(4, 3, generator=g, dtype=torch.float64),
                   "emb": torch.randn(5, 2, generator=g).bfloat16()},
        "opt_state": [torch.randn(3, generator=g),
                      torch.arange(6, dtype=torch.int32)],
        "step_rng": np.arange(4, dtype=np.int64),
    }


def _like(tree):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "opt_state": [torch.zeros_like(v) for v in tree["opt_state"]],
            "step_rng": np.zeros(4, dtype=np.int64)}


def _flat(tree):
    return tstore._flatten(tree)[0]


def test_round_trip_is_bitwise(tmp_path):
    tree = _tree()
    save(str(tmp_path), 7, tree, lineage={"run": "a"})
    got, manifest = restore(str(tmp_path), _like(tree))
    assert manifest["step"] == 7 and manifest["lineage"] == {"run": "a"}
    for a, b in zip(_flat(got), _flat(tree), strict=True):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape
        assert bits(a) == bits(b)
    dtypes = [m["dtype"] for m in manifest["leaves"]]
    # jax's leaf order: a dict's keys sorted
    assert dtypes == ["float32", "int32", "bfloat16", "float64", "int64"]


def test_device_argument_places_every_leaf(tmp_path):
    tree = _tree()
    save(str(tmp_path), 1, tree)
    got, _ = restore(str(tmp_path), _like(tree), device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in _flat(got))
    assert bits(_flat(got)[-1]) == bits(tree["step_rng"])


def test_tmp_dir_ignored_and_keep_last(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.ones(2)}
    for step in range(5):
        save(d, step, {"w": tree["w"] * step}, keep_last=2)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a crashed writer
    assert latest_step(d) == 4
    assert sorted(n for n in os.listdir(d)) == [
        "step_00000003", "step_00000004", "step_00000009.tmp"]
    got, _ = restore(d, tree)
    assert got["w"].tolist() == [4.0, 4.0]
    got, _ = restore(d, tree, step=3)
    assert got["w"].tolist() == [3.0, 3.0]


def test_missing_and_mismatched(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), {"w": torch.zeros(1)})
    save(str(tmp_path), 0, {"w": torch.zeros(1)})
    with pytest.raises(ValueError, match="leaves"):
        restore(str(tmp_path), {"w": torch.zeros(1), "v": torch.zeros(1)})


def _jax_tree(seed=0):
    rng = np.random.default_rng(seed)
    # float64 as a numpy leaf: jax holds float64 only with x64 on
    return {"params": {"w": rng.normal(size=(4, 3)),
                       "emb": jnp.asarray(rng.normal(size=(5, 2)),
                                          dtype=jnp.bfloat16)},
            "opt_state": [jnp.asarray(rng.normal(size=3), jnp.float32),
                          jnp.arange(6, dtype=jnp.int32)],
            "step_rng": np.arange(4, dtype=np.int64)}


def test_reference_saves_port_restores(tmp_path):
    ref = _jax_tree()
    rstore.save(str(tmp_path), 3, ref, lineage={"lambda": 0.5})
    like = {"params": {"w": torch.zeros(4, 3, dtype=torch.float64),
                       "emb": torch.zeros(5, 2, dtype=torch.bfloat16)},
            "opt_state": [torch.zeros(3), torch.zeros(6, dtype=torch.int32)],
            "step_rng": np.zeros(4, dtype=np.int64)}
    got, manifest = restore(str(tmp_path), like)
    assert manifest["lineage"] == {"lambda": 0.5}
    assert got["params"]["emb"].dtype == torch.bfloat16
    want = rstore._flatten(ref)[0]
    for a, b in zip(_flat(got), want, strict=True):
        assert bits(a) == bits(b)


def test_port_saves_reference_restores(tmp_path):
    tree = _tree(1)
    save(str(tmp_path), 2, tree, lineage={"features": ["a", "b"]})
    back, manifest = rstore.restore(str(tmp_path), _jax_tree())
    assert manifest["lineage"] == {"features": ["a", "b"]}
    got = rstore._flatten(back)[0]
    for a, b in zip(got, _flat(tree), strict=True):
        assert bits(a) == bits(b)
    # the file is the reference's own: its bf16 leaf loads as the raw
    # 16-bit type its ml_dtypes arrays take in an npz
    rstore.save(str(tmp_path / "r"), 2, _jax_tree())
    ref_back, _ = rstore.restore(str(tmp_path / "r"), _jax_tree())
    assert np.asarray(back["params"]["emb"]).dtype == \
        np.asarray(ref_back["params"]["emb"]).dtype
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        ours = json.load(f)["leaves"]
    with open(tmp_path / "r" / "step_00000002" / "manifest.json") as f:
        theirs = json.load(f)["leaves"]
    assert ours == theirs


def test_uint16_bfloat16_leaf_reads_back(tmp_path):
    """A bfloat16 leaf stored as uint16 (another writer's choice of the
    16-bit pattern) reads back through the same bit view."""
    t = torch.randn(6).bfloat16()
    save(str(tmp_path), 0, {"t": t})
    path = tmp_path / "step_00000000" / "shard_0.npz"
    raw = np.load(path)["leaf_0"].view(np.uint16)
    np.savez(path, leaf_0=raw)
    got, _ = restore(str(tmp_path), {"t": torch.zeros(6,
                                                      dtype=torch.bfloat16)})
    assert bits(got["t"]) == bits(t)


# ---------------------------------------------------------------------------
# run_with_restarts (mirrors tests/test_restart.py::TestRunWithRestarts)
# ---------------------------------------------------------------------------

def _make_fns(log):
    def init_fn():
        w = torch.zeros(4, dtype=torch.float64)
        return TrainState(step=0, params={"w": w},
                          opt_state={"m": torch.zeros(4)},
                          pipeline_state={"seed": 0, "step": 0})

    def step_fn(state):
        log.append(state.step)
        w = state.params["w"] * 1.1 + 0.1 * (state.step + 1)
        m = 0.9 * state.opt_state["m"] + w.float()
        return TrainState(step=state.step + 1, params={"w": w},
                          opt_state={"m": m},
                          pipeline_state={"seed": 0, "step": state.step + 1})

    return init_fn, step_fn


class TestRunWithRestarts:
    def test_runs_to_completion(self, tmp_path):
        log = []
        init_fn, step_fn = _make_fns(log)
        final = run_with_restarts(ckpt_dir=str(tmp_path), init_fn=init_fn,
                                  step_fn=step_fn, total_steps=7,
                                  ckpt_every=3)
        assert final.step == 7 and log == list(range(7))

    @pytest.mark.parametrize("fail_at", [3, 5])
    def test_injected_failure_then_resume(self, tmp_path, fail_at):
        clean_log = []
        init_fn, step_fn = _make_fns(clean_log)
        clean = run_with_restarts(ckpt_dir=str(tmp_path / "clean"),
                                  init_fn=init_fn, step_fn=step_fn,
                                  total_steps=10, ckpt_every=2)
        log = []
        init_fn, step_fn = _make_fns(log)
        with pytest.raises(Preemption):
            run_with_restarts(ckpt_dir=str(tmp_path), init_fn=init_fn,
                              step_fn=step_fn, total_steps=10,
                              ckpt_every=2, fail_at=fail_at)
        final = run_with_restarts(ckpt_dir=str(tmp_path), init_fn=init_fn,
                                  step_fn=step_fn, total_steps=10,
                                  ckpt_every=2)
        assert final.step == 10
        # resumed from the last checkpoint before the failure, not 0
        resumed = fail_at - fail_at % 2
        assert log.count(0) == 1 and log.count(resumed) == 2
        assert final.pipeline_state == clean.pipeline_state
        for a, b in ((final.params["w"], clean.params["w"]),
                     (final.opt_state["m"], clean.opt_state["m"])):
            assert a.dtype == b.dtype and bits(a) == bits(b)
