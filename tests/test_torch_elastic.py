"""Elastic checkpoints: values placed on a named mesh, saved and restored
onto another mesh, against the reference.

The reference's sharded `jax.device_put` needs a forced 8-device host,
set before jax starts: one subprocess for the file (a module-scoped
fixture) places seeded arrays on the meshes and specs below, writes
every device's `addressable_shards` data, saves a checkpoint from
sharded arrays, and restores, onto a mesh, a checkpoint that the port
saved from `Placed` values. The port lays 8 logical devices over the CPU.

Mirrors TestElasticCheckpoint (saved from a (4, 2) mesh with ("data",
"model"), restored onto (2, 4) with ("model", None): the whole array
bitwise, the spec kept), and holds every logical device's shard bitwise
against the shard jax gives the device of the same id; a spec axis that
does not divide its dimension raises in both packages.
"""
import json

import numpy as np
import pytest
import torch
from test_torch_moe_ep import run_reference

from repro_torch.checkpoint import store
from repro_torch.distributed import (NamedSharding, Placed, device_put,
                                     logical_devices, named)
from repro_torch.launch.mesh import make_mesh

AXES = ("data", "model")
W = np.arange(64, dtype=np.float32).reshape(8, 8)
E = np.random.default_rng(0).normal(size=(16, 12)).astype(np.float32)
BIAS = np.random.default_rng(1).normal(size=(12,)).astype(np.float32)
ARRAYS = {"w": W, "e": E, "b": BIAS}
# (array, mesh shape, spec): specs as tuples, a tuple entry for several
# axes
CASES = {
    "w_4x2_data_model": ("w", (4, 2), ("data", "model")),
    "w_2x4_model_none": ("w", (2, 4), ("model", None)),
    "e_2x4_both_none": ("e", (2, 4), (("data", "model"), None)),
    "e_4x2_none_data": ("e", (4, 2), (None, "data")),
    "e_1x8_model": ("e", (1, 8), ("model",)),
    "e_2x4_model_data": ("e", (2, 4), ("model", "data")),
    "b_2x4_replicated": ("b", (2, 4), ()),
}
# the port's checkpoint, saved from Placed values, that the reference
# restores onto (2, 4) with these specs
PORT_SPECS = {"w": ("model", None), "e": ("data", "model"), "b": ()}

REFERENCE = r"""
import json
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import store
from repro.launch.mesh import make_mesh
jax.config.update("jax_enable_x64", False)

ARRAYS = {k: np.asarray(v, np.float32) for k, v in np.load(IN).items()}
CASES = json.loads(CASES_JSON)
AXES = ("data", "model")
res, meta = {}, {}


def spec(entries):
    return P(*[tuple(e) if isinstance(e, list) else e for e in entries])


def shards(arr, prefix):
    for s in arr.addressable_shards:
        res[f"{prefix}/{s.device.id}"] = np.asarray(s.data)


for name, (key, shape, entries) in CASES.items():
    mesh = make_mesh(tuple(shape), AXES)
    arr = jax.device_put(jnp.asarray(ARRAYS[key]),
                         NamedSharding(mesh, spec(entries)))
    shards(arr, f"shard/{name}")

# TestElasticCheckpoint, with a 1-D leaf and a second matrix beside w
mesh1 = make_mesh((4, 2), AXES)
tree = {"w": jax.device_put(jnp.asarray(ARRAYS["w"]),
                            NamedSharding(mesh1, P("data", "model"))),
        "e": jax.device_put(jnp.asarray(ARRAYS["e"]),
                            NamedSharding(mesh1, P(None, "model"))),
        "b": jax.device_put(jnp.asarray(ARRAYS["b"]),
                            NamedSharding(mesh1, P()))}
store.save(REF_CKPT, 1, tree)

# the port's checkpoint restored onto (2, 4)
mesh2 = make_mesh((2, 4), AXES)
port_specs = json.loads(PORT_SPECS_JSON)
like = {k: jnp.zeros(v.shape, jnp.float32) for k, v in ARRAYS.items()}
back, _ = store.restore(PORT_CKPT, like, shardings={
    k: NamedSharding(mesh2, spec(v)) for k, v in port_specs.items()})
for k, v in back.items():
    res[f"port_ckpt/{k}"] = np.asarray(v)
    meta[f"port_ckpt_spec/{k}"] = [list(e) if isinstance(e, tuple) else e
                                   for e in v.sharding.spec]
    shards(v, f"port_ckpt_shard/{k}")

# a spec axis that does not divide its dimension
try:
    jax.device_put(jnp.zeros((7, 8), jnp.float32),
                   NamedSharding(mesh1, P("data", None)))
    meta["nondivisible"] = "placed"
except Exception as exc:
    meta["nondivisible"] = type(exc).__name__
res["meta"] = np.array(json.dumps(meta))
np.savez(OUT, **res)
print("OK")
"""


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("elastic")
    np.savez(d / "in.npz", **ARRAYS)
    port_ckpt = str(d / "port_ckpt")
    with logical_devices(8):
        mesh1 = make_mesh((4, 2), AXES)
        store.save(port_ckpt, 1, {
            "w": device_put(torch.from_numpy(W),
                            NamedSharding(mesh1, ("data", "model"))),
            "e": device_put(torch.from_numpy(E),
                            NamedSharding(mesh1, ("model", None))),
            "b": torch.from_numpy(BIAS)})
    cases = {k: [a, list(s), _spec_json(sp)]
             for k, (a, s, sp) in CASES.items()}
    port_specs = {k: _spec_json(v) for k, v in PORT_SPECS.items()}
    header = (f"IN = {str(d / 'in.npz')!r}\n"
              f"REF_CKPT = {str(d / 'ref_ckpt')!r}\n"
              f"PORT_CKPT = {port_ckpt!r}\n"
              f"CASES_JSON = {json.dumps(cases)!r}\n"
              f"PORT_SPECS_JSON = {json.dumps(port_specs)!r}\n")
    res = run_reference(header + REFERENCE, str(d / "ref.npz"))
    res["meta"] = json.loads(str(res["meta"]))
    res["dir"] = d
    return res


@pytest.fixture
def eight():
    with logical_devices(8):
        yield


def _assert_shards_match(placed: Placed, ref, prefix: str):
    """Each logical device's shard bitwise the one jax gives the device
    of the same id, and a view of the placed tensor."""
    mesh = placed.sharding.mesh
    assert len(placed.shards) == mesh.size
    for i, shard in enumerate(placed.shards):
        want = ref[f"{prefix}/{i}"]
        assert shard.shape == want.shape and shard.dtype == torch.float32
        assert shard.numpy().tobytes() == want.tobytes(), (prefix, i)
        assert shard.untyped_storage().data_ptr() == \
            placed.value.untyped_storage().data_ptr()


@pytest.mark.parametrize("case", list(CASES))
def test_shards_match_addressable_shards(ref, eight, case):
    key, shape, spec = CASES[case]
    mesh = make_mesh(shape, AXES)
    placed = device_put(torch.from_numpy(ARRAYS[key]),
                        NamedSharding(mesh, spec))
    assert placed.sharding.spec == spec
    assert np.asarray(placed).tobytes() == ARRAYS[key].tobytes()
    _assert_shards_match(placed, ref, f"shard/{case}")


def test_restore_onto_different_mesh(ref, eight, tmp_path):
    """TestElasticCheckpoint: saved from (4, 2) with ("data", "model"),
    restored onto (2, 4) with ("model", None)."""
    mesh1 = make_mesh((4, 2), AXES)
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    sharded = device_put(w, NamedSharding(mesh1, ("data", "model")))
    store.save(str(tmp_path), 1, {"w": sharded})
    mesh2 = make_mesh((2, 4), AXES)
    back, _ = store.restore(str(tmp_path), {"w": w}, shardings={
        "w": NamedSharding(mesh2, ("model", None))})
    np.testing.assert_array_equal(np.asarray(back["w"]), w.numpy())
    assert back["w"].sharding.spec == ("model", None)
    _assert_shards_match(back["w"], ref, "shard/w_2x4_model_none")


def test_reference_sharded_checkpoint_restores_into_port(ref, eight):
    mesh2 = make_mesh((2, 4), AXES)
    specs = {"w": ("model", None), "e": (("data", "model"), None), "b": ()}
    like = {k: torch.zeros(v.shape) for k, v in ARRAYS.items()}
    back, manifest = store.restore(str(ref["dir"] / "ref_ckpt"), like,
                                   shardings=named(mesh2, specs))
    assert manifest["step"] == 1
    for k, v in ARRAYS.items():
        assert isinstance(back[k], Placed)
        assert np.asarray(back[k]).tobytes() == v.tobytes()
        assert back[k].sharding.spec == specs[k]
    _assert_shards_match(back["w"], ref, "shard/w_2x4_model_none")
    _assert_shards_match(back["e"], ref, "shard/e_2x4_both_none")
    _assert_shards_match(back["b"], ref, "shard/b_2x4_replicated")


def test_placed_checkpoint_restores_in_reference(ref):
    """The port saved Placed values (their whole tensors); the reference
    restored them onto (2, 4) bitwise, shard by shard."""
    for k, v in ARRAYS.items():
        assert ref[f"port_ckpt/{k}"].tobytes() == v.tobytes()
        assert ref["meta"][f"port_ckpt_spec/{k}"][:len(PORT_SPECS[k])] == \
            _spec_json(PORT_SPECS[k])
    with logical_devices(8):
        mesh2 = make_mesh((2, 4), AXES)
        for k, spec in PORT_SPECS.items():
            placed = device_put(torch.from_numpy(ARRAYS[k]),
                                NamedSharding(mesh2, spec))
            _assert_shards_match(placed, ref, f"port_ckpt_shard/{k}")


def test_nondivisible_spec_raises(ref, eight, tmp_path):
    assert ref["meta"]["nondivisible"] != "placed"
    mesh1 = make_mesh((4, 2), AXES)
    with pytest.raises(ValueError, match="splits a dimension of 7"):
        device_put(torch.zeros(7, 8), NamedSharding(mesh1, ("data", None)))
    store.save(str(tmp_path), 1, {"w": torch.zeros(7, 8)})
    with pytest.raises(ValueError, match="splits a dimension of 7"):
        store.restore(str(tmp_path), {"w": torch.zeros(7, 8)}, shardings={
            "w": NamedSharding(mesh1, ("data", None))})
    with pytest.raises(ValueError, match="more entries"):
        device_put(torch.zeros(8), NamedSharding(mesh1, ("data", "model")))
    with pytest.raises(ValueError, match="not in the mesh"):
        NamedSharding(mesh1, ("pod",))


def test_named_builds_a_tree_of_shardings(eight):
    mesh = make_mesh((2, 4), AXES)
    tree = named(mesh, {"a": ("data", "model"), "b": [(), ("model",)]})
    assert tree["a"] == NamedSharding(mesh, ("data", "model"))
    assert [s.spec for s in tree["b"]] == [(), ("model",)]
    assert all(s.mesh is mesh for s in (tree["a"], *tree["b"]))
