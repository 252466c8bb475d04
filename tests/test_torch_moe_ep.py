"""The expert-parallel MoE, the sharding hints and the named mesh against
the reference.

The reference runs its shard_map EP on a forced 8-device host, which must
be set before jax starts: one subprocess for the file (a module-scoped
fixture, as `tests/test_distributed.py` runs its EP case) computes the
reference's outputs and writes them to an `.npz` that the tests read;
this file imports no jax. The port lays 8 logical devices over the CPU
(`logical_devices(8)`), builds the same meshes with `make_mesh` and
enables hints on them.

Reduced deepseek-moe-16b with 8 experts, top-2 (TestMoeEP's config), the
reference's `moe_init(PRNGKey(0))` carried over leaf by leaf, seeded numpy
tokens: the port's `moe_forward_ep` against the reference's at meshes (2,
4) and (1, 8), within TestMoeEP's rtol 2e-4 / atol 2e-5 (aux rtol 1e-4);
at capacity factor 64 (no drops) also against the port's local path; at
1.25, where slots drop, the port drops exactly the slots that the
reference's capacity rule drops on the reference's own routing. The
dispatch rule of `moe_forward` (hints off, experts not divisible by
`model`, tokens not divisible by the data ranks: the local path) against
the reference's own choice; `_expand`, `axis_size` and the spec that
`shard_hint` pins against the reference's on the same meshes. The
`cuda` cases hold EP on the card against the CPU's, and `quantize_int8`
on the card bitwise against the CPU.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import compress, hints, logical_devices
from repro_torch.launch.mesh import (data_axes, make_mesh,
                                     make_production_mesh)
from repro_torch.models import moe as tmoe
from _torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 4), (1, 8)]
CFS = [64.0, 1.25]
B, S = 4, 64   # 256 tokens


def run_reference(code: str, out: str, devices: int = 8) -> dict:
    """Run `code` (which writes the npz `OUT`) in a subprocess with a
    forced `devices`-device jax host; returns the npz's arrays."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    res = subprocess.run([sys.executable, "-c", f"OUT = {out!r}\n" + code],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(out) as npz:
        return {k: npz[k] for k in npz.files}


REFERENCE = r"""
import json
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.distributed import hints
from repro.distributed.hints import disable_hints, enable_hints, shard_hint
from repro.launch.mesh import make_mesh
from repro.models import moe as moe_mod
jax.config.update("jax_enable_x64", False)

SHAPES = %(shapes)r
CFS = %(cfs)r
B, S = %(B)d, %(S)d
res, meta = {}, {}
base = get_config("deepseek_moe_16b").reduced().with_(n_experts=8,
                                                      moe_top_k=2)
p = moe_mod.moe_init(jax.random.PRNGKey(0), base)


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


for k, v in flat(p):
    res[f"param/{k}"] = v
# tokens leaning toward expert 0 (one sd of its logit), so that its
# slots overflow at capacity factor 1.25 on every mesh
r0 = np.asarray(p["router"])[:, 0]
x = np.random.default_rng(0).normal(size=(B, S, base.d_model))
x = jnp.asarray(x + r0 / np.linalg.norm(r0), jnp.float32)
res["x"] = np.asarray(x)
disable_hints()
out, aux = moe_mod.moe_forward_local(p, base, x)
res["local"], res["local_aux"] = np.asarray(out), np.asarray(aux)
xf = x.reshape(B * S, base.d_model)
for shape in SHAPES:
    mesh = make_mesh(shape, ("data", "model"))
    for cf in CFS:
        cfg = base.with_(capacity_factor=cf)
        enable_hints(mesh)
        with mesh:
            out, aux = jax.jit(lambda p, x: moe_mod.moe_forward_ep(
                p, cfg, x))(p, x)
        disable_hints()
        res[f"ep/{shape}/{cf}"] = np.asarray(out)
        res[f"ep_aux/{shape}/{cf}"] = np.asarray(aux)
    # each data rank's routing, as its rank_fn computes it
    t_loc = B * S // shape[0]
    for d in range(shape[0]):
        xd = xf[d * t_loc:(d + 1) * t_loc]
        probs = jax.nn.softmax((xd @ p["router"]).astype(jnp.float32), -1)
        res[f"top/{shape}/{d}"] = np.asarray(jax.lax.top_k(probs, 2)[1])

# the dispatch rule: which calls take moe_forward_ep
taken = []
ep = moe_mod.moe_forward_ep
moe_mod.moe_forward_ep = lambda p, cfg, x: (taken.append(1), ep(p, cfg, x))[1]
cases = {"ep": ((2, 4), base, (B, S)),
         "hints_off": (None, base, (B, S)),
         "experts_not_divisible": ((2, 4), base.with_(n_experts=6), (B, S)),
         "tokens_not_divisible": ((4, 2), base, (1, 3))}
for name, (shape, cfg, xs) in cases.items():
    taken.clear()
    pc = moe_mod.moe_init(jax.random.PRNGKey(1), cfg)
    xc = jnp.asarray(np.random.default_rng(1).normal(
        size=xs + (cfg.d_model,)), jnp.float32)
    mesh = make_mesh(shape or (2, 4), ("data", "model"))
    if shape:
        enable_hints(mesh)
    with mesh:
        moe_mod.moe_forward(pc, cfg, xc)
    disable_hints()
    meta[f"dispatch/{name}"] = bool(taken)
moe_mod.moe_forward_ep = ep

# hints: token expansion, axis sizes and the spec shard_hint pins
TOKENS = ["dp", "data", "model", "pod", None, ["data", "model"],
          ["pod", "model"], "bogus", ["bogus"]]
SPECS = [[(8, 6), ["dp", "model"]], [(7, 6), ["dp", "model"]],
         [(4, 16, 128), ["dp", None, "model"]],
         [(6, 8), [["data", "model"], None]], [(8,), ["dp"]],
         [(16, 4), ["model", "dp"]], [(2, 16), [["pod", "data"], "model"]]]


def tok(t):
    return tuple(t) if isinstance(t, list) else t


def enc(e):
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else list(e)
    return e


for shape, axes in [((2, 4), ("data", "model")),
                    ((2, 2, 2), ("pod", "data", "model")),
                    ((8,), ("model",)), ((4, 2), ("data", "model"))]:
    mesh = make_mesh(shape, axes)
    enable_hints(mesh)
    key = f"{shape}"
    meta[f"expand/{key}"] = [enc(hints._expand(tok(t))) for t in TOKENS]
    meta[f"axis_size/{key}"] = [hints.axis_size(a) for a in
                                ("data", "model", "pod", "bogus")]
    pinned = []
    with mesh:
        for xs, spec in SPECS:
            y = jax.jit(lambda v: shard_hint(v, *[tok(s) for s in spec]))(
                jnp.zeros(xs, jnp.float32))
            got = list(y.sharding.spec) + [None] * (len(xs)
                                                    - len(y.sharding.spec))
            pinned.append([enc(e) for e in got])
    meta[f"pinned/{key}"] = pinned
    disable_hints()
meta["tokens"] = TOKENS
meta["specs"] = SPECS
res["meta"] = np.array(json.dumps(meta))
np.savez(OUT, **res)
print("OK")
""" % dict(shapes=SHAPES, cfs=CFS, B=B, S=S)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    out = str(tmp_path_factory.mktemp("moe_ep") / "ref.npz")
    res = run_reference(REFERENCE, out)
    res["meta"] = json.loads(str(res["meta"]))
    return res


@pytest.fixture
def eight():
    """8 logical devices over the CPU, hints off after the case."""
    with logical_devices(8):
        try:
            yield
        finally:
            hints.disable_hints()


def _cfg(**kw):
    return get_config("deepseek-moe-16b").reduced().with_(
        **{"n_experts": 8, "moe_top_k": 2, **kw})


def _layer(ref, cfg, device="cpu"):
    mod = tmoe.MoE(cfg, device)
    mod.load_state_dict({k[len("param/"):]: torch.from_numpy(v)
                         for k, v in ref.items() if k.startswith("param/")})
    return mod


def _ep(mod, cfg, x, shape):
    hints.enable_hints(make_mesh(shape, ("data", "model")))
    try:
        return tmoe.moe_forward_ep(mod, cfg, x)
    finally:
        hints.disable_hints()


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ep_matches_reference(ref, eight, shape, cf):
    cfg = _cfg(capacity_factor=cf)
    mod = _layer(ref, cfg)
    x = torch.from_numpy(ref["x"])
    out, aux = _ep(mod, cfg, x, shape)
    np.testing.assert_allclose(out.numpy(), ref[f"ep/{shape}/{cf}"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(ref[f"ep_aux/{shape}/{cf}"]),
                               rtol=1e-4)
    if cf == 64.0:  # ample capacity: EP is the local dropless path
        local, laux = tmoe.moe_forward_local(mod, cfg, x)
        np.testing.assert_allclose(out.numpy(), local.numpy(), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(out.numpy(), ref["local"], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(float(aux), float(laux), rtol=1e-4)


def _dropped_by_rule(top_idx: np.ndarray, E: int, cf: float) -> np.ndarray:
    """The reference's capacity rule in numpy: a replica (token-major) is
    dropped when its expert already holds Ce earlier replicas."""
    flat = top_idx.reshape(-1)
    ce = max(int(len(flat) / E * cf + 7) // 8 * 8, 8)
    seen = np.zeros(E, np.int64)
    dropped = np.zeros(len(flat), bool)
    for j, e in enumerate(flat):
        dropped[j] = seen[e] >= ce
        seen[e] += 1
    return dropped


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_capacity_drops_the_reference_slots(ref, eight, shape):
    cf = 1.25
    cfg = _cfg(capacity_factor=cf)
    mod = _layer(ref, cfg)
    xf = torch.from_numpy(ref["x"]).reshape(B * S, cfg.d_model)
    dp, n = shape
    t_loc = B * S // dp
    e_local = cfg.n_experts // n
    ce = tmoe.capacity(t_loc * cfg.moe_top_k, cfg.n_experts, cf)
    total = 0
    for d in range(dp):
        _, _, top_idx = tmoe.route(mod, cfg, xf[d * t_loc:(d + 1) * t_loc])
        want_top = ref[f"top/{shape}/{d}"]
        np.testing.assert_array_equal(top_idx.numpy(), want_top)
        kept = torch.zeros(top_idx.numel(), dtype=torch.bool)
        for r in range(n):
            keep, _, _ = tmoe._rank_slots(top_idx.reshape(-1), r, e_local, ce)
            assert not (kept & keep).any()  # one rank keeps each replica
            kept |= keep
        want = _dropped_by_rule(want_top, cfg.n_experts, cf)
        np.testing.assert_array_equal((~kept).numpy(), want)
        total += int(want.sum())
    assert total > 0  # slots drop at 1.25 on this data


@pytest.mark.parametrize("case", ["ep", "hints_off", "experts_not_divisible",
                                  "tokens_not_divisible"])
def test_dispatch_rule_matches_reference(ref, eight, monkeypatch, case):
    mesh, over, xs = {
        "ep": ((2, 4), {}, (B, S)),
        "hints_off": (None, {}, (B, S)),
        "experts_not_divisible": ((2, 4), dict(n_experts=6), (B, S)),
        "tokens_not_divisible": ((4, 2), {}, (1, 3))}[case]
    cfg = _cfg(**over)
    mod = tmoe.MoE(cfg, "cpu")
    mod.reset_parameters(torch.Generator().manual_seed(1), cfg)
    taken = []
    ep = tmoe.moe_forward_ep
    monkeypatch.setattr(tmoe, "moe_forward_ep",
                        lambda p, c, x: (taken.append(1), ep(p, c, x))[1])
    if mesh:
        hints.enable_hints(make_mesh(mesh, ("data", "model")))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=xs + (cfg.d_model,)).astype(np.float32))
    out, _ = tmoe.moe_forward(mod, cfg, x)
    assert bool(taken) == ref["meta"][f"dispatch/{case}"]
    if not taken:
        assert torch.equal(out, tmoe.moe_forward_local(mod, cfg, x)[0])


def _tok(t):
    return tuple(t) if isinstance(t, list) else t


def _enc(e):
    """A spec entry as JSON holds it; a one-axis tuple is that axis, as a
    `PartitionSpec` entry reads."""
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else list(e)
    return e


@pytest.mark.parametrize("shape,axes", [
    ((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
    ((8,), ("model",)), ((4, 2), ("data", "model"))], ids=str)
def test_hints_match_reference(ref, eight, shape, axes):
    meta = ref["meta"]
    assert not hints.hints_enabled()
    assert hints.hint_spec((8, 6), "dp", "model") is None
    mesh = make_mesh(shape, axes)
    hints.enable_hints(mesh)
    assert hints.hints_enabled() and hints.current_mesh() is mesh
    key = f"{shape}"
    assert [_enc(hints._expand(_tok(t))) for t in meta["tokens"]] == \
        meta[f"expand/{key}"]
    assert [hints.axis_size(a) for a in ("data", "model", "pod", "bogus")] \
        == meta[f"axis_size/{key}"]
    for (xs, spec), want in zip(meta["specs"], meta[f"pinned/{key}"]):
        got = hints.hint_spec(tuple(xs), *[_tok(s) for s in spec])
        got = list(got) + [None] * (len(xs) - len(got))
        assert [_enc(e) for e in got] == want, (xs, spec)
        x = torch.zeros(xs)
        assert hints.shard_hint(x, *[_tok(s) for s in spec]) is x
    assert hints._STATE["data_axes"] == data_axes(mesh)
    hints.disable_hints()
    assert not hints.hints_enabled()


def test_make_mesh_needs_the_logical_devices():
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((2, 4), ("data", "model"))
    mesh = make_mesh((1, 1), ("data", "model"))  # the runtime's own device
    assert mesh.size == 1 and mesh.axis_names == ("data", "model")
    with logical_devices(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        assert dict(mesh.shape) == {"data": 2, "model": 4}
        assert mesh.devices.shape == (2, 4)
        assert mesh.devices.reshape(-1).tolist() == list(range(8))
        assert mesh.coords(6) == {"data": 1, "model": 2}
        with pytest.raises(ValueError, match="needs 16 devices"):
            make_mesh((4, 4), ("data", "model"))
        with pytest.raises(ValueError, match="repeat"):
            make_mesh((2, 4), ("data", "data"))
    with logical_devices(256):
        prod = make_production_mesh()
        assert dict(prod.shape) == {"data": 16, "model": 16}
        assert data_axes(prod) == ("data",)
        with pytest.raises(ValueError, match="needs 512 devices"):
            make_production_mesh(multi_pod=True)
    with logical_devices(512):
        pods = make_production_mesh(multi_pod=True)
        assert pods.axis_names == ("pod", "data", "model")
        assert pods.size == 512 and data_axes(pods) == ("pod", "data")


# ---------------------------------------------------------------------------
# on the card (`python -m pytest -m cuda`; no jax needed)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cf", CFS)
def test_ep_on_the_card_matches_the_cpu(cuda_device, eight, cf):
    cfg = _cfg(capacity_factor=cf)
    mod = tmoe.MoE(cfg, "cpu")
    mod.reset_parameters(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    want, waux = _ep(mod, cfg, x, (2, 4))
    got, aux = _ep(mod.to(cuda_device), cfg, x.to(cuda_device), (2, 4))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-4)


@pytest.mark.cuda
def test_quantize_int8_on_the_card_is_bitwise_the_cpu(cuda_device):
    """64 leaves of seeded scales: 64 maxima divided by 127 (CUDA divides
    by a host scalar through its reciprocal, an ulp off for some)."""
    gen = np.random.default_rng(3)
    for i in range(64):
        n = int(gen.integers(1, 1 << 16))
        g = torch.from_numpy((gen.normal(size=(n,)) * 10.0 ** gen.uniform(
            -6, 2)).astype(np.float32))
        err = torch.from_numpy(1e-3 * gen.normal(size=(n,)).astype(
            np.float32)) * g.abs().max()
        want = compress.quantize_int8(g, err)
        got = compress.quantize_int8(g.to(cuda_device), err.to(cuda_device))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), i
