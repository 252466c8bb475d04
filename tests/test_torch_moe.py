"""The port's MoE FFN against the reference's.

One MoE layer (`repro.models.moe.moe_init` from a PRNGKey, carried over
leaf by leaf) of the reduced jamba (4 experts, top-2) and of the reduced
deepseek-moe-16b (8 fine-grained experts, top-2, one shared expert), and
the same seeded numpy tokens through the reference's `moe_forward_local`
and the port's, on the CPU: out within 1e-4 and aux within 1e-5 of each
other and of the dense oracle (`tests/test_models.py::
test_moe_dispatch_matches_dense_oracle`'s tolerances). A bfloat16 case
plants router ties (equal router columns, so equal probabilities):
`jax.lax.top_k` takes the lower index among equals, and the port's stable
sort must pick the same experts, then agree within bfloat16's 2e-2.
Whole blocks with an MoE FFN ("attn+moe" of deepseek-moe-16b, with its
shared expert; "mamba+moe" of jamba) are held against the reference's
`block_forward` at 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")


def _layer(arch, dtype="float32", seed=1, ties=False, **overrides):
    """(reference cfg, reference params, the port's cfg, its MoE module
    holding the same values), of the reduced config with `overrides`. With
    `ties`, experts 1..3 share expert 0's router column, so their logits
    tie exactly."""
    from repro.configs import get_config as ref_config
    from repro.models.moe import moe_init
    rcfg = ref_config(arch).reduced().with_(dtype=dtype, **overrides)
    cfg = get_config(arch).reduced().with_(dtype=dtype, **overrides)
    # float32 draws whichever tests ran before in this process (a test
    # that imports `repro.core` turns jax's x64 mode on for the process)
    with jax.enable_x64(False):
        params = jax.tree_util.tree_map(
            np.asarray, moe_init(jax.random.PRNGKey(seed), rcfg))
    if ties:
        params["router"] = params["router"].copy()
        params["router"][:, 1:4] = params["router"][:, :1]
    mod = tmoe.MoE(cfg, "cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in _flat(params)})
    return rcfg, params, cfg, mod


def _x(rng, cfg, dtype="float32", B=2, S=16):
    x = rng.normal(size=(B, S, cfg.d_model))
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "deepseek_moe_16b"])
def test_local_dispatch_matches_reference_and_dense_oracle(rng, arch):
    from repro.models import moe as rmoe
    rcfg, params, cfg, mod = _layer(arch)
    jx, tx = _x(rng, cfg)
    want, waux = rmoe.moe_forward_local(params, rcfg, jx)
    got, aux = tmoe.moe_forward_local(mod, cfg, tx)
    dense, daux = tmoe.moe_forward_dense_fallback(mod, cfg, tx)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    for out, a in ((got, aux), (dense, daux)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(float(a), float(waux), rtol=1e-5)
    assert torch.equal(tmoe.moe_forward(mod, cfg, tx)[0], got)


def test_routing_ties_break_to_the_lower_index_in_bfloat16(rng):
    from repro.models import moe as rmoe
    rcfg, params, cfg, mod = _layer("jamba_v0_1_52b", "bfloat16", ties=True)
    jx, tx = _x(rng, cfg, "bfloat16", S=32)
    xf = tx.reshape(-1, cfg.d_model)
    probs, _, idx = tmoe.route(mod, cfg, xf)
    _, want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.moe_top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # the planted ties are there: experts 0..3 share every probability
    assert torch.equal(probs[:, 0], probs[:, 3])
    assert ((idx[:, 0] < 4) & (idx[:, 1] < 4)).any()
    want, waux = rmoe.moe_forward_local(params, rcfg, jx)
    got, aux = tmoe.moe_forward_local(mod, cfg, tx)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


@pytest.mark.parametrize("shared", [False, True])
def test_top6_bfloat16_sums_replicas_in_expert_order(rng, shared):
    """At k = 6 in bfloat16 (deepseek-moe-16b's reduced 8 experts; the
    reduced config caps k at 2) the order in which a token's replicas are
    summed shows: the reference's scatter-add applies them in ascending
    expert id, and so must the port (ROADMAP Queue 3 item 21; the top-k
    order matched ~48 % of entries). Without the shared expert the two
    agree bit for bit. The shared expert's dense bf16 product is a
    rounding of its own (XLA's dot and torch's matmul differ in a few
    entries), so with it the layer is held within bfloat16's 2e-2."""
    from repro.models import moe as rmoe
    over = dict(moe_top_k=6) if shared else dict(moe_top_k=6,
                                                 n_shared_experts=0)
    rcfg, params, cfg, mod = _layer("deepseek_moe_16b", "bfloat16", **over)
    assert (cfg.n_experts, cfg.moe_top_k) == (8, 6)
    assert bool(cfg.n_shared_experts) == shared
    jx, tx = _x(rng, cfg, "bfloat16", S=32)
    want, waux = rmoe.moe_forward_local(params, rcfg, jx)
    got, aux = tmoe.moe_forward_local(mod, cfg, tx)
    assert got.dtype == torch.bfloat16
    if shared:
        _close(got, want, 2e-2)
    else:
        assert torch.equal(got.float(),
                           torch.from_numpy(np.asarray(want, np.float32)))
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_top_k_takes_the_lower_index_among_equals():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe.top_k(probs, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    assert torch.equal(vals, torch.tensor([[0.3, 0.3], [0.25, 0.25]]))


def test_expert_parallel_path_waits_for_the_sharded_placement(rng):
    _, _, cfg, mod = _layer("jamba_v0_1_52b")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        tmoe.moe_forward_ep(mod, cfg, _x(rng, cfg)[1])


def test_init_follows_the_reference_shapes():
    from repro.configs import get_config as ref_config
    from repro.models.moe import moe_init
    for arch in ("jamba_v0_1_52b", "deepseek_moe_16b"):
        cfg = get_config(arch).reduced()
        mod = tmoe.MoE(cfg, "cpu")
        mod.reset_parameters(torch.Generator().manual_seed(0), cfg)
        shapes = jax.eval_shape(lambda: moe_init(jax.random.PRNGKey(0),
                                                 ref_config(arch).reduced()))
        want = {k: tuple(v.shape) for k, v in _flat(shapes)}
        assert {n: tuple(p.shape) for n, p in mod.named_parameters()} == want
        # the experts' scale: 1/sqrt(d) on the way in, 1/sqrt(de) out
        assert abs(mod.w_gate.std().item() * cfg.d_model ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("kind,arch", [("attn+moe", "deepseek_moe_16b"),
                                       ("mamba+moe", "jamba_v0_1_52b")])
def test_moe_blocks_match_reference(rng, kind, arch):
    """A whole pre-norm block with an MoE FFN: prefill output, aux loss
    and cache against the reference's `block_forward`."""
    from repro.configs import get_config as ref_config
    from repro.models import blocks as rblocks
    from repro_torch.models import blocks as tblocks
    from repro_torch.models.model import _tree_map
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    with jax.enable_x64(False):  # float32 draws, as in _layer
        params = jax.tree_util.tree_map(
            np.asarray, rblocks.block_init(jax.random.PRNGKey(2), rcfg, kind))
    blk = tblocks.Block(cfg, kind, "cpu")
    blk.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in _flat(params)})
    x = rng.normal(size=(2, 12, cfg.d_model))
    pos = np.broadcast_to(np.arange(12, dtype=np.int32)[None], (2, 12))
    want, waux, wcache = rblocks.block_forward(
        params, rcfg, kind, jnp.asarray(x, jnp.float32), jnp.asarray(pos),
        collect_cache=True)
    got, aux, cache = tblocks.block_forward(
        blk, cfg, kind, torch.from_numpy(x).float(),
        torch.from_numpy(pos.copy()), collect_cache=True)
    _close(got, want, 1e-4)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    _tree_map(lambda g, w: _close(g, w, 1e-4), cache,
              jax.tree_util.tree_map(np.asarray, wcache))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v
