"""The port's MLA and cross-attention layers against the reference's.

MLA (`models/mla.py`, DeepSeek-V2) at deepseek-v2-236b's reduced config
(d 128, 4 heads of q/k 32 + 16 RoPE and v 32, latent 64, q rank 96): the
reference's `mla_init(PRNGKey(0))` values loaded into the port's module,
the same numpy inputs through `mla_forward` (prefill at S ≤ attn_chunk,
the "ref" core, and above it, "chunked"; the reference pads v to q's
width and slices the output back, the port reads v at its own width) and
`mla_decode` (absorbed, over the latent cache) of both packages, float32
within 1e-4, as the model tests. The port's own mirror of
`tests/test_models.py::test_mla_decode_matches_expanded` keeps its rtol
2e-3. Each attention route the port's MLA can take (the flash kernel's
plain version `ref.attention`, the model's "ref" and "chunked" cores)
with an unpadded v must equal the padded route sliced (within 1e-6).

The cross-attention layer (`attention.xattn_forward`, llama-3.2-vision)
against the reference's with a nonzero gate in the numpy params both
load (the reference initialises it to 0, and tanh(0) hides the image).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla

TOL = dict(rtol=1e-4, atol=1e-4)

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")


def _load(module, params):
    """The reference's nested numpy dict into `module` (dotted names)."""
    flat = {}

    def walk(tree, prefix):
        for key, sub in tree.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(sub, dict):
                walk(sub, path)
            else:
                flat[path] = torch.from_numpy(np.array(sub, np.float32))
    walk(params, "")
    module.load_state_dict(flat)
    return module


@pytest.fixture(scope="module")
def mla_pair():
    from repro.models import mla as rmla
    cfg = get_config("deepseek_v2_236b").reduced()
    with jax.enable_x64(False):
        params = jax.tree_util.tree_map(
            np.asarray, rmla.mla_init(jax.random.PRNGKey(0), cfg))
    return cfg, rmla, params, _load(tmla.MLA(cfg, "cpu"), params)


def _x(seed, cfg, B, S):
    return (np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
            * 0.1).astype(np.float32)


def _positions(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))


@pytest.mark.parametrize("S", [12, 128])  # ≤ and > attn_chunk (64)
def test_mla_forward_matches_reference(mla_pair, S):
    cfg, rmla, params, port = mla_pair
    x, pos = _x(0, cfg, 2, S), _positions(2, S)
    want, (wc, wr) = rmla.mla_forward(params, cfg, jnp.asarray(x),
                                      jnp.asarray(pos))
    got, (gc, gr) = tmla.mla_forward(port, cfg, torch.from_numpy(x),
                                     torch.from_numpy(pos.copy()))
    assert got.shape == (2, S, cfg.d_model)
    assert gc.shape == (2, S, cfg.kv_lora_rank)
    assert gr.shape == (2, S, cfg.rope_head_dim)
    for g, w in ((got, want), (gc, wc), (gr, wr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mla_decode_matches_reference(mla_pair):
    cfg, rmla, params, port = mla_pair
    B, S, max_len = 2, 12, 20
    x, pos = _x(1, cfg, B, S + 4), _positions(B, S)
    _, (wc, wr) = rmla.mla_forward(params, cfg, jnp.asarray(x[:, :S]),
                                   jnp.asarray(pos))
    wcache = tuple(jnp.pad(t, ((0, 0), (0, max_len - S), (0, 0)))
                   for t in (wc, wr))
    gcache = tuple(torch.from_numpy(np.array(t)) for t in wcache)
    for t in range(S, S + 4):
        step = x[:, t:t + 1]
        want, wcache = rmla.mla_decode(params, cfg, jnp.asarray(step),
                                       wcache, jnp.int32(t))
        got, same = tmla.mla_decode(port, cfg, torch.from_numpy(step),
                                    gcache, t)
        assert same is gcache  # updated in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(gcache, wcache, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mla_decode_matches_expanded(mla_pair):
    """Absorbed decode == the expanded prefill at the same position (the
    reference's test of the same name, its tolerance)."""
    cfg, _, _, port = mla_pair
    B, S = 2, 12
    x = torch.from_numpy(_x(2, cfg, B, S))
    pos = torch.from_numpy(_positions(B, S).copy())
    out_full, (ckv, kr) = tmla.mla_forward(port, cfg, x, pos)
    pad = S + 4
    cache = tuple(F.pad(t, (0, 0, 0, pad - S)) for t in (ckv, kr))
    for t in cache:  # decode the last token against the first S - 1
        t[:, S - 1:] = 0
    out_step, _ = tmla.mla_decode(port, cfg, x[:, S - 1:S], cache, S - 1)
    np.testing.assert_allclose(out_step[:, 0].numpy(),
                               out_full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_mla_cache_spec(mla_pair):
    cfg = mla_pair[0]
    assert tmla.mla_cache_spec(cfg, 3, 40) == (
        ((3, 40, 64), torch.float32), ((3, 40, 16), torch.float32))


def _chunk(n: int) -> int:
    """The largest block of at most 16 rows that divides n."""
    return max(d for d in range(1, 17) if n % d == 0)


_ROUTES = {
    "flash_plain": fref.attention,
    "ref": tattn.ref_attention,
    "chunked": lambda q, k, v, causal: tattn.chunked_attention(
        q, k, v, causal=causal, q_chunk=_chunk(q.shape[1]),
        k_chunk=_chunk(k.shape[1]))}


@pytest.mark.parametrize("route", sorted(_ROUTES))
@pytest.mark.parametrize("Sq,Sk,causal", [(64, 64, True), (33, 33, True),
                                          (64, 64, False), (17, 40, False)])
def test_unpadded_v_equals_padded_route(route, Sq, Sk, causal):
    """An attention route with v at 128 (the operands at DeepSeek-V2's
    widths: q/k 192, v 128) against the reference's route, v padded to
    192 and the output sliced back."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, Sq, 4, 192), (2, Sk, 4, 192), (2, Sk, 4, 128)))
    attend = _ROUTES[route]
    got = attend(q, k, v, causal=causal)
    want = attend(q, k, F.pad(v, (0, 64)), causal=causal)[..., :128]
    assert got.shape == (2, Sq, 4, 128)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_xattn_forward_matches_reference():
    from repro.models import attention as rattn
    cfg = get_config("llama3_2_vision_90b").reduced().with_(
        n_image_tokens=16)
    with jax.enable_x64(False):
        params = jax.tree_util.tree_map(
            np.asarray, rattn.xattn_init(jax.random.PRNGKey(0), cfg))
    params["gate"] = np.array([0.75], np.float32)
    port = _load(tattn.XAttn(cfg, "cpu"), params)
    assert port.gate.dtype == torch.float32
    rng = np.random.default_rng(4)
    for S in (12, 128):  # the "ref" and the "chunked" core
        x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
        img = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
        want = rattn.xattn_forward(params, cfg, jnp.asarray(x),
                                   jnp.asarray(img))
        got, (k, v) = tattn.xattn_forward(port, cfg, torch.from_numpy(x),
                                          torch.from_numpy(img))
        assert k.shape == v.shape == (2, 16, cfg.kv_heads, cfg.head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert np.abs(np.asarray(want)).max() > 1e-2  # the gate is open
