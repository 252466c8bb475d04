"""The port's Mamba mixer against the reference's.

One reduced-jamba Mamba layer (`repro.models.mamba.mamba_init` from a
PRNGKey, carried over leaf by leaf) and the same seeded numpy inputs
through `repro.models.mamba.mamba_forward` and the port's, on the CPU:
prefill (the port's scan is `ops.ssm_scan`, on the CPU the plain
`ref.ssm_scan`; the reference's `selective_scan`) and decode steps from a
carried state (`selective_scan` at S = 1 in both), within 1e-5 in
float32 (the same operations in another summation order) and the
bfloat16 tolerance of `tests/test_kernels.py` (2e-2) in bfloat16.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import mamba as tmamba

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")


def _layer(dtype="float32", seed=3):
    """(reference cfg, one reference Mamba layer's params, the port's cfg,
    its Mamba module holding the same values)."""
    from repro.configs import get_config as ref_config
    from repro.models.mamba import mamba_init
    rcfg = ref_config("jamba-v0.1-52b").reduced().with_(dtype=dtype)
    cfg = get_config("jamba-v0.1-52b").reduced().with_(dtype=dtype)
    # float32 draws whichever tests ran before in this process (a test
    # that imports `repro.core` turns jax's x64 mode on for the process)
    with jax.enable_x64(False):
        params = jax.tree_util.tree_map(
            np.asarray, mamba_init(jax.random.PRNGKey(seed), rcfg))
    mod = tmamba.Mamba(cfg, "cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in params.items()})
    return rcfg, params, cfg, mod


@pytest.fixture(scope="module")
def layer():
    return _layer()


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_leaves_dtypes_and_shapes():
    cfg = get_config("jamba-v0.1-52b").reduced().with_(dtype="bfloat16")
    mod = tmamba.Mamba(cfg, "cpu")
    di, ds, r = cfg.d_inner, cfg.d_state, tmamba.dt_rank(cfg)
    want = {"in_proj": (cfg.d_model, 2 * di), "conv_w": (di, 1, 4),
            "conv_b": (di,), "x_proj": (di, r + 2 * ds), "dt_proj": (r, di),
            "dt_bias": (di,), "A_log": (di, ds), "D_skip": (di,),
            "out_proj": (di, cfg.d_model)}
    assert {n: tuple(p.shape) for n, p in mod.named_parameters()} == want
    for name, p in mod.named_parameters():
        f32 = name in ("dt_bias", "A_log", "D_skip")
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    spec = tmamba.mamba_state_spec(cfg, 3)
    assert spec == {"h": ((3, di, ds), torch.float32),
                    "conv": ((3, di, 3), torch.bfloat16)}


def test_init_follows_the_reference_distributions():
    cfg = get_config("jamba-v0.1-52b").reduced()
    mod = tmamba.Mamba(cfg, "cpu")
    mod.reset_parameters(torch.Generator().manual_seed(0), cfg)
    ds = cfg.d_state
    assert torch.equal(mod.A_log, torch.log(torch.arange(
        1, ds + 1, dtype=torch.float32)).repeat(cfg.d_inner, 1))
    assert torch.equal(mod.D_skip, torch.ones(cfg.d_inner))
    dt = torch.nn.functional.softplus(mod.dt_bias)  # in [0.001, 0.1]
    assert dt.min() >= 0.001 * 0.999 and dt.max() <= 0.1 * 1.001


@pytest.mark.parametrize("S", [8, 24, 40])
def test_prefill_matches_reference(layer, rng, S):
    from repro.models.mamba import mamba_forward
    rcfg, params, cfg, mod = layer
    x = rng.normal(size=(2, S, cfg.d_model))
    want, wstate = mamba_forward(params, rcfg, jnp.asarray(x, jnp.float32))
    got, gstate = tmamba.mamba_forward(mod, cfg, torch.from_numpy(x).float())
    _close(got, want, 1e-5)
    _close(gstate["h"], wstate["h"], 1e-5)
    _close(gstate["conv"], wstate["conv"], 1e-5)


def test_causal_conv_matches_reference(layer, rng):
    from repro.models.mamba import _causal_conv
    rcfg, params, cfg, mod = layer
    x = rng.normal(size=(2, 12, cfg.d_inner))
    state = rng.normal(size=(2, cfg.d_inner, 3))
    _close(tmamba._causal_conv(mod, torch.from_numpy(x).float(), None),
           _causal_conv(params, jnp.asarray(x, jnp.float32), None), 1e-5)
    _close(tmamba._causal_conv(mod, torch.from_numpy(x[:, :1]).float(),
                               torch.from_numpy(state).float()),
           _causal_conv(params, jnp.asarray(x[:, :1], jnp.float32),
                        jnp.asarray(state, jnp.float32)), 1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_decode_steps_match_reference(rng, dtype, tol):
    """Prefill 16 tokens, then 6 decode steps from the carried state, in
    both packages."""
    from repro.models.mamba import mamba_forward
    rcfg, params, cfg, mod = _layer(dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = rng.normal(size=(2, 22, cfg.d_model))
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    _, wstate = mamba_forward(params, rcfg, jx[:, :16])
    _, gstate = tmamba.mamba_forward(mod, cfg, tx[:, :16])
    for t in range(16, 22):
        want, wstate = mamba_forward(params, rcfg, jx[:, t:t + 1], wstate,
                                     decode=True)
        got, gstate = tmamba.mamba_forward(mod, cfg, tx[:, t:t + 1], gstate,
                                           decode=True)
        assert got.dtype == tx.dtype and gstate["h"].dtype == torch.float32
        _close(got, want, tol)
    _close(gstate["h"], wstate["h"], tol)
    _close(gstate["conv"], wstate["conv"], tol)
