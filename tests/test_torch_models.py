"""The port's LM families against the reference's.

For each dense config's `reduced()` (qwen3-0.6b with qk_norm, llama3.2-1b
and -3b, phi3-medium-14b, lm-100m), for the ssm family's (rwkv6-3b: 2
layers, d 128, dh 32, chunk 16) and for the hybrid family's (jamba: 2
periods of 8 layers, 7 Mamba + 1 attention each, d 128, d_state 8, MoE of
4 experts top-2 on every second layer): the reference's `Model.init(
PRNGKey(0))` parameters carried over with `params_from_reference`, then
the same seeded numpy tokens through both packages on the CPU. Prefill
runs at S ≤ attn_chunk (the "ref" attention path in both) and at
S > attn_chunk ("chunked" in both); logits and K/V caches agree within
rtol/atol 1e-4 in float32 (the same operations in another summation
order; observed ≤ 2e-5). Decode is compared step by step, greedy
`generate` token for token, and one bfloat16 case within the bfloat16
tolerance of `tests/test_kernels.py` (2e-2). The port's own mirror of
`tests/test_models.py::test_decode_matches_prefill` keeps its 5e-3
(2e-2 for the recurrent families, as the reference). Every period cache
is compared leaf by leaf: K/V, rwkv6's WKV state and token-shift
carries, Mamba's scan state and conv carry; rwkv6's prefill also runs at
a ragged S 40 (the chunk is 16).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.interop import params_from_reference
from repro_torch.launch.serve import generate
from repro_torch.models import build_model

DENSE = ["qwen3_0_6b", "llama3_2_1b", "llama3_2_3b", "phi3_medium_14b",
         "lm_100m"]
SSM = ["rwkv6_3b"]
HYBRID = ["jamba_v0_1_52b"]
SERVED = DENSE + SSM + HYBRID
MODEL_ARCHS = [a for a in ARCHS if a != "paper_hpo"]
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")


def _pair(arch, dtype=None, **overrides):
    """(reference model, its params, the port's model on the CPU holding
    the same values), for the reduced config (with `overrides`)."""
    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_build
    kw = dict(overrides, **({"dtype": dtype} if dtype else {}))
    rcfg = ref_config(arch).reduced().with_(**kw)
    cfg = get_config(arch).reduced().with_(**kw)
    ref = ref_build(rcfg)
    # the same float32 values whichever tests ran before in this process:
    # with jax's x64 mode on (a test that imports `repro.core` turns it on
    # for the process) the reference's init scales by numpy float64
    # scalars, computes in float64 and returns other values
    with jax.enable_x64(False):
        params = jax.tree_util.tree_map(np.asarray,
                                        ref.init(jax.random.PRNGKey(0)))
    port = build_model(cfg, device="cpu")
    port.load_state_dict(params_from_reference(params, cfg, "cpu"))
    return ref, params, port


@pytest.fixture(scope="module", params=SERVED)
def pair(request):
    return _pair(request.param)


def _tokens(seed, cfg, batch, seq):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _leaves(tree):
    """A period cache's leaves in a fixed order (tuples in order, dicts by
    key)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _caches(caches, cfg):
    return [np.asarray(t, np.float32) for t in _leaves(caches["periods"])]


def _port_caches(caches, cfg):
    return [t.float().numpy() for t in _leaves(caches["periods"])]


def _cache_shapes(cfg, batch, max_len):
    """The stacked cache leaves' shapes, in `_leaves` order (period keys
    "{i}:{kind}" sorted, then each kind's leaves)."""
    n = cfg.n_periods()
    shapes = []
    for _, kind in sorted(enumerate(cfg.layer_kinds()),
                          key=lambda ik: f"{ik[0]}:{ik[1]}"):
        if kind == "rwkv6":
            dh = cfg.rwkv_head_dim
            shapes += [(n, batch, 1, cfg.d_model), (n, batch, 1, cfg.d_model),
                       (n, batch, cfg.d_model // dh, dh, dh)]
        elif kind.startswith("mamba"):  # "conv", "h"
            shapes += [(n, batch, cfg.d_inner, cfg.conv_kernel - 1),
                       (n, batch, cfg.d_inner, cfg.d_state)]
        else:
            shapes += [(n, batch, max_len, cfg.kv_heads, cfg.head_dim)] * 2
    return shapes


def _check_prefill(ref, params, port, seq):
    toks = _tokens(1, port.cfg, 2, seq)
    want, wcache = ref.prefill(params, jnp.asarray(toks), max_len=seq + 8)
    got, gcache = port.prefill(torch.from_numpy(toks), max_len=seq + 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    shapes = _cache_shapes(port.cfg, 2, seq + 8)
    for g, w, shape in zip(_port_caches(gcache, port.cfg),
                           _caches(wcache, port.cfg), shapes, strict=True):
        assert g.shape == w.shape == shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("seq", [32, 128])  # ≤ and > attn_chunk (64)
def test_prefill_matches_reference(pair, seq):
    _check_prefill(*pair, seq)


def test_ragged_prefill_matches_reference():
    # the ssm family's chunk is 16: S 40 runs two chunks and a ragged one
    _check_prefill(*_pair("rwkv6_3b"), 40)


def test_n_params_match_reference(pair):
    ref, _, port = pair
    assert port.n_params() == ref.n_params()


def test_decode_steps_match_reference(pair):
    ref, params, port = pair
    toks = _tokens(2, port.cfg, 2, 32)
    n0 = 24
    want, wcache = ref.prefill(params, jnp.asarray(toks[:, :n0]), max_len=32)
    got, gcache = port.prefill(torch.from_numpy(toks[:, :n0]), max_len=32)
    step = jax.jit(ref.decode_step)
    for t in range(n0, n0 + 8):
        nxt = toks[:, t:t + 1]
        want, wcache = step(params, jnp.asarray(nxt), wcache, jnp.int32(t))
        got, gcache = port.decode_step(torch.from_numpy(nxt), gcache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(_port_caches(gcache, port.cfg),
                    _caches(wcache, port.cfg), strict=True):
        np.testing.assert_allclose(g, w, **TOL)


def test_greedy_generate_matches_reference(pair):
    from repro.launch.serve import generate as ref_generate
    ref, params, port = pair
    prompts = _tokens(3, port.cfg, 2, 16)
    want = ref_generate(ref, params, prompts, max_new=8, max_len=24)
    got = generate(port, prompts, max_new=8, max_len=24)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", SERVED)
def test_decode_matches_prefill(arch):
    """Teacher-forced decode reproduces prefill logits (the port's mirror
    of the reference's test of the same name, same tolerances)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu").init(seed=0)
    toks = torch.from_numpy(_tokens(0, cfg, 2, 24))
    n0, total = 16, 24
    full, _ = model.prefill(toks, max_len=total)
    logits, caches = model.prefill(toks[:, :n0], max_len=total)
    for t in range(n0, total):
        logits, caches = model.decode_step(toks[:, t:t + 1], caches, t)
    tol = 2e-2 if cfg.family in ("ssm", "hybrid") else 5e-3
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=tol,
                               atol=tol)


def test_bfloat16_prefill_and_decode_match_reference():
    _check_bfloat16("qwen3_0_6b")


def test_bfloat16_rwkv6_prefill_and_decode_match_reference():
    _check_bfloat16("rwkv6_3b")


@pytest.mark.parametrize("n_layers", [8, 16])
def test_bfloat16_jamba_prefill_and_decode_match_reference(monkeypatch,
                                                           n_layers):
    """bf16 rounds differently in the two packages, and a rounding can
    flip a near-tied top-2 choice of the router; one flipped token moves
    its whole row and, through the Mamba scan, the later positions of its
    sequence. So the port replays the reference's routing: the reference
    runs its periods unscanned (`jax.lax.top_k` then runs eagerly and its
    choices can be read), and the port's `route` takes them call by call,
    with its own probabilities at those experts. Left free, the port must
    route at least 90 % of the tokens alike. One period (8 layers, every
    kind jamba has; the depth chip_smoke serves) and the reduced config's
    two. The drift grows with depth: on these weights the logits read
    ≤ 0.0088 at one period and ≤ 0.0184 at two, against the 2e-2 limit
    (0.015–0.025 at two periods across other weight draws). Its source is
    not the scan: the port's scan reproduced bit for bit as XLA's CPU
    backend computes it leaves every logit as it was; XLA's own exp and
    log1p (softplus of dt) differ from torch's in 10–15 % of entries by
    an ulp (tools/scan_parity.py; ROADMAP Queue 3 item 22)."""
    _check_bfloat16("jamba_v0_1_52b", _ReferenceRouting(monkeypatch),
                    n_layers=n_layers)


class _ReferenceRouting:
    """Reads the reference's top-k choices and replays them in the port's
    `route`, in call order; counts the tokens the port would route
    otherwise."""

    def __init__(self, monkeypatch):
        from repro_torch.models import moe as tmoe
        self.choices, self.tokens, self.flips = [], 0, 0
        top_k, route = jax.lax.top_k, tmoe.route

        def record(x, k):
            vals, idx = top_k(x, k)
            self.choices.append(np.asarray(idx))
            return vals, idx

        def replay(p, cfg, xf):
            probs, _, own = route(p, cfg, xf)
            idx = torch.from_numpy(self.choices.pop(0).astype(np.int64))
            self.tokens += idx.shape[0]
            self.flips += int((idx != own).any(-1).sum())
            return probs, probs.gather(1, idx), idx

        monkeypatch.setattr(jax.lax, "top_k", record)
        monkeypatch.setattr(tmoe, "route", replay)

    @staticmethod
    def unscanned(ref, params):
        """The reference model with its periods run one by one."""
        from repro.models import build_model as ref_build
        n = ref.cfg.n_periods()
        periods = [jax.tree_util.tree_map(lambda a, i=i: a[i],
                                          params["periods"])
                   for i in range(n)]
        return (ref_build(ref.cfg.with_(scan_layers=False)),
                dict(params, periods=periods))


def _check_bfloat16(arch, routing=None, **overrides):
    ref, params, port = _pair(arch, dtype="bfloat16", **overrides)
    assert port.embed.tok.dtype == torch.bfloat16
    assert port.final_norm.scale.dtype == torch.float32
    step = jax.jit(ref.decode_step)
    if routing is not None:
        ref, params = routing.unscanned(ref, params)
        step = ref.decode_step  # eager: its routing is read as it runs
    toks = _tokens(4, port.cfg, 2, 40)
    want, wcache = ref.prefill(params, jnp.asarray(toks[:, :32]), max_len=40)
    got, gcache = port.prefill(torch.from_numpy(toks[:, :32]), max_len=40)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    for t in range(32, 36):
        nxt = toks[:, t:t + 1]
        want, wcache = step(params, jnp.asarray(nxt), wcache, jnp.int32(t))
        got, gcache = port.decode_step(torch.from_numpy(nxt), gcache, t)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **BF16_TOL)
    if routing is not None:
        assert not routing.choices and routing.tokens
        assert routing.flips <= 0.1 * routing.tokens


def test_temperature_sampling_is_seeded():
    cfg = get_config("qwen3-0.6b").reduced()
    model = build_model(cfg, device="cpu").init(seed=1)
    prompts = _tokens(5, cfg, 3, 8)
    a = generate(model, prompts, max_new=6, max_len=14, temperature=0.8,
                 seed=7)
    b = generate(model, prompts, max_new=6, max_len=14, temperature=0.8,
                 generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 6) and a.min() >= 0 and a.max() < cfg.vocab_size


# ---------------------------------------------------------------------------
# configs and parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_configs_and_counts_match_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_build
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(rcfg.reduced())
    assert cfg.param_counts() == rcfg.param_counts()
    assert cfg.total_params() == rcfg.total_params()
    assert cfg.active_params() == rcfg.active_params()
    if cfg.family not in ("dense", "ssm", "hybrid"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            build_model(cfg, device="meta")
        return
    n = build_model(cfg, device="meta").n_params()
    if cfg.family in ("ssm", "hybrid"):
        # rwkv6's own leaves (mu, lora, w0, u, ln_x, ...) and mamba's
        # (conv_b, dt_bias, D_skip, the full x_proj and dt_proj) are more
        # than total_params counts; the reference's n_params counts them
        assert n == ref_build(rcfg).n_params()
        return
    # the reference's n_params counts the norm scales, which
    # total_params leaves out: two per layer, the final norm, and the
    # q/k norms of qk_norm
    scales = cfg.n_layers * (2 * cfg.d_model
                             + (2 * cfg.head_dim if cfg.qk_norm else 0))
    assert n == ref_build(rcfg).n_params() == \
        cfg.total_params() + scales + cfg.d_model


def test_aliases_resolve_like_the_reference():
    from repro.configs import _ALIAS as ref_alias
    from repro_torch.configs import _ALIAS
    assert _ALIAS == ref_alias
    for alias, name in _ALIAS.items():
        assert get_config(alias) is get_config(name)


def test_build_model_needs_a_gpu_unless_asked_for_the_cpu():
    cfg = get_config("qwen3-0.6b").reduced()
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg)
    assert build_model(cfg, device="cpu").device == torch.device("cpu")
