"""The port's RWKV-6 (WKV6 recurrence and time/channel mix) against the
reference.

Same inputs (numpy, from a seed) through `repro.kernels.rwkv6` — the
Pallas kernel in interpret mode and the jnp oracle `ref.wkv6` — and
through `repro_torch.kernels.rwkv6.ops` on the CPU, where it takes
`ref.wkv_chunked`. Shapes and tolerances are those of
`tests/test_kernels.py::TestRwkv6Kernel` (max error over max|y| < 1e-4,
state rtol/atol 1e-4; decode steps against the scan 1e-5). A ragged S,
which the Pallas kernel does not take, is held against the reference's
`wkv_chunked` and the oracle. The model pieces (`_ddlerp`, `_group_norm`,
`time_mix`, `channel_mix`) are held against the reference's at 1e-5.

The CUDA kernel runs only on the card: the `cuda`-marked cases hold it
against the plain version computed in float32 from the same inputs, each
y and state entry within `KERNEL_TOL[dtype]` of its envelope (the same
recurrence on |r|, |k|, |v|, |u|, |state|; `ref.scaled_err`). The float32
kernel's products are 3xTF32, so it differs only in summation order and
in the rounding of the cumulative log-decays (a chunked float32 sum reads
≤ 2.1e-5 against a float64 scan here, about a twelfth of 2⁻¹²); the
bfloat16 kernel rounds each product's operands to TF32 once and y to
bfloat16, at most 2⁻⁹ of its envelope. The CPU cases show the limit
passes a chunked float32 sum and fails a dropped sub-block pair, a decay
off by one step and a state not carried across chunks, each by ≥ 10×.
`_two_pass` emulates the kernel's algebra (a state pass keeping the
state entering every chunk, then an output pass per chunk, with the
kernel's sub-block factors) with and without its TF32 operand roundings;
it is held against the reference's kernel, oracle and chunked form here,
and the `cuda`-marked cases hold the kernel against it.
This module imports jax only inside the `reference` fixture.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import ops as tops
from repro_torch.kernels.rwkv6 import ref as tref
from repro_torch.models import rwkv6 as trwkv

KERNEL_TOL = {"float32": 2.0 ** -12, "bfloat16": 2.0 ** -8 + 2.0 ** -12}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.rwkv6 import ops, ref
    return jnp, ops, ref


def _inputs(rng, B, S, H, dh, decay="test", state_scale=0.1):
    """r, k, v, logw (B, S, H, dh), u (H, dh), state (B, H, dh, dh) as
    float64 numpy; logw as in tests/test_kernels.py unless `decay` says
    otherwise."""
    r, k, v = (rng.normal(size=(B, S, H, dh)) for _ in range(3))
    if decay == "extreme":
        lw = np.full((B, S, H, dh), -5.0)
    elif decay == "slow":
        lw = np.clip(-1e-4 * np.exp(0.5 * rng.normal(size=(B, S, H, dh))),
                     -5.0, -1e-4)
    else:
        lw = np.clip(-np.exp(rng.normal(size=(B, S, H, dh)) * 1.5), -5.0,
                     -1e-4)
    u = rng.normal(size=(H, dh)) * 0.1
    s0 = rng.normal(size=(B, H, dh, dh)) * state_scale
    return r, k, v, lw, u, s0


def _port(arrays, dtype="float32", device="cpu"):
    """The port's tensors: r, k, v in `dtype`, the rest float32."""
    out = [torch.from_numpy(np.asarray(a)).to(device=device,
                                              dtype=TORCH_DTYPE[dtype])
           for a in arrays[:3]]
    return out + [torch.from_numpy(np.asarray(a)).to(device=device,
                                                    dtype=torch.float32)
                  for a in arrays[3:]]


def _jax(jnp, arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("S,H,dh,chunk", [
    (64, 2, 32, 32), (128, 3, 32, 64), (256, 2, 64, 64),
])
def test_plain_matches_reference_kernel(reference, rng, S, H, dh, chunk):
    jnp, rops, rref = reference
    arrays = _inputs(rng, 2, S, H, dh)
    y_ref, s_ref = rref.wkv6(*_jax(jnp, arrays))
    y_pl, s_pl = rops.wkv6(*_jax(jnp, arrays), chunk=chunk, interpret=True)
    y, s = tops.wkv6(*_port(arrays), chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (2, S, H, dh)
    assert s.dtype == torch.float32 and s.shape == (2, H, dh, dh)
    for yw, sw in ((y_pl, s_pl), (y_ref, s_ref)):
        scale = float(np.abs(np.asarray(y_ref)).max()) + 1e-6
        assert np.abs(_np(y) - np.asarray(yw)).max() / scale < 1e-4
        np.testing.assert_allclose(_np(s), np.asarray(sw), rtol=1e-4,
                                   atol=1e-4)


def test_port_oracle_matches_reference_oracle(reference, rng):
    jnp, _, rref = reference
    arrays = _inputs(rng, 2, 48, 2, 32)
    y_ref, s_ref = rref.wkv6(*_jax(jnp, arrays))
    y, s = tref.wkv6(*_port(arrays))
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(s), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-5)


def test_extreme_decay_stable(reference, rng):
    """Clamped maximal decay must not produce inf/nan."""
    jnp, rops, rref = reference
    arrays = list(_inputs(rng, 1, 64, 1, 32, decay="extreme"))
    arrays[4] = np.zeros_like(arrays[4])
    arrays[5] = np.zeros_like(arrays[5])
    y_ref, _ = rref.wkv6(*_jax(jnp, arrays))
    y, _ = tops.wkv6(*_port(arrays), chunk=32)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)


def test_decode_step_matches_scan(reference, rng):
    from repro.models.rwkv6 import wkv_step as ref_step
    jnp, _, rref = reference
    B, S, H, dh = 1, 8, 2, 16
    arrays = list(_inputs(rng, B, S, H, dh))
    arrays[5] = np.zeros_like(arrays[5])
    y_ref, s_ref = rref.wkv6(*_jax(jnp, arrays))
    r, k, v, lw, u, s = _port(arrays)
    js = jnp.asarray(arrays[5], jnp.float32)
    ys = []
    for t in range(S):
        y, s = trwkv.wkv_step(r[:, t], k[:, t], v[:, t], lw[:, t], u, s)
        jy, js = ref_step(*(jnp.asarray(a[:, t], jnp.float32)
                            for a in arrays[:4]),
                          jnp.asarray(arrays[4], jnp.float32), js)
        np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.stack(ys, dim=1)),
                               np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(17, 128), (40, 16), (100, 32),
                                     (1, 16)])
def test_ragged_lengths_match_reference(reference, rng, S, chunk):
    from repro.models.rwkv6 import wkv_chunked as ref_chunked
    jnp, _, rref = reference
    arrays = _inputs(rng, 2, S, 2, 32)
    y_c, s_c = ref_chunked(*_jax(jnp, arrays), chunk)
    y_o, s_o = rref.wkv6(*_jax(jnp, arrays))
    y, s = tops.wkv6(*_port(arrays), chunk=chunk)
    assert y.shape == (2, S, 2, 32)
    for yw, sw in ((y_c, s_c), (y_o, s_o)):
        scale = float(np.abs(np.asarray(y_o)).max()) + 1e-6
        assert np.abs(_np(y) - np.asarray(yw)).max() / scale < 1e-4
        np.testing.assert_allclose(_np(s), np.asarray(sw), rtol=1e-4,
                                   atol=1e-4)


def test_chunk_rule_matches_wkv_chunked():
    # min(chunk, max(S, SUB)) rounded down to a multiple of SUB
    assert tops.chunk_rows(2048, 128) == 128
    assert tops.chunk_rows(1000, 128) == 128
    assert tops.chunk_rows(17, 128) == 16
    assert tops.chunk_rows(5, 128) == 16
    assert tops.chunk_rows(40, 32) == 32


def test_cpu_tensors_take_the_plain_version(rng):
    args = _port(_inputs(rng, 1, 20, 2, 32))
    before = dict(tops.LAUNCHES)
    y, s = tops.wkv6(*args, chunk=16)
    want = tref.wkv_chunked(*args, 16)
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])
    assert tops.LAUNCHES == before
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tops.wkv6_cuda(*args, chunk=16)


# ---------------------------------------------------------------------------
# the kernel's tolerance: passes roundings, fails planted faults
# ---------------------------------------------------------------------------

def _scan64(r, k, v, lw, u, s):
    """The port's oracle (`ref.wkv6`) in float64."""
    return tref.wkv6(*(torch.as_tensor(a, dtype=torch.float64)
                       for a in (r, k, v, lw, u, s)), dtype=torch.float64)


def _decay_off_by_one(arrays, chunk):
    """Each step reads the state after its own decay (every term decays
    one step too many): the scan on r ⊙ w, its bonus term restored."""
    r, k, v, lw, u, s0 = (torch.as_tensor(a, dtype=torch.float64)
                          for a in arrays)
    w = torch.exp(lw)
    y, s = _scan64(r * w, k, v, lw, u, s0)
    bonus = torch.einsum("bthd,hd,bthd->bth", r * (1 - w), u, k)
    return y + bonus[..., None] * v, s


def _pair_dropped(arrays, chunk):
    """The exact result less sub-block pair (b=1, a=0) of the second
    chunk: rows C+16..C+31 miss the terms of keys C..C+15."""
    r, k, v, lw, u, s0 = (torch.as_tensor(a, dtype=torch.float64)
                          for a in arrays)
    y, s = _scan64(*arrays)
    c0 = chunk
    lwc = torch.cumsum(lw[:, c0:c0 + 32], dim=1)
    lx = lwc - lw[:, c0:c0 + 32]
    t, src = slice(16, 32), slice(0, 16)
    coef = torch.exp(lx[:, t, None] - lwc[:, None, src])   # (B, T, S, H, d)
    A = torch.einsum("bthd,bshd,btshd->bhts", r[:, c0 + 16:c0 + 32],
                     k[:, c0:c0 + 16], coef)
    y = y.clone()
    y[:, c0 + 16:c0 + 32] -= torch.einsum("bhts,bshe->bthe", A,
                                          v[:, c0:c0 + 16])
    return y, s


def _state_not_carried(arrays, chunk):
    """Every chunk after the first starts from a zero state."""
    r, k, v, lw, u, s0 = arrays
    ys, s = [], None
    for c0 in range(0, r.shape[1], chunk):
        rows = slice(c0, c0 + chunk)
        start = s0 if c0 == 0 else np.zeros_like(s0)
        y, s = _scan64(r[:, rows], k[:, rows], v[:, rows], lw[:, rows], u,
                       start)
        ys.append(y)
    return torch.cat(ys, dim=1), s


FAULTS = {
    "pair_dropped": _pair_dropped,
    "decay_off_by_one": _decay_off_by_one,
    "state_not_carried": _state_not_carried,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_kernel_tolerance_passes_roundings_and_fails_faults(rng, fault):
    chunk = 128
    arrays = _inputs(rng, 1, 512, 2, 64)
    args = _port(arrays)
    want = _scan64(*arrays)
    sound = tref.wkv_chunked(*args, chunk)  # float32, chunked
    assert tref.scaled_err(sound, want, *args, chunk=chunk) \
        <= KERNEL_TOL["float32"] / 4
    rounded = (sound[0].bfloat16(), sound[1])  # the bf16 kernel's y
    assert tref.scaled_err(rounded, want, *args, chunk=chunk) \
        <= KERNEL_TOL["bfloat16"]
    bad = FAULTS[fault](arrays, chunk)
    err = tref.scaled_err(bad, want, *args, chunk=chunk)
    assert err >= 10 * KERNEL_TOL["bfloat16"] > 10 * KERNEL_TOL["float32"]


# ---------------------------------------------------------------------------
# the CUDA kernel's two-pass algebra and its tensor-core roundings, in torch
# ---------------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero, 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, rounding):
    """a @ b in float32 as the kernel's tensor cores take it: operands
    rounded once to TF32 ("tf32", the bf16 kernel), split into hi = tf32(x)
    and lo = tf32(x - hi) and summed as lo·hi + hi·lo + hi·hi ("3xtf32",
    the float32 kernel), or whole (None)."""
    if rounding is None:
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    if rounding == "tf32":
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _two_pass(r, k, v, logw, u, state, chunk, rounding=None):
    """csrc/wkv6.cu's algorithm in float32 torch (model layout in, y float32
    out): a state pass sweeps the chunks and keeps S_in, the state entering
    each; an output pass then computes each chunk's y from its own rows and
    its S_in alone, sub-block by sub-block, with the kernel's factors (lx/lw
    the sums of logw inside a 16-row sub-block, T a sub-block's total):
    L = r e^lx, Kd = k e^-lw, Kt = k e^(T - lw), F[i] = e^(T[0] + .. +
    T[i-1]), G[i][a] = e^(T[a+1] + .. + T[i-1]); y = (L ⊙ F[i]) S_in + (L
    Kd^T, strictly causal, the bonus Σ_d r u k on its diagonal) V_i +
    Σ_{a<i} ((L ⊙ G[i][a]) Kt_a^T) V_a. Every product goes through `_mm`."""
    B, S, H, dh = r.shape
    C = tref.chunk_rows(S, chunk)
    nc, nu = -(-S // C), C // tref.SUB
    pad = nc * C - S
    rr, kk, vv, ww = (F.pad(t.float(), (0, 0, 0, 0, 0, pad))
                      .permute(0, 2, 1, 3).reshape(B, H, nc, C, dh)
                      for t in (r, k, v, logw))
    uf = u.float()[None, :, None, :]
    # the state pass
    s_c, s_in = state.float(), []
    for c in range(nc):
        s_in.append(s_c)
        w = ww[:, :, c]
        later = w.flip(-2).cumsum(-2).flip(-2) - w   # Σ logw over later rows
        kdec = kk[:, :, c] * torch.exp(later)
        s_c = torch.exp(w.sum(-2))[..., None] * s_c \
            + _mm(kdec.mT, vv[:, :, c], rounding)
    # the output pass
    strict = torch.ones(tref.SUB, tref.SUB, dtype=torch.bool).tril(-1)
    ys = []
    for c in range(nc):
        rb, kb, vb, w = (t[:, :, c].reshape(B, H, nu, tref.SUB, dh)
                         for t in (rr, kk, vv, ww))
        lw = w.cumsum(-2)
        lx = lw - w
        T = lw[..., -1, :]
        L = rb * torch.exp(lx)
        Kd = kb * torch.exp(-lw)
        Kt = kb * torch.exp(T[..., None, :] - lw)
        bonus = (rb * uf[:, :, None] * kb).sum(-1)
        for i in range(nu):
            f = torch.exp(T[:, :, :i].sum(2))[..., None, :]
            y = _mm(L[:, :, i] * f, s_in[c], rounding)
            A = _mm(L[:, :, i], Kd[:, :, i].mT, rounding)
            A = torch.where(strict, A, 0.0) + torch.diag_embed(bonus[:, :, i])
            y = y + _mm(A, vb[:, :, i], rounding)
            for a in range(i):
                g = torch.exp(T[:, :, a + 1:i].sum(2))[..., None, :]
                A = _mm(L[:, :, i] * g, Kt[:, :, a].mT, rounding)
                y = y + _mm(A, vb[:, :, a], rounding)
            ys.append((c, i, y))
    y = torch.empty(B, H, nc * C, dh)
    for c, i, yi in ys:
        y[:, :, c * C + i * tref.SUB:c * C + (i + 1) * tref.SUB] = yi
    return y.permute(0, 2, 1, 3)[:, :S], s_c


@pytest.mark.parametrize("S,H,dh,chunk", [
    (64, 2, 32, 32), (128, 3, 32, 64), (256, 2, 64, 64),
])
def test_two_pass_matches_reference_kernel(reference, rng, S, H, dh, chunk):
    """The two passes against the reference's interpreted wkv6_pallas and
    oracle (test_plain_matches_reference_kernel's shapes and limits), and
    against the port's wkv_chunked within a quarter of the float32 kernel
    limit, per entry over its envelope."""
    jnp, rops, rref = reference
    arrays = _inputs(rng, 2, S, H, dh)
    y_ref, s_ref = rref.wkv6(*_jax(jnp, arrays))
    y_pl, s_pl = rops.wkv6(*_jax(jnp, arrays), chunk=chunk, interpret=True)
    args = _port(arrays)
    y, s = _two_pass(*args, chunk)
    for yw, sw in ((y_pl, s_pl), (y_ref, s_ref)):
        scale = float(np.abs(np.asarray(y_ref)).max()) + 1e-6
        assert np.abs(_np(y) - np.asarray(yw)).max() / scale < 1e-4
        np.testing.assert_allclose(_np(s), np.asarray(sw), rtol=1e-4,
                                   atol=1e-4)
    chunked = tref.wkv_chunked(*args, chunk)
    assert tref.scaled_err((y, s), chunked, *args, chunk=chunk) \
        <= KERNEL_TOL["float32"] / 4


@pytest.mark.parametrize("B,S,H,dh,chunk,decay,state_scale", [
    (2, 100, 2, 32, 32, "test", 0.1),      # ragged S
    (2, 17, 2, 64, 128, "test", 0.1),      # S < C: one row past a chunk
    (1, 5, 2, 32, 128, "test", 0.1),       # one short, padded chunk
    (2, 256, 2, 32, 16, "test", 0.1),      # dh 32 with C 16
    (1, 192, 2, 64, 64, "test", 1.0),      # a large initial state
    (1, 64, 2, 32, 32, "extreme", 0.1),    # logw ≡ -5
])
def test_two_pass_matches_chunked_on_edges(reference, rng, B, S, H, dh,
                                           chunk, decay, state_scale):
    """Ragged and short S, dh 32 with C 16, a nonzero initial state and
    extreme decay: the two passes against the reference's wkv_chunked and
    oracle (the ragged tests' limits) and the port's wkv_chunked (a quarter
    of the float32 kernel limit over the envelope)."""
    from repro.models.rwkv6 import wkv_chunked as ref_chunked
    jnp, _, rref = reference
    arrays = _inputs(rng, B, S, H, dh, decay, state_scale)
    y_c, s_c = ref_chunked(*_jax(jnp, arrays), chunk)
    y_o, s_o = rref.wkv6(*_jax(jnp, arrays))
    args = _port(arrays)
    y, s = _two_pass(*args, chunk)
    assert y.shape == (B, S, H, dh) and torch.isfinite(y).all()
    for yw, sw in ((y_c, s_c), (y_o, s_o)):
        scale = float(np.abs(np.asarray(y_o)).max()) + 1e-6
        assert np.abs(_np(y) - np.asarray(yw)).max() / scale < 1e-4
        np.testing.assert_allclose(_np(s), np.asarray(sw), rtol=1e-4,
                                   atol=1e-4)
    chunked = tref.wkv_chunked(*args, chunk)
    assert tref.scaled_err((y, s), chunked, *args, chunk=chunk) \
        <= KERNEL_TOL["float32"] / 4


@pytest.mark.parametrize("rounding", ["tf32", "3xtf32"])
@pytest.mark.parametrize("decay", ["test", "extreme"])
@pytest.mark.parametrize("S", [512, 2048])
def test_two_pass_tensor_core_roundings_within_limits(rng, S, decay,
                                                      rounding):
    """The two passes with every product's operands rounded as the card's
    TF32 tensor cores take them, against the float64 scan, per entry over
    the envelope: one TF32 rounding (bf16 inputs, exact in TF32) within
    half the bf16 limit, and within all of it once y is stored in bf16;
    3xTF32 (float32 inputs) within a quarter of the float32 limit."""
    chunk = 128
    arrays = list(_inputs(rng, 1, S, 2, 64, decay))
    if rounding == "tf32":   # the bf16 kernel's inputs
        arrays[:3] = [np.asarray(torch.from_numpy(a).bfloat16().double())
                      for a in arrays[:3]]
    args = _port(arrays)
    want = _scan64(*arrays)
    got = _two_pass(*args, chunk, rounding)
    err = tref.scaled_err(got, want, *args, chunk=chunk)
    if rounding == "tf32":
        assert err <= KERNEL_TOL["bfloat16"] / 2, err
        stored = (got[0].bfloat16(), got[1])
        assert tref.scaled_err(stored, want, *args, chunk=chunk) \
            <= KERNEL_TOL["bfloat16"]
    else:
        assert err <= KERNEL_TOL["float32"] / 4, err


# ---------------------------------------------------------------------------
# the model pieces against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer_pair():
    """(reference cfg, one reference rwkv6 layer's params, the port's
    RWKV6 module holding the same values), reduced rwkv6-3b, float32."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.models.rwkv6 import rwkv6_init
    from repro_torch.configs import get_config
    rcfg, cfg = ref_config("rwkv6-3b").reduced(), \
        get_config("rwkv6-3b").reduced()
    # float32 draws whichever tests ran before in this process (a test
    # that imports `repro.core` turns jax's x64 mode on for the process)
    with jax.enable_x64(False):
        params = jax.tree_util.tree_map(
            np.asarray, rwkv6_init(jax.random.PRNGKey(3), rcfg))
    mod = trwkv.RWKV6(cfg, "cpu")
    mod.load_state_dict({
        (f"ln_x.{k2}" if k == "ln_x" else k):
            torch.from_numpy(np.array(v2, np.float32))
        for k, v in params.items()
        for k2, v2 in (v.items() if isinstance(v, dict) else [(None, v)])})
    return rcfg, params, cfg, mod


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_float32_leaves_stay_float32():
    from repro_torch.configs import get_config
    mod = trwkv.RWKV6(get_config("rwkv6-3b").reduced().with_(
        dtype="bfloat16"), "cpu")
    for name, p in mod.named_parameters():
        want = torch.float32 if name in ("w0", "u", "ln_x.scale",
                                         "ln_x.bias") else torch.bfloat16
        assert p.dtype == want, name


def test_ddlerp_and_group_norm_match_reference(layer_pair, rng):
    import jax.numpy as jnp
    from repro.models import rwkv6 as rrwkv
    rcfg, params, cfg, mod = layer_pair
    x, xp = (rng.normal(size=(2, 12, cfg.d_model)) for _ in range(2))
    want = rrwkv._ddlerp(params, jnp.asarray(x, jnp.float32),
                         jnp.asarray(xp, jnp.float32))
    got = trwkv._ddlerp(mod, torch.from_numpy(x).float(),
                        torch.from_numpy(xp).float())
    assert got.shape == (5, 2, 12, cfg.d_model)
    _close(got, want)
    y = rng.normal(size=(2, 12, cfg.d_model)) * 3 + 1
    H = cfg.d_model // cfg.rwkv_head_dim
    _close(trwkv._group_norm(mod, torch.from_numpy(y).float(), H),
           rrwkv._group_norm(params, jnp.asarray(y, jnp.float32), H))


@pytest.mark.parametrize("S", [1, 24, 40])
def test_time_and_channel_mix_match_reference(layer_pair, rng, S):
    import jax.numpy as jnp
    from repro.models import rwkv6 as rrwkv
    rcfg, params, cfg, mod = layer_pair
    B, dh = 2, cfg.rwkv_head_dim
    H = cfg.d_model // dh
    x = rng.normal(size=(B, S, cfg.d_model))
    prev = rng.normal(size=(B, 1, cfg.d_model))
    s0 = rng.normal(size=(B, H, dh, dh)) * 0.1
    decode = S == 1
    jx, jp, js = (jnp.asarray(a, jnp.float32) for a in (x, prev, s0))
    tx, tp, ts = (torch.from_numpy(a).float() for a in (x, prev, s0))
    want = rrwkv.time_mix(params, rcfg, jx, jp, js, decode=decode)
    got = trwkv.time_mix(mod, cfg, tx, tp, ts, decode=decode)
    for g, w in zip(got, want):
        _close(g, w)
    want = rrwkv.channel_mix(params, jx, jp)
    got = trwkv.channel_mix(mod, tx, tp)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dh,chunk,decay", [
    (2, 512, 8, 64, 128, "test"),     # rwkv6-3b heads
    (2, 1000, 4, 64, 128, "test"),    # ragged prompt
    (3, 17, 4, 32, 128, "test"),      # reduced heads, one short chunk
    (2, 256, 4, 32, 16, "test"),      # the reduced configs' chunk
    (1, 256, 2, 64, 64, "extreme"),
    (1, 2048, 2, 64, 128, "slow"),    # state carried over 16 chunks
    (2, 129, 4, 64, 128, "test"),     # a one-row last chunk
    (1, 16384, 4, 64, 128, "test"),   # one long prompt, 128 chunks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(cuda_device, rng, B, S, H, dh,
                                           chunk, decay, dtype):
    args = _port(_inputs(rng, B, S, H, dh, decay), dtype, cuda_device)
    before = tops.LAUNCHES["wkv6"]
    got = tops.wkv6(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["wkv6"] == before + 1
    assert got[0].dtype == args[0].dtype and got[1].dtype == torch.float32
    f32 = [a.float() for a in args]
    want = tref.wkv_chunked(*f32, chunk)
    assert all(torch.isfinite(t).all() for t in got)
    err = tref.scaled_err(got, want, *f32, chunk=chunk)
    assert err <= KERNEL_TOL[dtype], err
    again = tops.wkv6(*args, chunk=chunk)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def _envelope_err(got, want, args, chunk):
    """(max, mean) of |got - want| per entry over its envelope (as
    `ref.scaled_err`), over y's and the state's entries together."""
    env = tref.wkv_chunked(*(a.float().abs() for a in args[:3]),
                           args[3].float(),
                           *(a.float().abs() for a in args[4:]), chunk)
    e = torch.cat([((g.float().cpu() - w.float().cpu()).abs()
                    / n.cpu().clamp_min(1e-30)).flatten()
                   for g, w, n in zip(got, want, env)])
    return e.max().item(), e.mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dh,chunk,decay", [
    (1, 512, 2, 64, 128, "test"),
    (1, 512, 2, 64, 128, "extreme"),
    (2, 100, 2, 32, 32, "test"),      # ragged, dh 32
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_two_pass_emulation(cuda_device, rng, B, S, H,
                                                dh, chunk, decay, dtype):
    """Ties the emulation to the kernel: the kernel against `_two_pass`
    with its own roundings (bf16: one TF32 rounding, y stored in bf16;
    float32: 3xTF32) and with the other (bf16: none; float32: one TF32
    rounding) on the same inputs, per entry over the envelope. Its mean
    error lies ≥ 10× nearer its own rounding's emulation than the other's
    (the roundings' mean distance is ~4-9e-5); float32's largest error,
    where no bf16 store rounds y, stays within 2⁻¹⁶, float32 summation
    and exponent noise (a TF32 rounding moves entries by up to ~9e-4)."""
    args = _port(_inputs(rng, B, S, H, dh, decay), dtype, cuda_device)
    got = tops.wkv6(*args, chunk=chunk)
    cpu = [a.float().cpu() for a in args]
    own, other = {"float32": ("3xtf32", "tf32"),
                  "bfloat16": ("tf32", None)}[dtype]
    stored = (lambda t: t.bfloat16()) if dtype == "bfloat16" else \
        (lambda t: t)
    emu = [(stored(y), s) for y, s in (_two_pass(*cpu, chunk, own),
                                       _two_pass(*cpu, chunk, other))]
    near = _envelope_err(got, emu[0], cpu, chunk)
    far = _envelope_err(got, emu[1], cpu, chunk)
    print(f"wkv6 vs emulation {dtype} {B}x{S}x{H}x{dh} c{chunk} {decay}: "
          f"own max {near[0]:.3e} mean {near[1]:.3e}, other max "
          f"{far[0]:.3e} mean {far[1]:.3e}")
    assert near[1] * 10 <= far[1], (near, far)
    if dtype == "float32":
        assert near[0] <= 2.0 ** -16, (near, far)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device, rng):
    r, k, v, lw, u, s = _port(_inputs(rng, 1, 32, 2, 64), "float32",
                              cuda_device)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tops.wkv6_cuda(r.half(), k.half(), v.half(), lw, u, s)
    with pytest.raises(TypeError, match="logw must be float32"):
        tops.wkv6_cuda(r, k, v, lw.bfloat16(), u, s)
    with pytest.raises(ValueError, match="head dim 48"):
        tops.wkv6_cuda(r[..., :48], k[..., :48], v[..., :48], lw[..., :48],
                       u[:, :48], s[:, :, :48, :48].contiguous())
    with pytest.raises(ValueError, match="not a multiple of 16"):
        tops.wkv6_cuda(r, k, v, lw, u, s, chunk=24)
