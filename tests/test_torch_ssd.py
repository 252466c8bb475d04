"""The port's Mamba selective scan against the reference.

Same inputs (numpy, from a seed) through `repro.kernels.ssd` — the Pallas
kernel in interpret mode and the jnp oracle `ref.ssm_scan` — and through
`repro_torch.kernels.ssd.ops.ssm_scan` on the CPU, where it takes the
plain `ref.ssm_scan`. Shapes and tolerance are those of
`tests/test_kernels.py::TestSsdKernel` (rtol/atol 1e-4). A ragged S and
a nonzero h0, which that test does not cover, are held against the
reference's oracle; the model's chunked route (`selective_scan`) against
the reference's, and at a ragged S, which the reference's asserts away,
against the oracle.

The CUDA kernel runs only on the card: the `cuda`-marked cases hold it
against the plain version computed in float32 from the same inputs, each
y and h entry within `KERNEL_TOL` of its envelope (the same scan on |x|,
|B|, |C|, |D|, |h0|; `ref.scaled_err`). Both sides read the same inputs
(bf16 x, B, C convert exactly) and write float32, so they differ in
summation order, in the FMA contractions and in expf's last bit only; a
float32 scan reads ≤ 5e-6 of its envelope against a float64 one here
(S 2,048 with a slow decay), about a twelfth of 2⁻¹⁴. The CPU cases show
the limit passes that float32 scan and fails a dropped D skip, a state
reset midway and a decay one step late, each by ≥ 10× (the late decay
at a slow dt reads 14×, the others ≥ 1,000×). This module
imports jax only inside the `reference` fixture.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import ops as tops
from repro_torch.kernels.ssd import ref as tref
from _torch_threads import one_thread  # noqa: F401

KERNEL_TOL = 2.0 ** -14
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd import ops, ref
    return jnp, ops, ref


def _inputs(rng, B, S, di, ds, dt_scale=0.2, h0_scale=0.0):
    """x, dt (B, S, di), A (di, ds), B, C (B, S, ds), D (di,), h0 (B, di,
    ds) as float64 numpy, as in tests/test_kernels.py (dt uniform in
    [0, dt_scale), A = -exp(0.3 N)), with h0 = h0_scale · N."""
    x = rng.normal(size=(B, S, di))
    dt = rng.random(size=(B, S, di)) * dt_scale
    A = -np.exp(rng.normal(size=(di, ds)) * 0.3)
    Bv = rng.normal(size=(B, S, ds))
    Cv = rng.normal(size=(B, S, ds))
    D = np.ones((di,))
    h0 = rng.normal(size=(B, di, ds)) * h0_scale
    return x, dt, A, Bv, Cv, D, h0


def _port(arrays, dtype="float32", device="cpu"):
    """The port's tensors: x, B, C in `dtype`, the rest float32."""
    x, dt, A, Bv, Cv, D, h0 = (torch.from_numpy(np.asarray(a)).to(device)
                               for a in arrays)
    dt_, f32 = TORCH_DTYPE[dtype], torch.float32
    return (x.to(dt_), dt.to(f32), A.to(f32), Bv.to(dt_), Cv.to(dt_),
            D.to(f32), h0.to(f32))


def _jax(jnp, arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _np(t):
    return t.float().cpu().numpy()


def _close(got, want, tol=1e-4):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,di,ds,bd,tc", [
    (64, 64, 8, 32, 16), (128, 32, 16, 32, 64), (96, 64, 4, 64, 32),
])
def test_plain_matches_reference_kernel(reference, rng, S, di, ds, bd, tc):
    jnp, rops, rref = reference
    arrays = _inputs(rng, 2, S, di, ds)
    want = rref.ssm_scan(*_jax(jnp, arrays))
    pallas = rops.ssm_scan(*_jax(jnp, arrays), interpret=True, bd=bd, tc=tc)
    got = tops.ssm_scan(*_port(arrays))
    assert got[0].dtype == got[1].dtype == torch.float32
    assert got[0].shape == (2, S, di) and got[1].shape == (2, di, ds)
    _close(got, pallas)
    _close(got, want)


@pytest.mark.parametrize("S,h0_scale", [(300, 0.0), (17, 0.5), (1, 0.5),
                                        (128, 1.0)])
def test_ragged_lengths_and_initial_state_match_reference(reference, rng, S,
                                                          h0_scale):
    jnp, _, rref = reference
    arrays = _inputs(rng, 2, S, 48, 16, h0_scale=h0_scale)
    _close(tops.ssm_scan(*_port(arrays)), rref.ssm_scan(*_jax(jnp, arrays)))


def test_chunked_route_matches_reference(reference, rng):
    from repro.models.mamba import selective_scan as ref_selective
    jnp, _, rref = reference
    arrays = _inputs(rng, 2, 128, 16, 8, h0_scale=0.5)
    want = ref_selective(*_jax(jnp, arrays), chunk=32)
    _close(tref.selective_scan(*_port(arrays), chunk=32), want)
    # a ragged last chunk, which the reference asserts away: the oracle
    arrays = _inputs(rng, 2, 100, 16, 8, h0_scale=0.5)
    _close(tref.selective_scan(*_port(arrays), chunk=32),
           rref.ssm_scan(*_jax(jnp, arrays)))


def test_strided_views_match_contiguous_copies(rng):
    # B and C as the model cuts them: column views of one (B, S, r + 2 ds)
    x, dt, A, _, _, D, h0 = _port(_inputs(rng, 2, 40, 32, 8, h0_scale=0.5))
    dbc = torch.randn(2, 40, 4 + 16, generator=torch.Generator()
                      .manual_seed(0))
    _, Bv, Cv = torch.split(dbc, [4, 8, 8], dim=-1)
    got = tops.ssm_scan(x, dt, A, Bv, Cv, D, h0)
    want = tref.ssm_scan(x, dt, A, Bv.contiguous(), Cv.contiguous(), D, h0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_tensors_take_the_plain_version(rng):
    args = _port(_inputs(rng, 1, 20, 16, 8))
    before = dict(tops.LAUNCHES)
    y, h = tops.ssm_scan(*args)
    want = tref.ssm_scan(*args)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    assert tops.LAUNCHES == before
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tops.ssm_scan_cuda(*args)


# ---------------------------------------------------------------------------
# the kernel's tolerance: passes roundings, fails planted faults
# ---------------------------------------------------------------------------

def _scan64(*arrays):
    return tref.ssm_scan(*(torch.as_tensor(a, dtype=torch.float64)
                           for a in arrays), dtype=torch.float64)


def _skip_dropped(arrays):
    x, dt, A, Bv, Cv, D, h0 = arrays
    return _scan64(x, dt, A, Bv, Cv, np.zeros_like(D), h0)


def _state_reset_midway(arrays):
    """The state is not carried past position S/2: the second half
    starts from zero."""
    x, dt, A, Bv, Cv, D, h0 = arrays
    m = x.shape[1] // 2
    y0, _ = _scan64(x[:, :m], dt[:, :m], A, Bv[:, :m], Cv[:, :m], D, h0)
    y1, h = _scan64(x[:, m:], dt[:, m:], A, Bv[:, m:], Cv[:, m:], D,
                    np.zeros_like(h0))
    return torch.cat([y0, y1], dim=1), h


def _decay_one_step_late(arrays):
    """Each step decays the state with the previous step's dt (the first
    with its own)."""
    x, dt, A, Bv, Cv, D, h0 = (torch.as_tensor(a, dtype=torch.float64)
                               for a in arrays)
    late = torch.cat([dt[:, :1], dt[:, :-1]], dim=1)
    h, ys = h0, []
    for t in range(x.shape[1]):
        h = torch.exp(late[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bv[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cv[:, t]))
    return torch.stack(ys, dim=1) + x * D, h


FAULTS = {
    "skip_dropped": _skip_dropped,
    "state_reset_midway": _state_reset_midway,
    "decay_one_step_late": _decay_one_step_late,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("dt_scale,S", [(0.2, 256), (1e-3, 2048)])
def test_kernel_tolerance_passes_roundings_and_fails_faults(rng, fault,
                                                             dt_scale, S):
    arrays = _inputs(rng, 1, S, 32, 16, dt_scale=dt_scale, h0_scale=0.5)
    args = _port(arrays)
    want = _scan64(*arrays)
    sound = tref.ssm_scan(*args)  # float32, the kernel's arithmetic
    assert tref.scaled_err(sound, want, *args) <= KERNEL_TOL / 4
    bad = FAULTS[fault](arrays)
    assert tref.scaled_err(bad, want, *args) >= 10 * KERNEL_TOL


# ---------------------------------------------------------------------------
# the kernel's exp: 2^z = 2^(z + 1) / 2 on the MUFU
# ---------------------------------------------------------------------------

def test_kernel_exp_within_its_error():
    """The kernel's dA (ref.kernel_decay, the MUFU taken exact) against
    exp(dt · A) in float64, over z = dt · A log2 e in [-130, 0]: within
    2^-24 (2 + 1.4 |z|) relative where the result is normal (A' = A log2 e
    and z + 1 each rounded to float32, then 2^w), exactly 0 for z < -127,
    and unbiased near 0, where a decay's rounding is carried over every
    step its term survives."""
    A = torch.tensor([[-1.0], [-0.37]])
    span = torch.cat([torch.linspace(0.0, 130.0, 100_001, dtype=torch.float64),
                      torch.logspace(-7, 0, 100_001, dtype=torch.float64)])
    for a in A[:, 0].tolist():
        dt = (span / (-a * tref.LOG2E)).float()
        got = tref.kernel_decay(dt[None], torch.tensor([[a]]))[0, :, 0]
        z = dt.double() * a * tref.LOG2E
        want = torch.exp(dt.double() * a)
        normal = want >= 2.0 ** -125
        rel = ((got.double() - want) / want)[normal]
        assert (rel.abs() <= 2.0 ** -24 * (2 + 1.4 * z.abs()[normal])).all()
        assert torch.all(got[z < -127.01] == 0)
        # dt spread evenly over z in (-1e-2, 0), as a step's dt spreads
        dt = (torch.linspace(1e-2, 0.0, 100_001, dtype=torch.float64)[:-1]
              / (-a * tref.LOG2E)).float()
        got = tref.kernel_decay(dt[None], torch.tensor([[a]]))[0, :, 0]
        want = torch.exp(dt.double() * a)
        assert abs(((got.double() - want) / want).mean().item()) \
            <= 2.0 ** -30
    assert tref.kernel_decay(torch.tensor([[200.0]]), A[:1]).item() == 0.0


@pytest.mark.parametrize("S", [2048, 8192])
def test_kernel_exp_scan_at_tiny_dt_matches_reference(reference, rng, S):
    """A scan with the kernel's exp at tiny dt (~1e-4: every decay within
    1e-3 of 1, the state carried over every step) within KERNEL_TOL of
    the reference's oracle, at a prompt of 2,048 and one of 8,192."""
    jnp, _, rref = reference
    arrays = _inputs(rng, 1, S, 16, 16, dt_scale=2e-4, h0_scale=0.5)
    args = _port(arrays)
    got = tref.ssm_scan(*args, decay=tref.kernel_decay)
    want = [torch.from_numpy(np.array(w))
            for w in rref.ssm_scan(*_jax(jnp, arrays))]
    assert tref.scaled_err(got, want, *args) <= KERNEL_TOL


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,ds,dt_scale,h0_scale", [
    (2, 2048, 512, 16, 0.2, 0.0),     # jamba's d_state
    (2, 1000, 320, 16, 0.2, 0.5),     # ragged S and di, an initial state
    (3, 17, 256, 8, 0.2, 0.0),        # the reduced config's d_state
    (2, 96, 64, 4, 0.2, 0.0),
    (1, 512, 128, 16, 50.0, 0.5),     # dA underflows to 0
    (1, 2048, 128, 16, 1e-4, 0.5),    # slow decay: the state carries on
    (1, 16384, 256, 16, 1e-4, 0.5),   # ... over a long prompt: the exp's
])                                    # error is carried over every step
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(cuda_device, rng, B, S, di, ds,
                                           dt_scale, h0_scale, dtype):
    args = _port(_inputs(rng, B, S, di, ds, dt_scale, h0_scale), dtype,
                 cuda_device)
    before = tops.LAUNCHES["ssm_scan"]
    got = tops.ssm_scan(*args)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["ssm_scan"] == before + 1
    assert got[0].dtype == got[1].dtype == torch.float32
    want = tref.ssm_scan(*args)
    assert all(torch.isfinite(t).all() for t in got)
    err = tref.scaled_err(got, want, *args)
    assert err <= KERNEL_TOL, err
    again = tops.ssm_scan(*args)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_takes_unaligned_views(cuda_device, rng, dtype):
    """x and dt as views at an odd offset: the kernel's element copies."""
    x, dt, A, Bv, Cv, D, h0 = _port(_inputs(rng, 2, 300, 129, 16,
                                            h0_scale=0.5), dtype, cuda_device)
    x, dt = x[..., 1:], dt[..., 1:]
    A, D, h0 = A[1:], D[1:], h0[:, 1:]
    args = (x, dt, A, Bv, Cv, D, h0)
    got = tops.ssm_scan(*args)
    want = tref.ssm_scan(*args)
    assert tref.scaled_err(got, want, *args) <= KERNEL_TOL
    again = tops.ssm_scan(*args)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device, rng):
    x, dt, A, Bv, Cv, D, h0 = _port(_inputs(rng, 1, 32, 64, 16), "float32",
                                    cuda_device)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tops.ssm_scan_cuda(x.half(), dt, A, Bv.half(), Cv.half(), D, h0)
    with pytest.raises(TypeError, match="dt must be float32"):
        tops.ssm_scan_cuda(x, dt.bfloat16(), A, Bv, Cv, D, h0)
    with pytest.raises(ValueError, match="d_state 12"):
        tops.ssm_scan_cuda(x, dt, A[:, :12], Bv[..., :12], Cv[..., :12], D,
                           h0[..., :12])
    with pytest.raises(ValueError, match="last dim must be contiguous"):
        tops.ssm_scan_cuda(x.mT.contiguous().mT, dt, A, Bv, Cv, D, h0)
