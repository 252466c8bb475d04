"""The port's flash attention against the reference.

Same inputs (numpy, from a seed) through `repro.kernels.flash_attention`
— the Pallas kernel in interpret mode and the jnp oracle `ref.attention`
— and through `repro_torch.kernels.flash_attention.ops` on the CPU, where
it takes its plain torch version. Shapes and tolerances are those of
`tests/test_kernels.py::TestFlashAttention` (MHA, GQA 4:1, MQA; causal
and full; float32 rtol/atol 2e-4, bfloat16 2e-2). Ragged lengths, which
the Pallas kernel does not take (it asserts block-aligned S), are held
against the oracle only.

The CUDA kernel runs only on the card: the `cuda`-marked cases hold it
against the plain version computed in float32 from the same inputs, each
entry within `KERNEL_TOL[dtype]` of its envelope Σ p_j |v_j|
(`ref.scaled_err`). A bfloat16 kernel rounds p before the PV product and
its output, each by at most 2⁻⁸ of the envelope: 2⁻⁷, plus 2⁻¹⁶ for
float32's share, which is all a float32 kernel may differ by. The CPU
cases show the limit passes these roundings and fails planted faults: a
block of 64 or of 128 keys dropped from the last q rows, and a causal
mask off by one.
This module imports jax only inside the `reference` fixture.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
KERNEL_TOL = {"float32": 2.0 ** -16, "bfloat16": 2.0 ** -7 + 2.0 ** -16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import ops, ref
    return jnp, ops, ref


def _qkv(rng, B, Sq, Sk, Hq, Hkv, hd):
    return (rng.normal(size=(B, Sq, Hq, hd)), rng.normal(size=(B, Sk, Hkv, hd)),
            rng.normal(size=(B, Sk, Hkv, hd)))


def _port(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=TORCH_DTYPE[dtype])
            for a in arrays]


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("S,Hq,Hkv,hd,bq,bk", [
    (128, 4, 4, 32, 64, 64),     # MHA
    (256, 8, 2, 64, 64, 64),     # GQA 4:1
    (256, 4, 1, 64, 128, 64),    # MQA
    (192, 2, 2, 32, 64, 64),     # several q blocks per kv block row
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(reference, rng, S, Hq, Hkv, hd, bq,
                                        bk, causal, dtype):
    jnp, fops, fref = reference
    arrays = _qkv(rng, 2, S, S, Hq, Hkv, hd)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    kernel = fops.flash_attention(jq, jk, jv, causal=causal, interpret=True,
                                  bq=bq, bk=bk)
    oracle = fref.attention(jq, jk, jv, causal=causal)
    got = tops.flash_attention(*_port(arrays, dtype), causal=causal)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (2, S, Hq, hd)
    for want in (kernel, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **TOL[dtype])


@pytest.mark.parametrize("Sq,Sk,causal", [(17, 17, True), (100, 100, True),
                                          (1, 1, True), (17, 40, False),
                                          (100, 7, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_lengths_match_reference_oracle(reference, rng, Sq, Sk, causal,
                                               dtype):
    jnp, _, fref = reference
    arrays = _qkv(rng, 2, Sq, Sk, 8, 2, 64)
    want = fref.attention(*(jnp.asarray(a, getattr(jnp, dtype))
                            for a in arrays), causal=causal)
    got = tops.flash_attention(*_port(arrays, dtype), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])


def test_cpu_tensors_take_the_plain_version(rng):
    q, k, v = _port(_qkv(rng, 1, 9, 9, 4, 2, 32), "float32")
    before = dict(tops.LAUNCHES)
    assert torch.equal(tops.flash_attention(q, k, v),
                       tref.attention(q, k, v))
    assert tops.LAUNCHES == before
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tops.flash_attention_cuda(q, k, v)


def _attention_f32(q, k, v, mask, p_dtype=torch.float32):
    """softmax(QKᵀ/√hd under `mask`) V with scores, p and their sum in
    float32; p rounded to `p_dtype` for the PV product only, as the
    kernel does."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, S, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    s = torch.where(mask, s, tref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(p_dtype).float(), v.float())
    o = o / p.sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, hd)


def _late_block_dropped(pos, S, n=64):
    lost = ((pos[:, None] >= S - n) & (pos[None, :] >= S // 2)
            & (pos[None, :] < S // 2 + n))
    return (pos[:, None] >= pos[None, :]) & ~lost


FAULTS = {
    # the last 64 q rows miss one block of 64 keys
    "late_block_dropped": _late_block_dropped,
    # the last q tile of 128 rows misses one block of 128 keys
    "late_block128_dropped": lambda pos, S: _late_block_dropped(pos, S, 128),
    # each query also sees the next key
    "mask_shifted": lambda pos, S: pos[:, None] + 1 >= pos[None, :],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_tolerance_passes_roundings_and_fails_faults(rng, fault,
                                                            dtype):
    # the serving path's row count and head dim, one kv head of two
    S = 2048
    q, k, v = _port(_qkv(rng, 1, S, S, 2, 1, 128), dtype)
    pos = torch.arange(S)
    causal = pos[:, None] >= pos[None, :]
    want = tref.attention(q.float(), k.float(), v.float())
    if dtype == "bfloat16":
        # the kernel's own roundings: p to bf16 before PV, output to bf16
        sound = _attention_f32(q, k, v, causal, torch.bfloat16).to(q.dtype)
    else:
        # another summation order: blocks of 64 under an online softmax
        from repro_torch.models.attention import chunked_attention
        sound = chunked_attention(q, k, v, q_chunk=64, k_chunk=64)
    assert tref.scaled_err(sound, want, q, k, v) <= KERNEL_TOL[dtype]
    bad = _attention_f32(q, k, v, FAULTS[fault](pos, S)).to(q.dtype)
    assert tref.scaled_err(bad, want, q, k, v) > 2 * KERNEL_TOL[dtype]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal", [
    (2, 512, 512, 16, 8, 128, True),    # qwen3-0.6b heads
    (2, 512, 512, 32, 8, 64, True),     # llama3.2-1b heads
    (2, 1000, 1000, 16, 8, 128, True),  # ragged prompt
    (3, 17, 17, 4, 2, 32, True),
    (2, 300, 1024, 16, 8, 128, False),  # cross-attention shape
    (2, 512, 512, 32, 8, 128, True),    # jamba-v0.1-52b heads
    (2, 200, 200, 4, 2, 32, True),      # hd 32, Sq not a multiple of 128
    (2, 129, 129, 4, 2, 128, True),     # one row past a q tile
    (2, 64, 100, 4, 2, 64, False),      # one full kv tile and a ragged one
    (2, 64, 40, 4, 2, 128, False),      # fewer keys than one kv tile
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(cuda_device, rng, B, Sq, Sk, Hq,
                                           Hkv, hd, causal, dtype):
    q, k, v = _port(_qkv(rng, B, Sq, Sk, Hq, Hkv, hd), dtype, cuda_device)
    before = tops.LAUNCHES["flash"]
    got = tops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["flash"] == before + 1
    want = tref.attention(q.float(), k.float(), v.float(), causal=causal)
    err = tref.scaled_err(got, want, q, k, v, causal=causal)
    assert err <= KERNEL_TOL[dtype], err
    assert torch.equal(got, tops.flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 8, 2, 64, dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tops.flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 8, 2, 48, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        tops.flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="causal needs Sq == Sk"):
        tops.flash_attention_cuda(q, q[:, :4], q[:, :4])
