"""The port's cost counter against the reference's on the same programs.

`repro_torch.launch.hlocost` counts the ATen ops a call dispatches where
`repro.launch.hlocost` walks XLA's compiled HLO (`tests/test_hlocost.py`):
the reference's scans are Python loops here, and its FLOPs must agree
within 5 %. Also held here: the windowed cap of
`tests/test_restart.py::TestHlocostWindowedCap`, the ring model and the
product rule (exact), the pure arithmetic of `launch.roofline` and
`launch.kernel_model` (bitwise the reference's for every assigned arch ×
shape × device count), each hand kernel's charge against the count
`chip_smoke.py` reckoned its bound from before it read them from
`kernel_model` (and `chip_smoke`'s bound helpers against those counts),
each kernel's meta implementation against its plain version's output
shape, and a count on "meta" against one of the kernel route with the
kernels' launches stood in for on the CPU (each plain version run
unseen, its kernel's work charged), as the card runs it.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro.launch import hlocost as ref_hlocost
from repro.launch import roofline as ref_roofline
from repro.launch.shapes import SHAPES as REF_SHAPES

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.gram import ops as gops
from repro_torch.kernels.gram import ref as gref
from repro_torch.kernels.rwkv6 import ops as wops
from repro_torch.kernels.rwkv6.ref import wkv_chunked
from repro_torch.kernels.spmm import ops as sp_ops
from repro_torch.kernels.spmm import ref as sp_ref
from repro_torch.kernels.ssd import ops as sops
from repro_torch.kernels.ssd.ref import ssm_scan
from repro_torch.launch import hlocost, kernel_model, roofline
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import build_model
from _torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

# the reference's kernel_model forces 512 host devices at import unless
# XLA_FLAGS names a count: keep the flag out of this process's jax
_flags = os.environ.get("XLA_FLAGS")
try:
    from repro.launch import kernel_model as ref_km  # noqa: E402
finally:
    if _flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = _flags


def _ref_analyze(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return ref_hlocost.analyze(jax.jit(fn).lower(*args).compile().as_text())


def _x(*shape):
    return torch.from_numpy(
        np.random.default_rng(0).normal(size=shape).astype(np.float32))


# ---------------------------------------------------------------------------
# TestTripCounts / TestBytes / TestHlocostWindowedCap / TestCollectives
# ---------------------------------------------------------------------------

def _scan(body, n):
    def f(c):
        y, _ = jax.lax.scan(lambda c, _: (body(c), None), c, None, length=n)
        return y
    return f


def _nested(c):
    def outer(c, _):
        y, _ = jax.lax.scan(lambda d, __: (d @ d, None), c, None, length=3)
        return y, None
    y, _ = jax.lax.scan(outer, c, None, length=5)
    return y


def _loop(body, n):
    def f(c):
        for _ in range(n):
            c = body(c)
        return c
    return f


TRIPS = {
    "single": (lambda x: x @ x, lambda x: x @ x),
    "unrolled": (_loop(lambda x: x @ x, 4), _loop(lambda x: x @ x, 4)),
    "scan": (_scan(lambda c: c @ c, 7), _loop(lambda c: c @ c, 7)),
    "nested_scan": (_nested, _loop(lambda c: c @ c, 15)),
    "scan_tanh": (_scan(lambda c: jnp.tanh(c @ c), 4),
                  _loop(lambda c: torch.tanh(c @ c), 4)),
}


@pytest.mark.parametrize("case", sorted(TRIPS))
def test_trip_counts_match_reference(case):
    """TestTripCounts: the port's FLOPs of the reference's programs, its
    scans written as Python loops, within 5 % of the reference's
    `analyze` (which multiplies while bodies by their trip counts)."""
    ref_fn, port_fn = TRIPS[case]
    want = _ref_analyze(ref_fn, (128, 128))
    got = hlocost.count(port_fn, _x(128, 128))
    assert abs(got.flops - want.flops) / want.flops < 0.05, \
        (got.flops, want.flops)
    assert got.unknown_trip_counts == 0 == want.unknown_trip_counts
    assert got.product_flops == got.by_op["mm.default"][1]


def test_bytes_scale_with_tensor_size():
    """TestBytes: ~16x the elements, 10x-22x the bytes, as the
    reference's."""
    def f(x):
        return torch.tanh(x) + 1.0
    small = hlocost.count(f, _x(128, 128))
    big = hlocost.count(f, _x(512, 512))
    assert 10 < big.bytes / small.bytes < 22
    ref_small = _ref_analyze(lambda x: jnp.tanh(x) + 1.0, (128, 128))
    ref_big = _ref_analyze(lambda x: jnp.tanh(x) + 1.0, (512, 512))
    assert 10 < ref_big.bytes / ref_small.bytes < 22


def test_scan_accumulator_not_charged_per_step():
    """TestHlocostWindowedCap: 64 steps writing each step's value into a
    preallocated (64, 256, 256) float32 buffer are charged the written
    windows, under 8x the buffer (naive accounting: >= 64x)."""
    def f(x):
        ys = torch.empty((64,) + tuple(x.shape))
        c = x
        for i in range(64):
            c = torch.tanh(c)
            ys[i] = c
        return ys
    t = hlocost.count(f, _x(256, 256))
    full_ys = 64 * 256 * 256 * 4
    assert t.bytes < 8 * full_ys, t.bytes
    assert t.by_op["copy_.default"] == [64, 0.0, 64 * 2 * 256 * 256 * 4]


class _Mesh:  # the product rule reads only the axis sizes
    shape = {"d": 8}


def test_allreduce_bytes_by_the_product_rule():
    """TestCollectives: x (1024, 512) split on its contraction over 8
    devices times w (512, 256) split on its rows, the output unsplit: an
    all-reduce of the (1024, 256) float32 output, 1,048,576 raw bytes and
    2·7/8 of them on the wire, exactly."""
    with hlocost.CostTotals() as t:
        done = hlocost.product_collective((None, "d"), ("d", None),
                                          (None, None), _Mesh(), (1024, 256),
                                          torch.float32)
    payload = 1024 * 256 * 4
    assert done == [("all-reduce", payload, 8)]
    assert t.collective_raw_bytes == payload == 1_048_576
    assert t.collective_wire_bytes == 2 * 7 / 8 * payload
    assert dict(t.per_collective) == {"all-reduce": 2 * 7 / 8 * payload}
    assert dict(t.by_group_size) == {8: 2 * 7 / 8 * payload}


def test_product_rule_scatter_and_no_collective():
    """A split contraction whose axis also splits the output is a
    reduce-scatter; an unsplit contraction needs no collective."""
    with hlocost.CostTotals() as t:
        assert hlocost.product_collective(
            (None, None), (None, "d"), (None, "d"), _Mesh(), (64, 64),
            torch.float32) == []
        done = hlocost.product_collective(
            (None, "d"), ("d", None), ("d", None), _Mesh(), (64, 64),
            torch.float32)
    assert done == [("reduce-scatter", 64 * 64 * 4 / 8, 8)]
    assert t.collective_wire_bytes == 7 / 8 * 64 * 64 * 4 / 8


_HLO = """HloModule m

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

ENTRY %main (p: f32[1024,256]) -> f32[1024,256] {
  %p = f32[1024,256]{1,0} parameter(0)
  ROOT %c = f32[1024,256]{1,0} OP(f32[1024,256]{1,0} %p), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
}
"""


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_ring_model_matches_reference(kind):
    """`collective` against the reference's analyzer on a one-collective
    HLO module over a group of 8: the same raw and wire bytes."""
    want = ref_hlocost.analyze(_HLO.replace("OP", kind), 8)
    with hlocost.CostTotals() as t:
        wire = hlocost.collective(kind, 1024 * 256 * 4, 8)
    assert t.collective_raw_bytes == want.collective_raw_bytes
    assert wire == t.collective_wire_bytes == want.collective_wire_bytes
    assert dict(t.per_collective) == dict(want.per_collective)
    assert dict(t.by_group_size) == dict(want.by_group_size)


def test_counter_holds_no_tensor():
    """Counting keeps nothing alive: the storages made inside are freed as
    the call drops them, and the peak is the most alive at once."""
    def f(x):
        for _ in range(10):
            x = torch.tanh(x)
        return x.sum()
    with hlocost.CostTotals() as t:
        f(_x(256, 256))
    assert t.live_bytes == 0
    assert t.peak_bytes == 2 * 256 * 256 * 4


def test_host_transfers_are_not_charged():
    x = _x(64, 64)
    t = hlocost.count(lambda: x.to("meta"))
    assert (t.flops, t.bytes) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# roofline and kernel_model: the reference's pure arithmetic, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_and_kernel_io_match_reference(arch):
    """`model_flops_per_device`, `wkv6_kernel_io_bytes` and
    `ssd_kernel_io_bytes` bitwise the reference's for every shape and
    n_devices in {1, 8, 256}."""
    from repro.configs import get_config as ref_config
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert set(SHAPES) == set(REF_SHAPES)
    for name, info in SHAPES.items():
        for n in (1, 8, 256):
            got = roofline.model_flops_per_device(
                cfg, info["kind"], info["batch"], info["seq_len"], n)
            want = ref_roofline.model_flops_per_device(
                rcfg, info["kind"], info["batch"], info["seq_len"], n)
            assert got == want, (name, n)
            b = max(info["batch"] // n, 1)
            if cfg.ssm_type == "rwkv6":
                assert kernel_model.wkv6_kernel_io_bytes(
                    cfg, b, info["seq_len"]) == ref_km.wkv6_kernel_io_bytes(
                    rcfg, b, info["seq_len"])
            if any(k.startswith("mamba") for k in cfg.layer_kinds()):
                assert kernel_model.ssd_kernel_io_bytes(
                    cfg, b, info["seq_len"]) == ref_km.ssd_kernel_io_bytes(
                    rcfg, b, info["seq_len"])


def test_roofline_cell_terms():
    """The roofline at NVIDIA H100 80GB HBM3's published peaks (700 W):
    t_compute at the cell's dtype, HBM 3.35 TB/s, NVLink 450 GB/s."""
    cell = roofline.RooflineCell(arch="a", shape="s", mesh="1", n_devices=1,
                                 kind="train", hlo_flops=989e12,
                                 hlo_bytes=3.35e12, coll_wire_bytes=450e9,
                                 model_flops=494.5e12)
    assert (cell.t_compute, cell.t_memory, cell.t_collective) == (1, 1, 1)
    assert cell.roofline_fraction == 0.5
    cell.dtype = "float32"
    assert cell.t_compute == 989e12 / 67e12
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3")[1]["bw"] == 3.35e12
    assert roofline.peaks_for("H100 PCIe")[0] == "NVIDIA H100 PCIe"
    with pytest.raises(RuntimeError):
        roofline.peaks_for("NVIDIA A100")
    assert roofline.format_table([cell]).splitlines()[0].split()[0] == "arch"


def test_save_and_load_cells(tmp_path):
    cell = roofline.RooflineCell(arch="a", shape="s", mesh="2x4",
                                 n_devices=8, kind="prefill", hlo_flops=1.0)
    path = str(tmp_path / "cells.json")
    roofline.save_cells([cell], path)
    loaded = roofline.load_cells(path)
    assert loaded[0]["hlo_flops"] == 1.0
    assert loaded[0]["bottleneck"] == cell.bottleneck


# ---------------------------------------------------------------------------
# each hand kernel's charge: the counts chip_smoke reckoned its bounds from
# ---------------------------------------------------------------------------

_SZ = {"float64": 8, "float32": 4, "bfloat16": 2}


def _old_gram(m, n, dtype):
    size, out = _SZ[dtype], 8 if dtype == "float64" else 4
    return m * n * (n + 1), m * n * size + n * n * out


def _old_xtv(m, n, c, dtype):
    size, out = _SZ[dtype], 8 if dtype == "float64" else 4
    return 2 * m * n * c, (m * n + m * c) * size + n * c * out


def _old_batched(kind, k, m, n, c, dtype, v_batched, x_batched):
    size, out = _SZ[dtype], 8 if dtype == "float64" else 4
    if kind == "gram":
        return k * m * n * (n + 1), k * (m * n * size + n * n * out)
    return 2 * k * m * n * c, ((k if x_batched else 1) * m * n * size
                               + (k if v_batched else 1) * m * c * size
                               + k * n * c * out)


def _old_sparse(kind, mask, m, n, c, dtype):
    size, out = _SZ[dtype], 8 if dtype == "float64" else 4
    pop = mask.numpy() > 0
    rows = np.minimum(sp_ops.ROWS, m - sp_ops.ROWS * np.arange(pop.shape[0]))
    width = np.minimum(sp_ops.TILE, n - sp_ops.TILE * np.arange(pop.shape[1]))
    cols = (pop * width).sum(axis=1)
    x_bytes = float((rows * cols).sum()) * size
    if kind == "gram_bs":
        return float((rows * cols * (cols + 1)).sum()), x_bytes + n * n * out
    ops = 2.0 * float((rows * cols).sum()) * c
    if kind == "xtv_bs":
        return ops, (x_bytes + float(rows[pop.any(axis=1)].sum()) * c * size
                     + n * c * out)
    used = float(width[pop.any(axis=0)].sum())
    return ops, x_bytes + used * c * size + m * c * out


def _old_flash(B, Sq, Sk, Hq, Hkv, hd, dv, causal, dtype):
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    return 2.0 * (hd + dv) * pairs * B * Hq, \
        (B * Sq * Hq * (hd + dv) + B * Sk * Hkv * (hd + dv)) * _SZ[dtype]


def _old_wkv6(B, S, H, dh, dtype):
    size = _SZ[dtype]
    return 5.0 * dh * dh * B * S * H, \
        (4 * size + 4) * B * S * H * dh + 4 * H * dh + 2 * 4 * B * H * dh * dh


def _old_ssm(B, S, di, ds, dtype):
    size = _SZ[dtype]
    return 7.0 * B * S * di * ds + 3.0 * B * S * di, \
        (size + 8) * B * S * di + 2 * size * B * S * ds \
        + 4 * (di * ds + di) + 2 * 4 * B * di * ds


def _mask(m, n, seed=0):
    rng = np.random.default_rng(seed)
    kr, kc = -(-m // sp_ops.ROWS), -(-n // sp_ops.TILE)
    return torch.from_numpy((rng.random((kr, kc)) < 0.3).astype(np.int32))


MASK = _mask(1000, 300)
CHARGES = {
    "gram": (kernel_model.gram_work, (100_000, 1000, "float64"), _old_gram),
    "xtv": (kernel_model.xtv_work, (100_000, 1000, 3, "float32"), _old_xtv),
    "gram_batched": (lambda *a: kernel_model.gram_batched_work(*a),
                     (8, 87_500, 1000, "float64"),
                     lambda k, m, n, d: _old_batched("gram", k, m, n, 0, d,
                                                     True, True)),
    "xtv_batched": (kernel_model.xtv_batched_work,
                    (8, 12_500, 1000, 1, "bfloat16", False, True),
                    lambda *a: _old_batched("xtv", *a)),
    "gram_bs": (kernel_model.gram_bs_work, (MASK, 1000, 300, "float64"),
                lambda mask, m, n, d: _old_sparse("gram_bs", mask, m, n, 1,
                                                  d)),
    "xtv_bs": (kernel_model.xtv_bs_work, (MASK, 1000, 300, 2, "float64"),
               lambda *a: _old_sparse("xtv_bs", *a)),
    "spmm": (kernel_model.spmm_work, (MASK, 1000, 300, 70, "float64"),
             lambda *a: _old_sparse("spmm", *a)),
    "flash": (kernel_model.flash_work,
              (8, 2048, 2048, 16, 8, 128, 128, True, "bfloat16"), _old_flash),
    "flash_mla": (kernel_model.flash_work,
                  (8, 2048, 2048, 128, 128, 192, 128, True, "float32"),
                  _old_flash),
    "wkv6": (kernel_model.wkv6_work, (8, 2048, 40, 64, "bfloat16"),
             _old_wkv6),
    "ssm": (kernel_model.ssm_work, (8, 2048, 8192, 16, "bfloat16"), _old_ssm),
}


@pytest.mark.parametrize("kernel", sorted(CHARGES))
def test_kernel_charge_equals_old_count(kernel):
    """Each kernel's (operations, bytes) equals the count chip_smoke.py
    reckoned its bound from, at one of its path's shapes; a torch dtype
    charges as its name does."""
    fn, args, old = CHARGES[kernel]
    assert fn(*args) == old(*args)
    dtype = next(a for a in args if isinstance(a, str))
    tdt = getattr(torch, dtype)
    assert fn(*(tdt if isinstance(a, str) else a for a in args)) \
        == old(*args)


PEAKS = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def _old_t(ops, nbytes, rate):
    t_ops, t_bytes = ops / rate, nbytes / PEAKS["bw"]
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def test_chip_smoke_bounds_read_the_shared_counts():
    """chip_smoke.py's bound helpers print the bounds they printed before
    they read `kernel_model` and `roofline`, at one shape each."""
    assert chip_smoke.peaks_for("NVIDIA H100 80GB HBM3")[1] == PEAKS
    assert chip_smoke.bound("gram", 8192, 1000, 1, "float64", PEAKS) == \
        _old_t(*_old_gram(8192, 1000, "float64"), PEAKS["float64"])
    assert chip_smoke.bound("xtv", 8192, 1000, 1, "float64", PEAKS) == \
        _old_t(*_old_xtv(8192, 1000, 1, "float64"), PEAKS["float64"])
    assert chip_smoke.batched_bound("xtv", 8, 87_500, 1000, 1, "float64",
                                    PEAKS, v_batched=False) == \
        _old_t(*_old_batched("xtv", 8, 87_500, 1000, 1, "float64", False,
                             True), PEAKS["float64"])
    assert chip_smoke.flash_bound(8, 2048, 2048, 16, 8, 128, 128, True,
                                  "bfloat16", PEAKS) == \
        _old_t(*_old_flash(8, 2048, 2048, 16, 8, 128, 128, True,
                           "bfloat16"), PEAKS["bfloat16"])
    ops, nbytes = _old_wkv6(8, 2048, 40, 64, "float32")
    assert chip_smoke.wkv6_bound(8, 2048, 40, 64, "float32", PEAKS) == \
        _old_t(ops * 3, nbytes, PEAKS["tf32"]) + ("tf32/3",)
    assert chip_smoke.ssm_bound(8, 2048, 8192, 16, "bfloat16", PEAKS) == \
        _old_t(*_old_ssm(8, 2048, 8192, 16, "bfloat16"), PEAKS["float32"])
    m, n, c = 1000, 300, 70
    got = chip_smoke.sparse_bounds("spmm", MASK, m, n, c, "float64", PEAKS)
    ms, by = _old_t(*_old_sparse("spmm", MASK, m, n, c, "float64"),
                    PEAKS["float64"])
    dense = _old_t(2.0 * m * n * c, (m * n + n * c) * 8 + m * c * 8,
                   PEAKS["float64"])
    assert got == dict(bound_ms=ms, bound_by=by, bound_dense_ms=dense[0],
                       bound_dense_by=dense[1])


def _old_family_bounds(model, cfg, batch, prompt, max_len, touched):
    D, V, K = cfg.d_model, cfg.vocab_size, cfg.n_codebooks or 1
    counts = cfg.param_counts()
    kinds = chip_smoke._attn_layers(cfg)
    dqk = cfg.head_dim + (cfg.rope_head_dim if cfg.attn_type == "mla"
                          else 0)
    pair_ops = 2.0 * (dqk + cfg.vdim) * cfg.n_heads * batch
    attn_ops = sum(pair_ops * (prompt * cfg.n_image_tokens if k == "xattn"
                               else prompt * (prompt + 1) / 2)
                   for k in kinds if k.startswith("attn") or k == "xattn")
    n_x = kinds.count("xattn")
    kv_w = 2 * D * cfg.kv_heads * cfg.head_dim
    per_token = cfg.active_params() - counts["embed"] - counts["head"]
    products = 2.0 * batch * (per_token * prompt
                              + n_x * kv_w * (cfg.n_image_tokens - prompt))
    prefill_ms = 1e3 * (products + attn_ops + 2.0 * D * V * K * batch) \
        / PEAKS["bfloat16"]
    embed = sum(p.numel() * p.element_size()
                for p in model.embed.parameters())
    weights = sum(p.numel() * p.element_size()
                  for p in model.parameters()) - embed
    caches = sum(t.numel() * t.element_size()
                 for t in chip_smoke._leaves(model.init_cache(batch,
                                                              max_len)))
    n_moe = sum(k.endswith("+moe") for k in kinds)
    untouched = n_moe * (cfg.n_experts - touched) * 3 * D \
        * (cfg.d_expert or cfg.d_ff) * 2
    return prefill_ms, 1e3 * (weights + caches - untouched) / PEAKS["bw"]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama3.2-vision-90b"])
def test_family_bounds_read_serve_work(arch):
    """`_family_bounds` (MLA with MoE, cross-attention) as before it read
    `roofline.serve_work`."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, "meta")
    assert chip_smoke._family_bounds(model, cfg, 8, 64, 96, 3.5, PEAKS) \
        == _old_family_bounds(model, cfg, 8, 64, 96, 3.5)


# ---------------------------------------------------------------------------
# wrappers: meta implementations, charges, custom ops, gram_aug
# ---------------------------------------------------------------------------

def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _wkv_inputs():
    g = torch.Generator().manual_seed(0)
    B, S, H, dh = 2, 48, 2, 32
    r, k, v = (torch.randn(B, S, H, dh, generator=g) for _ in range(3))
    logw = -torch.rand(B, S, H, dh, generator=g) - 0.01
    return (r, k, v, logw, torch.randn(H, dh, generator=g),
            torch.zeros(B, H, dh, dh))


def _ssm_inputs():
    g = torch.Generator().manual_seed(0)
    Bt, S, di, ds = 2, 40, 24, 8
    return (torch.randn(Bt, S, di, generator=g),
            torch.rand(Bt, S, di, generator=g) * 0.1,
            -torch.rand(di, ds, generator=g) - 0.5,
            torch.randn(Bt, S, ds, generator=g),
            torch.randn(Bt, S, ds, generator=g), torch.ones(di),
            torch.zeros(Bt, di, ds))


def _flash_inputs():
    return _x(2, 40, 4, 64), _x(2, 40, 2, 64), _x(2, 40, 2, 64)


WRAPPERS = {
    # name: (wrapper, plain version, inputs, kwargs, charge name, work)
    "flash": (fops.flash_attention, fref.attention, _flash_inputs,
              dict(causal=True), "flash",
              lambda q, k, v: kernel_model.flash_work(
                  2, 40, 40, 4, 2, 64, 64, True, torch.float32)),
    "wkv6": (wops.wkv6, lambda *a, chunk: wkv_chunked(*a, chunk),
             _wkv_inputs, dict(chunk=16), "wkv6",
             lambda *a: kernel_model.wkv6_work(2, 48, 2, 32, torch.float32)),
    "ssm_scan": (sops.ssm_scan, ssm_scan, _ssm_inputs, {}, "ssm",
                 lambda *a: kernel_model.ssm_work(2, 40, 24, 8,
                                                  torch.float32)),
    "gram": (gops.gram, gref.gram, lambda: (_x(300, 20),), {}, "gram",
             lambda x: kernel_model.gram_work(300, 20, torch.float32)),
    "xtv": (gops.xtv, gref.xtv, lambda: (_x(300, 20), _x(300, 3)), {},
            "xtv", lambda x, v: kernel_model.xtv_work(300, 20, 3,
                                                      torch.float32)),
    "gram_batched": (gops.gram_batched, gref.gram_batched,
                     lambda: (_x(3, 100, 20),), {}, "gram_batched",
                     lambda x: kernel_model.gram_batched_work(
                         3, 100, 20, torch.float32)),
    "xtv_batched": (gops.xtv_batched, gref.xtv_batched,
                    lambda: (_x(3, 100, 20), _x(100, 2)), {}, "xtv_batched",
                    lambda x, v: kernel_model.xtv_batched_work(
                        3, 100, 20, 2, torch.float32, False)),
    "gram_bs": (sp_ops.gram_dense_masked,
                lambda x, m: sp_ref.gram(x, m, sp_ops.ROWS, sp_ops.TILE),
                lambda: (_x(600, 130), _mask(600, 130)), {}, "gram_bs",
                lambda x, m: kernel_model.gram_bs_work(
                    _meta(m), 600, 130, torch.float32)),
    "xtv_bs": (sp_ops.xtv_dense_masked,
               lambda x, v, m: sp_ref.xtv(x, v, m, sp_ops.ROWS, sp_ops.TILE),
               lambda: (_x(600, 130), _x(600, 2), _mask(600, 130)), {},
               "xtv_bs", lambda x, v, m: kernel_model.xtv_bs_work(
                   _meta(m), 600, 130, 2, torch.float32)),
    "spmm": (sp_ops.spmm_dense_masked,
             lambda x, w, m: sp_ref.spmm(x, w, m, sp_ops.ROWS, sp_ops.TILE),
             lambda: (_x(600, 130), _x(130, 5), _mask(600, 130)), {},
             "spmm", lambda x, w, m: kernel_model.spmm_work(
                 _meta(m), 600, 130, 5, torch.float32)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_meta_implementation_matches_plain_shapes(name):
    """Each wrapper on "meta" gives its plain version's output shapes and
    dtypes, and charges its kernel's work once (a meta mask counts every
    block)."""
    wrapper, plain, inputs, kw, charge, work = WRAPPERS[name]
    args = inputs()
    want = plain(*args, **kw)
    with hlocost.CostTotals() as t:
        got = wrapper(*(_meta(a) for a in args), **kw)
    flat_w = want if isinstance(want, tuple) else (want,)
    flat_g = got if isinstance(got, tuple) else (got,)
    assert [(tuple(g.shape), g.dtype, g.device.type) for g in flat_g] == \
        [(tuple(w.shape), w.dtype, "meta") for w in flat_w]
    ops, nbytes = work(*args)
    assert t.by_op[charge] == [1, ops, nbytes]


def test_cuda_wrappers_still_refuse_cpu_tensors():
    q, k, v = _flash_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        fops.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        wops.wkv6_cuda(*_wkv_inputs(), chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        sops.ssm_scan_cuda(*_ssm_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        gops.gram_cuda(_x(10, 4))


def test_custom_ops_charge_their_plain_body():
    """`repro_torch::gram` / `::xtv` on the CPU run their plain body below
    the counter, which charges the kernel's work in its stead."""
    x, v = _x(300, 20), _x(300, 3)
    t = hlocost.count(gops.gram_op, x)
    assert (t.flops, t.bytes) == kernel_model.gram_work(300, 20, x.dtype)
    t = hlocost.count(gops.xtv_op, x, v)
    assert (t.flops, t.bytes) == kernel_model.xtv_work(300, 20, 3, x.dtype)
    t = hlocost.count(gops.gram_op, _meta(x))
    assert (t.flops, t.bytes) == kernel_model.gram_work(300, 20, x.dtype)


def test_gram_aug_matches_reference():
    """gram([X | y]) in one launch against the reference's `gram_aug`
    (interpret mode), at tests/test_kernels.py's tolerance."""
    from repro.kernels.gram import ops as ref_gops
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 30)).astype(np.float32)
    y = rng.normal(size=(128, 1)).astype(np.float32)
    want = np.asarray(ref_gops.gram_aug(jnp.asarray(x), jnp.asarray(y),
                                        interpret=True, bm=64, bn=32))
    for got in (gops.gram_aug(torch.from_numpy(x), torch.from_numpy(y)),
                gops.gram_aug(torch.from_numpy(x), torch.from_numpy(y[:, 0])),
                gref.gram_aug(torch.from_numpy(x), torch.from_numpy(y))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(want[:30, 30:], x.T @ y, rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# a count on meta equals the kernel route's, op for op
# ---------------------------------------------------------------------------

def _stand_in(plain, work, shapes):
    """A kernel launch stood in for on the CPU: the plain version run
    unseen by the counter (as a ctypes launch is), the kernel's work
    charged, as the CUDA wrapper does."""
    def launch(*args, **kw):
        with _disable_current_modes():
            out = plain(*args, **kw)
        hlocost.charge(work, *shapes(*args, **kw))
        return out
    return launch


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_meta_prefill_count_equals_kernel_route(arch, monkeypatch):
    """chip_smoke's `cost` check at a reduced width: the prefill counted
    on "meta" has the FLOPs, bytes and transcendentals of the kernel route
    counted on the CPU with each launch stood in for."""
    cfg = get_config(arch).reduced().with_(use_pallas=True)
    monkeypatch.setattr(fops, "flash_attention", _stand_in(
        fref.attention, kernel_model.flash_work,
        lambda q, k, v, causal: (*q.shape[:2], k.shape[1], q.shape[2],
                                 k.shape[2], q.shape[3], v.shape[3],
                                 causal, q.dtype)))
    monkeypatch.setattr(wops, "wkv6", _stand_in(
        lambda *a, chunk: wkv_chunked(*a, chunk),
        kernel_model.wkv6_work,
        lambda r, *a, chunk: (*r.shape, r.dtype)))
    monkeypatch.setattr(sops, "ssm_scan", _stand_in(
        ssm_scan, kernel_model.ssm_work,
        lambda x, dt, A, *a: (*x.shape, A.shape[1], x.dtype)))
    model = build_model(cfg, "cpu").init(seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    card = hlocost.count(model.prefill, tokens, max_len=80)
    meta = hlocost.count(build_model(cfg, "meta").prefill, _meta(tokens),
                         max_len=80)
    assert card.flops == meta.flops > 0
    assert card.bytes == meta.bytes
    assert card.transcendentals == meta.transcendentals
    kernels = {"qwen3-0.6b": ["flash"], "rwkv6-3b": ["wkv6"],
               "jamba-v0.1-52b": ["flash", "ssm"]}[arch]
    for k in kernels:
        assert card.by_op[k][0] == meta.by_op[k][0] > 0


def test_garbage_collection_inside_the_counter():
    """Tensors freed by the garbage collector while the counter registers
    another (weak-reference callbacks at any allocation) are released
    without a lock: nothing deadlocks and nothing stays counted."""
    import gc
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        with hlocost.CostTotals() as t:
            x = _x(16, 16)
            for _ in range(200):
                cycle = [torch.tanh(x)]
                cycle.append(cycle)  # freed by the collector, not refcounts
                del cycle
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    with t._lock:
        t._drain()
    assert t.live_bytes == 0 and t.flops == 200 * 16 * 16


def test_region_counts_its_backward():
    """`region` charges the ops inside and their backward ops (the
    reference's scan region holds the backward loop too), not the ops
    around them."""
    x = _x(64, 64).requires_grad_(True)

    def f():
        y = x * 2
        with hlocost.region("scan"):
            z = torch.tanh(y).exp()
        (z * 3).sum().backward()
    t = hlocost.count(f)
    n = 64 * 64 * 4
    # tanh and exp (2 n each), ExpBackward's mul and tanh_backward (3 n)
    assert t.regions["scan"] == 2 * 2 * n + 2 * 3 * n
    assert t.bytes > t.regions["scan"]
