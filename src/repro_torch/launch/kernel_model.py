"""The hand kernels' own work, and the kernel-effective memory term.

Port of `repro.launch.kernel_model`. Two parts:

  * one function per hand-written kernel of the port giving the
    (operations, bytes) of a call: the least work the function needs,
    each input byte read once and each output byte written once, and for
    the block-sparse kernels the populated blocks only (what this data
    needs; a mask on "meta" holds no data, so a meta call charges every
    block). The kernel wrappers charge these to the active
    `repro_torch.launch.hlocost` counter (a `ctypes` launch is invisible
    to torch's dispatch), and `chip_smoke.py` reckons every kernel's
    bound from them, so the card's bounds and the counter read one
    formula;
  * the reference's kernel-effective roofline substitution: the dry run's
    plain recurrences (`wkv_chunked`, `selective_scan`, which training
    takes) round-trip their state through memory op by op, where the
    kernels keep it on chip. `scan_region_bytes` reads the bytes the
    counter charged inside them (their `hlocost.region("scan")`),
    `wkv6_kernel_io_bytes` / `ssd_kernel_io_bytes` give the kernels'
    analytic I/O for the same work (the reference's, verbatim, its /16
    model split included), and `main` reports the substituted memory
    term.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.kernel_model rwkv6-3b train_4k
"""
from __future__ import annotations

import sys

import torch

_SIZES = {"float64": 8, "float32": 4, "bfloat16": 2}


def _size(dtype) -> int:
    """Bytes of an input element: `dtype` a torch dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return _SIZES[dtype]


def _out(dtype) -> int:
    """Bytes of an accumulated output element: float64 stays float64,
    every other input type accumulates in float32."""
    return 8 if _size(dtype) == 8 else 4


# -- gram.cu ------------------------------------------------------------------

def gram_work(m: int, n: int, dtype) -> tuple[float, float]:
    """G = XᵀX of an (m, n) X: the upper triangle with its diagonal,
    m·n·(n + 1) operations; X read and G written once."""
    return m * n * (n + 1), m * n * _size(dtype) + n * n * _out(dtype)


def xtv_work(m: int, n: int, c: int, dtype) -> tuple[float, float]:
    """Xᵀv of an (m, n) X and an (m, c) v: 2·m·n·c operations."""
    return 2 * m * n * c, (m * n + m * c) * _size(dtype) + n * c * _out(dtype)


def gram_batched_work(k: int, m: int, n: int, dtype) -> tuple[float, float]:
    """`gram_work` for a (k, m, n) stack in one launch."""
    return k * m * n * (n + 1), k * (m * n * _size(dtype)
                                     + n * n * _out(dtype))


def xtv_batched_work(k: int, m: int, n: int, c: int, dtype,
                     v_batched: bool = True, x_batched: bool = True
                     ) -> tuple[float, float]:
    """`xtv_work` for a batch of k products in one launch; a shared X or
    v is read once for the batch."""
    size = _size(dtype)
    return 2 * k * m * n * c, ((k if x_batched else 1) * m * n * size
                               + (k if v_batched else 1) * m * c * size
                               + k * n * c * _out(dtype))


def matmul_work(m: int, n: int, c: int, dtype) -> tuple[float, float]:
    """X @ W of an (m, n) X and an (n, c) W over the dense layout."""
    return 2 * m * n * c, (m * n + n * c) * _size(dtype) + m * c * _out(dtype)


# -- spmm.cu: the populated blocks of a (ROWS, TILE) block mask ---------------

def _populated(mask: torch.Tensor, m: int, n: int):
    """(populated blocks (chunks, tiles) bool, each chunk's rows, each
    tile's columns) as numpy; a mask on "meta" counts every block."""
    import numpy as np
    from repro_torch.kernels.spmm.ops import ROWS, TILE
    if mask.device.type == "meta":
        pop = np.ones(tuple(mask.shape), dtype=bool)
    else:
        pop = mask.cpu().numpy() > 0
    rows = np.minimum(ROWS, m - ROWS * np.arange(pop.shape[0]))
    width = np.minimum(TILE, n - TILE * np.arange(pop.shape[1]))
    return pop, rows, width


def gram_bs_work(mask: torch.Tensor, m: int, n: int, dtype
                 ) -> tuple[float, float]:
    """XᵀX over the populated blocks: per row chunk, its populated
    columns' upper triangle; the populated blocks of X read once, G
    written once."""
    pop, rows, width = _populated(mask, m, n)
    cols = (pop * width).sum(axis=1)          # populated columns per chunk
    ops = float((rows * cols * (cols + 1)).sum())
    return ops, float((rows * cols).sum()) * _size(dtype) \
        + n * n * _out(dtype)


def xtv_bs_work(mask: torch.Tensor, m: int, n: int, c: int, dtype
                ) -> tuple[float, float]:
    """Xᵀv over the populated blocks; v read for the chunks that hold a
    populated block."""
    pop, rows, width = _populated(mask, m, n)
    cols = (pop * width).sum(axis=1)
    size = _size(dtype)
    return 2.0 * float((rows * cols).sum()) * c, \
        (float((rows * cols).sum()) * size
         + float(rows[pop.any(axis=1)].sum()) * c * size + n * c * _out(dtype))


def spmm_work(mask: torch.Tensor, m: int, n: int, c: int, dtype
              ) -> tuple[float, float]:
    """X @ W over the populated blocks of an (m, n) X; W's rows read for
    the tiles that hold a populated block, Y written once."""
    pop, rows, width = _populated(mask, m, n)
    cols = (pop * width).sum(axis=1)
    used = float(width[pop.any(axis=0)].sum())
    size = _size(dtype)
    return 2.0 * float((rows * cols).sum()) * c, \
        (float((rows * cols).sum()) * size + used * c * size
         + m * c * _out(dtype))


# -- flash.cu, wkv6.cu, ssd.cu ------------------------------------------------

def flash_work(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
               dv: int, causal: bool, dtype) -> tuple[float, float]:
    """One attention call: the visible (q, k) pairs each take 2·hd
    operations for QKᵀ and 2·dv for PV; q, k, v read once and the output
    written once."""
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    return 2.0 * (hd + dv) * pairs * B * Hq, \
        (B * Sq * Hq * (hd + dv) + B * Sk * Hkv * (hd + dv)) * _size(dtype)


def wkv6_work(B: int, S: int, H: int, dh: int, dtype) -> tuple[float, float]:
    """One WKV6 call, from the least work the recurrence needs, whatever
    the algorithm: per row and (b, h), y = rᵀS (2·dh² operations) and S =
    w ⊙ S + k vᵀ (3·dh²); r, k, v read and y written once in `dtype`,
    logw, u and the state in and out in float32."""
    size = _size(dtype)
    return 5.0 * dh * dh * B * S * H, \
        (4 * size + 4) * B * S * H * dh + 4 * H * dh + 2 * 4 * B * H * dh * dh


def ssm_work(B: int, S: int, di: int, ds: int, dtype) -> tuple[float, float]:
    """One selective-scan call: per (b, t, d, s) one exp and six float32
    operations (dt·A, dA·h, u·B, their sum, h·C and its sum), per (b, t,
    d) three (u = dt·x, D·x and its sum); x read in `dtype`, dt read and
    y written in float32 once, B and C read once per (b, t), A, D and h0
    in and h out in float32."""
    size = _size(dtype)
    return 7.0 * B * S * di * ds + 3.0 * B * S * di, \
        (size + 8) * B * S * di + 2 * size * B * S * ds \
        + 4 * (di * ds + di) + 2 * 4 * B * di * ds


# -- the kernel-effective memory term (the reference's, verbatim) -------------

def scan_region_bytes(totals) -> tuple[float, float]:
    """(total bytes, bytes charged inside the plain recurrences) of a
    `hlocost.CostTotals`: the kernel-replaceable region, whatever the
    sequence length (the reference walked while-loops nested at depth >=
    2 of the compiled HLO)."""
    return totals.bytes, totals.regions.get("scan", 0.0)


def wkv6_kernel_io_bytes(cfg, batch_per_dev: int, seq: int,
                         passes: float = 3.0) -> float:
    """Per-device HBM I/O of the WKV6 kernel across all layers:
    r,k,v,logw in + y out (+state), bf16, heads sharded /16 on model."""
    d_sharded = cfg.d_model / 16
    per_layer = 5 * batch_per_dev * seq * d_sharded * 2
    H = cfg.d_model // cfg.rwkv_head_dim
    state = batch_per_dev * (H / 16) * cfg.rwkv_head_dim ** 2 * 4 \
        * (seq // cfg.rwkv_chunk)
    return (per_layer + state) * cfg.n_layers * passes


def ssd_kernel_io_bytes(cfg, batch_per_dev: int, seq: int,
                        passes: float = 3.0) -> float:
    """Per-device HBM I/O of the mamba scan kernel across mamba layers:
    x, dt in/out + B, C + y, f32, channels sharded /16 on model."""
    di_sharded = cfg.d_inner / 16
    n_mamba = sum(1 for k in cfg.layer_kinds() if k.startswith("mamba")) \
        * cfg.n_periods()
    per_layer = batch_per_dev * seq * (3 * di_sharded + 2 * cfg.d_state) * 4
    return per_layer * n_mamba * passes


def main():
    from repro_torch.configs import get_config
    from repro_torch.distributed import logical_devices
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES

    arch = sys.argv[1] if len(sys.argv) > 1 else "rwkv6-3b"
    shape = sys.argv[2] if len(sys.argv) > 2 else "train_4k"
    with logical_devices(256):
        mesh = make_production_mesh(multi_pod=False)
        _, totals, cell = lower_cell(arch, shape, mesh, verbose=False,
                                     hints=True)
    n = cell.n_devices
    total, inner = (b / n for b in scan_region_bytes(totals))
    cfg = get_config(arch)
    B_dev = SHAPES[shape]["batch"] // 16
    S = SHAPES[shape]["seq_len"]
    if cfg.ssm_type == "rwkv6":
        k_io = wkv6_kernel_io_bytes(cfg, B_dev, S)
        kname = "rwkv6 (chunked WKV, state on chip)"
    else:
        k_io = ssd_kernel_io_bytes(cfg, B_dev, S)
        kname = "ssd (mamba scan, state on chip)"
    substituted = total - inner + k_io
    print(f"cell: {arch} × {shape} (per device; NVIDIA H100 80GB HBM3 "
          f"at 700 W constants)")
    print(f"  measured bytes total      : {total:.3e}  "
          f"(t_mem {total/roofline.HBM_BW*1e3:9.1f} ms)")
    print(f"  scan region bytes         : {inner:.3e}  "
          f"({inner/max(total, 1)*100:.1f}% of total)")
    print(f"  kernel I/O replacement    : {k_io:.3e}   [{kname}]")
    print(f"  SUBSTITUTED bytes         : {substituted:.3e}  "
          f"(t_mem {substituted/roofline.HBM_BW*1e3:9.1f} ms)")
    print(f"  memory-term improvement   : "
          f"{total/max(substituted, 1):.1f}x")


if __name__ == "__main__":
    main()
