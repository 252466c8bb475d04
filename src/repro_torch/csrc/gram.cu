// Gram (tsmm) kernel family for Hopper (sm_90a): G = X^T X and X^T V.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gram/kernel.py:
//   * gram_{f64,f32}_partial_kernel, gram_bf16_wgmma_kernel +
//     gram_tile_reduce_kernel              <- gram_pallas (_gram_kernel)
//   * xtv_slab_kernel (V of one column), xtv_tile_kernel (two or more) +
//     xtv_reduce_kernel (gram_mainloop.cuh) <- xtv_pallas  (_xtv_kernel)
//
// Dtype rule (src/repro/kernels/gram/ref.py): float64 accumulates and
// returns float64, float32 -> float32, bfloat16 -> float32. The Pallas
// kernel's unconditional float32 output is NOT carried over: the
// lifecycle path is float64. float16 is not instantiated (the wrapper
// refuses it on the card; the plain version serves it on the CPU).
//
// gram is bound by operations in float64: an 8192 x 1000 bucket is ~8.2
// GFLOP of upper-triangle work against 65.5 MB read. Each block computes
// one upper-triangle output tile (BM x BN = 128 x 128 or 128 x 64: the
// tsmm trick of the Pallas kernel) over one row range (split-K: tall-
// skinny lmDS shapes have too few tiles to fill 132 SMs). Both operands
// are column tiles of the same X, so t(X) is never formed; a tile whose
// columns lie inside its rows' columns (the diagonal) loads X once. The
// float64 and float32 mainloops (FP64 tensor cores for float64, the FMA
// pipes for float32, a 3-stage cp.async ring of 16-byte or element
// copies) and the reduce pass over the tile-major partials
// [splits][tiles][BM][BN] live in gram_mainloop.cuh, which spmm.cu's
// block-sparse gram shares; the wrapper chooses the copy width by pointer
// and stride, since a column slice keeps its parent's leading dimension
// and odd widths give 8-byte-aligned rows. bfloat16 (lone and batched) is
// bound by the tensor cores, which only wgmma drives at their rate: its
// tiles come by TMA (two 64-column panels of each column tile, 128-byte
// swizzled, a 4-stage mbarrier ring fed by one producer thread) and two
// consumer warpgroups run wgmma m64nBNk16 on them with both operands
// MN-major (the descriptor transposes X's row tiles), float32
// accumulators in registers; same tiles, splits (whole stages of 64 rows
// each) and partials as the other dtypes. TMA needs X's base, leading
// dimension and batch stride 16-byte aligned: the wrapper gives it such
// a copy of any other X.
//
// xtv with one column of V (c = 1 in lmDS) is bound by bytes (it reads X
// once). Each lane loads 16 bytes of a row (two float64 columns), so a
// warp covers a slab of 32 x 16 bytes of every row it reads, with
// XTV_UNROLL independent row loads in flight a thread; elements of v are
// read as a broadcast. The 8 warps of a block split its rows and sum their
// partials in shared memory in warp order; blocks split the rows into a
// few splits of hundreds of KB each, which a second pass sums in a fixed
// order (gram_mainloop.cuh's xtv_reduce_kernel).
//
// xtv with two or more columns (kmeans' per-cluster sums, mlogreg's
// gradient, a batch of v folded into columns) is a tile product, bound by
// bytes at the paths' shapes: an output tile is a 128-column tile of the
// wider operand U against a BN-column tile (8, 16, 32 or 64: the narrow
// side is not padded to 128) of the narrower W, contracted over rows, so
// U is read once (W, narrow, once per U tile, from L2). The tiles come
// through gram_mainloop.cuh's cp.async ring (4 stages of 16 KB of U);
// float64 runs on mma.sync m16n8k4 f64, bfloat16 on mma.sync m16n8k16
// with float32 accumulation (the header's stage steps, mma_f64_stage and
// mma_bf16_stage, which the gram tiles run too), float32 on the FMA pipes
// (TF32 would break the 1e-5 limit). Each warp owns 16 rows of U's tile
// against all of W's BN columns, where a gram tile's warp owns 64 x 32 of
// a 128 x 128 tile: BN = 8 has no 32-column warp block, so the two share
// the fragment step, not the warp grid; float32's register tile (2 x
// BN / 4 a thread against the gram's 8 x 8) is the tile product's own.
// Either operand may read its columns through a group stride (column j at
// (j / gw) * gs + j % gw), so a vmapped batch of v is read in place as
// one V of k·c columns. Splits over rows go through xtv_reduce_kernel.
//
// None uses atomics: results are bitwise reproducible from run to run
// (the wrapper's plan depends only on the shape and the card).
//
// Batched forms (repro_gram_batched, repro_xtv_batched, repro_xtv_tile's
// batch): what torch.func.vmap over the lifecycle's gram/xtv asks for (a
// parfor grid's config-variant suffix, CV's per-fold products), where the
// reference's vmap turns the pallas_call into one launch whose grid
// carries the configurations. Here too the batch is one launch: grid.z is
// the batch element, X (and V, or V shared with batch stride 0) advance by
// their batch strides, and each element's workspace and output are whole
// copies of a lone call's. The split plan covers the whole batch (batch x
// tiles x splits), and each element's blocks and reduce compute exactly a
// lone call's sums under that plan, so results repeat bitwise.
//
// Interface: plain C entry points for ctypes. Each takes device pointers,
// sizes, leading dimensions and the CUDA stream, launches its kernels on
// that stream (the partial and the reduce pass, one host call for both,
// since the host's time per call sets xtv's), never synchronises or
// allocates (the Python wrapper owns every buffer), and returns the first
// launch error.

#include "gram_mainloop.cuh"

namespace {

// The partial kernels: block (tile, split, batch element) accumulates its
// tile over rows [split * rows_per_split, ...) of its element's X (xbatch
// elements after the previous one's) in order and writes its partial to
// slot (element, split, tile) of the tile-major workspace.
template <int BN, int VEC>
__global__ void __launch_bounds__(GRAM_THREADS, 1)
gram_f64_partial_kernel(const double* __restrict__ x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int64_t tiles, double* __restrict__ ws,
                        int64_t xbatch) {
  x += (int64_t)blockIdx.z * xbatch;
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  gram_tile<double, BN, VEC>(
      x, ldx, n, i0, j0, (int)((r1 - r0 + F64_BK - 1) / F64_BK),
      [&](int it) { return r0 + (int64_t)it * F64_BK; }, r1,
      ws + (((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * tiles + blockIdx.x) * (BM * BN));
}

template <int BN, int VEC>
__global__ void __launch_bounds__(GRAM_THREADS)
gram_f32_partial_kernel(const float* __restrict__ x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int64_t tiles, float* __restrict__ ws,
                        int64_t xbatch) {
  x += (int64_t)blockIdx.z * xbatch;
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  gram_tile<float, BN, VEC>(
      x, ldx, n, i0, j0, (int)((r1 - r0 + F32_BK - 1) / F32_BK),
      [&](int it) { return r0 + (int64_t)it * F32_BK; }, r1,
      ws + (((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * tiles + blockIdx.x) * (BM * BN));
}

// ---- xtv -------------------------------------------------------------------

constexpr int XTV_THREADS = 256;  // 8 warps
constexpr int XTV_UNROLL = 8;     // row loads in flight a thread

// 16 bytes of a row into registers (no address of a register is taken:
// that would put the value in local memory and serialise the loads)
__device__ __forceinline__ void load16(const double* p, double (&e)[2]) {
  const double2 d = __ldg(reinterpret_cast<const double2*>(p));
  e[0] = d.x;
  e[1] = d.y;
}
__device__ __forceinline__ void load16(const float* p, float (&e)[4]) {
  const float4 d = __ldg(reinterpret_cast<const float4*>(p));
  e[0] = d.x;
  e[1] = d.y;
  e[2] = d.z;
  e[3] = d.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, __nv_bfloat16 (&e)[8]) {
  const uint4 d = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int w[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    e[2 * i] = __ushort_as_bfloat16((unsigned short)(w[i] & 0xffffu));
    e[2 * i + 1] = __ushort_as_bfloat16((unsigned short)(w[i] >> 16));
  }
}

// One block: a slab of 32 * P columns (P = 16 / sizeof(T)) over one row
// range of one batch element (blockIdx.z: X and v advance by xbatch and
// vbatch, vbatch 0 for a broadcast v) against v's one column, warp w
// taking rows r0 + w, r0 + w + 8, ... VEC: lane l loads columns
// [l P, l P + P) with one 16-byte load; otherwise columns l + 32 p, one
// element a load.
template <typename T, bool VEC>
__global__ void __launch_bounds__(XTV_THREADS)
xtv_slab_kernel(const T* __restrict__ x, const T* __restrict__ v, int64_t m, int64_t n,
                int64_t ldx, int64_t ldv, int64_t rows_per_split,
                typename Acc<T>::type* __restrict__ ws, int64_t xbatch, int64_t vbatch) {
  using A = typename Acc<T>::type;
  x += (int64_t)blockIdx.z * xbatch;
  v += (int64_t)blockIdx.z * vbatch;
  ws += (int64_t)blockIdx.z * gridDim.y * n;
  constexpr int P = 16 / (int)sizeof(T), SLAB = 32 * P, WARPS = XTV_THREADS / 32;
  __shared__ A red[WARPS][SLAB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t j0 = (int64_t)blockIdx.x * SLAB;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  auto local = [&](int p) { return VEC ? lane * P + p : lane + 32 * p; };
  const bool full = VEC && j0 + (lane + 1) * P <= n;

  A acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = A(0);
  for (int64_t k = r0 + warp; k < r1; k += WARPS * XTV_UNROLL) {
    T xr[XTV_UNROLL][P];
    A vr[XTV_UNROLL];
#pragma unroll
    for (int u = 0; u < XTV_UNROLL; ++u) {
      const int64_t kk = k + (int64_t)u * WARPS;
      const bool rok = kk < r1;
      const T* row = x + kk * ldx + j0;
      if (VEC && full && rok) {
        load16(row + lane * P, xr[u]);
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p)
          xr[u][p] = (rok && j0 + local(p) < n) ? row[local(p)] : zero<T>();
      }
      vr[u] = rok ? to_acc(v[kk * ldv]) : A(0);
    }
#pragma unroll
    for (int u = 0; u < XTV_UNROLL; ++u)
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = madd(to_acc(xr[u][p]), vr[u], acc[p]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) red[warp][local(p)] = acc[p];
  __syncthreads();
  for (int e = threadIdx.x; e < SLAB; e += XTV_THREADS) {
    const int64_t j = j0 + e;
    if (j < n) {
      A s = red[0][e];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += red[w][e];
      ws[(int64_t)blockIdx.y * n + j] = s;
    }
  }
}

// ---- xtv as a tile product (two or more columns of V) ----------------------

// Block (tile, split, batch element): the 128 x BN output tile of
// U[:, c0u..]^T W[:, c0w..] over rows [split * rows_per_split, ...) of its
// element, written to out-layout slot (element, split): entry (i, j) of U^T
// W at ws[i * rs + j * cs] (rs = W's width, cs = 1; or, when U is V and W
// is X, rs = 1, cs = U's width).
template <typename T, int BN>
__global__ void __launch_bounds__(XT_THREADS, (sizeof(T) == 2 && BN >= 32) ? 1 : 2)
xtv_tile_kernel(const Operand<T> u, const Operand<T> w, int64_t m, int64_t rows_per_split,
                int tiles_u, typename Acc<T>::type* __restrict__ ws, int64_t rs, int64_t cs,
                int64_t nc) {
  using A = typename Acc<T>::type;
  constexpr int BK = xt_bk<T>(), LDU = xt_ldu<T>(), LDW = xt_ldw<T, BN>();
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int64_t uoff[XT_BM], woff[BN];
  __shared__ int uval[XT_BM], wval[BN];
  const int tid = threadIdx.x;
  const int64_t c0u = (int64_t)(blockIdx.x % tiles_u) * XT_BM;
  const int64_t c0w = (int64_t)(blockIdx.x / tiles_u) * BN;
  const T* up = u.p + (int64_t)blockIdx.z * u.bs;
  const T* wp = w.p + (int64_t)blockIdx.z * w.bs;
  ws += ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * nc;
  column_table<T, XT_BM>(uoff, uval, u, c0u, tid);
  column_table<T, BN>(woff, wval, w, c0w, tid);
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  const int niter = (int)((r1 - r0 + BK - 1) / BK);
  auto load = [&](T* s, int it) {
    const int64_t k0 = r0 + (int64_t)it * BK;
    T* sw = s + BK * LDU;
    if (u.vec) load_operand<T, V, BK, XT_BM, LDU>(s, up, u.ld, uoff, uval, k0, r1, tid);
    if (w.vec) load_operand<T, V, BK, BN, LDW>(sw, wp, w.ld, woff, wval, k0, r1, tid);
    if constexpr (sizeof(T) == 2) {
      if (!u.vec) load_operand_bf16<BK, XT_BM, LDU>(s, up, u.ld, uoff, uval, k0, r1, tid);
      if (!w.vec) load_operand_bf16<BK, BN, LDW>(sw, wp, w.ld, woff, wval, k0, r1, tid);
    } else {
      if (!u.vec) load_operand<T, 1, BK, XT_BM, LDU>(s, up, u.ld, uoff, uval, k0, r1, tid);
      if (!w.vec) load_operand<T, 1, BK, BN, LDW>(sw, wp, w.ld, woff, wval, k0, r1, tid);
    }
  };
  auto put = [&](int mm, int nn, A val) {
    const int64_t i = c0u + mm, j = c0w + nn;
    if (i < u.cols && j < w.cols) ws[i * rs + j * cs] = val;
  };
  TileAcc<T, BN, true> acc;
  cp_ring<XT_STAGES, BK * (LDU + LDW)>(smem, niter, load, [&](const T* su) {
    acc.template stage<BK, LDU, LDW>(su, su + BK * LDU, BN / 8);
  });
  acc.store(put);
}

// ---- bfloat16 gram on wgmma + TMA ------------------------------------------

constexpr int WG_BK = 64;                       // rows of X a stage
constexpr int WG_STAGES = 4;                    // depth of the TMA ring
constexpr int WG_CHAIN = 2;                     // stages a tensor-core chain
constexpr int WG_CONSUMERS = 256;               // 2 warpgroups: tile rows 0-63, 64-127
constexpr int WG_THREADS = WG_CONSUMERS + 32;   // and one producer warp
constexpr uint32_t WG_PANEL = WG_BK * 128;      // 64 columns x WG_BK rows, 128-byte rows
constexpr uint32_t WG_STAGE = 4 * WG_PANEL;     // the i tile's 2 panels, then the j tile's
constexpr int WG_SMEM = WG_STAGES * WG_STAGE + 1024;  // + the 1024-byte alignment

// One TMA box (64 columns x WG_BK rows of batch element z) into shared
// memory, completing its bytes on the barrier.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
// wgmma descriptor of a 128-byte-swizzled MN-major operand: 8-row groups
// 1024 bytes apart along k, 64-column panels `panel` bytes apart along m/n.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t panel) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((panel >> 4) & 0x3FFF) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}
// D (64 x 128, f32) = A (64 x 16) B (16 x 128) (+ D when accumulate), both
// from shared memory, both MN-major (transposed by the descriptor)
__device__ __forceinline__ void wgmma_tt_n128(float* d, uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}
// D (64 x 64, f32) = A (64 x 16) B (16 x 64) (+ D), as above
__device__ __forceinline__ void wgmma_tt_n64(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Block (tile, split, batch element z) of the upper-triangle walk: warp 8's
// first thread loads each stage's panels by TMA (the j tile's only off the
// diagonal) into a WG_STAGES-deep ring (full/empty mbarriers); consumer
// warpgroup wg computes tile rows 64 wg .. 64 wg + 63 against the BN
// columns. The tensor cores' float32 sums drift low over a long chain of
// adds (a 12,500-row split read 4.9e-5 of the column-norm scale, on an
// H100), so every WG_CHAIN stages' rows are one fresh chain of wgmma (the
// first k step overwrites), added once into the float32 accumulator by
// the FMA pipes, rounded to nearest, while the other warpgroup's products
// run. A stage is released once its products are done (wgmma.wait 1 in
// the chain, 0 at its end). Then the warpgroup writes its rows of the
// tile-major partial. Accumulator d[4j + e] of wgmma m64nN (w = warp in
// the warpgroup, g = lane / 4, t = lane % 4) is row 16w + g + 8 (e >= 2),
// column 8j + 2t + (e & 1).
template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
gram_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tx, int64_t m, int64_t n,
                       int64_t rows_per_split, int64_t tiles, float* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  uint8_t* stages = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const bool share = j0 + BN <= i0 + BM;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  const int niter = (int)((r1 - r0 + WG_BK - 1) / WG_BK);
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // 2: the producer

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == 2) {
    if (threadIdx.x == WG_CONSUMERS) {
      const uint32_t bytes = (share ? 2 : 2 + BN / 64) * WG_PANEL;
      const int z = blockIdx.z;
      for (int it = 0; it < niter; ++it) {
        const int st = it % WG_STAGES;
        mbar_wait(&empty[st], ((it / WG_STAGES) & 1) ^ 1);  // round 0 passes
        const uint32_t dst = smem_u32(stages + st * WG_STAGE);
        const int k = (int)(r0 + (int64_t)it * WG_BK);
        mbar_expect_tx(&full[st], bytes);
        tma_load_3d(dst, &tx, (int)i0, k, z, &full[st]);
        tma_load_3d(dst + WG_PANEL, &tx, (int)i0 + 64, k, z, &full[st]);
        if (!share)
          for (int p = 0; p < BN / 64; ++p)
            tma_load_3d(dst + (2 + p) * WG_PANEL, &tx, (int)j0 + 64 * p, k, z, &full[st]);
      }
    }
  } else {
    const int wg = role;
    const uint32_t boff = share ? (uint32_t)((j0 - i0) / 64) * WG_PANEL : 2 * WG_PANEL;
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    for (int it = 0; it < niter; ++it) {
      const int st = it % WG_STAGES;
      mbar_wait(&full[st], (it / WG_STAGES) & 1);
      const uint32_t base = smem_u32(stages + st * WG_STAGE);
      const uint64_t da = wg_desc(base + wg * WG_PANEL, WG_PANEL);
      const uint64_t db = wg_desc(base + boff, WG_PANEL);
      const int link = it % WG_CHAIN;  // this stage's place in its chain
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t step = (uint64_t)(kk * 16 * 128) >> 4;  // 16 rows of 128 bytes
        const int chained = link > 0 || kk > 0;
        if constexpr (BN == 128) wgmma_tt_n128(part, da + step, db + step, chained);
        else wgmma_tt_n64(part, da + step, db + step, chained);
      }
      wgmma_commit();
      if (link == WG_CHAIN - 1 || it == niter - 1) {
        wgmma_wait<0>();
        reg_fence(part);
        if (link > 0) mbar_arrive(&empty[(it - 1) % WG_STAGES]);
        mbar_arrive(&empty[st]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      } else if (link > 0) {
        wgmma_wait<1>();  // the previous stage's products are done
        mbar_arrive(&empty[(it - 1) % WG_STAGES]);
      }
    }
    const int lane = threadIdx.x & 31, wi = (threadIdx.x >> 5) & 3;
    const int row = wg * 64 + wi * 16 + (lane >> 2), col0 = 2 * (lane & 3);
    float* w = ws + (((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * tiles + blockIdx.x) *
                        (BM * BN);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + col0;
      *reinterpret_cast<float2*>(w + row * BN + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(w + (row + 8) * BN + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <typename T, int BN, int VEC>
int launch_gram_partial(const void* x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int splits, void* ws, cudaStream_t stream,
                        int batch, int64_t xbatch) {
  using A = typename Acc<T>::type;
  const int64_t tiles = upper_tiles<BN>(n);
  const dim3 grid((unsigned int)tiles, (unsigned int)splits, (unsigned int)batch);
  void (*kernel)(const T*, int64_t, int64_t, int64_t, int64_t, int64_t, A*, int64_t);
  if constexpr (sizeof(T) == 8) {
    kernel = gram_f64_partial_kernel<BN, VEC>;
  } else {
    kernel = gram_f32_partial_kernel<BN, VEC>;
  }
  constexpr int smem = gram_smem_bytes<T>();
  static bool ready[64] = {};
  const int rc = allow_smem(kernel, smem, ready);
  if (rc != 0) return rc;
  kernel<<<grid, GRAM_THREADS, smem, stream>>>(static_cast<const T*>(x), m, n, ldx,
                                               rows_per_split, tiles, static_cast<A*>(ws),
                                               xbatch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gram_partial(int tile_n, int vec, const void* x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int splits, void* ws, cudaStream_t stream,
                        int batch, int64_t xbatch) {
  constexpr int V = 16 / (int)sizeof(T);
  if (tile_n == 128)
    return vec ? launch_gram_partial<T, 128, V>(x, m, n, ldx, rows_per_split, splits, ws, stream,
                                                batch, xbatch)
               : launch_gram_partial<T, 128, 1>(x, m, n, ldx, rows_per_split, splits, ws, stream,
                                                batch, xbatch);
  if (tile_n == 64)
    return vec ? launch_gram_partial<T, 64, V>(x, m, n, ldx, rows_per_split, splits, ws, stream,
                                               batch, xbatch)
               : launch_gram_partial<T, 64, 1>(x, m, n, ldx, rows_per_split, splits, ws, stream,
                                               batch, xbatch);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool VEC>
int launch_xtv(const void* x, const void* v, int64_t m, int64_t n, int64_t ldx, int64_t ldv,
               int64_t rows_per_split, int splits, void* ws, cudaStream_t stream, int batch,
               int64_t xbatch, int64_t vbatch) {
  constexpr int SLAB = 32 * 16 / (int)sizeof(T);
  const dim3 grid(blocks_for(n, SLAB), (unsigned int)splits, (unsigned int)batch);
  xtv_slab_kernel<T, VEC><<<grid, XTV_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), m, n, ldx, ldv, rows_per_split,
      static_cast<typename Acc<T>::type*>(ws), xbatch, vbatch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_xtv(int vec, const void* x, const void* v, int64_t m, int64_t n, int64_t ldx,
               int64_t ldv, int64_t rows_per_split, int splits, void* ws, cudaStream_t stream,
               int batch, int64_t xbatch, int64_t vbatch) {
  return vec ? launch_xtv<T, true>(x, v, m, n, ldx, ldv, rows_per_split, splits, ws, stream,
                                   batch, xbatch, vbatch)
             : launch_xtv<T, false>(x, v, m, n, ldx, ldv, rows_per_split, splits, ws, stream,
                                    batch, xbatch, vbatch);
}

// The bf16 gram's partial pass: a 3-D (n, m, batch) tensor map over X
// (boxes of 64 columns x WG_BK rows, 128-byte swizzled, zeros past every
// edge) and one launch over (tiles, splits, batch). X's base, ldx and
// xbatch must be 16-byte aligned and the split rows whole stages.
template <int BN>
int launch_gram_bf16_wgmma(const void* x, int64_t m, int64_t n, int64_t ldx,
                           int64_t rows_per_split, int splits, void* ws, cudaStream_t stream,
                           int batch, int64_t xbatch) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || (ldx * 2) % 16 != 0 ||
      (batch > 1 && (xbatch * 2) % 16 != 0) || rows_per_split % WG_BK != 0)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)m, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)ldx * 2,
                                 (cuuint64_t)(batch > 1 ? xbatch : m * ldx) * 2};
  const cuuint32_t box[3] = {64, WG_BK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  static bool ready[64] = {};
  const int rc = allow_smem(gram_bf16_wgmma_kernel<BN>, WG_SMEM, ready);
  if (rc != 0) return rc;
  const int64_t tiles = upper_tiles<BN>(n);
  const dim3 grid((unsigned int)tiles, (unsigned int)splits, (unsigned int)batch);
  gram_bf16_wgmma_kernel<BN><<<grid, WG_THREADS, WG_SMEM, stream>>>(
      map, m, n, rows_per_split, tiles, static_cast<float*>(ws));
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch_xtv_tile(const Operand<T>& u, const Operand<T>& w, int64_t m, int64_t rows_per_split,
                    int splits, int batch, void* part, int64_t rs, int64_t cs, int64_t nc,
                    cudaStream_t stream) {
  const int tiles_u = (u.cols + XT_BM - 1) / XT_BM, tiles_w = (w.cols + BN - 1) / BN;
  const dim3 grid((unsigned int)tiles_u * tiles_w, (unsigned int)splits, (unsigned int)batch);
  constexpr int smem = xt_smem_bytes<T, BN>();
  static bool ready[64] = {};
  const int rc = allow_smem(xtv_tile_kernel<T, BN>, smem, ready);
  if (rc != 0) return rc;
  xtv_tile_kernel<T, BN><<<grid, XT_THREADS, smem, stream>>>(
      u, w, m, rows_per_split, tiles_u, static_cast<typename Acc<T>::type*>(part), rs, cs, nc);
  return (int)cudaGetLastError();
}

// X^T V as a tile product over `batch` elements: U is V and W is X when
// trans (X the narrower), else U is X and W is V; W's tiles are bn wide.
// The partial pass (into out itself with one split) and, with more than
// one split, the reduce pass.
template <typename T>
int xtv_tile_entry(int bn, int trans, int batch, const Operand<T>& xo, const Operand<T>& vo,
                   int64_t m, int64_t rows_per_split, int splits, void* ws, void* out,
                   cudaStream_t st) {
  const Operand<T>& u = trans ? vo : xo;
  const Operand<T>& w = trans ? xo : vo;
  const int64_t n = xo.cols, c = vo.cols;
  const int64_t rs = trans ? 1 : c, cs = trans ? c : 1;
  void* part = splits > 1 ? ws : out;
  int rc;
  switch (bn) {
    case 8: rc = launch_xtv_tile<T, 8>(u, w, m, rows_per_split, splits, batch, part, rs, cs, n * c, st); break;
    case 16: rc = launch_xtv_tile<T, 16>(u, w, m, rows_per_split, splits, batch, part, rs, cs, n * c, st); break;
    case 32: rc = launch_xtv_tile<T, 32>(u, w, m, rows_per_split, splits, batch, part, rs, cs, n * c, st); break;
    case 64: rc = launch_xtv_tile<T, 64>(u, w, m, rows_per_split, splits, batch, part, rs, cs, n * c, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || splits == 1) return rc;
  return launch_xtv_reduce<typename Acc<T>::type>(ws, splits, n * c, out, st, batch);
}

// gram of `batch` elements of X, xbatch elements apart: the partial pass
// and the reduce pass (see repro_gram)
int gram_entry(int dtype, int tile_n, int vec, const void* x, int batch, int64_t xbatch,
               int64_t m, int64_t n, int64_t ldx, int64_t rows_per_split, int splits, void* ws,
               void* out, cudaStream_t st) {
  int rc;
  switch (dtype) {
    case kF64:
      rc = launch_gram_partial<double>(tile_n, vec, x, m, n, ldx, rows_per_split, splits, ws, st,
                                       batch, xbatch);
      break;
    case kF32:
      rc = launch_gram_partial<float>(tile_n, vec, x, m, n, ldx, rows_per_split, splits, ws, st,
                                      batch, xbatch);
      break;
    case kBF16:
      rc = tile_n == 128 ? launch_gram_bf16_wgmma<128>(x, m, n, ldx, rows_per_split, splits, ws,
                                                        st, batch, xbatch)
         : tile_n == 64  ? launch_gram_bf16_wgmma<64>(x, m, n, ldx, rows_per_split, splits, ws,
                                                       st, batch, xbatch)
                         : (int)cudaErrorInvalidValue;
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const bool f64 = dtype == kF64;
  if (tile_n == 128)
    return f64 ? launch_gram_tile_reduce<double, 128, false>(ws, splits, n, out, nullptr, st, batch)
               : launch_gram_tile_reduce<float, 128, false>(ws, splits, n, out, nullptr, st, batch);
  return f64 ? launch_gram_tile_reduce<double, 64, false>(ws, splits, n, out, nullptr, st, batch)
             : launch_gram_tile_reduce<float, 64, false>(ws, splits, n, out, nullptr, st, batch);
}

// X^T v of `batch` elements (X and v xbatch and vbatch elements apart,
// v of one column): the slab kernel's partial pass and, with more than
// one split, the reduce pass (see repro_xtv)
int xtv_entry(int dtype, int vec, const void* x, const void* v, int batch, int64_t xbatch,
              int64_t vbatch, int64_t m, int64_t n, int64_t ldx, int64_t ldv,
              int64_t rows_per_split, int splits, void* ws, void* out, cudaStream_t st) {
  void* part = splits > 1 ? ws : out;
  int rc;
  switch (dtype) {
    case kF64:
      rc = launch_xtv<double>(vec, x, v, m, n, ldx, ldv, rows_per_split, splits, part, st, batch,
                              xbatch, vbatch);
      break;
    case kF32:
      rc = launch_xtv<float>(vec, x, v, m, n, ldx, ldv, rows_per_split, splits, part, st, batch,
                             xbatch, vbatch);
      break;
    case kBF16:
      rc = launch_xtv<__nv_bfloat16>(vec, x, v, m, n, ldx, ldv, rows_per_split, splits, part, st,
                                     batch, xbatch, vbatch);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || splits == 1) return rc;
  return dtype == kF64 ? launch_xtv_reduce<double>(ws, splits, n, out, st, batch)
                       : launch_xtv_reduce<float>(ws, splits, n, out, st, batch);
}

}  // namespace

extern "C" {

// G = X^T X: the partial pass into ws ([splits, tiles, 128, tile_n] of the
// accumulation dtype; rows [s * rows_per_split, (s + 1) * rows_per_split)
// of X go to split s) and the reduce pass into out ([n, n] contiguous),
// both on the stream. vec: X's base and ldx are 16-byte aligned (16-byte
// copies), else element copies.
int repro_gram(int dtype, int tile_n, int vec, const void* x, long long m, long long n,
               long long ldx, long long rows_per_split, int splits, void* ws, void* out,
               void* stream) {
  return gram_entry(dtype, tile_n, vec, x, 1, 0, m, n, ldx, rows_per_split, splits, ws, out,
                    static_cast<cudaStream_t>(stream));
}

// G_b = X_b^T X_b for b < batch, X_b = x + b * xbatch: one partial launch
// over the batch into ws ([batch, splits, tiles, 128, tile_n]) and one
// reduce launch into out ([batch, n, n] contiguous). vec: x, ldx and
// xbatch are 16-byte aligned.
int repro_gram_batched(int dtype, int tile_n, int vec, const void* x, int batch,
                       long long xbatch, long long m, long long n, long long ldx,
                       long long rows_per_split, int splits, void* ws, void* out,
                       void* stream) {
  return gram_entry(dtype, tile_n, vec, x, batch, xbatch, m, n, ldx, rows_per_split, splits, ws,
                    out, static_cast<cudaStream_t>(stream));
}

// X^T v for one column of v (two or more are repro_xtv_tile's): the
// partial pass into ws ([splits, n] of the accumulation dtype) and, with
// more than one split, the reduce pass into out ([n, 1] contiguous); one
// split writes out itself (ws is not read). vec: X's base and ldx are
// 16-byte aligned.
int repro_xtv(int dtype, int vec, const void* x, const void* v, long long m, long long n,
              long long ldx, long long ldv, long long rows_per_split, int splits, void* ws,
              void* out, void* stream) {
  return xtv_entry(dtype, vec, x, v, 1, 0, 0, m, n, ldx, ldv, rows_per_split, splits, ws, out,
                   static_cast<cudaStream_t>(stream));
}

// X_b^T v_b for b < batch, X_b = x + b * xbatch, v_b = v + b * vbatch
// (vbatch 0: one v for every element), v of one column: one partial
// launch over the batch into ws ([batch, splits, n]) and, with more than
// one split, one reduce launch into out ([batch, n, 1] contiguous). vec:
// x, ldx and xbatch are 16-byte aligned.
int repro_xtv_batched(int dtype, int vec, const void* x, const void* v, int batch,
                      long long xbatch, long long vbatch, long long m, long long n,
                      long long ldx, long long ldv, long long rows_per_split, int splits,
                      void* ws, void* out, void* stream) {
  return xtv_entry(dtype, vec, x, v, batch, xbatch, vbatch, m, n, ldx, ldv, rows_per_split,
                   splits, ws, out, static_cast<cudaStream_t>(stream));
}

// X_b^T V_b for b < batch as a tile product (two or more columns of V; see
// xtv_tile_entry): X (m x n, row stride ldx, xbatch apart, xvec: 16-byte
// copies) and V (m x c, row stride ldv, column j at (j / vgw) * vgs + j %
// vgw, vbatch apart, vvec); one partial launch into ws ([batch, splits,
// n, c]) and, with more than one split, one reduce launch into out
// ([batch, n, c] contiguous); one split writes out itself.
int repro_xtv_tile(int dtype, int bn, int trans, int batch, const void* x, long long ldx,
                   long long xbatch, int xvec, const void* v, long long ldv, long long vgw,
                   long long vgs, long long vbatch, int vvec, long long m, long long n,
                   long long c, long long rows_per_split, int splits, void* ws, void* out,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF64: {
      const Operand<double> xo{static_cast<const double*>(x), ldx, 0, xbatch, (int)n, (int)n, xvec};
      const Operand<double> vo{static_cast<const double*>(v), ldv, vgs, vbatch, (int)c, (int)vgw, vvec};
      return xtv_tile_entry(bn, trans, batch, xo, vo, m, rows_per_split, splits, ws, out, st);
    }
    case kF32: {
      const Operand<float> xo{static_cast<const float*>(x), ldx, 0, xbatch, (int)n, (int)n, xvec};
      const Operand<float> vo{static_cast<const float*>(v), ldv, vgs, vbatch, (int)c, (int)vgw, vvec};
      return xtv_tile_entry(bn, trans, batch, xo, vo, m, rows_per_split, splits, ws, out, st);
    }
    case kBF16: {
      using B = __nv_bfloat16;
      const Operand<B> xo{static_cast<const B*>(x), ldx, 0, xbatch, (int)n, (int)n, xvec};
      const Operand<B> vo{static_cast<const B*>(v), ldv, vgs, vbatch, (int)c, (int)vgw, vvec};
      return xtv_tile_entry(bn, trans, batch, xo, vo, m, rows_per_split, splits, ws, out, st);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
