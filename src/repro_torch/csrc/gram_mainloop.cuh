// The gram (tsmm) mainloop shared by gram.cu (dense X^T X) and spmm.cu
// (the block-sparse one): one BM x BN upper-triangle tile of X^T X
// accumulated over a sequence of BK-row stages of X and written to a
// tile-major partial, and the fixed-order pass that sums those partials.
// Also the xtv reduce pass over [splits][n][c] partials that gram.cu's
// xtv and spmm.cu's xtv_bs share.
//
//   * float64 runs on the FP64 tensor cores: mma.sync m16n8k4 f64
//     (wgmma has no f64 form). 8 warps of 64 x 32 (or 32 x 32)
//     outputs, fragments read from shared memory with 64-bit loads
//     (ldmatrix has no 64-bit form); rows are padded to BM + 4 doubles so
//     a warp's fragment loads hit distinct banks.
//   * bfloat16 runs on mma.sync m16n8k16 with float32 accumulation; both
//     operands are MN-major column tiles, loaded with ldmatrix.trans
//     (rows padded by 16 bytes: conflict-free). spmm.cu's block-sparse
//     gram runs this loop; gram.cu's dense bfloat16 gram (lone and
//     batched) runs its own wgmma + TMA mainloop (gram_bf16_wgmma_kernel).
//   * float32 stays on the FMA pipes (TF32 is off for the tolerance and
//     the library yardstick): an 8 x 8 (or 8 x 4) register tile a thread.
// The float64 and bfloat16 fragment steps of one stage (mma_f64_stage,
// mma_bf16_stage) also serve gram.cu's xtv tile product, whose warps own
// other blocks of its narrower tiles.
// Each stage holds BK rows of both column tiles; a 3-stage cp.async ring
// issues the next stage's copies before the current stage is computed.
// Which rows a stage holds is the caller's: gram.cu walks its row range in
// order, spmm.cu only the row chunks its mask populates. Copies are 16
// bytes where the base and the leading dimension allow it (cp.async.cg)
// and one element otherwise (cp.async.ca; a bfloat16 element is copied
// through registers). Ragged edges are zero-filled by the copies
// (src-size), never read and never padded in memory.
//
// The partials are tile-major, [splits][tiles][BM][BN]; gram_tile_reduce
// sums them in split order and writes each upper-triangle element and its
// mirror from the same sum, so G is bitwise symmetric. No atomics. A
// batched call (gram.cu's repro_gram_batched) stacks one such workspace
// and one n x n output per batch element; grid.z walks the batch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

enum DtypeCode : int { kF64 = 0, kF32 = 1, kBF16 = 2 };

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// ---- cp.async --------------------------------------------------------------

// Copy BYTES (4, 8 or 16) to shared memory; bytes past src_bytes are zero.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- tiles -----------------------------------------------------------------

constexpr int GRAM_THREADS = 256;  // 8 warps
constexpr int STAGES = 3;          // depth of the cp.async ring
constexpr int BM = 128;            // output tile rows (columns i of X)
constexpr int F64_BK = 16;         // rows of X per stage, float64
constexpr int F32_BK = 16;
constexpr int BF16_BK = 32;

template <typename T> __host__ __device__ constexpr int stage_rows() {
  return sizeof(T) == 8 ? F64_BK : sizeof(T) == 4 ? F32_BK : BF16_BK;
}

// Upper-triangle tiles of an n x n output in BM x BN tiles: tile row ti
// holds the column tiles tj >= ti * BM / BN. Linear index -> (i0, j0).
template <int BN>
__host__ __device__ __forceinline__ int64_t upper_tiles(int64_t n) {
  constexpr int R = BM / BN;
  const int64_t ti_n = (n + BM - 1) / BM, tj_n = (n + BN - 1) / BN;
  return ti_n * tj_n - R * ti_n * (ti_n - 1) / 2;
}
template <int BN>
__device__ __forceinline__ void upper_tile(int64_t t, int64_t n, int64_t& i0, int64_t& j0) {
  constexpr int R = BM / BN;
  const int64_t tj_n = (n + BN - 1) / BN;
  int64_t ti = 0;
  while (t >= tj_n - ti * R) {
    t -= tj_n - ti * R;
    ++ti;
  }
  i0 = ti * BM;
  j0 = (ti * R + t) * BN;
}

// One stage of one operand: rows [k0, k0 + BK) and columns [c0, c0 + W)
// of X into s (row stride LD), VEC elements a copy. Rows at or past r1 and
// columns at or past n are zero-filled.
template <typename T, int VEC, int BK, int W, int LD>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ x, int64_t ldx,
                                          int64_t k0, int64_t r1, int64_t c0,
                                          int64_t n, int tid) {
  constexpr int CPR = W / VEC, CHUNKS = BK * CPR;
  constexpr int BYTES = VEC * (int)sizeof(T);
#pragma unroll
  for (int q = 0; q < (CHUNKS + GRAM_THREADS - 1) / GRAM_THREADS; ++q) {
    const int e = tid + q * GRAM_THREADS;
    if (CHUNKS % GRAM_THREADS == 0 || e < CHUNKS) {
      const int kk = e / CPR, cc = (e % CPR) * VEC;
      const int64_t row = k0 + kk, col = c0 + cc;
      int valid = 0;
      if (row < r1 && col < n) valid = n - col >= VEC ? VEC : (int)(n - col);
      const T* src = valid ? x + row * ldx + col : x;
      T* dst = s + kk * LD + cc;
      if constexpr (BYTES >= 4) {
        cp_async<BYTES>(dst, src, valid * (int)sizeof(T));
      } else {
        *dst = valid ? *src : zero<T>();
      }
    }
  }
}

// A cp.async ring of NS stages of STAGE elements: load(stage pointer, it)
// issues stage it's copies (of niter), and compute(stage pointer) runs on
// each stage in order while the next NS - 1 stages' copies are in flight.
template <int NS, int STAGE, typename T, typename Load, typename Compute>
__device__ __forceinline__ void cp_ring(T* smem, int niter, Load&& load, Compute&& compute) {
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < niter) load(smem + s * STAGE, s);
    cp_async_commit();
  }
  for (int it = 0; it < niter; ++it) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (it + NS - 1 < niter) load(smem + ((it + NS - 1) % NS) * STAGE, it + NS - 1);
    cp_async_commit();
    compute(smem + (it % NS) * STAGE);
  }
}

// The gram ring: stage `it` (of niter) holds rows [row_of(it), row_of(it) +
// BK) of the i tile (BK x LD) and, unless the j tile lies inside it, of the
// j tile after it; rows at or past r1 are zero. compute(stage pointer)
// runs on each in order.
template <typename T, int BN, int VEC, int BK, int LD, typename RowOf, typename Compute>
__device__ __forceinline__ void gram_ring(T* smem, const T* __restrict__ x, int64_t ldx,
                                          int niter, RowOf&& row_of, int64_t r1, int64_t i0,
                                          int64_t j0, int64_t n, bool share,
                                          Compute&& compute) {
  const int tid = threadIdx.x;
  cp_ring<STAGES, 2 * BK * LD>(
      smem, niter,
      [&](T* s, int it) {
        const int64_t k0 = row_of(it);
        load_tile<T, VEC, BK, BM, LD>(s, x, ldx, k0, r1, i0, n, tid);
        if (!share) load_tile<T, VEC, BK, BN, LD>(s + BK * LD, x, ldx, k0, r1, j0, n, tid);
      },
      compute);
}

// D += A B on the FP64 tensor cores: one m16n8k4 f64 product (m16n8k8 and
// m16n8k16 measured no faster, PERF.md)
__device__ __forceinline__ void mma_f64(double* c, const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

// Warp grid of the tensor-core tiles: 32 output columns a warp.
template <int BN> struct WarpGrid {
  static constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N;
  static constexpr int WM = BM / WARPS_M, MI = WM / 16, NI = 4;
};

// Fragments of mma.m16n8k4.f64 (lane = 4 g + t; CuTe's
// SM90_16x8x4_F64F64F64F64_TN): a = {A(g, t), A(g + 8, t)}, b = B(t, g),
// c = {C(g, 2t), C(g, 2t+1), C(g+8, 2t), C(g+8, 2t+1)}. A stage holds
// rows k of both operands' column tiles: A(m, k) = sa[k LDA + m0 + m] and
// B(k, n) = sb[k LDB + n0 + n]. One stage's products of a warp's MI x NI
// fragments, added into acc (the warp's block of the output tile, its
// origin (m0, n0)); the gram tiles below and gram.cu's xtv tile product
// run it, with their own warp blocks.
template <int BK, int LDA, int LDB, int MI, int NI>
__device__ __forceinline__ void mma_f64_stage(double (&acc)[MI][NI][4],
                                              const double* sa, const double* sb, int m0,
                                              int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 4) {
    const double* ra = sa + (ks + t) * LDA + m0 + g;
    const double* rb = sb + (ks + t) * LDB + n0 + g;
    double a[MI][2], b[NI][1];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      a[mi][0] = ra[mi * 16];
      a[mi][1] = ra[mi * 16 + 8];
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) b[ni][0] = rb[ni * 8];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_f64(acc[mi][ni], a[mi], b[ni]);
  }
}

// The tile functions below take the ring's rows (A(m, k) = X(k, i0 + m),
// B(k, n) = X(k, j0 + n)) and write the BM x BN partial to w.
template <int BN, int VEC, typename RowOf>
__device__ __forceinline__ void gram_f64_tile(const double* __restrict__ x, int64_t ldx,
                                              int64_t n, int64_t i0, int64_t j0, int niter,
                                              RowOf&& row_of, int64_t r1,
                                              double* __restrict__ w) {
  using G = WarpGrid<BN>;
  constexpr int LD = BM + 4, BK = F64_BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const bool share = j0 + BN <= i0 + BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / G::WARPS_N) * G::WM, wn0 = (warp % G::WARPS_N) * 32;
  const int boff = share ? (int)(j0 - i0) : BK * LD;

  double acc[G::MI][G::NI][4];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;

  gram_ring<double, BN, VEC, BK, LD>(
      smem, x, ldx, niter, row_of, r1, i0, j0, n, share, [&](const double* sa) {
        mma_f64_stage<BK, LD, LD>(acc, sa, sa + boff, wm0, wn0);
      });

#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni) {
      const int r = wm0 + mi * 16 + g, c = wn0 + ni * 8 + 2 * t;
      *reinterpret_cast<double2*>(w + r * BN + c) = make_double2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<double2*>(w + (r + 8) * BN + c) =
          make_double2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// mma.m16n8k16 bf16 -> f32: a = {A(g, 2t..), A(g+8, 2t..), A(g, 2t+8..),
// A(g+8, 2t+8..)}, b = {B(2t.., g), B(2t+8.., g)}, c as for f64. A stage
// row is k, so ldmatrix.trans of the 8 x 8 blocks (k, m) gives A's and
// (k, n) gives B's fragments. One stage's products of a warp's MI x NI
// fragments (NI one, or even: B's fragments come two at a time), as
// mma_f64_stage.
template <int BK, int LDA, int LDB, int MI, int NI>
__device__ __forceinline__ void mma_bf16_stage(float (&acc)[MI][NI][4],
                                               const __nv_bfloat16* sa,
                                               const __nv_bfloat16* sb, int m0, int n0) {
  static_assert(NI == 1 || NI % 2 == 0, "B's fragments two at a time");
  const int lane = threadIdx.x & 31, li = lane >> 3, lr = lane & 7;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[MI][4], b[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldsm_x4_trans(a[mi], sa + (ks + lr + 8 * (li >> 1)) * LDA + m0 + mi * 16 + 8 * (li & 1));
    if constexpr (NI == 1) {
      ldsm_x2_trans(b[0], sb + (ks + lr + 8 * (li & 1)) * LDB + n0);
    } else {
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t r4[4];
        ldsm_x4_trans(r4, sb + (ks + lr + 8 * (li & 1)) * LDB + n0 + np * 16 + 8 * (li >> 1));
        b[2 * np][0] = r4[0];
        b[2 * np][1] = r4[1];
        b[2 * np + 1][0] = r4[2];
        b[2 * np + 1][1] = r4[3];
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        float* c = acc[mi][ni];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]), "r"(b[ni][0]),
              "r"(b[ni][1]));
      }
  }
}

template <int BN, int VEC, typename RowOf>
__device__ __forceinline__ void gram_bf16_tile(const __nv_bfloat16* __restrict__ x, int64_t ldx,
                                               int64_t n, int64_t i0, int64_t j0, int niter,
                                               RowOf&& row_of, int64_t r1,
                                               float* __restrict__ w) {
  using G = WarpGrid<BN>;
  constexpr int LD = BM + 8, BK = BF16_BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const bool share = j0 + BN <= i0 + BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / G::WARPS_N) * G::WM, wn0 = (warp % G::WARPS_N) * 32;
  const int boff = share ? (int)(j0 - i0) : BK * LD;

  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  gram_ring<__nv_bfloat16, BN, VEC, BK, LD>(
      smem, x, ldx, niter, row_of, r1, i0, j0, n, share, [&](const __nv_bfloat16* sa) {
        mma_bf16_stage<BK, LD, LD>(acc, sa, sa + boff, wm0, wn0);
      });

#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni) {
      const int r = wm0 + mi * 16 + g, c = wn0 + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(w + r * BN + c) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(w + (r + 8) * BN + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// float32 on the FMA pipes: thread (ty, tx) of a 16 x 16 grid owns rows
// gm * 64 + 4 ty + [0, 4) and columns gn * 64 + 4 tx + [0, 4), read from a
// stage with 16-byte shared loads.
template <int BN, int VEC, typename RowOf>
__device__ __forceinline__ void gram_f32_tile(const float* __restrict__ x, int64_t ldx,
                                              int64_t n, int64_t i0, int64_t j0, int niter,
                                              RowOf&& row_of, int64_t r1,
                                              float* __restrict__ w) {
  constexpr int LD = BM + 4, BK = F32_BK, GM = BM / 64, GN = BN / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const bool share = j0 + BN <= i0 + BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int boff = share ? (int)(j0 - i0) : BK * LD;

  float acc[4 * GM][4 * GN];
#pragma unroll
  for (int r = 0; r < 4 * GM; ++r)
#pragma unroll
    for (int c = 0; c < 4 * GN; ++c) acc[r][c] = 0.f;

  gram_ring<float, BN, VEC, BK, LD>(
      smem, x, ldx, niter, row_of, r1, i0, j0, n, share, [&](const float* sa) {
        const float* sb = sa + boff;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[4 * GM], b[4 * GN];
#pragma unroll
          for (int q = 0; q < GM; ++q) {
            const float4 va = *reinterpret_cast<const float4*>(sa + kk * LD + q * 64 + 4 * ty);
            a[4 * q] = va.x; a[4 * q + 1] = va.y; a[4 * q + 2] = va.z; a[4 * q + 3] = va.w;
          }
#pragma unroll
          for (int q = 0; q < GN; ++q) {
            const float4 vb = *reinterpret_cast<const float4*>(sb + kk * LD + q * 64 + 4 * tx);
            b[4 * q] = vb.x; b[4 * q + 1] = vb.y; b[4 * q + 2] = vb.z; b[4 * q + 3] = vb.w;
          }
#pragma unroll
          for (int r = 0; r < 4 * GM; ++r)
#pragma unroll
            for (int c = 0; c < 4 * GN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
      });

#pragma unroll
  for (int r = 0; r < 4 * GM; ++r)
#pragma unroll
    for (int q = 0; q < GN; ++q) {
      const int row = (r / 4) * 64 + 4 * ty + r % 4, col = q * 64 + 4 * tx;
      *reinterpret_cast<float4*>(w + row * BN + col) =
          make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2], acc[r][4 * q + 3]);
    }
}

// The tile function of X's dtype.
template <typename T, int BN, int VEC, typename RowOf>
__device__ __forceinline__ void gram_tile(const T* __restrict__ x, int64_t ldx, int64_t n,
                                          int64_t i0, int64_t j0, int niter, RowOf&& row_of,
                                          int64_t r1, typename Acc<T>::type* __restrict__ w) {
  if constexpr (sizeof(T) == 8)
    gram_f64_tile<BN, VEC>(x, ldx, n, i0, j0, niter, row_of, r1, w);
  else if constexpr (sizeof(T) == 4)
    gram_f32_tile<BN, VEC>(x, ldx, n, i0, j0, niter, row_of, r1, w);
  else
    gram_bf16_tile<BN, VEC>(x, ldx, n, i0, j0, niter, row_of, r1, w);
}

// Dynamic shared memory of a tile's ring.
template <typename T>
constexpr int gram_smem_bytes() {
  constexpr int LD = BM + (sizeof(T) == 2 ? 8 : 4);
  return STAGES * 2 * stage_rows<T>() * LD * (int)sizeof(T);
}

// Epilogue pass over the tile-major workspace: one block per 32 x 32
// block of an upper tile sums its split partials in split order, writes
// the elements with i <= j and, through shared memory, their mirrors
// (both coalesced). A thread sums 4 rows, loading 8 splits of each ahead
// of the adds, so a long split list is not one load latency a split.
// FILLED: only the splits whose filled[tile * splits + split] is nonzero
// wrote a partial (the others hold only zeros, which add nothing); the
// block sums those, LIST at a time, still in split order. blockIdx.z is
// the batch element (workspace and output offset by whole ones; each
// element's sum is the lone call's, in the same order).
template <typename A, int BN, bool FILLED>
__global__ void __launch_bounds__(256)
gram_tile_reduce_kernel(const A* __restrict__ ws, int splits, int64_t tiles, int64_t n,
                        A* __restrict__ out, const int32_t* __restrict__ filled) {
  constexpr int R = 4, U = 8, LIST = FILLED ? 1024 : 1;
  __shared__ A sub[32][33];
  __shared__ int list[LIST];
  __shared__ int warp_n[8];
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const int sr = blockIdx.y / (BN / 32), sc = blockIdx.y % (BN / 32);
  const int64_t ib = i0 + sr * 32, jb = j0 + sc * 32;
  if (ib >= n || jb >= n || ib > jb + 31) return;  // uniform over the block
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int64_t stride = tiles * BM * BN;
  ws += (int64_t)blockIdx.z * splits * stride;
  out += (int64_t)blockIdx.z * n * n;
  const A* w = ws + blockIdx.x * (int64_t)(BM * BN) + (sr * 32 + ty) * BN + sc * 32 + tx;
  A s[R];
  if constexpr (!FILLED) {
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = w[r * 8 * BN];
    int p = 1;
    for (; p + U <= splits; p += U) {
      A t[R][U];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u) t[r][u] = w[(p + u) * stride + r * 8 * BN];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u) s[r] += t[r][u];
    }
    for (; p < splits; ++p)
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += w[p * stride + r * 8 * BN];
  } else {
    // s starts at +0: the first filled partial adds to it exactly (a
    // partial is never -0: its sums start at +0)
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = A(0);
    const int32_t* f = filled + blockIdx.x * (int64_t)splits;
    for (int base = 0; base < splits; base += LIST) {
      // the filled splits of [base, base + LIST), in order
      int count = 0;
      for (int b0 = base; b0 < min(splits, base + LIST); b0 += 256) {
        const int p = b0 + threadIdx.x;
        const bool on = p < min(splits, base + LIST) && f[p] != 0;
        const unsigned bits = __ballot_sync(0xffffffffu, on);
        __syncthreads();  // the previous round's warp_n is read
        if (tx == 0) warp_n[ty] = __popc(bits);
        __syncthreads();
        int off = count;
        for (int q = 0; q < ty; ++q) off += warp_n[q];
        if (on) list[off + __popc(bits & ((1u << tx) - 1u))] = p;
        for (int q = 0; q < 8; ++q) count += warp_n[q];
      }
      __syncthreads();
      int q = 0;
      for (; q + U <= count; q += U) {
        A t[R][U];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int u = 0; u < U; ++u) t[r][u] = w[list[q + u] * stride + r * 8 * BN];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int u = 0; u < U; ++u) s[r] += t[r][u];
      }
      for (; q < count; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] += w[list[q] * stride + r * 8 * BN];
      __syncthreads();  // list is read before the next window writes it
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rr = ty + 8 * r;
    sub[rr][tx] = s[r];
    const int64_t i = ib + rr, j = jb + tx;
    if (i <= j && j < n) out[i * n + j] = s[r];
  }
  __syncthreads();
  for (int rr = ty; rr < 32; rr += 8) {
    const int64_t j = jb + rr, i = ib + tx;
    if (i < j && j < n) out[j * n + i] = sub[tx][rr];
  }
}

// The xtv reduce (gram.cu's xtv and spmm.cu's xtv_bs): out[i] = the sum
// of ws[p][i] over the splits p, in a fixed order that depends on the
// split count alone: the splits in groups of XR_GROUP consecutive ones,
// each group summed in split order (one group: the plain split-order
// sum), warp w of a block adding groups w, w + 8, ... in order, and the
// warps' sums added in warp order. A block takes 32 outputs; a thread
// loads a group's splits ahead of their adds, so a long split list costs
// a few load latencies, not one a split. blockIdx.y is the batch element
// of a batched call ([batch][splits][nc] partials, [batch][nc] out).
constexpr int XR_GROUP = 16;

template <typename A>
__global__ void __launch_bounds__(256)
xtv_reduce_kernel(const A* __restrict__ ws, int splits, int64_t nc, A* __restrict__ out) {
  __shared__ A red[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t idx = (int64_t)blockIdx.x * 32 + lane;
  ws += (int64_t)blockIdx.y * splits * nc;
  out += (int64_t)blockIdx.y * nc;
  const int groups = (splits + XR_GROUP - 1) / XR_GROUP;
  A s = A(0);
  if (idx < nc) {
    for (int g = warp; g < groups; g += 8) {
      const int p0 = g * XR_GROUP, np = min(XR_GROUP, splits - p0);
      A t[XR_GROUP];
#pragma unroll
      for (int u = 0; u < XR_GROUP; ++u)
        t[u] = u < np ? ws[(int64_t)(p0 + u) * nc + idx] : A(0);
      A gs = t[0];
#pragma unroll
      for (int u = 1; u < XR_GROUP; ++u)
        if (u < np) gs += t[u];
      s = g == warp ? gs : s + gs;
    }
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && idx < nc) {
    for (int w = 1; w < min(8, groups); ++w) s += red[w][lane];
    out[idx] = s;
  }
}

inline unsigned int blocks_for(int64_t items, int threads) {
  return (unsigned int)((items + threads - 1) / threads);
}

template <typename A>
int launch_xtv_reduce(const void* ws, int splits, int64_t nc, void* out, cudaStream_t st,
                      int batch = 1) {
  const dim3 grid(blocks_for(nc, 32), (unsigned int)batch);
  xtv_reduce_kernel<A><<<grid, 256, 0, st>>>(static_cast<const A*>(ws), splits, nc,
                                             static_cast<A*>(out));
  return (int)cudaGetLastError();
}

template <typename A, int BN, bool FILLED>
int launch_gram_tile_reduce(const void* ws, int splits, int64_t n, void* out,
                            const int32_t* filled, cudaStream_t stream, int batch = 1) {
  const int64_t tiles = upper_tiles<BN>(n);
  const dim3 grid((unsigned int)tiles, (BM / 32) * (BN / 32), (unsigned int)batch);
  gram_tile_reduce_kernel<A, BN, FILLED><<<grid, 256, 0, stream>>>(
      static_cast<const A*>(ws), splits, tiles, n, static_cast<A*>(out), filled);
  return (int)cudaGetLastError();
}

// Set the dynamic shared memory of `kernel` to `bytes` (above 48 KB needs
// the attribute), once per kernel and device; `ready` is the kernel's own
// flags.
template <typename K>
int allow_smem(K kernel, int bytes, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  return 0;
}

}  // namespace
