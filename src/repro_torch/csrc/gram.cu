// Gram (tsmm) kernel family for Hopper (sm_90a): G = X^T X and X^T v.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gram/kernel.py:
//   * gram_{f64,bf16,f32}_partial_kernel + gram_tile_reduce_kernel
//                                            <- gram_pallas (_gram_kernel)
//   * xtv_slab_kernel + xtv_reduce_kernel    <- xtv_pallas  (_xtv_kernel)
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
// columns lie inside its rows' columns (the diagonal) loads X once.
//   * float64 runs on the FP64 tensor cores: mma.sync m16n8k4 f64
//     (wgmma has no f64 form). 8 warps of 64 x 32 (or 32 x 32)
//     outputs, fragments read from shared memory with 64-bit loads
//     (ldmatrix has no 64-bit form); rows are padded to BM + 4 doubles so
//     a warp's fragment loads hit distinct banks.
//   * bfloat16 runs on mma.sync m16n8k16 with float32 accumulation; both
//     operands are MN-major column tiles, loaded with ldmatrix.trans
//     (rows padded by 16 bytes: conflict-free).
//   * float32 stays on the FMA pipes (TF32 is off for the tolerance and
//     the library yardstick): an 8 x 8 (or 8 x 4) register tile a thread.
// Each stage holds BK rows of both column tiles; a 3-stage cp.async ring
// issues the next stage's copies before the current stage is computed.
// Copies are 16 bytes where the base and the leading dimension allow it
// (cp.async.cg) and one element otherwise (cp.async.ca; a bfloat16
// element is copied through registers): the wrapper chooses by pointer
// and stride, since a column slice keeps its parent's leading dimension
// and odd widths give 8-byte-aligned rows. Ragged edges are zero-filled
// by the copies (src-size), never read and never padded in memory.
// The partials go to a tile-major workspace [splits][tiles][BM][BN]; a
// second pass sums them in split order and writes each upper-triangle
// element and its mirror from the same sum, so G is bitwise symmetric.
//
// xtv is bound by bytes (it reads X once; c = 1 in lmDS). Each lane
// loads 16 bytes of a row (two float64 columns), so a warp covers a slab
// of 32 x 16 bytes of every row it reads, with XTV_UNROLL independent row
// loads in flight a thread; elements of v are read as a broadcast. The 8
// warps of a block split its rows and sum their partials in shared memory
// in warp order; blocks split the rows into a few splits of hundreds of
// KB each, which a second pass sums in split order.
//
// Neither uses atomics: results are bitwise reproducible from run to run
// (the wrapper's plan depends only on the shape and the card).
//
// Interface: plain C entry points for ctypes. Each takes device pointers,
// sizes, leading dimensions and the CUDA stream, launches its kernels on
// that stream (repro_gram and repro_xtv: the partial and the reduce pass,
// one host call for both, since the host's time per call sets xtv's),
// never synchronises or allocates (the Python wrapper owns every buffer),
// and returns the first launch error. repro_gram_reduce and
// repro_xtv_reduce reduce the block-sparse kernels' partials
// (kernels/spmm/ops.py) in their layout: [splits, n, n] / [splits, n, c].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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

// ---- gram ------------------------------------------------------------------

constexpr int GRAM_THREADS = 256;  // 8 warps
constexpr int STAGES = 3;          // depth of the cp.async ring
constexpr int BM = 128;            // output tile rows (columns i of X)
constexpr int F64_BK = 16;         // rows of X per stage, float64
constexpr int F32_BK = 16;
constexpr int BF16_BK = 32;

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

// The ring shared by the three partial kernels: stage `it` holds rows
// [r0 + it * BK, ...) of the i tile (BK x LD) and, unless the j tile lies
// inside it, of the j tile after it. compute(stage pointer) runs on each.
template <typename T, int BN, int VEC, int BK, int LD, typename Compute>
__device__ __forceinline__ void gram_ring(T* smem, const T* __restrict__ x, int64_t ldx,
                                          int64_t r0, int64_t r1, int64_t i0, int64_t j0,
                                          int64_t n, bool share, Compute&& compute) {
  constexpr int STAGE = 2 * BK * LD;
  const int tid = threadIdx.x;
  const int niter = (int)((r1 - r0 + BK - 1) / BK);
  auto load = [&](int it) {
    T* s = smem + (it % STAGES) * STAGE;
    const int64_t k0 = r0 + (int64_t)it * BK;
    load_tile<T, VEC, BK, BM, LD>(s, x, ldx, k0, r1, i0, n, tid);
    if (!share) load_tile<T, VEC, BK, BN, LD>(s + BK * LD, x, ldx, k0, r1, j0, n, tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < niter) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < niter; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < niter) load(it + STAGES - 1);
    cp_async_commit();
    compute(smem + (it % STAGES) * STAGE);
  }
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

// Warp grid of the tensor-core kernels: 32 output columns a warp.
template <int BN> struct WarpGrid {
  static constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N;
  static constexpr int WM = BM / WARPS_M, MI = WM / 16, NI = 4;
};

// Fragments of mma.m16n8k4.f64 (lane = 4 g + t; CuTe's
// SM90_16x8x4_F64F64F64F64_TN): a = {A(g, t), A(g + 8, t)}, b = B(t, g),
// c = {C(g, 2t), C(g, 2t+1), C(g+8, 2t), C(g+8, 2t+1)}. A(m, k) =
// X(k, i0 + m) and B(k, n) = X(k, j0 + n): both are read from row k of a
// stage.
template <int BN, int VEC>
__global__ void __launch_bounds__(GRAM_THREADS, 1)
gram_f64_partial_kernel(const double* __restrict__ x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int64_t tiles, double* __restrict__ ws) {
  using G = WarpGrid<BN>;
  constexpr int LD = BM + 4, BK = F64_BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const bool share = j0 + BN <= i0 + BM;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
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
      smem, x, ldx, r0, r1, i0, j0, n, share, [&](const double* sa) {
        const double* sb = sa + boff;
#pragma unroll
        for (int ks = 0; ks < BK; ks += 4) {
          const double* ra = sa + (ks + t) * LD + wm0 + g;
          const double* rb = sb + (ks + t) * LD + wn0 + g;
          double a[G::MI][2], b[G::NI][1];
#pragma unroll
          for (int mi = 0; mi < G::MI; ++mi) {
            a[mi][0] = ra[mi * 16];
            a[mi][1] = ra[mi * 16 + 8];
          }
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) b[ni][0] = rb[ni * 8];
#pragma unroll
          for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < G::NI; ++ni) mma_f64(acc[mi][ni], a[mi], b[ni]);
        }
      });

  double* w = ws + ((int64_t)blockIdx.y * tiles + blockIdx.x) * (BM * BN);
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

// mma.m16n8k16 bf16 -> f32: a = {A(g, 2t..), A(g+8, 2t..), A(g, 2t+8..),
// A(g+8, 2t+8..)}, b = {B(2t.., g), B(2t+8.., g)}, c as for f64. A stage
// row is k, so ldmatrix.trans of the 8 x 8 blocks (k, m) gives A's and
// (k, n) gives B's fragments.
template <int BN, int VEC>
__global__ void __launch_bounds__(GRAM_THREADS, 1)
gram_bf16_partial_kernel(const __nv_bfloat16* __restrict__ x, int64_t m, int64_t n,
                         int64_t ldx, int64_t rows_per_split, int64_t tiles,
                         float* __restrict__ ws) {
  using G = WarpGrid<BN>;
  constexpr int LD = BM + 8, BK = BF16_BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const bool share = j0 + BN <= i0 + BM;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, li = lane >> 3, lr = lane & 7;
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
      smem, x, ldx, r0, r1, i0, j0, n, share, [&](const __nv_bfloat16* sa) {
        const __nv_bfloat16* sb = sa + boff;
#pragma unroll
        for (int ks = 0; ks < BK; ks += 16) {
          uint32_t a[G::MI][4], b[G::NI][2];
#pragma unroll
          for (int mi = 0; mi < G::MI; ++mi)
            ldsm_x4_trans(a[mi], sa + (ks + lr + 8 * (li >> 1)) * LD + wm0 + mi * 16 +
                                     8 * (li & 1));
#pragma unroll
          for (int np = 0; np < G::NI / 2; ++np) {
            uint32_t r4[4];
            ldsm_x4_trans(r4, sb + (ks + lr + 8 * (li & 1)) * LD + wn0 + np * 16 +
                                  8 * (li >> 1));
            b[2 * np][0] = r4[0];
            b[2 * np][1] = r4[1];
            b[2 * np + 1][0] = r4[2];
            b[2 * np + 1][1] = r4[3];
          }
#pragma unroll
          for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < G::NI; ++ni) {
              float* c = acc[mi][ni];
              asm volatile(
                  "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                  "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                  : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                  : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]),
                    "r"(b[ni][0]), "r"(b[ni][1]));
            }
        }
      });

  float* w = ws + ((int64_t)blockIdx.y * tiles + blockIdx.x) * (BM * BN);
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
template <int BN, int VEC>
__global__ void __launch_bounds__(GRAM_THREADS)
gram_f32_partial_kernel(const float* __restrict__ x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int64_t tiles, float* __restrict__ ws) {
  constexpr int LD = BM + 4, BK = F32_BK, GM = BM / 64, GN = BN / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const bool share = j0 + BN <= i0 + BM;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int boff = share ? (int)(j0 - i0) : BK * LD;

  float acc[4 * GM][4 * GN];
#pragma unroll
  for (int r = 0; r < 4 * GM; ++r)
#pragma unroll
    for (int c = 0; c < 4 * GN; ++c) acc[r][c] = 0.f;

  gram_ring<float, BN, VEC, BK, LD>(
      smem, x, ldx, r0, r1, i0, j0, n, share, [&](const float* sa) {
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

  float* w = ws + ((int64_t)blockIdx.y * tiles + blockIdx.x) * (BM * BN);
#pragma unroll
  for (int r = 0; r < 4 * GM; ++r)
#pragma unroll
    for (int q = 0; q < GN; ++q) {
      const int row = (r / 4) * 64 + 4 * ty + r % 4, col = q * 64 + 4 * tx;
      *reinterpret_cast<float4*>(w + row * BN + col) =
          make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2], acc[r][4 * q + 3]);
    }
}

// Epilogue pass over the tile-major workspace: one block per 32 x 32
// block of an upper tile sums its split partials in split order, writes
// the elements with i <= j and, through shared memory, their mirrors
// (both coalesced). A thread sums 4 rows, loading 8 splits of each ahead
// of the adds, so a long split list is not one load latency a split.
template <typename A, int BN>
__global__ void __launch_bounds__(256)
gram_tile_reduce_kernel(const A* __restrict__ ws, int splits, int64_t tiles, int64_t n,
                        A* __restrict__ out) {
  constexpr int R = 4, U = 8;
  __shared__ A sub[32][33];
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const int sr = blockIdx.y / (BN / 32), sc = blockIdx.y % (BN / 32);
  const int64_t ib = i0 + sr * 32, jb = j0 + sc * 32;
  if (ib >= n || jb >= n || ib > jb + 31) return;  // uniform over the block
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int64_t stride = tiles * BM * BN;
  const A* w = ws + blockIdx.x * (int64_t)(BM * BN) + (sr * 32 + ty) * BN + sc * 32 + tx;
  A s[R];
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

// Epilogue pass of the block-sparse gram (spmm.cu's [splits, n, n]
// partials): sum every upper-triangle element in split order and write it
// and its mirror.
template <typename A>
__global__ void gram_reduce_kernel(const A* __restrict__ ws, int splits, int64_t n,
                                   A* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * n) return;
  const int64_t i = idx / n, j = idx % n;
  if (i > j) return;
  A s = ws[idx];
  for (int p = 1; p < splits; ++p) s += ws[(int64_t)p * n * n + idx];
  out[i * n + j] = s;
  out[j * n + i] = s;
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
// range, warp w taking rows r0 + w, r0 + w + 8, ...; XC columns of v a
// pass. VEC: lane l loads columns [l P, l P + P) with one 16-byte load;
// otherwise columns l + 32 p, one element a load.
template <typename T, bool VEC, int XC>
__global__ void __launch_bounds__(XTV_THREADS)
xtv_slab_kernel(const T* __restrict__ x, const T* __restrict__ v, int64_t m, int64_t n,
                int64_t c, int64_t ldx, int64_t ldv, int64_t rows_per_split,
                typename Acc<T>::type* __restrict__ ws) {
  using A = typename Acc<T>::type;
  constexpr int P = 16 / (int)sizeof(T), SLAB = 32 * P, WARPS = XTV_THREADS / 32;
  __shared__ A red[WARPS][SLAB * XC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t j0 = (int64_t)blockIdx.x * SLAB;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  auto local = [&](int p) { return VEC ? lane * P + p : lane + 32 * p; };
  const bool full = VEC && j0 + (lane + 1) * P <= n;

  for (int64_t c0 = 0; c0 < c; c0 += XC) {
    const int nc = (int)min64(XC, c - c0);
    A acc[P][XC];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < XC; ++q) acc[p][q] = A(0);
    for (int64_t k = r0 + warp; k < r1; k += WARPS * XTV_UNROLL) {
      T xr[XTV_UNROLL][P];
      A vr[XTV_UNROLL][XC];
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
#pragma unroll
        for (int q = 0; q < XC; ++q)
          vr[u][q] = (rok && q < nc) ? to_acc(v[kk * ldv + c0 + q]) : A(0);
      }
#pragma unroll
      for (int u = 0; u < XTV_UNROLL; ++u)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int q = 0; q < XC; ++q) acc[p][q] = madd(to_acc(xr[u][p]), vr[u][q], acc[p][q]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < XC; ++q) red[warp][local(p) * XC + q] = acc[p][q];
    __syncthreads();
    for (int e = threadIdx.x; e < SLAB * XC; e += XTV_THREADS) {
      const int64_t j = j0 + e / XC;
      const int q = e % XC;
      if (j < n && q < nc) {
        A s = red[0][e];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += red[w][e];
        ws[((int64_t)blockIdx.y * n + j) * c + c0 + q] = s;
      }
    }
    __syncthreads();
  }
}

template <typename A>
__global__ void xtv_reduce_kernel(const A* __restrict__ ws, int splits, int64_t nc,
                                  A* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nc) return;
  A s = ws[idx];
  for (int p = 1; p < splits; ++p) s += ws[(int64_t)p * nc + idx];
  out[idx] = s;
}

constexpr int REDUCE_THREADS = 256;

inline unsigned int blocks_for(int64_t items, int threads) {
  return (unsigned int)((items + threads - 1) / threads);
}

template <typename T, int BK, int LD>
constexpr int gram_smem_bytes() {
  return STAGES * 2 * BK * LD * (int)sizeof(T);
}

template <typename T, int BN, int VEC>
int launch_gram_partial(const void* x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int splits, void* ws, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int64_t tiles = upper_tiles<BN>(n);
  const dim3 grid((unsigned int)tiles, (unsigned int)splits);
  void (*kernel)(const T*, int64_t, int64_t, int64_t, int64_t, int64_t, A*);
  int smem;
  if constexpr (sizeof(T) == 8) {
    kernel = gram_f64_partial_kernel<BN, VEC>;
    smem = gram_smem_bytes<double, F64_BK, BM + 4>();
  } else if constexpr (sizeof(T) == 4) {
    kernel = gram_f32_partial_kernel<BN, VEC>;
    smem = gram_smem_bytes<float, F32_BK, BM + 4>();
  } else {
    kernel = gram_bf16_partial_kernel<BN, VEC>;
    smem = gram_smem_bytes<__nv_bfloat16, BF16_BK, BM + 8>();
  }
  // above 48 KB of dynamic shared memory needs the attribute, set once
  // per instantiation and device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  kernel<<<grid, GRAM_THREADS, smem, stream>>>(static_cast<const T*>(x), m, n, ldx,
                                               rows_per_split, tiles, static_cast<A*>(ws));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gram_partial(int tile_n, int vec, const void* x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int splits, void* ws, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  if (tile_n == 128)
    return vec ? launch_gram_partial<T, 128, V>(x, m, n, ldx, rows_per_split, splits, ws, stream)
               : launch_gram_partial<T, 128, 1>(x, m, n, ldx, rows_per_split, splits, ws, stream);
  if (tile_n == 64)
    return vec ? launch_gram_partial<T, 64, V>(x, m, n, ldx, rows_per_split, splits, ws, stream)
               : launch_gram_partial<T, 64, 1>(x, m, n, ldx, rows_per_split, splits, ws, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename A, int BN>
int launch_gram_tile_reduce(const void* ws, int splits, int64_t n, void* out,
                            cudaStream_t stream) {
  const int64_t tiles = upper_tiles<BN>(n);
  const dim3 grid((unsigned int)tiles, (BM / 32) * (BN / 32));
  gram_tile_reduce_kernel<A, BN><<<grid, 256, 0, stream>>>(
      static_cast<const A*>(ws), splits, tiles, n, static_cast<A*>(out));
  return (int)cudaGetLastError();
}

template <typename T, bool VEC, int XC>
int launch_xtv(const void* x, const void* v, int64_t m, int64_t n, int64_t c, int64_t ldx,
               int64_t ldv, int64_t rows_per_split, int splits, void* ws,
               cudaStream_t stream) {
  constexpr int SLAB = 32 * 16 / (int)sizeof(T);
  const dim3 grid(blocks_for(n, SLAB), (unsigned int)splits);
  xtv_slab_kernel<T, VEC, XC><<<grid, XTV_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), m, n, c, ldx, ldv, rows_per_split,
      static_cast<typename Acc<T>::type*>(ws));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_xtv(int vec, const void* x, const void* v, int64_t m, int64_t n, int64_t c,
               int64_t ldx, int64_t ldv, int64_t rows_per_split, int splits, void* ws,
               cudaStream_t stream) {
  if (c == 1)
    return vec ? launch_xtv<T, true, 1>(x, v, m, n, c, ldx, ldv, rows_per_split, splits, ws, stream)
               : launch_xtv<T, false, 1>(x, v, m, n, c, ldx, ldv, rows_per_split, splits, ws, stream);
  return vec ? launch_xtv<T, true, 4>(x, v, m, n, c, ldx, ldv, rows_per_split, splits, ws, stream)
             : launch_xtv<T, false, 4>(x, v, m, n, c, ldx, ldv, rows_per_split, splits, ws, stream);
}

template <typename A>
int launch_reduce(bool gram, const void* ws, int splits, int64_t items, void* out,
                  cudaStream_t st) {
  if (gram) {
    gram_reduce_kernel<A><<<blocks_for(items * items, REDUCE_THREADS), REDUCE_THREADS, 0, st>>>(
        static_cast<const A*>(ws), splits, items, static_cast<A*>(out));
  } else {
    xtv_reduce_kernel<A><<<blocks_for(items, REDUCE_THREADS), REDUCE_THREADS, 0, st>>>(
        static_cast<const A*>(ws), splits, items, static_cast<A*>(out));
  }
  return (int)cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF64:
      rc = launch_gram_partial<double>(tile_n, vec, x, m, n, ldx, rows_per_split, splits, ws, st);
      break;
    case kF32:
      rc = launch_gram_partial<float>(tile_n, vec, x, m, n, ldx, rows_per_split, splits, ws, st);
      break;
    case kBF16:
      rc = launch_gram_partial<__nv_bfloat16>(tile_n, vec, x, m, n, ldx, rows_per_split, splits,
                                              ws, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const bool f64 = dtype == kF64;
  if (tile_n == 128)
    return f64 ? launch_gram_tile_reduce<double, 128>(ws, splits, n, out, st)
               : launch_gram_tile_reduce<float, 128>(ws, splits, n, out, st);
  return f64 ? launch_gram_tile_reduce<double, 64>(ws, splits, n, out, st)
             : launch_gram_tile_reduce<float, 64>(ws, splits, n, out, st);
}

// acc_dtype: kF64 or kF32; ws: [splits, n, n] (the block-sparse gram's
// partials); out: [n, n] contiguous.
int repro_gram_reduce(int acc_dtype, const void* ws, int splits, long long n, void* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acc_dtype == kF64) return launch_reduce<double>(true, ws, splits, n, out, st);
  if (acc_dtype == kF32) return launch_reduce<float>(true, ws, splits, n, out, st);
  return (int)cudaErrorInvalidValue;
}

// X^T v: the partial pass into ws ([splits, n, c] of the accumulation
// dtype) and, with more than one split, the reduce pass into out ([n, c]
// contiguous); one split writes out itself (ws is not read). vec: X's
// base and ldx are 16-byte aligned.
int repro_xtv(int dtype, int vec, const void* x, const void* v, long long m, long long n,
              long long c, long long ldx, long long ldv, long long rows_per_split, int splits,
              void* ws, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* part = splits > 1 ? ws : out;
  int rc;
  switch (dtype) {
    case kF64:
      rc = launch_xtv<double>(vec, x, v, m, n, c, ldx, ldv, rows_per_split, splits, part, st);
      break;
    case kF32:
      rc = launch_xtv<float>(vec, x, v, m, n, c, ldx, ldv, rows_per_split, splits, part, st);
      break;
    case kBF16:
      rc = launch_xtv<__nv_bfloat16>(vec, x, v, m, n, c, ldx, ldv, rows_per_split, splits, part,
                                     st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || splits == 1) return rc;
  return dtype == kF64 ? launch_reduce<double>(false, ws, splits, n * c, out, st)
                       : launch_reduce<float>(false, ws, splits, n * c, out, st);
}

// acc_dtype: kF64 or kF32; ws: [splits, n, c] (the block-sparse xtv's
// partials); out: [n, c] contiguous (nc = n * c elements).
int repro_xtv_reduce(int acc_dtype, const void* ws, int splits, long long nc, void* out,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acc_dtype == kF64) return launch_reduce<double>(false, ws, splits, nc, out, st);
  if (acc_dtype == kF32) return launch_reduce<float>(false, ws, splits, nc, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
