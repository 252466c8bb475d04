// Block-sparse gram / SpMM / xtv for Hopper (sm_90a), over a dense layout of
// a sparse X and a mask of its nonzero blocks.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/spmm/kernel.py:
//   * gram_bs_partial_kernel (+ gram.cu's gram_reduce_kernel)
//                                <- gram_block_sparse (_gram_kernel)
//   * spmm_kernel                <- spmm_block_sparse (_spmm_kernel)
//   * xtv_bs_partial_kernel  (+ gram.cu's xtv_reduce_kernel)
//                                <- xtv_block_sparse  (_xtv_kernel)
//
// The mask belongs to this card's tiles, not the TPU's: mask[r * mask_cols + t]
// is the int32 count of nonzeros in the block of X at row chunk r (RC = 256
// rows) and column tile t (BN = 64 columns, the gram output tile edge of
// gram.cu); the last chunk and tile may be ragged. The wrapper
// (kernels/spmm/ops.py) counts it from the BCOO indices, so nothing scans the
// dense copy. A block whose count is 0 holds only zeros, so every term it
// would add is an exact zero: skipping it changes no bit of the result. A
// kernel run with the true mask is therefore bitwise equal to the same kernel
// run with an all-ones mask (same split plan), which is what the on-card
// check holds it to.
//
// What bounds them on this card, and what the design does about it:
//   * gram_bs is bound by operations in float64, counted over the populated
//     blocks only. It is gram.cu's design (upper-triangle BN x BN output
//     tiles in registers, X streamed through shared memory BK rows at a
//     time, rows split across blockIdx.y, a fixed-order reduce pass that
//     writes each entry and its mirror from one sum, no float atomics) with
//     the row loop walking row chunks: a block skips both the loads and the
//     FMAs of a row chunk when either of its two column tiles has count 0.
//     The TPU kernel's block copies are unconditional and only its MXU work
//     is gated; here the bytes are saved too.
//   * spmm is bound by the bytes of the populated blocks of X (c = 1 in lmCG:
//     a GEMV). Each block owns SPMM_ROWS rows of Y (an eighth of a row
//     chunk, so that a chunk whose row holds many populated tiles is spread
//     over eight blocks); each warp takes one row at a time and walks the
//     column tiles in order, skipping masked ones, its lanes reading the
//     row's populated 64-column segments with coalesced loads. A warp-shuffle
//     tree sums the lanes in a fixed order, so there is no split, no reduce
//     pass and no atomic, and the result repeats bit for bit.
//   * xtv_bs is bound by the bytes of the populated blocks of X. It is
//     gram.cu's xtv design (one thread per column of X, rows split across
//     blocks, fixed-order reduce pass) with the row loop skipping the row
//     chunks whose count for the thread's column tile is 0; a warp's 32
//     columns lie in one tile, so the skip never diverges inside a warp. A
//     thread walks its rows one dependent load at a time, so its time is
//     its populated rows times the memory latency: the wrapper gives every
//     split a single row chunk, so no thread walks more than RC rows.
// Nothing is padded: ragged rows and columns are masked inside the kernels
// (padding to the TPU's (512, 256) blocks would copy the whole matrix).
//
// Dtype rule of src/repro/kernels/gram/ref.py: float64 accumulates and
// returns float64, float32 -> float32, bfloat16 -> float32.
//
// This first version uses plain FMA pipes (no wgmma, no TMA): the simple,
// correct kernel; speed is later work.
//
// Interface: plain C entry points for ctypes. Each takes device pointers,
// sizes, leading dimensions and the CUDA stream, launches one kernel on that
// stream, never synchronises or allocates (the Python wrapper owns every
// buffer, and runs gram.cu's reduce passes), and returns cudaGetLastError().

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

__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

constexpr int RC = 256;  // rows per mask chunk
constexpr int BN = 64;   // columns per mask tile (= gram output tile edge)

// ---- gram (gram.cu's tiles; the row loop walks mask chunks) ----------------

constexpr int BK = 16;                               // rows per shared-memory stage
constexpr int TM = 4;                                // outputs per thread along i
constexpr int TN = 4;                                // outputs per thread along j
constexpr int GRAM_THREADS = (BN / TM) * (BN / TN);  // 256
constexpr int LANES_I = BN / TM;                     // 16
constexpr int LANES_J = BN / TN;                     // 16
static_assert(RC % BK == 0, "a row chunk is a whole number of stages");

// One block: one upper-triangle output tile (ti <= tj) over one row range,
// which starts on a chunk boundary (the wrapper aligns rows_per_split to RC).
template <typename T>
__global__ void __launch_bounds__(GRAM_THREADS)
gram_bs_partial_kernel(const T* __restrict__ x, int64_t m, int64_t n, int64_t ldx,
                       const int32_t* __restrict__ mask, int64_t mask_cols,
                       int64_t rows_per_split, typename Acc<T>::type* __restrict__ ws) {
  using A = typename Acc<T>::type;
  __shared__ A xi[BK][BN];
  __shared__ A xj[BK][BN];

  const int64_t tiles = (n + BN - 1) / BN;
  int64_t t = blockIdx.x, ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int64_t tj = ti + t;
  const int64_t i0 = ti * BN, j0 = tj * BN;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);

  const int tid = threadIdx.x;
  const int ty = tid / LANES_J;
  const int tx = tid % LANES_J;
  A acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = A(0);

  for (int64_t c0 = r0; c0 < r1; c0 += RC) {
    const int32_t* mrow = mask + (c0 / RC) * mask_cols;
    if (mrow[ti] == 0 || mrow[tj] == 0) continue;  // uniform across the block
    const int64_t c1 = min64(r1, c0 + RC);
    for (int64_t k0 = c0; k0 < c1; k0 += BK) {
      for (int e = tid; e < BK * BN; e += GRAM_THREADS) {
        const int kk = e / BN, cc = e % BN;
        const int64_t row = k0 + kk;
        const bool rok = row < c1;
        const int64_t ci = i0 + cc, cj = j0 + cc;
        xi[kk][cc] = (rok && ci < n) ? to_acc(x[row * ldx + ci]) : A(0);
        xj[kk][cc] = (rok && cj < n) ? to_acc(x[row * ldx + cj]) : A(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        A a[TM], b[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) a[r] = xi[kk][ty + LANES_I * r];
#pragma unroll
        for (int c = 0; c < TN; ++c) b[c] = xj[kk][tx + LANES_J * c];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[r][c] = madd(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

  A* w = ws + (int64_t)blockIdx.y * n * n;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int64_t i = i0 + ty + LANES_I * r;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int64_t j = j0 + tx + LANES_J * c;
      if (i < n && j < n) w[i * n + j] = acc[r][c];
    }
  }
}

// ---- xtv -------------------------------------------------------------------

constexpr int XTV_THREADS = 256;  // columns of X per block
constexpr int XC = 4;             // columns of v (or W) per pass

template <typename T>
__global__ void __launch_bounds__(XTV_THREADS)
xtv_bs_partial_kernel(const T* __restrict__ x, const T* __restrict__ v, int64_t m,
                      int64_t n, int64_t c, int64_t ldx, int64_t ldv,
                      const int32_t* __restrict__ mask, int64_t mask_cols,
                      int64_t rows_per_split, typename Acc<T>::type* __restrict__ ws) {
  using A = typename Acc<T>::type;
  const int64_t j = (int64_t)blockIdx.x * XTV_THREADS + threadIdx.x;
  if (j >= n) return;
  const int64_t tile = j / BN;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  A* w = ws + ((int64_t)blockIdx.y * n + j) * c;
  for (int64_t q0 = 0; q0 < c; q0 += XC) {
    const int nc = (int)min64(XC, c - q0);
    A acc[XC];
#pragma unroll
    for (int q = 0; q < XC; ++q) acc[q] = A(0);
    for (int64_t c0 = r0; c0 < r1; c0 += RC) {
      if (mask[(c0 / RC) * mask_cols + tile] == 0) continue;
      const int64_t c1 = min64(r1, c0 + RC);
#pragma unroll 4
      for (int64_t k = c0; k < c1; ++k) {
        const A xv = to_acc(x[k * ldx + j]);
        const T* vk = v + k * ldv + q0;
#pragma unroll
        for (int q = 0; q < XC; ++q)
          if (q < nc) acc[q] = madd(xv, to_acc(vk[q]), acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < XC; ++q)
      if (q < nc) w[q0 + q] = acc[q];
  }
}

// ---- spmm ------------------------------------------------------------------

constexpr int SPMM_THREADS = 256;
constexpr int WARPS = SPMM_THREADS / 32;
constexpr int SPMM_ROWS = 32;  // rows of Y per block
static_assert(RC % SPMM_ROWS == 0, "a block's rows lie in one row chunk");

// Y (m, c), contiguous, = X (m, k) @ W (k, c). Block b owns rows
// [b * SPMM_ROWS, (b + 1) * SPMM_ROWS) of Y, warp w its rows w, w + WARPS, ...
template <typename T>
__global__ void __launch_bounds__(SPMM_THREADS)
spmm_kernel(const T* __restrict__ x, const T* __restrict__ wt, int64_t m, int64_t k,
            int64_t c, int64_t ldx, int64_t ldw, const int32_t* __restrict__ mask,
            int64_t mask_cols, typename Acc<T>::type* __restrict__ y) {
  using A = typename Acc<T>::type;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t r0 = (int64_t)blockIdx.x * SPMM_ROWS;
  const int64_t r1 = min64(m, r0 + SPMM_ROWS);
  const int32_t* mrow = mask + (r0 / RC) * mask_cols;
  for (int64_t row = r0 + warp; row < r1; row += WARPS) {
    const T* xr = x + row * ldx;
    for (int64_t q0 = 0; q0 < c; q0 += XC) {
      const int nc = (int)min64(XC, c - q0);
      A acc[XC];
#pragma unroll
      for (int q = 0; q < XC; ++q) acc[q] = A(0);
      for (int64_t t = 0; t < mask_cols; ++t) {
        if (mrow[t] == 0) continue;  // uniform across the block
#pragma unroll
        for (int h = 0; h < BN / 32; ++h) {
          const int64_t col = t * BN + h * 32 + lane;
          if (col < k) {
            const A xv = to_acc(xr[col]);
            const T* wk = wt + col * ldw + q0;
#pragma unroll
            for (int q = 0; q < XC; ++q)
              if (q < nc) acc[q] = madd(xv, to_acc(wk[q]), acc[q]);
          }
        }
      }
      // fixed-order tree over the lanes; lane 0 ends with the sum
#pragma unroll
      for (int q = 0; q < XC; ++q)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < XC; ++q)
          if (q < nc) y[row * c + q0 + q] = acc[q];
      }
    }
  }
}

inline unsigned int blocks_for(int64_t items, int threads) {
  return (unsigned int)((items + threads - 1) / threads);
}

template <typename T>
int launch_gram_bs(const void* x, int64_t m, int64_t n, int64_t ldx, const int32_t* mask,
                   int64_t mask_cols, int64_t rows_per_split, int splits, void* ws,
                   cudaStream_t stream) {
  const int64_t tiles = (n + BN - 1) / BN;
  const dim3 grid((unsigned int)(tiles * (tiles + 1) / 2), (unsigned int)splits);
  gram_bs_partial_kernel<T><<<grid, GRAM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), m, n, ldx, mask, mask_cols, rows_per_split,
      static_cast<typename Acc<T>::type*>(ws));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_xtv_bs(const void* x, const void* v, int64_t m, int64_t n, int64_t c,
                  int64_t ldx, int64_t ldv, const int32_t* mask, int64_t mask_cols,
                  int64_t rows_per_split, int splits, void* ws, cudaStream_t stream) {
  const dim3 grid(blocks_for(n, XTV_THREADS), (unsigned int)splits);
  xtv_bs_partial_kernel<T><<<grid, XTV_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), m, n, c, ldx, ldv, mask,
      mask_cols, rows_per_split, static_cast<typename Acc<T>::type*>(ws));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spmm(const void* x, const void* w, int64_t m, int64_t k, int64_t c,
                int64_t ldx, int64_t ldw, const int32_t* mask, int64_t mask_cols,
                void* y, cudaStream_t stream) {
  spmm_kernel<T><<<blocks_for(m, SPMM_ROWS), SPMM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), m, k, c, ldx, ldw, mask,
      mask_cols, static_cast<typename Acc<T>::type*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The mask's block shape, for the wrapper to check against its own.
int repro_spmm_row_chunk() { return RC; }
int repro_spmm_col_tile() { return BN; }

// ws: [splits, n, n] in the accumulation dtype, upper-triangle tiles only
// (reduce with gram.cu's repro_gram_reduce). rows_per_split is a multiple of
// the row chunk.
int repro_gram_bs_partial(int dtype, const void* x, long long m, long long n,
                          long long ldx, const void* mask, long long mask_cols,
                          long long rows_per_split, int splits, void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  if (rows_per_split % RC != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF64: return launch_gram_bs<double>(x, m, n, ldx, mk, mask_cols, rows_per_split, splits, ws, st);
    case kF32: return launch_gram_bs<float>(x, m, n, ldx, mk, mask_cols, rows_per_split, splits, ws, st);
    case kBF16: return launch_gram_bs<__nv_bfloat16>(x, m, n, ldx, mk, mask_cols, rows_per_split, splits, ws, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ws: [splits, n, c] in the accumulation dtype (reduce with gram.cu's
// repro_xtv_reduce). rows_per_split is a multiple of the row chunk.
int repro_xtv_bs_partial(int dtype, const void* x, const void* v, long long m, long long n,
                         long long c, long long ldx, long long ldv, const void* mask,
                         long long mask_cols, long long rows_per_split, int splits,
                         void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  if (rows_per_split % RC != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF64: return launch_xtv_bs<double>(x, v, m, n, c, ldx, ldv, mk, mask_cols, rows_per_split, splits, ws, st);
    case kF32: return launch_xtv_bs<float>(x, v, m, n, c, ldx, ldv, mk, mask_cols, rows_per_split, splits, ws, st);
    case kBF16: return launch_xtv_bs<__nv_bfloat16>(x, v, m, n, c, ldx, ldv, mk, mask_cols, rows_per_split, splits, ws, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y: [m, c] contiguous, in the accumulation dtype.
int repro_spmm(int dtype, const void* x, const void* w, long long m, long long k,
               long long c, long long ldx, long long ldw, const void* mask,
               long long mask_cols, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  switch (dtype) {
    case kF64: return launch_spmm<double>(x, w, m, k, c, ldx, ldw, mk, mask_cols, y, st);
    case kF32: return launch_spmm<float>(x, w, m, k, c, ldx, ldw, mk, mask_cols, y, st);
    case kBF16: return launch_spmm<__nv_bfloat16>(x, w, m, k, c, ldx, ldw, mk, mask_cols, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
