// Gram (tsmm) kernel family for Hopper (sm_90a): G = X^T X and X^T v.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gram/kernel.py:
//   * gram_partial_kernel + gram_reduce_kernel  <- gram_pallas (_gram_kernel)
//   * xtv_partial_kernel  + xtv_reduce_kernel   <- xtv_pallas  (_xtv_kernel)
//
// Dtype rule (src/repro/kernels/gram/ref.py): float64 accumulates and
// returns float64, float32 -> float32, bfloat16 -> float32. The Pallas
// kernel's unconditional float32 output is NOT carried over: the
// lifecycle path is float64. float16 is not instantiated (the wrapper
// refuses it on the card; the plain version serves it on the CPU).
//
// What bounds them on this card, and what the design does about it:
//   * gram is bound by operations in float64 (an 8192 x 1000 bucket is
//     ~8.2 GFLOP of upper-triangle work against 65.5 MB read). Only the
//     upper-triangle BN x BN output tiles are computed (the tsmm trick of
//     the Pallas kernel), each by a block that keeps its tile in registers
//     (TM x TN outputs per thread) while X streams through shared memory
//     BK rows at a time. Both operands are column tiles of the same X, so
//     t(X) is never formed. The Pallas grid's sequential row axis becomes
//     a loop over rows inside the block; the rows are also split across
//     blockIdx.y (split-K), because tall-skinny lmDS shapes have too few
//     output tiles to fill 132 SMs.
//   * xtv is bound by bytes (it reads X once; c = 1 in lmDS). One thread
//     per column of X reads a row range with coalesced loads; the rows
//     are split across blocks so the card fills.
// Both reduce the split partials in a second, fixed-order pass (no float
// atomics), so results are bitwise reproducible from run to run. The
// gram reduce writes each upper-triangle element and its mirror from the
// same sum, so G is bitwise symmetric. Ragged edges are masked inside the
// kernels; nothing is padded or copied.
//
// This first version uses plain FMA pipes (no wgmma, no TMA): it is the
// simple, correct kernel; tensor-core speed is later work.
//
// Interface: plain C entry points for ctypes. Each takes device pointers,
// sizes, leading dimensions and the CUDA stream, launches one kernel on
// that stream, never synchronises or allocates (the Python wrapper owns
// every buffer), and returns cudaGetLastError().

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

// ---- gram ------------------------------------------------------------------

constexpr int BN = 64;                          // output tile edge
constexpr int BK = 16;                          // rows per shared-memory stage
constexpr int TM = 4;                           // outputs per thread along i
constexpr int TN = 4;                           // outputs per thread along j
constexpr int GRAM_THREADS = (BN / TM) * (BN / TN);  // 256
constexpr int LANES_I = BN / TM;                // 16
constexpr int LANES_J = BN / TN;                // 16

// One block: one upper-triangle output tile (ti <= tj) over one row range.
// Thread (ty, tx) owns outputs (i0 + ty + LANES_I * r, j0 + tx + LANES_J * c):
// interleaved so a warp reads consecutive shared-memory words and writes
// consecutive columns.
template <typename T>
__global__ void __launch_bounds__(GRAM_THREADS)
gram_partial_kernel(const T* __restrict__ x, int64_t m, int64_t n, int64_t ldx,
                    int64_t rows_per_split, typename Acc<T>::type* __restrict__ ws) {
  using A = typename Acc<T>::type;
  __shared__ A xi[BK][BN];
  __shared__ A xj[BK][BN];

  // linear upper-triangle tile index -> (ti, tj)
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

  for (int64_t k0 = r0; k0 < r1; k0 += BK) {
    for (int e = tid; e < BK * BN; e += GRAM_THREADS) {
      const int kk = e / BN, cc = e % BN;
      const int64_t row = k0 + kk;
      const bool rok = row < r1;
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

// Epilogue pass: sum the split partials of every upper-triangle element
// in split order and write it and its mirror.
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

constexpr int XTV_THREADS = 256;  // columns of X per block
constexpr int XC = 4;             // columns of v per pass

template <typename T>
__global__ void __launch_bounds__(XTV_THREADS)
xtv_partial_kernel(const T* __restrict__ x, const T* __restrict__ v, int64_t m,
                   int64_t n, int64_t c, int64_t ldx, int64_t ldv,
                   int64_t rows_per_split, typename Acc<T>::type* __restrict__ ws) {
  using A = typename Acc<T>::type;
  const int64_t j = (int64_t)blockIdx.x * XTV_THREADS + threadIdx.x;
  if (j >= n) return;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  A* w = ws + ((int64_t)blockIdx.y * n + j) * c;
  for (int64_t c0 = 0; c0 < c; c0 += XC) {
    const int nc = (int)min64(XC, c - c0);
    A acc[XC];
#pragma unroll
    for (int q = 0; q < XC; ++q) acc[q] = A(0);
#pragma unroll 4
    for (int64_t k = r0; k < r1; ++k) {
      const A xv = to_acc(x[k * ldx + j]);
      const T* vk = v + k * ldv + c0;
#pragma unroll
      for (int q = 0; q < XC; ++q)
        if (q < nc) acc[q] = madd(xv, to_acc(vk[q]), acc[q]);
    }
#pragma unroll
    for (int q = 0; q < XC; ++q)
      if (q < nc) w[c0 + q] = acc[q];
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

template <typename T>
int launch_gram_partial(const void* x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int splits, void* ws,
                        cudaStream_t stream) {
  const int64_t tiles = (n + BN - 1) / BN;
  const dim3 grid((unsigned int)(tiles * (tiles + 1) / 2), (unsigned int)splits);
  gram_partial_kernel<T><<<grid, GRAM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), m, n, ldx, rows_per_split,
      static_cast<typename Acc<T>::type*>(ws));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_xtv_partial(const void* x, const void* v, int64_t m, int64_t n, int64_t c,
                       int64_t ldx, int64_t ldv, int64_t rows_per_split, int splits,
                       void* ws, cudaStream_t stream) {
  const dim3 grid(blocks_for(n, XTV_THREADS), (unsigned int)splits);
  xtv_partial_kernel<T><<<grid, XTV_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), m, n, c, ldx, ldv,
      rows_per_split, static_cast<typename Acc<T>::type*>(ws));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ws: [splits, n, n] in the accumulation dtype; only upper-triangle tiles
// are written. Rows [s * rows_per_split, (s + 1) * rows_per_split) of X go
// to split s.
int repro_gram_partial(int dtype, const void* x, long long m, long long n,
                       long long ldx, long long rows_per_split, int splits,
                       void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF64: return launch_gram_partial<double>(x, m, n, ldx, rows_per_split, splits, ws, st);
    case kF32: return launch_gram_partial<float>(x, m, n, ldx, rows_per_split, splits, ws, st);
    case kBF16: return launch_gram_partial<__nv_bfloat16>(x, m, n, ldx, rows_per_split, splits, ws, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// acc_dtype: kF64 or kF32; out: [n, n] contiguous.
int repro_gram_reduce(int acc_dtype, const void* ws, int splits, long long n, void* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = blocks_for((int64_t)n * n, REDUCE_THREADS);
  if (acc_dtype == kF64) {
    gram_reduce_kernel<double><<<blocks, REDUCE_THREADS, 0, st>>>(
        static_cast<const double*>(ws), splits, n, static_cast<double*>(out));
  } else if (acc_dtype == kF32) {
    gram_reduce_kernel<float><<<blocks, REDUCE_THREADS, 0, st>>>(
        static_cast<const float*>(ws), splits, n, static_cast<float*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ws: [splits, n, c] in the accumulation dtype.
int repro_xtv_partial(int dtype, const void* x, const void* v, long long m, long long n,
                      long long c, long long ldx, long long ldv, long long rows_per_split,
                      int splits, void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF64: return launch_xtv_partial<double>(x, v, m, n, c, ldx, ldv, rows_per_split, splits, ws, st);
    case kF32: return launch_xtv_partial<float>(x, v, m, n, c, ldx, ldv, rows_per_split, splits, ws, st);
    case kBF16: return launch_xtv_partial<__nv_bfloat16>(x, v, m, n, c, ldx, ldv, rows_per_split, splits, ws, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: [n, c] contiguous (nc = n * c elements).
int repro_xtv_reduce(int acc_dtype, const void* ws, int splits, long long nc, void* out,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = blocks_for((int64_t)nc, REDUCE_THREADS);
  if (acc_dtype == kF64) {
    xtv_reduce_kernel<double><<<blocks, REDUCE_THREADS, 0, st>>>(
        static_cast<const double*>(ws), splits, nc, static_cast<double*>(out));
  } else if (acc_dtype == kF32) {
    xtv_reduce_kernel<float><<<blocks, REDUCE_THREADS, 0, st>>>(
        static_cast<const float*>(ws), splits, nc, static_cast<float*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
