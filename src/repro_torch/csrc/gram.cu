// Gram (tsmm) kernel family for Hopper (sm_90a): G = X^T X and X^T v.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gram/kernel.py:
//   * gram_{f64,bf16,f32}_partial_kernel + gram_tile_reduce_kernel
//                                            <- gram_pallas (_gram_kernel)
//   * xtv_slab_kernel + xtv_reduce_kernel (gram_mainloop.cuh)
//                                            <- xtv_pallas  (_xtv_kernel)
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
// mainloop (FP64 tensor cores for float64, mma.sync bf16, the FMA pipes
// for float32, a 3-stage cp.async ring of 16-byte or element copies) and
// the reduce pass over the tile-major partials [splits][tiles][BM][BN]
// live in gram_mainloop.cuh, which spmm.cu's block-sparse gram shares;
// the wrapper chooses the copy width by pointer and stride, since a
// column slice keeps its parent's leading dimension and odd widths give
// 8-byte-aligned rows.
//
// xtv is bound by bytes (it reads X once; c = 1 in lmDS). Each lane
// loads 16 bytes of a row (two float64 columns), so a warp covers a slab
// of 32 x 16 bytes of every row it reads, with XTV_UNROLL independent row
// loads in flight a thread; elements of v are read as a broadcast. The 8
// warps of a block split its rows and sum their partials in shared memory
// in warp order; blocks split the rows into a few splits of hundreds of
// KB each, which a second pass sums in a fixed order
// (gram_mainloop.cuh's xtv_reduce_kernel).
//
// Neither uses atomics: results are bitwise reproducible from run to run
// (the wrapper's plan depends only on the shape and the card).
//
// Interface: plain C entry points for ctypes. Each takes device pointers,
// sizes, leading dimensions and the CUDA stream, launches its kernels on
// that stream (repro_gram and repro_xtv: the partial and the reduce pass,
// one host call for both, since the host's time per call sets xtv's),
// never synchronises or allocates (the Python wrapper owns every buffer),
// and returns the first launch error.

#include "gram_mainloop.cuh"

namespace {

// The partial kernels: block (tile, split) accumulates its tile over rows
// [split * rows_per_split, ...) in order and writes its partial to slot
// (split, tile) of the tile-major workspace.
template <int BN, int VEC>
__global__ void __launch_bounds__(GRAM_THREADS, 1)
gram_f64_partial_kernel(const double* __restrict__ x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int64_t tiles, double* __restrict__ ws) {
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  gram_tile<double, BN, VEC>(
      x, ldx, n, i0, j0, (int)((r1 - r0 + F64_BK - 1) / F64_BK),
      [&](int it) { return r0 + (int64_t)it * F64_BK; }, r1,
      ws + ((int64_t)blockIdx.y * tiles + blockIdx.x) * (BM * BN));
}

template <int BN, int VEC>
__global__ void __launch_bounds__(GRAM_THREADS, 1)
gram_bf16_partial_kernel(const __nv_bfloat16* __restrict__ x, int64_t m, int64_t n,
                         int64_t ldx, int64_t rows_per_split, int64_t tiles,
                         float* __restrict__ ws) {
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  gram_tile<__nv_bfloat16, BN, VEC>(
      x, ldx, n, i0, j0, (int)((r1 - r0 + BF16_BK - 1) / BF16_BK),
      [&](int it) { return r0 + (int64_t)it * BF16_BK; }, r1,
      ws + ((int64_t)blockIdx.y * tiles + blockIdx.x) * (BM * BN));
}

template <int BN, int VEC>
__global__ void __launch_bounds__(GRAM_THREADS)
gram_f32_partial_kernel(const float* __restrict__ x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int64_t tiles, float* __restrict__ ws) {
  int64_t i0, j0;
  upper_tile<BN>(blockIdx.x, n, i0, j0);
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  gram_tile<float, BN, VEC>(
      x, ldx, n, i0, j0, (int)((r1 - r0 + F32_BK - 1) / F32_BK),
      [&](int it) { return r0 + (int64_t)it * F32_BK; }, r1,
      ws + ((int64_t)blockIdx.y * tiles + blockIdx.x) * (BM * BN));
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

template <typename T, int BN, int VEC>
int launch_gram_partial(const void* x, int64_t m, int64_t n, int64_t ldx,
                        int64_t rows_per_split, int splits, void* ws, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int64_t tiles = upper_tiles<BN>(n);
  const dim3 grid((unsigned int)tiles, (unsigned int)splits);
  void (*kernel)(const T*, int64_t, int64_t, int64_t, int64_t, int64_t, A*);
  if constexpr (sizeof(T) == 8) {
    kernel = gram_f64_partial_kernel<BN, VEC>;
  } else if constexpr (sizeof(T) == 4) {
    kernel = gram_f32_partial_kernel<BN, VEC>;
  } else {
    kernel = gram_bf16_partial_kernel<BN, VEC>;
  }
  constexpr int smem = gram_smem_bytes<T>();
  static bool ready[64] = {};
  const int rc = allow_smem(kernel, smem, ready);
  if (rc != 0) return rc;
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
    return f64 ? launch_gram_tile_reduce<double, 128, false>(ws, splits, n, out, nullptr, st)
               : launch_gram_tile_reduce<float, 128, false>(ws, splits, n, out, nullptr, st);
  return f64 ? launch_gram_tile_reduce<double, 64, false>(ws, splits, n, out, nullptr, st)
             : launch_gram_tile_reduce<float, 64, false>(ws, splits, n, out, nullptr, st);
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
  return dtype == kF64 ? launch_xtv_reduce<double>(ws, splits, n * c, out, st)
                       : launch_xtv_reduce<float>(ws, splits, n * c, out, st);
}

}  // extern "C"
