// Block-sparse gram / SpMM / xtv for Hopper (sm_90a), over a dense layout of
// a sparse X and a mask of its nonzero blocks.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/spmm/kernel.py:
//   * gram_bs_partial_kernel + gram_tile_reduce_kernel (gram_mainloop.cuh)
//                                <- gram_block_sparse (_gram_kernel)
//   * spmm_kernel                <- spmm_block_sparse (_spmm_kernel)
//   * xtv_bs_partial_kernel  (+ gram.cu's xtv_reduce_kernel)
//                                <- xtv_block_sparse  (_xtv_kernel)
//
// The mask belongs to this card's tiles, not the TPU's: mask[r * mask_cols + t]
// is the int32 count of nonzeros in the block of X at row chunk r (RC = 256
// rows) and column tile t (TILE = 64 columns); the last chunk and tile may be
// ragged. The wrapper (kernels/spmm/ops.py) counts it from the BCOO indices,
// so nothing scans the dense copy. A block whose count is 0 holds only
// zeros, so every term it would add is an exact zero: skipping it changes no
// bit of the result. A kernel run with the true mask is therefore bitwise
// equal to the same kernel run with an all-ones mask (same split plan),
// which is what the on-card check holds it to.
//
// What bounds them on this card, and what the design does about it:
//   * gram_bs is bound by operations in float64, counted over the populated
//     blocks only. It runs gram.cu's mainloop (gram_mainloop.cuh: 128 x 128
//     or 128 x 64 upper tiles, float64 on the FP64 tensor cores, bf16 on
//     mma.sync, float32 on the FMA pipes, a 3-stage cp.async ring) with the
//     ring walking the populated row chunks of its split only: a chunk is
//     skipped when every mask tile under the output tile's i columns, or
//     every one under its j columns, has count 0, and the ring refills from
//     the next populated chunk, so a skipped chunk issues no copies. Work
//     per tile is uneven: a chunk feeds a diagonal tile when its i columns
//     are populated, an off-diagonal one only when its j columns are too.
//     The split plan cannot follow the mask (the all-ones run must give the
//     same bits), so the wrapper's plan (ops.gram_bs_plan, a function of the
//     shape and the card) cuts the rows into many splits of a few chunks:
//     items (tile, split), ~24 times more than resident blocks, launched
//     as one block each, every diagonal tile's items first (the longest
//     class): the card hands blocks out in that order as slots free, and
//     an item with no populated chunk ends after its mask reads. (A plan
//     pass listing the populated items for persistent blocks measured
//     slower: PERF.md §6.) Each item writes its own partial slot,
//     tile-major [splits][tiles][BM][BN], or, when none of its chunks is
//     populated, only a 0 in filled[tile][split]; gram_tile_reduce sums the
//     filled slots in split order and writes each element and its mirror
//     from one sum. The order in which items run changes no bit; no
//     atomics, no host read of the mask.
//   * spmm is bound by the bytes of the populated blocks of X (c = 1 in lmCG:
//     a GEMV). Each block owns SPMM_ROWS rows of Y (an eighth of a row
//     chunk, so that a chunk whose row holds many populated tiles is spread
//     over eight blocks); each warp takes one row at a time and walks the
//     column tiles in order, skipping masked ones, its lanes reading the
//     row's populated 64-column segments with coalesced loads. A warp-shuffle
//     tree sums the lanes in a fixed order, so there is no split, no reduce
//     pass and no atomic, and the result repeats bit for bit.
//   * xtv_bs is bound by the bytes of the populated blocks of X. It is
//     gram.cu's first xtv design (one thread per column of X, rows split
//     across blocks, fixed-order reduce pass) with the row loop skipping the
//     row chunks whose count for the thread's column tile is 0; a warp's 32
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
// Interface: plain C entry points for ctypes. Each takes device pointers,
// sizes, leading dimensions and the CUDA stream, launches its kernels on
// that stream (repro_gram_bs: the partial and the reduce pass), never
// synchronises or allocates (the Python wrapper owns every buffer, and runs
// gram.cu's xtv reduce pass), and returns the first launch error.

#include "gram_mainloop.cuh"

namespace {

constexpr int RC = 256;          // rows per mask chunk
constexpr int TILE = 64;         // columns per mask tile
constexpr int MAX_CHUNKS = 8192;  // row chunks a gram_bs split may hold
static_assert(RC % F64_BK == 0 && RC % F32_BK == 0 && RC % BF16_BK == 0,
              "a row chunk is a whole number of stages");

// ---- gram ------------------------------------------------------------------

// Item -> (tile, split): every diagonal tile's items (tile row ti's first
// tile, j0 = i0), then the others; in each class consecutive items take
// consecutive tiles of one split.
template <int BN>
__device__ __forceinline__ void item_tile(int64_t item, int splits, int64_t n, int64_t& tile,
                                          int& split) {
  constexpr int R = BM / BN;
  const int64_t ti_n = (n + BM - 1) / BM, tj_n = (n + BN - 1) / BN;
  const int64_t off = upper_tiles<BN>(n) - ti_n;
  if (item < ti_n * splits) {
    const int64_t d = item % ti_n;
    split = (int)(item / ti_n);
    tile = d * tj_n - R * d * (d - 1) / 2;
    return;
  }
  item -= ti_n * splits;
  int64_t k = item % off, ti = 0;
  split = (int)(item / off);
  while (k >= tj_n - ti * R - 1) {
    k -= tj_n - ti * R - 1;
    ++ti;
  }
  tile = ti * tj_n - R * ti * (ti - 1) / 2 + 1 + k;
}

// One block: item blockIdx.x, one upper tile over one split's rows (a
// whole number of chunks). Warp 0 marks the split's populated chunks, one
// bit each; the ring then walks their stages only, in row order. An item
// none of whose chunks is populated costs its mask reads and one flag.
template <typename T, int BN, int VEC>
__global__ void __launch_bounds__(GRAM_THREADS, 1)
gram_bs_partial_kernel(const T* __restrict__ x, int64_t m, int64_t n, int64_t ldx,
                       const int32_t* __restrict__ mask, int64_t mask_cols,
                       int64_t rows_per_split, int splits, int64_t tiles,
                       typename Acc<T>::type* __restrict__ ws, int32_t* __restrict__ filled) {
  constexpr int BK = stage_rows<T>(), SPC = RC / BK;
  __shared__ unsigned populated[MAX_CHUNKS / 32];
  __shared__ int count;
  int64_t tile, i0, j0;
  int split;
  item_tile<BN>(blockIdx.x, splits, n, tile, split);
  upper_tile<BN>(tile, n, i0, j0);
  const int64_t r0 = (int64_t)split * rows_per_split;
  const int64_t r1 = min64(m, r0 + rows_per_split);
  const int64_t c0 = r0 / RC;
  const int nc = (int)((r1 - r0 + RC - 1) / RC);
  // the mask tiles under the i and the j columns
  const int64_t ia = i0 / TILE, ib = (min64(i0 + BM, n) - 1) / TILE;
  const int64_t ja = j0 / TILE, jb = (min64(j0 + BN, n) - 1) / TILE;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int got = 0;
    for (int base = 0; base < nc; base += 32) {
      bool on = false;
      if (base + lane < nc) {
        const int32_t* row = mask + (c0 + base + lane) * mask_cols;
        bool in_i = false, in_j = false;
        for (int64_t q = ia; q <= ib; ++q) in_i |= row[q] != 0;
        for (int64_t q = ja; q <= jb; ++q) in_j |= row[q] != 0;
        on = in_i && in_j;
      }
      const unsigned bits = __ballot_sync(0xffffffffu, on);
      if (lane == 0) populated[base / 32] = bits;
      got += __popc(bits);
    }
    if (lane == 0) {
      count = got;
      filled[tile * splits + split] = got > 0;
    }
  }
  __syncthreads();
  const int np = count;
  if (np == 0) return;  // uniform over the block
  // the ring asks for stages 0, 1, 2, ... in order: every SPC stages it
  // moves to the next populated chunk (the lowest bit left in `left`)
  int word = -1, chunk = 0;
  unsigned left = 0;
  gram_tile<T, BN, VEC>(
      x, ldx, n, i0, j0, np * SPC,
      [&](int it) {
        if (it % SPC == 0) {
          while (left == 0) left = populated[++word];
          chunk = 32 * word + __ffs(left) - 1;
          left &= left - 1;
        }
        return (c0 + chunk) * RC + (int64_t)(it % SPC) * BK;
      },
      r1, ws + ((int64_t)split * tiles + tile) * (BM * BN));
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
  const int64_t tile = j / TILE;
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
        for (int h = 0; h < TILE / 32; ++h) {
          const int64_t col = t * TILE + h * 32 + lane;
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

template <typename T, int BN, int VEC>
int launch_gram_bs(const void* x, int64_t m, int64_t n, int64_t ldx, const int32_t* mask,
                   int64_t mask_cols, int64_t rows_per_split, int splits, void* ws,
                   int32_t* filled, void* out, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int64_t tiles = upper_tiles<BN>(n), items = tiles * splits;
  if (items > INT32_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = gram_bs_partial_kernel<T, BN, VEC>;
  constexpr int smem = gram_smem_bytes<T>();
  static bool ready[64] = {};
  int rc = allow_smem(kernel, smem, ready);
  if (rc != 0) return rc;
  kernel<<<(unsigned int)items, GRAM_THREADS, smem, stream>>>(
      static_cast<const T*>(x), m, n, ldx, mask, mask_cols, rows_per_split, splits, tiles,
      static_cast<A*>(ws), filled);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_gram_tile_reduce<A, BN, true>(ws, splits, n, out, filled, stream);
}

template <typename T>
int launch_gram_bs(int tile_n, int vec, const void* x, int64_t m, int64_t n, int64_t ldx,
                   const int32_t* mask, int64_t mask_cols, int64_t rows_per_split, int splits,
                   void* ws, int32_t* filled, void* out, cudaStream_t st) {
  constexpr int V = 16 / (int)sizeof(T);
  if (tile_n == 128)
    return vec ? launch_gram_bs<T, 128, V>(x, m, n, ldx, mask, mask_cols, rows_per_split,
                                          splits, ws, filled, out, st)
               : launch_gram_bs<T, 128, 1>(x, m, n, ldx, mask, mask_cols, rows_per_split,
                                          splits, ws, filled, out, st);
  if (tile_n == 64)
    return vec ? launch_gram_bs<T, 64, V>(x, m, n, ldx, mask, mask_cols, rows_per_split,
                                         splits, ws, filled, out, st)
               : launch_gram_bs<T, 64, 1>(x, m, n, ldx, mask, mask_cols, rows_per_split,
                                         splits, ws, filled, out, st);
  return (int)cudaErrorInvalidValue;
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

// The mask's block shape and a gram_bs split's most chunks, for the
// wrapper to check against its own.
int repro_spmm_row_chunk() { return RC; }
int repro_spmm_col_tile() { return TILE; }
int repro_spmm_max_chunks() { return MAX_CHUNKS; }

// G = X^T X over the populated blocks: the partial pass into ws ([splits,
// tiles, 128, tile_n] of the accumulation dtype) and filled ([tiles,
// splits] int32), and the reduce pass into out ([n, n] contiguous), both
// on the stream. rows_per_split is a whole number of row chunks, at most
// MAX_CHUNKS. vec: X's base and ldx are 16-byte aligned (16-byte copies),
// else element copies.
int repro_gram_bs(int dtype, int tile_n, int vec, const void* x, long long m, long long n,
                  long long ldx, const void* mask, long long mask_cols,
                  long long rows_per_split, int splits, void* ws, void* filled, void* out,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  int32_t* fl = static_cast<int32_t*>(filled);
  if (rows_per_split % RC != 0 || rows_per_split / RC > MAX_CHUNKS || splits <= 0)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF64:
      return launch_gram_bs<double>(tile_n, vec, x, m, n, ldx, mk, mask_cols, rows_per_split,
                                    splits, ws, fl, out, st);
    case kF32:
      return launch_gram_bs<float>(tile_n, vec, x, m, n, ldx, mk, mask_cols, rows_per_split,
                                   splits, ws, fl, out, st);
    case kBF16:
      return launch_gram_bs<__nv_bfloat16>(tile_n, vec, x, m, n, ldx, mk, mask_cols,
                                           rows_per_split, splits, ws, fl, out, st);
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
