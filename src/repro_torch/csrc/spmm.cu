// Block-sparse gram / SpMM / xtv for Hopper (sm_90a), over a dense layout of
// a sparse X and a mask of its nonzero blocks.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/spmm/kernel.py:
//   * gram_bs_partial_kernel + gram_tile_reduce_kernel (gram_mainloop.cuh)
//                                <- gram_block_sparse (_gram_kernel)
//   * spmm_kernel                <- spmm_block_sparse (_spmm_kernel)
//   * xtv_bs_partial_kernel + xtv_reduce_kernel (gram_mainloop.cuh)
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
//   * xtv_bs and spmm are bound by the bytes of the populated blocks of X
//     (c = 1 on the lmCG and lmDS paths: a GEMV); with one element a lane
//     per load they would be bound by load latency instead. Both read X
//     as gram.cu's xtv does: every lane issues 16-byte loads, several rows
//     in flight, LPR lanes covering one 64-column mask tile of one row
//     (so the skip stays at the mask's tile: float32 covers 2 rows of a
//     tile a warp load, bfloat16 4). Which lane and
//     which accumulator takes a column is a function of the column alone,
//     rows go to warps by row index, populated chunks and tiles are
//     walked in ascending order and the lanes, warps and splits merge in
//     a fixed order, so a skipped block only leaves out exact zeros: the
//     all-ones mask gives the same bits.
//     xtv_bs: a block per (mask tile, split), a split being every S-th
//     row chunk, S from the wrapper's plan (ops.xtv_bs_plan, a function of
//     the shape, the dtype and the card, never of the mask); each warp
//     ballots its split's chunks for the tile and walks the populated ones
//     only; the split partials ([splits][n][c], zeros where a split
//     had no populated chunk) are summed in a fixed order by the xtv
//     reduce pass (gram_mainloop.cuh), launched by the same host call.
//     spmm: a block per 32 x RPW rows of one row chunk, so they share one
//     mask row: the block lists the chunk's populated tiles once (a
//     ballot pass), stages W's rows under them in shared memory, and
//     every warp walks the list, each lane summing its own columns; a
//     fixed shuffle tree merges a row's lanes. No split, no reduce pass.
// Nothing is padded: ragged rows and columns are masked inside the kernels
// (padding to the TPU's (512, 256) blocks would copy the whole matrix).
//
// Dtype rule of src/repro/kernels/gram/ref.py: float64 accumulates and
// returns float64, float32 -> float32, bfloat16 -> float32.
//
// Interface: plain C entry points for ctypes. Each takes device pointers,
// sizes, leading dimensions and the CUDA stream, launches its kernels on
// that stream (repro_gram_bs and repro_xtv_bs: the partial and the reduce
// pass, one host call for both), never synchronises or allocates (the
// Python wrapper owns every buffer), and returns the first launch error.

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

// ---- tiles of 16-byte lanes (xtv_bs, spmm) ---------------------------------

// A lane loads P = 16 / sizeof(T) consecutive elements of a row; LPR =
// TILE / P lanes cover one 64-column mask tile of one row and a warp load
// covers RPW = 32 / LPR rows of it (float64: 1, float32: 2, bfloat16: 4),
// so the skip stays at the mask's tile. (A slab of 32 x 16 bytes, 2 tiles
// in float32 and 4 in bfloat16, measured slower: PERF.md §6.)
template <typename T> struct Seg {
  static constexpr int P = 16 / (int)sizeof(T), LPR = TILE / P, RPW = 32 / LPR;
  static_assert(32 % LPR == 0, "a warp load covers whole rows of a tile");
  // the tile-local column of element p of lane cl: VEC, P consecutive
  // columns a lane (one 16-byte load); otherwise columns cl + LPR p (one
  // element a load, coalesced across the lanes)
  template <bool VEC> __device__ static __forceinline__ int col(int cl, int p) {
    return VEC ? cl * P + p : cl + LPR * p;
  }
};

// A lane's P elements of one row's tile, as the row stores them: 16
// bytes in 4 registers whatever the dtype (so many row loads can be in
// flight), unpacked to the accumulation dtype at their multiply.
__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ void set_word(uint4& r, int i, uint32_t v) {
  if (i == 0) r.x = v;
  else if (i == 1) r.y = v;
  else if (i == 2) r.z = v;
  else r.w = v;
}
__device__ __forceinline__ double unpack(const uint4& r, int p, const double*) {
  return __hiloint2double((int)word(r, 2 * p + 1), (int)word(r, 2 * p));
}
__device__ __forceinline__ float unpack(const uint4& r, int p, const float*) {
  return __uint_as_float(word(r, p));
}
__device__ __forceinline__ float unpack(const uint4& r, int p, const __nv_bfloat16*) {
  const uint32_t w = word(r, p / 2);
  return __uint_as_float(p & 1 ? w & 0xffff0000u : w << 16);
}
__device__ __forceinline__ void pack(uint4& r, int p, double v) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  set_word(r, 2 * p, (uint32_t)b);
  set_word(r, 2 * p + 1, (uint32_t)(b >> 32));
}
__device__ __forceinline__ void pack(uint4& r, int p, float v) {
  set_word(r, p, __float_as_uint(v));
}
__device__ __forceinline__ void pack(uint4& r, int p, __nv_bfloat16 v) {
  const uint32_t h = __bfloat16_as_ushort(v), w = word(r, p / 2);
  set_word(r, p / 2, p & 1 ? (w & 0xffffu) | (h << 16) : (w & 0xffff0000u) | h);
}

// The P elements of row `row` at tile-local columns Seg::col(cl, p) of
// the tile at column j0: one 16-byte load where VEC allows it, else
// element loads; zeros where the row is past m (!rok) or the column past n.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_seg(const T* __restrict__ row, bool rok, int64_t j0,
                                          int64_t n, int cl) {
  using S = Seg<T>;
  constexpr int P = S::P;
  if (VEC && rok && j0 + (cl + 1) * P <= n)
    return __ldg(reinterpret_cast<const uint4*>(row + cl * P));
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int jc = S::template col<VEC>(cl, p);
    if (rok && j0 + jc < n) pack(r, p, row[jc]);
  }
  return r;
}

// ---- xtv -------------------------------------------------------------------

constexpr int XB_THREADS = 256;  // 8 warps
constexpr int XB_WARPS = XB_THREADS / 32;
constexpr int XB_UNROLL = 8;     // row loads in flight a lane (c = 1)
constexpr int XB_MIN_BLOCKS = 2;  // resident blocks an SM (caps registers)

// One block: mask tile blockIdx.x of X's columns over split s =
// blockIdx.y's row chunks, which are chunks s, s + S, s + 2 S, ... (S =
// gridDim.y splits): strided, so a split samples chunks from every part
// of X and the populated work of the blocks evens out, whatever the
// mask's layout. Each warp ballots the split's chunks whose mask is
// nonzero under the tile, then walks those chunks in order: row group g
// (RPW rows, one warp load) of a chunk goes to warp g % 8, so a lane
// accumulates its rows in ascending order, XB_UNROLL loads in flight. The RPW lanes that share columns merge by a
// fixed shuffle tree, the warps in shared memory in warp order; the
// block writes its partial (zeros when no chunk was populated: then
// without the merge) to slot s of ws ([splits][n][c]), or, with one
// split, to the output.
template <typename T, bool VEC, int XC>
__global__ void __launch_bounds__(XB_THREADS, XB_MIN_BLOCKS)
xtv_bs_partial_kernel(const T* __restrict__ x, const T* __restrict__ v, int64_t m, int64_t n,
                      int64_t c, int64_t ldx, int64_t ldv, const int32_t* __restrict__ mask,
                      int64_t mask_cols, typename Acc<T>::type* __restrict__ ws) {
  using A = typename Acc<T>::type;
  using S = Seg<T>;
  constexpr int P = S::P, RPW = S::RPW, LPR = S::LPR;
  constexpr int LOADS = RC / (RPW * XB_WARPS);  // loads a lane issues a chunk
  // rows in flight: half with XC columns of v or with element loads (P
  // loads a row already; the bfloat16 one spilled at 8); the order of
  // the adds does not depend on it
  constexpr int U0 = XC == 1 && VEC ? XB_UNROLL : XB_UNROLL / 2;
  constexpr int U = LOADS < U0 ? LOADS : U0;
  static_assert(LOADS % U == 0, "whole rounds of loads a chunk");
  __shared__ A red[XB_WARPS][TILE * XC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPR, cl = lane % LPR;
  const int64_t ta = blockIdx.x, j0 = ta * TILE;
  const int64_t split = blockIdx.y, splits = gridDim.y;
  const int nc = (int)(((m + RC - 1) / RC - split + splits - 1) / splits);

  for (int64_t q0 = 0; q0 < c; q0 += XC) {
    const int ncol = (int)min64(XC, c - q0);
    A acc[P][XC];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < XC; ++q) acc[p][q] = A(0);
    bool none = true;  // the same in every warp: they read the same mask
    for (int base = 0; base < nc; base += 32) {
      // bit i: the split's chunk base + i is populated in tile ta
      const bool in = base + lane < nc;
      unsigned any = __ballot_sync(
          0xffffffffu, in && mask[(split + (base + lane) * splits) * mask_cols + ta] != 0);
      none = none && any == 0;
      while (any != 0) {
        const int i = __ffs(any) - 1;
        any &= any - 1;
        const int64_t r0 = (split + (base + i) * splits) * RC + warp * RPW + sub;
        for (int l0 = 0; l0 < LOADS; l0 += U) {
          uint4 xr[U];
          A vr[U][XC];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int64_t r = r0 + (int64_t)(l0 + u) * (RPW * XB_WARPS);
            const bool rok = r < m;
            xr[u] = load_seg<T, VEC>(x + r * ldx + j0, rok, j0, n, cl);
#pragma unroll
            for (int q = 0; q < XC; ++q)
              vr[u][q] = (rok && q < ncol) ? to_acc(v[r * ldv + q0 + q]) : A(0);
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int p = 0; p < P; ++p)
#pragma unroll
              for (int q = 0; q < XC; ++q)
                acc[p][q] = madd(unpack(xr[u], p, x), vr[u][q], acc[p][q]);
        }
      }
    }
    if (none) {  // an all-zero partial
      for (int e = threadIdx.x; e < TILE * XC; e += XB_THREADS) {
        const int64_t j = j0 + e / XC;
        const int q = e % XC;
        if (j < n && q < ncol) ws[(split * n + j) * c + q0 + q] = A(0);
      }
      continue;
    }
    // the RPW lanes of a column, fixed order; sub 0 ends with the sum
#pragma unroll
    for (int off = 16; off >= LPR; off >>= 1)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int q = 0; q < XC; ++q) acc[p][q] += __shfl_down_sync(0xffffffffu, acc[p][q], off);
    if (sub == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int q = 0; q < XC; ++q) red[warp][S::template col<VEC>(cl, p) * XC + q] = acc[p][q];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TILE * XC; e += XB_THREADS) {
      const int64_t j = j0 + e / XC;
      const int q = e % XC;
      if (j < n && q < ncol) {
        A s = red[0][e];
#pragma unroll
        for (int w = 1; w < XB_WARPS; ++w) s += red[w][e];
        ws[(split * n + j) * c + q0 + q] = s;
      }
    }
    __syncthreads();
  }
}

// ---- spmm ------------------------------------------------------------------

constexpr int SPMM_THREADS = 256;
constexpr int SPMM_WARPS = SPMM_THREADS / 32;
constexpr int SPMM_SLOTS = 4;          // rows a lane holds, c = 1 (loads in flight a tile)
constexpr int SPMM_W_BYTES = 16384;    // W's rows staged in shared memory at once
constexpr int SPMM_MIN_BLOCKS = 2;     // resident blocks an SM (caps registers)

// rows a lane holds (XC columns of W: half, for registers) and rows of Y a block
template <int XC> __host__ __device__ constexpr int spmm_slots() {
  return XC == 1 ? SPMM_SLOTS : SPMM_SLOTS / 2;
}
template <typename T, int XC> __host__ __device__ constexpr int spmm_rows() {
  return SPMM_WARPS * spmm_slots<XC>() * Seg<T>::RPW;
}

// Y (m, c), contiguous, = X (m, k) @ W (k, c). Block b owns BR rows of Y
// inside one row chunk, so they share one mask row: the block lists the
// chunk's populated tiles in ascending order (a ballot pass, 256 tiles
// at a time), stages their rows of W in shared memory, and each warp
// walks the list for its SLOTS x RPW rows (row group g of the block to
// warp g / SLOTS), SLOTS 16-byte loads in flight. A lane sums its own
// columns in column order; the LPR lanes of a row merge by a fixed shuffle tree, and
// the block's rows go through shared memory to one coalesced store. No
// split, no reduce pass, no atomics.
template <typename T, bool VEC, int XC>
__global__ void __launch_bounds__(SPMM_THREADS, SPMM_MIN_BLOCKS)
spmm_kernel(const T* __restrict__ x, const T* __restrict__ wt, int64_t m, int64_t k,
            int64_t c, int64_t ldx, int64_t ldw, const int32_t* __restrict__ mask,
            int64_t mask_cols, typename Acc<T>::type* __restrict__ y) {
  using A = typename Acc<T>::type;
  using S = Seg<T>;
  constexpr int P = S::P, LPR = S::LPR, RPW = S::RPW, BR = spmm_rows<T, XC>();
  constexpr int SLOTS = spmm_slots<XC>();
  constexpr int WCAP = SPMM_W_BYTES / (int)(sizeof(A) * TILE * XC);  // tiles staged at once
  static_assert(RC % BR == 0 && WCAP >= 1, "a block's rows lie in one row chunk");
  __shared__ __align__(16) A wsm[WCAP * TILE * XC];
  __shared__ A ys[BR * XC];
  __shared__ int list[SPMM_THREADS];
  __shared__ int warp_n[SPMM_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPR, cl = lane % LPR;
  const int64_t r0 = (int64_t)blockIdx.x * BR;
  const int32_t* mrow = mask + (r0 / RC) * mask_cols;
  const int64_t rw = r0 + (int64_t)warp * SLOTS * RPW + sub;  // slot s: rw + s RPW

  for (int64_t q0 = 0; q0 < c; q0 += XC) {
    const int ncol = (int)min64(XC, c - q0);
    A acc[SLOTS][XC];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int q = 0; q < XC; ++q) acc[s][q] = A(0);
    for (int64_t win = 0; win < mask_cols; win += SPMM_THREADS) {
      // the populated tiles of [win, win + 256), in order
      const int64_t tg = win + tid;
      const bool pop = tg < mask_cols && mrow[tg] != 0;
      const unsigned bits = __ballot_sync(0xffffffffu, pop);
      if (lane == 0) warp_n[warp] = __popc(bits);
      __syncthreads();
      int off = 0, count = 0;
#pragma unroll
      for (int w = 0; w < SPMM_WARPS; ++w) {
        off += w < warp ? warp_n[w] : 0;
        count += warp_n[w];
      }
      if (pop) list[off + __popc(bits & ((1u << lane) - 1u))] = tid;
      __syncthreads();
      for (int g0 = 0; g0 < count; g0 += WCAP) {
        const int gn = min(WCAP, count - g0);
        // W's rows under the listed tiles g0 .. g0 + gn, zero past k
        for (int e = tid; e < gn * TILE * XC; e += SPMM_THREADS) {
          const int64_t col = (win + list[g0 + e / (TILE * XC)]) * TILE + (e / XC) % TILE;
          const int q = e % XC;
          wsm[e] = (col < k && q < ncol) ? to_acc(wt[col * ldw + q0 + q]) : A(0);
        }
        __syncthreads();
        for (int g = 0; g < gn; ++g) {
          const int64_t j0 = (win + list[g0 + g]) * TILE;
          const A* wg = wsm + g * TILE * XC;
          A wv[P][XC];
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int q = 0; q < XC; ++q) wv[p][q] = wg[S::template col<VEC>(cl, p) * XC + q];
          uint4 xr[SLOTS];
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            const int64_t r = rw + s * RPW;
            xr[s] = load_seg<T, VEC>(x + r * ldx + j0, r < m, j0, k, cl);
          }
#pragma unroll
          for (int s = 0; s < SLOTS; ++s)
#pragma unroll
            for (int p = 0; p < P; ++p)
#pragma unroll
              for (int q = 0; q < XC; ++q)
                acc[s][q] = madd(unpack(xr[s], p, x), wv[p][q], acc[s][q]);
        }
        __syncthreads();  // wsm is read before the next group is staged
      }
    }
    // the LPR lanes of a row, fixed order; lane cl 0 ends with the sum
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
#pragma unroll
        for (int q = 0; q < XC; ++q) acc[s][q] += __shfl_down_sync(0xffffffffu, acc[s][q], o, LPR);
    if (cl == 0) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
#pragma unroll
        for (int q = 0; q < XC; ++q)
          ys[((warp * SLOTS + s) * RPW + sub) * XC + q] = acc[s][q];
    }
    __syncthreads();
    for (int e = tid; e < BR * ncol; e += SPMM_THREADS) {
      const int64_t r = r0 + e / ncol;
      const int q = e % ncol;
      if (r < m) y[r * c + q0 + q] = ys[(e / ncol) * XC + q];
    }
    __syncthreads();
  }
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

template <typename T, bool VEC, int XC>
int launch_xtv_bs(const void* x, const void* v, int64_t m, int64_t n, int64_t c, int64_t ldx,
                  int64_t ldv, const int32_t* mask, int64_t mask_cols, int splits, void* part,
                  cudaStream_t stream) {
  const dim3 grid(blocks_for(n, TILE), (unsigned int)splits);
  xtv_bs_partial_kernel<T, VEC, XC><<<grid, XB_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), m, n, c, ldx, ldv, mask, mask_cols,
      static_cast<typename Acc<T>::type*>(part));
  return (int)cudaGetLastError();
}

// The partial pass into ws (or, with one split, into out), then the
// reduce pass, both on the stream.
template <typename T>
int launch_xtv_bs(int vec, const void* x, const void* v, int64_t m, int64_t n, int64_t c,
                  int64_t ldx, int64_t ldv, const int32_t* mask, int64_t mask_cols, int splits,
                  void* ws, void* out, cudaStream_t st) {
  void* part = splits > 1 ? ws : out;
  int rc;
  if (c == 1)
    rc = vec ? launch_xtv_bs<T, true, 1>(x, v, m, n, c, ldx, ldv, mask, mask_cols, splits, part,
                                         st)
             : launch_xtv_bs<T, false, 1>(x, v, m, n, c, ldx, ldv, mask, mask_cols, splits,
                                          part, st);
  else
    rc = vec ? launch_xtv_bs<T, true, 4>(x, v, m, n, c, ldx, ldv, mask, mask_cols, splits, part,
                                         st)
             : launch_xtv_bs<T, false, 4>(x, v, m, n, c, ldx, ldv, mask, mask_cols, splits,
                                          part, st);
  if (rc != 0 || splits == 1) return rc;
  return launch_xtv_reduce<typename Acc<T>::type>(ws, splits, n * c, out, st);
}

template <typename T, bool VEC, int XC>
int launch_spmm(const void* x, const void* w, int64_t m, int64_t k, int64_t c, int64_t ldx,
                int64_t ldw, const int32_t* mask, int64_t mask_cols, void* y,
                cudaStream_t stream) {
  spmm_kernel<T, VEC, XC><<<blocks_for(m, spmm_rows<T, XC>()), SPMM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), m, k, c, ldx, ldw, mask, mask_cols,
      static_cast<typename Acc<T>::type*>(y));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spmm(int vec, const void* x, const void* w, int64_t m, int64_t k, int64_t c,
                int64_t ldx, int64_t ldw, const int32_t* mask, int64_t mask_cols, void* y,
                cudaStream_t st) {
  if (c == 1)
    return vec ? launch_spmm<T, true, 1>(x, w, m, k, c, ldx, ldw, mask, mask_cols, y, st)
               : launch_spmm<T, false, 1>(x, w, m, k, c, ldx, ldw, mask, mask_cols, y, st);
  return vec ? launch_spmm<T, true, 4>(x, w, m, k, c, ldx, ldw, mask, mask_cols, y, st)
             : launch_spmm<T, false, 4>(x, w, m, k, c, ldx, ldw, mask, mask_cols, y, st);
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

// X^T v over the populated blocks: the partial pass into ws ([splits, n,
// c] of the accumulation dtype; split s holds row chunks s, s + splits,
// s + 2 splits, ...) and, with more than one split, the reduce pass into
// out ([n, c] contiguous), both on the stream; one split writes out
// itself. splits: at most the row chunks and 65,535. vec: X's base and
// ldx are 16-byte aligned (16-byte loads), else element loads.
int repro_xtv_bs(int dtype, int vec, const void* x, const void* v, long long m, long long n,
                 long long c, long long ldx, long long ldv, const void* mask,
                 long long mask_cols, int splits, void* ws, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  if (splits <= 0 || splits > 65535 || splits > (m + RC - 1) / RC)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF64:
      return launch_xtv_bs<double>(vec, x, v, m, n, c, ldx, ldv, mk, mask_cols, splits, ws, out,
                                   st);
    case kF32:
      return launch_xtv_bs<float>(vec, x, v, m, n, c, ldx, ldv, mk, mask_cols, splits, ws, out,
                                  st);
    case kBF16:
      return launch_xtv_bs<__nv_bfloat16>(vec, x, v, m, n, c, ldx, ldv, mk, mask_cols, splits,
                                          ws, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y: [m, c] contiguous, in the accumulation dtype. vec as for xtv_bs.
int repro_spmm(int dtype, int vec, const void* x, const void* w, long long m, long long k,
               long long c, long long ldx, long long ldw, const void* mask,
               long long mask_cols, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  switch (dtype) {
    case kF64: return launch_spmm<double>(vec, x, w, m, k, c, ldx, ldw, mk, mask_cols, y, st);
    case kF32: return launch_spmm<float>(vec, x, w, m, k, c, ldx, ldw, mk, mask_cols, y, st);
    case kBF16:
      return launch_spmm<__nv_bfloat16>(vec, x, w, m, k, c, ldx, ldw, mk, mask_cols, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
