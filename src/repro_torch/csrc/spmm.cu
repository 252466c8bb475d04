// Block-sparse gram / SpMM / xtv for Hopper (sm_90a), over a dense layout of
// a sparse X and a mask of its nonzero blocks.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/spmm/kernel.py:
//   * gram_bs_partial_kernel + gram_tile_reduce_kernel (gram_mainloop.cuh)
//                                <- gram_block_sparse (_gram_kernel)
//   * spmm_kernel (W of one column), spmm_tile_kernel (two or more)
//                                <- spmm_block_sparse (_spmm_kernel)
//   * xtv_bs_partial_kernel (V of one column), xtv_bs_tile_kernel (two or
//     more) + xtv_reduce_kernel (gram_mainloop.cuh)
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
//   * xtv_bs and spmm of one column (c = 1 on the lmCG and lmDS paths: a
//     GEMV) are bound by the bytes of the populated blocks of X; with one
//     element a lane per load they would be bound by load latency instead.
//     Both read X as gram.cu's xtv does: every lane issues 16-byte loads,
//     several rows in flight, LPR lanes covering one 64-column mask tile
//     of one row (so the skip stays at the mask's tile: float32 covers 2
//     rows of a tile a warp load, bfloat16 4). Which lane and
//     which accumulator takes a column is a function of the column alone,
//     rows go to warps by row index, populated chunks and tiles are
//     walked in ascending order and the lanes, warps and splits merge in
//     a fixed order, so a skipped block only leaves out exact zeros: the
//     all-ones mask gives the same bits.
//     xtv_bs: a block per (mask tile, split), a split being every S-th
//     row chunk, S from the wrapper's plan (ops.xtv_bs_plan, a function of
//     the shape, the dtype and the card, never of the mask); each warp
//     ballots its split's chunks for the tile and walks the populated ones
//     only; the split partials ([splits][n], zeros where a split had no
//     populated chunk) are summed in a fixed order by the xtv reduce pass
//     (gram_mainloop.cuh), launched by the same host call.
//     spmm: a block per 32 x RPW rows of one row chunk, so they share one
//     mask row: the block lists the chunk's populated tiles once (a
//     ballot pass), stages W's rows under them in shared memory, and
//     every warp walks the list, each lane summing its own columns; a
//     fixed shuffle tree merges a row's lanes. No split, no reduce pass.
//   * xtv_bs and spmm of two or more columns (a λ grid's fold, 70 columns;
//     mlogreg's 10 classes) are tile products (gram_mainloop.cuh's
//     TileAcc: float64 on mma.sync m16n8k4, bfloat16 on m16n8k16 with
//     float32 sums, float32 on the FMA pipes), so the products run on the
//     tensor cores and X is read once for c up to 128: an output tile is
//     128 rows against a BN-column tile of the narrow operand (16 or 128;
//     the fragments past its c columns are not computed), fed by a 4-stage
//     cp.async ring with the populated blocks only; float64 from 17 to 80
//     columns takes 80-column tiles on blocks of 4 warps, two an SM, so
//     every warp holds 20 independent accumulators (with half as many the
//     FP64 tensor cores ran at a quarter of their rate, PERF.md §6).
//     xtv_bs_tile: a tile of X's columns (two mask tiles) against
//     BN columns of V, contracted over rows; a block per (tile, split),
//     the split strided as xtv_bs's (ops.xtv_bs_tile_plan, never of the
//     mask); warp 0 marks the split's chunks populated under each of the
//     tile's mask tiles, one bit each, and the ring walks the chunks with
//     any bit, reading V's rows for them only and zero-filling the columns
//     of X under an empty mask tile (their bytes are not read); the split
//     partials ([splits][n][c]) go through the xtv reduce pass. V's column
//     j may lie at (j / gw) * gs + j % gw (a vmapped batch of v read in
//     place).
//     spmm_tile: a tile of X's rows (half a row chunk) against BN columns
//     of W, contracted over X's columns; warp 0 marks
//     the chunk's populated mask tiles, and the ring walks them in
//     ascending order, a stage holding 16 (float64), 32 or 64 (bfloat16)
//     of a tile's columns of the rows and W's rows under them (W, 560 KB at
//     the fold, comes from L2). No split, no reduce pass. W's columns may
//     be grouped as V's.
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
// without the merge) to slot s of ws ([splits][n]), or, with one split,
// to the output. v has one column.
template <typename T, bool VEC>
__global__ void __launch_bounds__(XB_THREADS, XB_MIN_BLOCKS)
xtv_bs_partial_kernel(const T* __restrict__ x, const T* __restrict__ v, int64_t m, int64_t n,
                      int64_t ldx, int64_t ldv, const int32_t* __restrict__ mask,
                      int64_t mask_cols, typename Acc<T>::type* __restrict__ ws) {
  using A = typename Acc<T>::type;
  using S = Seg<T>;
  constexpr int P = S::P, RPW = S::RPW, LPR = S::LPR;
  constexpr int LOADS = RC / (RPW * XB_WARPS);  // loads a lane issues a chunk
  // rows in flight: half with element loads (P loads a row already); the
  // order of the adds does not depend on it
  constexpr int U0 = VEC ? XB_UNROLL : XB_UNROLL / 2;
  constexpr int U = LOADS < U0 ? LOADS : U0;
  static_assert(LOADS % U == 0, "whole rounds of loads a chunk");
  __shared__ A red[XB_WARPS][TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPR, cl = lane % LPR;
  const int64_t ta = blockIdx.x, j0 = ta * TILE;
  const int64_t split = blockIdx.y, splits = gridDim.y;
  const int nc = (int)(((m + RC - 1) / RC - split + splits - 1) / splits);

  A acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = A(0);
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
        A vr[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t r = r0 + (int64_t)(l0 + u) * (RPW * XB_WARPS);
          const bool rok = r < m;
          xr[u] = load_seg<T, VEC>(x + r * ldx + j0, rok, j0, n, cl);
          vr[u] = rok ? to_acc(v[r * ldv]) : A(0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int p = 0; p < P; ++p) acc[p] = madd(unpack(xr[u], p, x), vr[u], acc[p]);
      }
    }
  }
  if (none) {  // an all-zero partial
    for (int e = threadIdx.x; e < TILE; e += XB_THREADS)
      if (j0 + e < n) ws[split * n + j0 + e] = A(0);
    return;
  }
  // the RPW lanes of a column, fixed order; sub 0 ends with the sum
#pragma unroll
  for (int off = 16; off >= LPR; off >>= 1)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] += __shfl_down_sync(0xffffffffu, acc[p], off);
  if (sub == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) red[warp][S::template col<VEC>(cl, p)] = acc[p];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TILE; e += XB_THREADS) {
    if (j0 + e < n) {
      A s = red[0][e];
#pragma unroll
      for (int w = 1; w < XB_WARPS; ++w) s += red[w][e];
      ws[split * n + j0 + e] = s;
    }
  }
}

// ---- spmm ------------------------------------------------------------------

constexpr int SPMM_THREADS = 256;
constexpr int SPMM_WARPS = SPMM_THREADS / 32;
constexpr int SPMM_SLOTS = 4;          // rows a lane holds (loads in flight a tile)
constexpr int SPMM_W_BYTES = 16384;    // W's rows staged in shared memory at once
constexpr int SPMM_MIN_BLOCKS = 2;     // resident blocks an SM (caps registers)

// rows of Y a block
template <typename T> __host__ __device__ constexpr int spmm_rows() {
  return SPMM_WARPS * SPMM_SLOTS * Seg<T>::RPW;
}

// y (m) = X (m, k) @ w (k), one column. Block b owns BR rows of y inside
// one row chunk, so they share one mask row: the block lists the chunk's
// populated tiles in ascending order (a ballot pass, 256 tiles at a time),
// stages their rows of w in shared memory, and each warp walks the list
// for its SLOTS x RPW rows (row group g of the block to warp g / SLOTS),
// SLOTS 16-byte loads in flight. A lane sums its own columns in column
// order; the LPR lanes of a row merge by a fixed shuffle tree, and the
// block's rows go through shared memory to one coalesced store. No split,
// no reduce pass, no atomics.
template <typename T, bool VEC>
__global__ void __launch_bounds__(SPMM_THREADS, SPMM_MIN_BLOCKS)
spmm_kernel(const T* __restrict__ x, const T* __restrict__ wt, int64_t m, int64_t k,
            int64_t ldx, int64_t ldw, const int32_t* __restrict__ mask, int64_t mask_cols,
            typename Acc<T>::type* __restrict__ y) {
  using A = typename Acc<T>::type;
  using S = Seg<T>;
  constexpr int P = S::P, LPR = S::LPR, RPW = S::RPW, BR = spmm_rows<T>();
  constexpr int SLOTS = SPMM_SLOTS;
  constexpr int WCAP = SPMM_W_BYTES / (int)(sizeof(A) * TILE);  // tiles staged at once
  static_assert(RC % BR == 0 && WCAP >= 1, "a block's rows lie in one row chunk");
  __shared__ __align__(16) A wsm[WCAP * TILE];
  __shared__ A ys[BR];
  __shared__ int list[SPMM_THREADS];
  __shared__ int warp_n[SPMM_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPR, cl = lane % LPR;
  const int64_t r0 = (int64_t)blockIdx.x * BR;
  const int32_t* mrow = mask + (r0 / RC) * mask_cols;
  const int64_t rw = r0 + (int64_t)warp * SLOTS * RPW + sub;  // slot s: rw + s RPW

  A acc[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) acc[s] = A(0);
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
      // w's rows under the listed tiles g0 .. g0 + gn, zero past k
      for (int e = tid; e < gn * TILE; e += SPMM_THREADS) {
        const int64_t col = (win + list[g0 + e / TILE]) * TILE + e % TILE;
        wsm[e] = col < k ? to_acc(wt[col * ldw]) : A(0);
      }
      __syncthreads();
      for (int g = 0; g < gn; ++g) {
        const int64_t j0 = (win + list[g0 + g]) * TILE;
        const A* wg = wsm + g * TILE;
        A wv[P];
#pragma unroll
        for (int p = 0; p < P; ++p) wv[p] = wg[S::template col<VEC>(cl, p)];
        uint4 xr[SLOTS];
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int64_t r = rw + s * RPW;
          xr[s] = load_seg<T, VEC>(x + r * ldx + j0, r < m, j0, k, cl);
        }
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
#pragma unroll
          for (int p = 0; p < P; ++p) acc[s] = madd(unpack(xr[s], p, x), wv[p], acc[s]);
      }
      __syncthreads();  // wsm is read before the next group is staged
    }
  }
  // the LPR lanes of a row, fixed order; lane cl 0 ends with the sum
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) acc[s] += __shfl_down_sync(0xffffffffu, acc[s], o, LPR);
  if (cl == 0) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) ys[(warp * SLOTS + s) * RPW + sub] = acc[s];
  }
  __syncthreads();
  for (int e = tid; e < BR; e += SPMM_THREADS)
    if (r0 + e < m) y[r0 + e] = ys[e];
}

// ---- the tile products (two or more columns) --------------------------------

constexpr int TILE_STAGES = 4;      // depth of the tile products' cp.async ring
constexpr int XBT_F64_ROWS = 16;    // rows of X a float64 xtv_bs_tile stage holds
constexpr int SP_F64_COLS = 16;     // columns of X a float64 spmm_tile stage holds

// Float64's 80-column tiles (the fold's 70 columns) run on blocks of 4
// warps, two an SM, so that every warp holds 20 independent accumulators,
// which the FP64 tensor cores need to run near their rate (with 10 they
// ran at a quarter of it, PERF.md §6), with a ring one stage shorter so
// that two blocks fit an SM's shared memory.
template <typename T, int BN>
__host__ __device__ constexpr bool f64_wide() {
  return sizeof(T) == 8 && BN == 80;
}
template <typename T, int BN>
__host__ __device__ constexpr int tile_threads() {
  return f64_wide<T, BN>() ? XT_THREADS / 2 : XT_THREADS;
}
template <typename T, int BN>
__host__ __device__ constexpr int tile_stages() {
  return f64_wide<T, BN>() ? TILE_STAGES - 1 : TILE_STAGES;
}

// Resident blocks an SM the tile kernels' launch bounds ask for (they cap
// the registers a thread): one for the 128-column tiles (128 registers of
// float64 accumulators a thread), else two (ops.xtv_bs_blocks_per_sm
// mirrors it)
template <int BN>
__host__ __device__ constexpr int tile_min_blocks() {
  return BN == 128 ? 1 : 2;
}

// xtv_bs_tile's stage rows (twice as many in float32, four times in
// bfloat16: the same bytes), the row pitch of X's stage (4 mod 16 doubles,
// an odd number of 16-byte units in bfloat16) and the dynamic shared
// memory of its ring
template <typename T>
__host__ __device__ constexpr int xbt_bk() {
  return XBT_F64_ROWS * 8 / (int)sizeof(T);
}
template <typename T, int BN>
constexpr int xbt_smem_bytes() {
  return tile_stages<T, BN>() * xbt_bk<T>() * (xt_ldu<T>() + xt_ldw<T, BN>()) * (int)sizeof(T);
}

// spmm_tile's stage: sp_bk columns of X's 128 rows (a quarter, a half or
// the whole of a mask tile: a mask tile of 128 float64 rows, 64 KB, is too
// much for one stage of a 4-deep ring) and the rows of W under them; the
// row pitch of X's stage reads float64 fragments conflict-free (4 mod 16
// doubles), float32 float4 runs and ldmatrix rows (an odd number of
// 16-byte units)
template <typename T>
__host__ __device__ constexpr int sp_bk() {
  return SP_F64_COLS * 8 / (int)sizeof(T) < TILE ? SP_F64_COLS * 8 / (int)sizeof(T) : TILE;
}
template <typename T>
__host__ __device__ constexpr int sp_lda() {
  return sp_bk<T>() + (sizeof(T) == 2 ? 8 : 4);
}
template <typename T, int BN>
__host__ __device__ constexpr int sp_ring_bytes() {
  return tile_stages<T, BN>() * (XT_BM * sp_lda<T>() + sp_bk<T>() * xt_ldw<T, BN>()) *
         (int)sizeof(T);
}

// One stage of spmm_tile's X: rows [r0, r0 + 128) and columns [c0, c0 + W)
// into s (row pitch LD), V elements a copy by NT threads (cp.async of 4
// bytes or more, else through registers, 8 a thread in flight); rows at or
// past m and columns at or past k are zero-filled. A thread copies the
// same columns of every STEP-th row.
template <typename T, int V, int W, int LD, int NT>
__device__ __forceinline__ void load_rows(T* s, const T* __restrict__ x, int64_t ldx,
                                          int64_t r0, int64_t m, int64_t c0, int64_t k,
                                          int tid) {
  constexpr int CPR = W / V, STEP = NT / CPR, N = XT_BM / STEP;
  constexpr int BYTES = V * (int)sizeof(T);
  static_assert(NT % CPR == 0 && XT_BM % STEP == 0, "whole rounds of copies");
  const int rr = tid / CPR, cc = (tid % CPR) * V;
  const int64_t col = c0 + cc, rows = min64(m - r0 - rr, XT_BM);  // rows rr + q STEP < rows
  const int nv = col < k ? (int)min64(V, k - col) : 0;
  const T* p = x + (r0 + rr) * ldx + col;
  T* d = s + rr * LD + cc;
  if constexpr (BYTES >= 4) {
#pragma unroll 4
    for (int q = 0; q < N; ++q) {
      const bool ok = q * STEP < rows && nv > 0;
      cp_async<BYTES>(d + q * STEP * LD, ok ? p + q * STEP * ldx : x, ok ? nv * (int)sizeof(T) : 0);
    }
  } else {
#pragma unroll 8
    for (int q = 0; q < N; ++q)
      d[q * STEP * LD] = q * STEP < rows && nv > 0 ? p[q * STEP * ldx] : zero<T>();
  }
}

// Copies of E elements (E * sizeof(T) bytes: 16, or a bfloat16 pair's 4)
// of the narrow operand's rows [k0, k0 + BK), a warp's lanes along a row,
// by NT threads; the tile's columns past `lim` are not copied.
template <typename T, int E, int BK, int BN, int LD, int NT>
__device__ __forceinline__ void load_narrow_runs(T* s, const Operand<T>& op, const int64_t* off,
                                                 const int* valid, int64_t k0, int64_t r1,
                                                 int lim, int tid) {
  constexpr int CPR = BN / E, CHUNKS = BK * CPR;
#pragma unroll 4
  for (int q = 0; q < (CHUNKS + NT - 1) / NT; ++q) {
    const int e = tid + q * NT, kk = e / CPR, cc = (e % CPR) * E;
    if ((CHUNKS % NT == 0 || e < CHUNKS) && cc < lim) {
      const int64_t row = k0 + kk;
      const int nv = row < r1 ? min(valid[cc], E) : 0;
      cp_async<E * (int)sizeof(T)>(s + kk * LD + cc, nv ? op.p + row * op.ld + off[cc] : op.p,
                                   nv * (int)sizeof(T));
    }
  }
}

// One stage of the narrow operand: rows [k0, k0 + BK) (zeros at or past
// r1) of its tile's first `lim` columns (the fragments read no further)
// into s (row pitch LD), by NT threads: 16-byte copies when op.vec is 1, a
// bfloat16 pair's 4 when 2; else element copies (a bfloat16 one through
// registers), a warp's lanes on consecutive columns of a row or, where a
// column's rows are adjacent (gw 1: a vmapped batch of one-column operands
// read in place), on consecutive rows of a column, so the reads coalesce
// either way.
template <typename T, int BK, int BN, int LD, int NT = XT_THREADS>
__device__ __forceinline__ void load_narrow(T* s, const Operand<T>& op, const int64_t* off,
                                            const int* valid, int64_t k0, int64_t r1, int lim,
                                            int tid) {
  constexpr int V = 16 / (int)sizeof(T);
  if (op.vec == 1) {
    load_narrow_runs<T, V, BK, BN, LD, NT>(s, op, off, valid, k0, r1, lim, tid);
    return;
  }
  if constexpr (sizeof(T) == 2) {
    if (op.vec == 2) {
      load_narrow_runs<T, 2, BK, BN, LD, NT>(s, op, off, valid, k0, r1, lim, tid);
      return;
    }
  }
  constexpr int CHUNKS = BK * BN;
  static_assert(CHUNKS % NT == 0, "whole rounds of copies");
  const bool down = op.gw == 1;
#pragma unroll 8
  for (int q = 0; q < CHUNKS / NT; ++q) {
    const int e = tid + q * NT;
    const int kk = down ? e % BK : e / BN, cc = down ? e / BK : e % BN;
    if (cc < lim) {
      const int64_t row = k0 + kk;
      const bool ok = row < r1 && valid[cc] != 0;
      const T* src = ok ? op.p + row * op.ld + off[cc] : op.p;
      if constexpr (sizeof(T) == 2) {
        s[kk * LD + cc] = ok ? *src : zero<T>();
      } else {
        cp_async<(int)sizeof(T)>(s + kk * LD + cc, src, ok ? (int)sizeof(T) : 0);
      }
    }
  }
}

// The columns of a narrow tile its stages must hold: every one for
// float32 (its FMA step reads them all), else those of its active
// fragments.
template <typename T, int BN>
__device__ __forceinline__ int narrow_columns(int nact) {
  return sizeof(T) == 4 ? BN : 8 * nact;
}

// Block (tile, split): the 128 x BN tile of X[:, c0u..]^T V[:, c0w..] (two
// mask tiles of X's columns) over split s = blockIdx.y's populated row
// chunks (chunks s, s + S, ..., S = gridDim.y),
// written to slot s of ws ([splits][n][c], or the output with one split).
// Warp 0 marks which of the split's chunks are populated in each of the
// tile's mask tiles; the ring walks the chunks with any bit, in ascending
// order, RC / BK stages each, and zero-fills a mask tile's columns of X
// whose bit is clear. A block none of whose chunks is populated writes
// zeros.
template <typename T, int BN>
__global__ void __launch_bounds__(tile_threads<T, BN>(), tile_min_blocks<BN>())
xtv_bs_tile_kernel(const T* __restrict__ x, int64_t m, int64_t n, int64_t ldx, int xvec,
                   const Operand<T> v, const int32_t* __restrict__ mask, int64_t mask_cols,
                   int tiles_u, typename Acc<T>::type* __restrict__ ws) {
  using A = typename Acc<T>::type;
  constexpr int UM = XT_BM, Q = UM / TILE, NT = tile_threads<T, BN>(), NS = tile_stages<T, BN>();

  constexpr int BK = xbt_bk<T>(), LDU = xt_ldu<T>(), LDW = xt_ldw<T, BN>(), SPC = RC / BK;
  constexpr int V = 16 / (int)sizeof(T);
  static_assert(UM % TILE == 0 && RC % BK == 0, "an X tile is whole mask tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int64_t uoff[UM], woff[BN];
  __shared__ int uval[UM], wval[BN];
  __shared__ unsigned on[Q][MAX_CHUNKS / 32];
  __shared__ int count;
  const int tid = threadIdx.x;
  const int64_t c0u = (int64_t)(blockIdx.x % tiles_u) * UM;
  const int64_t c0w = (int64_t)(blockIdx.x / tiles_u) * BN;
  const int64_t split = blockIdx.y, splits = gridDim.y;
  const int nc = (int)(((m + RC - 1) / RC - split + splits - 1) / splits);
  const int64_t ta = c0u / TILE;
  if (tid < 32) {
    int got = 0;
    for (int base = 0; base < nc; base += 32) {
      const bool in = base + tid < nc;
      const int32_t* row = mask + (split + (int64_t)(base + tid) * splits) * mask_cols + ta;
      unsigned any = 0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const unsigned b = __ballot_sync(0xffffffffu, in && ta + q < mask_cols && row[q] != 0);
        if (tid == 0) on[q][base / 32] = b;
        any |= b;
      }
      got += __popc(any);
    }
    if (tid == 0) count = got;
  }
  const Operand<T> xo{x, ldx, 0, 0, (int)n, (int)n, xvec};
  column_table<T, UM, NT>(uoff, uval, xo, c0u, tid);
  column_table<T, BN, NT>(woff, wval, v, c0w, tid);
  __syncthreads();
  const int np = count;
  TileAcc<T, BN, true, NT / 32> acc;
  if (np > 0) {  // uniform over the block
    const int nact = active_fragments<T, BN>(v.cols - c0w), lim = narrow_columns<T, BN>(nact);
    // the ring asks for stages 0, 1, 2, ... in order: every SPC stages it
    // moves to the next populated chunk (the lowest bit left in `left`)
    int word = -1;
    unsigned left = 0, bit = 0;
    int64_t r0 = 0;
    auto load = [&](T* s, int it) {
      if (it % SPC == 0) {
        while (left == 0) {
          ++word;
#pragma unroll
          for (int q = 0; q < Q; ++q) left |= on[q][word];
        }
        bit = left & (0u - left);  // the lowest
        left &= left - 1;
        r0 = (split + (int64_t)(32 * word + __ffs(bit) - 1) * splits) * RC;
      }
      const int64_t k0 = r0 + (int64_t)(it % SPC) * BK;
      // a mask tile's columns whose bit is clear read as rows past the end:
      // zeros
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int64_t rq = on[q][word] & bit ? m : k0;
        T* sq = s + q * TILE;
        if (xvec) {
          load_operand<T, V, BK, TILE, LDU, NT>(sq, x, ldx, uoff + q * TILE, uval + q * TILE,
                                                k0, rq, tid);
        } else if constexpr (sizeof(T) == 2) {
          load_operand_bf16<BK, TILE, LDU, NT>(sq, x, ldx, uoff + q * TILE, uval + q * TILE, k0,
                                               rq, tid);
        } else {
          load_operand<T, 1, BK, TILE, LDU, NT>(sq, x, ldx, uoff + q * TILE, uval + q * TILE,
                                                k0, rq, tid);
        }
      }
      load_narrow<T, BK, BN, LDW, NT>(s + BK * LDU, v, woff, wval, k0, m, lim, tid);
    };
    cp_ring<NS, BK * (LDU + LDW)>(smem, np * SPC, load, [&](const T* su) {
      acc.template stage<BK, LDU, LDW>(su, su + BK * LDU, nact);
    });
  }
  const int64_t c = v.cols;
  ws += split * n * c;
  acc.store([&](int i, int j, A val) {
    const int64_t col = c0u + i, q = c0w + j;
    if (col < n && q < c) ws[col * c + q] = val;
  });
}

// Block (row tile, column tile): Y[r0.., c0w..] (128 x BN: half a row
// chunk) = X[r0..] @ W[:, c0w..] over the populated mask tiles of X's row
// chunk, in
// ascending order, TILE / sp_bk stages each, into y ([m][c], c = W's
// columns). Warp 0 marks the populated tiles (bits in dynamic shared
// memory after the ring, one per mask tile); a block whose chunk has none
// writes zeros.
template <typename T, int BN>
__global__ void __launch_bounds__(tile_threads<T, BN>(), tile_min_blocks<BN>())
spmm_tile_kernel(const T* __restrict__ x, int64_t m, int64_t k, int64_t ldx, int xvec,
                 const Operand<T> w, const int32_t* __restrict__ mask, int64_t mask_cols,
                 typename Acc<T>::type* __restrict__ y) {
  using A = typename Acc<T>::type;
  constexpr int NT = tile_threads<T, BN>(), NS = tile_stages<T, BN>();
  constexpr int BK = sp_bk<T>(), LDA = sp_lda<T>(), LDW = xt_ldw<T, BN>(), SPT = TILE / BK;
  constexpr int V = 16 / (int)sizeof(T);
  static_assert(RC % XT_BM == 0 && TILE % BK == 0, "a block's rows lie in one row chunk");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  unsigned* bits = reinterpret_cast<unsigned*>(smem_raw + sp_ring_bytes<T, BN>());
  __shared__ int64_t woff[BN];
  __shared__ int wval[BN];
  __shared__ int count;
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * XT_BM, c0w = (int64_t)blockIdx.y * BN;
  const int32_t* mrow = mask + (r0 / RC) * mask_cols;
  if (tid < 32) {
    int got = 0;
    for (int64_t base = 0; base < mask_cols; base += 32) {
      const unsigned b =
          __ballot_sync(0xffffffffu, base + tid < mask_cols && mrow[base + tid] != 0);
      if (tid == 0) bits[base / 32] = b;
      got += __popc(b);
    }
    if (tid == 0) count = got;
  }
  column_table<T, BN, NT>(woff, wval, w, c0w, tid);
  __syncthreads();
  const int np = count;
  TileAcc<T, BN, false, NT / 32> acc;
  if (np > 0) {  // uniform over the block
    const int nact = active_fragments<T, BN>(w.cols - c0w), lim = narrow_columns<T, BN>(nact);
    int word = -1;
    unsigned left = 0;
    int64_t t0 = 0;
    auto load = [&](T* s, int it) {
      if (it % SPT == 0) {
        while (left == 0) left = bits[++word];
        t0 = (int64_t)(32 * word + __ffs(left) - 1) * TILE;
        left &= left - 1;
      }
      const int64_t c0 = t0 + (int64_t)(it % SPT) * BK;
      if (xvec) load_rows<T, V, BK, LDA, NT>(s, x, ldx, r0, m, c0, k, tid);
      else load_rows<T, 1, BK, LDA, NT>(s, x, ldx, r0, m, c0, k, tid);
      load_narrow<T, BK, BN, LDW, NT>(s + XT_BM * LDA, w, woff, wval, c0, k, lim, tid);
    };
    cp_ring<NS, XT_BM * LDA + BK * LDW>(smem, np * SPT, load, [&](const T* sa) {
      acc.template stage<BK, LDA, LDW>(sa, sa + XT_BM * LDA, nact);
    });
  }
  const int64_t c = w.cols;
  acc.store([&](int i, int j, A val) {
    const int64_t r = r0 + i, q = c0w + j;
    if (r < m && q < c) y[r * c + q] = val;
  });
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

// The partial pass into ws (or, with one split, into out), then the
// reduce pass, both on the stream.
template <typename T>
int launch_xtv_bs(int vec, const void* x, const void* v, int64_t m, int64_t n, int64_t ldx,
                  int64_t ldv, const int32_t* mask, int64_t mask_cols, int splits, void* ws,
                  void* out, cudaStream_t st) {
  using A = typename Acc<T>::type;
  void* part = splits > 1 ? ws : out;
  const dim3 grid(blocks_for(n, TILE), (unsigned int)splits);
  auto kernel = vec ? xtv_bs_partial_kernel<T, true> : xtv_bs_partial_kernel<T, false>;
  kernel<<<grid, XB_THREADS, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(v), m, n,
                                      ldx, ldv, mask, mask_cols, static_cast<A*>(part));
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  return launch_xtv_reduce<A>(ws, splits, n, out, st);
}

template <typename T>
int launch_spmm(int vec, const void* x, const void* w, int64_t m, int64_t k, int64_t ldx,
                int64_t ldw, const int32_t* mask, int64_t mask_cols, void* y, cudaStream_t st) {
  auto kernel = vec ? spmm_kernel<T, true> : spmm_kernel<T, false>;
  kernel<<<blocks_for(m, spmm_rows<T>()), SPMM_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), m, k, ldx, ldw, mask, mask_cols,
      static_cast<typename Acc<T>::type*>(y));
  return (int)cudaGetLastError();
}

// The dynamic shared memory of `kernel` allowed up to `bytes`, raised when
// a launch asks for more than the last (`set`: the kernel's own, per
// device)
template <typename K>
int allow_smem_up_to(K kernel, int bytes, int (&set)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (set[dev] < bytes) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    set[dev] = bytes;
  }
  return 0;
}

template <typename T, int BN>
int launch_xtv_bs_tile(const T* x, int64_t m, int64_t n, int64_t ldx, int xvec,
                       const Operand<T>& v, const int32_t* mask, int64_t mask_cols, int splits,
                       void* part, cudaStream_t st) {
  const int64_t tiles_u = (n + XT_BM - 1) / XT_BM, tiles = tiles_u * ((v.cols + BN - 1) / BN);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  constexpr int smem = xbt_smem_bytes<T, BN>();
  static bool ready[64] = {};
  const int rc = allow_smem(xtv_bs_tile_kernel<T, BN>, smem, ready);
  if (rc != 0) return rc;
  xtv_bs_tile_kernel<T, BN><<<dim3((unsigned int)tiles, (unsigned int)splits),
                              tile_threads<T, BN>(), smem, st>>>(x, m, n, ldx, xvec, v, mask, mask_cols, (int)tiles_u,
                                    static_cast<typename Acc<T>::type*>(part));
  return (int)cudaGetLastError();
}

// xtv_bs of two or more columns: the tile product's partial pass (into out
// itself with one split) and, with more than one split, the reduce pass
template <typename T>
int xtv_bs_tile_entry(int bn, const void* x, int64_t m, int64_t n, int64_t ldx, int xvec,
                      const Operand<T>& v, const int32_t* mask, int64_t mask_cols, int splits,
                      void* ws, void* out, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  void* part = splits > 1 ? ws : out;
  int rc;
  switch (bn) {
    case 16: rc = launch_xtv_bs_tile<T, 16>(xp, m, n, ldx, xvec, v, mask, mask_cols, splits, part, st); break;
    case 80:
      if constexpr (sizeof(T) != 8) return (int)cudaErrorInvalidValue;
      else rc = launch_xtv_bs_tile<T, 80>(xp, m, n, ldx, xvec, v, mask, mask_cols, splits, part, st);
      break;
    case 128: rc = launch_xtv_bs_tile<T, 128>(xp, m, n, ldx, xvec, v, mask, mask_cols, splits, part, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || splits == 1) return rc;
  return launch_xtv_reduce<typename Acc<T>::type>(ws, splits, n * v.cols, out, st);
}

template <typename T, int BN>
int launch_spmm_tile(const T* x, int64_t m, int64_t k, int64_t ldx, int xvec,
                     const Operand<T>& w, const int32_t* mask, int64_t mask_cols, void* y,
                     cudaStream_t st) {
  const int64_t rows = (m + XT_BM - 1) / XT_BM, cols = (w.cols + BN - 1) / BN;
  const int64_t smem = sp_ring_bytes<T, BN>() + 4 * ((mask_cols + 31) / 32);
  if (rows > INT32_MAX || cols > 65535 || smem > INT32_MAX) return (int)cudaErrorInvalidValue;
  static int set[64] = {};
  const int rc = allow_smem_up_to(spmm_tile_kernel<T, BN>, (int)smem, set);
  if (rc != 0) return rc;
  spmm_tile_kernel<T, BN><<<dim3((unsigned int)rows, (unsigned int)cols), tile_threads<T, BN>(),
                            (int)smem, st>>>(x, m, k, ldx, xvec, w, mask, mask_cols,
                                  static_cast<typename Acc<T>::type*>(y));
  return (int)cudaGetLastError();
}

template <typename T>
int spmm_tile_entry(int bn, const void* x, int64_t m, int64_t k, int64_t ldx, int xvec,
                    const Operand<T>& w, const int32_t* mask, int64_t mask_cols, void* y,
                    cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  switch (bn) {
    case 16: return launch_spmm_tile<T, 16>(xp, m, k, ldx, xvec, w, mask, mask_cols, y, st);
    case 80:
      if constexpr (sizeof(T) != 8) return (int)cudaErrorInvalidValue;
      else return launch_spmm_tile<T, 80>(xp, m, k, ldx, xvec, w, mask, mask_cols, y, st);
    case 128: return launch_spmm_tile<T, 128>(xp, m, k, ldx, xvec, w, mask, mask_cols, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// An operand of the tile products: the narrow one's `cols` columns, column
// j at (j / gw) * gs + j % gw of a row (gw = cols: a plain matrix)
template <typename T>
Operand<T> narrow(const void* p, long long ld, long long gw, long long gs, int vec,
                  long long cols) {
  return Operand<T>{static_cast<const T*>(p), ld, gs, 0, (int)cols, (int)gw, vec};
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

// X^T v over the populated blocks for one column of v (two or more are
// repro_xtv_bs_tile's): the partial pass into ws ([splits, n] of the
// accumulation dtype; split s holds row chunks s, s + splits, s + 2 splits,
// ...) and, with more than one split, the reduce pass into out ([n, 1]
// contiguous), both on the stream; one split writes out itself. splits: at
// most the row chunks and 65,535. vec: X's base and ldx are 16-byte aligned
// (16-byte loads), else element loads.
int repro_xtv_bs(int dtype, int vec, const void* x, const void* v, long long m, long long n,
                 long long ldx, long long ldv, const void* mask, long long mask_cols,
                 int splits, void* ws, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  if (splits <= 0 || splits > 65535 || splits > (m + RC - 1) / RC)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF64:
      return launch_xtv_bs<double>(vec, x, v, m, n, ldx, ldv, mk, mask_cols, splits, ws, out, st);
    case kF32:
      return launch_xtv_bs<float>(vec, x, v, m, n, ldx, ldv, mk, mask_cols, splits, ws, out, st);
    case kBF16:
      return launch_xtv_bs<__nv_bfloat16>(vec, x, v, m, n, ldx, ldv, mk, mask_cols, splits, ws,
                                          out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y ([m, 1] contiguous, the accumulation dtype) = X @ w for one column of
// w (two or more are repro_spmm_tile's). vec as for xtv_bs.
int repro_spmm(int dtype, int vec, const void* x, const void* w, long long m, long long k,
               long long ldx, long long ldw, const void* mask, long long mask_cols, void* y,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  switch (dtype) {
    case kF64: return launch_spmm<double>(vec, x, w, m, k, ldx, ldw, mk, mask_cols, y, st);
    case kF32: return launch_spmm<float>(vec, x, w, m, k, ldx, ldw, mk, mask_cols, y, st);
    case kBF16:
      return launch_spmm<__nv_bfloat16>(vec, x, w, m, k, ldx, ldw, mk, mask_cols, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// X^T V over the populated blocks as a tile product (V of c >= 2 columns,
// column j at v + (j / vgw) * vgs + j % vgw of a row, rows ldv apart; bn
// its tile width, 16 or 128, or 80 in float64): the partial pass into ws ([splits, n, c]
// of the accumulation dtype; split s holds row chunks s, s + splits, ...)
// and, with more than one split, the reduce pass into out ([n, c]
// contiguous); one split writes out itself. splits: at most the row chunks
// and 65,535, each split at most MAX_CHUNKS chunks. xvec: 16-byte copies
// of X (base and ldx 16-byte aligned), else element copies; vvec: 1 for
// 16-byte copies of V (base, ldv and vgs aligned, vgw a multiple of the
// copy), 2 for 4-byte copies of bfloat16 pairs (4-byte aligned, vgw even),
// else 0: element copies.
int repro_xtv_bs_tile(int dtype, int bn, const void* x, long long m, long long n, long long ldx,
                      int xvec, const void* v, long long ldv, long long vgw, long long vgs,
                      int vvec, long long c, const void* mask, long long mask_cols, int splits,
                      void* ws, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  const long long chunks = (m + RC - 1) / RC;
  if (splits <= 0 || splits > 65535 || splits > chunks ||
      (chunks + splits - 1) / splits > MAX_CHUNKS || n > INT32_MAX || c > INT32_MAX || vgw <= 0)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF64:
      return xtv_bs_tile_entry<double>(bn, x, m, n, ldx, xvec, narrow<double>(v, ldv, vgw, vgs, vvec, c),
                                       mk, mask_cols, splits, ws, out, st);
    case kF32:
      return xtv_bs_tile_entry<float>(bn, x, m, n, ldx, xvec, narrow<float>(v, ldv, vgw, vgs, vvec, c),
                                      mk, mask_cols, splits, ws, out, st);
    case kBF16:
      return xtv_bs_tile_entry<__nv_bfloat16>(
          bn, x, m, n, ldx, xvec, narrow<__nv_bfloat16>(v, ldv, vgw, vgs, vvec, c), mk,
          mask_cols, splits, ws, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y ([m, c] contiguous, the accumulation dtype) = X @ W over the populated
// blocks as a tile product (W of c >= 2 columns, laid out as repro_xtv_bs_
// tile's V; bn as there). xvec / wvec as for repro_xtv_bs_tile.
int repro_spmm_tile(int dtype, int bn, const void* x, long long m, long long k, long long ldx,
                    int xvec, const void* w, long long ldw, long long wgw, long long wgs,
                    int wvec, long long c, const void* mask, long long mask_cols, void* y,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  if (c > INT32_MAX || wgw <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF64:
      return spmm_tile_entry<double>(bn, x, m, k, ldx, xvec, narrow<double>(w, ldw, wgw, wgs, wvec, c),
                                     mk, mask_cols, y, st);
    case kF32:
      return spmm_tile_entry<float>(bn, x, m, k, ldx, xvec, narrow<float>(w, ldw, wgw, wgs, wvec, c),
                                    mk, mask_cols, y, st);
    case kBF16:
      return spmm_tile_entry<__nv_bfloat16>(
          bn, x, m, k, ldx, xvec, narrow<__nv_bfloat16>(w, ldw, wgw, wgs, wvec, c), mk,
          mask_cols, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
