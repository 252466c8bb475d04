// Flash attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T
// + mask) V with grouped-query heads.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/kernel.py: flash_pallas (_flash_kernel).
// It computes what that kernel computes, not block for block:
//   * q is (B, Sq, Hq, dqk), k (B, Sk, Hkv, dqk) and v (B, Sk, Hkv, dv),
//     read and written through their (B, S, H) strides (the head dim
//     contiguous), so the reference's transpose to (B*H, S, hd) is never
//     made; kv head = q head / G with G = Hq / Hkv. dv is dqk, except for
//     MLA (DeepSeek-V2), whose heads are dqk 192 (128 + a 64-wide RoPE part)
//     and dv 128: the reference pads v to 192 and slices the output back,
//     this kernel reads v at its own width (a third less PV work, and the
//     output registers of dv 128);
//   * the online-softmax state m, l and the accumulator stay in float32;
//     the scale multiplies the float32 scores; masked scores are
//     NEG_INF = -1e30 (not -inf); p is cast to v's dtype before the PV
//     product; the output is acc / max(l, 1e-30) in q's dtype;
//   * causal: qpos >= kpos with no offset (prefill, Sq == Sk); kv blocks
//     past the last causally visible one are never visited (the Pallas
//     kernel's pl.when skip); non-causal attends to every key;
//   * ragged lengths: rows past Sq and keys past Sk are masked in the
//     kernel; nothing is padded (the Pallas wrapper asserts Sq % bq == 0).
//
// What bounds it on this card: at the serving path's prefill shape (B 8,
// S 2048, 16/8 heads, hd 128, causal) one call is ~1.4e11 operations
// against ~0.2 GB, so it is bound by the tensor cores, and only wgmma
// reaches their full rate; the scores' exponentials run on the much slower
// MUFU pipe beside them. A kernel that loads a tile, then computes on it,
// also leaves the tensor cores idle for every load's latency.
//
// What the bfloat16 design does about it: both products run on wgmma
// (m64n{BN}k16 for S = Q K^T with Q and K from shared memory;
// m64n{hd}k16 for O += P V with P from registers, in the layout S's
// accumulator already has). One CTA per (128 q rows, q head, batch) holds two consumer
// warpgroups of 64 rows and one producer warp, one thread of which issues
// TMA loads: Q once, then K and V tiles of BN rows into a two-stage ring
// guarded by full/empty mbarriers, so the next tile's load runs under this
// tile's products. One warpgroup's softmax runs under the other's wgmma,
// and each warpgroup issues the next tile's Q K^T right behind its P V.
// The tiles are 128-byte swizzled (64-byte at hd 32), as TMA writes them
// and wgmma reads them, free of bank conflicts. TMA zero-fills rows past
// Sq and Sk; the kernel still masks them, and only in the tiles that cross
// the diagonal or the ragged edge. log2 e is folded into the float32 scale
// so that each score takes one exp2.
//
// Two choices differ from the textbook Hopper layout, both measured on an
// H100 (tools/flash_variants.py; PERF.md): ptxas caps every thread of this
// kernel at 168 registers (it counts the 288 threads as three warpgroups,
// 65,536 / 384) and holds the consumers' code to that cap even where
// setmaxnreg.inc asks for 240; at hd 128, with kv tiles of 128 rows, the
// consumer needs more (two 64 x 128 float32 accumulators and P) and
// spills. So no setmaxnreg is issued, and BN is 64 at dv 128 (128 at hd 32
// and 64, which fit). The (192, 128) instantiation holds what (128, 128)
// holds in registers: S's k-loop takes 12 steps over three 64-column
// panels of Q and K in place of 8 over two, and the tiles (Q 48 KB, two
// stages of K 24 KB and V 16 KB) take 129 KB of shared memory.
//
// The float32 instantiation (a check of the algorithm at full precision;
// TF32 would round the inputs) runs on the FMA pipes: four threads per q
// row, each holding a quarter of the head dim. Each output tile is written
// by one CTA, with no atomics, so results are bitwise repeatable.
//
// Interface: one plain C entry point for ctypes. It takes device pointers,
// sizes, element strides and the CUDA stream, encodes the bf16 tensor maps
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so nothing
// links libcuda), launches one kernel on that stream, never synchronises
// or allocates (the Python wrapper owns every buffer), and returns a CUDA
// error code: cudaGetLastError() after the launch, or the reason it was
// not launched.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

enum DtypeCode : int { kF32 = 1, kBF16 = 2 };

constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, G, causal;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  float scale;
};

// kv blocks of bn rows a CTA whose first q row is m0 (of bm) visits: every
// block up to the last one holding a key at or before its last row
// (causal), all of them otherwise.
__device__ __forceinline__ int visible_blocks(const Params& p, int m0, int bm,
                                              int bn) {
  int n = (p.Sk + bn - 1) / bn;
  if (p.causal) {
    int last = (m0 + bm - 1) / bn + 1;
    n = last < n ? last : n;
  }
  return n;
}

// ---- bfloat16: wgmma + TMA, warp-specialised ------------------------------

constexpr int NWG = 2;  // consumer warpgroups, 64 q rows each
constexpr int BM = 64 * NWG;  // q rows per CTA
constexpr int STAGES = 2;  // K/V ring depth
constexpr int CONSUMERS = 128 * NWG;  // threads of the consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp

// Shared-memory tiles for q/k head dim DQK and v head dim DV. TMA writes
// each tile as panels of PW columns (the swizzle span: 128 bytes, or 64 at
// hd 32), each panel rows x PW, 1024-byte aligned, in the hardware's
// swizzled order; the wgmma descriptors read the same layout. A ring stage
// holds one K tile and then one V tile.
template <int DQK, int DV>
struct Tile {
  // kv rows per tile: 128, but 64 at dv 128, where a 64 x 128 float32 S
  // beside the 64 x 128 accumulator spills (ptxas holds this kernel to
  // 168 registers a thread)
  static constexpr int BN = DV == 128 ? 64 : 128;
  static constexpr int PW = DQK < 64 ? DQK : 64;  // columns per panel
  static_assert((DV < 64 ? DV : 64) == PW && DQK % PW == 0 && DV % PW == 0,
                "q/k and v tiles share one panel width");
  static constexpr int SW = PW * 2;  // swizzle span and row pitch, bytes
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;  // descriptor: 128B / 64B
  static constexpr uint32_t Q_BYTES = BM * DQK * 2;
  static constexpr uint32_t K_BYTES = BN * DQK * 2;  // one K tile
  static constexpr uint32_t V_BYTES = BN * DV * 2;   // one V tile
  static constexpr uint32_t STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr uint32_t SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024;
};

// One TMA box of a 4-D (hd, H, S, B) tensor map into shared memory; its
// bytes complete on the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
       | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
       | (uint64_t)layout << 62;
}

// reg_fence (sm90.cuh) for wgmma's A fragments held in registers
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// D (64 x 64, f32) = or += A (64 x 16, smem) B (64 x 16, smem, K-major); the
// descriptors are da + a_off and db + b_off (16-byte units), added here so
// that only the two bases stay live across the loop
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                              uint32_t a_off, uint32_t b_off,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b, o;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "cvt.u64.u32 o, %34;\nadd.s64 a, %32, o;\n"
      "cvt.u64.u32 o, %35;\nadd.s64 b, %33, o;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, a, b, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(a_off), "r"(b_off), "r"(accumulate));
}

// D (64 x 128, f32) = or += A (64 x 16, smem) B (128 x 16, smem, K-major); the
// descriptors are da + a_off and db + b_off (16-byte units), added here so
// that only the two bases stay live across the loop
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                              uint32_t a_off, uint32_t b_off,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b, o;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "cvt.u64.u32 o, %66;\nadd.s64 a, %64, o;\n"
      "cvt.u64.u32 o, %67;\nadd.s64 b, %65, o;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, a, b, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(a_off), "r"(b_off), "r"(accumulate));
}

// D (64 x 32, f32) += A (64 x 16, bf16 registers) B (16 x 32, smem,
// MN-major); the descriptor is db + b_off (16-byte units)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t a[4], uint64_t db,
                                              uint32_t b_off) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 b, o;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "cvt.u64.u32 o, %21;\nadd.s64 b, %20, o;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, b, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(b_off), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) B (16 x 64, smem,
// MN-major); the descriptor is db + b_off (16-byte units)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t a[4], uint64_t db,
                                              uint32_t b_off) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 b, o;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "cvt.u64.u32 o, %37;\nadd.s64 b, %36, o;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, b, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(b_off), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) B (16 x 128, smem,
// MN-major); the descriptor is db + b_off (16-byte units)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t a[4], uint64_t db,
                                              uint32_t b_off) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 b, o;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "cvt.u64.u32 o, %69;\nadd.s64 b, %68, o;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, b, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(b_off), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t da, uint64_t db,
                                         uint32_t a_off, uint32_t b_off, int acc) {
  if constexpr (N == 128) wgmma_ss_n128(s, da, db, a_off, b_off, acc);
  else wgmma_ss_n64(s, da, db, a_off, b_off, acc);
}

template <int DV>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t a[4], uint64_t db,
                                         uint32_t b_off) {
  if constexpr (DV == 128) wgmma_rs_n128(o, a, db, b_off);
  else if constexpr (DV == 64) wgmma_rs_n64(o, a, db, b_off);
  else wgmma_rs_n32(o, a, db, b_off);
}

// Issue (and commit, not wait for) S = Q K^T of kv tile j: this
// warpgroup's 64 q rows (Q's descriptor base q_desc) against the BN keys of
// the tile's ring stage, once the tile has landed.
template <int DQK, int DV>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<DQK, DV>::BN / 2],
                                         uint64_t q_desc, uint8_t* kvs,
                                         uint64_t* full_k, int j) {
  using T = Tile<DQK, DV>;
  const int st = j % STAGES;
  mbar_wait(&full_k[st], (j / STAGES) & 1);
  const uint64_t k_desc = desc(smem_u32(kvs + st * T::STAGE_BYTES), 16,
                               8 * T::SW, T::LAYOUT);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const uint32_t col = (kk * 16 % T::PW) * 2, panel = kk * 16 / T::PW;
    wgmma_qk<T::BN>(s, q_desc, k_desc, (panel * BM * T::SW + col) >> 4,
                    (panel * T::BN * T::SW + col) >> 4, kk > 0);
  }
  wgmma_commit();
}

// two floats as a bf16x2 register, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// One CTA per (128 q rows, q head, batch): warps 0-7 are two consumer
// warpgroups of 64 q rows each, warp 8 the producer, one thread of which
// loads Q once and K/V tiles of BN rows into a STAGES-deep ring (full/empty
// mbarriers). Each consumer warpgroup runs S = Q K^T (wgmma, both operands
// from swizzled shared memory, K K-major), the online softmax on the S
// registers, and O += P V (wgmma, P from registers in the A-fragment
// layout that S's accumulator already has, V MN-major), issues the next
// tile's S behind it, and releases the stage once P V is done.
// Accumulator layout of wgmma m64nN (w = warp in the warpgroup,
// g = lane / 4, t = lane % 4): d[4j + e] is row 16w + g + 8 (e >= 2),
// column 8j + 2t + (e & 1).
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Tile<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kvs = qs + T::Q_BYTES;  // stage s: K, then V, at s * STAGE_BYTES

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest sweeps first
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / p.G;
  const int n_kv = visible_blocks(p, m0, BM, T::BN);
  // the warpgroup's role (NWG: the producer), uniform across each warp
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == NWG) {
    // ---- producer: one thread issues every load
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(full_q, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DQK; c += T::PW)
        tma_load(smem_u32(qs) + c / T::PW * BM * T::SW, &tq, c, hq, m0, b, full_q);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % STAGES;
        mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);  // round 0 passes
        const uint32_t kdst = smem_u32(kvs + st * T::STAGE_BYTES);
        const uint32_t vdst = kdst + T::K_BYTES;
        mbar_expect_tx(&full_k[st], T::K_BYTES);
#pragma unroll
        for (int c = 0; c < DQK; c += T::PW)
          tma_load(kdst + c / T::PW * T::BN * T::SW, &tk, c, hk, j * T::BN, b, &full_k[st]);
        mbar_expect_tx(&full_v[st], T::V_BYTES);
#pragma unroll
        for (int c = 0; c < DV; c += T::PW)
          tma_load(vdst + c / T::PW * T::BN * T::SW, &tv, c, hk, j * T::BN, b, &full_v[st]);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows m0 + 64 wg .. + 63
    const int wg = role, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row_first = m0 + wg * 64;
    const int r0 = row_first + (threadIdx.x >> 5 & 3) * 16 + g, r1 = r0 + 8;
    // descriptor bases: K-major Q and K (8-row groups 8 * SW apart), MN-major
    // V (8-row groups 8 * SW apart along k, PW-column panels BN * SW apart
    // along n); each k-step adds its offset in 16-byte units
    const uint64_t q_desc = desc(smem_u32(qs) + wg * 64 * T::SW, 16, 8 * T::SW, T::LAYOUT);
    constexpr int NT = T::BN / 8;  // 8-column tiles of S

    float s[T::BN / 2], o[DV / 2];
#pragma unroll
    for (int i = 0; i < T::BN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
    uint32_t pf[T::BN / 16][4];

    // exp(x) = exp2(x log2 e): log2 e folds into the float32 scale, so each
    // score takes one exp2 (MUFU ex2) in place of expf's longer sequence
    const float sc = p.scale * 1.4426950408889634f;
    mbar_wait(full_q, 0);
    issue_qk<DQK, DV>(s, q_desc, kvs, full_k, 0);
    wgmma_wait<0>();
    reg_fence(s);
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % STAGES;
      const int n0 = j * T::BN;

      // scale in float32, mask (only tiles across the diagonal or the
      // ragged edge), online softmax over the tile
      const bool edge = (p.causal && n0 + T::BN - 1 > row_first) || n0 + T::BN > p.Sk;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * nt + e] * sc;
          if (edge) {
            const int col = n0 + nt * 8 + 2 * t + (e & 1);
            const int row = (e < 2) ? r0 : r1;
            if (col >= p.Sk || (p.causal && col > row)) x = NEG_INF;
          }
          s[4 * nt + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        alpha[h] = exp2f(m_run[h] - m_new);
        m_run[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < T::BN / 2; ++i) {
        s[i] = exp2f(s[i] - m_run[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l_run[h] = l_run[h] * alpha[h] + sum[h];
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // P (bf16) as A fragments: k-step kk is S's 8-column tiles 2kk, 2kk+1
#pragma unroll
      for (int kk = 0; kk < T::BN / 16; ++kk) {
        pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V: V's rows are the k dimension, its columns (N) contiguous
      mbar_wait(&full_v[st], (j / STAGES) & 1);
      const uint64_t v_desc = desc(smem_u32(kvs + st * T::STAGE_BYTES + T::K_BYTES),
                                   T::BN * T::SW, 8 * T::SW, T::LAYOUT);
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::BN / 16; ++kk)
        wgmma_pv<DV>(o, pf[kk], v_desc, kk * 16 * T::SW >> 4);
      wgmma_commit();
      // the next tile's scores run on the tensor cores right behind it
      if (j + 1 < n_kv) {
        issue_qk<DQK, DV>(s, q_desc, kvs, full_k, j + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      reg_fence(o);
      reg_fence(pf);
      mbar_arrive(&empty[st]);  // this stage's K and V are read
      wgmma_wait<0>();
      reg_fence(s);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.osb + hq * p.osh;
    const float d0 = fmaxf(l_run[0], 1e-30f), d1 = fmaxf(l_run[1], 1e-30f);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int col = i * 8 + 2 * t;
      if (r0 < p.Sq)
        *reinterpret_cast<uint32_t*>(out + r0 * p.oss + col) =
            pack_bf16(o[4 * i] / d0, o[4 * i + 1] / d0);
      if (r1 < p.Sq)
        *reinterpret_cast<uint32_t*>(out + r1 * p.oss + col) =
            pack_bf16(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
    }
  }
}

// ---- float32: FMA pipes ----------------------------------------------------

constexpr int F_BM = 64;       // q rows per CTA
constexpr int F_BN = 32;       // kv rows per block
constexpr int F_THREADS = 256; // four per q row

template <int DQK, int DV>
__global__ void __launch_bounds__(F_THREADS)
flash_f32_kernel(const Params p) {
  // float4s per thread per row (a quarter of the head dim) and per row, of
  // q/k and of v
  constexpr int QV4 = DQK / 16, OV4 = DV / 16, RK = DQK / 4, RV = DV / 4;
  __shared__ __align__(16) float4 ks[F_BN * RK];
  __shared__ __align__(16) float4 vs[F_BN * RV];

  const int m0 = (gridDim.x - 1 - blockIdx.x) * F_BM;
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / p.G;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = m0 + (tid >> 2);
  const float* q = static_cast<const float*>(p.q) + b * p.qsb + hq * p.qsh;
  const float* k = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* v = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;

  // this thread's float4s of q: part, part + 4, ... (conflict-free reads)
  float4 qv[QV4], acc[OV4];
#pragma unroll
  for (int i = 0; i < QV4; ++i)
    qv[i] = row < p.Sq
        ? reinterpret_cast<const float4*>(q + row * p.qss)[part + 4 * i]
        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < OV4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_run = NEG_INF, l_run = 0.f;

  const int n_kv = visible_blocks(p, m0, F_BM, F_BN);
  for (int j = 0; j < n_kv; ++j) {
    const int n0 = j * F_BN;
    __syncthreads();
    for (int c = tid; c < F_BN * RK; c += F_THREADS) {
      const int r = c / RK, cc = c % RK;
      ks[c] = n0 + r < p.Sk
          ? reinterpret_cast<const float4*>(k + (n0 + r) * p.kss)[cc]
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int c = tid; c < F_BN * RV; c += F_THREADS) {
      const int r = c / RV, cc = c % RV;
      vs[c] = n0 + r < p.Sk
          ? reinterpret_cast<const float4*>(v + (n0 + r) * p.vss)[cc]
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    float s[F_BN];
    float mx = NEG_INF;
#pragma unroll
    for (int n = 0; n < F_BN; ++n) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < QV4; ++i) {
        const float4 kx = ks[n * RK + part + 4 * i];
        d = fmaf(qv[i].x, kx.x, d);
        d = fmaf(qv[i].y, kx.y, d);
        d = fmaf(qv[i].z, kx.z, d);
        d = fmaf(qv[i].w, kx.w, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      float x = d * p.scale;
      const int col = n0 + n;
      if (col >= p.Sk || (p.causal && col > row)) x = NEG_INF;
      s[n] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < F_BN; ++n) {
      s[n] = expf(s[n] - m_new);
      sum += s[n];
    }
    l_run = l_run * alpha + sum;
#pragma unroll
    for (int i = 0; i < OV4; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
    }
#pragma unroll
    for (int n = 0; n < F_BN; ++n) {
#pragma unroll
      for (int i = 0; i < OV4; ++i) {
        const float4 vx = vs[n * RV + part + 4 * i];
        acc[i].x = fmaf(s[n], vx.x, acc[i].x);
        acc[i].y = fmaf(s[n], vx.y, acc[i].y);
        acc[i].z = fmaf(s[n], vx.z, acc[i].z);
        acc[i].w = fmaf(s[n], vx.w, acc[i].w);
      }
    }
  }

  if (row < p.Sq) {
    float4* out = reinterpret_cast<float4*>(static_cast<float*>(p.o) + b * p.osb +
                                            hq * p.osh + row * p.oss);
    const float d = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int i = 0; i < OV4; ++i)
      out[part + 4 * i] = make_float4(acc[i].x / d, acc[i].y / d, acc[i].z / d, acc[i].w / d);
  }
}

// ---- host side --------------------------------------------------------------

// A 4-D (hd, H, S, B) bf16 tensor map over the tensor's own strides
// (elements), whose box is one swizzle panel (T::PW columns) of `rows`
// sequence rows of one head of one batch.
template <class T>
int encode(CUtensorMap* map, const void* base, int hd, int H, int S, int B,
           int64_t sh, int64_t ss, int64_t sb, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::PW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros past the edge
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DQK, int DV>
int launch_bf16(const Params& p, int B, int Hq, int Hkv, cudaStream_t st) {
  using T = Tile<DQK, DV>;
  auto kernel = flash_bf16_kernel<DQK, DV>;
  // once per device: the dynamic shared memory beyond 48 KB
  static bool ready[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = encode<T>(&tq, p.q, DQK, Hq, p.Sq, B, p.qsh, p.qss, p.qsb, BM);
  if (rc == 0) rc = encode<T>(&tk, p.k, DQK, Hkv, p.Sk, B, p.ksh, p.kss, p.ksb, T::BN);
  if (rc == 0) rc = encode<T>(&tv, p.v, DV, Hkv, p.Sk, B, p.vsh, p.vss, p.vsb, T::BN);
  if (rc != 0) return rc;
  dim3 grid((p.Sq + BM - 1) / BM, Hq, B);
  flash_bf16_kernel<DQK, DV><<<grid, THREADS, T::SMEM, st>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch(int dtype, const Params& p, int B, int Hq, int Hkv, cudaStream_t st) {
  if (dtype == kBF16) return launch_bf16<DQK, DV>(p, B, Hq, Hkv, st);
  dim3 grid((p.Sq + F_BM - 1) / F_BM, Hq, B);
  flash_f32_kernel<DQK, DV><<<grid, F_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, hd), k (B, Sk, Hkv, hd), v (B, Sk, Hkv, dv), o (B, Sq, Hq,
// dv); strides in elements (batch, sequence, head; the head dim is
// contiguous). (hd, dv) is one of (32, 32), (64, 64), (128, 128) and
// (192, 128). Returns a CUDA error code (0 on a successful launch).
int repro_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Sk, int Hq, int Hkv, int hd, int dv,
                    int64_t qsb, int64_t qss, int64_t qsh,
                    int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh,
                    int64_t osb, int64_t oss, int64_t osh,
                    int causal, float scale, void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || B <= 0 || Sq <= 0 || Sk <= 0 ||
      Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, Sq, Sk, Hq / Hkv, causal,
           qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 192 && dv == 128) return launch<192, 128>(dtype, p, B, Hq, Hkv, st);
  if (hd != dv) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch<32, 32>(dtype, p, B, Hq, Hkv, st);
    case 64: return launch<64, 64>(dtype, p, B, Hq, Hkv, st);
    case 128: return launch<128, 128>(dtype, p, B, Hq, Hkv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
