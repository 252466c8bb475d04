// Chunked RWKV-6 WKV recurrence for Hopper (sm_90a), the prefill half of
// the time-mix:
//   y_t = r_t^T (S_{t-1} + u ⊙ k_t v_t^T),   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
// computed chunk by chunk as wkv_chunked (src/repro_torch/kernels/rwkv6/ref.py).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rwkv6/kernel.py:
// wkv6_pallas (_wkv_kernel). That kernel sweeps the chunks of a (batch,
// head) in order, carrying the float32 (dh, dh) state in scratch. Here the
// sweep is split into two passes, launched by one C call on one stream:
//
//   1. wkv6_state_kernel: one CTA per (tile of ET value columns, head,
//      batch) sweeps the chunks in order, holding its (dh x ET) slice of
//      the state in registers (columns of S are independent: S[:, e]
//      depends on v[:, e] only). For each chunk it writes S_in, the state
//      entering the chunk, to a workspace (B, H, n_chunks, dh, dh) float32
//      laid out [e][d], then S <- diag(e^lw_last) S + (k ⊙ e^(lw_last -
//      lw))^T v. The next chunk's k, v and logw are copied into shared
//      memory by cp.async while this one is computed; each thread sums
//      its own run of logw and a quad's shuffles join the runs (no block
//      barrier inside the scan). The final state goes to sout.
//   2. wkv6_output_kernel: one CTA per (chunk, head, batch), in any order;
//      it copies the chunk's r, k, logw, u, v and S_in into shared memory
//      at once (cp.async), then warp i owns the chunk's rows 16i .. 16i+15
//      (one m16 tile) and computes their y = (r ⊙ e^lx) S_in + the bonus
//      diagonal + the strictly causal sub-block pairs (i, a), a <= i.
//
// The pair factorisation keeps the reference's boundaries (lx[t0] on the
// diagonal pair, the end of sub-block a otherwise) and computes every
// factor from the sub-block's own cumulative sums, so no exponent leaves
// [-SUB*MAX_DECAY, SUB*MAX_DECAY] except toward an exact underflow, as the
// reference's own far pairs do. With lxl/lwl the exclusive/inclusive sums
// of logw inside a sub-block and T[a] a sub-block's total:
//   L  = r e^lxl                   (the row block's left factor, <= |r|)
//   Kd = k e^-lwl                  (the diagonal pair's keys, base lx[t0])
//   Kt = k e^(T - lwl)             (an earlier block's keys, base lw[end a])
//   G[i][a] = e^(T[a+1] + .. + T[i-1])   (<= 1; the pair's middle factor)
//   F[i]    = e^(T[0] + .. + T[i-1])     (= e^lx[t0]: the inter-chunk factor)
// so that A(i, a) = (L ⊙ G[i][a]) Kt_a^T, A(i, i) = L Kd^T masked strictly
// causal with the bonus Σ_d r u k on its diagonal, and y = (L ⊙ F[i]) S_in
// + Σ_a A(i, a) V_a, summed in that fixed order. Cumulative sums are kept
// in log2 units (logw times log2 e as it is read), so each factor is one
// ex2.approx (relative error ~2^-22).
//
// Every product runs on the tensor cores as mma.sync.m16n8k8 TF32 with
// float32 accumulation (a 16-row sub-block pair is one m16 tile; wgmma's
// 64-row minimum does not fit the 16-row factorisation). The bfloat16
// instantiation rounds each operand to TF32 once, to nearest with ties
// away from zero (cvt.rna's rounding, done as an integer add of half an
// ulp whose low bits the mma ignores): r, k and v in
// bf16 are exact in TF32, so what is rounded is L, Kd, Kt, A, S_in and
// the state pass's decayed keys, each by at most 2^-11 of its term. The
// float32 instantiation runs 3xTF32 (hi = tf32(x), lo = tf32(x - hi); a·b
// ~ lo·hi + hi·lo + hi·hi), float32-accurate. Each mma's k index is
// permuted so that a thread's two operands of a k-step are adjacent
// (8-byte loads), and each output sub-block's rows are permuted so that a
// thread holds two consecutive time rows.
//
// What bounds it on this card, and what the design does about it: at the
// serving path's shape (B 8, S 2048, H 40, dh 64, C 128) the least time is
// set by bytes (~0.51 GB: r, k, v, y in bf16 and logw in float32, 0.153 ms
// at 3.35 TB/s); the two passes move ~1.0 GB (pass 1 reads k, v, logw and
// writes the 84 MB of S_in; pass 2 reads r, k, v, logw, S_in and writes
// y), so the design's own floor is ~0.30 ms. Pass 1 runs 640 CTAs of 8
// warps (2 a SM, bf16) instead of one CTA of 8 warps per (batch, head),
// each thread's suffix sums and exponentials independent within 4 rows;
// pass 2 runs 5,120 CTAs of 8 warps (2 a SM) with no sequential
// dependence. On an H100 SXM (700 W) the path's call takes ~0.42 ms, state
// pass ~0.17 and output pass ~0.25 (tools/wkv6_ab.py), each at ~70 % of
// its share of the memory rate: at 2 CTAs a SM, a pass-2 CTA's loads stop
// while its warps compute, and both passes execute as many instructions as
// they move bytes (TF32 rounding, exponentials, scans, copies). The chunk
// of the serving path (FIXED_C) is compiled with its loops unrolled; other
// chunks run the same code with C read at run time. Every output entry is
// summed by one thread in a fixed order: no atomics, results bitwise
// repeatable. A fused single pass with a look-back across chunks, and
// wgmma, are later work.
//
// Deliberate departures from the Pallas kernel:
//   * layout: r, k, v, logw and y are read and written in the model layout
//     (B, S, H, dh) through their (batch, sequence, head) strides, u as
//     (H, dh); the reference's transpose to (B*H, S, dh) is never made;
//   * ragged S: any S >= 1 runs; rows past S are wkv_chunked's zero
//     padding (r = k = v = 0, logw = 0, an exact no-op) and are not stored
//     (the Pallas kernel asserts S % C == 0).
//
// Interface: one plain C entry point for ctypes. It takes device pointers
// (the workspace included), sizes, element strides and the CUDA stream,
// launches both passes on that stream, never synchronises or allocates
// (the Python wrapper owns every buffer), and returns cudaGetLastError()
// (or the error of setting a kernel's shared-memory size).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DtypeCode : int { kF32 = 1, kBF16 = 2 };

constexpr int SUB = 16;    // sub-block rows: one m16 tile, one warp of pass 2
constexpr int ET = 32;     // value columns of a pass-1 CTA (ET/16 m16 tiles)
constexpr int MAX_C = 128;
constexpr int OUT_MIN_BLOCKS = 2;  // pass-2 CTAs resident on an SM (bf16)
constexpr int FIXED_C = 128;       // the chunk compiled with its loops unrolled
                                   // (others run the generic kernels; 0: none)

// a pass-1 CTA's value columns at head dim DH
template <int DH>
constexpr int kEt = ET < DH ? ET : DH;

// 3xTF32 for float32 inputs, one TF32 rounding for bfloat16 (exact inputs)
template <typename T>
constexpr bool kSplit = std::is_same<T, float>::value;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  void* y;
  float* sout;
  float* ws;  // S_in of every chunk: (B, H, n_c, dh, dh), [e][d]
  int S, H, C, n_c;
  int64_t rsb, rss, rsh, ksb, kss, ksh, vsb, vss, vsh, wsb, wss, wsh, ysb, yss, ysh;
};

// ---- element access ------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// two adjacent elements as float32 (8- or 4-byte aligned)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- cp.async --------------------------------------------------------------

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [0, rows) of CH 16-byte chunks each from `src` (row stride `stride`
// elements) into shared memory at element offset dst(row, chunk); rows at
// or past `valid` are zero-filled. Thread `tid` of `threads` (a multiple of
// CH) copies chunk tid % CH of rows tid / CH, + threads / CH, ...
template <int CH, typename T, typename Dst>
__device__ __forceinline__ void copy_rows(T* smem_base, const T* src, int64_t stride,
                                          int rows, int valid, int tid, int threads,
                                          Dst dst) {
  constexpr int EPC = 16 / sizeof(T);
  const int ch = tid % CH, step = threads / CH;
  const T* q = src + (tid / CH) * stride + ch * EPC;
  for (int s = tid / CH; s < rows; s += step, q += step * stride)
    cp16(smem_base + dst(s, ch), s < valid ? q : src, s < valid);
}

// e^x as 2^(x log2 e): the kernels keep every cumulative log-decay in log2
// units (logw times LOG2E as it is read), so each factor is one ex2
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- TF32 tensor-core products ---------------------------------------------

// x rounded to TF32 to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds it: half a TF32 ulp (bit 12) added to x's bits. The mma reads only
// the top 19 bits of a TF32 operand, so `tf32_bits` leaves the low 13 bits
// as they fall (one integer add, no cvt's infinity test; an infinity or NaN
// keeps its top bits); `tf32_value` clears them (the rounded value itself)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("{\n .reg .b32 t;\n mov.b32 t, %1;\n add.u32 %0, t, 4096;\n}\n"
      : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float as_float(uint32_t x) {
  float f;
  asm("mov.b32 %0, %1;\n" : "=f"(f) : "r"(x));
  return f;
}
__device__ __forceinline__ float tf32_value(float x) {
  return as_float(tf32_bits(x) & 0xffffe000u);
}

// a float32 as an mma operand: its TF32 rounding, and with SPLIT the
// rounding of what is left
template <bool SPLIT> struct Tf;
template <> struct Tf<false> {
  uint32_t h;
  __device__ __forceinline__ Tf() {}
  __device__ __forceinline__ explicit Tf(float x) : h(tf32_bits(x)) {}
};
template <> struct Tf<true> {
  uint32_t h, l;
  __device__ __forceinline__ Tf() {}
  __device__ __forceinline__ explicit Tf(float x)
      : h(tf32_bits(x)), l(tf32_bits(x - tf32_value(x))) {}
};

// an input element as an operand: bf16 is exact in TF32 (its bits, shifted)
template <bool SPLIT>
__device__ __forceinline__ Tf<SPLIT> operand(__nv_bfloat16 x) {
  Tf<SPLIT> r;
  r.h = (uint32_t)(*reinterpret_cast<const unsigned short*>(&x)) << 16;
  if constexpr (SPLIT) r.l = 0u;
  return r;
}
template <bool SPLIT>
__device__ __forceinline__ Tf<SPLIT> operand(float x) {
  return Tf<SPLIT>(x);
}

// a factor kept in shared memory for many products: rounded once to TF32
// when it is stored (one rounding), read back as it is; with SPLIT kept
// whole and split where it is read
template <bool SPLIT>
__device__ __forceinline__ float stored(float x) {
  if constexpr (SPLIT) return x;
  else return tf32_value(x);
}
template <bool SPLIT>
__device__ __forceinline__ Tf<SPLIT> from_stored(float x) {
  if constexpr (SPLIT) {
    return Tf<true>(x);
  } else {
    Tf<false> r;
    r.h = *reinterpret_cast<const uint32_t*>(&x);
    return r;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a · b for one m16n8k8 step. Fragments (g = lane/4, t = lane%4):
// a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]},
// c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}
template <bool SPLIT>
__device__ __forceinline__ void mma(float (&c)[4], const Tf<SPLIT> (&a)[4],
                                    const Tf<SPLIT> (&b)[2]) {
  if constexpr (SPLIT) {
    mma_tf32(c, a[0].l, a[1].l, a[2].l, a[3].l, b[0].h, b[1].h);
    mma_tf32(c, a[0].h, a[1].h, a[2].h, a[3].h, b[0].l, b[1].l);
  }
  mma_tf32(c, a[0].h, a[1].h, a[2].h, a[3].h, b[0].h, b[1].h);
}

// the 16-byte chunk `ch` of a shared row after an XOR swizzle by `sw`
// (chunks: a power of two)
__device__ __forceinline__ int chunk_at(int ch, int sw, int chunks) {
  return ch ^ (sw & (chunks - 1));
}

// ---- pass 1: the state entering every chunk --------------------------------
//
// CTA (tile of ET value columns, head, batch), DH/8 warps; warp w owns the
// channels d in [8w, 8w + 8). The product S^T[e][d] += Σ_s v[s][e]
// kdec[s][d] is an m16 (e) x n8 (d) x k8 (s) mma with A = v^T, B = kdec.
// Quad lane t owns the chunk's rows [R t, R t + R), R = C/4, and its k-step
// j takes rows R t + 2j (slot t) and R t + 2j + 1 (slot t + 4), so each
// thread's suffix sums of logw run over rows of its own; g picks the
// channel 8w + g.
//
// Shared memory per stage: logw [C][DH] float32 and k [C][DH] T, their 16-
// byte chunks XOR-swizzled by the row's quad lane (2t) so that a k-step's
// loads hit distinct banks; v [C][ET] T with a 32-byte gap after every R
// rows for the same reason.

__host__ __device__ constexpr int gap_elems(int size) { return 32 / size; }

template <typename T, int DH>
__host__ __device__ constexpr int state_stage_bytes(int C) {
  return C * DH * 4 + C * DH * (int)sizeof(T)
      + (C * kEt<DH> + 4 * gap_elems(sizeof(T))) * (int)sizeof(T);
}

template <typename T, int DH, int CF>
__global__ void __launch_bounds__(DH / 8 * 32)
wkv6_state_kernel(const Params p) {
  constexpr bool SPLIT = kSplit<T>;
  constexpr int THREADS = DH / 8 * 32;
  constexpr int EPC = 16 / sizeof(T);      // elements per 16-byte chunk
  constexpr int WCH = DH / 4;              // chunks in a row of logw
  constexpr int KCH = DH / EPC;            // ... of k
  constexpr int ET = kEt<DH>;              // value columns of this CTA
  constexpr int VCH = ET / EPC;            // ... of v's tile
  constexpr int GAP = gap_elems(sizeof(T));
  constexpr int MT = ET / 16;              // m16 tiles of value columns
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = CF ? CF : p.C, R = C / 4;
  const int stage = state_stage_bytes<T, DH>(C);
  const int e0 = blockIdx.x * ET, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh + e0;
  const float* w = p.w + b * p.wsb + h * p.wsh;
  const int64_t bh = (int64_t)b * p.H + h;

  auto load_chunk = [&](int c, int st) {
    float* wb = reinterpret_cast<float*>(smem + st * stage);
    T* kb = reinterpret_cast<T*>(smem + st * stage + C * DH * 4);
    T* vb = kb + C * DH;
    const int64_t s0 = (int64_t)c * C;
    const int valid = p.S - s0 < C ? (int)(p.S - s0) : C;
    auto quarter = [&](int s) { return (s >= R) + (s >= 2 * R) + (s >= 3 * R); };
    copy_rows<WCH>(wb, w + s0 * p.wss, p.wss, C, valid, tid, THREADS, [&](int s, int ch) {
      return s * DH + chunk_at(ch, 2 * quarter(s), WCH) * 4;
    });
    copy_rows<KCH>(kb, k + s0 * p.kss, p.kss, C, valid, tid, THREADS, [&](int s, int ch) {
      return s * DH + chunk_at(ch, 2 * quarter(s), KCH) * EPC;
    });
    copy_rows<VCH>(vb, v + s0 * p.vss, p.vss, C, valid, tid, THREADS, [&](int s, int ch) {
      return s * ET + quarter(s) * GAP + ch * EPC;
    });
  };

  // the state slice: m-tile mt holds S^T[e0 + 16mt + g (+8)][8w + 2t (+1)]
  float acc[MT][4];
  const float* s0 = p.s0 + bh * DH * DH;
  const int dc = 8 * warp + 2 * t;        // this thread's columns of acc
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int e = e0 + 16 * mt + g;
    acc[mt][0] = s0[dc * DH + e];
    acc[mt][1] = s0[(dc + 1) * DH + e];
    acc[mt][2] = s0[dc * DH + e + 8];
    acc[mt][3] = s0[(dc + 1) * DH + e + 8];
  }
  // this thread's channel (the B fragments' n = g), at its swizzled place
  // in its rows (quarter t)
  const int dn = 8 * warp + g;
  const int woff = chunk_at(dn / 4, 2 * t, WCH) * 4 + dn % 4;
  const int koff = chunk_at(dn / EPC, 2 * t, KCH) * EPC + dn % EPC;

  load_chunk(0, 0);
  cp_commit();
  for (int c = 0; c < p.n_c; ++c) {
    const int st = c & 1;
    cp_wait_all();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c-1
    if (c + 1 < p.n_c) load_chunk(c + 1, st ^ 1);
    cp_commit();

    // S_in of chunk c, [e][d] (rounded to TF32 for bf16: the output pass's
    // operand)
    float* sin = p.ws + (bh * p.n_c + c) * DH * DH;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int e = e0 + 16 * mt + g;
      store2(sin + e * DH + dc, stored<SPLIT>(acc[mt][0]), stored<SPLIT>(acc[mt][1]));
      store2(sin + (e + 8) * DH + dc, stored<SPLIT>(acc[mt][2]),
             stored<SPLIT>(acc[mt][3]));
    }

    const float* wb = reinterpret_cast<const float*>(smem + st * stage) + R * t * DH + woff;
    const T* kb = reinterpret_cast<const T*>(smem + st * stage + C * DH * 4)
        + R * t * DH + koff;
    const T* vb = reinterpret_cast<const T*>(smem + st * stage + C * DH * 4) + C * DH
        + R * t * ET + t * GAP;           // this quad lane's rows
    // this thread's run total (log2 units, 4 rows at a time), then the
    // quad's suffix sums: run = Σ of the later lanes' runs, tot = the
    // chunk's Σ logw (lw_last)
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < R; i += 4)
      run += ((wb[i * DH] + wb[(i + 1) * DH]) + (wb[(i + 2) * DH] + wb[(i + 3) * DH]))
          * LOG2E;
    float part[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) part[q] = __shfl_sync(0xffffffffu, run, (lane & ~3) | q);
    float tot = 0.f;
    run = 0.f;
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      if (q > t) run += part[q];
      tot += part[q];
    }
    // S <- diag(e^lw_last) S: columns d = 8w + 2t (+1) take the totals of
    // lanes g = 2t (+1)
    const float f0 = ex2(__shfl_sync(0xffffffffu, tot, 8 * t));
    const float f1 = ex2(__shfl_sync(0xffffffffu, tot, 8 * t + 4));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][0] *= f0; acc[mt][1] *= f1;
      acc[mt][2] *= f0; acc[mt][3] *= f1;
    }
    // S += Σ_s (k e^(lw_last - lw))[s]^T v[s], 4 rows (two k-steps) at a
    // time from the last: the suffix sums first, then the independent
    // exponentials
#pragma unroll 2
    for (int i = R - 4; i >= 0; i -= 4) {
      float suf[4];
      suf[3] = run;
      suf[2] = suf[3] + wb[(i + 3) * DH] * LOG2E;
      suf[1] = suf[2] + wb[(i + 2) * DH] * LOG2E;
      suf[0] = suf[1] + wb[(i + 1) * DH] * LOG2E;
      run = suf[0] + wb[i * DH] * LOG2E;
      Tf<SPLIT> bf[2][2];         // [k-step][slot]
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bf[q / 2][q % 2] = Tf<SPLIT>(to_f(kb[(i + q) * DH]) * ex2(suf[q]));
#pragma unroll
      for (int js = 1; js >= 0; --js) {
        const T* va = vb + (i + 2 * js) * ET;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int e = 16 * mt + g;
          const Tf<SPLIT> a[4] = {operand<SPLIT>(va[e]), operand<SPLIT>(va[e + 8]),
                                  operand<SPLIT>(va[ET + e]),
                                  operand<SPLIT>(va[ET + e + 8])};
          mma<SPLIT>(acc[mt], a, bf[js]);
        }
      }
    }
  }

  float* so = p.sout + bh * DH * DH;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int e = e0 + 16 * mt + g;
    so[dc * DH + e] = acc[mt][0];
    so[(dc + 1) * DH + e] = acc[mt][1];
    so[dc * DH + e + 8] = acc[mt][2];
    so[(dc + 1) * DH + e + 8] = acc[mt][3];
  }
}

// ---- pass 2: every chunk's y -------------------------------------------------
//
// CTA (chunk, head, batch), C/16 warps; warp i owns rows t0 = 16i ..
// t0 + 15. Its m16 tiles' row m = g is time t0 + 2g and m = g + 8 is
// t0 + 2g + 1, so thread (g, t) holds two consecutive rows; likewise a
// pair's key index n = 8j + x is time s0 + 2x + j. The k index over d is
// permuted: slot t of k-step kk is d = 8kk + 2t, slot t + 4 is d + 1.
//
// Shared memory: the chunk's r, k (T) and logw (float32), [C][DH] each,
// copied by cp.async at the start and swizzled by bits 1-3 of the row so
// that a thread's pair loads hit distinct banks; once every warp has read
// its rows, kt [C][DH + 4] (the rows' Kt, rounded to TF32 for bf16) takes
// their place. Then v [C][DH] T (swizzled by bits 2-3 of the row), S_in
// [DH][DH + 8] float32 (row e), u [DH], the block totals T [nu][DH], F
// [nu][DH] and G [nu(nu-1)/2][DH].

template <typename T, int DH>
__host__ __device__ constexpr int output_smem_bytes(int C) {
  return C * DH * (2 * (int)sizeof(T) + 4) + C * DH * (int)sizeof(T)
      + DH * (DH + 8) * 4 + DH * 4
      + (2 * (C / SUB) + (C / SUB) * (C / SUB - 1) / 2) * DH * 4;
}

template <typename T, int DH, int CF>
__global__ void __launch_bounds__(MAX_C / SUB * 32, sizeof(T) == 2 ? OUT_MIN_BLOCKS : 1)
wkv6_output_kernel(const Params p) {
  constexpr bool SPLIT = kSplit<T>;
  constexpr int NK = DH / 8;             // k-steps over d, n-tiles over e
  constexpr int EPC = 16 / sizeof(T);
  constexpr int TCH = DH / EPC;          // chunks in a row of r, k, v
  constexpr int WCH = DH / 4;            // ... of logw
  constexpr int SLD = DH + 8;            // row stride of S_in in shared memory
  constexpr int KLD = DH + 4;            // ... of kt
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = CF ? CF : p.C, nu = C / SUB, threads = C / SUB * 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, blk = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  T* rs = reinterpret_cast<T*>(smem);
  T* ks = rs + C * DH;
  float* wsm = reinterpret_cast<float*>(ks + C * DH);
  float* kt = reinterpret_cast<float*>(smem);      // over rs, ks, wsm
  T* vs = reinterpret_cast<T*>(wsm + C * DH);
  float* st = reinterpret_cast<float*>(vs + C * DH);
  float* us = st + DH * SLD;
  float* tt = us + DH;
  float* ff = tt + nu * DH;
  float* gg = ff + nu * DH;

  const int64_t s0 = (int64_t)c * C;
  const T* r = static_cast<const T*>(p.r) + b * p.rsb + h * p.rsh;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh;
  const float* w = p.w + b * p.wsb + h * p.wsh;
  const float* u = p.u + h * DH;
  T* y = static_cast<T*>(p.y) + b * p.ysb + h * p.ysh;
  const float* sin = p.ws + (((int64_t)b * p.H + h) * p.n_c + c) * DH * DH;

  // every input of the chunk into shared memory at once: r, k, logw and u
  // (group 1), then v and S_in (group 2)
  const int valid = p.S - s0 < C ? (int)(p.S - s0) : C;
  auto staged = [](int s, int ch) {   // r and k: swizzled by bits 1-3 of the row
    return s * DH + chunk_at(ch, ((s >> 1) & 7) * (8 / EPC), TCH) * EPC;
  };
  copy_rows<TCH>(rs, r + s0 * p.rss, p.rss, C, valid, tid, threads, staged);
  copy_rows<TCH>(ks, k + s0 * p.kss, p.kss, C, valid, tid, threads, staged);
  copy_rows<WCH>(wsm, w + s0 * p.wss, p.wss, C, valid, tid, threads, [](int s, int ch) {
    return s * DH + chunk_at(ch, ((s >> 1) & 7) * 2, WCH) * 4;
  });
  if (tid < DH / 4) cp16(us + 4 * tid, u + 4 * tid, true);
  cp_commit();
  copy_rows<TCH>(vs, v + s0 * p.vss, p.vss, C, valid, tid, threads, [](int s, int ch) {
    return s * DH + chunk_at(ch, ((s >> 2) & 3) * 2, TCH) * EPC;
  });
  copy_rows<DH / 4>(st, sin, (int64_t)DH, DH, DH, tid, threads, [](int e, int ch) {
    return e * SLD + ch * 4;
  });
  cp_commit();

  // this warp's rows ta = t0 + 2g and ta + 1: the sub-block's cumulative
  // sums of logw (a scan over g by shuffles), L, Kd and Kt, the bonus
  // Σ_d r u k, and the diagonal pair's A = L Kd^T
  const int t0 = blk * SUB, ta = t0 + 2 * g;
  const int rsw = g * (8 / EPC), wsw = g * 2;   // the rows' swizzles (bits 1-3)
  float L[NK][4];        // A fragments: (ta, d), (tb, d), (ta, d+1), (tb, d+1)
  float ktr[NK][4];      // Kt, the same places
  float ad[2][4];        // the diagonal pair's A, n-tiles j = 0, 1
  float da = 0.f, db = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) ad[j][0] = ad[j][1] = ad[j][2] = ad[j][3] = 0.f;
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();  // r, k, logw and u have landed
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int d = 8 * kk + 2 * t;
    const int td = chunk_at(d / EPC, rsw, TCH) * EPC + d % EPC;
    const int wd = chunk_at(d / 4, wsw, WCH) * 4 + d % 4;
    const float2 wa = load2(wsm + ta * DH + wd), wb = load2(wsm + (ta + 1) * DH + wd);
    const float2 ra = load2(rs + ta * DH + td), rb = load2(rs + (ta + 1) * DH + td);
    const float2 ka = load2(ks + ta * DH + td), kb = load2(ks + (ta + 1) * DH + td);
    const float2 uu = load2(us + d);
    float la[2], lb[2], kda[2], kdb[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float x0 = (q ? wa.y : wa.x) * LOG2E, x1 = (q ? wb.y : wb.x) * LOG2E;
      float incl = x0 + x1;
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      float lxa = __shfl_up_sync(0xffffffffu, incl, 4);
      if (g == 0) lxa = 0.f;
      const float lwa = lxa + x0;                       // = lx of row tb
      const float tot = __shfl_sync(0xffffffffu, incl, 28 + t);
      if (g == 7) tt[blk * DH + d + q] = incl;
      const float rra = q ? ra.y : ra.x, rrb = q ? rb.y : rb.x;
      const float kka = q ? ka.y : ka.x, kkb = q ? kb.y : kb.x;
      la[q] = rra * ex2(lxa);
      lb[q] = rrb * ex2(lwa);
      kda[q] = kka * ex2(-lwa);
      kdb[q] = kkb * ex2(-incl);
      ktr[kk][2 * q] = kka * ex2(tot - lwa);
      ktr[kk][2 * q + 1] = kkb * ex2(tot - incl);
      const float uq = q ? uu.y : uu.x;
      da = fmaf(rra * uq, kka, da);
      db = fmaf(rrb * uq, kkb, db);
    }
    L[kk][0] = la[0]; L[kk][1] = lb[0]; L[kk][2] = la[1]; L[kk][3] = lb[1];
    const Tf<SPLIT> a[4] = {Tf<SPLIT>(la[0]), Tf<SPLIT>(lb[0]), Tf<SPLIT>(la[1]),
                            Tf<SPLIT>(lb[1])};
    const Tf<SPLIT> b0[2] = {Tf<SPLIT>(kda[0]), Tf<SPLIT>(kda[1])};
    const Tf<SPLIT> b1[2] = {Tf<SPLIT>(kdb[0]), Tf<SPLIT>(kdb[1])};
    mma<SPLIT>(ad[0], a, b0);
    mma<SPLIT>(ad[1], a, b1);
  }
  da += __shfl_xor_sync(0xffffffffu, da, 1);
  da += __shfl_xor_sync(0xffffffffu, da, 2);
  db += __shfl_xor_sync(0xffffffffu, db, 1);
  db += __shfl_xor_sync(0xffffffffu, db, 2);
  // strictly causal, the bonus on the diagonal: c0/c1 are row 2g, c2/c3 row
  // 2g + 1; c0/c2 key 4t + j, c1/c3 key 4t + 2 + j (times within the block)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int tm = 2 * g + (x >> 1), ts = 4 * t + 2 * (x & 1) + j;
      const float bonus = (x >> 1) ? db : da;
      ad[j][x] = ts < tm ? ad[j][x] : (ts == tm ? bonus : 0.f);
    }
  }
  __syncthreads();  // every warp has read its r, k, logw rows; block totals

  // kt in place of the staged rows; this warp's F[i] = e^(Σ_{a<i} T[a]) and
  // G[i][a] = e^(Σ_{a<m<i} T[m]), the sums from the nearest block back
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int d = 8 * kk + 2 * t;
    store2(kt + ta * KLD + d, stored<SPLIT>(ktr[kk][0]), stored<SPLIT>(ktr[kk][2]));
    store2(kt + (ta + 1) * KLD + d, stored<SPLIT>(ktr[kk][1]), stored<SPLIT>(ktr[kk][3]));
  }
  for (int d = lane; d < DH; d += 32) {
    float e = 0.f;
    for (int a = blk - 1; a >= 0; --a) {
      gg[(blk * (blk - 1) / 2 + a) * DH + d] = ex2(e);
      e += tt[a * DH + d];
    }
    ff[blk * DH + d] = ex2(e);
  }
  cp_wait_all();
  __syncthreads();  // kt, the tables, v and S_in

  float acc[NK][4];
#pragma unroll
  for (int nt = 0; nt < NK; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // the inter-chunk term (L ⊙ F[i]) S_in
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const float2 f = load2(ff + blk * DH + 8 * kk + 2 * t);
    const Tf<SPLIT> a[4] = {Tf<SPLIT>(L[kk][0] * f.x), Tf<SPLIT>(L[kk][1] * f.x),
                            Tf<SPLIT>(L[kk][2] * f.y), Tf<SPLIT>(L[kk][3] * f.y)};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      const float2 sb = load2(st + (8 * nt + g) * SLD + 8 * kk + 2 * t);
      const Tf<SPLIT> bf[2] = {from_stored<SPLIT>(sb.x), from_stored<SPLIT>(sb.y)};
      mma<SPLIT>(acc[nt], a, bf);
    }
  }
  // y += A V_a: A's c-fragments as the A operand (slot t = key 2t, slot
  // t + 4 = key 2t + 1 of k-step jj: times a0 + 4t + jj and a0 + 4t + 2 + jj)
  auto apply = [&](const float (&A)[2][4], int a0) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const Tf<SPLIT> a[4] = {Tf<SPLIT>(A[jj][0]), Tf<SPLIT>(A[jj][2]),
                              Tf<SPLIT>(A[jj][1]), Tf<SPLIT>(A[jj][3])};
      const T* va = vs + (a0 + 4 * t + jj) * DH;
      const T* vb = va + 2 * DH;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        const int e = 8 * nt + g;
        const int at = chunk_at(e / EPC, 2 * t, TCH) * EPC + e % EPC;
        const Tf<SPLIT> bf[2] = {operand<SPLIT>(va[at]), operand<SPLIT>(vb[at])};
        mma<SPLIT>(acc[nt], a, bf);
      }
    }
  };
  // A(i, a) = (L ⊙ G[i][a]) Kt_a^T for one or two earlier blocks at once
  auto pairs = [&](int a, auto two) {
    constexpr int NP = decltype(two)::value;
    float ap[NP][2][4];
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j) ap[q][j][0] = ap[q][j][1] = ap[q][j][2] = ap[q][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const float2 gf = load2(gg + (blk * (blk - 1) / 2 + a + q) * DH + 8 * kk + 2 * t);
        const Tf<SPLIT> av[4] = {Tf<SPLIT>(L[kk][0] * gf.x), Tf<SPLIT>(L[kk][1] * gf.x),
                                 Tf<SPLIT>(L[kk][2] * gf.y), Tf<SPLIT>(L[kk][3] * gf.y)};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 kv =
              load2(kt + (SUB * (a + q) + 2 * g + j) * KLD + 8 * kk + 2 * t);
          const Tf<SPLIT> bf[2] = {from_stored<SPLIT>(kv.x), from_stored<SPLIT>(kv.y)};
          mma<SPLIT>(ap[q][j], av, bf);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) apply(ap[q], SUB * (a + q));
  };
  apply(ad, t0);
  int a = 0;
  for (; a + 1 < blk; a += 2) pairs(a, std::integral_constant<int, 2>());
  if (a < blk) pairs(a, std::integral_constant<int, 1>());

  const int64_t ga = s0 + ta, gb = ga + 1;
#pragma unroll
  for (int nt = 0; nt < NK; ++nt) {
    const int e = 8 * nt + 2 * t;
    if (ga < p.S) store2(y + ga * p.yss + e, acc[nt][0], acc[nt][1]);
    if (gb < p.S) store2(y + gb * p.yss + e, acc[nt][2], acc[nt][3]);
  }
}

template <typename T, int DH, int CF>
int launch_c(const Params& p, int B, cudaStream_t stream) {
  void (*k1)(const Params) = wkv6_state_kernel<T, DH, CF>;
  void (*k2)(const Params) = wkv6_output_kernel<T, DH, CF>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * state_stage_bytes<T, DH>(p.C));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             output_smem_bytes<T, DH>(p.C));
  if (err != cudaSuccess) return (int)err;
  k1<<<dim3(DH / kEt<DH>, p.H, B), DH / 8 * 32, 2 * state_stage_bytes<T, DH>(p.C),
       stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2<<<dim3(p.n_c, p.H, B), p.C / SUB * 32, output_smem_bytes<T, DH>(p.C),
       stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const Params& p, int B, cudaStream_t stream) {
  if (FIXED_C != 0 && p.C == FIXED_C) return launch_c<T, DH, FIXED_C>(p, B, stream);
  return launch_c<T, DH, 0>(p, B, stream);
}

template <int DH>
int launch_dtype(int dtype, const Params& p, int B, cudaStream_t stream) {
  if (dtype == kBF16) return launch<__nv_bfloat16, DH>(p, B, stream);
  return launch<float, DH>(p, B, stream);
}

}  // namespace

extern "C" {

// r, k, v, logw, y (B, S, H, dh) with element strides (batch, sequence,
// head; the head dim contiguous, every row 16-byte aligned); u (H, dh), s0
// and sout (B, H, dh, dh) contiguous float32; logw float32; r, k, v, y
// float32 (dtype 1) or bfloat16 (dtype 2). C is the chunk (a multiple of
// 16, at most 128); ws holds B * H * ceil(S / C) * dh * dh float32s (the
// state entering every chunk). Launches the state pass, then the output
// pass, on `stream`. Returns a CUDA error code (0 on successful launches).
int repro_wkv6_fwd(int dtype, const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* sout, void* ws, int B, int S, int H, int dh, int C,
                   int64_t rsb, int64_t rss, int64_t rsh,
                   int64_t ksb, int64_t kss, int64_t ksh,
                   int64_t vsb, int64_t vss, int64_t vsh,
                   int64_t wsb, int64_t wss, int64_t wsh,
                   int64_t ysb, int64_t yss, int64_t ysh, void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || B <= 0 || S <= 0 || H <= 0 ||
      B > 65535 || H > 65535 || C < SUB || C > MAX_C || C % SUB != 0)
    return (int)cudaErrorInvalidValue;
  Params p{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
           static_cast<const float*>(s0), y, static_cast<float*>(sout),
           static_cast<float*>(ws), S, H, C, (S + C - 1) / C,
           rsb, rss, rsh, ksb, kss, ksh, vsb, vss, vsh,
           wsb, wss, wsh, ysb, yss, ysh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_dtype<32>(dtype, p, B, st);
    case 64: return launch_dtype<64>(dtype, p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
