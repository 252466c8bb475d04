// Chunked RWKV-6 WKV recurrence for Hopper (sm_90a), the prefill half of
// the time-mix:
//   y_t = r_t^T (S_{t-1} + u ⊙ k_t v_t^T),   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
// computed chunk by chunk as wkv_chunked (src/repro_torch/kernels/rwkv6/ref.py).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rwkv6/kernel.py:
// wkv6_pallas (_wkv_kernel). It computes what that kernel computes: for
// every (batch, head) it sweeps the chunks in order and carries a float32
// (dh, dh) state across them; within a chunk of C rows, lw = cumsum(logw),
// lx = lw - logw, the inter-chunk term (r exp(lx)) @ S, the bonus diagonal
// (Σ_d r u k) v, the strictly causal intra-chunk term over SUB = 16
// sub-block pairs (b, a), then S <- exp(lw_last) S + (k exp(lw_last - lw))^T v.
// Every product and sum is float32 on the FMA pipes (tensor cores would
// round the products to TF32). Deliberate departures:
//   * layout: r, k, v, logw and y are read and written in the model layout
//     (B, S, H, dh) through their (batch, sequence, head) strides, u as
//     (H, dh); the reference's transpose to (B*H, S, dh) is never made;
//   * ragged S: any S >= 1 runs; rows past S are wkv_chunked's zero
//     padding (r = k = v = 0, logw = 0, an exact no-op) and are not stored
//     (the Pallas kernel asserts S % C == 0);
//   * the pair factorisation keeps the reference's boundaries (lx[t0] on
//     the diagonal, the end of sub-block a otherwise) and splits the left
//     factor at the sub-block's first row t0, so that one left factor
//     L = r exp(lx - lx[t0]) serves every pair of a row block:
//       exp(lx[t] - lw[s]) = exp(lx[t] - lx[t0]) * exp(lx[t0] - lw[end a])
//                            * exp(lw[end a] - lw[s]).
//     The outer two exponents lie in [-SUB*MAX_DECAY, 0]; the middle one
//     lies in [0, SUB*MAX_DECAY] on the diagonal pair and is <= 0 (at worst
//     an exact underflow to 0, as the reference's own left factor of a far
//     pair) otherwise. The right two factors are carried in place: after the
//     row block starting at t0, kt[s] = k[s] exp(lx[t0] - lw[s]) for every
//     earlier row s (each row block rescales the rows before it by
//     exp(lx[t0] - lx[t0 - SUB]) <= 1), so a pair's product is a plain dot
//     product of L and kt. The inter-chunk factor exp(lx) is L exp(lx[t0]),
//     and the state's k exp(lw_last - lw) is kt exp(lw_last - lx[t0 last]).
//
// What bounds it on this card, and what the design does about it: at the
// serving path's shape (B 8, S 2048, H 40, dh 64, C 128) one call is ~23
// GFLOP of float32 against ~0.5 GB, bound by operations (~0.34 ms at 67
// TFLOP/s). One CTA of 256 threads per (batch, head), sweeping the chunks
// in order; thread (i, j) owns row i of each 16-row block and the value
// columns j, j + 16, ... A chunk is staged in shared memory in float32 with
// 16-byte loads (r, k, lw, lx and v, ~200 KB at C 128, dh 64: dynamic
// shared memory), and the next chunk's rows are asked of L2 meanwhile. One
// CTA of 8 warps fits an SM, so every phase is written for latency: vector
// loads, independent partial sums. The cumulative sum runs
// THREADS / dh threads per channel, each over a run of rows in order, then
// adds the earlier runs' totals; thread (i, j) holds row i of a row block's
// L in registers and computes A[i][j] of each pair of that row block, then
// its y entries. (Splitting the value columns over several CTAs, 1,280 at
// the path's shape rather than 320, was measured slower: each CTA repeats
// the staging, the cumulative sums, the factors and A.) Every output entry
// is summed by one thread in a fixed order: no atomics, results bitwise
// repeatable. No wgmma, no TMA, no double buffering of the chunk in shared
// memory: the simple, right kernel; speed is later work.
//
// Interface: one plain C entry point for ctypes. It takes device pointers,
// sizes, element strides and the CUDA stream, launches one kernel on that
// stream, never synchronises or allocates (the Python wrapper owns every
// buffer), and returns cudaGetLastError() (or the error of setting the
// kernel's shared-memory size).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DtypeCode : int { kF32 = 1, kBF16 = 2 };

constexpr int SUB = 16;              // sub-block rows of the factorisation
constexpr int TJ = 16;               // threads across the value columns
constexpr int THREADS = SUB * TJ;    // thread (i, j) = (tid / TJ, tid % TJ)
constexpr int MAX_C = 128;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  void* y;
  float* sout;
  int S, H, C;
  int64_t rsb, rss, rsh, ksb, kss, ksh, vsb, vss, vsh, wsb, wss, wsh, ysb, yss, ysh;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// row strides (floats) of the shared arrays; every row starts 16-byte aligned
template <int DH>
__host__ __device__ constexpr int row_ld() { return DH + 4; }
__host__ __device__ __forceinline__ int a_ld(int C) { return C + 16 - (C & 16); }  // ≡ 16 mod 32
__host__ __device__ __forceinline__ int v_ld(int C) { return C + 4; }

template <int DH>
size_t smem_bytes(int C) {
  constexpr int LD = row_ld<DH>();
  const size_t floats = 4 * (size_t)C * LD   // r/L, k/kt, lw, lx
      + (size_t)DH * v_ld(C)                 // v, transposed
      + (size_t)DH * LD                      // state, transposed
      + (size_t)2 * LD                       // rescale factors g
      + DH + C                               // f, bonus diagonal
      + (size_t)SUB * a_ld(C);               // A of one row block
  return floats * sizeof(float);
}

// 16 bytes of T from global memory into `dst` as float32 (4 or 8 values)
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[q]));
    dst[2 * q] = f.x;
    dst[2 * q + 1] = f.y;
  }
}

// Σ_q a[q] · b[q] over DH/4 float4s, in four interleaved partial sums
template <int N>
__device__ __forceinline__ float dot4(const float* a, const float4* b) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float4 x = b[q];
    s0 = fmaf(a[4 * q], x.x, s0);
    s1 = fmaf(a[4 * q + 1], x.y, s1);
    s2 = fmaf(a[4 * q + 2], x.z, s2);
    s3 = fmaf(a[4 * q + 3], x.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const Params p) {
  constexpr int LD = row_ld<DH>();
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int SEGS = THREADS / DH;        // cumsum segments per channel
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, nu = C / SUB, ALD = a_ld(C), VLD = v_ld(C);
  float* rl = smem;               // [C][LD] r, then L = r e^(lx - lx[t0])
  float* kt = rl + C * LD;        // [C][LD] k, then k e^(lw[end] - lw), rescaled (see above)
  float* lw = kt + C * LD;        // [C][LD] log-decay, then its inclusive cumsum
  float* lx = lw + C * LD;        // [C][LD] exclusive cumsum lw - log-decay
  float* vt = lx + C * LD;        // [DH][VLD] v[t][e] at vt[e][t]
  float* st = vt + DH * VLD;      // [DH][LD] state S[d][e] at st[e][d]
  float* g = st + DH * LD;        // [2][LD] rescale factors of kt
  float* f = g + 2 * LD;          // [DH]
  float* diag = f + DH;           // [C] Σ_d r u k
  float* As = diag + C;           // [SUB][ALD]

  constexpr int NJ = DH / TJ;     // value columns per thread: j + TJ c
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, i = tid / TJ, j = tid % TJ;
  const T* r = static_cast<const T*>(p.r) + b * p.rsb + h * p.rsh;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh;
  const float* w = p.w + b * p.wsb + h * p.wsh;
  const float* u = p.u + h * DH;
  T* y = static_cast<T*>(p.y) + b * p.ysb + h * p.ysh;
  const int64_t s_off = ((int64_t)b * p.H + h) * DH * DH;

  for (int x = tid; x < DH * DH; x += THREADS) {
    const int d = x / DH, c = x % DH;
    st[c * LD + d] = p.s0[s_off + x];
  }

  const int n_chunks = (p.S + C - 1) / C;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int g0 = ch * C;
    __syncthreads();  // the previous chunk is done with every buffer
    // stage the chunk in float32, 16 bytes a load; rows past S are the zero
    // padding
#pragma unroll 4
    for (int x = tid; x < C * DH / VEC; x += THREADS) {
      const int t = x / (DH / VEC), d = (x % (DH / VEC)) * VEC;
      float* rd = rl + t * LD + d;
      float* kd = kt + t * LD + d;
      if (g0 + t < p.S) {
        const int64_t gt = g0 + t;
        load16(r + gt * p.rss + d, rd);
        load16(k + gt * p.kss + d, kd);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) rd[q] = kd[q] = 0.f;
      }
    }
#pragma unroll 4
    for (int x = tid; x < C * DH / 4; x += THREADS) {
      const int t = x / (DH / 4), d = (x % (DH / 4)) * 4;
      float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g0 + t < p.S)
        wv = *reinterpret_cast<const float4*>(w + (int64_t)(g0 + t) * p.wss + d);
      *reinterpret_cast<float4*>(lw + t * LD + d) = wv;
    }
#pragma unroll 4
    for (int x = tid; x < C * DH / VEC; x += THREADS) {
      const int t = x / (DH / VEC), c = (x % (DH / VEC)) * VEC;
      float vv[VEC];
      if (g0 + t < p.S) {
        load16(v + (int64_t)(g0 + t) * p.vss + c, vv);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) vv[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) vt[(c + q) * VLD + t] = vv[q];
    }
    // ask L2 for the next chunk's rows while this one is computed
    for (int x = tid; x < C * 8; x += THREADS) {
      const int t = x / 8, which = (x / 2) % 4, line = x % 2;
      const int64_t gt = g0 + C + t;
      if (gt < p.S) {
        const void* row = which == 0 ? (const void*)(r + gt * p.rss)
            : which == 1 ? (const void*)(k + gt * p.kss)
            : which == 2 ? (const void*)(v + gt * p.vss)
                         : (const void*)(w + gt * p.wss);
        if (line * 128 < DH * (which == 3 ? 4 : (int)sizeof(T)))
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              static_cast<const char*>(row) + line * 128));
      }
    }
    __syncthreads();

    // lw = cumsum(logw), lx = lw - logw: SEGS threads per
    // channel each sum a run of rows in order, then add the runs before
    {
      const int d = tid % DH, seg = tid / DH, rows = C / SEGS, t0 = seg * rows;
      float acc = 0.f;
      for (int t = t0; t < t0 + rows; ++t) {
        const float wt = lw[t * LD + d];
        acc += wt;
        lw[t * LD + d] = acc;
        lx[t * LD + d] = acc - wt;
      }
    }
    __syncthreads();
    {
      const int d = tid % DH, seg = tid / DH, rows = C / SEGS, t0 = seg * rows;
      float off = 0.f;
      for (int s = 0; s < seg; ++s) off += lw[(s * rows + rows - 1) * LD + d];
      __syncthreads();  // every thread has read the run totals
      if (seg) {
        for (int t = t0; t < t0 + rows; ++t) {
          lw[t * LD + d] += off;
          lx[t * LD + d] += off;
        }
      }
    }
    // the bonus diagonal Σ_d (r u) k: two threads per row, half the
    // channels each
    for (int t0 = 0; t0 < C; t0 += THREADS / 2) {
      const int t = t0 + tid / 2, d0 = (tid & 1) * (DH / 2);
      float s = 0.f;
      if (t < C) {
        float s1 = 0.f;
#pragma unroll
        for (int d = d0; d < d0 + DH / 2; d += 2) {
          s = fmaf(rl[t * LD + d] * u[d], kt[t * LD + d], s);
          s1 = fmaf(rl[t * LD + d + 1] * u[d + 1], kt[t * LD + d + 1], s1);
        }
        s += s1;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (t < C && (tid & 1) == 0) diag[t] = s;
    }
    __syncthreads();

    // the factors every pair shares: L = r e^(lx - lx[t0]) and
    // kt = k e^(lw[end] - lw), t0 and end the first and last rows of the
    // row's sub-block (both exponents in [-SUB*MAX_DECAY, 0])
#pragma unroll 4
    for (int x = tid; x < C * DH; x += THREADS) {
      const int t = x / DH, d = x % DH;
      const int t0 = t & ~(SUB - 1), te = t0 + SUB - 1;
      rl[t * LD + d] *= expf(lx[t * LD + d] - lx[t0 * LD + d]);
      kt[t * LD + d] *= expf(lw[te * LD + d] - lw[t * LD + d]);
    }
    __syncthreads();

    for (int sb = 0; sb < nu; ++sb) {
      const int t0 = sb * SUB, t = t0 + i;
      // this row block's factors: f = e^lx[t0]; g[0] = e^(lx[t0] -
      // lx[t0 - SUB]) (<= 1) rescales the earlier rows of kt, g[1] =
      // e^(lx[t0] - lw[t0 + SUB - 1]) (in [1, e^(SUB*MAX_DECAY)]) this
      // block's rows, so that kt[s] = k[s] e^(lx[t0] - lw[s]) for every
      // s < t0 + SUB
      for (int x = tid; x < 3 * DH; x += THREADS) {
        const int a = x / DH, d = x % DH;
        const float l0 = lx[t0 * LD + d];
        if (a == 0)
          g[d] = sb ? expf(l0 - lx[(t0 - SUB) * LD + d]) : 1.f;
        else if (a == 1)
          g[LD + d] = expf(l0 - lw[(t0 + SUB - 1) * LD + d]);
        else
          f[d] = expf(l0);
      }
      __syncthreads();
#pragma unroll 8
      for (int x = tid; x < (t0 + SUB) * DH; x += THREADS) {
        const int s = x / DH, d = x % DH;
        kt[s * LD + d] *= g[(s >= t0 ? LD : 0) + d];
      }
      __syncthreads();

      float lr[DH];
      {
        const float4* src = reinterpret_cast<const float4*>(rl + t * LD);
        const float4* fr = reinterpret_cast<const float4*>(f);
#pragma unroll
        for (int q = 0; q < DH / 4; ++q) {
          const float4 x = src[q], fq = fr[q];
          lr[4 * q] = x.x * fq.x; lr[4 * q + 1] = x.y * fq.y;
          lr[4 * q + 2] = x.z * fq.z; lr[4 * q + 3] = x.w * fq.w;
        }
      }
      // inter-chunk term and the bonus: Σ_d (L f)[t][d] S[d][e] + diag[t] v[t][e]
      // for this thread's columns e = j + TJ c
      float yv[NJ];
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const int e = j + TJ * c;
        yv[c] = dot4<DH / 4>(lr, reinterpret_cast<const float4*>(st + e * LD))
            + diag[t] * vt[e * VLD + t];
      }
      {
        const float4* src = reinterpret_cast<const float4*>(rl + t * LD);
#pragma unroll
        for (int q = 0; q < DH / 4; ++q) {
          const float4 x = src[q];
          lr[4 * q] = x.x; lr[4 * q + 1] = x.y; lr[4 * q + 2] = x.z; lr[4 * q + 3] = x.w;
        }
      }
      // A[i][j] of every pair (sb, a): Σ_d L[t][d] kt[a*SUB + j][d],
      // strictly causal (j < i) on the diagonal pair
      for (int a = 0; a <= sb; ++a) {
        const float s = dot4<DH / 4>(
            lr, reinterpret_cast<const float4*>(kt + (a * SUB + j) * LD));
        As[i * ALD + a * SUB + j] = (a == sb && j >= i) ? 0.f : s;
      }
      __syncthreads();
      // y[t][e] += Σ_s A[i][s] v[s][e] over the row block's pairs
      {
        const float4* ar = reinterpret_cast<const float4*>(As + i * ALD);
        float s[NJ][4];
#pragma unroll
        for (int c = 0; c < NJ; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
        for (int q = 0; q < (sb + 1) * SUB / 4; ++q) {
          const float4 aq = ar[q];
#pragma unroll
          for (int c = 0; c < NJ; ++c) {
            const float4 vq = reinterpret_cast<const float4*>(vt + (j + TJ * c) * VLD)[q];
            s[c][0] = fmaf(aq.x, vq.x, s[c][0]);
            s[c][1] = fmaf(aq.y, vq.y, s[c][1]);
            s[c][2] = fmaf(aq.z, vq.z, s[c][2]);
            s[c][3] = fmaf(aq.w, vq.w, s[c][3]);
          }
        }
#pragma unroll
        for (int c = 0; c < NJ; ++c) yv[c] += (s[c][0] + s[c][1]) + (s[c][2] + s[c][3]);
      }
      if (g0 + t < p.S) {
#pragma unroll
        for (int c = 0; c < NJ; ++c) store(&y[(int64_t)(g0 + t) * p.yss + j + TJ * c], yv[c]);
      }
      // the next row block rewrites g, f and kt only after a barrier that
      // every thread reaches after its reads here
    }

    __syncthreads();  // every pair is done with g, f and kt
    // kt[s] = k[s] e^(lx[t0 last] - lw[s]); the state takes k e^(lw_last -
    // lw) = kt e^(lw_last - lx[t0 last]) (exponent <= 0), and f = e^lw_last
    const float* last = lw + (C - 1) * LD;
    for (int x = tid; x < 2 * DH; x += THREADS) {
      const int a = x / DH, d = x % DH;
      if (a == 0)
        g[d] = expf(last[d] - lx[(C - SUB) * LD + d]);
      else
        f[d] = expf(last[d]);
    }
    __syncthreads();
#pragma unroll 4
    for (int x = tid; x < C * DH; x += THREADS) {
      const int t = x / DH, d = x % DH;
      kt[t * LD + d] *= g[d];  // k e^(lw_last - lw)
    }
    __syncthreads();
    // S[d][e] = e^(lw_last[d]) S[d][e] + Σ_t kd[t][d] v[t][e]; thread (i, j)
    // owns channels 4i .. 4i+3 of columns e = j + TJ c
    if (4 * i < DH) {
      const int d0 = 4 * i;
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const int e = j + TJ * c;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4* vr = reinterpret_cast<const float4*>(vt + e * VLD);
        for (int q = 0; q < C / 4; ++q) {
          const float4 vq = vr[q];
          const float vv[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) {
            const float4 kq = *reinterpret_cast<const float4*>(kt + (4 * q + tt) * LD + d0);
            acc.x = fmaf(kq.x, vv[tt], acc.x);
            acc.y = fmaf(kq.y, vv[tt], acc.y);
            acc.z = fmaf(kq.z, vv[tt], acc.z);
            acc.w = fmaf(kq.w, vv[tt], acc.w);
          }
        }
        float* sr = st + e * LD + d0;
        sr[0] = f[d0] * sr[0] + acc.x;
        sr[1] = f[d0 + 1] * sr[1] + acc.y;
        sr[2] = f[d0 + 2] * sr[2] + acc.z;
        sr[3] = f[d0 + 3] * sr[3] + acc.w;
      }
    }
  }

  __syncthreads();
  for (int x = tid; x < DH * DH; x += THREADS) {
    const int d = x / DH, c = x % DH;
    p.sout[s_off + x] = st[c * LD + d];
  }
}

template <typename T, int DH>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes<DH>(p.C);
  void (*kern)(const Params) = wkv6_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.H, B);
  kern<<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dtype(int dtype, const Params& p, int B, cudaStream_t stream) {
  if (dtype == kBF16) return launch<__nv_bfloat16, DH>(p, B, stream);
  return launch<float, DH>(p, B, stream);
}

}  // namespace

extern "C" {

// r, k, v, logw, y (B, S, H, dh) with element strides (batch, sequence,
// head; the head dim contiguous); u (H, dh), s0 and sout (B, H, dh, dh)
// contiguous float32; logw float32; r, k, v, y float32 (dtype 1) or
// bfloat16 (dtype 2). C is the chunk (a multiple of 16, at most 128).
// Returns a CUDA error code (0 on a successful launch).
int repro_wkv6_fwd(int dtype, const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* sout, int B, int S, int H, int dh, int C,
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
           S, H, C, rsb, rss, rsh, ksb, kss, ksh, vsb, vss, vsh,
           wsb, wss, wsh, ysb, yss, ysh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_dtype<32>(dtype, p, B, st);
    case 64: return launch_dtype<64>(dtype, p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
