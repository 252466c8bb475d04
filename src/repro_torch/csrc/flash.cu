// Flash attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T
// + mask) V with grouped-query heads.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/kernel.py: flash_pallas (_flash_kernel).
// It computes what that kernel computes, not block for block:
//   * q is (B, Sq, Hq, hd), k and v are (B, Sk, Hkv, hd), read and written
//     through their (B, S, H) strides (the head dim contiguous), so the
//     reference's transpose to (B*H, S, hd) is never made; kv head =
//     q head / G with G = Hq / Hkv;
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
// What bounds it on this card, and what the design does about it: at the
// serving path's prefill shape (B 8, S 2048, 16/8 heads, hd 128, causal)
// one call is ~1.4e11 operations against ~0.2 GB, so it is bound by
// operations. The bfloat16 instantiation runs both products on the tensor
// cores (mma.sync.m16n8k16, bf16 inputs, float32 accumulate): one CTA per
// (64 q rows, head, batch) with four warps of 16 q rows each; Q stays in
// registers as A fragments for the whole kv sweep, K and V tiles of 64
// rows are staged in shared memory (rows padded by 16 bytes, so fragment
// and ldmatrix reads are free of bank conflicts), S = Q K^T lands in
// registers in exactly the layout the PV product takes as its A operand,
// and V's B fragments come from ldmatrix.trans. The float32 instantiation
// (a check of the algorithm at full precision; TF32 would round the
// inputs) runs on the FMA pipes: four threads per q row, each holding a
// quarter of the head dim.
//
// This first version has no wgmma, no TMA, no warp specialisation and no
// double buffering: each kv block is loaded, then computed. It is the
// simple, right kernel; speed is later work. Each output tile is written
// by one CTA, with no atomics, so results are bitwise repeatable.
//
// Interface: one plain C entry point for ctypes. It takes device pointers,
// sizes, element strides and the CUDA stream, launches one kernel on that
// stream, never synchronises or allocates (the Python wrapper owns every
// buffer), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DtypeCode : int { kF32 = 1, kBF16 = 2 };

constexpr float NEG_INF = -1e30f;
constexpr int BM = 64;  // q rows per CTA (both instantiations)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, G, causal;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  float scale;
};

// kv blocks a CTA whose first q row is m0 visits: every block up to the
// last one holding a key at or before its last row (causal), all of them
// otherwise.
__device__ __forceinline__ int visible_blocks(const Params& p, int m0, int bn) {
  int n = (p.Sk + bn - 1) / bn;
  if (p.causal) {
    int last = (m0 + BM - 1) / bn + 1;
    n = last < n ? last : n;
  }
  return n;
}

// ---- bfloat16: tensor cores ------------------------------------------------

constexpr int BN = 64;        // kv rows per block
constexpr int WARPS = 4;      // 16 q rows each
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const void* smem) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

// two floats as a bf16x2 register, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16): reg0 (row g, k 2t..2t+1), reg1 (g+8, 2t), reg2 (g, 2t+8),
//                reg3 (g+8, 2t+8);
//   B (16 x 8):  reg0 (k 2t..2t+1, col g), reg1 (k 2t+8.., col g);
//   C (16 x 8):  c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8, same cols).
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const Params p) {
  constexpr int LD = HD + 8;  // shared row stride (elements): +16 bytes
  constexpr int KS = HD / 16; // k-steps of Q K^T
  constexpr int NT = BN / 8;  // n-tiles of S
  constexpr int OT = HD / 8;  // n-tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[BN * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BN * LD];

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest sweeps first
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / p.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + hq * p.qsh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + hk * p.ksh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + hk * p.vsh;
  const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two q rows

  // Q as A fragments, for the whole sweep (rows past Sq read as 0)
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? r1 : r0;
      const int col = kk * 16 + 2 * t + ((r & 2) ? 8 : 0);
      qf[kk][r] = row < p.Sq
          ? *reinterpret_cast<const uint32_t*>(q + row * p.qss + col) : 0u;
    }
  }

  float o[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  const int n_kv = visible_blocks(p, m0, BN);
  for (int j = 0; j < n_kv; ++j) {
    const int n0 = j * BN;
    __syncthreads();  // every warp is done with the previous tiles
    constexpr int CHUNKS = BN * HD / 8;  // 16-byte chunks per tile
#pragma unroll
    for (int c = tid; c < CHUNKS; c += THREADS) {
      const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (n0 + r < p.Sk) {
        kx = *reinterpret_cast<const uint4*>(k + (n0 + r) * p.kss + cc);
        vx = *reinterpret_cast<const uint4*>(v + (n0 + r) * p.vss + cc);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + cc) = kx;
      *reinterpret_cast<uint4*>(vs + r * LD + cc) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale in float32, mask, online softmax over the block
    const bool edge = (p.causal && n0 + BN - 1 > m0) || n0 + BN > p.Sk;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (edge) {
          const int col = n0 + nt * 8 + 2 * t + (e & 1);
          const int row = (e < 2) ? r0 : r1;
          if (col >= p.Sk || (p.causal && col > row)) x = NEG_INF;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m_run[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      o[i][0] *= alpha[0]; o[i][1] *= alpha[0];
      o[i][2] *= alpha[1]; o[i][3] *= alpha[1];
    }

    // O += P V: P (bf16) straight from the S registers as A fragments
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < OT; nt += 2) {
        // lanes 0-15: keys kk*16 + lane at column nt*8; lanes 16-31: the
        // same keys at column (nt+1)*8 -> B fragments of n-tiles nt, nt+1
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3,
                      vs + (kk * 16 + (lane & 15)) * LD + (nt + (lane >> 4)) * 8);
        mma_bf16(o[nt], a, b0, b1);
        mma_bf16(o[nt + 1], a, b2, b3);
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.osb + hq * p.osh;
  const float d0 = fmaxf(l_run[0], 1e-30f), d1 = fmaxf(l_run[1], 1e-30f);
#pragma unroll
  for (int i = 0; i < OT; ++i) {
    const int col = i * 8 + 2 * t;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(out + r0 * p.oss + col) =
          pack_bf16(o[i][0] / d0, o[i][1] / d0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(out + r1 * p.oss + col) =
          pack_bf16(o[i][2] / d1, o[i][3] / d1);
  }
}

// ---- float32: FMA pipes ----------------------------------------------------

constexpr int F_BN = 32;       // kv rows per block
constexpr int F_THREADS = 256; // four per q row

template <int HD>
__global__ void __launch_bounds__(F_THREADS)
flash_f32_kernel(const Params p) {
  constexpr int V4 = HD / 16;  // float4s per thread per row: a quarter of hd
  constexpr int RV = HD / 4;   // float4s per row
  __shared__ __align__(16) float4 ks[F_BN * RV];
  __shared__ __align__(16) float4 vs[F_BN * RV];

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / p.G;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = m0 + (tid >> 2);
  const float* q = static_cast<const float*>(p.q) + b * p.qsb + hq * p.qsh;
  const float* k = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* v = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;

  // this thread's float4s of q: part, part + 4, ... (conflict-free reads)
  float4 qv[V4], acc[V4];
#pragma unroll
  for (int i = 0; i < V4; ++i) {
    qv[i] = row < p.Sq
        ? reinterpret_cast<const float4*>(q + row * p.qss)[part + 4 * i]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m_run = NEG_INF, l_run = 0.f;

  const int n_kv = visible_blocks(p, m0, F_BN);
  for (int j = 0; j < n_kv; ++j) {
    const int n0 = j * F_BN;
    __syncthreads();
    for (int c = tid; c < F_BN * RV; c += F_THREADS) {
      const int r = c / RV, cc = c % RV;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (n0 + r < p.Sk) {
        kx = reinterpret_cast<const float4*>(k + (n0 + r) * p.kss)[cc];
        vx = reinterpret_cast<const float4*>(v + (n0 + r) * p.vss)[cc];
      }
      ks[c] = kx;
      vs[c] = vx;
    }
    __syncthreads();

    float s[F_BN];
    float mx = NEG_INF;
#pragma unroll
    for (int n = 0; n < F_BN; ++n) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < V4; ++i) {
        const float4 kx = ks[n * RV + part + 4 * i];
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
    for (int i = 0; i < V4; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
    }
#pragma unroll
    for (int n = 0; n < F_BN; ++n) {
#pragma unroll
      for (int i = 0; i < V4; ++i) {
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
    for (int i = 0; i < V4; ++i)
      out[part + 4 * i] = make_float4(acc[i].x / d, acc[i].y / d, acc[i].z / d, acc[i].w / d);
  }
}

template <int HD>
int launch(int dtype, const Params& p, dim3 grid, cudaStream_t st) {
  if (dtype == kBF16)
    flash_bf16_kernel<HD><<<grid, THREADS, 0, st>>>(p);
  else
    flash_f32_kernel<HD><<<grid, F_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, hd), k/v (B, Sk, Hkv, hd), o like q; strides in elements
// (batch, sequence, head; the head dim is contiguous). Returns a CUDA error
// code (0 on a successful launch).
int repro_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Sk, int Hq, int Hkv, int hd,
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
  dim3 grid((Sq + BM - 1) / BM, Hq, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(dtype, p, grid, st);
    case 64: return launch<64>(dtype, p, grid, st);
    case 128: return launch<128>(dtype, p, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
