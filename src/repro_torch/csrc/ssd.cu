// Mamba selective scan for Hopper (sm_90a), the prefill half of the Mamba
// mixer: per batch b and channel d, with the state h[d, :] of length ds in
// float32,
//   h = exp(dt_t[d] A[d, :]) ⊙ h + dt_t[d] x_t[d] B_t[:]
//   y_t[d] = Σ_s h[d, s] C_t[s] + D[d] x_t[d]
// computed as ssm_scan (src/repro_torch/kernels/ssd/ref.py).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd/kernel.py:
// ssm_scan_pallas (_ssm_kernel). That kernel's grid is (batch, channel
// block, time chunk) with the time axis sequential and the (bd, ds) state
// in VMEM scratch across it; here blocks run in no order, so the time axis
// becomes a loop inside the block, and the state lives in registers for
// the whole sweep. Deliberate departures:
//   * layout: x, dt, B, C and y are read and written in the model layout
//     (Bt, S, ·) through their (batch, sequence) strides, so B and C may be
//     the column views that split() cuts from the model's dbc; nothing is
//     copied;
//   * ragged sizes: any S >= 1 and any di (the Pallas kernel asserts
//     S % tc == 0 and di % bd == 0); channels past di are masked;
//   * exp is 2^(dt · A log2 e) on the MUFU (below); the plain version on
//     the card is torch.exp in float32 (expf).
//
// What bounds it on this card, and what the design does about it: at the
// served shape (Bt 8, S 2,048, di 8,192, ds 16) one call moves x (bf16), dt
// (f32) and y (f32) once, ~1.34 GB, ~0.40 ms at 3.35 TB/s; its 2.15 G exps
// and ~13 G other float32 operations are ~0.22 ms at 67 TFLOP/s. The exps
// alone, one MUFU op each at 16 a clock per SM, take 0.51-0.58 ms, and on
// this card a MUFU op also holds its sub-partition's issue for ~8 cycles
// that the other instructions do not fill (measured, PERF.md §6): a
// step of one channel costs ~16 x 8 cycles of exps beside ~85 of loads
// and FP32 work, so instruction issue bounds the call, near 0.75 ms.
// Design:
//   * one thread per channel holds the channel's ds states and A · log2 e
//     in registers, y summed in the thread in a fixed order (no shuffle,
//     no predicated store);
//   * each exp is 2^z = 2^(z + 1) / 2: one FFMA (z + 1 = dt · A' + 1,
//     A' = A log2 e in registers), one `ex2.approx.ftz.f32` on the MUFU
//     and one FMUL. For z in [-1, 0), where a decay is near 1 and its
//     error is carried over every step the term survives, the MUFU then
//     takes its argument in [0, 1), where expf's own reduction puts it;
//     fed z itself it errs with a bias there (at dt ~1e-4, 4.5e-5 of the
//     envelope after 2,048 steps and 1.9e-4 after 16,384, against 8e-6
//     and 6e-6 this way; PERF.md §6). Exactly 0 for z < -127 (dt · A <=
//     -200 included). A degree-6 polynomial on the FMA pipes for a share
//     of the states was slower at every share and no more accurate;
//     kernels/ssd/ref.py emulates this form;
//   * x and dt are staged in a STAGES-deep cp.async ring of TC-step chunks
//     (16-byte copies where pointers and strides allow, element copies
//     otherwise), and B and C (shared by every channel of the batch) go
//     through registers into float32 rows of the same ring, so chunk k + 1
//     loads while chunk k computes; every thread walks fixed columns of
//     the chunk with running pointers (the per-chunk address arithmetic
//     was a sixth of the call); a step reads its B and C rows as float4
//     broadcasts;
//   * y is one coalesced float32 store per channel and step, through a
//     running pointer.
// No atomics: results are bitwise repeatable.
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

constexpr int THREADS = 128;    // one channel a thread
constexpr int TC = 16;           // steps a chunk of the ring
constexpr int STAGES = 3;        // depth of the ring
constexpr int MIN_BLOCKS = 4;    // resident blocks an SM (launch bounds)
constexpr int T_UNROLL = 2;      // steps of the step loop unrolled

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  const float* h0;
  float* y;
  float* hout;
  int S, di;
  int64_t xsb, xss, dsb, dss, bsb, bss, csb, css, ysb, yss;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float exp2_mufu(float z) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// BYTES (4 or 16) to shared memory; bytes past src_bytes are zero
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [t0, t0 + TC) of the block's CH channels [d0, d0 + CH) of one
// operand (x or dt) into s[TC][CH]; steps at or past S and channels at or
// past di are zero. VEC: 16-byte copies (the base and the strides are
// 16-byte aligned); otherwise one element a copy (a bfloat16 element goes
// through registers: cp.async has no 2-byte form). A thread copies one
// column of the tile, every RPP-th row.
template <typename T, int CH, bool VEC>
__device__ __forceinline__ void load_rows(T* s, const T* g, int64_t ss, int t0, int S,
                                          int d0, int di, int tid) {
  constexpr int PER = VEC ? 16 / (int)sizeof(T) : 1;  // elements a copy
  constexpr int CPR = CH / PER;                       // copies a row
  constexpr int RPP = THREADS / CPR;                  // rows a pass
  static_assert(THREADS % CPR == 0 && TC % RPP == 0, "passes cover the tile");
  const int c = (tid % CPR) * PER, d = d0 + c;
  const int valid = d < di ? min(PER, di - d) : 0;
  int t = tid / CPR;
  const T* src = g + (int64_t)(t0 + t) * ss + d;
  T* dst = s + t * CH + c;
#pragma unroll 4
  for (int q = 0; q < TC / RPP; ++q, t += RPP, src += RPP * ss, dst += RPP * CH) {
    const int v = t0 + t < S ? valid : 0;
    if constexpr (VEC) {
      cp_async<16>(dst, v ? src : g, v * (int)sizeof(T));
    } else if constexpr (sizeof(T) == 4) {
      cp_async<4>(dst, v ? src : g, v * 4);
    } else {
      *dst = v ? *src : __ushort_as_bfloat16((unsigned short)0);
    }
  }
}

template <typename T, int DS, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ssm_scan_kernel(const Params p) {
  constexpr int CH = THREADS;                       // channels a block
  constexpr int BC = 2 * DS;                        // a step's B and C row
  constexpr int BC_PER = TC * BC / THREADS;
  constexpr int STAGE = TC * CH * (int)sizeof(T) + TC * CH * 4 + TC * BC * 4;
  static_assert(DS % 4 == 0, "B and C are read as float4");
  static_assert((TC * CH * sizeof(T)) % 16 == 0, "stage parts stay 16-byte aligned");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * CH, b = blockIdx.y;
  const int d = d0 + tid;
  const bool active = d < p.di;
  const T* xg = static_cast<const T*>(p.x) + b * p.xsb;
  const float* dtg = p.dt + b * p.dsb;
  const T* Bg = static_cast<const T*>(p.B) + b * p.bsb;
  const T* Cg = static_cast<const T*>(p.C) + b * p.csb;
  float* y = p.y + b * p.ysb + d;
  const int64_t h_off = ((int64_t)b * p.di + d) * DS;

  float A2[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    A2[s] = active ? p.A[(int64_t)d * DS + s] * LOG2E : 0.f;
    h[s] = active ? p.h0[h_off + s] : 0.f;
  }
  const float Dd = active ? p.D[d] : 0.f;

  auto xs = [&](int st) { return reinterpret_cast<T*>(smem + st * STAGE) + tid; };
  auto dts = [&](int st) {
    return reinterpret_cast<float*>(smem + st * STAGE + TC * CH * sizeof(T)) + tid;
  };
  auto bcs = [&](int st) {
    return reinterpret_cast<float*>(smem + st * STAGE + TC * CH * (sizeof(T) + 4));
  };
  // B and C of chunk k through registers: a thread loads column bc_col of
  // the chunk's [TC][B | C] rows, every BC_RPP-th row from bc_row
  constexpr int BC_RPP = THREADS / BC;
  static_assert(THREADS % BC == 0 && TC % BC_RPP == 0, "passes cover the rows");
  const int bc_col = tid % BC, bc_row = tid / BC;
  const T* bc_src = bc_col < DS ? Bg + bc_col : Cg + (bc_col - DS);
  const int64_t bc_ss = bc_col < DS ? p.bss : p.css;
  float bc[BC_PER];
  auto fetch_bc = [&](int k) {
    const int t0 = k * TC + bc_row;
    const T* src = bc_src + (int64_t)t0 * bc_ss;
#pragma unroll
    for (int q = 0; q < BC_PER; ++q, src += BC_RPP * bc_ss)
      bc[q] = t0 + q * BC_RPP < p.S ? to_f(*src) : 0.f;
  };
  auto store_bc = [&](int st) {
    float* dst = bcs(st) + tid;
#pragma unroll
    for (int q = 0; q < BC_PER; ++q) dst[q * THREADS] = bc[q];
  };
  auto load_xdt = [&](int k) {
    const int st = k % STAGES;
    load_rows<T, CH, VEC>(xs(st) - tid, xg, p.xss, k * TC, p.S, d0, p.di, tid);
    load_rows<float, CH, VEC>(dts(st) - tid, dtg, p.dss, k * TC, p.S, d0, p.di, tid);
  };
  const int chunks = (p.S + TC - 1) / TC;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < chunks) {
      load_xdt(k);
      fetch_bc(k);
      store_bc(k % STAGES);
    }
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk k has landed; every thread is done with k - 1
    const int next = k + STAGES - 1;
    if (next < chunks) {
      load_xdt(next);
      fetch_bc(next);
    }
    cp_async_commit();

    const int st = k % STAGES, n = min(TC, p.S - k * TC);
    const T* xk = xs(st);
    const float* dtk = dts(st);
    const float* bck = bcs(st);
    float* yt = y + (int64_t)k * TC * p.yss;
#pragma unroll (T_UNROLL)
    for (int t = 0; t < n; ++t) {  // uniform across the block
      const float xv = to_f(xk[t * CH]), dtv = dtk[t * CH];
      const float u = dtv * xv;
      const float* row = bck + t * BC;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < DS / 4; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(row + 4 * q);
        const float4 c4 = *reinterpret_cast<const float4*>(row + DS + 4 * q);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int s = 4 * q + r;
          const float dA = 0.5f * exp2_mufu(fmaf(dtv, A2[s], 1.f));
          h[s] = fmaf(dA, h[s], u * bv[r]);
          acc = fmaf(h[s], cv[r], acc);
        }
      }
      if (active) *yt = fmaf(Dd, xv, acc);
      yt += p.yss;
    }
    // chunk `next`'s B and C into the stage chunk k - 1 used; the barrier
    // at the top of iteration `next` publishes them
    if (next < chunks) store_bc(next % STAGES);
  }

  if (active) {
#pragma unroll
    for (int s = 0; s < DS; ++s) p.hout[h_off + s] = h[s];
  }
}

template <typename T, int DS, bool VEC>
int launch(const Params& p, int Bt, cudaStream_t stream) {
  constexpr int CH = THREADS;
  constexpr int SMEM = STAGES * (TC * CH * (int)sizeof(T) + TC * CH * 4 + TC * 2 * DS * 4);
  auto kernel = ssm_scan_kernel<T, DS, VEC>;
  // above 48 KB of dynamic shared memory needs the attribute, set once
  // per instantiation and device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  dim3 grid((p.di + CH - 1) / CH, Bt);
  kernel<<<grid, THREADS, SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_ds(int ds, const Params& p, int Bt, cudaStream_t stream) {
  switch (ds) {
    case 4: return launch<T, 4, VEC>(p, Bt, stream);
    case 8: return launch<T, 8, VEC>(p, Bt, stream);
    case 16: return launch<T, 16, VEC>(p, Bt, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (Bt, S, di) and B, C (Bt, S, ds) float32 (dtype 1) or bfloat16 (dtype
// 2), dt (Bt, S, di) float32, each with element strides (batch, sequence)
// and its last dim contiguous; A (di, ds), D (di,), h0 and hout (Bt, di,
// ds) contiguous float32; y (Bt, S, di) float32 with strides (batch,
// sequence). ds is 4, 8 or 16. vec: x's and dt's base pointers and
// strides are 16-byte aligned (16-byte copies), else element copies.
// Returns a CUDA error code (0 on a successful launch).
int repro_ssm_scan_fwd(int dtype, int vec, const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* D,
                       const void* h0, void* y, void* hout, int Bt, int S,
                       int di, int ds, int64_t xsb, int64_t xss, int64_t dsb,
                       int64_t dss, int64_t bsb, int64_t bss, int64_t csb,
                       int64_t css, int64_t ysb, int64_t yss, void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || Bt <= 0 || S <= 0 || di <= 0 ||
      Bt > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
           static_cast<const float*>(D), static_cast<const float*>(h0),
           static_cast<float*>(y), static_cast<float*>(hout), S, di,
           xsb, xss, dsb, dss, bsb, bss, csb, css, ysb, yss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return vec ? launch_ds<__nv_bfloat16, true>(ds, p, Bt, st)
               : launch_ds<__nv_bfloat16, false>(ds, p, Bt, st);
  return vec ? launch_ds<float, true>(ds, p, Bt, st) : launch_ds<float, false>(ds, p, Bt, st);
}

}  // extern "C"
