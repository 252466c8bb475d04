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
//   * exp is expf (no fast math: the plain version on the card is
//     torch.exp in float32), and the state update contracts to an FMA.
//
// What bounds it on this card, and what the design does about it: at the
// served shape (Bt 8, S 2,048, di 8,192, ds 16) one call moves x (bf16), dt
// (f32) and y (f32) once, ~1.34 GB, ~0.40 ms at 3.35 TB/s; its 2.1 G exps
// and ~13 G other float32 operations are ~0.22 ms at 67 TFLOP/s. But each
// expf is several instructions around an ex2 on the quarter-rate MUFU
// (~0.58 ms for 2.1 G on 132 SMs), and each step of a thread waits on the
// last, so instruction throughput and latency bound it: 1.90 ms on an H100
// SXM at 700 W, where capping registers for more resident blocks or loading
// fewer steps at once was slower. Design: TPC = ds / NS threads per channel
// (2 at ds 16), each holding NS = 8 states and its channel's A in
// registers; neighbouring thread groups take neighbouring channels, so the
// per-step loads of x and dt and the store of y are coalesced across a
// warp. One block of 128 threads covers 128 / TPC channels of one batch and
// sweeps S in order: a chunk of TC rows of B and C (shared by every channel
// of the batch) is staged in shared memory, then each thread loads U steps
// of its x and dt into registers at once (independent loads in flight
// together) and steps through them. y's partial sums over the TPC threads
// of a channel are combined by a fixed xor-shuffle tree (commutative at
// each level, so every lane holds the same bits). No atomics: results are
// bitwise repeatable. No TMA, no double buffering: the simple, right
// kernel; speed is later work.
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

constexpr int THREADS = 128;
constexpr int TC = 64;   // rows of B and C staged per chunk
constexpr int U = 16;    // steps of x and dt loaded into registers at once

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

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T, int NS, int TPC>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const Params p) {
  constexpr int DS = NS * TPC;
  constexpr int CH = THREADS / TPC;   // channels per block
  __shared__ float Bs[TC][DS];
  __shared__ float Cs[TC][DS];

  const int tid = threadIdx.x, part = tid % TPC;
  const int d = blockIdx.x * CH + tid / TPC, b = blockIdx.y;
  const bool active = d < p.di;
  const int s0 = part * NS;
  const T* x = static_cast<const T*>(p.x) + b * p.xsb + d;
  const float* dt = p.dt + b * p.dsb + d;
  const T* Bg = static_cast<const T*>(p.B) + b * p.bsb;
  const T* Cg = static_cast<const T*>(p.C) + b * p.csb;
  float* y = p.y + b * p.ysb + d;
  const int64_t h_off = ((int64_t)b * p.di + d) * DS + s0;

  float A[NS], h[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    A[s] = active ? p.A[(int64_t)d * DS + s0 + s] : 0.f;
    h[s] = active ? p.h0[h_off + s] : 0.f;
  }
  const float Dd = active ? p.D[d] : 0.f;

  for (int t0 = 0; t0 < p.S; t0 += TC) {
    const int n = min(TC, p.S - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < n * DS; i += THREADS) {
      const int t = i / DS, s = i % DS;
      const int64_t gt = t0 + t;
      Bs[t][s] = ld(Bg + gt * p.bss + s);
      Cs[t][s] = ld(Cg + gt * p.css + s);
    }
    __syncthreads();
    for (int u0 = 0; u0 < n; u0 += U) {
      float xr[U], dtr[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int64_t gt = t0 + u0 + j;
        const bool in = active && u0 + j < n;
        xr[j] = in ? ld(x + gt * p.xss) : 0.f;
        dtr[j] = in ? dt[gt * p.dss] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (u0 + j < n) {  // uniform across the block
          const int t = u0 + j;
          const float u = dtr[j] * xr[j];
          float acc = 0.f;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float dA = expf(dtr[j] * A[s]);
            h[s] = dA * h[s] + u * Bs[t][s0 + s];
            acc = fmaf(h[s], Cs[t][s0 + s], acc);
          }
#pragma unroll
          for (int o = 1; o < TPC; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
          if (active && part == 0) y[(t0 + t) * p.yss] = fmaf(Dd, xr[j], acc);
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int s = 0; s < NS; ++s) p.hout[h_off + s] = h[s];
  }
}

template <typename T, int NS, int TPC>
int launch(const Params& p, int Bt, cudaStream_t stream) {
  constexpr int CH = THREADS / TPC;
  dim3 grid((p.di + CH - 1) / CH, Bt);
  ssm_scan_kernel<T, NS, TPC><<<grid, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ds(int ds, const Params& p, int Bt, cudaStream_t stream) {
  switch (ds) {
    case 4: return launch<T, 4, 1>(p, Bt, stream);
    case 8: return launch<T, 8, 1>(p, Bt, stream);
    case 16: return launch<T, 8, 2>(p, Bt, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (Bt, S, di) and B, C (Bt, S, ds) float32 (dtype 1) or bfloat16 (dtype
// 2), dt (Bt, S, di) float32, each with element strides (batch, sequence)
// and its last dim contiguous; A (di, ds), D (di,), h0 and hout (Bt, di,
// ds) contiguous float32; y (Bt, S, di) float32 with strides (batch,
// sequence). ds is 4, 8 or 16. Returns a CUDA error code (0 on a
// successful launch).
int repro_ssm_scan_fwd(int dtype, const void* x, const void* dt, const void* A,
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
  if (dtype == kBF16) return launch_ds<__nv_bfloat16>(ds, p, Bt, st);
  return launch_ds<float>(ds, p, Bt, st);
}

}  // extern "C"
