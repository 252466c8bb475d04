// TF32 tensor-core products for wkv6.cu and flash.cu: a float32 rounded
// to TF32 as an mma operand, split into that rounding and the rounding of
// what is left (3xTF32: a·b ≈ lo·hi + hi·lo + hi·hi, float32 accurate),
// and one mma.sync m16n8k8 step on such operands.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace
