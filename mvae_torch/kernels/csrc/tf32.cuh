// The TF32 split of a float32 operand for 3xTF32 products on the tensor
// cores (decode_bce.cu):
//
//   hi = a rounded to TF32,  lo = a - hi (exact),
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi
//
// A TF32 operand is the top 19 bits of a float32 (sign, 8 exponent and 10
// mantissa bits): the tensor core ignores the low 13 bits of what it is
// given. hi rounds a to nearest, ties away from zero, as cvt.rna.tf32.f32
// does: half of the 13 dropped bits (0x1000) added to the float's bits,
// then cleared (the carry rounds the magnitude up into the exponent where
// it must). lo, the rest, is exact in float32 and the tensor core reads its
// top 11 significant bits, so hi + lo keeps ~22 of a's 24 bits and the
// dropped lo lo term is ~2^-22 relative. hi rounded to nearest leaves lo
// of either sign, so the truncation of lo does not bias the product (with
// hi truncated, lo would always share a's sign). The same integer and
// float32 operations run on the card and in the host build of the tests:
// no conversion instruction.

#pragma once

#include <cuda_runtime.h>
#ifndef __CUDA_ARCH__
#include <string.h>
#endif

__host__ __device__ __forceinline__ float tf32_bits_to_float(unsigned u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

__host__ __device__ __forceinline__ unsigned tf32_float_to_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  unsigned u;
  memcpy(&u, &f, sizeof u);
  return u;
#endif
}

// the (hi, lo) TF32 pair of a, as the bits the products take
__host__ __device__ __forceinline__ void tf32_split(float a, unsigned& hi,
                                                    unsigned& lo) {
  hi = (tf32_float_to_bits(a) + 0x1000u) & 0xffffe000u;
  lo = tf32_float_to_bits(a - tf32_bits_to_float(hi));
}
