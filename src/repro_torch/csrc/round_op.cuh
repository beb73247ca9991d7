// Operand rounding of the mixed-precision kernel variants, shared by
// symmetric_contraction.cu and channelwise_tp.cu.
//
// PRECISION is a compile-time constant of the generated header each source
// is built with (kernel.py::spec_header): 0 fp32, 1 bf16, 2 fp8 (e4m3).
// round_op(x) rounds a loaded fp32 operand to that type and widens it back
// to fp32, in registers, so a variant reads and writes the same fp32 arrays
// as the fp32 build and accumulates in fp32 (the JAX package's
// kernels/precision.py contract); round_all rounds an array of them two at
// a time, with the packed conversions (cvt.rn.bf16x2.f32,
// cvt.rn.satfinite.e4m3x2.f32), one conversion instruction for two values.
// Conversions issue at a fraction of the fp32 arithmetic rate: rounded one
// at a time, the interaction kernels' bf16 and fp8 builds took 1.6 to 2.7
// times the fp32 build's time on an H100, two at a time within 10%
// (PERF.md).  Both match the plain version
// repro_torch/kernels/precision.py::round_to bit for bit, which follows the
// reference's ml_dtypes rounding: to nearest even, subnormals kept, every
// NaN the quiet NaN 0x7fc00000 with the input's sign; in fp8 also every
// magnitude above 464 and every infinity.  The hardware conversion to e4m3
// (cvt.rn.satfinite.e4m3x2.f32) saturates to +-448 instead, so those are
// caught before it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>

#ifndef PRECISION
#error "the generated header must define PRECISION (0 fp32, 1 bf16, 2 fp8)"
#endif

__device__ __forceinline__ float signed_quiet_nan(float x) {
  return __int_as_float((__float_as_int(x) & 0x80000000) | 0x7fc00000);
}

#if PRECISION != 0 && PRECISION != 1 && PRECISION != 2
#error "PRECISION must be 0, 1 or 2"
#endif

// the value x takes where the conversion's result is not the reference's:
// NaN in, and in fp8 also infinity or a magnitude above 464 in
__device__ __forceinline__ float fix_special(float x, float rounded) {
#if PRECISION == 1
  return x != x ? signed_quiet_nan(x) : rounded;
#else
  return fabsf(x) <= 464.f ? rounded : signed_quiet_nan(x);
#endif
}

__device__ __forceinline__ void round_pair(float& a, float& b) {
#if PRECISION == 1
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  const float ra = __low2float(r), rb = __high2float(r);
#elif PRECISION == 2
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE, __NV_E4M3),
      __NV_E4M3);
  const float2 r = __half22float2(__half2(h));
  const float ra = r.x, rb = r.y;
#endif
#if PRECISION != 0
  a = fix_special(a, ra);
  b = fix_special(b, rb);
#endif
}

__device__ __forceinline__ float round_op(float x) {
  float unused = 0.f;
  round_pair(x, unused);
  return x;
}

template <int D>
__device__ __forceinline__ void round_all(float (&v)[D]) {
#pragma unroll
  for (int m = 0; m + 1 < D; m += 2) round_pair(v[m], v[m + 1]);
  if (D % 2) v[D - 1] = round_op(v[D - 1]);
}
