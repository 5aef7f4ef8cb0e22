// Scalar arithmetic shared by the hand-written kernels, one struct a
// working type (float, double).
//
//   * add, sub, mul, div, sqrt round each result to nearest on its own
//     (_rn intrinsics): nvcc never contracts them into an FMA, so a kernel
//     that forms a value in its plain version's order gets the plain
//     version's bits. fma is the one fused form, for the values torch
//     itself fuses (torch.linalg.cross).
//   * acos and cos are the CUDA math library's (no fast math).
//   * key/from_key: order-preserving integer keys of the floats (the bits
//     where the sign bit is clear, the bits with the others flipped where
//     it is set), int32 for float32 and int64 for float64, so a minimum of
//     floats is an exact, order-free atomicMin of integers (-0.0 keys
//     below +0.0). big_key is the key of the largest finite value. The
//     plain versions form the same keys (kernels/build_points.py
//     `float_keys`).

#pragma once

#include <cuda_runtime.h>

namespace madicp {

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using Key = int;
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float acos(float a) { return acosf(a); }
  static __device__ __forceinline__ float cos(float a) { return cosf(a); }
  static __device__ __forceinline__ float nan() { return __int_as_float(0x7fc00000); }
  static __device__ __forceinline__ float max_value() { return 3.40282347e+38f; }
  static __device__ __forceinline__ Key big_key() { return 0x7f7fffff; }
  static __device__ __forceinline__ Key key(float x) {
    const int b = __float_as_int(x);
    return b >= 0 ? b : b ^ 0x7fffffff;
  }
  static __device__ __forceinline__ float from_key(Key k) {
    return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
  }
};

template <>
struct Arith<double> {
  using Key = long long;
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double acos(double a) { return ::acos(a); }
  static __device__ __forceinline__ double cos(double a) { return ::cos(a); }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000ll);
  }
  static __device__ __forceinline__ double max_value() { return 1.7976931348623157e+308; }
  static __device__ __forceinline__ Key big_key() { return 0x7fefffffffffffffll; }
  static __device__ __forceinline__ Key key(double x) {
    const long long b = __double_as_longlong(x);
    return b >= 0 ? b : b ^ 0x7fffffffffffffffll;
  }
  static __device__ __forceinline__ double from_key(Key k) {
    return __longlong_as_double(k >= 0 ? k : k ^ 0x7fffffffffffffffll);
  }
};

}  // namespace madicp
