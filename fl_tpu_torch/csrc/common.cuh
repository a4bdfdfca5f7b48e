// Shared device helpers of the port's CUDA sources: conversions between the
// compute dtype T (float or __nv_bfloat16) and f32, four-wide loads into and
// out of shared memory, the 4x4 register-tile product the GEMM-shaped kernels are built on,
// and the fixed-order reduction of per-block partial sums.
//
// Everything sits in an anonymous namespace: each source compiles on its own
// and gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round an f32 value to T's precision (round to nearest even) and back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__host__ __device__ __forceinline__ int round_up4(int n) { return (n + 3) & ~3; }

// Four consecutive T values as f32 in one load. p must be aligned to
// 4 * sizeof(T): every shared-memory row the callers lay out starts at a
// multiple of four elements from a 16-byte aligned base.
template <typename T> __device__ __forceinline__ void load4(const T* p, float v[4]);
template <> __device__ __forceinline__ void load4<float>(const float* p, float v[4]) {
  float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float v[4]) {
  // a bf16 value is the upper half of the f32 with the same value
  uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// Copy four consecutive T values from global memory into a shared-memory
// slot aligned to 4 * sizeof(T), with zeros from element `valid` on (valid
// <= 0 reads nothing). `vec` says that src is aligned like the slot, so that
// four valid values move in one load.
template <typename T>
__device__ __forceinline__ void stage4(T* dst, const T* src, int valid, bool vec) {
  if (vec && valid >= 4) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = i < valid ? src[i] : from_f<T>(0.f);
  }
}

// true when rows of `row_len` elements starting at p all begin on a
// 4 * sizeof(T) boundary
template <typename T> __device__ __forceinline__ bool rows_aligned4(const T* p, int row_len) {
  return row_len % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// acc[j][n] += sum_k a_j[k] * b[k * ldb + n] for four rows a_0..a_3 and four
// columns n, over k in [0, K) in ascending order, K a multiple of 4. Eight
// four-wide shared-memory loads feed 64 FMAs. Rows past the end of a tile
// are passed as any valid row and dropped by the caller's store mask.
template <typename T>
__device__ __forceinline__ void fma_rows4x4(const T* a0, const T* a1, const T* a2,
                                            const T* a3, const T* b, int ldb, int K,
                                            float acc[4][4]) {
  for (int k = 0; k < K; k += 4) {
    float av[4][4], bv[4][4];
    load4<T>(a0 + k, av[0]);
    load4<T>(a1 + k, av[1]);
    load4<T>(a2 + k, av[2]);
    load4<T>(a3 + k, av[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) load4<T>(b + (size_t)(k + i) * ldb, bv[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[j][n] = fmaf(av[j][i], bv[i][n], acc[j][n]);
  }
}

// out[c][p] = sum over the client's NG block slots, in slot order
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int C, int NG, int P) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)C * P) return;
  size_t c = i / P, p = i - c * P;
  const float* src = partial + c * NG * P + p;
  float s = 0.f;
  for (int j = 0; j < NG; ++j) s += src[(size_t)j * P];
  out[i] = s;
}

int launch_reduce_partials(const float* partial, float* out, int C, int NG, int P,
                           cudaStream_t stream) {
  const size_t n = (size_t)C * P;
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, C, NG,
                                                                         P);
  return (int)cudaGetLastError();
}

}  // namespace
