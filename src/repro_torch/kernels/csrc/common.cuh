// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is built on its own by nvcc into a shared object
// with a plain C interface (loaded from Python with ctypes): element
// types are passed as an int code, pointers as void*, and every C entry
// returns cudaGetLastError() right after its launches so a refused
// launch is reported to the caller.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1 };

// the reference's mask fill (-2**20), not -inf: exp(NEG_INF - m) underflows
// to exactly 0 for any real running max m
#define NEG_INF (-1048576.0f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// Load 16 bytes (16 / sizeof(E) elements) from a 16-byte-aligned address
// and widen them to f32: one memory instruction instead of up to 16.
template <typename E>
__device__ __forceinline__ void load16_f32(const E* src, float* dst) {
  constexpr int N = 16 / sizeof(E);
  alignas(16) E buf[N];
  *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int e = 0; e < N; ++e) dst[e] = to_f32(buf[e]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum; every thread gets the result. ``red`` holds >= 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();  // ``red`` may still be read from a previous call
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
  return warp_sum(t);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : NEG_INF;
  return warp_max(t);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
