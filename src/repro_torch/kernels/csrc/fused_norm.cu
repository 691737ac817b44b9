// fused_norm: row RMSNorm / LayerNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_norm.py::fused_norm
// (_norm_kernel). f32 math, eps added to the (biased) variance, then
// * scale (+ bias), output in the input type.
//
// Bound on the H100: bytes. One read of x, one write of the output and
// one read of scale/bias; there is nothing for the tensor cores. Design:
// one block per row, so decode's M = num_slots rows still spread over
// M SMs and prefill's hundreds of rows fill the card. The row is staged
// once in shared memory as f32 (both LayerNorm passes read it from
// there, never from device memory again), reductions are warp shuffles
// plus one shared-memory hop. Ragged M needs no masking: the grid is M.
#include "common.cuh"

template <typename T, typename S>
__global__ void fused_norm_kernel(const T* __restrict__ x,
                                  const S* __restrict__ scale,
                                  const S* __restrict__ bias,
                                  T* __restrict__ out, int D,
                                  long long x_stride, long long o_stride,
                                  int layer, float eps) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const long long m = blockIdx.x;
  const T* xr = x + m * x_stride;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    row[i] = v;  // each thread re-reads only what it wrote: no barrier
    s += layer ? v : v * v;
  }
  s = block_sum(s, red);
  float mean = 0.f, var;
  if (layer) {
    mean = s / D;
    float s2 = 0.f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float c = row[i] - mean;
      s2 += c * c;
    }
    var = block_sum(s2, red) / D;
  } else {
    var = s / D;
  }
  const float inv = rsqrtf(var + eps);
  T* orow = out + m * o_stride;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float v = (row[i] - mean) * inv * to_f32(scale[i]);
    if (bias != nullptr) v += to_f32(bias[i]);
    orow[i] = from_f32<T>(v);
  }
}

template <typename T, typename S>
static void launch(const void* x, const void* scale, const void* bias,
                   void* out, int M, int D, long long xs, long long os,
                   int layer, float eps, cudaStream_t stream) {
  const int threads = D <= 1024 ? 128 : 256;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  auto kern = fused_norm_kernel<T, S>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  kern<<<M, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const S*>(bias), static_cast<T*>(out), D, xs, os, layer,
      eps);
}

extern "C" int fused_norm(const void* x, const void* scale, const void* bias,
                          void* out, int M, int D, long long x_stride,
                          long long o_stride, int layer, float eps,
                          int x_dtype, int s_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    if (x_dtype == DT_F32 && s_dtype == DT_F32)
      launch<float, float>(x, scale, bias, out, M, D, x_stride, o_stride,
                           layer, eps, st);
    else if (x_dtype == DT_F32)
      launch<float, __nv_bfloat16>(x, scale, bias, out, M, D, x_stride,
                                   o_stride, layer, eps, st);
    else if (s_dtype == DT_F32)
      launch<__nv_bfloat16, float>(x, scale, bias, out, M, D, x_stride,
                                   o_stride, layer, eps, st);
    else
      launch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, out, M, D,
                                           x_stride, o_stride, layer, eps,
                                           st);
  }
  return static_cast<int>(cudaGetLastError());
}
