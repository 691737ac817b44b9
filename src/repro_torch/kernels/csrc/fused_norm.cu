// fused_norm: row RMSNorm / LayerNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_norm.py::fused_norm
// (_norm_kernel). f32 math, eps added to the (biased) variance, then
// * scale (+ bias), output in the input type.
//
// Bound on the H100: bytes. One read of x, one write of the output and
// one read of scale/bias; there is nothing for the tensor cores. At
// decode (4 rows of 3-5 KB) the bytes take nanoseconds, so what sets the
// time is the chain of dependent steps. Design: the row lives in
// registers. A row's threads (tpr, a multiple of 32, about one 16-byte
// vector a thread; `fused_norm.threads_per_row`) each issue their
// 16-byte loads of x AND of scale (and bias) together, before the
// reduction, so the kernel makes one round trip to device memory, not
// two; the sum is a warp shuffle plus, across a row's warps, one
// shared-memory hop (LayerNorm: a second one for its centred pass, taken
// from registers with the same two-pass arithmetic); the output goes out
// in 16-byte stores. The scalar variant (VE = 1: one element at a time)
// takes a D, row pitch or base address that 16-byte vectors do not fit;
// the wrapper picks the variant. One block per row (prefill's hundreds
// of rows fill the card), or a few rows a block where a row has at most
// two warps. Ragged M needs no masking beyond the last block's rows.
#include "common.cuh"

constexpr int FN_BLOCK = 128;   // threads a block when rows share one
constexpr int FN_MAX_VPT = 8;   // vectors a thread

// N elements of E at p (aligned to N * sizeof(E), or to 16 bytes) as f32:
// 16-byte loads, one 8- or 4-byte load, or one scalar
template <typename E, int N>
__device__ __forceinline__ void load_f32(const E* __restrict__ p,
                                         float* out) {
  constexpr int BYTES = N * static_cast<int>(sizeof(E));
  if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / sizeof(E);
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      alignas(16) E buf[PER];
      *reinterpret_cast<uint4*>(buf) = reinterpret_cast<const uint4*>(p)[i];
#pragma unroll
      for (int e = 0; e < PER; ++e) out[i * PER + e] = to_f32(buf[e]);
    }
  } else if constexpr (BYTES == 8) {
    alignas(8) E buf[N];
    *reinterpret_cast<uint2*>(buf) = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(buf[e]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(p[e]);
  }
}

// N f32 values to p in T: one 16-byte store, or scalars
template <typename T, int N>
__device__ __forceinline__ void store_from_f32(T* __restrict__ p,
                                               const float* v) {
  if constexpr (N * sizeof(T) == 16) {
    alignas(16) T buf[N];
#pragma unroll
    for (int e = 0; e < N; ++e) buf[e] = from_f32<T>(v[e]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(buf);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = from_f32<T>(v[e]);
  }
}

// The sum of ``v`` over a row's threads (threadIdx.x of row threadIdx.y):
// warp shuffles, then, if the row has several warps, one hop through
// ``red`` (one slot a warp of the block), added in warp order.
__device__ __forceinline__ float row_sum(float v, float* red) {
  const int wpr = blockDim.x >> 5;
  v = warp_sum(v);
  if (wpr == 1) return v;
  float* rr = red + threadIdx.y * wpr;
  if ((threadIdx.x & 31) == 0) rr[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < wpr; ++i) t += rr[i];
  return t;
}

// VE elements a unit (16 / sizeof(T) for the vector variant, 1 for the
// scalar one); each thread holds up to VPT units of its row, unit i at
// thread i % tpr.
template <typename T, typename S, int VE, int VPT>
__global__ void fused_norm_kernel(const T* __restrict__ x,
                                  const S* __restrict__ scale,
                                  const S* __restrict__ bias,
                                  T* __restrict__ out, int M, int D,
                                  long long x_stride, int layer, float eps) {
  __shared__ float red[2][32];
  const int tpr = blockDim.x, t = threadIdx.x;
  const long long m = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = m < M;
  const int nu = D / VE;
  const T* xr = x + m * x_stride;
  float xv[VPT][VE], sv[VPT][VE], bv[VPT][VE];
  // every load of the row, x and scale (and bias), before the reduction
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = k * tpr + t;
    if (live && i < nu) {
      load_f32<T, VE>(xr + i * VE, xv[k]);
      load_f32<S, VE>(scale + i * VE, sv[k]);
      if (layer) load_f32<S, VE>(bias + i * VE, bv[k]);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) xv[k][e] = sv[k][e] = bv[k][e] = 0.f;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int e = 0; e < VE; ++e) s += layer ? xv[k][e] : xv[k][e] * xv[k][e];
  s = row_sum(s, red[0]);
  float mean = 0.f, var;
  if (layer) {
    mean = s / D;
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      if (k * tpr + t < nu)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const float c = xv[k][e] - mean;
          s2 += c * c;
        }
    var = row_sum(s2, red[1]) / D;
  } else {
    var = s / D;
  }
  const float inv = rsqrtf(var + eps);
  T* orow = out + m * D;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = k * tpr + t;
    if (live && i < nu) {
      float y[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        y[e] = (xv[k][e] - mean) * inv * sv[k][e];
        if (layer) y[e] += bv[k][e];
      }
      store_from_f32<T, VE>(orow + i * VE, y);
    }
  }
}

template <typename T, typename S, int VE>
static int launch(const void* x, const void* scale, const void* bias,
                  void* out, int M, int D, long long xs, int layer, float eps,
                  int tpr, cudaStream_t stream) {
  if (tpr < 32 || tpr > 1024 || tpr % 32 || D % VE)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vpt = (D / VE + tpr - 1) / tpr;
  const int rows = tpr <= 64 ? FN_BLOCK / tpr : 1;
  const dim3 grid((M + rows - 1) / rows), block(tpr, rows);
#define FN_LAUNCH(V)                                                     \
  fused_norm_kernel<T, S, VE, V><<<grid, block, 0, stream>>>(            \
      static_cast<const T*>(x), static_cast<const S*>(scale),            \
      static_cast<const S*>(bias), static_cast<T*>(out), M, D, xs, layer, \
      eps)
  if (vpt <= 1) FN_LAUNCH(1);
  else if (vpt <= 2) FN_LAUNCH(2);
  else if (vpt <= 4) FN_LAUNCH(4);
  else if (vpt <= FN_MAX_VPT) FN_LAUNCH(FN_MAX_VPT);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef FN_LAUNCH
  return 0;
}

template <typename T, typename S>
static int launch_variant(int vec, const void* x, const void* scale,
                          const void* bias, void* out, int M, int D,
                          long long xs, int layer, float eps, int tpr,
                          cudaStream_t st) {
  constexpr int VEC = static_cast<int>(16 / sizeof(T));
  if (vec)
    return launch<T, S, VEC>(x, scale, bias, out, M, D, xs, layer, eps, tpr,
                             st);
  return launch<T, S, 1>(x, scale, bias, out, M, D, xs, layer, eps, tpr, st);
}

// x (M, D) at row pitch x_stride (elements), out (M, D) contiguous. mode
// bits: 1 LayerNorm (with bias), 2 x is bf16, 4 scale/bias are bf16, 8 the
// 16-byte vector variant (D, x_stride and every base 16-byte aligned in
// vectors); from bit 4 on, the threads a row (`fused_norm.threads_per_row`).
extern "C" int fused_norm(const void* x, const void* scale, const void* bias,
                          void* out, int M, int D, long long x_stride,
                          float eps, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int layer = mode & 1, vec = (mode >> 3) & 1, tpr = mode >> 4;
  int bad = 0;
  if (M > 0) {
    switch ((mode >> 1) & 3) {
      case 0:
        bad = launch_variant<float, float>(vec, x, scale, bias, out, M, D,
                                           x_stride, layer, eps, tpr, st);
        break;
      case 1:
        bad = launch_variant<__nv_bfloat16, float>(
            vec, x, scale, bias, out, M, D, x_stride, layer, eps, tpr, st);
        break;
      case 2:
        bad = launch_variant<float, __nv_bfloat16>(
            vec, x, scale, bias, out, M, D, x_stride, layer, eps, tpr, st);
        break;
      default:
        bad = launch_variant<__nv_bfloat16, __nv_bfloat16>(
            vec, x, scale, bias, out, M, D, x_stride, layer, eps, tpr, st);
    }
  }
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
