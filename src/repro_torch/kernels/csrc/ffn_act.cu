// ffn_act: fused dense FFN over weights in the model's type (see
// ffn_act.cuh for the design and the TPU kernel it replaces).
#include "ffn_act.cuh"

// x, weights and out all f32 (dtype 0) or all bf16 (dtype 1)
extern "C" int ffn_act(const void* x, const void* w1, const void* wg,
                       const void* w2, void* partial, void* out, int M, int D,
                       int F, int bm, int f_per_block, int n_fc, int act,
                       int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const FfnArgs a{x, w1, wg, w2, nullptr, nullptr, nullptr,
                  static_cast<float*>(partial), out, M, D, F, f_per_block,
                  n_fc, act, vec};
  const int bad = dtype == DT_F32
                      ? ffn_dispatch<float, float>(bm, a, st)
                      : ffn_dispatch<__nv_bfloat16, __nv_bfloat16>(bm, a, st);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
