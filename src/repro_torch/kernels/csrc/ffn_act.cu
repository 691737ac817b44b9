// ffn_act: fused dense FFN over weights in the model's type (see
// ffn_act.cuh for the design and the TPU kernel it replaces).
#include "ffn_act.cuh"

// x, weights and out all f32 (dtype 0) or all bf16 (dtype 1); scratch
// the f32 partials of the stream and fma forms, the (M, F) bf16 hidden
// of the wgmma form or the pair planes of the tf32x3 form; variant VAR_*
// with its plan p0..p2
extern "C" int ffn_act(const void* x, const void* w1, const void* wg,
                       const void* w2, void* scratch, void* out, int M,
                       int D, int F, int act, int dtype, int variant, int p0,
                       int p1, int p2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FfnArgs a{x,       w1,  wg, w2, nullptr, nullptr, nullptr,
                  scratch, out, M,  D,  F,       act,     {p0, p1, p2}};
  return dtype == DT_F32
             ? ffn_run<float, float>(variant, a, st)
             : ffn_run<__nv_bfloat16, __nv_bfloat16>(variant, a, st);
}

extern "C" int ffn_smem_bytes(int form, int a, int b, int c) {
  return ffn_smem_query<__nv_bfloat16>(form, a, b, c);
}
