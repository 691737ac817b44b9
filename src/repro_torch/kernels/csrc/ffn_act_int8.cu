// ffn_act_int8: fused dense FFN over int8 weights with per-output-column
// f32 scales (see ffn_act.cuh for the design and the TPU kernel it
// replaces).
#include "ffn_act.cuh"

// x and out f32 (dtype 0) or bf16 (dtype 1); w1 / wg int8 (D, F) with
// scales s1 / sg (F,); w2 int8 (F, D) with scale s2 (D,); wg and sg null
// for an ungated FFN; scratch, variant and plan as for ffn_act
extern "C" int ffn_act_int8(const void* x, const void* w1, const void* s1,
                            const void* wg, const void* sg, const void* w2,
                            const void* s2, void* scratch, void* out, int M,
                            int D, int F, int act, int dtype, int variant,
                            int p0, int p1, int p2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FfnArgs a{x, w1, wg, w2, static_cast<const float*>(s1),
                  static_cast<const float*>(sg),
                  static_cast<const float*>(s2),
                  scratch, out, M, D, F, act, {p0, p1, p2}};
  return dtype == DT_F32 ? ffn_run<float, int8_t>(variant, a, st)
                         : ffn_run<__nv_bfloat16, int8_t>(variant, a, st);
}

extern "C" int ffn_smem_bytes(int form, int a, int b, int c) {
  return ffn_smem_query<int8_t>(form, a, b, c);
}
