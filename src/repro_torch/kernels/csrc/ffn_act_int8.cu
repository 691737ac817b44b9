// ffn_act_int8: fused dense FFN over int8 weights with per-output-column
// f32 scales (see ffn_act.cuh for the design and the TPU kernel it
// replaces).
#include "ffn_act.cuh"

// x and out f32 (dtype 0) or bf16 (dtype 1); w1 / wg int8 (D, F) with
// scales s1 / sg (F,); w2 int8 (F, D) with scale s2 (D,); wg and sg null
// for an ungated FFN
extern "C" int ffn_act_int8(const void* x, const void* w1, const void* s1,
                            const void* wg, const void* sg, const void* w2,
                            const void* s2, void* partial, void* out, int M,
                            int D, int F, int bm, int f_per_block, int n_fc,
                            int act, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const FfnArgs a{x, w1, wg, w2, static_cast<const float*>(s1),
                  static_cast<const float*>(sg),
                  static_cast<const float*>(s2),
                  static_cast<float*>(partial), out, M, D, F, f_per_block,
                  n_fc, act, vec};
  const int bad = dtype == DT_F32
                      ? ffn_dispatch<float, int8_t>(bm, a, st)
                      : ffn_dispatch<__nv_bfloat16, int8_t>(bm, a, st);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
