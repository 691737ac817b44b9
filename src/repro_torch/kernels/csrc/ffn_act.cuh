// Fused dense FFN for Hopper (sm_90a), shared by ffn_act.cu (weights in
// the model's type) and ffn_act_int8.cu (int8 weights with per-output-
// column f32 scales).
//
// ffn_act replaces the TPU kernel repro/kernels/ffn_act.py::ffn_act
// (_ffn_kernel); ffn_act_int8 replaces repro/kernels/ffn_act.py::
// ffn_act_int8 (_ffn_q_kernel). Both compute
// out = (act(x·W_up) [* x·W_gate]) · W_down with f32 accumulation; act is
// silu, tanh-GELU or relu². In the int8 form each weight is dequantized in
// registers as it is staged, w = w_q · scale[column] in f32, before its
// dot (the TPU kernel's order; no int8 MMA, which would requantize x),
// except W_down's scale, which is per output column and is applied once
// to each output element by the reduction kernel: Σ_f h·(w_q·s) =
// s·Σ_f h·w_q. The TPU kernel is ungated only; the model's int8 path
// (apply_mlp's int8 branch) also runs silu_gated, so this kernel takes an
// optional int8 W_gate with its own scales.
//
// Bound on the H100: at decode (M = num_slots rows) it is bytes — the
// weight matrices are read once (82.6 MB a layer for fastvlm-1.7b in
// bf16; 53.1 MB a layer for mobilevlm-3b in int8), so the kernel must
// spread the weight stream over every SM. At prefill (M in the hundreds)
// it is operations. On the TPU the F axis is a sequential grid axis
// accumulating into VMEM scratch; on Hopper that would run a decode step
// on one block per row tile and leave most of the 132 SMs idle. Design:
// blocks over (M tile of BM rows, F chunk), BM = 16, or 4 at decode's
// M <= 4 so the accumulator stays small enough for several blocks per SM.
// A block walks its F chunk 32 hidden units at a time: it computes the
// (BM x 32) hidden tile from shared-memory tiles of x and W_up/W_gate
// (16-byte weight loads: 8 bf16 or 16 int8 values), applies act and gate,
// keeps the tile in shared memory, and multiplies it into a (BM x D)
// register accumulator against W_down's rows (int8 rows are first staged
// in shared memory with 16-byte loads; bf16 rows are read straight from
// device memory, 2 bytes a thread). The (M, F) hidden therefore
// never reaches device memory; only each block's f32 partial (BM x D)
// does. A second kernel sums the partials over the F chunks in a fixed
// order and casts: no atomics, so results are deterministic. The wrapper
// picks the chunk count so the grid holds a few blocks per SM. Ragged M
// and F are masked (zero rows / zero hidden units), never asserted.
// Products are f32 FMAs: wgmma/TMA come in a later PR.
#pragma once

#include "common.cuh"

constexpr int BF = 32;   // hidden units per inner step
constexpr int NT = 256;  // threads; phase 2 gives each thread D / NT columns

enum { ACT_SILU = 0, ACT_GELU = 1, ACT_RELU2 = 2 };
// bits of ``vec``: rows of W_up / W_gate, and of W_down, start 16-byte
// aligned, so their tiles may load 16 bytes at a time
enum { VEC_UP = 1, VEC_DOWN = 2 };

__device__ __forceinline__ float activate(float h, int act) {
  if (act == ACT_SILU) return h / (1.f + expf(-h));
  if (act == ACT_GELU)
    return 0.5f * h *
           (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  const float r = fmaxf(h, 0.f);
  return r * r;
}

// T: the type of x and out; WT: the weights' type (T, or int8_t with the
// column scales s1 / sg of W_up / W_gate)
template <typename T, typename WT, int BM, int NCH>
__global__ void __launch_bounds__(NT)
    ffn_act_kernel(const T* __restrict__ x, const WT* __restrict__ w1,
                   const WT* __restrict__ wg, const WT* __restrict__ w2,
                   const float* __restrict__ s1,
                   const float* __restrict__ sg,
                   float* __restrict__ partial, int M, int D, int F,
                   int f_per_block, int act, int vec) {
  constexpr bool QUANT = sizeof(WT) == 1;
  // reduction depth per shared-memory tile: 64, or 128 for int8 weights,
  // so that a tile of W_up is one 16-byte load per thread in both cases
  // and the block walks D in as few load -> barrier -> FMA rounds
  constexpr int BD = QUANT ? 128 : 64;
  __shared__ float xs[BM][BD];
  // the W_up / W_gate tiles; in phase 2 the int8 form stages W_down's
  // rows here
  __shared__ __align__(16) float wsm[2][BD][BF];
  float(*w1s)[BF] = wsm[0];
  float(*wgs)[BF] = wsm[1];
  __shared__ float hs[BM][BF];
  const int m0 = blockIdx.x * BM;
  const int fc = blockIdx.y;
  const int f_lo = fc * f_per_block;
  const int f_hi = min(F, f_lo + f_per_block);
  const int tid = threadIdx.x;
  const bool gated = wg != nullptr;
  constexpr int RPT = (BM + 7) / 8;        // phase-1 rows per thread
  const int pf = tid % BF, pr = tid / BF;  // rows pr, pr + 8, ...

  float acc[BM][NCH];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[r][c] = 0.f;

  for (int f0 = f_lo; f0 < f_hi; f0 += BF) {
    float hu[RPT], hg[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) hu[k] = hg[k] = 0.f;
    for (int d0 = 0; d0 < D; d0 += BD) {
      __syncthreads();  // previous tiles (and hs) fully consumed
      for (int idx = tid; idx < BM * BD; idx += NT) {
        const int r = idx / BD, c = idx % BD;
        const int m = m0 + r, d = d0 + c;
        xs[r][c] = (m < M && d < D) ? to_f32(x[(long long)m * D + d]) : 0.f;
      }
      if (vec & VEC_UP) {  // rows 16-byte aligned: VK elements per load
        constexpr int VK = 16 / sizeof(WT);
        for (int idx = tid; idx < BD * (BF / VK); idx += NT) {
          const int r = idx / (BF / VK), c = (idx % (BF / VK)) * VK;
          const int d = d0 + r, f = f0 + c;
          float a[VK], g[VK];
          const long long off = (long long)d * F + f;
          if (d < D && f < f_hi) {   // f_hi - f0 is a multiple of VK
            load16_f32(w1 + off, a);
            if (gated) load16_f32(wg + off, g);
          }
#pragma unroll
          for (int e = 0; e < VK; ++e) {
            const bool ok = d < D && f + e < f_hi;
            w1s[r][c + e] = ok ? a[e] * (QUANT ? s1[f + e] : 1.f) : 0.f;
            wgs[r][c + e] =
                (ok && gated) ? g[e] * (QUANT ? sg[f + e] : 1.f) : 0.f;
          }
        }
      } else {
        for (int idx = tid; idx < BD * BF; idx += NT) {
          const int r = idx / BF, c = idx % BF;
          const int d = d0 + r, f = f0 + c;
          const bool ok = d < D && f < f_hi;
          const long long off = (long long)d * F + f;
          w1s[r][c] = ok ? to_f32(w1[off]) * (QUANT ? s1[f] : 1.f) : 0.f;
          wgs[r][c] = (ok && gated)
                          ? to_f32(wg[off]) * (QUANT ? sg[f] : 1.f)
                          : 0.f;
        }
      }
      __syncthreads();
      if (pr < BM) {
#pragma unroll 8
        for (int c = 0; c < BD; ++c) {
          const float a = w1s[c][pf], g = wgs[c][pf];
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            const float xv = xs[pr + 8 * k][c];
            hu[k] += xv * a;
            hg[k] += xv * g;
          }
        }
      }
    }
    if (pr < BM) {
      const bool f_ok = f0 + pf < f_hi;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        float h = activate(hu[k], act);
        if (gated) h *= hg[k];
        hs[pr + 8 * k][pf] = f_ok ? h : 0.f;
      }
    }
    __syncthreads();
    const int nf = min(BF, f_hi - f0);
    if constexpr (QUANT) {
      // int8 W_down: RS rows at a time are copied into shared memory (over
      // the phase-1 tiles, consumed by now) with 16-byte loads, then each
      // thread widens its NCH columns of a row from there
      constexpr int STR = NCH * NT;  // staged row stride, bytes
      constexpr int RS = (int)sizeof(wsm) / STR < BF ? (int)sizeof(wsm) / STR
                                                     : BF;
      int8_t* w2s = reinterpret_cast<int8_t*>(&wsm[0][0][0]);
      for (int r0 = 0; r0 < nf; r0 += RS) {
        const int nr = min(RS, nf - r0);
        __syncthreads();  // the previous stage (or phase 1) fully read
        const WT* src = w2 + (long long)(f0 + r0) * D;
        if (vec & VEC_DOWN) {  // D % 16 == 0 and an aligned base
          const int nv = D / 16;
          for (int idx = tid; idx < nr * nv; idx += NT) {
            const int rr = idx / nv, cv = idx % nv;
            *reinterpret_cast<uint4*>(w2s + rr * STR + cv * 16) =
                *reinterpret_cast<const uint4*>(src + (long long)rr * D +
                                                cv * 16);
          }
        } else {
          for (int idx = tid; idx < nr * D; idx += NT)
            w2s[(idx / D) * STR + idx % D] = src[idx];
        }
        __syncthreads();
#pragma unroll(BM >= 16 ? 4 : 1)
        for (int rr = 0; rr < nr; ++rr) {
          float wv[NCH];
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const int n = tid + NT * c;
            wv[c] = n < D ? static_cast<float>(w2s[rr * STR + n]) : 0.f;
          }
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            const float h = hs[r][r0 + rr];
#pragma unroll
            for (int c = 0; c < NCH; ++c) acc[r][c] += h * wv[c];
          }
        }
      }
    } else {
      // 4 rows of W_down in flight for the 16-row tile; the 4-row
      // (decode) tile keeps its registers low instead, for more blocks
      // per SM
#pragma unroll(BM >= 16 ? 4 : 1)
      for (int ff = 0; ff < nf; ++ff) {
        const WT* w2row = w2 + (long long)(f0 + ff) * D;
        float wv[NCH];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int n = tid + NT * c;
          wv[c] = n < D ? to_f32(w2row[n]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float h = hs[r][ff];
#pragma unroll
          for (int c = 0; c < NCH; ++c) acc[r][c] += h * wv[c];
        }
      }
    }
  }

  float* pb = partial + (long long)fc * M * D;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int n = tid + NT * c;
      if (n < D) pb[(long long)m * D + n] = acc[r][c];
    }
  }
}

// out = sum over F chunks of the partials, in chunk order, times W_down's
// column scale s2 where the weights are int8, cast to T
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ s2,
                                  T* __restrict__ out, int n_fc, int D,
                                  long long MD) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MD) return;
  float s = 0.f;
  for (int c = 0; c < n_fc; ++c) s += partial[(long long)c * MD + i];
  out[i] = from_f32<T>(s2 ? s * s2[i % D] : s);
}

// Weight and scale pointers of one call; the scales are null for weights
// in the model's type.
struct FfnArgs {
  const void *x, *w1, *wg, *w2;
  const float *s1, *sg, *s2;
  float* partial;  // (n_fc, M, D) f32 scratch allocated by the caller
  void* out;
  int M, D, F, f_per_block, n_fc, act, vec;
};

template <typename T, typename WT, int BM, int NCH>
static void launch(const FfnArgs& a, cudaStream_t stream) {
  dim3 grid((a.M + BM - 1) / BM, a.n_fc);
  ffn_act_kernel<T, WT, BM, NCH><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const WT*>(a.w1),
      static_cast<const WT*>(a.wg), static_cast<const WT*>(a.w2), a.s1, a.sg,
      a.partial, a.M, a.D, a.F, a.f_per_block, a.act, a.vec);
  const long long MD = (long long)a.M * a.D;
  ffn_reduce_kernel<T><<<(unsigned)((MD + 255) / 256), 256, 0, stream>>>(
      a.partial, a.s2, static_cast<T*>(a.out), a.n_fc, a.D, MD);
}

template <typename T, typename WT, int BM>
static int dispatch_nch(const FfnArgs& a, cudaStream_t st) {
  const int nch = (a.D + NT - 1) / NT;
#define FFN_CASE(N)                  \
  if (nch <= N) {                    \
    launch<T, WT, BM, N>(a, st);     \
    return 0;                        \
  }
  FFN_CASE(1) FFN_CASE(2) FFN_CASE(4) FFN_CASE(6) FFN_CASE(8) FFN_CASE(10)
  FFN_CASE(12)
#undef FFN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// bm: 4 or 16; vec: VEC_UP where W_up / W_gate rows are 16-byte aligned
// (F * itemsize % 16 == 0 and aligned base pointers), VEC_DOWN where W_down
// rows are (D * itemsize % 16 == 0; read by the int8 form only). WT is the
// weights' type for x and out in T.
template <typename T, typename WT>
static int ffn_dispatch(int bm, const FfnArgs& a, cudaStream_t st) {
  if (bm == 4) return dispatch_nch<T, WT, 4>(a, st);
  if (bm == 16) return dispatch_nch<T, WT, 16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
