// ffn_act: fused dense FFN for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ffn_act.py::ffn_act (_ffn_kernel):
// out = (act(x·W_up) [* x·W_gate]) · W_down with f32 accumulation; act is
// silu, tanh-GELU or relu².
//
// Bound on the H100: at decode (M = num_slots rows) it is bytes — the
// three weight matrices are read once (82.6 MB a layer for fastvlm-1.7b
// in bf16), so the kernel must spread the weight stream over every SM. At
// prefill (M in the hundreds) it is operations. On the TPU the F axis is a
// sequential grid axis accumulating into VMEM scratch; on Hopper that would
// run a decode step on one block per row tile and leave most of the 132
// SMs idle. Design: blocks over (M tile of BM rows, F chunk), BM = 16, or
// 4 at decode's M <= 4 so the accumulator stays small enough for several
// blocks per SM. A block walks its F chunk 32 hidden units at a time: it
// computes the (BM x 32) hidden tile from shared-memory tiles of x and
// W_up/W_gate, applies act and gate, keeps the tile in shared memory, and
// multiplies it into a (BM x D) register accumulator against W_down's rows.
// The (M, F) hidden therefore never reaches device memory; only each
// block's f32 partial (BM x D) does.
// A second kernel sums the partials over the F chunks in a fixed order and
// casts: no atomics, so results are deterministic. The wrapper picks the
// chunk count so the grid holds a few blocks per SM. Ragged M and F are
// masked (zero rows / zero hidden units), never asserted. Products are f32
// FMAs: wgmma/TMA come in a later PR.
#include "common.cuh"

constexpr int BF = 32;   // hidden units per inner step
constexpr int BD = 64;   // reduction depth per shared-memory tile
constexpr int NT = 256;  // threads; phase 2 gives each thread D / NT columns

enum { ACT_SILU = 0, ACT_GELU = 1, ACT_RELU2 = 2 };

__device__ __forceinline__ float activate(float h, int act) {
  if (act == ACT_SILU) return h / (1.f + expf(-h));
  if (act == ACT_GELU)
    return 0.5f * h *
           (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  const float r = fmaxf(h, 0.f);
  return r * r;
}

template <typename T, int BM, int NCH>
__global__ void __launch_bounds__(NT)
    ffn_act_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ wg, const T* __restrict__ w2,
                   float* __restrict__ partial, int M, int D, int F,
                   int f_per_block, int act, int vec) {
  __shared__ float xs[BM][BD];
  __shared__ float w1s[BD][BF];
  __shared__ float wgs[BD][BF];
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
      if (vec) {  // rows 16-byte aligned: VK elements per load
        constexpr int VK = 16 / sizeof(T);
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
            w1s[r][c + e] = ok ? a[e] : 0.f;
            wgs[r][c + e] = (ok && gated) ? g[e] : 0.f;
          }
        }
      } else {
        for (int idx = tid; idx < BD * BF; idx += NT) {
          const int r = idx / BF, c = idx % BF;
          const int d = d0 + r, f = f0 + c;
          const bool ok = d < D && f < f_hi;
          const long long off = (long long)d * F + f;
          w1s[r][c] = ok ? to_f32(w1[off]) : 0.f;
          wgs[r][c] = (ok && gated) ? to_f32(wg[off]) : 0.f;
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
    // 4 rows of W_down in flight for the 16-row tile; the 4-row (decode)
    // tile keeps its registers low instead, for more blocks per SM
#pragma unroll(BM >= 16 ? 4 : 1)
    for (int ff = 0; ff < nf; ++ff) {
      const T* w2row = w2 + (long long)(f0 + ff) * D;
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

// out = sum over F chunks of the partials, in chunk order, cast to T
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ partial,
                                  T* __restrict__ out, int n_fc,
                                  long long MD) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MD) return;
  float s = 0.f;
  for (int c = 0; c < n_fc; ++c) s += partial[(long long)c * MD + i];
  out[i] = from_f32<T>(s);
}

template <typename T, int BM, int NCH>
static void launch(const void* x, const void* w1, const void* wg,
                   const void* w2, float* partial, void* out, int M, int D,
                   int F, int f_per_block, int n_fc, int act, int vec,
                   cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, n_fc);
  ffn_act_kernel<T, BM, NCH><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(wg), static_cast<const T*>(w2), partial, M, D, F,
      f_per_block, act, vec);
  const long long MD = (long long)M * D;
  ffn_reduce_kernel<T><<<(unsigned)((MD + 255) / 256), 256, 0, stream>>>(
      partial, static_cast<T*>(out), n_fc, MD);
}

template <typename T, int BM>
static int dispatch_nch(const void* x, const void* w1, const void* wg,
                        const void* w2, float* partial, void* out, int M,
                        int D, int F, int f_per_block, int n_fc, int act,
                        int vec, cudaStream_t st) {
  const int nch = (D + NT - 1) / NT;
#define FFN_CASE(N)                                                         \
  if (nch <= N) {                                                           \
    launch<T, BM, N>(x, w1, wg, w2, partial, out, M, D, F, f_per_block,     \
                     n_fc, act, vec, st);                                   \
    return 0;                                                               \
  }
  FFN_CASE(1) FFN_CASE(2) FFN_CASE(4) FFN_CASE(6) FFN_CASE(8) FFN_CASE(10)
  FFN_CASE(12)
#undef FFN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int dispatch_bm(int bm, const void* x, const void* w1, const void* wg,
                       const void* w2, float* pt, void* out, int M, int D,
                       int F, int f_per_block, int n_fc, int act, int vec,
                       cudaStream_t st) {
  if (bm == 4)
    return dispatch_nch<T, 4>(x, w1, wg, w2, pt, out, M, D, F, f_per_block,
                              n_fc, act, vec, st);
  if (bm == 16)
    return dispatch_nch<T, 16>(x, w1, wg, w2, pt, out, M, D, F, f_per_block,
                               n_fc, act, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// partial: (n_fc, M, D) f32 scratch allocated by the caller; bm: 4 or 16;
// vec: W_up / W_gate rows are 16-byte aligned (F * itemsize % 16 == 0 and
// aligned base pointers), so their tiles load 16 bytes at a time
extern "C" int ffn_act(const void* x, const void* w1, const void* wg,
                       const void* w2, void* partial, void* out, int M, int D,
                       int F, int bm, int f_per_block, int n_fc, int act,
                       int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  float* pt = static_cast<float*>(partial);
  const int bad =
      dtype == DT_F32
          ? dispatch_bm<float>(bm, x, w1, wg, w2, pt, out, M, D, F,
                               f_per_block, n_fc, act, vec, st)
          : dispatch_bm<__nv_bfloat16>(bm, x, w1, wg, w2, pt, out, M, D, F,
                                       f_per_block, n_fc, act, vec, st);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
