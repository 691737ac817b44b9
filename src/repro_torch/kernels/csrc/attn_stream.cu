// attn_stream: flash-style GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/attn_stream.py::attn_stream
// (_attn_kernel). Online softmax over key tiles with f32 running
// (max, denominator, accumulator); causal with q_offset = L - S; the
// ragged tail and the upper triangle are masked with NEG_INF = -2**20.
//
// Bound on the H100: at the serving prefill shapes (S = L = 320, Dh 128)
// the work is ~0.3 GFLOP over ~2 MB, so operations bound it on paper and
// launch latency in practice. Design: the TPU's sequential key-block grid
// axis becomes a loop inside the block (Hopper blocks run in no order and
// carry nothing between them). One block per (b*h, 32-query tile): 4
// threads per query row, each owning every 4th feature of q and of the
// accumulator in registers (interleaved so a warp's shared-memory reads of
// a key row hit 4 consecutive banks, broadcast over its 8 rows). K/V tiles
// of 32 keys are staged in shared memory as f32 and read by the whole
// block; the KV head is h / G. Key tiles past the causal diagonal of the
// query tile are never loaded. Scores are plain f32 FMAs: wgmma/TMA come
// in a later PR.
//
// Tensors are addressed through strides (last dim contiguous), so the
// model-layout (B, S, H, D) activations and a slice of the (B, max_len,
// Hkv, D) extend workspace are read in place, without transposed copies.
#include "common.cuh"

constexpr int BQ = 32;   // query rows per block
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int TPR = 4;   // threads per query row
constexpr int NT = BQ * TPR;

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    attn_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int Hkv, int S, int L, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh,
                       long long ksl, long long vsb, long long vsh,
                       long long vsl, long long osb, long long osh,
                       long long oss, int causal, int q_offset, float scale) {
  constexpr int DPT = HD / TPR;  // features per thread
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int qt = blockIdx.x;
  const int tid = threadIdx.x;
  const int r = tid / TPR, sub = tid % TPR;
  const int qi = qt * BQ + r;
  const int q_pos = qi + q_offset;

  float qreg[DPT], acc[DPT];
  const T* qp = q + b * qsb + h * qsh + (long long)min(qi, S - 1) * qss;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qreg[i] = to_f32(qp[sub + TPR * i]);
    acc[i] = 0.f;
  }
  float m = NEG_INF, d = 0.f;

  // key tiles wholly above the diagonal of this query tile are dead
  int kv_end = L;
  if (causal) kv_end = min(L, qt * BQ + BQ + q_offset);

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int j = idx / HD, c = idx % HD;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < L) {
        kv = to_f32(kb[(long long)kj * ksl + c]);
        vv = to_f32(vb[(long long)kj * vsl + c]);
      }
      ks[j][c] = kv;
      vs[j][c] = vv;
    }
    __syncthreads();

    float s[BK];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qreg[i] * ks[j][sub + TPR * i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      const bool ok = kj < L && (!causal || kj <= q_pos);
      const float sc = ok ? part * scale : NEG_INF;
      s[j] = sc;
      mt = fmaxf(mt, sc);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    d = d * alpha + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += s[j] * vs[j][sub + TPR * i];
    }
    m = m_new;
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(d, 1e-30f);
    T* op = o + b * osb + h * osh + (long long)qi * oss;
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[sub + TPR * i] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int HD>
static void launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int S, int L, const long long* st,
                   int causal, float scale, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  attn_stream_kernel<T, HD><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, L, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, L - S, scale);
}

template <typename T>
static int dispatch_hd(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Hkv, int S, int L, int D,
                       const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, o, B, H, Hkv, S, L, st, causal, scale, stream); return 0;
    case 32: launch<T, 32>(q, k, v, o, B, H, Hkv, S, L, st, causal, scale, stream); return 0;
    case 64: launch<T, 64>(q, k, v, o, B, H, Hkv, S, L, st, causal, scale, stream); return 0;
    case 128: launch<T, 128>(q, k, v, o, B, H, Hkv, S, L, st, causal, scale, stream); return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides (elements): q b,h,s | k b,h,l | v b,h,l | o b,h,s
extern "C" int attn_stream(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int Hkv, int S, int L, int D,
                           const long long* strides, int causal, float scale,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const int bad = dtype == DT_F32
                      ? dispatch_hd<float>(q, k, v, o, B, H, Hkv, S, L, D,
                                           strides, causal, scale, st)
                      : dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S,
                                                   L, D, strides, causal,
                                                   scale, st);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
