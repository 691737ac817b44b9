// paged_decode: one-token GQA decode over the CHIME tiered store and over
// a flat full-precision store, for Hopper (sm_90a).
//
// paged_decode_tiered replaces the TPU kernel
// repro/kernels/paged_decode.py::paged_decode_tiered (_paged_tiered_kernel).
// The hot ring (full precision) is read first and anchors the running max;
// then the slot's cold pages come through its block table (-1 = dead page,
// skipped), as int8 K/V with per-(token, head) f32 scales factored out of
// both dots:
//   score = (q·k_q)·scale·k_scale,   acc += (p·v_scale)·v_q.
// A cold token is attendable iff its logical position <= pos - W. With
// tau > 0 the SLIM sparse read skips a page when, for every query row g
// of the group, scale·127·max(page k-scales)·||q_g||_1 < m_g + log(tau);
// tau = 0 reads every live page.
//
// paged_decode_flat replaces the TPU kernel
// repro/kernels/paged_decode.py::paged_decode_flat (_paged_flat_kernel):
// the same page loop over a flat (B, max_len, Hkv, D) store in the model's
// type, no hot ring, no scales, no sparse read; a token is attendable iff
// its logical position <= pos. The TPU pads K/V to a whole number of
// pages; here the ragged tail page is masked (row < max_len) instead, so
// the store is never copied.
//
// Bound on the H100: bytes — the live K/V rows (hot ring + live int8
// pages + scales for the tiered store, ~1.3 MB at 4 slots x 384 cold
// tokens for fastvlm-1.7b; the first pos + 1 rows of each slot for the
// flat store, ~12 MB at 4 slots x ctx 300 for mobilevlm-3b), a few µs.
// Design: one block of 512 threads per (slot, kv head) with the G query
// rows of the group in the block, so K/V bytes are read once per group,
// not once per query head. Keys go through shared memory in chunks of 64:
// the block stages a chunk's K and V rows with coalesced loads (as f32, K
// rows padded by one word so a warp reading 32 keys' same feature hits 32
// banks; 16-byte loads, so an int8 row is 8 instructions, not 128), then
// each thread dots one key with an eighth of the query rows, one warp per
// row updates the running max and denominator, and each thread folds its
// slice of the chunk's keys into its feature of every row's accumulator;
// the slices are summed once, at the end. Chunks past the slot's last
// attendable token are not read. Per-slot lengths and block tables are
// read by the block itself (the TPU's scalar prefetch). At 4 slots this
// is 4 x Hkv blocks (8 for fastvlm-1.7b, 80 for mobilevlm-3b) on 132 SMs:
// splitting the keys across blocks (flash-decoding) is a later PR's work.
#include <type_traits>

#include "common.cuh"

constexpr int NT = 512;   // threads per block
constexpr int NW = NT / 32;
constexpr int CH = 64;    // keys per shared-memory chunk
constexpr int MAXG = 16;  // query rows per kv head
constexpr int GPT = MAXG / (NT / CH);  // query rows a thread scores

// dynamic shared memory of one block, in floats: the chunk buffers, or
// the key slices' partial accumulators (NT x MAXG) if those are larger
template <int HD>
constexpr int smem_floats() {
  constexpr int chunk = CH * (HD + 1) + CH * HD + MAXG * HD + MAXG * CH;
  return chunk > NT * MAXG ? chunk : NT * MAXG;
}

// One chunk of n <= CH keys (rows row0.. of a store with row stride rs):
// stage K and V in shared memory as f32, score every (key, query row)
// pair, update the rows' running max / denominator, and fold the chunk
// into the accumulators: thread tid owns feature tid % HD of every row,
// over the chunk keys i with i % (NT / HD) == tid / HD.
// RING: the hot ring (slot s holds position pos - ((pos - s) mod W)); else
// a paged store where a key is attendable iff logical <= pos - W and its
// row < max_rows (W = 0 for the flat store). QUANT: int8 rows with f32
// scales (the cold tier); else rows in the model's type T.
template <typename T, int HD, bool RING, bool QUANT>
__device__ __forceinline__ void process_chunk(
    const T* __restrict__ khot, const T* __restrict__ vhot,
    const int8_t* __restrict__ kq, const float* __restrict__ kscale,
    const int8_t* __restrict__ vq, const float* __restrict__ vscale,
    long long row0, int n, long long rs, long long ss, int logical0,
    int pos, int W, int max_rows, int G, float scale, float* ks, float* vs,
    const float* qs, float* sc, float* ksc, float* vsc, int* ok_s,
    float* m_s, float* d_s, float* alpha_s, float* acc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // --- stage: 16-byte loads of the chunk's K/V rows (rows are 16-byte
  // aligned: HD elements at a stride of Hkv * HD), widened to f32
  using E = typename std::conditional<QUANT, int8_t, T>::type;
  constexpr int VK = 16 / sizeof(E);
  constexpr int VPR = HD / VK;         // vectors per row
  const E* kb = QUANT ? reinterpret_cast<const E*>(kq)
                      : reinterpret_cast<const E*>(khot);
  const E* vb = QUANT ? reinterpret_cast<const E*>(vq)
                      : reinterpret_cast<const E*>(vhot);
#pragma unroll 4
  for (int idx = tid; idx < n * VPR; idx += NT) {
    const int i = idx / VPR, c = (idx % VPR) * VK;
    const long long row = row0 + i;
    float kv[VK], vv[VK];
    if (RING || row < max_rows) {
      load16_f32(kb + row * rs + c, kv);
      load16_f32(vb + row * rs + c, vv);
    } else {
#pragma unroll
      for (int e = 0; e < VK; ++e) kv[e] = vv[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VK; ++e) {
      ks[i * (HD + 1) + c + e] = kv[e];
      vs[i * HD + c + e] = vv[e];
    }
  }
  if (tid < n) {
    const long long row = row0 + tid;
    bool ok;
    if (RING) {
      const int slot = logical0 + tid;
      ok = pos - (((pos - slot) % W + W) % W) >= 0;
    } else {
      ok = (logical0 + tid <= pos - W) && row < max_rows;
    }
    ok_s[tid] = ok;
    ksc[tid] = (QUANT && ok) ? kscale[row * ss] : 1.f;
    vsc[tid] = (QUANT && ok) ? vscale[row * ss] : 1.f;
  }
  __syncthreads();
  // --- scores: thread (key i, row set gs) dots K row i with its rows
  {
    const int i = tid % CH, gs = tid / CH;
    if (i < n) {
      float part[GPT];
#pragma unroll
      for (int k = 0; k < GPT; ++k) part[k] = 0.f;
      const float* krow = ks + i * (HD + 1);
#pragma unroll 8
      for (int c = 0; c < HD; ++c) {
        const float kv = krow[c];
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
          const int g = gs + (NT / CH) * k;
          if (g < G) part[k] += qs[g * HD + c] * kv;
        }
      }
#pragma unroll
      for (int k = 0; k < GPT; ++k) {
        const int g = gs + (NT / CH) * k;
        if (g < G)
          sc[g * CH + i] = ok_s[i] ? part[k] * scale * ksc[i] : NEG_INF;
      }
    }
  }
  __syncthreads();
  // --- softmax statistics: one warp per query row
  for (int g = warp; g < G; g += NW) {
    float mt = NEG_INF;
    for (int i = lane; i < n; i += 32) mt = fmaxf(mt, sc[g * CH + i]);
    mt = warp_max(mt);
    const float m_new = fmaxf(m_s[g], mt);
    float ps = 0.f;
    for (int i = lane; i < n; i += 32) {
      // a masked key weighs exactly 0, even before any key was attendable
      const float p = ok_s[i] ? expf(sc[g * CH + i] - m_new) : 0.f;
      sc[g * CH + i] = p;
      ps += p;
    }
    ps = warp_sum(ps);
    if (lane == 0) {
      const float alpha = expf(m_s[g] - m_new);
      alpha_s[g] = alpha;
      d_s[g] = d_s[g] * alpha + ps;
      m_s[g] = m_new;
    }
  }
  __syncthreads();
  // --- accumulate: acc += (p * v_scale) * v over this thread's keys
  {
    constexpr int KQ = NT / HD;        // key slices
    const int f = tid % HD;
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] *= alpha_s[g];
    for (int i = tid / HD; i < n; i += KQ) {
      const float vv = vs[i * HD + f], vscl = vsc[i];
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] += (sc[g * CH + i] * vscl) * vv;
    }
  }
  __syncthreads();  // the next chunk overwrites the shared buffers
}

// The key slices' partial accumulators meet in shared memory (the staging
// buffers are free: process_chunk ended on a barrier) and each output row
// is divided by its denominator.
template <typename T, int HD>
__device__ __forceinline__ void finish(const float* acc, float* smem,
                                       const float* d_s, int G,
                                       T* __restrict__ ob) {
  constexpr int KQ = NT / HD;
  const int tid = threadIdx.x;
  float* part = smem;                  // KQ x MAXG x HD = NT x MAXG
  const int f = tid % HD, kslice = tid / HD;
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G) part[(kslice * MAXG + g) * HD + f] = acc[g];
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += NT) {
    const int g = idx / HD, c = idx % HD;
    float s = 0.f;
    for (int k = 0; k < KQ; ++k) s += part[(k * MAXG + g) * HD + c];
    ob[idx] = from_f32<T>(s / fmaxf(d_s[g], 1e-30f));
  }
}

// Shared-memory layout of both kernels, and the per-block prologue: the
// group's query rows staged as f32, running max / denominator reset.
#define PD_SHARED(HD)                                                   \
  extern __shared__ float smem[];                                       \
  float* ks = smem;                 /* CH x (HD + 1), padded rows */    \
  float* vs = ks + CH * (HD + 1);   /* CH x HD */                       \
  float* qs = vs + CH * HD;         /* MAXG x HD */                     \
  float* sc = qs + MAXG * HD;       /* MAXG x CH */                     \
  __shared__ float m_s[MAXG], d_s[MAXG], alpha_s[MAXG];                 \
  __shared__ float ksc[CH], vsc[CH];                                    \
  __shared__ int ok_s[CH];                                              \
  const int h = blockIdx.x, b = blockIdx.y;                             \
  const int tid = threadIdx.x;                                          \
  const int pos = lengths[b];                                           \
  const T* qb = q + ((long long)b * Hkv + h) * G * HD;                  \
  for (int idx = tid; idx < G * HD; idx += NT) qs[idx] = to_f32(qb[idx]); \
  if (tid < G) {                                                        \
    m_s[tid] = NEG_INF;                                                 \
    d_s[tid] = 0.f;                                                     \
  }                                                                     \
  __syncthreads();                                                      \
  float acc[MAXG];                                                      \
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;                          \
  const long long rs = (long long)Hkv * HD;

template <typename T, int HD>
__global__ void __launch_bounds__(NT) paged_decode_tiered_kernel(
    const T* __restrict__ q, const T* __restrict__ hot_k,
    const T* __restrict__ hot_v, const int8_t* __restrict__ ckq,
    const float* __restrict__ cks, const int8_t* __restrict__ cvq,
    const float* __restrict__ cvs, const int* __restrict__ lengths,
    const int* __restrict__ table, T* __restrict__ out, int Hkv, int G, int W,
    int max_len, int n_pages, int block_k, float scale, float log_tau,
    int use_tau) {
  PD_SHARED(HD)
  __shared__ float ql1[MAXG], red[32];
  __shared__ int live_s;
  const int lane = tid & 31, warp = tid >> 5;
  if (use_tau) {
    for (int g = warp; g < G; g += NW) {
      float s = 0.f;
      for (int c = lane; c < HD; c += 32) s += fabsf(qs[g * HD + c]);
      s = warp_sum(s);
      if (lane == 0) ql1[g] = s;
    }
  }

  // hot ring (B, W, Hkv, HD): row b*W + i at stride Hkv*HD, offset h*HD
  for (int c0 = 0; c0 < W; c0 += CH)
    process_chunk<T, HD, true, false>(
        hot_k + h * HD, hot_v + h * HD, nullptr, nullptr, nullptr, nullptr,
        (long long)b * W + c0, min(CH, W - c0), rs, 0, c0, pos, W, 0, G,
        scale, ks, vs, qs, sc, ksc, vsc, ok_s, m_s, d_s, alpha_s, acc);

  // cold pages through the block table; scales are (B, max_len, Hkv, 1)
  const int8_t* kqb = ckq + (long long)b * max_len * rs + h * HD;
  const int8_t* vqb = cvq + (long long)b * max_len * rs + h * HD;
  const float* ksb = cks + (long long)b * max_len * Hkv + h;
  const float* vsb = cvs + (long long)b * max_len * Hkv + h;
  for (int j = 0; j < n_pages; ++j) {
    const int phys = table[(long long)b * n_pages + j];
    if (phys < 0 || j * block_k > pos - W) continue;  // dead or all future
    if (use_tau) {
      float mk = 0.f;
      for (int i = tid; i < block_k; i += NT) {
        const long long row = (long long)phys * block_k + i;
        if (j * block_k + i <= pos - W && row < max_len)
          mk = fmaxf(mk, ksb[row * Hkv]);
      }
      mk = block_max(mk, red);
      if (tid == 0) {
        int live = 0;
        for (int g = 0; g < G; ++g)
          live |= scale * 127.f * mk * ql1[g] >= m_s[g] + log_tau;
        live_s = live;
      }
      __syncthreads();
      if (!live_s) continue;
    }
    for (int c0 = 0; c0 < block_k && j * block_k + c0 <= pos - W; c0 += CH)
      process_chunk<T, HD, false, true>(
          nullptr, nullptr, kqb, ksb, vqb, vsb,
          (long long)phys * block_k + c0, min(CH, block_k - c0), rs, Hkv,
          j * block_k + c0, pos, W, max_len, G, scale, ks, vs, qs, sc, ksc,
          vsc, ok_s, m_s, d_s, alpha_s, acc);
  }
  finish<T, HD>(acc, smem, d_s, G, out + ((long long)b * Hkv + h) * G * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) paged_decode_flat_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    const int* __restrict__ table, T* __restrict__ out, int Hkv, int G,
    int max_len, int n_pages, int block_k, float scale) {
  PD_SHARED(HD)
  // flat store (B, max_len, Hkv, HD): the slot's rows at stride Hkv*HD
  const T* kb = k + (long long)b * max_len * rs + h * HD;
  const T* vb = v + (long long)b * max_len * rs + h * HD;
  for (int j = 0; j < n_pages; ++j) {
    const int phys = table[(long long)b * n_pages + j];
    if (phys < 0 || j * block_k > pos) continue;  // dead or all future
    // chunk 0 of a live page holds its first token (<= pos): the running
    // max is anchored by an attendable key before any masked one counts
    for (int c0 = 0; c0 < block_k && j * block_k + c0 <= pos; c0 += CH)
      process_chunk<T, HD, false, false>(
          kb, vb, nullptr, nullptr, nullptr, nullptr,
          (long long)phys * block_k + c0, min(CH, block_k - c0), rs, 0,
          j * block_k + c0, pos, 0, max_len, G, scale, ks, vs, qs, sc, ksc,
          vsc, ok_s, m_s, d_s, alpha_s, acc);
  }
  finish<T, HD>(acc, smem, d_s, G, out + ((long long)b * Hkv + h) * G * HD);
}

// dynamic shared memory of one block, opted in above 48 KB
template <int HD, typename Kern>
static size_t prepare(Kern kern) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  return smem;
}

#define PD_DISPATCH_HD(D, CALL) \
  switch (D) {                  \
    case 16: CALL(16) break;    \
    case 32: CALL(32) break;    \
    case 64: CALL(64) break;    \
    case 128: CALL(128) break;  \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <typename T>
static int tiered(int D, const void* q, const void* hk, const void* hv,
                  const void* ckq, const void* cks, const void* cvq,
                  const void* cvs, const void* lengths, const void* table,
                  void* out, int B, int Hkv, int G, int W, int max_len,
                  int n_pages, int block_k, float scale, float log_tau,
                  int use_tau, cudaStream_t st) {
#define PD_TIERED(N)                                                         \
  {                                                                          \
    auto kern = paged_decode_tiered_kernel<T, N>;                            \
    kern<<<dim3(Hkv, B), NT, prepare<N>(kern), st>>>(                        \
        static_cast<const T*>(q), static_cast<const T*>(hk),                 \
        static_cast<const T*>(hv), static_cast<const int8_t*>(ckq),          \
        static_cast<const float*>(cks), static_cast<const int8_t*>(cvq),     \
        static_cast<const float*>(cvs), static_cast<const int*>(lengths),    \
        static_cast<const int*>(table), static_cast<T*>(out), Hkv, G, W,     \
        max_len, n_pages, block_k, scale, log_tau, use_tau);                 \
  }
  PD_DISPATCH_HD(D, PD_TIERED)
#undef PD_TIERED
  return 0;
}

template <typename T>
static int flat(int D, const void* q, const void* k, const void* v,
                const void* lengths, const void* table, void* out, int B,
                int Hkv, int G, int max_len, int n_pages, int block_k,
                float scale, cudaStream_t st) {
#define PD_FLAT(N)                                                          \
  {                                                                         \
    auto kern = paged_decode_flat_kernel<T, N>;                             \
    kern<<<dim3(Hkv, B), NT, prepare<N>(kern), st>>>(                       \
        static_cast<const T*>(q), static_cast<const T*>(k),                 \
        static_cast<const T*>(v), static_cast<const int*>(lengths),         \
        static_cast<const int*>(table), static_cast<T*>(out), Hkv, G,       \
        max_len, n_pages, block_k, scale);                                  \
  }
  PD_DISPATCH_HD(D, PD_FLAT)
#undef PD_FLAT
  return 0;
}

// q (B,Hkv,G,D); hot (B,W,Hkv,D); cold int8 (B,max_len,Hkv,D) + f32
// scales (B,max_len,Hkv,1); lengths (B,) int32; table (B,n_pages) int32
extern "C" int paged_decode_tiered(
    const void* q, const void* hk, const void* hv, const void* ckq,
    const void* cks, const void* cvq, const void* cvs, const void* lengths,
    const void* table, void* out, int B, int Hkv, int G, int D, int W,
    int max_len, int n_pages, int block_k, float scale, float log_tau,
    int use_tau, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  if (B * Hkv == 0) return static_cast<int>(cudaGetLastError());
  const int bad =
      dtype == DT_F32
          ? tiered<float>(D, q, hk, hv, ckq, cks, cvq, cvs, lengths, table,
                          out, B, Hkv, G, W, max_len, n_pages, block_k,
                          scale, log_tau, use_tau, st)
          : tiered<__nv_bfloat16>(D, q, hk, hv, ckq, cks, cvq, cvs, lengths,
                                  table, out, B, Hkv, G, W, max_len, n_pages,
                                  block_k, scale, log_tau, use_tau, st);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

// q (B,Hkv,G,D); k/v (B,max_len,Hkv,D); lengths (B,) int32; table
// (B,n_pages) int32
extern "C" int paged_decode_flat(const void* q, const void* k, const void* v,
                                 const void* lengths, const void* table,
                                 void* out, int B, int Hkv, int G, int D,
                                 int max_len, int n_pages, int block_k,
                                 float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  if (B * Hkv == 0) return static_cast<int>(cudaGetLastError());
  const int bad =
      dtype == DT_F32
          ? flat<float>(D, q, k, v, lengths, table, out, B, Hkv, G, max_len,
                        n_pages, block_k, scale, st)
          : flat<__nv_bfloat16>(D, q, k, v, lengths, table, out, B, Hkv, G,
                                max_len, n_pages, block_k, scale, st);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
