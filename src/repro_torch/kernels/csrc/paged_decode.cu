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
// the same pages over a flat (B, max_len, Hkv, D) store in the model's
// type, no hot ring, no scales, no sparse read; a token is attendable iff
// its logical position <= pos. The TPU pads K/V to a whole number of
// pages; here the ragged tail page is masked (row < max_len) instead, so
// the store is never copied.
//
// Bound on the H100: bytes — the live K/V rows (hot ring + live int8
// pages + scales for the tiered store, ~1.3 MB at 4 slots x 384 cold
// tokens for fastvlm-1.7b; the first pos + 1 rows of each slot for the
// flat store, ~12 MB at 4 slots x ctx 300 for mobilevlm-3b), a few µs.
//
// Tiered design: one block of 512 threads per (slot, kv head) with the G
// query rows of the group in the block, so K/V bytes are read once per
// group, not once per query head. Keys go through shared memory in chunks
// of 64: the block stages a chunk's K and V rows with coalesced loads (as
// f32, K rows padded by one word so a warp reading 32 keys' same feature
// hits 32 banks; 16-byte loads, so an int8 row is 8 instructions, not
// 128), then each thread dots one key with an eighth of the query rows,
// one warp per row updates the running max and denominator, and each
// thread folds its slice of the chunk's keys into its feature of every
// row's accumulator; the slices are summed once, at the end. Chunks past
// the slot's last attendable token are not read. Per-slot lengths and
// block tables are read by the block itself (the TPU's scalar prefetch).
//
// Flat design (flash-decoding; the section at the end of this file): a
// (slot, kv head)'s live keys are split over the `split` blocks of one
// thread-block cluster (`paged_decode.flat_split` picks it from shapes
// and the SM count; the blocks read lengths[b] themselves and share the
// live range evenly, so the host never reads lengths), and inside a
// block over its 4 warps. Each warp streams its key tiles through its own
// 3-stage cp.async ring in the store's type (no widening copy, no block
// barrier in the loop: a lane reads back only the 16-byte chunks it
// copied), lanes take keys (16 bytes of one key row a lane, dot products
// summed by warp shuffles), and keeps an online softmax in registers. The
// warps' and ranks' partials (m, d, acc) merge in rank order through
// distributed shared memory: deterministic, no workspace, one launch.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

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
// row < max_rows. QUANT: int8 rows with f32 scales (the cold tier); else
// rows in the model's type T.
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

// Shared-memory layout of the tiered kernel, and the per-block prologue:
// the group's query rows staged as f32, running max / denominator reset.
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


// ---- paged_decode_flat: split-K over a thread-block cluster ----------------
constexpr int FL_WARPS = 4;
constexpr int FL_NT = 32 * FL_WARPS;
constexpr int FL_STAGES = 3;          // key tiles in a warp's cp.async ring
constexpr int FL_STAGE_BYTES = 4096;  // one warp's K and V tile
constexpr int FL_STEPS = 4;           // key steps a tile: one 16-byte K and
                                      // one V chunk a lane a step
constexpr int FL_STEP_BYTES = 32 * 16;               // a warp's chunks a step
constexpr int FL_V_OFF = FL_STEPS * FL_STEP_BYTES;  // V half of a stage
constexpr int FL_MAX_SPLIT = 8;       // portable cluster size

// dynamic shared memory of a block: the warps' rings (reused for their
// partials after the loop) and the slot's block table
__host__ __device__ constexpr int fl_ring_bytes() {
  return FL_WARPS * FL_STAGES * FL_STAGE_BYTES;
}
__host__ __device__ constexpr int fl_smem_bytes(int n_pages) {
  return fl_ring_bytes() + ((4 * n_pages + 15) & ~15);
}

// A key row of HD elements of T is LPK lanes' 16-byte chunks; a warp
// step covers KPW keys, a tile TK = KPW * FL_STEPS keys (always 4 KB of
// K and V together).
template <typename T, int HD>
struct FlatTile {
  static constexpr int VE = 16 / sizeof(T);
  static constexpr int LPK = HD / VE;
  static constexpr int KPW = 32 / LPK;
  static constexpr int TK = KPW * FL_STEPS;
  static_assert(LPK >= 1 && LPK <= 32 && KPW * LPK == 32, "head dim");
  static_assert(2 * TK * HD * sizeof(T) == FL_STAGE_BYTES, "stage size");
};

struct FlatArgs {
  const void *q, *k, *v;
  const int *lengths, *table;
  void* out;
  int Hkv, G, max_len, n_pages, block_k;
  float scale_log2;  // softmax scale * log2(e)
};

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(FL_NT) paged_decode_flat_kernel(FlatArgs a) {
  using FT = FlatTile<T, HD>;
  constexpr int VE = FT::VE, LPK = FT::LPK, KPW = FT::KPW, TK = FT::TK;
  constexpr int WARP_BYTES = FL_STAGES * FL_STAGE_BYTES;
  extern __shared__ __align__(16) uint8_t fl_smem[];
  int* tab_s = reinterpret_cast<int*>(fl_smem + fl_ring_bytes());
  __shared__ int pos_s;
  const int h = blockIdx.x, b = blockIdx.y;
  const int rank = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this lane's 16-byte chunk of a row, and its key of each step
  const int c = lane % LPK, kg = lane / LPK;
  const int G = a.G, n_pages = a.n_pages, block_k = a.block_k;

  // prologue: the slot's length and block table in one round trip, and
  // this lane's chunk of the G query rows, pre-scaled into the log2 domain
  if (tid == 0) pos_s = a.lengths[b];
  for (int j = tid; j < n_pages; j += FL_NT)
    tab_s[j] = a.table[(long long)b * n_pages + j];
  const T* qb = static_cast<const T*>(a.q) +
                ((long long)b * a.Hkv + h) * G * HD + c * VE;
  float qf[GM][VE];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VE; ++e)
      qf[g][e] = g < G ? to_f32(qb[g * HD + e]) * a.scale_log2 : 0.f;
  __syncthreads();
  const int pos = pos_s;

  // the slot's live tiles: TK keys each, tpp to a page, pages 0..pos/block_k;
  // the cluster's ranks take contiguous runs, a rank's warps every
  // FL_WARPS-th tile of its run
  const int tpp = (block_k + TK - 1) / TK;
  const int n_live =
      pos < 0 ? 0
              : min(n_pages * tpp,
                    (pos / block_k) * tpp + (pos % block_k) / TK + 1);
  const int per = (n_live + n_split - 1) / n_split;
  const int jb = min(n_live, rank * per), je = min(n_live, jb + per);
  const int nt =
      jb + warp < je ? (je - jb - warp + FL_WARPS - 1) / FL_WARPS : 0;

  const long long rs = (long long)a.Hkv * HD;
  const long long slot0 = (long long)b * a.max_len * rs + h * HD + c * VE;
  const T* kb = static_cast<const T*>(a.k) + slot0;
  const T* vb = static_cast<const T*>(a.v) + slot0;
  uint8_t* ring = fl_smem + warp * WARP_BYTES;
  // key kk (offset in page j) of tile t is attendable: a live page, inside
  // the page and the store, logical position <= pos
  auto key_ok = [&](int j, int phys, int kk) {
    return phys >= 0 && kk < block_k && j * block_k + kk <= pos &&
           (long long)phys * block_k + kk < a.max_len;
  };
  auto issue = [&](int i) {
    const int t = jb + warp + i * FL_WARPS;
    const int j = t / tpp, c0 = (t % tpp) * TK, phys = tab_s[j];
    const uint32_t st =
        smem_u32(ring + (i % FL_STAGES) * FL_STAGE_BYTES) + lane * 16;
#pragma unroll
    for (int s = 0; s < FL_STEPS; ++s) {
      const int kk = c0 + s * KPW + kg;
      const bool ok = key_ok(j, phys, kk);
      const long long off = ok ? ((long long)phys * block_k + kk) * rs : 0;
      // a masked key is zero-filled and nothing is read
      cp_async16(st + s * FL_STEP_BYTES, kb + off, ok ? 16 : 0);
      cp_async16(st + FL_V_OFF + s * FL_STEP_BYTES, vb + off, ok ? 16 : 0);
    }
  };

  float m[GM], d[GM], acc[GM][VE];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    d[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < FL_STAGES - 1; ++i) {
    if (i < nt) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    __syncwarp();  // the stage refilled here was read in iteration i - 1
    if (i + FL_STAGES - 1 < nt) issue(i + FL_STAGES - 1);
    cp_async_commit();
    cp_async_wait<FL_STAGES - 1>();  // tile i has landed
    const int t = jb + warp + i * FL_WARPS;
    const int j = t / tpp, c0 = (t % tpp) * TK, phys = tab_s[j];
    const uint8_t* st = ring + (i % FL_STAGES) * FL_STAGE_BYTES + lane * 16;
    float sc[FL_STEPS][GM];
    bool ok[FL_STEPS];
#pragma unroll
    for (int s = 0; s < FL_STEPS; ++s) {
      ok[s] = key_ok(j, phys, c0 + s * KPW + kg);
      float kv[VE];
      load16_f32(reinterpret_cast<const T*>(st + s * FL_STEP_BYTES), kv);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < VE; ++e) p += qf[g][e] * kv[e];
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        sc[s][g] = ok[s] ? p : NEG_INF;
      }
    }
    // online softmax over the tile's TK keys, warp-wide
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mt = NEG_INF;
#pragma unroll
      for (int s = 0; s < FL_STEPS; ++s) mt = fmaxf(mt, sc[s][g]);
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float mn = fmaxf(m[g], mt), alpha = exp2f(m[g] - mn);
      m[g] = mn;
      float ps = 0.f;
#pragma unroll
      for (int s = 0; s < FL_STEPS; ++s) {
        // a masked key weighs exactly 0, even before any key was attendable
        sc[s][g] = ok[s] ? exp2f(sc[s][g] - mn) : 0.f;
        ps += sc[s][g];
      }
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      d[g] = d[g] * alpha + ps;
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int s = 0; s < FL_STEPS; ++s) {
      float vv[VE];
      load16_f32(
          reinterpret_cast<const T*>(st + FL_V_OFF + s * FL_STEP_BYTES), vv);
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[g][e] += sc[s][g] * vv[e];
    }
  }
  cp_async_wait<0>();

  // the warp's keys of one step were split over its KPW key groups
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VE; ++e)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  // the warp's partial over its ring: m[GM], d[GM], acc[GM][HD]
  __syncwarp();
  float* part = reinterpret_cast<float*>(ring);
  if (lane == 0)
    for (int g = 0; g < G; ++g) {
      part[g] = m[g];
      part[GM + g] = d[g];
    }
  if (kg == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          part[2 * GM + g * HD + c * VE + e] = acc[g][e];

  // merge the warps' and ranks' partials in (rank, warp) order into rank 0
  auto merge = [&](auto part_of) {
    T* ob = static_cast<T*>(a.out) + ((long long)b * a.Hkv + h) * G * HD;
    for (int idx = tid; idx < G * HD; idx += FL_NT) {
      const int g = idx / HD;
      float mm = NEG_INF, dd = 0.f, aa = 0.f;
      for (int r = 0; r < n_split; ++r) {
        const float* pr = part_of(r);
        for (int w = 0; w < FL_WARPS; ++w) {
          const float* p = pr + w * (WARP_BYTES / 4);
          const float mb = p[g], mx = fmaxf(mm, mb);
          const float sa = exp2f(mm - mx), sb = exp2f(mb - mx);
          dd = dd * sa + p[GM + g] * sb;
          aa = aa * sa + p[2 * GM + idx] * sb;
          mm = mx;
        }
      }
      ob[idx] = from_f32<T>(aa / fmaxf(dd, 1e-30f));
    }
  };
  float* local = reinterpret_cast<float*>(fl_smem);
  if (n_split == 1) {
    __syncthreads();
    merge([&](int) { return static_cast<const float*>(local); });
  } else {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every rank's partials are written
    if (rank == 0)
      merge([&](int r) {
        return static_cast<const float*>(cl.map_shared_rank(local, r));
      });
    cl.sync();  // rank 0 has read them: the others may exit
  }
}

template <typename T, int HD, int GM>
static int launch_flat(const FlatArgs& a, int B, int split, cudaStream_t st) {
  auto kern = paged_decode_flat_kernel<T, HD, GM>;
  const int smem = fl_smem_bytes(a.n_pages);
  static int granted = 48 * 1024;  // dynamic shared memory opted in so far
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv, B, split);
  cfg.blockDim = dim3(FL_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, a));
}

template <typename T, int HD>
static int flat_g(const FlatArgs& a, int B, int split, cudaStream_t st) {
  if (a.G <= 1) return launch_flat<T, HD, 1>(a, B, split, st);
  if (a.G <= 2) return launch_flat<T, HD, 2>(a, B, split, st);
  if (a.G <= 4) return launch_flat<T, HD, 4>(a, B, split, st);
  if (a.G <= 8) return launch_flat<T, HD, 8>(a, B, split, st);
  return launch_flat<T, HD, MAXG>(a, B, split, st);
}

template <typename T>
static int flat(int D, const FlatArgs& a, int B, int split, cudaStream_t st) {
  switch (D) {
    case 16: return flat_g<T, 16>(a, B, split, st);
    case 32: return flat_g<T, 32>(a, B, split, st);
    case 64: return flat_g<T, 64>(a, B, split, st);
    case 128: return flat_g<T, 128>(a, B, split, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (B,Hkv,G,D); k/v (B,max_len,Hkv,D), rows 16-byte aligned; lengths (B,)
// int32; table (B,n_pages) int32. Each (slot, kv head)'s live keys are
// split over a cluster of ``split`` blocks (`paged_decode.flat_split`).
extern "C" int paged_decode_flat(const void* q, const void* k, const void* v,
                                 const void* lengths, const void* table,
                                 void* out, int B, int Hkv, int G, int D,
                                 int max_len, int n_pages, int block_k,
                                 float scale, int dtype, int split,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAXG || split < 1 || split > FL_MAX_SPLIT || block_k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * Hkv == 0) return static_cast<int>(cudaGetLastError());
  const FlatArgs a = {q, k, v, static_cast<const int*>(lengths),
                      static_cast<const int*>(table), out, Hkv, G, max_len,
                      n_pages, block_k, scale * 1.4426950408889634f};
  const int bad = dtype == DT_F32 ? flat<float>(D, a, B, split, st)
                                  : flat<__nv_bfloat16>(D, a, B, split, st);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

// the flat kernel's dynamic shared memory at ``n_pages`` table entries, for
// the Python mirror (`paged_decode.flat_smem_bytes`)
extern "C" int paged_decode_flat_smem_bytes(int n_pages) {
  return fl_smem_bytes(n_pages);
}
