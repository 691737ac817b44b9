// paged_decode: one-token GQA decode over the CHIME tiered store and over
// a flat full-precision store, for Hopper (sm_90a).
//
// paged_decode_tiered replaces the TPU kernel
// repro/kernels/paged_decode.py::paged_decode_tiered (_paged_tiered_kernel).
// The hot ring (full precision; slot i holds position pos - ((pos - i) mod
// W), attendable iff i <= pos) and the slot's cold pages, read through its
// block table (-1 = dead page, skipped) as int8 K/V with per-(token, head)
// f32 scales factored out of both dots:
//   score = (q·k_q)·scale·k_scale,   acc += (p·v_scale)·v_q.
// A cold token is attendable iff its logical position <= pos - W and its
// row < max_len. With tau > 0 the SLIM sparse read skips a page when, for
// every query row g of the group, scale·127·max(page k-scales)·||q_g||_1 <
// m_g + log(tau), m_g the running max over the hot ring and the pages read
// before it; tau = 0 reads every live page.
//
// paged_decode_flat replaces the TPU kernel
// repro/kernels/paged_decode.py::paged_decode_flat (_paged_flat_kernel):
// the same pages over a flat (B, max_len, Hkv, D) store in the model's
// type, no hot ring, no scales, no sparse read; a token is attendable iff
// its logical position <= pos. The TPU pads K/V to a whole number of
// pages; here the ragged tail page is masked (row < max_len) instead, so
// the store is never copied.
//
// Bound on the H100: bytes -- the live K/V rows (hot ring + live int8
// pages + their scales for the tiered store, ~1.3 MB at 4 slots x 384 cold
// tokens for fastvlm-1.7b, ~8.7 MB at mobilevlm-3b's 20 kv heads; the
// first pos + 1 rows of each slot for the flat store, ~12 MB at 4 slots x
// ctx 300 for mobilevlm-3b), a few µs. At decode there are only B x Hkv
// (slot, kv head) pairs (8 at fastvlm-1.7b, 80 at mobilevlm-3b) for 132
// SMs, so one block a pair leaves the card idle and every load latency
// exposed.
//
// Design, both kernels (flash-decoding): a (slot, kv head)'s live key
// tiles are split over the `split` blocks of one thread-block cluster
// (`paged_decode.tiered_split` / `flat_split` pick it from shapes and the
// SM count; the blocks read lengths[b] and the table row themselves and
// share the live tiles evenly, so the host never reads lengths), and
// inside a block over its 4 warps. Each warp streams its key tiles
// through its own 3-stage cp.async ring (no widening copy, no block
// barrier in the loop: a lane reads back the bytes it copied, or, on the
// tensor-core path below, its warp's after a warp barrier; a masked key
// is zero-filled and nothing is read for it), lanes take keys
// (one key row over LPK lanes, dot products summed by warp shuffles), and
// keeps an online softmax in registers in the exp2 domain (q pre-scaled
// by scale·log2(e)). The partials (m, d, acc) merge in two fixed levels --
// each block's warps, then the cluster's blocks, each level weighting its
// partials at their common max, the second through distributed shared
// memory with each rank merging a share of the outputs: deterministic, no
// workspace, one launch; an empty warp or rank gives (NEG_INF, 0, 0),
// which weighs 0.
//
// Head dims. A key row is split over LPK lanes, LPK its 16-byte chunks
// (8 features a chunk in the tiered kernel) rounded up to a power of two
// and at most 32: a row of 20 chunks (Dh 160 in bf16) takes a whole warp,
// the 12 lanes past its end copy zeros and hold zero q, so every
// shuffle tree and lane map stays a power of two; past 32 chunks (f32 at
// Dh 160 / 256 in the flat kernel) a lane holds CH = 2 chunks of a row.
// A warp's partial (G x Dh f32) goes over its ring after the loop, so
// groups above 8 are refused at Dh 256 where the ring is 4 KB a stage.
//
// Tiered specifics. A (slot, kv head)'s tile list is the hot ring's tiles,
// then the cold pages' tiles up to the one holding position pos - W. The
// two sources differ in element size, so a lane owns the same 8 features
// of a key row in both (a 16-byte chunk of a bf16 hot row, two of an f32
// one, an 8-byte chunk of an int8 cold row) and hot and cold tiles fold
// into the same accumulators; a cold tile carries its keys' k and v
// scales (a 4-byte cp.async a lane). In bf16 with 2+ query rows a tile's
// scores are tensor-core products instead of shuffle-reduced dot products
// (mma.sync m16n8k16: q's rows, padded to 16, against 8 keys; int8 keys
// widened to bf16, exactly; K chunks XOR-swizzled so the fragment loads
// hit distinct banks): the softmax runs on the score fragments, a quad of
// lanes a row, and the weights reach the V sums, which stay f32, through
// a small warp scratch after the block table; an mma takes 8 keys, so
// where a warp's row is the whole warp (Dh 160 / 256) its stages are 8 KB
// (8 keys of K and V). tau > 0 keeps the reference's skip decisions: the
// rule is a chain in page order, so the kernel runs one block a (slot, kv
// head) (split 1), takes the hot ring, then the pages in logical order,
// its 4 warps sharing each page's tiles, and at each page boundary applies
// the test to the block-wide max of the warps' m -- a max does not depend
// on order, so the decisions equal the sequential ones.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

constexpr int MAXG = 16;  // query rows per kv head

// ---- shared by both kernels: split-K over a thread-block cluster ----------
constexpr int FL_WARPS = 4;
constexpr int FL_NT = 32 * FL_WARPS;
constexpr int FL_STAGES = 3;          // key tiles in a warp's cp.async ring
constexpr int FL_STAGE_BYTES = 4096;  // one warp's K and V tile
constexpr int FL_MAX_SPLIT = 8;       // portable cluster size

// dynamic shared memory of a block: the warps' rings (reused for their
// partials after the loop) and the slot's block table
__host__ __device__ constexpr int fl_ring_bytes(int stage = FL_STAGE_BYTES) {
  return FL_WARPS * FL_STAGES * stage;
}
__host__ __device__ constexpr int fl_table_bytes(int n_pages) {
  return (4 * n_pages + 15) & ~15;
}
__host__ __device__ constexpr int fl_smem_bytes(int n_pages) {
  return fl_ring_bytes() + fl_table_bytes(n_pages);
}
// lanes a key row of ``chunks`` chunks is split over: the chunks rounded
// up to a power of two, at most a warp
__host__ __device__ constexpr int row_lanes(int chunks) {
  int p = 1;
  while (p < chunks && p < 32) p <<= 1;
  return p;
}
// the largest query group of head dim ``hd``: a warp's partial (2 + hd
// floats a row) fits its 4 KB-stage ring up to 16 rows at Dh <= 160
__host__ __device__ constexpr int max_group(int hd) {
  return hd > 160 ? 8 : MAXG;
}

// cp.async of 8 or 4 bytes (.ca: .cg takes only 16); ``bytes`` 0 zero-fills
// the destination and reads nothing
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// 8 features of a key row from shared memory, widened to f32: 16 bytes of
// bf16, 32 of f32, 8 of int8
template <typename E>
__device__ __forceinline__ void load8_f32(const uint8_t* src, float* dst) {
  constexpr int N = 16 / sizeof(E);
#pragma unroll
  for (int x = 0; x < 8; x += N)
    load16_f32(reinterpret_cast<const E*>(src) + x, dst + x);
}
template <>
__device__ __forceinline__ void load8_f32<int8_t>(const uint8_t* src,
                                                  float* dst) {
  alignas(8) int8_t buf[8];
  *reinterpret_cast<uint2*>(buf) = *reinterpret_cast<const uint2*>(src);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = static_cast<float>(buf[e]);
}

// D += A·B on tensor cores: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 features (the low byte first) as a bf16 pair, exactly
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint16_t v) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(v & 0xff)),
                            static_cast<float>(static_cast<int8_t>(v >> 8)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A warp's online-softmax update over one tile's STEPS x KPW keys: sc holds
// the lane's key's log2-domain scores (NEG_INF where masked); on return it
// holds their weights (exactly 0 where masked) and m, d, acc are rescaled.
template <int STEPS, int GM, int VE, int LPK>
__device__ __forceinline__ void softmax_step(float (&sc)[STEPS][GM],
                                             const bool (&ok)[STEPS],
                                             float (&m)[GM], float (&d)[GM],
                                             float (&acc)[GM][VE]) {
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float mt = NEG_INF;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) mt = fmaxf(mt, sc[s][g]);
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float mn = fmaxf(m[g], mt), alpha = exp2f(m[g] - mn);
    m[g] = mn;
    float ps = 0.f;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
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
}

// After a warp's loop (its cp.async groups drained): fold the warp's key
// groups together and write the warp's partial m[GM], d[GM], acc[GM][HD]
// over its own ring; then combine the block's warps, then the cluster's
// blocks, each level at its partials' common max (weights exp2(m - max)
// in a fixed order): the block's in local shared memory (the weights
// once a query row), the ranks' through distributed shared memory (each
// rank a share of the outputs, every rank's loads issued before the
// sums); and write the output rows ``ob``. An empty partial (NEG_INF, 0,
// 0) weighs 0 beside any live one.
// A lane holds CH chunks of VE features of a row, chunk x at features
// (c + LPK x) VE (lanes c past the row's NCH = HD / VE chunks hold none).
template <typename T, int HD, int GM, int LPK, int CH, int VE, int STAGE>
__device__ __forceinline__ void merge_partials(const float (&m)[GM],
                                               const float (&d)[GM],
                                               float (&acc)[GM][CH * VE],
                                               uint8_t* smem, int G,
                                               T* __restrict__ ob) {
  constexpr int NCH = HD / VE;
  constexpr int WARP_FLOATS = FL_STAGES * STAGE / 4;
  static_assert(2 * GM + GM * HD <= WARP_FLOATS, "a warp's partial");
  constexpr int NI = (GM * HD + FL_NT - 1) / FL_NT;  // outputs a thread has
  __shared__ float wgt_s[FL_WARPS][GM], bm_s[GM], bd_s[GM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = lane % LPK, kg = lane / LPK;
  const int rank = blockIdx.z, n_split = gridDim.z;
  // the warp's keys of one step were split over its KPW key groups
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < CH * VE; ++e)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  __syncwarp();
  float* part = reinterpret_cast<float*>(smem) + warp * WARP_FLOATS;
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
        for (int x = 0; x < CH; ++x)
          if (c + LPK * x < NCH)
#pragma unroll
            for (int e = 0; e < VE; ++e)
              part[2 * GM + g * HD + (c + LPK * x) * VE + e] =
                  acc[g][x * VE + e];
  __syncthreads();  // every warp's partial is written

  // the block's warps: a query row's weights, then outputs tid, tid +
  // FL_NT, ...
  const float* parts = reinterpret_cast<const float*>(smem);
  if (tid < G) {
    float mx = NEG_INF, dd = 0.f;
#pragma unroll
    for (int w = 0; w < FL_WARPS; ++w)
      mx = fmaxf(mx, parts[w * WARP_FLOATS + tid]);
#pragma unroll
    for (int w = 0; w < FL_WARPS; ++w) {
      const float* p = parts + w * WARP_FLOATS;
      const float e = exp2f(p[tid] - mx);
      wgt_s[w][tid] = e;
      dd += e * p[GM + tid];
    }
    bm_s[tid] = mx;
    bd_s[tid] = dd;
  }
  __syncthreads();
  float ba[NI];
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int idx = tid + k * FL_NT, g = idx / HD;
    ba[k] = 0.f;
    if (idx < G * HD)
#pragma unroll
      for (int w = 0; w < FL_WARPS; ++w)
        ba[k] += wgt_s[w][g] * parts[w * WARP_FLOATS + 2 * GM + idx];
  }
  if (n_split == 1) {
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const int idx = tid + k * FL_NT;
      if (idx < G * HD)
        ob[idx] = from_f32<T>(ba[k] / fmaxf(bd_s[idx / HD], 1e-30f));
    }
    return;
  }
  __syncthreads();  // the warps' partials are read: warp 0's ring takes the
                    // block's
  float* blk = reinterpret_cast<float*>(smem);
  if (tid < G) {
    blk[tid] = bm_s[tid];
    blk[GM + tid] = bd_s[tid];
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int idx = tid + k * FL_NT;
    if (idx < G * HD) blk[2 * GM + idx] = ba[k];
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every rank's block partial is written
  // the ranks' block partials: rank r takes outputs r * FL_NT + tid,
  // stepping by split * FL_NT
  const float* rp[FL_MAX_SPLIT];
#pragma unroll
  for (int r = 0; r < FL_MAX_SPLIT; ++r)
    rp[r] = r < n_split ? cl.map_shared_rank(blk, r) : blk;
  for (int idx = rank * FL_NT + tid; idx < G * HD; idx += n_split * FL_NT) {
    const int g = idx / HD;
    float pm[FL_MAX_SPLIT], pd[FL_MAX_SPLIT], pa[FL_MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < FL_MAX_SPLIT; ++r) {
      pm[r] = rp[r][g];
      pd[r] = rp[r][GM + g];
      pa[r] = rp[r][2 * GM + idx];
    }
    float mx = NEG_INF, dd = 0.f, aa = 0.f;
#pragma unroll
    for (int r = 0; r < FL_MAX_SPLIT; ++r)
      if (r < n_split) mx = fmaxf(mx, pm[r]);
#pragma unroll
    for (int r = 0; r < FL_MAX_SPLIT; ++r)
      if (r < n_split) {
        const float e = exp2f(pm[r] - mx);
        dd += e * pd[r];
        aa += e * pa[r];
      }
    ob[idx] = from_f32<T>(aa / fmaxf(dd, 1e-30f));
  }
  cl.sync();  // every rank has read the others' partials: they may exit
}

// Launch ``kern`` on a (Hkv, B, split) grid of FL_NT-thread blocks, the
// ``split`` blocks of a (slot, kv head) one cluster, with ``smem`` bytes of
// dynamic shared memory, opted in above ``granted`` (the kernel's own
// record of what it was granted so far).
template <typename Args>
static int launch_cluster(void (*kern)(Args), int& granted, const Args& a,
                          int Hkv, int B, int split, int smem,
                          cudaStream_t st) {
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, B, split);
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

// ---- paged_decode_flat ------------------------------------------------------
constexpr int FL_STEPS = 4;  // 16-byte K and V chunks a lane a tile

// A key row of HD elements of T is NCH 16-byte chunks over LPK lanes (CH
// chunks a lane); a warp step covers KPW keys, a tile TK = KPW * STEPS
// keys (4 KB of K and V together, the padding lanes' zeros included).
template <typename T, int HD>
struct FlatTile {
  static constexpr int VE = 16 / sizeof(T);
  static constexpr int NCH = HD / VE;
  static constexpr int LPK = row_lanes(NCH);
  static constexpr int CH = (NCH + LPK - 1) / LPK;
  static constexpr int KPW = 32 / LPK;
  static constexpr int STEPS = FL_STEPS / CH;
  static constexpr int TK = KPW * STEPS;
  static constexpr int X_BYTES = 32 * 16;  // a warp's x-th chunks of a step
  static constexpr int STEP_BYTES = CH * X_BYTES;  // a warp's chunks a step
  static constexpr int V_OFF = STEPS * STEP_BYTES;  // V half of a stage
  static_assert(HD % VE == 0 && CH * LPK >= NCH && (CH == 1 || CH == 2),
                "head dim");
  static_assert(2 * V_OFF == FL_STAGE_BYTES, "stage size");
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
  constexpr int CH = FT::CH, NCH = FT::NCH, STEPS = FT::STEPS;
  constexpr int SB = FT::STEP_BYTES;
  constexpr int WARP_BYTES = FL_STAGES * FL_STAGE_BYTES;
  extern __shared__ __align__(16) uint8_t fl_smem[];
  int* tab_s = reinterpret_cast<int*>(fl_smem + fl_ring_bytes());
  __shared__ int pos_s;
  const int h = blockIdx.x, b = blockIdx.y;
  const int rank = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this lane's 16-byte chunks of a row (c + LPK x; past NCH: none), and
  // its key of each step
  const int c = lane % LPK, kg = lane / LPK;
  const int G = a.G, n_pages = a.n_pages, block_k = a.block_k;
  bool live_ch[CH];
#pragma unroll
  for (int x = 0; x < CH; ++x) live_ch[x] = c + LPK * x < NCH;

  // prologue: the slot's length and block table in one round trip, and
  // this lane's chunks of the G query rows, pre-scaled into the log2 domain
  if (tid == 0) pos_s = a.lengths[b];
  for (int j = tid; j < n_pages; j += FL_NT)
    tab_s[j] = a.table[(long long)b * n_pages + j];
  const T* qb = static_cast<const T*>(a.q) +
                ((long long)b * a.Hkv + h) * G * HD + c * VE;
  float qf[GM][CH * VE];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int x = 0; x < CH; ++x)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        qf[g][x * VE + e] =
            g < G && live_ch[x]
                ? to_f32(qb[g * HD + LPK * x * VE + e]) * a.scale_log2
                : 0.f;
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
    for (int s = 0; s < STEPS; ++s) {
      const int kk = c0 + s * KPW + kg;
      const bool ok = key_ok(j, phys, kk);
      const long long off = ok ? ((long long)phys * block_k + kk) * rs : 0;
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        // a masked key (and a padding lane) is zero-filled, nothing read
        const int n = ok && live_ch[x] ? 16 : 0;
        const long long o = n ? off + LPK * x * VE : 0;
        cp_async16(st + s * SB + x * FT::X_BYTES, kb + o, n);
        cp_async16(st + FT::V_OFF + s * SB + x * FT::X_BYTES, vb + o, n);
      }
    }
  };

  float m[GM], d[GM], acc[GM][CH * VE];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    d[g] = 0.f;
#pragma unroll
    for (int e = 0; e < CH * VE; ++e) acc[g][e] = 0.f;
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
    float sc[STEPS][GM];
    bool ok[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      ok[s] = key_ok(j, phys, c0 + s * KPW + kg);
      float kv[CH * VE];
#pragma unroll
      for (int x = 0; x < CH; ++x)
        load16_f32(reinterpret_cast<const T*>(st + s * SB + x * FT::X_BYTES),
                   kv + x * VE);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < CH * VE; ++e) p += qf[g][e] * kv[e];
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        sc[s][g] = ok[s] ? p : NEG_INF;
      }
    }
    softmax_step<STEPS, GM, CH * VE, LPK>(sc, ok, m, d, acc);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      float vv[CH * VE];
#pragma unroll
      for (int x = 0; x < CH; ++x)
        load16_f32(reinterpret_cast<const T*>(st + FT::V_OFF + s * SB +
                                              x * FT::X_BYTES),
                   vv + x * VE);
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < CH * VE; ++e) acc[g][e] += sc[s][g] * vv[e];
    }
  }
  cp_async_wait<0>();
  merge_partials<T, HD, GM, LPK, CH, VE, FL_STAGE_BYTES>(
      m, d, acc, fl_smem, G,
      static_cast<T*>(a.out) + ((long long)b * a.Hkv + h) * G * HD);
}

template <typename T, int HD, int GM>
static int launch_flat(const FlatArgs& a, int B, int split, cudaStream_t st) {
  static int granted = 48 * 1024;  // dynamic shared memory opted in so far
  return launch_cluster(paged_decode_flat_kernel<T, HD, GM>, granted, a,
                        a.Hkv, B, split, fl_smem_bytes(a.n_pages), st);
}

template <typename T, int HD>
static int flat_g(const FlatArgs& a, int B, int split, cudaStream_t st) {
  if (a.G <= 1) return launch_flat<T, HD, 1>(a, B, split, st);
  if (a.G <= 2) return launch_flat<T, HD, 2>(a, B, split, st);
  if (a.G <= 4) return launch_flat<T, HD, 4>(a, B, split, st);
  if (a.G <= 8) return launch_flat<T, HD, 8>(a, B, split, st);
  if constexpr (max_group(HD) == MAXG)
    return launch_flat<T, HD, MAXG>(a, B, split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int flat(int D, const FlatArgs& a, int B, int split, cudaStream_t st) {
  switch (D) {
    case 16: return flat_g<T, 16>(a, B, split, st);
    case 32: return flat_g<T, 32>(a, B, split, st);
    case 64: return flat_g<T, 64>(a, B, split, st);
    case 128: return flat_g<T, 128>(a, B, split, st);
    case 160: return flat_g<T, 160>(a, B, split, st);
    case 256: return flat_g<T, 256>(a, B, split, st);
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
  if (G < 1 || G > max_group(D) || split < 1 || split > FL_MAX_SPLIT ||
      block_k < 1)
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

// ---- paged_decode_tiered ----------------------------------------------------
// A lane owns VE = 8 features of a key row in both sources: a hot row of T
// is LPK lanes' HB-byte chunks, a cold int8 row LPK lanes' 8-byte chunks
// (LPK the row's hd / 8 chunks rounded up to a power of two: lanes past
// them copy zeros); a warp step covers KPW keys, a tile TK = KPW * STEPS
// keys of one source. A hot tile's K and V fill a stage (4 KB, or 8 KB on
// the tensor-core path at LPK 32, whose mma takes 8 keys); a cold tile's
// K, V and scales fit in it.
__host__ __device__ constexpr bool td_mma(int es, int gm) {
  return es == 2 && gm >= 2;
}
__host__ __device__ constexpr int td_stage_bytes(int es, int hd, int gm) {
  return td_mma(es, gm) && row_lanes(hd / 8) == 32 ? 2 * FL_STAGE_BYTES
                                                    : FL_STAGE_BYTES;
}
__host__ __device__ constexpr int td_tile_keys(int es, int hd, int gm) {
  return 32 / row_lanes(hd / 8) * (td_stage_bytes(es, hd, gm) / (512 * es));
}

template <typename T, int HD, int GM>
struct TieredTile {
  static constexpr int VE = 8;
  static constexpr int NCH = HD / VE;
  static constexpr int LPK = row_lanes(NCH);
  static constexpr int KPW = 32 / LPK;
  static constexpr int HB = VE * static_cast<int>(sizeof(T));
  static constexpr int STAGE = td_stage_bytes(sizeof(T), HD, GM);
  static constexpr int STEPS = STAGE / (2 * 32 * HB);
  static constexpr int TK = KPW * STEPS;
  static constexpr int HV_OFF = STEPS * 32 * HB;  // hot: K, then V
  static constexpr int CV_OFF = STEPS * 32 * 8;   // cold: K, V, k / v scales
  static constexpr int KS_OFF = 2 * CV_OFF;
  static constexpr int VS_OFF = KS_OFF + STEPS * 32 * 4;
  // the tensor-core path stores chunk c of key row n at c ^ (n & SW), so
  // the 8 rows of an mma fragment load hit distinct banks
  static constexpr int SW = (LPK < 8 ? LPK : 8) - 1;
  static_assert(HD % 16 == 0 && NCH <= LPK && KPW * LPK == 32, "head dim");
  static_assert(TK == td_tile_keys(sizeof(T), HD, GM), "tile keys");
  static_assert(2 * HV_OFF == STAGE, "hot stage size");
  static_assert(VS_OFF + STEPS * 32 * 4 <= STAGE, "cold stage size");
};

// the tiered kernel's dynamic shared memory: the rings and the table, then
// (bf16 with 2+ query rows: the tensor-core scores) each warp's scratch of
// TK x GM weights and 3 x GM row sums
__host__ __device__ constexpr int td_scratch_floats(int es, int hd, int gm) {
  return td_mma(es, gm) ? gm * (td_tile_keys(es, hd, gm) + 3) : 0;
}
__host__ __device__ constexpr int td_smem_bytes(int n_pages, int es, int hd,
                                                int gm) {
  return fl_ring_bytes(td_stage_bytes(es, hd, gm)) + fl_table_bytes(n_pages) +
         4 * FL_WARPS * td_scratch_floats(es, hd, gm);
}

struct TieredArgs {
  const void *q, *hk, *hv;
  const int8_t *ckq, *cvq;
  const float *cks, *cvs;
  const int *lengths, *table;
  void* out;
  int Hkv, G, W, max_len, n_pages, block_k;
  float scale_log2;  // softmax scale * log2(e)
  float log_tau2;    // log(tau) * log2(e), read when sparse
  int sparse;        // tau > 0: one block a (slot, kv head), page order
};

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(FL_NT)
    paged_decode_tiered_kernel(TieredArgs a) {
  using TT = TieredTile<T, HD, GM>;
  constexpr int VE = TT::VE, LPK = TT::LPK, KPW = TT::KPW, HB = TT::HB;
  constexpr int STEPS = TT::STEPS, TK = TT::TK, SW = TT::SW;
  constexpr int STAGE = TT::STAGE, WARP_BYTES = FL_STAGES * STAGE;
  // bf16 with 2+ query rows: a tile's scores on tensor cores (q·K^T, 16
  // padded query rows x 8 keys an mma), the softmax over the score
  // fragments, the weights through a warp scratch to the V sums below
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value && GM >= 2;
  static_assert(MMA == td_mma(sizeof(T), GM) && (!MMA || TK % 8 == 0),
                "tensor-core tiles");
  extern __shared__ __align__(16) uint8_t td_smem[];
  int* tab_s = reinterpret_cast<int*>(td_smem + fl_ring_bytes(STAGE));
  __shared__ int pos_s;
  const int h = blockIdx.x, b = blockIdx.y;
  const int rank = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this lane's 8 features of a row (none past the row's NCH chunks), and
  // its key of each step
  const int c = lane % LPK, kg = lane / LPK;
  const bool live_ch = c < TT::NCH;
  const int G = a.G, W = a.W, n_pages = a.n_pages, block_k = a.block_k;
  const int max_len = a.max_len;

  // prologue: the slot's length and block table in one round trip, and
  // this lane's features of the G query rows, pre-scaled into the log2
  // domain
  if (tid == 0) pos_s = a.lengths[b];
  for (int j = tid; j < n_pages; j += FL_NT)
    tab_s[j] = a.table[(long long)b * n_pages + j];
  const T* qb = static_cast<const T*>(a.q) +
                ((long long)b * a.Hkv + h) * G * HD + c * VE;
  float qf[GM][VE];  // 16-byte loads: q is 16-byte aligned (the wrapper)
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G && live_ch)
      load8_f32<T>(reinterpret_cast<const uint8_t*>(qb + g * HD), qf[g]);
#pragma unroll
    for (int e = 0; e < VE; ++e)
      qf[g][e] = g < G && live_ch ? qf[g][e] * a.scale_log2 : 0.f;
  }
  // the mma A fragments of q (bf16, unscaled): rows g0 and g0 + 8 (zero
  // past G), features 16kk + 2qd (+1) and + 8
  const int g0 = lane >> 2, qd = lane & 3;
  constexpr int KSTEPS = MMA ? HD / 16 : 1;
  uint32_t qa[KSTEPS][4];
  if constexpr (MMA) {
    const T* qg = static_cast<const T*>(a.q) +
                  ((long long)b * a.Hkv + h) * G * HD;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = g0 + (i & 1) * 8;
        const int col = 16 * kk + 2 * qd + (i >> 1) * 8;
        qa[kk][i] = row < G ? *reinterpret_cast<const uint32_t*>(
                                  qg + row * HD + col)
                            : 0u;
      }
  }
  __syncthreads();
  const int pos = pos_s;
  const int last = pos - W;  // the last attendable cold position

  // the tile list: the hot ring's slots 0..min(W, pos + 1), then TK-key
  // tiles of the cold pages, tpp to a page, up to the one holding `last`
  const int n_hot = pos < 0 ? 0 : min((W + TK - 1) / TK, pos / TK + 1);
  const int tpp = (block_k + TK - 1) / TK;
  const int n_cold =
      last < 0 ? 0
               : min(n_pages * tpp,
                     (last / block_k) * tpp + (last % block_k) / TK + 1);

  const long long rs = (long long)a.Hkv * HD;
  const long long hot0 = (long long)b * W * rs + h * HD + c * VE;
  const long long cold0 = (long long)b * max_len * rs + h * HD + c * VE;
  const uint8_t* hkb =
      reinterpret_cast<const uint8_t*>(static_cast<const T*>(a.hk) + hot0);
  const uint8_t* hvb =
      reinterpret_cast<const uint8_t*>(static_cast<const T*>(a.hv) + hot0);
  const int8_t* ckb = a.ckq + cold0;
  const int8_t* cvb = a.cvq + cold0;
  const float* ksb = a.cks + (long long)b * max_len * a.Hkv + h;
  const float* vsb = a.cvs + (long long)b * max_len * a.Hkv + h;
  uint8_t* ring = td_smem + warp * WARP_BYTES;

  // ring slot i holds position pos - ((pos - i) mod W): attendable iff
  // i <= pos
  auto hot_ok = [&](int slot) { return slot < W && slot <= pos; };
  // key kk of logical page j (physical page phys): a live page, inside the
  // page and the store, logical position <= pos - W
  auto cold_ok = [&](int j, int phys, int kk) {
    return phys >= 0 && kk < block_k && j * block_k + kk <= last &&
           (long long)phys * block_k + kk < max_len;
  };
  auto issue = [&](int t, int i) {
    const uint32_t st = smem_u32(ring + (i % FL_STAGES) * STAGE);
    if (t < n_hot) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int slot = t * TK + s * KPW + kg;
        const bool ok = hot_ok(slot) && live_ch;
        const long long off = ok ? (long long)slot * rs * sizeof(T) : 0;
        const int n = s * KPW + kg;  // the key's row in the tile
        const uint32_t dv = st + TT::HV_OFF + (s * 32 + lane) * HB;
        const uint32_t dk =
            MMA ? st + (n * LPK + (c ^ (n & SW))) * HB : dv - TT::HV_OFF;
#pragma unroll
        for (int x = 0; x < HB; x += 16) {
          cp_async16(dk + x, hkb + off + x, ok ? 16 : 0);
          cp_async16(dv + x, hvb + off + x, ok ? 16 : 0);
        }
      }
    } else {
      const int u = t - n_hot, j = u / tpp, c0 = (u % tpp) * TK;
      const int phys = tab_s[j];
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int kk = c0 + s * KPW + kg;
        const bool ok = cold_ok(j, phys, kk);
        const long long row = ok ? (long long)phys * block_k + kk : 0;
        const int n = s * KPW + kg;  // the key's row in the tile
        const uint32_t dv = st + TT::CV_OFF + (s * 32 + lane) * 8;
        const uint32_t dk =
            MMA ? st + (n * LPK + (c ^ (n & SW))) * 8 : dv - TT::CV_OFF;
        const uint32_t d4 = st + TT::KS_OFF + (s * 32 + lane) * 4;
        cp_async8(dk, ckb + row * rs, ok && live_ch ? 8 : 0);
        cp_async8(dv, cvb + row * rs, ok && live_ch ? 8 : 0);
        cp_async4(d4, ksb + row * a.Hkv, ok ? 4 : 0);
        cp_async4(d4 + (TT::VS_OFF - TT::KS_OFF), vsb + row * a.Hkv,
                  ok ? 4 : 0);
      }
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
  // the tensor-core path's warp scratch, after the table: a tile's weights
  // p[key][row], and each row's alpha, new max and weight sum
  constexpr int SCR = td_scratch_floats(sizeof(T), HD, GM);
  static_assert(SCR == (MMA ? TK * GM + 3 * GM : 0), "warp scratch");
  float* scr =
      reinterpret_cast<float*>(td_smem + fl_ring_bytes(STAGE) +
                               fl_table_bytes(n_pages)) +
      warp * SCR;
  // fold tile t, landed in stage i % FL_STAGES, into m, d, acc
  auto consume = [&](int t, int i) {
    const uint8_t* st = ring + (i % FL_STAGES) * STAGE;
    const bool hot = t < n_hot;
    const int u = t - n_hot;
    const int j = hot ? 0 : u / tpp, c0 = hot ? 0 : (u % tpp) * TK;
    const int phys = hot ? 0 : tab_s[j];
    // key n of the tile is attendable
    auto key_ok = [&](int n) {
      return hot ? hot_ok(t * TK + n) : cold_ok(j, phys, c0 + n);
    };
    if constexpr (MMA) {
      __syncwarp();  // every lane's copies of the tile are visible
      constexpr int NB = TK / 8;  // 8-key blocks: the mma's n
      float sc[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        // B fragment: key row n = 8nb + g0, features 16kk + 2qd (+1), + 8
        const int n = nb * 8 + g0;
        sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t b0, b1;
          if (hot) {
            const uint8_t* row = st + n * LPK * 16 + 4 * qd;
            b0 = *reinterpret_cast<const uint32_t*>(
                row + ((2 * kk) ^ (n & SW)) * 16);
            b1 = *reinterpret_cast<const uint32_t*>(
                row + ((2 * kk + 1) ^ (n & SW)) * 16);
          } else {
            const uint8_t* row = st + n * LPK * 8 + 2 * qd;
            b0 = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(
                row + ((2 * kk) ^ (n & SW)) * 8));
            b1 = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(
                row + ((2 * kk + 1) ^ (n & SW)) * 8));
          }
          mma_bf16(sc[nb], qa[kk], b0, b1);
        }
      }
      // scores: row g0 (+ 8) of keys 8nb + 2qd + e, in the log2 domain
      bool okn[NB][2];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nb * 8 + 2 * qd + e;
          okn[nb][e] = key_ok(n);
          const float ksc =
              hot ? a.scale_log2
                  : a.scale_log2 * *reinterpret_cast<const float*>(
                                       st + TT::KS_OFF + n * LPK * 4);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            sc[nb][2 * h2 + e] =
                okn[nb][e] ? sc[nb][2 * h2 + e] * ksc : NEG_INF;
        }
      // the softmax of each of this lane's rows over the tile, its quad
      // holding the row's keys
#pragma unroll
      for (int h2 = 0; h2 < (GM > 8 ? 2 : 1); ++h2) {
        const int r = g0 + 8 * h2;
        float mt = NEG_INF, mo = NEG_INF;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mt = fmaxf(mt, fmaxf(sc[nb][2 * h2], sc[nb][2 * h2 + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g == r) mo = m[g];
        const float mn = fmaxf(mo, mt);
        float ps = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // a masked key weighs exactly 0, even before any key was
            // attendable
            const float p =
                okn[nb][e] ? exp2f(sc[nb][2 * h2 + e] - mn) : 0.f;
            ps += p;
            if (r < GM) scr[(nb * 8 + 2 * qd + e) * GM + r] = p;
          }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        if (qd == 0 && r < GM) {
          scr[TK * GM + r] = exp2f(mo - mn);
          scr[TK * GM + GM + r] = mn;
          scr[TK * GM + 2 * GM + r] = ps;
        }
      }
      __syncwarp();  // the weights and row statistics are in the scratch
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float alpha = scr[TK * GM + g];
        m[g] = scr[TK * GM + GM + g];
        d[g] = d[g] * alpha + scr[TK * GM + 2 * GM + g];
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int n = s * KPW + kg;
        float vv[VE], w[GM];
        float vsc = 1.f;
        if (hot) {
          load8_f32<T>(st + TT::HV_OFF + (s * 32 + lane) * HB, vv);
        } else {
          load8_f32<int8_t>(st + TT::CV_OFF + (s * 32 + lane) * 8, vv);
          vsc = *reinterpret_cast<const float*>(st + TT::VS_OFF +
                                                (s * 32 + lane) * 4);
        }
        if constexpr (GM % 4 == 0) {
#pragma unroll
          for (int g = 0; g < GM; g += 4)
            *reinterpret_cast<float4*>(w + g) =
                *reinterpret_cast<const float4*>(scr + n * GM + g);
        } else {
#pragma unroll
          for (int g = 0; g < GM; ++g) w[g] = scr[n * GM + g];
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float wv = w[g] * vsc;
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[g][e] += wv * vv[e];
        }
      }
      return;
    }
    float sc[STEPS][GM], vsc[STEPS];
    bool ok[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      float kv[VE], ksc = 1.f;
      vsc[s] = 1.f;
      if (hot) {
        ok[s] = hot_ok(t * TK + s * KPW + kg);
        load8_f32<T>(st + (s * 32 + lane) * HB, kv);
      } else {
        ok[s] = cold_ok(j, phys, c0 + s * KPW + kg);
        load8_f32<int8_t>(st + (s * 32 + lane) * 8, kv);
        ksc = *reinterpret_cast<const float*>(st + TT::KS_OFF +
                                              (s * 32 + lane) * 4);
        vsc[s] = *reinterpret_cast<const float*>(st + TT::VS_OFF +
                                                 (s * 32 + lane) * 4);
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < VE; ++e) p += qf[g][e] * kv[e];
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        sc[s][g] = ok[s] ? p * ksc : NEG_INF;
      }
    }
    softmax_step<STEPS, GM, VE, LPK>(sc, ok, m, d, acc);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      float vv[VE];
      if (hot)
        load8_f32<T>(st + TT::HV_OFF + (s * 32 + lane) * HB, vv);
      else
        load8_f32<int8_t>(st + TT::CV_OFF + (s * 32 + lane) * 8, vv);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float w = sc[s][g] * vsc[s];
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[g][e] += w * vv[e];
      }
    }
  };
  // this warp's tiles of the list range [lo, hi): every FL_WARPS-th from
  // lo + warp, through the warp's ring, FL_STAGES - 1 tiles in flight
  auto run = [&](int lo, int hi) {
    const int nt =
        lo + warp < hi ? (hi - lo - warp + FL_WARPS - 1) / FL_WARPS : 0;
#pragma unroll
    for (int i = 0; i < FL_STAGES - 1; ++i) {
      if (i < nt) issue(lo + warp + i * FL_WARPS, i);
      cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
      __syncwarp();  // the stage refilled here was read in iteration i - 1
      if (i + FL_STAGES - 1 < nt)
        issue(lo + warp + (i + FL_STAGES - 1) * FL_WARPS, i + FL_STAGES - 1);
      cp_async_commit();
      cp_async_wait<FL_STAGES - 1>();  // tile i has landed
      consume(lo + warp + i * FL_WARPS, i);
    }
    cp_async_wait<0>();
    __syncwarp();
  };

  // dense (tau = 0): one run, the cluster's ranks taking contiguous runs
  // of the list. Sparse (split 1): the hot ring, then the live pages in
  // logical order, each read or skipped by the SLIM test on the
  // block-wide running max. One loop, so the tile loop is built once.
  const int n = n_hot + n_cold;
  const int per = (n + n_split - 1) / n_split;
  const int jb = min(n, rank * per), je = min(n, jb + per);
  __shared__ float wm_s[FL_WARPS][GM], red[32];
  float ql1[GM];  // ||q_g||_1 · scale · log2(e), for the sparse test
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) s += fabsf(qf[g][e]);
#pragma unroll
    for (int o = 1; o < LPK; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    ql1[g] = s;
  }
  for (int j = -1;; ++j) {  // j: the cold page (sparse), -1 the hot ring
    int lo = jb, hi = je;
    if (a.sparse && j < 0) {
      hi = n_hot;
    } else if (a.sparse) {
      if (j >= n_pages || j * block_k > last) break;
      const int phys = tab_s[j];
      if (phys < 0) continue;  // a dead page
      // the page's largest attendable k-scale
      float mk = 0.f;
      for (int i = tid; i < block_k; i += FL_NT) {
        const long long row = (long long)phys * block_k + i;
        if (j * block_k + i <= last && row < max_len)
          mk = fmaxf(mk, ksb[row * a.Hkv]);
      }
      if (lane == 0)
#pragma unroll
        for (int g = 0; g < GM; ++g) wm_s[warp][g] = m[g];
      mk = block_max(mk, red);  // its barriers publish wm_s
      bool live = false;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mb = wm_s[0][g];
#pragma unroll
        for (int w = 1; w < FL_WARPS; ++w) mb = fmaxf(mb, wm_s[w][g]);
        // 127: the int8 codec's largest level, so 127 · k-scale · ||q||_1
        // bounds every score of the page
        live |= g < G && 127.f * mk * ql1[g] >= mb + a.log_tau2;
      }
      __syncthreads();  // wm_s is rewritten at the next page
      if (!live) continue;
      lo = n_hot + j * tpp;
      hi = min(n, lo + tpp);
    }
    run(lo, hi);
    if (!a.sparse) break;
  }
  merge_partials<T, HD, GM, LPK, 1, VE, STAGE>(
      m, d, acc, td_smem, G,
      static_cast<T*>(a.out) + ((long long)b * a.Hkv + h) * G * HD);
}

// launch the instance, or with ``occupancy`` set only write the blocks of
// it an SM holds (registers, static and dynamic shared memory)
template <typename T, int HD, int GM>
static int launch_tiered(const TieredArgs& a, int B, int split,
                         cudaStream_t st, int* occupancy) {
  static int granted = 48 * 1024;  // dynamic shared memory opted in so far
  const auto kern = paged_decode_tiered_kernel<T, HD, GM>;
  const int smem = td_smem_bytes(a.n_pages, sizeof(T), HD, GM);
  if (occupancy) {
    cudaError_t e = cudaSuccess;
    if (smem > granted) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e == cudaSuccess) granted = smem;
    }
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kern, FL_NT,
                                                        smem);
    return static_cast<int>(e);
  }
  return launch_cluster(kern, granted, a, a.Hkv, B, split, smem, st);
}

template <typename T, int HD>
static int tiered_g(const TieredArgs& a, int B, int split, cudaStream_t st,
                    int* occ) {
  if (a.G <= 1) return launch_tiered<T, HD, 1>(a, B, split, st, occ);
  if (a.G <= 2) return launch_tiered<T, HD, 2>(a, B, split, st, occ);
  if (a.G <= 4) return launch_tiered<T, HD, 4>(a, B, split, st, occ);
  if (a.G <= 8) return launch_tiered<T, HD, 8>(a, B, split, st, occ);
  if constexpr (max_group(HD) == MAXG)
    return launch_tiered<T, HD, MAXG>(a, B, split, st, occ);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int tiered(int D, const TieredArgs& a, int B, int split,
                  cudaStream_t st, int* occ = nullptr) {
  switch (D) {
    case 16: return tiered_g<T, 16>(a, B, split, st, occ);
    case 32: return tiered_g<T, 32>(a, B, split, st, occ);
    case 64: return tiered_g<T, 64>(a, B, split, st, occ);
    case 128: return tiered_g<T, 128>(a, B, split, st, occ);
    case 160: return tiered_g<T, 160>(a, B, split, st, occ);
    case 256: return tiered_g<T, 256>(a, B, split, st, occ);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (B,Hkv,G,D); hot (B,W,Hkv,D); cold int8 (B,max_len,Hkv,D) + f32
// scales (B,max_len,Hkv,1), K/V rows 16-byte aligned; lengths (B,) int32;
// table (B,n_pages) int32. Each (slot, kv head)'s live key tiles are split
// over a cluster of ``split`` blocks (`paged_decode.tiered_split`); with
// use_tau (the sparse read) split must be 1.
extern "C" int paged_decode_tiered(
    const void* q, const void* hk, const void* hv, const void* ckq,
    const void* cks, const void* cvq, const void* cvs, const void* lengths,
    const void* table, void* out, int B, int Hkv, int G, int D, int W,
    int max_len, int n_pages, int block_k, float scale, float log_tau,
    int use_tau, int dtype, int split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > max_group(D) || split < 1 || split > FL_MAX_SPLIT ||
      block_k < 1 || (use_tau && split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * Hkv == 0) return static_cast<int>(cudaGetLastError());
  constexpr float LOG2E = 1.4426950408889634f;
  const TieredArgs a = {q, hk, hv, static_cast<const int8_t*>(ckq),
                        static_cast<const int8_t*>(cvq),
                        static_cast<const float*>(cks),
                        static_cast<const float*>(cvs),
                        static_cast<const int*>(lengths),
                        static_cast<const int*>(table), out, Hkv, G, W,
                        max_len, n_pages, block_k, scale * LOG2E,
                        log_tau * LOG2E, use_tau};
  const int bad = dtype == DT_F32
                      ? tiered<float>(D, a, B, split, st)
                      : tiered<__nv_bfloat16>(D, a, B, split, st);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

// the tiered kernel's dynamic shared memory at ``n_pages`` table entries,
// head dim D and G query rows, for the Python mirror
// (`paged_decode.tiered_smem_bytes`)
extern "C" int paged_decode_tiered_smem_bytes(int n_pages, int dtype, int D,
                                              int G) {
  const int gm = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : G <= 8 ? 8 : MAXG;
  return td_smem_bytes(n_pages, dtype == DT_F32 ? 4 : 2, D, gm);
}

// blocks of the tiered kernel's instance an SM holds at ``n_pages`` table
// entries, or minus the CUDA error
extern "C" int paged_decode_tiered_blocks_per_sm(int n_pages, int dtype, int D,
                                                 int G) {
  if (G < 1 || G > max_group(D))
    return -static_cast<int>(cudaErrorInvalidValue);
  TieredArgs a = {};
  a.G = G;
  a.n_pages = n_pages;
  int n = 0;
  const int bad = dtype == DT_F32
                      ? tiered<float>(D, a, 0, 1, nullptr, &n)
                      : tiered<__nv_bfloat16>(D, a, 0, 1, nullptr, &n);
  return bad ? -bad : n;
}
