// attn_stream: flash-style GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/attn_stream.py::attn_stream
// (_attn_kernel). Online softmax over key tiles with f32 running
// (max, denominator, accumulator); causal with q_offset = L - S; the
// ragged tail and the upper triangle are masked with NEG_INF = -2**20.
// The TPU's sequential key-block grid axis becomes a loop inside the
// block (Hopper blocks run in no order and carry nothing between them);
// the KV head of head h is h / G; key tiles wholly above the causal
// diagonal of the query tile are never loaded.
//
// Bound on the H100: at the serving prefill shapes (S = L = 256-320, Dh
// 128, causal) the work is ~0.2-0.3 GFLOP over ~2 MB, so operations bound
// it on paper (0.3-0.7 µs either way) and latency in practice: 60 to 100
// query tiles of 64 rows, a few key tiles each.
//
// bf16: a Flash-style tensor-core kernel (`attn_wgmma_kernel`). One
// warpgroup (128 threads) per 64-query tile of one (b, h):
//   * Q, K and V tiles land in shared memory by cp.async in the 128-byte
//     swizzled layout of wgmma.cuh (64/32-byte swizzle at Dh 32/16; at Dh
//     160 two 128B panels and one 64B panel); K/V
//     tiles of 64 keys sit in a ring of 2 stages, so tile j + 1 loads
//     while tile j is multiplied (a 3-stage ring that also issued tile
//     j + 1's S before tile j's softmax measured slower on the H100);
//   * S = Q.K^T by wgmma (m64n64k16, both operands from shared memory) into
//     f32 registers; the mask, the running max and denominator and the
//     rescale of the f32 output accumulator stay in registers (exp2 on
//     log2e-scaled scores);
//   * P is rounded to bf16 and multiplied into the output by wgmma with A
//     from registers (the S accumulator fragment is P's A fragment) and V
//     as an MN-major shared operand: one m64nDhk16 at Dh <= 128; at Dh
//     160 an n128 over the two whole panels and an n32 over the 64B one,
//     at Dh 256 two n128s. At Dh 256 the f32 output accumulator is 128
//     registers a thread (S and P add 48): one warpgroup still fits
//     under the 255-register cap, and the 161 KB of Q and the 2-stage
//     ring leave one block an SM (Dh 160: 101 KB, two). The rounding of
//     P is the one place the bf16 kernel differs from the f32 math of the
//     twin beyond bf16 I/O;
//     chip_smoke holds it to the bf16 tolerance (2e-2 on outputs < 2);
//   * query tiles run heaviest first (the last causal tile has the most
//     keys). At 60-80 query tiles the card is under-filled and the
//     longest causal tile sets the time, so the wrapper may split each
//     tile's key tiles over a cluster of up to 3 blocks (`kv_split`);
//     the blocks' (max, denominator, accumulator) states are merged in
//     rank order by rank 0 through distributed shared memory.
// f32: wgmma has no f32 mode that holds the port's f32 parity (1e-4 with
// TF32 off), so f32 keeps the CUDA-core kernel below (`attn_fma_kernel`:
// 32-query tiles, 4 threads per row (8 above Dh 128, so a thread holds at
// most 32 features of q and of the accumulator), f32 FMAs, 32-key tiles
// (16 at Dh 256, within 48 KB of static shared memory) staged as f32 in
// shared memory). The wrapper picks the kernel by dtype, and both count
// as attn_stream launches.
//
// Tensors are addressed through strides (last dim contiguous), so the
// model-layout (B, S, H, D) activations and a slice of the (B, max_len,
// Hkv, D) extend workspace are read in place, without transposed copies;
// the bf16 kernel also needs 16-byte aligned rows (the wrapper checks).
#include <cooperative_groups.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

// ---- f32: CUDA-core kernel -------------------------------------------------
constexpr int BQ = 32;   // query rows per block

// threads per query row, keys per shared-memory tile and threads of the
// f32 kernel at head dim HD
template <int HD>
struct FmaShape {
  static constexpr int TPR = HD > 128 ? 8 : 4;
  static constexpr int BK = HD > 160 ? 16 : 32;
  static constexpr int NT = BQ * TPR;
  static_assert(HD % TPR == 0 && 2 * BK * HD * 4 <= 48 * 1024, "head dim");
};

template <typename T, int HD>
__global__ void __launch_bounds__(FmaShape<HD>::NT)
    attn_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int H,
                    int Hkv, int S, int L, long long qsb, long long qsh,
                    long long qss, long long ksb, long long ksh,
                    long long ksl, long long vsb, long long vsh,
                    long long vsl, long long osb, long long osh,
                    long long oss, int causal, int q_offset, float scale) {
  constexpr int TPR = FmaShape<HD>::TPR, BK = FmaShape<HD>::BK;
  constexpr int NT = FmaShape<HD>::NT;
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
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
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

// ---- bf16: tensor-core kernel ----------------------------------------------
constexpr int WG_BQ = 64;      // query rows per block (one wgmma M)
constexpr int WG_BK = 64;      // keys per K/V tile
constexpr int WG_STAGES = 2;   // K/V tiles in flight
constexpr int WG_NT = 128;     // one warpgroup
constexpr int WG_MAX_SPLIT = 3;  // blocks (a cluster) sharing one query tile

// dynamic shared memory of the bf16 kernel at head dim ``hd``: the Q tile,
// the K/V ring, and 1 KB to align the tiles to 1024 bytes
__host__ __device__ constexpr int wg_smem_bytes(int hd) {
  return tile_bytes(WG_BQ, hd) + 2 * WG_STAGES * tile_bytes(WG_BK, hd) + 1024;
}

struct AttnArgs {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  int H, Hkv, S, L, causal, q_offset;
  float scale_log2;  // softmax scale * log2(e)
  long long qsb, qsh, qss, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, oss;
};

template <int HD>
__global__ void __launch_bounds__(WG_NT) attn_wgmma_kernel(AttnArgs a) {
  constexpr int QB = tile_bytes(WG_BQ, HD), KB = tile_bytes(WG_BK, HD);
  constexpr int NO = HD / 2;  // output accumulators a thread
  constexpr int NS = WG_BK / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + QB;                  // stage st: + st * KB
  const uint32_t v_s = k_s + WG_STAGES * KB;

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tile first
  const int q0 = qt * WG_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_end = a.causal ? min(a.L, q0 + WG_BQ + a.q_offset) : a.L;
  const int n_kt = (kv_end + WG_BK - 1) / WG_BK;
  // the query tile's key tiles are split over the gridDim.z blocks of a
  // cluster: this block takes tiles [jb, je)
  const int n_split = gridDim.z, rank = blockIdx.z;
  const int per = (n_kt + n_split - 1) / n_split;
  const int jb = min(n_kt, rank * per), je = min(n_kt, jb + per);

  const __nv_bfloat16* kb = a.k + b * a.ksb + hk * a.ksh;
  const __nv_bfloat16* vb = a.v + b * a.vsb + hk * a.vsh;
  auto load_kv = [&](int j) {
    const int st = (j - jb) % WG_STAGES, k0 = j * WG_BK;
    load_tile<WG_BK, HD>(k_s + st * KB, kb + k0 * a.ksl, a.ksl, a.L - k0, HD,
                         tid, WG_NT);
    load_tile<WG_BK, HD>(v_s + st * KB, vb + k0 * a.vsl, a.vsl, a.L - k0, HD,
                         tid, WG_NT);
  };
  if (jb < je) {
    load_tile<WG_BQ, HD>(q_s, a.q + b * a.qsb + h * a.qsh + q0 * a.qss,
                         a.qss, a.S - q0, HD, tid, WG_NT);
    load_kv(jb);
  }
  cp_async_commit();
  if (jb + 1 < je) load_kv(jb + 1);
  cp_async_commit();

  // this thread's rows of the tile: r0 and r0 + 8
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int qpos0 = q0 + r0 + a.q_offset, qpos1 = qpos0 + 8;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int j = jb; j < je; ++j) {
    cp_async_wait<1>();  // tile j (and Q) landed; tile j + 1 may fly
    fence_proxy_async();
    __syncthreads();
    const int st = (j - jb) % WG_STAGES;
    const uint32_t kt = k_s + st * KB, vt = v_s + st * KB;

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;  // overwritten: scale_d = 0
    wgmma_hold<NS>(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      Wgmma<WG_BK>::template ss<0>(s, desc_k<WG_BQ, HD>(q_s, ks),
                                   desc_k<WG_BK, HD>(kt, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold<NS>(s);

    // mask, scale into the log2 domain, running max
    const int k0 = j * WG_BK;
    float mt0 = NEG_INF, mt1 = NEG_INF;
#pragma unroll
    for (int c = 0; c < WG_BK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * c + c0 + e;
        const bool live = kj < a.L;
        const bool ok0 = live && (!a.causal || kj <= qpos0);
        const bool ok1 = live && (!a.causal || kj <= qpos1);
        float& s0 = s[4 * c + e];
        float& s1 = s[4 * c + 2 + e];
        s0 = ok0 ? s0 * a.scale_log2 : NEG_INF;
        s1 = ok1 ? s1 * a.scale_log2 : NEG_INF;
        mt0 = fmaxf(mt0, s0);
        mt1 = fmaxf(mt1, s1);
      }
    }
    // the four lanes of a quad hold the same two rows
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, sh));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, sh));
    }
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int c = 0; c < WG_BK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * c + e] = exp2f(s[4 * c + e] - mn0);
        s[4 * c + 2 + e] = exp2f(s[4 * c + 2 + e] - mn1);
        ps0 += s[4 * c + e];
        ps1 += s[4 * c + 2 + e];
      }
    }
    l0 = l0 * al0 + ps0;  // per-thread partial sums; the quad adds up last
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      o[4 * c] *= al0;
      o[4 * c + 1] *= al0;
      o[4 * c + 2] *= al1;
      o[4 * c + 3] *= al1;
    }
    // P (bf16) as the register A operand, 16 keys a k-step
    uint32_t p[WG_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    wgmma_hold<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      if constexpr (HD <= 128) {
        Wgmma<HD>::template rs<1>(o, p[kk], desc_mn<WG_BK, HD>(vt, kk), 1);
      } else {  // columns 0..127 (two 128B panels), then the rest
        Wgmma<128>::template rs<1>(o, p[kk], desc_mn_at<WG_BK, HD>(vt, kk, 0),
                                   1);
        Wgmma<HD - 128>::template rs<1>(o + 64, p[kk],
                                        desc_mn_at<WG_BK, HD>(vt, kk, 2), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold<NO>(o);

    __syncthreads();  // every thread is done with stage st
    if (j + WG_STAGES < je) load_kv(j + WG_STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (n_split > 1) {
    // merge the cluster's partial softmax states into rank 0, in rank
    // order: each thread's (m, l, o) fragment goes to the same thread of
    // rank 0, stored register-major (conflict-free) over the freed tiles
    cg::cluster_group cl = cg::this_cluster();
    float* part = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
    __syncthreads();
    if (rank > 0) {
#pragma unroll
      for (int i = 0; i < NO; ++i) part[i * WG_NT + tid] = o[i];
      part[NO * WG_NT + tid] = m0;
      part[(NO + 1) * WG_NT + tid] = m1;
      part[(NO + 2) * WG_NT + tid] = l0;
      part[(NO + 3) * WG_NT + tid] = l1;
    }
    cl.sync();
    if (rank == 0) {
      for (int r = 1; r < n_split; ++r) {
        const float* rp = cl.map_shared_rank(part, r);
        const float mb0 = rp[NO * WG_NT + tid], mb1 = rp[(NO + 1) * WG_NT + tid];
        const float mx0 = fmaxf(m0, mb0), mx1 = fmaxf(m1, mb1);
        const float sa0 = exp2f(m0 - mx0), sb0 = exp2f(mb0 - mx0);
        const float sa1 = exp2f(m1 - mx1), sb1 = exp2f(mb1 - mx1);
        l0 = l0 * sa0 + rp[(NO + 2) * WG_NT + tid] * sb0;
        l1 = l1 * sa1 + rp[(NO + 3) * WG_NT + tid] * sb1;
        m0 = mx0;
        m1 = mx1;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          o[4 * c] = o[4 * c] * sa0 + rp[(4 * c) * WG_NT + tid] * sb0;
          o[4 * c + 1] = o[4 * c + 1] * sa0 + rp[(4 * c + 1) * WG_NT + tid] * sb0;
          o[4 * c + 2] = o[4 * c + 2] * sa1 + rp[(4 * c + 2) * WG_NT + tid] * sb1;
          o[4 * c + 3] = o[4 * c + 3] * sa1 + rp[(4 * c + 3) * WG_NT + tid] * sb1;
        }
      }
    }
    cl.sync();  // rank 0 has read every partial
    if (rank > 0) return;
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = a.o + b * a.osb + h * a.osh;
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int col = 8 * c + c0;
    if (qi0 < a.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + qi0 * a.oss + col) =
          __floats2bfloat162_rn(o[4 * c] * inv0, o[4 * c + 1] * inv0);
    if (qi1 < a.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + qi1 * a.oss + col) =
          __floats2bfloat162_rn(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
  }
}

// ---- launch -------------------------------------------------------------------
template <int HD>
static int launch_fma(const AttnArgs& a, const float* q, const float* k,
                      const float* v, float* o, int B, float scale,
                      cudaStream_t st) {
  dim3 grid((a.S + BQ - 1) / BQ, B * a.H);
  attn_fma_kernel<float, HD><<<grid, FmaShape<HD>::NT, 0, st>>>(
      q, k, v, o, a.H, a.Hkv, a.S, a.L, a.qsb, a.qsh, a.qss, a.ksb, a.ksh,
      a.ksl, a.vsb, a.vsh, a.vsl, a.osb, a.osh, a.oss, a.causal, a.q_offset,
      scale);
  return 0;
}

template <int HD>
static int launch_wgmma(const AttnArgs& a, int B, int kv_split,
                        cudaStream_t st) {
  constexpr int smem = wg_smem_bytes(HD);
  if (kv_split < 1 || kv_split > WG_MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      attn_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.S + WG_BQ - 1) / WG_BQ, B * a.H, kv_split);
  cfg.blockDim = dim3(WG_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = kv_split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, attn_wgmma_kernel<HD>, a));
}

template <int HD>
static int launch_hd(const AttnArgs& a, const void* q, const void* k,
                     const void* v, void* o, int B, float scale, int dtype,
                     int kv_split, cudaStream_t st) {
  if (dtype == DT_F32)
    return launch_fma<HD>(a, static_cast<const float*>(q),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v),
                          static_cast<float*>(o), B, scale, st);
  return launch_wgmma<HD>(a, B, kv_split, st);
}

// Strides in elements: q b,h,s | k b,h,l | v b,h,l | o b,h,s. dtype 0 (f32)
// runs the CUDA-core kernel, 1 (bf16) the tensor-core kernel with each
// query tile's key tiles split over ``kv_split`` blocks (`kv_split`).
extern "C" int attn_stream(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int Hkv, int S, int L, int D,
                           long long qsb, long long qsh, long long qss,
                           long long ksb, long long ksh, long long ksl,
                           long long vsb, long long vsh, long long vsl,
                           long long osb, long long osh, long long oss,
                           int causal, float scale, int dtype, int kv_split,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const AttnArgs a{static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v),
                   static_cast<__nv_bfloat16*>(o),
                   H, Hkv, S, L, causal, L - S,
                   scale * 1.4426950408889634f,
                   qsb, qsh, qss, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, oss};
  int bad;
  switch (D) {
    case 16: bad = launch_hd<16>(a, q, k, v, o, B, scale, dtype, kv_split, st); break;
    case 32: bad = launch_hd<32>(a, q, k, v, o, B, scale, dtype, kv_split, st); break;
    case 64: bad = launch_hd<64>(a, q, k, v, o, B, scale, dtype, kv_split, st); break;
    case 128: bad = launch_hd<128>(a, q, k, v, o, B, scale, dtype, kv_split, st); break;
    case 160: bad = launch_hd<160>(a, q, k, v, o, B, scale, dtype, kv_split, st); break;
    case 256: bad = launch_hd<256>(a, q, k, v, o, B, scale, dtype, kv_split, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) {
    cudaGetLastError();  // clear it: the next call must not report it again
    return bad;
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel's dynamic shared memory at head dim ``hd`` (0 for a head
// dim it does not take), for the Python mirror's check.
extern "C" int attn_stream_smem_bytes(int hd) {
  switch (hd) {
    case 16: case 32: case 64: case 128: case 160: case 256:
      return wg_smem_bytes(hd);
  }
  return 0;
}
