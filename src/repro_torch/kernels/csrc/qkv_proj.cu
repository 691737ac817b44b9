// qkv_proj: the fused Q/K/V projection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/qkv_proj.py::qkv_proj (_qkv_kernel):
// [q | k | v] = x·[Wq | Wk | Wv] + [bq | bk | bv], f32 accumulation, the
// bias added in f32, one rounding to the output type. The TPU kernel takes
// the three weights concatenated; here they are three operands read in
// place (concatenating them would copy every projection weight on every
// call), and each block picks its operand by its output column tile.
// Outputs go straight into three contiguous (M, N_i) tensors, which are the
// model's (B, S, H, Dh) layouts; RoPE stays in the model.
//
// Bound on the H100: bytes at every serving shape. The weights are read
// once: 39.3 MB a layer for mobilevlm-3b in bf16 (11.7 µs at 3.35 TB/s),
// 6.3 MB for fastvlm-1.7b (1.9 µs). At prefill (M = 256-320) the product is
// 2-10 GFLOP, 2-10 µs at the bf16 tensor-core peak, still at or under the
// weight bytes.
// Design:
//   * M <= 4 (decode, f32 and bf16): a GEMV split over N and over D.
//     A block owns 128 bytes of columns (64 bf16 / 32 f32) of one operand
//     over a chunk of D; its 256 threads are 32 row groups of 8, so each
//     warp reads 4 whole 128-byte row segments with 16-byte loads, and a
//     thread keeps two batches of 8 independent loads going, one in
//     flight while the other is multiplied (the first issued before x is
//     staged). The wrapper's planner (`qkv_proj.gemv_split`) picks the
//     fewest D chunks that give every SM a block, within one wave of two
//     blocks an SM; the blocks of one column tile
//     form a thread-block cluster, and the partial sums over D are added
//     in rank order through distributed shared memory -- deterministic,
//     with no float atomics, no workspace and no second kernel.
//   * M > 4, bf16 (prefill): wgmma tiles of 64 or 128 rows (one or two
//     warpgroups, `qkv_proj.gemm_warpgroups`) by 128 columns, over a
//     cp.async ring of 64-deep x and W tiles in the swizzled layout of
//     wgmma.cuh (x K-major, W MN-major, both read in place), as deep as a
//     block's shared memory allows (8 or 7 stages): at these grids the
//     loads are latency-bound, so they run 5-6 tiles ahead of the
//     products, and one group of products stays in flight while the next
//     is issued. (64-column tiles, for more blocks at fastvlm-1.7b's
//     prefill, measured slower.) The bias is added in f32 in the epilogue, with one
//     rounding to bf16. Row tiles run fastest in the grid, so the blocks
//     that share a weight tile run together and reread it from L2.
//   * M > 4, f32, M >= the wrapper's threshold (`qkv_proj.TF32X3_MIN_M`;
//     the training path's M 2048 and the f32 parity prefills): "tf32x3",
//     a 3xTF32 tensor-core GEMM (tf32x3.cuh: each f32 operand split into
//     TF32 hi + lo, three TF32 wgmma products a k-step, error <=
//     3·2^-22 sum_k |x_k w_k| beyond f32 accumulation's). wgmma takes
//     .tf32 only K-major, so one split launch first writes x's hi / lo
//     planes as stored and the three weights' transposed, stacked
//     (N_q + N_k + N_v, D), into the wrapper's workspace; then 128 x 128
//     output tiles over a 7-stage cp.async ring of 16-deep tiles, the
//     bias added in f32 in the epilogue. Bound: 3 TF32 products at 495
//     TFLOP/s (78 µs at fastvlm-1.7b's training M 2048), or the bytes.
//   * M > 4, f32, fewer rows or rows not 16-byte aligned: "fma", the
//     CUDA-core GEMM: 64 x 64 output tiles over 16-deep shared-memory
//     tiles, 4 x 4 outputs a thread, f32 FMAs (scalar loads: any
//     alignment).
// Ragged M and N are masked. The GEMV and the tensor-core forms need N_i
// * sizeof(T) % 16 == 0, D * sizeof(T) % 16 == 0 and 16-byte aligned
// operands for the vector and cp.async loads (the wrapper checks).
#include <cooperative_groups.h>

#include "common.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

struct QkvArgs {
  const void* x;
  const void* w[3];  // (D, n[i]) row-major
  const void* b[3];  // (n[i],) or null
  void* o[3];        // (M, n[i]) row-major
  int n[3];
  int M, D;
};

// The operand whose column tiles of width ``bn`` hold block column ``bx``
// (``bx`` becomes the tile index within it), with its fields picked by
// selects: indexing the by-value arguments at run time would copy them to
// local memory.
struct Operand {
  const void* w;
  const void* b;
  void* o;
  int n;
};
__device__ __forceinline__ Operand pick_operand(const QkvArgs& a, int bn,
                                                int& bx) {
  const int t0 = (a.n[0] + bn - 1) / bn, t1 = (a.n[1] + bn - 1) / bn;
  if (bx < t0) return {a.w[0], a.b[0], a.o[0], a.n[0]};
  bx -= t0;
  if (bx < t1) return {a.w[1], a.b[1], a.o[1], a.n[1]};
  bx -= t1;
  return {a.w[2], a.b[2], a.o[2], a.n[2]};
}

// ---- decode: split-N, split-D GEMV -----------------------------------------
constexpr int GV_NT = 256;
constexpr int GV_MIN_BLOCKS = 2;      // blocks an SM holds (registers)
constexpr int GV_MMAX = 4;            // rows
constexpr int GV_ROWS = GV_NT / 8;    // row groups of 8 threads (128 bytes)
constexpr int GV_UNROLL = 8;          // weight rows in flight a thread
constexpr int GV_MAX_SPLIT = 8;       // portable cluster size

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& v, float* f) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = to_f32(e[i]);
}

template <typename T>
__global__ void __launch_bounds__(GV_NT, GV_MIN_BLOCKS)
    qkv_gemv_kernel(QkvArgs a, int d_chunk) {
  constexpr int VK = 16 / sizeof(T);  // columns a 16-byte load
  constexpr int CW = 8 * VK;          // columns a block: 128 bytes a row
  extern __shared__ float xs[];       // M x this block's D chunk
  __shared__ float red[GV_NT / 32][GV_MMAX * CW];
  __shared__ float part[GV_MMAX * CW];
  cg::cluster_group cl = cg::this_cluster();
  int bx = blockIdx.x;
  const Operand op = pick_operand(a, CW, bx);
  const int N = op.n, col0 = bx * CW, M = a.M, tid = threadIdx.x;
  const int d0 = blockIdx.y * d_chunk, dn = min(d_chunk, a.D - d0);
  const int cc = tid % 8, rg = tid / 8, c = col0 + cc * VK;
  const bool live = c < N;  // N % VK == 0: the whole vector is in the row
  const T* w = static_cast<const T*>(op.w) + (long long)d0 * N + c;

  // two register batches of GV_UNROLL rows: one is in flight while the
  // other is multiplied, so loads never wait on the FMAs
  uint4 wa[GV_UNROLL], wb[GV_UNROLL];
  auto load_rows = [&](uint4* wv, int d) {
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      const int dd = d + u * GV_ROWS;
      wv[u] = live && dd < dn ? __ldg(reinterpret_cast<const uint4*>(
                                    w + (long long)dd * N))
                              : make_uint4(0, 0, 0, 0);
    }
  };
  load_rows(wa, rg);  // the first weight rows fly while x is staged
  const T* x = static_cast<const T*>(a.x) + d0;
  const int xv = dn / VK;  // 16-byte vectors of x a row (D % VK == 0)
  for (int i = tid; i < M * xv; i += GV_NT) {
    const int m = i / xv, j = (i % xv) * VK;
    load16_f32(x + (long long)m * a.D + j, xs + m * dn + j);
  }
  __syncthreads();

  float acc[GV_MMAX][VK];
#pragma unroll
  for (int m = 0; m < GV_MMAX; ++m)
#pragma unroll
    for (int e = 0; e < VK; ++e) acc[m][e] = 0.f;
  auto fma_rows = [&](const uint4* wv, int d) {
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      const int dd = d + u * GV_ROWS;
      if (dd >= dn) break;
      float wf[VK];
      unpack16<T>(wv[u], wf);
#pragma unroll
      for (int m = 0; m < GV_MMAX; ++m) {
        if (m < M) {
          const float xm = xs[m * dn + dd];
#pragma unroll
          for (int e = 0; e < VK; ++e) acc[m][e] += xm * wf[e];
        }
      }
    }
  };
  constexpr int STEP = GV_ROWS * GV_UNROLL;
  for (int d = rg; d < dn; d += 2 * STEP) {
    load_rows(wb, d + STEP);
    fma_rows(wa, d);
    load_rows(wa, d + 2 * STEP);
    fma_rows(wb, d + STEP);
  }
  // the warp's 4 row groups (lanes cc, cc + 8, cc + 16, cc + 24), then the
  // 8 warps in order: this block's partial over its D chunk
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int m = 0; m < GV_MMAX; ++m)
#pragma unroll
    for (int e = 0; e < VK; ++e) {
      float v = acc[m][e];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 8) red[warp][m * CW + lane * VK + e] = v;
    }
  __syncthreads();
  if (tid < GV_MMAX * CW) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < GV_NT / 32; ++w8) s += red[w8][tid];
    part[tid] = s;
  }
  cl.sync();
  // the cluster is this column tile's D chunks; each block finishes every
  // nr-th output, adding the chunks' partials in rank order (the remote
  // reads are issued together)
  const int nr = cl.num_blocks(), rank = cl.block_rank();
  if (tid < M * CW && tid % nr == rank) {
    const int m = tid / CW, n = col0 + tid % CW;
    if (n < N) {
      float v[GV_MAX_SPLIT];
#pragma unroll
      for (int r = 0; r < GV_MAX_SPLIT; ++r)
        v[r] = r < nr ? cl.map_shared_rank(part, r)[tid] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < GV_MAX_SPLIT; ++r) s += v[r];
      if (op.b) s += to_f32(static_cast<const T*>(op.b)[n]);
      static_cast<T*>(op.o)[(long long)m * N + n] = from_f32<T>(s);
    }
  }
  cl.sync();  // keep ``part`` alive until every block of the cluster read it
}

// ---- prefill, bf16: wgmma GEMM ---------------------------------------------
// A block is WGS warpgroups (64 rows each) over one 128-column tile, with
// a ring as deep as one block's shared memory allows, at most
// TC_MAX_STAGES: the loads run STAGES - 2 tiles ahead.
constexpr int TC_BN = 128, TC_BK = 64, TC_MAX_STAGES = 8;
constexpr int TC_SMEM = 232448 - 1024;  // a block's shared memory, aligned
__host__ __device__ constexpr int tc_stage_bytes(int wgs) {
  return tile_bytes(64 * wgs, TC_BK) + tile_bytes(TC_BK, TC_BN);
}
__host__ __device__ constexpr int tc_stages(int wgs) {
  return TC_SMEM / tc_stage_bytes(wgs) < TC_MAX_STAGES
             ? TC_SMEM / tc_stage_bytes(wgs)
             : TC_MAX_STAGES;
}

// the tensor-core GEMM's dynamic shared memory: the x / W tile ring and
// 1 KB to align the tiles to 1024 bytes
__host__ __device__ constexpr int tc_smem_bytes(int wgs) {
  return tc_stages(wgs) * tc_stage_bytes(wgs) + 1024;
}

template <int WGS>
__global__ void __launch_bounds__(128 * WGS) qkv_wgmma_kernel(QkvArgs a) {
  constexpr int BM = 64 * WGS, NT = 128 * WGS;
  constexpr int TC_STAGES = tc_stages(WGS);
  constexpr int XB = tile_bytes(BM, TC_BK), WB = tile_bytes(TC_BK, TC_BN);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t x_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t w_s = x_s + TC_STAGES * XB;
  int bx = blockIdx.y;
  const Operand op = pick_operand(a, TC_BN, bx);
  const int N = op.n, col0 = bx * TC_BN, row0 = blockIdx.x * BM;
  const int M = a.M, D = a.D, tid = threadIdx.x, wg = tid / 128;
  const __nv_bfloat16* x =
      static_cast<const __nv_bfloat16*>(a.x) + (long long)row0 * D;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(op.w) + col0;
  const int nk = (D + TC_BK - 1) / TC_BK;
  auto load = [&](int kt) {
    const int st = kt % TC_STAGES, k0 = kt * TC_BK;
    load_tile<BM, TC_BK>(x_s + st * XB, x + k0, D, M - row0, D - k0, tid,
                         NT);
    load_tile<TC_BK, TC_BN>(w_s + st * WB, w + (long long)k0 * N, N, D - k0,
                            N - col0, tid, NT);
  };
  // loads STAGES - 2 tiles ahead of the products, and one group of
  // products in flight while the next is issued: stage kt + STAGES - 2
  // reuses the stage of kt - 2, whose products every warp waited for
  // before this barrier
#pragma unroll
  for (int s = 0; s < TC_STAGES - 2; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  float acc[TC_BN / 2];
#pragma unroll
  for (int i = 0; i < TC_BN / 2; ++i) acc[i] = 0.f;
  const uint32_t x_wg = x_s + wg * tile_bytes(64, TC_BK);  // this WG's rows
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TC_STAGES - 3>();  // tile kt landed; later ones fly
    fence_proxy_async();
    __syncthreads();  // ... for every thread
    if (kt + TC_STAGES - 2 < nk) load(kt + TC_STAGES - 2);
    cp_async_commit();
    const int st = kt % TC_STAGES;
    wgmma_hold<TC_BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks)
      Wgmma<TC_BN>::template ss<1>(
          acc, desc_k<BM, TC_BK>(x_wg + st * XB, ks),
          desc_mn<TC_BK, TC_BN>(w_s + st * WB, ks), 1);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_hold<TC_BN / 2>(acc);
  }
  wgmma_wait<0>();
  wgmma_hold<TC_BN / 2>(acc);
  cp_async_wait<0>();

  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(op.b);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(op.o);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r = row0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int c = 0; c < TC_BN / 8; ++c) {
    const int n = col0 + 8 * c + 2 * (lane & 3);
    if (n >= N) continue;  // N % 8 == 0: n + 1 < N too
    const float b0 = bias ? __bfloat162float(bias[n]) : 0.f;
    const float b1 = bias ? __bfloat162float(bias[n + 1]) : 0.f;
    if (r < M)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r * N + n) =
          __floats2bfloat162_rn(acc[4 * c] + b0, acc[4 * c + 1] + b1);
    if (r + 8 < M)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)(r + 8) * N + n) =
          __floats2bfloat162_rn(acc[4 * c + 2] + b0, acc[4 * c + 3] + b1);
  }
}

// ---- prefill, f32: CUDA-core GEMM ------------------------------------------
constexpr int NT = 256;
constexpr int BM = 64, BN = 64, BK = 16;  // GEMM tiles

template <typename T>
__global__ void __launch_bounds__(NT) qkv_fma_kernel(QkvArgs a) {
  __shared__ float xs[BK][BM + 1];  // x tile, transposed; +1: no conflicts
  __shared__ float ws[BK][BN];
  int bx = blockIdx.x;
  const Operand op = pick_operand(a, BN, bx);
  const int N = op.n, col0 = bx * BN, row0 = blockIdx.y * BM;
  const int M = a.M, D = a.D, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // outputs (ty*4.., tx*4..)
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(op.w);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, k = i % BK, m = row0 + r, d = k0 + k;
      xs[k][r] = (m < M && d < D) ? to_f32(x[(long long)m * D + d]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int k = i / BN, cc = i % BN, d = k0 + k, n = col0 + cc;
      ws[k][cc] = (d < D && n < N) ? to_f32(w[(long long)d * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float xr[4], wr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xr[i] = xs[k][ty * 4 + i];
        wr[i] = ws[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xr[i] * wr[j];
    }
    __syncthreads();
  }
  const T* bias = static_cast<const T*>(op.b);
  T* o = static_cast<T*>(op.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = row0 + ty * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx * 4 + j;
      if (n < N)
        o[(long long)m * N + n] =
            from_f32<T>(acc[i][j] + (bias ? to_f32(bias[n]) : 0.f));
    }
  }
}

static int col_tiles(const QkvArgs& a, int bn) {
  int t = 0;
  for (int i = 0; i < 3; ++i) t += (a.n[i] + bn - 1) / bn;
  return t;
}

// ---- prefill, f32: 3xTF32 tensor-core GEMM -------------------------------
// B is the three weights' pair planes stacked as (N_q + N_k + N_v) rows of
// D (tf32x3.cuh); a block's column tile picks its operand
// (`pick_operand` over TF_BN-wide tiles) and reads only that operand's
// rows of the stack. T is float (a template: built where the f32 form is
// dispatched).
template <typename T>
__global__ void __launch_bounds__(TF_NT, 1)
    qkv_tf32_kernel(QkvArgs a, const float* __restrict__ x,
                    const float* __restrict__ w) {
  extern __shared__ uint8_t tc_smem[];
  int bx = blockIdx.y;
  const int t0 = (a.n[0] + TF_BN - 1) / TF_BN;
  const int t1 = (a.n[1] + TF_BN - 1) / TF_BN;
  const int stack0 = bx < t0 ? 0 : bx < t0 + t1 ? a.n[0] : a.n[0] + a.n[1];
  const Operand op = pick_operand(a, TF_BN, bx);
  const int N = op.n, col0 = bx * TF_BN, row0 = blockIdx.x * TF_BM;
  const int M = a.M, D = a.D;
  const long long ld = tf_pair_ld(D);
  const float* wo = w + (stack0 + col0) * ld;
  float acc[TF_BN / 2];
  tf_mainloop(tf_ring(tc_smem), {x + row0 * ld, M - row0}, ld,
              {wo, N - col0}, {wo + 64 * ld, N - col0 - 64}, ld, D, acc);
  const T* bias = static_cast<const T*>(op.b);
  T* o = static_cast<T*>(op.o);
  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r = row0 + 64 * wgi + 16 * warp + (lane >> 2);
#pragma unroll
  for (int c = 0; c < TF_BN / 8; ++c) {
    const int n = col0 + 8 * c + 2 * (lane & 3);
    if (n >= N) continue;  // N % 4 == 0: n + 1 < N too
    const float b0 = bias ? bias[n] : 0.f, b1 = bias ? bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = r + 8 * i;
      if (rr < M)
        *reinterpret_cast<float2*>(o + (long long)rr * N + n) = make_float2(
            acc[4 * c + 2 * i] + b0, acc[4 * c + 2 * i + 1] + b1);
    }
  }
}

// the split, then the GEMM; ``scratch`` holds the pair planes of x (M
// rows of D) and of the stacked weights (N_q + N_k + N_v rows of D):
// (M + N_q + N_k + N_v) tf_pair_ld(D) floats
template <typename T>
static int launch_tf32x3(const QkvArgs& a, void* scratch, cudaStream_t st) {
  if (!scratch || a.D % 4 || a.n[0] % 4 || a.n[1] % 4 || a.n[2] % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ld = tf_pair_ld(a.D);
  float* x = static_cast<float*>(scratch);
  float* w = x + a.M * ld;
  SplitArgs sp = {};
  sp.n = 4;
  long long row = 0;  // the weight's first row in the stack
  for (int i = 0; i < 4; ++i) {
    const bool xm = i == 0;
    sp.src[i] = static_cast<const float*>(xm ? a.x : a.w[i - 1]);
    sp.dst[i] = xm ? x : w + row * ld;
    sp.rows[i] = xm ? a.M : a.D;
    sp.cols[i] = xm ? a.D : a.n[i - 1];
    sp.trans[i] = xm ? 0 : 1;
    if (!xm) row += a.n[i - 1];
  }
  launch_split(sp, st);
  static bool granted = false;
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        qkv_tf32_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TfShape::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = true;
  }
  const dim3 grid((a.M + TF_BM - 1) / TF_BM, col_tiles(a, TF_BN));
  qkv_tf32_kernel<T><<<grid, TF_NT, TfShape::SMEM, st>>>(a, x, w);
  return 0;
}

template <typename T>
static int launch_gemv(const QkvArgs& a, int n_split, int d_chunk,
                       cudaStream_t st) {
  if (n_split < 1 || n_split > GV_MAX_SPLIT ||
      (long long)n_split * d_chunk < a.D || (n_split - 1) * d_chunk >= a.D)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)a.M * d_chunk * sizeof(float);
  // the static partials count against the 48 KB a launch gets unasked
  constexpr size_t fixed = (GV_NT / 32 + 1) * GV_MMAX * (128 / sizeof(T)) *
                           sizeof(float);
  if (smem + fixed > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qkv_gemv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles(a, 128 / sizeof(T)), n_split);
  cfg.blockDim = dim3(GV_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, qkv_gemv_kernel<T>, a, d_chunk));
}

template <int WGS>
static int launch_wgmma(const QkvArgs& a, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes(WGS);
  const cudaError_t e = cudaFuncSetAttribute(
      qkv_wgmma_kernel<WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.M + 64 * WGS - 1) / (64 * WGS), col_tiles(a, TC_BN));
  qkv_wgmma_kernel<WGS><<<grid, 128 * WGS, smem, st>>>(a);
  return 0;
}

static int launch_fma(const QkvArgs& a, cudaStream_t st) {
  const dim3 grid(col_tiles(a, BN), (a.M + BM - 1) / BM);
  qkv_fma_kernel<float><<<grid, NT, 0, st>>>(a);
  return 0;
}

// x (M, D); wq/wk/wv (D, nq/nk/nv); bq/bk/bv (n,) or null; q/k/v out
// (M, n); all f32 (dtype 0) or all bf16 (dtype 1); scratch the tf32x3
// form's workspace (see launch_tf32x3) or null. ``form`` (the
// wrapper's `kernel_variant`): 0 the GEMV (M <= 4; D split into n_split
// chunks of d_chunk rows, `gemv_split`), 1 the bf16 wgmma GEMM with
// ``wgs`` (1 or 2) warpgroups a block (`gemm_warpgroups`), 2 the f32
// CUDA-core GEMM, 3 the f32 3xTF32 GEMM.
enum { FORM_GEMV = 0, FORM_WGMMA = 1, FORM_FMA = 2, FORM_TF32X3 = 3 };
extern "C" int qkv_proj(const void* x, const void* wq, const void* wk,
                        const void* wv, const void* bq, const void* bk,
                        const void* bv, void* q, void* k, void* v,
                        void* scratch, int M, int D, int nq, int nk, int nv,
                        int n_split, int d_chunk, int wgs, int dtype,
                        int form, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const QkvArgs a{x, {wq, wk, wv}, {bq, bk, bv}, {q, k, v}, {nq, nk, nv},
                  M, D};
  const bool f32 = dtype == DT_F32;
  int bad = static_cast<int>(cudaErrorInvalidValue);
  if (form == FORM_GEMV && M <= GV_MMAX)
    bad = f32 ? launch_gemv<float>(a, n_split, d_chunk, st)
              : launch_gemv<__nv_bfloat16>(a, n_split, d_chunk, st);
  else if (form == FORM_FMA && f32)
    bad = launch_fma(a, st);
  else if (form == FORM_TF32X3 && f32)
    bad = launch_tf32x3<float>(a, scratch, st);
  else if (form == FORM_WGMMA && !f32 && (wgs == 1 || wgs == 2))
    bad = wgs == 1 ? launch_wgmma<1>(a, st) : launch_wgmma<2>(a, st);
  if (bad) {
    cudaGetLastError();  // clear it: the next call must not report it again
    return bad;
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of the kernels, for the Python mirror's check: 1 and 2
// the GEMV's static bytes for f32 and bf16 (its dynamic part is M *
// d_chunk floats); 11 and 12 the tensor-core GEMM's dynamic bytes at 1
// and 2 warpgroups a block; 21 the 3xTF32 GEMM's.
extern "C" int qkv_proj_smem_bytes(int which) {
  switch (which) {
    case 1: return (GV_NT / 32 + 1) * GV_MMAX * 32 * (int)sizeof(float);
    case 2: return (GV_NT / 32 + 1) * GV_MMAX * 64 * (int)sizeof(float);
    case 11: return tc_smem_bytes(1);
    case 12: return tc_smem_bytes(2);
    case 21: return TfShape::SMEM;
  }
  return 0;
}
