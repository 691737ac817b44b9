// Fused dense FFN for Hopper (sm_90a), shared by ffn_act.cu (weights in
// the model's type) and ffn_act_int8.cu (int8 weights with per-output-
// column f32 scales).
//
// ffn_act replaces the TPU kernel repro/kernels/ffn_act.py::ffn_act
// (_ffn_kernel); ffn_act_int8 replaces repro/kernels/ffn_act.py::
// ffn_act_int8 (_ffn_q_kernel). Both compute
// out = (act(x·W_up) [* x·W_gate]) · W_down with f32 accumulation; act is
// silu, tanh-GELU or relu². int8 scales are factored out of the sums:
// Σ_d x·(q·s_f) = s_f·Σ_d x·q, so s_up / s_gate are applied once per
// hidden unit after the D sum and s_down once per output column after
// the F sum (no int8 MMA, which would requantize x). The TPU kernel is
// ungated only; the model's int8 path (apply_mlp's int8 branch) also runs
// silu_gated, so this kernel takes an optional int8 W_gate with its scales.
//
// The wrapper (`ffn_act.kernel_variant`) picks one of three forms:
//
// 1. "stream", decode (bf16 x, M <= 8; bf16 and int8 weights). Bound
//    by bytes: the three weight matrices are read once (82.6 MB a layer
//    for fastvlm-1.7b in bf16, 24.7 µs at 3.35 TB/s; 53.1 MB for
//    mobilevlm-3b in int8, 15.9 µs). The TPU kernel's fusion is kept: the
//    (M, F) hidden never leaves the chip. A slice of 128 hidden units is
//    split over D among ``ds`` blocks of a cluster (`ffn_act.stream_plan`);
//    a block streams, through one 3-stage cp.async ring of 12-18 KB
//    stages, first its W_up / W_gate row segments, then its W_down rows,
//    all with 16-byte copies; phase 2's first tiles are in flight while
//    phase 1 finishes. The products are tensor-core mma.sync m16n8k16
//    with the 8 rows of x (zero rows past M) as the n = 8 side (see the
//    section below). A CUDA-core product issues 4 FMAs and a widening for
//    every weight element -- at decode as many instructions as the bytes
//    take to stream: it measured 55-66 µs a launch where the tensor-core
//    kernel takes 38-50 (PERF.md). The slice's phase-1 sums meet in block order
//    through distributed shared memory before the column scales, act and
//    the gate. h enters the second product rounded to 16 bits, as the
//    prefill form rounds it: bf16 for bf16 weights, for int8 weights fp16
//    scaled by a power of two from the block's max |h| (x likewise; bf16
//    x is exact in fp16 down to 2^-17 after that scaling). Rounding h
//    moves an output by at most u * sum_f |h_f w_fd| (u = 2^-9 in bf16,
//    2^-11 in fp16); chip_smoke.py prints that bound beside each stream
//    case's error.
//    The blocks of a cluster (up to 8) add their (M, D) f32 partials in
//    rank order through distributed shared memory; one partial a cluster
//    reaches device memory, and a second kernel adds those in cluster
//    order, applies s_down and casts: deterministic, no atomics.
// 2. "wgmma", prefill (bf16 activations, M > 8; bf16 and int8 weights).
//    Bound by operations (2·M·D·F·(2 or 3) flops: 27 µs at the bf16
//    tensor-core peak for mobilevlm-3b at M = 256). Two tensor-core GEMMs
//    over cp.async rings of swizzled tiles (wgmma.cuh): phase 1 computes
//    x·W_up and x·W_gate for a 64·wgs x 128 tile (x K-major, W MN-major
//    read in place), and its epilogue applies the column scales, act and
//    the gate and writes h (M, F) in bf16 to a workspace; phase 2 computes
//    h·W_down for a 64·wgs x 128 tile, with F split over a cluster of
//    `ks` blocks when the tile grid underfills the card, merged in rank
//    order through distributed shared memory before s_down and the cast.
//    int8 tiles arrive by cp.async into a raw stage and are widened to
//    bf16 into the swizzled tile (exact: |q| <= 127), with a proxy fence
//    before the wgmma that reads them; the widening of tile k + 1
//    overlaps the products of tile k.
//    Why h leaves the chip here, though the TPU kernel keeps it in VMEM:
//    the TPU kernel carries a (block_m, D) f32 accumulator across a
//    sequential F axis; at wgmma's 64-row minimum and D 2560 that is
//    640 KB, against a block's 227 KB of shared memory. Splitting F
//    instead leaves (M, D) f32 partials per F chunk, 20-40x the bytes of
//    h. h is 3.5 MB (mobilevlm-3b, M 256) or 5.7 MB (fastvlm-1.7b, M
//    320) in bf16, so it stays in the 50 MB L2 between the phases. The
//    only new rounding is h in bf16, as attn_stream rounds P for P·V.
// 3. "fma": f32 activations at every M (the f32 parity path: wgmma and
//    mma.sync have no f32 mode that holds 1e-4), and any shape whose rows
//    do not start 16-byte aligned (the other forms copy 16 bytes at a
//    time). Blocks over (16-row tile, F chunk, band of 3072 output
//    columns) with f32 FMAs, the hidden tile in shared memory and one f32
//    partial per F chunk, added in chunk order by the same reduction
//    kernel. A thread holds 12 output columns of 16 rows (192
//    accumulators); a d_model above 3072 (stablelm-12b's 5120) takes a
//    second band of blocks, each recomputing its chunk's hidden tile (an
//    f32 parity path: the bands double phase 1's FMAs, not its bytes in
//    flight).
// Ragged M, D and F are masked (zero rows, columns, hidden units).
#pragma once

#include <cooperative_groups.h>

#include <cuda_fp16.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

enum { ACT_SILU = 0, ACT_GELU = 1, ACT_RELU2 = 2 };
enum { VAR_FMA = 0, VAR_STREAM = 1, VAR_WGMMA = 2 };
// bits of ``vec`` (fma form): rows of W_up / W_gate, and of W_down, start
// 16-byte aligned, so their tiles may load 16 bytes at a time
enum { VEC_UP = 1, VEC_DOWN = 2 };

constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use

__device__ __forceinline__ float activate(float h, int act) {
  if (act == ACT_SILU) return h / (1.f + expf(-h));
  if (act == ACT_GELU)
    return 0.5f * h *
           (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  const float r = fmaxf(h, 0.f);
  return r * r;
}

// an int8 byte of u (already ^ 0x80, byte ``sel``) widened to f32: (q ^
// 0x80) placed in the mantissa of 2^23 by a byte permute is the float
// 2^23 + 128 + q, so one subtraction leaves q
__device__ __forceinline__ float i8_byte(uint32_t u, uint32_t sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
}

// ---- the reduction: out = s2 * sum of the partials, in a fixed order -------
// Eight lanes an output: lane j adds partials j, j + 8, ... in order, then
// the eight sums meet in a fixed shuffle tree, so the order (and the
// result) is the same on every run, and the partials' loads are in flight
// together.
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ s2,
                                  T* __restrict__ out, int n_part, int D,
                                  long long MD) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = t >> 3;
  const int j = threadIdx.x & 7;
  float s = 0.f;
  if (i < MD)
    for (int c = j; c < n_part; c += 8) s += partial[(long long)c * MD + i];
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (i < MD && j == 0) out[i] = from_f32<T>(s2 ? s * s2[i % D] : s);
}

template <typename T>
static void launch_reduce(const float* partial, const float* s2, void* out,
                          int n_part, int M, int D, cudaStream_t st) {
  const long long MD = (long long)M * D;
  ffn_reduce_kernel<T><<<(unsigned)((8 * MD + 255) / 256), 256, 0, st>>>(
      partial, s2, static_cast<T*>(out), n_part, D, MD);
}

// Operands and plan of one call; the scales are null for weights in the
// model's type, wg and sg for an ungated FFN.
struct FfnArgs {
  const void *x, *w1, *wg, *w2;
  const float *s1, *sg, *s2;
  void* scratch;   // f32 partials (stream, fma: (n_part, M, D)) or the
                   // bf16 hidden (wgmma: (M, F))
  void* out;
  int M, D, F, act;
  int p[3];        // the form's plan (see ffn_run)
};

// ===========================================================================
// 1. stream: decode
// ===========================================================================
constexpr int ST_NT = 256;        // threads: 8 warps
constexpr int ST_MAX_SPLIT = 8;   // portable cluster size

// The products are mma.sync m16n8k16 (f32 accumulators) with the 8 rows
// of x (M <= 8, zero rows past M) as the n = 8 side: phase 1 computes h^T
// (SM_FS x 8) = W^T x^T, phase 2 out^T (D x 8) = W_down^T h^T, h rounded
// to 16 bits in shared memory (as the prefill form rounds it). An mma
// takes 256 weight elements in one instruction.
// A slice of SM_FS hidden units is split over D among ``ds`` consecutive
// blocks: block r of a slice reads rows [r dch, +dch) of D of the slice's
// W_up / W_gate columns (256-byte row segments in bf16) and rows
// [r SM_FS / ds, +SM_FS / ds) of its W_down rows. A thread-block cluster
// holds one or more whole slices. The slice's phase-1 sums meet in block
// order through distributed shared memory, each block finishing h for
// its own W_down rows; then the cluster's (M, D) partials meet in rank
// order the same way, one partial a cluster. In phase 1 warp w owns the
// slice's 16-column tile w over every 16-deep step of the block's D
// rows; in phase 2 two 16-column output tiles of each 256-column band.
//  * bf16 weights: bf16 mma; the W tiles are read transposed by ldmatrix
//    from ring rows padded by 16 bytes (no bank conflicts).
//  * int8 weights: fp16 mma; a thread builds its A fragment from the raw
//    int8 rows (padded by 16 bytes) with four 2-byte loads, a byte
//    permute that pairs rows d and d + 1, and a permute into the mantissa
//    of 1024 plus one packed subtraction per two values (exact: |q| <=
//    127), about 2 instructions a weight where an f32 FMA path spends 6.
//    A fragment row g holds slice column 2g and row g + 8 column 2g + 1,
//    so both come from one 2-byte load. x and h enter fp16 scaled by a
//    power of two from their block-wide max (|v| * 2^-k < 2^14), undone
//    on the f32 sums.
constexpr int SM_FS = 128;        // hidden units a slice: a warp's 16 each
constexpr int SM_NST = 3;         // ring stages (deeper measured no faster)
constexpr int SM_STAGE = 18432;   // a bf16 ring stage: 16 KB + row pads
constexpr int SM_QSTAGE = 12288;  // an int8 ring stage: 8 KB + row pads
constexpr int SM_BAND = 256;      // phase 2: output columns a tile
constexpr int SM_KROWS = 32;      // phase 2: W_down rows a tile

// rows of D a block reads: a multiple of 16 (the k-step)
__host__ __device__ constexpr int sm_dch(int D, int ds) {
  return ((D + ds - 1) / ds + 15) / 16 * 16;
}
// shared memory: x (8 rows of the block's dch + 8, 16-bit) / the phase-1
// fragments (8 warps x 32 lanes x 8 f32) / the block's (M x D) f32
// partial, one region over the three; the block's phase-1 sums (2 x SM_FS
// x 8 f32, read by its slice's blocks); the ring; h (8 x (SM_FS / ds +
// 8), 16-bit)
__host__ __device__ constexpr int sm_union_bytes(int M, int D, int ds) {
  return 16 * (sm_dch(D, ds) + 8) > 8192
             ? (16 * (sm_dch(D, ds) + 8) > 4 * M * D
                    ? 16 * (sm_dch(D, ds) + 8)
                    : 4 * M * D)
             : (8192 > 4 * M * D ? 8192 : 4 * M * D);
}
__host__ __device__ constexpr int sm_smem_bytes(int M, int D, int ds,
                                                bool q) {
  return (sm_union_bytes(M, D, ds) + 15) / 16 * 16 + 64 * SM_FS +
         SM_NST * (q ? SM_QSTAGE : SM_STAGE) + 16 * (SM_FS / ds + 8);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16 x 8 f32) += a (16 x 16, row) . b (16 x 8, col), bf16 or fp16 in
template <bool F16>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (F16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two int8 pairs (bytes 0, 2 and 1, 3 of w ^ 0x80808080) -> fp16x2 each
__device__ __forceinline__ uint32_t i8pair_f16(uint32_t w, uint32_t sel) {
  const uint32_t v = __byte_perm(w, 0x64646464u, sel);  // 1024 + (q ^ 0x80)
  uint32_t r;
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(0x64806480u));
  return r;  // q, exact
}
// the int8 A fragment (16 x 16: rows = 8 column pairs of a 16-column
// tile, k = 16 rows of the stage) at ``base`` + ``col`` (the tile's first
// byte) over rows k0 .. k0 + 15 of ``rowb`` bytes
__device__ __forceinline__ void a_frag_i8(const uint8_t* base, int rowb,
                                          int k0, int col, int g, int q,
                                          uint32_t* a) {
  const uint8_t* p = base + (k0 + 2 * q) * rowb + col + 2 * g;
  const uint32_t l0 = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t l1 = *reinterpret_cast<const uint16_t*>(p + rowb);
  const uint32_t l8 = *reinterpret_cast<const uint16_t*>(p + 8 * rowb);
  const uint32_t l9 = *reinterpret_cast<const uint16_t*>(p + 9 * rowb);
  const uint32_t w0 = __byte_perm(l0, l1, 0x5410) ^ 0x80808080u;
  const uint32_t w8 = __byte_perm(l8, l9, 0x5410) ^ 0x80808080u;
  a[0] = i8pair_f16(w0, 0x4240);  // column 2g, rows k0+2q, +1
  a[1] = i8pair_f16(w0, 0x4341);  // column 2g+1
  a[2] = i8pair_f16(w8, 0x4240);  // column 2g, rows +8
  a[3] = i8pair_f16(w8, 0x4341);
}
// v rounded to 16 bits: fp16 (int8 path) or bf16
template <bool F16>
__device__ __forceinline__ uint16_t to16(float v) {
  if constexpr (F16) {
    const __half h = __float2half_rn(v);
    return *reinterpret_cast<const uint16_t*>(&h);
  } else {
    const __nv_bfloat16 h = __float2bfloat16(v);
    return *reinterpret_cast<const uint16_t*>(&h);
  }
}
// the power of two k >= 0 with max|v| * 2^-k < 2^14, from a block max
__device__ __forceinline__ int f16_shift(float amax) {
  int e;
  frexpf(amax, &e);  // amax < 2^e
  return max(0, e - 14);
}

// WT: bf16 weights (bf16 mma, ldmatrix) or int8 weights with column
// scales s1 / sg, applied after the D sum (fp16 mma, fragments built
// from the raw bytes)
template <typename WT>
__global__ void __launch_bounds__(ST_NT, 2)
    ffn_stream_mma_kernel(const __nv_bfloat16* __restrict__ x,
                          const WT* __restrict__ w1,
                          const WT* __restrict__ wg,
                          const WT* __restrict__ w2,
                          const float* __restrict__ s1,
                          const float* __restrict__ sg,
                          float* __restrict__ cpart, int M, int D, int F,
                          int ds, int act) {
  constexpr bool Q = sizeof(WT) == 1;
  constexpr int STB = Q ? SM_QSTAGE : SM_STAGE;  // bytes of a stage
  constexpr int CE = 16 / sizeof(WT);            // elements a chunk
  constexpr int RS2 = SM_BAND * sizeof(WT) + 16;  // a phase-2 row, bytes
  constexpr int CPR2 = SM_BAND / CE;              // chunks a phase-2 row
  constexpr int CPT = (STB / 16 + ST_NT - 1) / ST_NT;
  constexpr int fs = SM_FS, nst = SM_NST;
  constexpr int HE = 8 * fs / ST_NT;  // h entries a thread
  extern __shared__ __align__(16) uint8_t sm_smem[];
  __shared__ float red_max[32];
  cg::cluster_group cl = cg::this_cluster();
  const int ncl = cl.num_blocks(), rank = cl.block_rank();
  const int dch = sm_dch(D, ds), fch = fs / ds;
  const int XS = dch + 8, HS = fch + 8;
  uint16_t* xs = reinterpret_cast<uint16_t*>(sm_smem);  // [8][XS]
  float* usum = reinterpret_cast<float*>(
      sm_smem + (sm_union_bytes(M, D, ds) + 15) / 16 * 16);  // [2][fs][8]
  uint8_t* ring = reinterpret_cast<uint8_t*>(usum + 16 * fs);
  uint16_t* hs = reinterpret_cast<uint16_t*>(ring + nst * STB);  // [8][HS]
  const uint32_t ring_s = smem_u32(ring);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  // this block: part dr of slice ``slice``, whose first block is cluster
  // rank r0 (a slice past F, padding the grid to whole clusters, adds
  // zeros)
  const int slice = blockIdx.x / ds, dr = blockIdx.x % ds, r0 = rank - dr;
  const int f0 = slice * fs;
  const int nf = max(0, min(fs, F - f0));     // the slice's live units
  const int d_lo = dr * dch, nd = max(0, min(dch, D - d_lo));
  const int f_lo = dr * fch, nf2 = max(0, min(fch, nf - f_lo));
  const bool gated = wg != nullptr;
  const int nmat = gated ? 2 : 1;
  const int rs1 = fs * sizeof(WT) + 16;  // a padded phase-1 row, bytes
  const int bd1 = STB / (nmat * rs1) / 16 * 16;  // D rows a stage
  const int t1 = nf && nd ? (nd + bd1 - 1) / bd1 : 0;
  const int nkc = (nf2 + SM_KROWS - 1) / SM_KROWS;  // W_down row chunks
  const int nband = (D + SM_BAND - 1) / SM_BAND;
  const int nt = t1 + nband * nkc;

  // each thread's 16-byte chunks of a stage, worked out once: phase 1
  // (row of the rank's D rows, column of the slice, matrix, smem offset)
  // and phase 2 (row of the chunk, column of the band)
  const int cpr1 = fs / CE, per1 = bd1 * cpr1;
  int p1_row[CPT], p1_off[CPT], p2_row[CPT], p2_col[CPT];
  long long p1_g[CPT];
  const WT* p1_src[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int i = tid + ST_NT * k;
    const int mat = i / per1, j = i - mat * per1;
    const int r = j / cpr1, c = j - r * cpr1;
    const bool live = i < nmat * per1;
    p1_row[k] = live && f0 + c * CE < F ? r : dch;  // dch: a zero chunk
    p1_off[k] = live ? mat * bd1 * rs1 + r * rs1 + c * 16 : -1;
    p1_src[k] = mat ? wg : w1;
    p1_g[k] = (long long)(d_lo + r) * F + f0 + c * CE;
    p2_row[k] = i < SM_KROWS * CPR2 ? i / CPR2 : -1;
    p2_col[k] = (i % CPR2) * CE;
  }
  auto load = [&](int t) {
    const uint32_t st = ring_s + (t % nst) * STB;
    if (t < t1) {
      const int d0 = t * bd1;  // within the rank's rows
      const long long step = (long long)d0 * F;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        if (p1_off[k] < 0) continue;
        const bool ok = p1_row[k] < nd - d0;
        cp_async16(st + p1_off[k], ok ? p1_src[k] + p1_g[k] + step : w1,
                   ok ? 16 : 0);
      }
    } else {
      const int b = (t - t1) / nkc, kc = (t - t1) - b * nkc;
      const int r0 = kc * SM_KROWS, n0 = b * SM_BAND;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        if (p2_row[k] < 0) continue;
        const bool ok = r0 + p2_row[k] < nf2 && n0 + p2_col[k] < D;
        cp_async16(st + p2_row[k] * RS2 + p2_col[k] * sizeof(WT),
                   ok ? w2 + (long long)(f0 + f_lo + r0 + p2_row[k]) * D +
                            n0 + p2_col[k]
                      : w2,
                   ok ? 16 : 0);
      }
    }
  };
  auto next = [&](int t) -> int {  // tile t landed for every thread
    cp_async_wait<nst - 2>();
    __syncthreads();
    if (t + nst - 1 < nt) load(t + nst - 1);
    cp_async_commit();
    return (t % nst) * STB;
  };
  for (int s = 0; s < nst - 1; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }
  // the rank's x columns (zero past M and past D, up to the k-steps'
  // reach); for int8 weights in fp16, scaled by 2^-kx
  const int vr = dch / 8;  // 8-element vectors a row
  const __nv_bfloat16* xb = x + d_lo;
  int kx = 0;
  if constexpr (Q) {
    float amax = 0.f;
    for (int i = tid; i < 8 * vr; i += ST_NT) {
      const int m = i / vr, v = i - m * vr;
      if (m < M && v * 8 < nd) {
        float f[8];
        load16_f32(xb + (long long)m * D + v * 8, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
      }
    }
    kx = f16_shift(block_max(amax, red_max));
  }
  const float sx = ldexpf(1.f, -kx);
  for (int i = tid; i < 8 * vr; i += ST_NT) {
    const int m = i / vr, v = i - m * vr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m < M && v * 8 < nd) {
      val = *reinterpret_cast<const uint4*>(xb + (long long)m * D + v * 8);
      if constexpr (Q) {
        float f[8];
        load16_f32(xb + (long long)m * D + v * 8, f);
        uint16_t* o = reinterpret_cast<uint16_t*>(&val);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = to16<true>(f[e] * sx);
      }
    }
    *reinterpret_cast<uint4*>(xs + m * XS + v * 8) = val;
  }

  // ---- phase 1: warp = the slice's 16-column tile ft ----
  static_assert(fs == 16 * (ST_NT / 32), "a 16-column tile a warp");
  const int ft = warp;
  // ldmatrix row address of this lane: matrix lane / 8 covers tile rows
  // +8 (matrices 2, 3) and columns +8 (matrices 1, 3)
  const int lm = lane >> 3, li = lane & 7;
  const int a_row = li + 8 * (lm >> 1), a_col = 8 * (lm & 1);
  float cu[4] = {0.f, 0.f, 0.f, 0.f}, cv[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < t1; ++t) {
    const int so = next(t);
    const int d0 = t * bd1, nks = (min(bd1, nd - d0) + 15) / 16;
    for (int ks = 0; ks < nks; ++ks) {
      const int k0 = ks * 16;
      const uint16_t* xr = xs + g * XS + d0 + k0 + 2 * q;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
      uint32_t a[4];
      if constexpr (Q) {
        a_frag_i8(ring + so, rs1, k0, ft * 16, g, q, a);
        mma16816<true>(cu, a, b0, b1);
        if (gated) {
          a_frag_i8(ring + so + bd1 * rs1, rs1, k0, ft * 16, g, q, a);
          mma16816<true>(cv, a, b0, b1);
        }
      } else {
        const uint32_t ao =
            ring_s + so + (k0 + a_row) * rs1 + (ft * 16 + a_col) * 2;
        ldsm_x4_trans(ao, a);
        mma16816<false>(cu, a, b0, b1);
        if (gated) {
          ldsm_x4_trans(ao + bd1 * rs1, a);
          mma16816<false>(cv, a, b0, b1);
        }
      }
    }
  }
  __syncthreads();  // x is read: its region takes the fragments
  float* red = reinterpret_cast<float*>(sm_smem);  // [warp][lane][8]
  *reinterpret_cast<float4*>(red + (warp * 32 + lane) * 8) =
      make_float4(cu[0], cu[1], cu[2], cu[3]);
  *reinterpret_cast<float4*>(red + (warp * 32 + lane) * 8 + 4) =
      make_float4(cv[0], cv[1], cv[2], cv[3]);
  __syncthreads();
  // the rank's sums over its D rows, usum[mat][f][m]: entry (f, m) of
  // warp f / 16's fragment row r (f % 16; for int8 column 2g is row g, 2g
  // + 1 row g + 8) -> lane (r % 8) * 4 + m / 2, register (r / 8) * 2 + m %
  // 2; x's scale undone
  const float ux = ldexpf(1.f, kx);
#pragma unroll
  for (int j = 0; j < HE; ++j) {
    const int e = tid + ST_NT * j;
    if (e >= fs * 8) continue;
    const int fl = e >> 3, m = e & 7, cc = fl & 15;
    const int r = Q ? (cc & 1) * 8 + (cc >> 1) : cc;
    const int ln = (r & 7) * 4 + (m >> 1), rg = (r >> 3) * 2 + (m & 1);
    const float* src = red + ((fl >> 4) * 32 + ln) * 8;
    usum[e] = src[rg] * ux;
    usum[fs * 8 + e] = src[4 + rg] * ux;
  }
  cl.sync();  // every rank's sums are in place
  // h for the rank's W_down rows: the ranks' sums in rank order, then the
  // column scales, act and the gate
  float hv[HE];
  float hmax = 0.f;
#pragma unroll
  for (int j = 0; j < HE; ++j) {
    const int e = tid + ST_NT * j;  // (row fl of the rank's fch, m)
    hv[j] = 0.f;
    if (e >= fch * 8) continue;
    const int fl = f_lo + (e >> 3), f = f0 + fl;
    float u = 0.f, gv = 0.f;
    for (int r = 0; r < ds; ++r) {
      const float* src = cl.map_shared_rank(usum, r0 + r);
      u += src[fl * 8 + (e & 7)];
      gv += src[fs * 8 + fl * 8 + (e & 7)];
    }
    if (f < F) {
      float h = activate(Q ? u * s1[f] : u, act);
      if (gated) h *= Q ? gv * sg[f] : gv;
      hv[j] = h;
      hmax = fmaxf(hmax, fabsf(h));
    }
  }
  const int kh = Q ? f16_shift(block_max(hmax, red_max)) : 0;
  const float sh = ldexpf(1.f, -kh);
#pragma unroll
  for (int j = 0; j < HE; ++j) {
    const int e = tid + ST_NT * j;
    if (e < fch * 8) hs[(e & 7) * HS + (e >> 3)] = to16<Q>(hv[j] * sh);
  }

  // ---- phase 2: warp = output tiles 2 warp, 2 warp + 1 of each band ----
  float* part = reinterpret_cast<float*>(sm_smem);  // [M][D]
  const float uh = ldexpf(1.f, kh);
  float acc[2][4];
  for (int t = t1; t < nt; ++t) {  // next()'s barrier also publishes hs
    const int so = next(t);
    const int b = (t - t1) / nkc, kc = (t - t1) - b * nkc;
    if (kc == 0)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int nks = (min(SM_KROWS, nf2 - kc * SM_KROWS) + 15) / 16;
    for (int ks = 0; ks < nks; ++ks) {
      const int k0 = ks * 16;
      const uint16_t* hr = hs + g * HS + kc * SM_KROWS + k0 + 2 * q;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(hr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(hr + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t a[4];
        if constexpr (Q) {
          a_frag_i8(ring + so, RS2, k0, (2 * warp + j) * 16, g, q, a);
        } else {
          ldsm_x4_trans(ring_s + so + (k0 + a_row) * RS2 +
                            ((2 * warp + j) * 16 + a_col) * 2,
                        a);
        }
        mma16816<Q>(acc[j], a, b0, b1);
      }
    }
    if (kc == nkc - 1) {  // the band is done: its outputs into the partial
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = b * SM_BAND + (2 * warp + j) * 16;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // fragment row g (+8 for i >= 2) is column g (+8), or for int8
          // 2g (+1)
          const int m = 2 * q + (i & 1);
          const int nn = n + (Q ? 2 * g + (i >> 1) : g + 8 * (i >> 1));
          if (m < M && nn < D) part[m * D + nn] = acc[j][i] * uh;
        }
      }
    }
  }
  if (!nkc) {  // a rank with no W_down rows adds zeros
    __syncthreads();
    for (int i = tid; i < M * D; i += ST_NT) part[i] = 0.f;
  }

  // ---- the cluster's partials, added in rank order ----
  cl.sync();
  float* out = cpart + (long long)(blockIdx.x / ncl) * M * D;
  for (int i = rank * ST_NT + tid; i < M * D; i += ncl * ST_NT) {
    float v[ST_MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < ST_MAX_SPLIT; ++r)
      v[r] = r < ncl ? cl.map_shared_rank(part, r)[i] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < ST_MAX_SPLIT; ++r) s += v[r];
    out[i] = s;
  }
  cl.sync();  // keep every rank's memory alive until the others read it
}

// p = {ds, cluster, n_blocks}: n_blocks / ds slices of SM_FS hidden units
// (the grid padded to whole clusters; slices past F add zeros), each
// split over D among ds blocks of one cluster
template <typename WT>
static int launch_stream(const FfnArgs& a, cudaStream_t st) {
  const int ds = a.p[0], ncl = a.p[1], nb = a.p[2];
  // ds divides the cluster, and each block's W_down rows are 16-row steps
  if (ds < 1 || ncl % ds || ncl > ST_MAX_SPLIT || nb % ncl ||
      (long long)(nb / ds) * SM_FS < a.F || SM_FS % (16 * ds) || a.M > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = sm_smem_bytes(a.M, a.D, ds, sizeof(WT) == 1);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ffn_stream_mma_kernel<WT>;
  static int granted = 0;  // dynamic shared memory opted in so far
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(ST_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const WT*>(a.w1), static_cast<const WT*>(a.wg),
      static_cast<const WT*>(a.w2), a.s1, a.sg,
      static_cast<float*>(a.scratch), a.M, a.D, a.F, ds, a.act);
  if (e != cudaSuccess) return static_cast<int>(e);
  launch_reduce<__nv_bfloat16>(static_cast<const float*>(a.scratch), a.s2,
                               a.out, nb / ncl, a.M, a.D, st);
  return 0;
}

// ===========================================================================
// 3. fma: f32 x and rows not 16-byte aligned
// ===========================================================================
constexpr int BF = 32;   // hidden units per inner step
constexpr int NT = 256;  // threads; phase 2 gives each thread D / NT columns
constexpr int FMA_BM = 16;  // rows a block
constexpr int FMA_BAND = 12 * NT;  // output columns a block: 12 a thread

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
  // this block's band of output columns: [n0, n0 + nd)
  const int n0 = blockIdx.z * FMA_BAND, nd = min(D - n0, FMA_BAND);
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
        const WT* src = w2 + (long long)(f0 + r0) * D + n0;
        if (vec & VEC_DOWN) {  // D % 16 == 0 and an aligned base
          const int nv = nd / 16;
          for (int idx = tid; idx < nr * nv; idx += NT) {
            const int rr = idx / nv, cv = idx % nv;
            *reinterpret_cast<uint4*>(w2s + rr * STR + cv * 16) =
                *reinterpret_cast<const uint4*>(src + (long long)rr * D +
                                                cv * 16);
          }
        } else {
          for (int idx = tid; idx < nr * nd; idx += NT)
            w2s[(idx / nd) * STR + idx % nd] =
                src[(long long)(idx / nd) * D + idx % nd];
        }
        __syncthreads();
#pragma unroll(BM >= 16 ? 4 : 1)
        for (int rr = 0; rr < nr; ++rr) {
          float wv[NCH];
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const int n = tid + NT * c;
            wv[c] = n < nd ? static_cast<float>(w2s[rr * STR + n]) : 0.f;
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
        const WT* w2row = w2 + (long long)(f0 + ff) * D + n0;
        float wv[NCH];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int n = tid + NT * c;
          wv[c] = n < nd ? to_f32(w2row[n]) : 0.f;
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

  float* pb = partial + (long long)fc * M * D + n0;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int n = tid + NT * c;
      if (n < nd) pb[(long long)m * D + n] = acc[r][c];
    }
  }
}

template <typename T, typename WT, int NCH>
static int launch_fma(const FfnArgs& a, cudaStream_t stream) {
  const int f_per_block = a.p[0], n_fc = a.p[1], vec = a.p[2];
  dim3 grid((a.M + FMA_BM - 1) / FMA_BM, n_fc,
            (a.D + FMA_BAND - 1) / FMA_BAND);
  ffn_act_kernel<T, WT, FMA_BM, NCH><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const WT*>(a.w1),
      static_cast<const WT*>(a.wg), static_cast<const WT*>(a.w2), a.s1, a.sg,
      static_cast<float*>(a.scratch), a.M, a.D, a.F, f_per_block, a.act, vec);
  launch_reduce<T>(static_cast<const float*>(a.scratch), a.s2, a.out, n_fc,
                   a.M, a.D, stream);
  return 0;
}

// p = {f_per_block, n_fc, vec}
template <typename T, typename WT>
static int dispatch_fma(const FfnArgs& a, cudaStream_t st) {
  const int nch = (min(a.D, FMA_BAND) + NT - 1) / NT;
#define FFN_CASE(N) \
  if (nch <= N) return launch_fma<T, WT, N>(a, st);
  FFN_CASE(1) FFN_CASE(2) FFN_CASE(4) FFN_CASE(6) FFN_CASE(8) FFN_CASE(10)
  FFN_CASE(12)
#undef FFN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ===========================================================================
// 2. wgmma: bf16 prefill
// ===========================================================================
constexpr int TC_BK = 64;                   // depth of a tile
constexpr int TC_MAX_STAGES = 6;
constexpr int TC_BN = 128;                  // output columns a block
constexpr int TC_SMEM = SMEM_LIMIT - 1024;  // after aligning to 1024 bytes

// A GEMM of BM rows by BN columns over NB weight operands: the ring's
// stages hold an x (or h) tile and NB weight tiles, in bf16 or, for int8
// weights, as the raw bytes; int8 tiles are widened into WIDE, two bf16
// buffers of NB tiles
template <typename WT, int BM, int BN, int NB>
struct TcShape {
  static constexpr bool QUANT = sizeof(WT) == 1;
  static constexpr int XB = tile_bytes(BM, TC_BK);
  static constexpr int WB = tile_bytes(TC_BK, BN);
  static constexpr int RAW = TC_BK * BN;
  static constexpr int STAGE = XB + NB * (QUANT ? RAW : WB);
  static constexpr int WIDE = QUANT ? 2 * NB * WB : 0;
  static constexpr int FIT = (TC_SMEM - WIDE) / STAGE;
  static constexpr int STAGES = FIT < TC_MAX_STAGES ? FIT : TC_MAX_STAGES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING + WIDE + 1024;
  static_assert(STAGES >= 3, "the ring needs 3 stages");
};

// int8 rows [R][C] as they are in memory: 16-byte cp.asyncs, rows >=
// ``rows`` and columns >= ``cols`` (a multiple of 16) zero-filled
template <int R, int C>
__device__ __forceinline__ void load_raw(uint32_t dst, const int8_t* src,
                                         long long stride, int rows,
                                         int cols, int tid, int nt) {
  constexpr int CPR = C / 16;
#pragma unroll 4
  for (int i = tid; i < R * CPR; i += nt) {
    const int r = i / CPR, cj = i % CPR;
    const bool ok = r < rows && cj * 16 < cols;
    cp_async16(dst + r * C + cj * 16, ok ? src + r * stride + cj * 16 : src,
               ok ? 16 : 0);
  }
}

// a raw int8 [R][C] tile widened into the swizzled bf16 tile at ``dst``
// (exact: |q| <= 127 fits bf16's 8-bit significand)
template <int R, int C>
__device__ __forceinline__ void widen_tile(uint8_t* dst, const uint8_t* raw,
                                           int tid, int nt) {
  constexpr int CPR = C / 8;
#pragma unroll 4
  for (int i = tid; i < R * CPR; i += nt) {
    const int r = i / CPR, cj = i % CPR;
    const uint2 q = *reinterpret_cast<const uint2*>(raw + r * C + cj * 8);
    const uint32_t lo = q.x ^ 0x80808080u, hi = q.y ^ 0x80808080u;
    uint4 o;
    o.x = pack_bf16(i8_byte(lo, 0x7440), i8_byte(lo, 0x7441));
    o.y = pack_bf16(i8_byte(lo, 0x7442), i8_byte(lo, 0x7443));
    o.z = pack_bf16(i8_byte(hi, 0x7440), i8_byte(hi, 0x7441));
    o.w = pack_bf16(i8_byte(hi, 0x7442), i8_byte(hi, 0x7443));
    *reinterpret_cast<uint4*>(dst + tile_offset<R, C>(r, cj)) = o;
  }
}

// The GEMM main loop: acc[j] (BN / 2 floats a thread, wgmma's fragment) =
// A (BM x k_len, K-major rows of stride lda; a_rows live) times B_j (k_len
// x BN, MN-major rows of stride ldb; b_cols live), for j < NB with b[j]
// not null. Loads run STAGES - 2 tiles ahead and one group of products
// stays in flight while the next is issued (qkv_proj.cu's GEMM).
template <typename WT, int BM, int BN, int NB>
__device__ __forceinline__ void tc_mainloop(
    uint8_t* ring, const __nv_bfloat16* a, long long lda, int a_rows,
    const WT* const* b, long long ldb, int b_cols, int k_len,
    float (*acc)[BN / 2]) {
  using S = TcShape<WT, BM, BN, NB>;
  constexpr int NT_ = 2 * BM;  // a warpgroup of 128 threads a 64 rows
  const int tid = threadIdx.x, wgi = tid / 128;
  const uint32_t ring_s = smem_u32(ring);
  const int nk = (k_len + TC_BK - 1) / TC_BK;
  auto load = [&](int kt) {
    const uint32_t st = ring_s + (kt % S::STAGES) * S::STAGE;
    const int k0 = kt * TC_BK;
    load_tile<BM, TC_BK>(st, a + k0, lda, a_rows, k_len - k0, tid, NT_);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (!b[j]) continue;
      const WT* src = b[j] + (long long)k0 * ldb;
      if constexpr (S::QUANT)
        load_raw<TC_BK, BN>(st + S::XB + j * S::RAW, src, ldb, k_len - k0,
                            b_cols, tid, NT_);
      else
        load_tile<TC_BK, BN>(st + S::XB + j * S::WB, src, ldb, k_len - k0,
                             b_cols, tid, NT_);
    }
  };
#pragma unroll
  for (int s = 0; s < S::STAGES - 2; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[j][i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S::STAGES - 3>();  // tile kt landed; later ones fly
    fence_proxy_async();
    __syncthreads();  // ... for every thread; tile kt - 2's products done
    if (kt + S::STAGES - 2 < nk) load(kt + S::STAGES - 2);
    cp_async_commit();
    const int so = (kt % S::STAGES) * S::STAGE;
    uint32_t bt[NB];
    if constexpr (S::QUANT) {
      // widen into the buffer tile kt - 2 used; its products are done
      const int wo = S::RING + (kt & 1) * NB * S::WB;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (b[j])
          widen_tile<TC_BK, BN>(ring + wo + j * S::WB,
                                ring + so + S::XB + j * S::RAW, tid, NT_);
        bt[j] = ring_s + wo + j * S::WB;
      }
      fence_proxy_async();  // the generic writes, seen by wgmma's proxy
      __syncthreads();
    } else {
#pragma unroll
      for (int j = 0; j < NB; ++j) bt[j] = ring_s + so + S::XB + j * S::WB;
    }
    const uint32_t at = ring_s + so + wgi * tile_bytes(64, TC_BK);
#pragma unroll
    for (int j = 0; j < NB; ++j) wgmma_hold<BN / 2>(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (b[j])
          Wgmma<BN>::template ss<1>(acc[j], desc_k<BM, TC_BK>(at, ks),
                                    desc_mn<TC_BK, BN>(bt[j], ks), 1);
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < NB; ++j) wgmma_hold<BN / 2>(acc[j]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NB; ++j) wgmma_hold<BN / 2>(acc[j]);
  cp_async_wait<0>();
}

__device__ __forceinline__ uint8_t* tc_ring(uint8_t* smem) {
  const uint32_t s = smem_u32(smem);
  return smem + (((s + 1023) & ~1023u) - s);
}

// Phase 1: h = act(x·W_up · s1) [* x·W_gate · sg] for a 64·WGS x TC_BN
// tile, rounded to bf16 into the (M, F) workspace
template <typename WT, int WGS>
__global__ void __launch_bounds__(128 * WGS)
    ffn_up_kernel(const __nv_bfloat16* __restrict__ x,
                  const WT* __restrict__ w1, const WT* __restrict__ wg,
                  const float* __restrict__ s1, const float* __restrict__ sg,
                  __nv_bfloat16* __restrict__ h, int M, int D, int F,
                  int act) {
  constexpr int BM = 64 * WGS, BN = TC_BN;
  constexpr bool QUANT = sizeof(WT) == 1;
  extern __shared__ uint8_t tc_smem[];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const bool gated = wg != nullptr;
  const WT* b[2] = {w1 + col0, gated ? wg + col0 : nullptr};
  float acc[2][BN / 2];
  tc_mainloop<WT, BM, BN, 2>(tc_ring(tc_smem), x + (long long)row0 * D, D,
                             M - row0, b, F, F - col0, D, acc);
  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r = row0 + 64 * wgi + 16 * warp + (lane >> 2);
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int n = col0 + 8 * c + 2 * (lane & 3);
    if (n >= F) continue;  // F % 8 == 0: n + 1 < F too
    const float u0 = QUANT ? s1[n] : 1.f, u1 = QUANT ? s1[n + 1] : 1.f;
    const float g0 = QUANT && gated ? sg[n] : 1.f;
    const float g1 = QUANT && gated ? sg[n + 1] : 1.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = r + 8 * i;
      if (rr >= M) continue;
      float h0 = activate(acc[0][4 * c + 2 * i] * u0, act);
      float h1 = activate(acc[0][4 * c + 2 * i + 1] * u1, act);
      if (gated) {
        h0 *= acc[1][4 * c + 2 * i] * g0;
        h1 *= acc[1][4 * c + 2 * i + 1] * g1;
      }
      *reinterpret_cast<__nv_bfloat162*>(h + (long long)rr * F + n) =
          __floats2bfloat162_rn(h0, h1);
    }
  }
}

// Phase 2: out = (h·W_down) · s2 for a 64·WGS x TC_BN tile over hidden
// units [z k_chunk, +k_chunk); the blocks of a cluster (gridDim.z of
// them) add their tiles in rank order through distributed shared memory
template <typename WT, int WGS>
__global__ void __launch_bounds__(128 * WGS)
    ffn_down_kernel(const __nv_bfloat16* __restrict__ h,
                    const WT* __restrict__ w2, const float* __restrict__ s2,
                    __nv_bfloat16* __restrict__ out, int M, int D, int F,
                    int k_chunk) {
  constexpr int BM = 64 * WGS, BN = TC_BN, NT_ = 128 * WGS;
  using S = TcShape<WT, BM, BN, 1>;
  static_assert(BM * BN * 4 <= S::RING, "the partial goes over the ring");
  extern __shared__ uint8_t tc_smem[];
  uint8_t* ring = tc_ring(tc_smem);
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int kb = blockIdx.z * k_chunk, kl = max(0, min(k_chunk, F - kb));
  const WT* b[1] = {w2 + (long long)kb * D + col0};
  float acc[1][BN / 2];
  tc_mainloop<WT, BM, BN, 1>(ring, h + (long long)row0 * F + kb, F,
                             M - row0, b, D, D - col0, kl, acc);
  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int rl = 64 * wgi + 16 * warp + (lane >> 2);
  if (gridDim.z == 1) {
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int n = col0 + 8 * c + 2 * (lane & 3);
      if (n >= D) continue;  // D % 8 == 0
      const float c0 = s2 ? s2[n] : 1.f, c1 = s2 ? s2[n + 1] : 1.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = row0 + rl + 8 * i;
        if (rr < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)rr * D + n) =
              __floats2bfloat162_rn(acc[0][4 * c + 2 * i] * c0,
                                    acc[0][4 * c + 2 * i + 1] * c1);
      }
    }
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  __syncthreads();  // every warpgroup is done with the ring
  float* part = reinterpret_cast<float*>(ring);  // [BM][BN]
#pragma unroll
  for (int c = 0; c < BN / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(part + (rl + 8 * i) * BN + 8 * c +
                                 2 * (lane & 3)) =
          make_float2(acc[0][4 * c + 2 * i], acc[0][4 * c + 2 * i + 1]);
  cl.sync();
  const int ks = cl.num_blocks(), rank = cl.block_rank();
  for (int p = rank * NT_ + tid; p < BM * BN / 2; p += ks * NT_) {
    float2 v[ST_MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < ST_MAX_SPLIT; ++q)
      v[q] = q < ks ? reinterpret_cast<const float2*>(
                          cl.map_shared_rank(part, q))[p]
                    : make_float2(0.f, 0.f);
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int q = 0; q < ST_MAX_SPLIT; ++q) {
      sx += v[q].x;
      sy += v[q].y;
    }
    const int rr = row0 + (2 * p) / BN, n = col0 + (2 * p) % BN;
    if (rr < M && n < D) {
      const float c0 = s2 ? s2[n] : 1.f, c1 = s2 ? s2[n + 1] : 1.f;
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)rr * D + n) =
          __floats2bfloat162_rn(sx * c0, sy * c1);
    }
  }
  cl.sync();  // keep ``part`` alive until every block of the cluster read it
}

template <typename WT, int WGS>
static int launch_up(const FfnArgs& a, cudaStream_t st) {
  using S = TcShape<WT, 64 * WGS, TC_BN, 2>;
  auto kern = ffn_up_kernel<WT, WGS>;
  static bool granted = false;
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = true;
  }
  const dim3 grid((a.M + 64 * WGS - 1) / (64 * WGS),
                  (a.F + TC_BN - 1) / TC_BN);
  kern<<<grid, 128 * WGS, S::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const WT*>(a.w1),
      static_cast<const WT*>(a.wg), a.s1, a.sg,
      static_cast<__nv_bfloat16*>(a.scratch), a.M, a.D, a.F, a.act);
  return 0;
}

template <typename WT, int WGS>
static int launch_down(const FfnArgs& a, int ks, int k_chunk,
                       cudaStream_t st) {
  using S = TcShape<WT, 64 * WGS, TC_BN, 1>;
  auto kern = ffn_down_kernel<WT, WGS>;
  if (ks < 1 || ks > ST_MAX_SPLIT || k_chunk % TC_BK ||
      (long long)ks * k_chunk < a.F)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool granted = false;
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.M + 64 * WGS - 1) / (64 * WGS),
                     (a.D + TC_BN - 1) / TC_BN, ks);
  cfg.blockDim = dim3(128 * WGS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ks;
  cfg.attrs = attr;
  cfg.numAttrs = ks > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(a.scratch),
      static_cast<const WT*>(a.w2), a.s2, static_cast<__nv_bfloat16*>(a.out),
      a.M, a.D, a.F, k_chunk));
}

// p = {wgs, ks, k_chunk}: both phases in 64·wgs x TC_BN tiles, phase 2's
// F split over ks blocks of k_chunk
template <typename WT>
static int launch_wgmma(const FfnArgs& a, cudaStream_t st) {
  const int wgs = a.p[0], ks = a.p[1], k_chunk = a.p[2];
  if (wgs == 1) {
    const int e = launch_up<WT, 1>(a, st);
    return e ? e : launch_down<WT, 1>(a, ks, k_chunk, st);
  }
  if (wgs == 2) {
    const int e = launch_up<WT, 2>(a, st);
    return e ? e : launch_down<WT, 2>(a, ks, k_chunk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ===========================================================================
// entry
// ===========================================================================
// Run ``variant`` (VAR_*) with its plan a.p; T is x's and out's type, WT
// the weights'. Returns a CUDA error code, clearing it so the next call
// does not report it again.
template <typename T, typename WT>
static int ffn_run(int variant, const FfnArgs& a, cudaStream_t st) {
  if (a.M == 0) return static_cast<int>(cudaGetLastError());
  int bad = static_cast<int>(cudaErrorInvalidValue);
  if (variant == VAR_FMA) {
    bad = dispatch_fma<T, WT>(a, st);
  } else if (variant == VAR_STREAM) {
    if constexpr (sizeof(T) == 2) bad = launch_stream<WT>(a, st);
  } else if (variant == VAR_WGMMA) {
    if constexpr (sizeof(T) == 2) bad = launch_wgmma<WT>(a, st);
  }
  if (bad) {
    cudaGetLastError();
    return bad;
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of the forms, for the Python mirrors: form 0 the stream
// kernel at (M = a, D = b, ds = c); 1 phase 1 of the GEMM at wgs = a; 2
// its phase 2 at wgs = a. 0 for anything else.
template <typename WT>
static int ffn_smem_query(int form, int a, int b, int c) {
  if (form == 0) return sm_smem_bytes(a, b, c, sizeof(WT) == 1);
  if (form == 1 && a == 1) return TcShape<WT, 64, TC_BN, 2>::SMEM;
  if (form == 1 && a == 2) return TcShape<WT, 128, TC_BN, 2>::SMEM;
  if (form == 2 && a == 1) return TcShape<WT, 64, TC_BN, 1>::SMEM;
  if (form == 2 && a == 2) return TcShape<WT, 128, TC_BN, 1>::SMEM;
  return 0;
}
