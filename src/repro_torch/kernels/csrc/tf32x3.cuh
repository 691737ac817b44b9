// f32-accurate GEMMs on Hopper's TF32 tensor cores (3xTF32), shared by the
// f32 prefill / training forms of ffn_act (ffn_act.cuh), qkv_proj
// (qkv_proj.cu) and attn_stream (attn_stream.cu: the split and the
// TF32 wgmma products of `WgmmaTf32`; its own tiles and pair planes).
//
// The split. An f32 operand a is cut into two TF32 values, a_hi =
// tf32(a) and a_lo = tf32(a - a_hi), each rounded as cvt.rna.tf32.f32
// does (to nearest, ties away; the low 13 bits cleared). a - a_hi is
// exact in f32, so a = a_hi + a_lo + e_a with |a_lo| <= 2^-11 |a| and
// |e_a| <= 2^-11 |a_lo| <= 2^-22 |a|. A product takes three TF32 MMAs,
// a_lo·b_hi + a_hi·b_lo + a_hi·b_hi; a_lo·b_lo (<= 2^-22 |a b|) is
// dropped. Each term of a sum is then off by at most |a_lo b_lo| +
// |e_a b| + |a e_b| + ... <= 3·2^-22 |a_k b_k| (plus terms of 2^-33), so
//   |sum_k a_k b_k - gemm| <= 3·2^-22 sum_k |a_k b_k| + the error of
//   summing in f32, which any f32 GEMM of the same K has;
// chip_smoke.py prints each case's measured error beside 3·2^-22 times
// its largest sum_k |a_k b_k|. A single TF32 product (2^-11 a term)
// misses the f32 paths' 1e-4 gate; the split holds it at three products
// a k-step: 495 / 3 = 165 TFLOP/s of f32 work at the H100's TF32 peak,
// against 67 on the CUDA cores.
//
// The sums. The tensor cores add into their accumulator rounding toward
// zero, once for each of the three products of a k-step; summed that way
// over all of K (8960 in phase 2 of fastvlm-1.7b's FFN) that bias
// measured tens of times the f32 FMA form's error while this kernel was
// developed. So the products go into a fragment that is zeroed every
// TF_FLUSH k-tiles (64 of K) and then added into the f32 accumulator on
// the CUDA cores (rounding to nearest): the tensor cores' rounding acts
// on a short partial sum only, and the error is f32's order
// (kernel_sweep.py's tf32 section prints each form's error beside the
// FMA form's).
//
// The layout. wgmma reads .tf32 operands only K-major (the transpose
// bits exist only for 16-bit types), so A is (M, K) and B is (N, K), K
// contiguous. `tf32_split_kernel` runs first, once a call: it writes
// every operand as a "pair plane" in a workspace the wrapper allocates,
// each row of K as blocks of 16 hi values followed by their 16 lo
// values (a row of ceil(K / 16) * 32 floats; weights transposed through
// a 32 x 32 shared-memory tile, x as stored). The port's weights are
// MN-major as B (W_up, W_gate (D, F), Wq|Wk|Wv (D, N): N contiguous;
// W_down (F, D): D contiguous), and cp.async / TMA cannot transpose;
// weights change every training step, so nothing is cached across
// calls. At fastvlm-1.7b's FFN the split reads 178 MB and writes 356 MB
// (~0.16 ms at 3.35 TB/s) against a GEMM of 169 GFLOP. A k-tile of 32 is
// then two 128-byte lines a row, copied by cp.async into wgmma.cuh's
// 128B-swizzled tile as a 128-column bf16 tile is, one line in each of
// its two regions: bytes 0-63 of a line the hi values (k-steps at 32
// bytes each, as 16-deep bf16 k-steps), bytes 64-127 the lo values.
//
// The GEMM (`tf_mainloop`): a block is two warpgroups over a 128 x 128
// output tile (phase 1 of a gated FFN: 64 columns of x·W_up beside the
// same 64 of x·W_gate), both operands from shared memory (wgmma's ss
// form), 32-deep k-tiles (64 KB a stage) in a 3-stage cp.async ring,
// loads one tile ahead and one group of products in flight while the
// next is issued (32-deep tiles measured faster than 16-deep ones in a
// 7-stage ring: half the barriers). Ragged M, N and K are zero-filled by
// the copies; K and every N a multiple of 4 (16-byte rows: the wrapper
// checks).
//
// What bounds it: its copies and its products overlap poorly (every
// thread fills the one ring, with a barrier a k-tile); with either
// switched off in a scratch build, their times added up. Splitting raw
// f32 tiles in shared memory instead (half the L2 bytes) and a
// single-warp cp.async producer on mbarriers both measured slower. A TMA
// producer, A from registers and 256-wide B tiles are still to try.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

constexpr int TF_PB = 16;            // a pair block: 16 hi, then 16 lo
constexpr int TF_BK = 32;            // f32 a k-tile: two pair blocks
constexpr int TF_C = 4 * TF_BK;      // a tile row (two blocks) in
                                     // wgmma.cuh's 2-byte columns: 256 B
constexpr int TF_BM = 128, TF_BN = 128, TF_NT = 256;  // two warpgroups
constexpr int TF_MAX_STAGES = 8;
constexpr int TF_SMEM_LIMIT = 232448;  // shared memory a block may use

// x rounded to TF32 as cvt.rna.tf32.f32 does; the mask clears the low 13
// bits, which the PTX result leaves unspecified
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xFFFFE000u);
}
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);  // x - hi is exact in f32
}
// The same split by two integer operations on x's bits (half a TF32 step
// added to the magnitude, then the mask: to nearest, ties away, the same
// bits as cvt.rna for every finite x). A NaN is not kept: it may come out
// as -0 or as an infinity. So it splits only values whose NaN reaches
// the result another way: the attention's P, whose unsplit values also
// make the softmax denominator. It measured faster there on the H100,
// the GEMMs' epilogues slower.
__device__ __forceinline__ void tf32_split_bits(float x, float& hi,
                                                float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
  lo = __uint_as_float((__float_as_uint(x - hi) + 0x1000u) & 0xFFFFE000u);
}

// floats a row of a pair plane of K columns: ceil(K / 16) blocks of 16 hi
// and 16 lo values
__host__ __device__ constexpr long long tf_pair_ld(int K) {
  return (K + TF_PB - 1) / TF_PB * 2LL * TF_PB;
}
// offset of the hi value of column k in a pair-plane row (lo: + TF_PB)
__device__ __forceinline__ int tf_pair_col(int k) {
  return (k / TF_PB) * 2 * TF_PB + k % TF_PB;
}
// x split into hi / lo at column k of pair-plane row ``row``
__device__ __forceinline__ void tf_pair_store(float* row, int k, float x) {
  float h, l;
  tf32_split(x, h, l);
  row[tf_pair_col(k)] = h;
  row[tf_pair_col(k) + TF_PB] = l;
}

// ---- the split: pair planes of up to 4 matrices in one launch -----------
// Matrix i is src[i] (rows x cols, row-major); trans 1 writes it as the
// (cols, rows) pair plane (a weight, N contiguous -> K-major: K = rows),
// 0 as the (rows, cols) one (K = cols). Blocks walk 32 x 32 tiles of the
// matrices in order.
struct SplitArgs {
  const float* src[4];
  float* dst[4];
  int rows[4], cols[4], trans[4];
  int tile0[5];  // first block of each matrix; tile0[n] = the grid
  int n;
};

__global__ void __launch_bounds__(256) tf32_split_kernel(SplitArgs a) {
  __shared__ float t[32][33];
  const int b = blockIdx.x;
  // the matrix of block b, by selects (indexing the by-value arguments at
  // run time would copy them to local memory)
  const int i = b >= a.tile0[1] ? (b >= a.tile0[2] ? (b >= a.tile0[3] ? 3
                                                                      : 2)
                                                   : 1)
                                : 0;
#define TF_PICK(f) \
  (i == 0 ? a.f[0] : i == 1 ? a.f[1] : i == 2 ? a.f[2] : a.f[3])
  const float* src = TF_PICK(src);
  float* dst = TF_PICK(dst);
  const int R = TF_PICK(rows), C = TF_PICK(cols), tr = TF_PICK(trans);
  const int t0 = TF_PICK(tile0);
#undef TF_PICK
  const int tc_n = (C + 31) / 32, tile = b - t0;
  const int r0 = (tile / tc_n) * 32, c0 = (tile % tc_n) * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  if (!tr) {
    const long long ld = tf_pair_ld(C);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + ty + 8 * k, c = c0 + tx;
      if (r < R && c < C)
        tf_pair_store(dst + r * ld, c, src[(long long)r * C + c]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = r0 + ty + 8 * k, c = c0 + tx;
    t[ty + 8 * k][tx] = r < R && c < C ? src[(long long)r * C + c] : 0.f;
  }
  __syncthreads();
  const long long ld = tf_pair_ld(R);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int oc = c0 + ty + 8 * k, orow = r0 + tx;  // out row oc, k orow
    if (oc < C && orow < R)
      tf_pair_store(dst + oc * ld, orow, t[tx][ty + 8 * k]);
  }
}

// tiles of the split launch, filled into a.tile0; returns the grid
static inline int split_grid(SplitArgs& a) {
  int t = 0;
  for (int i = 0; i < 4; ++i) {
    a.tile0[i] = t;
    if (i < a.n) t += ((a.rows[i] + 31) / 32) * ((a.cols[i] + 31) / 32);
  }
  a.tile0[4] = t;
  return t;
}

static inline void launch_split(SplitArgs& a, cudaStream_t st) {
  const int grid = split_grid(a);
  if (grid > 0) tf32_split_kernel<<<grid, 256, 0, st>>>(a);
}

// ---- wgmma m64n128k8, TF32 inputs (both K-major), f32 accumulators -------
// D (64 x 128, f32) += A (64 x 8, smem) . B (8 x 128, smem); the
// accumulator fragment is Wgmma<128>'s. No transpose operands: .tf32
// takes none.
// scale_d 0 overwrites d with the product.
__device__ __forceinline__ void wgmma_tf32_128(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- wgmma m64nNk8, TF32 inputs, f32 accumulators, by N -------------------
// The attention's products (attn_stream.cu): S = Q.K^T with both operands
// K-major in shared memory (`ss`, N = the key tile: 16 or 32), O += P.V
// with P from registers (`rs`, N = the head dim: 64, 128, 160). The
// accumulator fragment is wgmma.cuh's. The register A fragment of an
// 8-deep k-step (PTX ISA, wgmma .tf32 matrix A): thread t of the
// warpgroup, warp w, lane l, holds a[0] = (row 16w + l/4, col l%4),
// a[1] = (row + 8, col l%4), a[2] = (row, col l%4 + 4), a[3] = (row + 8,
// col l%4 + 4) -- not the accumulator's columns (2(l%4), 2(l%4) + 1).
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<16> {
  // D (64 x 16, f32) (+)= A (64 x 8, smem) . B (8 x 16, smem)
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<32> {
  // D (64 x 32, f32) (+)= A (64 x 8, smem) . B (8 x 32, smem)
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<64> {
  // D (64 x 64, f32) (+)= A (64 x 8, registers) . B (8 x 64, smem)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<128> {
  // D (64 x 128, f32) (+)= A (64 x 8, registers) . B (8 x 128, smem)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<160> {
  // D (64 x 160, f32) (+)= A (64 x 8, registers) . B (8 x 160, smem)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "{%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

// ---- the GEMM main loop ---------------------------------------------------
// Stage: the pair tiles of A (TF_BM rows) and of B (TF_BN rows), 32 of K
// (256-byte rows: two 128B-swizzled regions): 64 KB, 3 stages.
struct TfShape {
  static constexpr int AT = tile_bytes(TF_BM, TF_C);
  static constexpr int BT = tile_bytes(TF_BN, TF_C);
  static constexpr int STAGE = AT + BT;
  static constexpr int FIT = (TF_SMEM_LIMIT - 1024) / STAGE;
  static constexpr int STAGES = FIT < TF_MAX_STAGES ? FIT : TF_MAX_STAGES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING + 1024;
  static_assert(STAGES >= 3, "the ring needs 3 stages");
};

// One operand of a GEMM: a pair plane from its first row and k-tile,
// ``rows`` live rows (the rest zero-filled)
struct TfOperand {
  const float* p;
  int rows;
};

// NR rows of one k-tile (``kl`` of its 32 columns live) of the pair plane
// ``src`` (row stride ``ld`` floats) into rows r0.. of a 128-row tile:
// two 128-byte lines a row, pair block b in the tile's region b, chunk j
// of a line hi values 4j.. (j < 4) or lo values 4(j - 4)..; rows >=
// ``rows`` and columns >= ``kl`` zero-filled
template <int NR>
__device__ __forceinline__ void tf_load(uint32_t tile, int r0,
                                        const float* src, long long ld,
                                        int rows, int kl, int tid) {
  constexpr int CPR = TF_BK / 2;  // 16-byte chunks a row
#pragma unroll 4
  for (int i = tid; i < NR * CPR; i += TF_NT) {
    const int r = i / CPR, cj = i % CPR;
    const bool ok = r < rows && (cj / 8) * TF_PB + 4 * (cj & 3) < kl;
    cp_async16(tile + tile_offset<128, TF_C>(r0 + r, cj),
               ok ? src + r * ld + 4 * cj : src, ok ? 16 : 0);
  }
}

// acc (wgmma's fragment of a 64 x TF_BN tile a warpgroup) = A (TF_BM
// rows, pair plane of stride lda) times B (TF_BN rows of N: rows [0, 64)
// from b0, [64, 128) from b1, pair planes of stride ldb) over k_len. The
// B halves are separate so that phase 1 of the FFN can put 64 columns
// of W_up beside the same 64 of W_gate in one tile. The products of
// TF_FLUSH k-tiles at a time are summed by the tensor cores into tmp,
// then added into acc in f32. The loop is unrolled over those k-tiles so
// that every read of tmp follows its wgmma_wait in straight-line code: a
// run-time flush condition made ptxas inject a wait of its own (C7517:
// "warpgroup.wait is injected ... to allow use of registers defined by
// GMMA"), which kernel_sweep.py prints from the build log.
constexpr int TF_FLUSH = 2;  // k-tiles between the f32 adds into acc
__device__ __forceinline__ void tf_mainloop(uint8_t* ring, TfOperand a,
                                            long long lda, TfOperand b0,
                                            TfOperand b1, long long ldb,
                                            int k_len, float* acc) {
  using S = TfShape;
  static_assert(TF_BM == 128 && TF_BN == 128, "tf_load's 128-row tiles");
  static_assert(TF_FLUSH == 2, "the loop below adds every second tile");
  const int tid = threadIdx.x, wgi = tid / 128;
  const uint32_t ring_s = smem_u32(ring);
  const int nk = (k_len + TF_BK - 1) / TF_BK;
  auto load = [&](int kt) {
    const uint32_t st = ring_s + (kt % S::STAGES) * S::STAGE;
    const int ko = 2 * TF_BK * kt, kl = k_len - TF_BK * kt;
    tf_load<TF_BM>(st, 0, a.p + ko, lda, a.rows, kl, tid);
    tf_load<64>(st + S::AT, 0, b0.p + ko, ldb, b0.rows, kl, tid);
    tf_load<64>(st + S::AT, 64, b1.p + ko, ldb, b1.rows, kl, tid);
  };
#pragma unroll
  for (int s = 0; s < S::STAGES - 2; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  float tmp[TF_BN / 2];
#pragma unroll
  for (int i = 0; i < TF_BN / 2; ++i) acc[i] = tmp[i] = 0.f;
  // this warpgroup's 64 rows of A: 64 lines into each region
  const uint32_t a_wg = wgi * 64 * 128;
  // tile kt's products into tmp (``fresh``: overwriting it); loads run
  // STAGES - 2 tiles ahead: stage kt + STAGES - 2 reuses the stage of kt
  // - 2, whose products every warp waited for before this barrier
  auto tile = [&](int kt, bool fresh) {
    cp_async_wait<S::STAGES - 3>();  // tile kt landed; later ones fly
    fence_proxy_async();
    __syncthreads();  // ... for every thread
    if (kt + S::STAGES - 2 < nk) load(kt + S::STAGES - 2);
    cp_async_commit();
    const uint32_t at = ring_s + (kt % S::STAGES) * S::STAGE + a_wg;
    const uint32_t bt = ring_s + (kt % S::STAGES) * S::STAGE + S::AT;
    wgmma_hold<TF_BN / 2>(tmp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TF_BK / 8; ++ks) {
      // k-step ks: pair block ks / 2 (region), its hi at 32-byte step
      // ks % 2 of the region's line, its lo two steps on
      const int hs = (ks / 2) * 4 + ks % 2;
      const uint64_t ahi = desc_k<TF_BM, TF_C>(at, hs);
      const uint64_t alo = desc_k<TF_BM, TF_C>(at, hs + 2);
      const uint64_t bhi = desc_k<TF_BN, TF_C>(bt, hs);
      const uint64_t blo = desc_k<TF_BN, TF_C>(bt, hs + 2);
      // the small terms first (the first product of a partial sum
      // overwrites tmp), then hi·hi
      wgmma_tf32_128(tmp, alo, bhi, ks > 0 || !fresh);
      wgmma_tf32_128(tmp, ahi, blo, 1);
      wgmma_tf32_128(tmp, ahi, bhi, 1);
    }
    wgmma_commit();
  };
  auto add = [&]() {  // every product landed in tmp: into acc, in f32
    wgmma_wait<0>();
    wgmma_hold<TF_BN / 2>(tmp);
#pragma unroll
    for (int i = 0; i < TF_BN / 2; ++i) acc[i] += tmp[i];
  };
  int kt = 0;
  for (; kt + 1 < nk; kt += 2) {
    tile(kt, true);
    wgmma_wait<1>();  // one group stays in flight while the next issues
    wgmma_hold<TF_BN / 2>(tmp);
    tile(kt + 1, false);
    add();
  }
  if (kt < nk) {
    tile(kt, true);
    add();
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ uint8_t* tf_ring(uint8_t* smem) {
  const uint32_t s = smem_u32(smem);
  return smem + (((s + 1023) & ~1023u) - s);
}
