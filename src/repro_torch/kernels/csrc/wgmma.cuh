// Tensor-core building blocks shared by the port's bf16 Hopper kernels.
//
// Hopper's tensor cores are reached through warpgroup MMAs (wgmma): the
// four warps of a warpgroup together issue an asynchronous bf16 x bf16 ->
// f32 product of a 64-row tile, B read from shared memory through a
// 64-bit descriptor, A from shared memory or from registers. This header
// holds what `attn_stream.cu`, `qkv_proj.cu` and the FFN kernels' prefill
// (`ffn_act.cuh`) build their products from:
//   * `cp_async16`: a 16-byte global -> shared copy (cp.async, zero-filled
//     past the operand's edge), so a tile's load overlaps the products of
//     the one before it; `load_tile` fills a whole swizzled tile with it;
//   * the swizzled shared-memory tile layout and its wgmma descriptors,
//     K-major (`desc_k`) and MN-major (`desc_mn`);
//   * `Wgmma<N>::ss` / `::rs`: m64nNk16 with A from shared memory (N = 64,
//     128) or from registers (N = 16, 32, 64, 128), and the fence / commit
//     / wait helpers that order them.
//
// Its users replace the TPU kernels repro/kernels/attn_stream.py::
// attn_stream, repro/kernels/qkv_proj.py::qkv_proj (prefill) and
// repro/kernels/ffn_act.py::ffn_act / ffn_act_int8 (prefill). On the
// H100 their products at serving shapes are a few GFLOP over a few MB:
// scalar f32 FMAs made them issue-bound (one FMA an operand pair), and
// synchronous loads through registers left every load exposed. wgmma
// takes the products off the CUDA cores (989 TFLOP/s bf16) and cp.async
// keeps the next tiles' loads in flight under them, so what remains is
// the bytes and the latency of a short dependency chain.
//
// Tile layout. A tile of R rows by C bf16 columns is stored as C / 64
// regions of 64 columns, then, where C % 64 is 16 or 32 (head dims 16,
// 32, 160), one region of the C % 64 columns left; each region is R rows
// of ROWB bytes (128, or 2 * (C % 64) for the last). Inside a region the
// 16-byte chunk j of row r sits at chunk j ^ (r % 8) (128-byte swizzle;
// for 64- and 32-byte rows the 64B / 32B swizzle on the same
// byte-address bits), the layout TMA's swizzle modes write and wgmma
// reads. Every region starts 1024-byte aligned (R a multiple of 8), and
// the tile is exactly R * C * 2 bytes: a head dim of 160 is two 128B
// panels and one 64B panel, never padded to 192. The same stored tile
// serves as a K-major operand (rows = M or N, columns = K: Q, K, x) or as
// an MN-major one (rows = K, columns = N: V, W); an MN-major product
// wider than one region's columns is issued a region group at a time
// (`desc_mn_at`).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async -------------------------------------------------------------
// 16 bytes from global ``src`` to shared ``dst``; ``bytes`` < 16 zero-fills
// the rest (0: the whole chunk is zeros and nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's completed shared-memory writes visible to the async
// proxy that wgmma reads its shared operands through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- tile layout ----------------------------------------------------------
// bytes of one row of region ``k`` (64 columns each) of a tile ``C``
// columns wide: 128 for a whole region, 2 * (C % 64) for the last part one
__host__ __device__ constexpr int tile_rowb(int C, int k = 0) {
  return k < C / 64 ? 128 : 2 * (C % 64);
}
__host__ __device__ constexpr int tile_bytes(int R, int C) { return R * C * 2; }
// the swizzle modes wgmma reads: 128-, 64- or 32-byte rows
__host__ __device__ constexpr bool tile_ok(int R, int C) {
  return R % 8 == 0 && C % 16 == 0 && (C % 64 == 0 || C % 64 == 16 ||
                                       C % 64 == 32);
}

// byte offset of 16-byte chunk ``cj`` (columns 8cj..8cj+7) of row ``r`` in
// a tile of R rows by C columns
template <int R, int C>
__device__ __forceinline__ uint32_t tile_offset(int r, int cj) {
  static_assert(tile_ok(R, C), "tile shape");
  const int k = cj / 8;  // the region: 8 chunks (128 bytes) a whole one
  const int rowb = tile_rowb(C, k);
  const uint32_t lin = r * rowb + (cj % 8) * 16;
  // 128B / 64B / 32B swizzle: chunk bits [4, 4 + log2(CPR)) ^= bits [7, ..)
  return k * (R * 128) + (lin ^ ((lin >> 3) & (rowb - 16)));
}

// Fill a tile of R rows by C columns from global rows ``src + r * stride``
// (elements; each row 16-byte aligned). Rows >= ``rows`` and columns >=
// ``cols`` (a multiple of 8) are zero-filled. Each of ``nt`` threads
// issues its share of 16-byte cp.asyncs; the caller commits and waits.
template <int R, int C>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src,
                                          long long stride, int rows,
                                          int cols, int tid, int nt) {
  constexpr int CPR = C / 8;  // chunks a row
#pragma unroll 4
  for (int i = tid; i < R * CPR; i += nt) {
    const int r = i / CPR, cj = i % CPR;
    const bool ok = r < rows && cj * 8 < cols;
    const __nv_bfloat16* g = ok ? src + r * stride + cj * 8 : src;
    cp_async16(tile + tile_offset<R, C>(r, cj), g, ok ? 16 : 0);
  }
}

// ---- descriptors ----------------------------------------------------------
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int rowb) {
  const uint64_t swz = rowb == 128 ? 1 : rowb == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (swz << 62);
}

// K-major operand (rows = M or N, columns = K) of a tile of R rows by C
// columns: the 16-deep k-step ``ks``. Inside a region a k-step is a 32-byte
// step of the start address (the hardware applies the swizzle to the
// address it forms); 8-row groups are ROWB * 8 bytes apart.
template <int R, int C>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  const int kb = ks * 32, k = kb / 128;  // k: the region holding the step
  const int rowb = tile_rowb(C, k);
  return make_desc(tile + k * (R * 128) + kb % 128, 16, 8 * rowb, rowb);
}

// MN-major operand (rows = K, columns = N) of a tile of R rows by C
// columns: k-step ``ks`` covers rows 16ks..16ks+15, columns from region
// ``k`` on (64k..). LBO steps between 64-column regions, SBO between
// 8-row groups; a product's N columns stay inside regions of one row
// width (the whole ones, or the last part one alone).
template <int R, int C>
__device__ __forceinline__ uint64_t desc_mn_at(uint32_t tile, int ks, int k) {
  const int rowb = tile_rowb(C, k);
  return make_desc(tile + k * (R * 128) + ks * 16 * rowb, R * rowb, 8 * rowb,
                   rowb);
}
template <int R, int C>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks) {
  return desc_mn_at<R, C>(tile, ks, 0);
}

// ---- wgmma ordering -------------------------------------------------------
// before the first wgmma, and after registers it reads (accumulators, A
// fragments) were written by other instructions
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the accumulators in registers across the asynchronous products
template <int N>
__device__ __forceinline__ void wgmma_hold(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two floats -> packed bf16x2 (``lo`` in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma m64nNk16, bf16 inputs, f32 accumulators ----------------------
// Accumulator fragment (N / 2 floats a thread): thread t of the warpgroup,
// warp w = t / 32, lane l: d[4c + 2i + e] is row 16w + l/4 + 8i, column
// 8c + 2(l%4) + e. The register A fragment of a 16-deep k-step is the same
// layout over 16 columns packed in bf16 pairs: a[0] = row l/4 cols
// 2(l%4)+{0,1}, a[1] = row l/4+8 same cols, a[2] / a[3] = the same rows at
// cols +8 -- so an accumulator converts to an A operand in place.
// TRANS_B = 0: B is K-major; 1: B is MN-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static constexpr int REGS = 8;
  // D (64 x 16, f32) (+)= A (64 x 16, registers) . B (16 x 16, smem)
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<32> {
  static constexpr int REGS = 16;
  // D (64 x 32, f32) (+)= A (64 x 16, registers) . B (16 x 32, smem)
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<64> {
  static constexpr int REGS = 32;
  // D (64 x 64, f32) (+)= A (64 x 16, smem) . B (16 x 64, smem)
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
  }
  // D (64 x 64, f32) (+)= A (64 x 16, registers) . B (16 x 64, smem)
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<128> {
  static constexpr int REGS = 64;
  // D (64 x 128, f32) (+)= A (64 x 16, smem) . B (16 x 128, smem)
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
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
        : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
  }
  // D (64 x 128, f32) (+)= A (64 x 16, registers) . B (16 x 128, smem)
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TRANS_B));
  }
};
