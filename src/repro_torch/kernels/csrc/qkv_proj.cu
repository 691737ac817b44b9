// qkv_proj: the fused Q/K/V projection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/qkv_proj.py::qkv_proj (_qkv_kernel):
// [q | k | v] = x·[Wq | Wk | Wv] + [bq | bk | bv], f32 accumulation, the
// bias added in f32, one rounding to the output type. The TPU kernel takes
// the three weights concatenated; here they are three operands read in
// place (concatenating them would copy every projection weight on every
// call), and each block picks its operand by its output columns. Outputs
// go straight into three contiguous (M, N_i) tensors, which are the
// model's (B, S, H, Dh) layouts; RoPE stays in the model.
//
// Bound on the H100: at decode (M = num_slots rows) bytes — the weights
// are read once (39.3 MB a layer for mobilevlm-3b in bf16, 11.7 µs at
// 3.35 TB/s); at prefill (M in the hundreds) operations.
// Design:
//   * M <= 4 (decode): a split-N GEMV. A block owns 32 output columns of
//     one operand for every row; its 256 threads split D, each loading 16
//     bytes (8 bf16 / 4 f32 columns) of a weight row at a time against x
//     staged once in shared memory, and the D slices are summed in shared
//     memory in a fixed order. The grid has N / 32 blocks (240 for
//     mobilevlm-3b), so the weight stream spreads over every SM.
//   * M > 4 (prefill): 64 x 64 output tiles over 16-deep shared-memory
//     tiles of x and W, 4 x 4 outputs a thread, f32 FMAs. wgmma/TMA come
//     in a later PR.
// Ragged M and N are masked. Needs N_i * sizeof(T) % 16 == 0 and 16-byte
// aligned weights for the GEMV's vector loads (the wrapper checks).
#include "common.cuh"

constexpr int NT = 256;
constexpr int GV_COLS = 32;  // GEMV: output columns per block
constexpr int GV_MMAX = 4;   // GEMV: rows
constexpr int BM = 64, BN = 64, BK = 16;  // GEMM tiles

struct QkvArgs {
  const void* x;
  const void* w[3];  // (D, n[i]) row-major
  const void* b[3];  // (n[i],) or null
  void* o[3];        // (M, n[i]) row-major
  int n[3];
  int M, D;
};

// The operand whose column tiles of width ``bn`` hold block column ``bx``;
// ``bx`` becomes the tile index within that operand.
__device__ __forceinline__ int pick_operand(const QkvArgs& a, int bn,
                                            int& bx) {
  int op = 0;
  for (; op < 2; ++op) {
    const int t = (a.n[op] + bn - 1) / bn;
    if (bx < t) break;
    bx -= t;
  }
  return op;
}

template <typename T>
__global__ void __launch_bounds__(NT) qkv_gemv_kernel(QkvArgs a) {
  constexpr int VK = 16 / sizeof(T);  // columns per 16-byte load
  constexpr int CV = GV_COLS / VK;    // loads per row segment
  constexpr int NS = NT / CV;         // D slices
  extern __shared__ float smem[];
  float* xs = smem;                   // M x D
  float* red = xs + a.M * a.D;        // NS x GV_MMAX x GV_COLS
  int bx = blockIdx.x;
  const int op = pick_operand(a, GV_COLS, bx);
  const int N = a.n[op], col0 = bx * GV_COLS, tid = threadIdx.x;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w[op]);
  for (int i = tid; i < a.M * a.D; i += NT) xs[i] = to_f32(x[i]);
  __syncthreads();
  const int cv = tid % CV, sl = tid / CV;
  const int c = col0 + cv * VK;  // this thread's first column
  float acc[GV_MMAX][VK];
#pragma unroll
  for (int m = 0; m < GV_MMAX; ++m)
#pragma unroll
    for (int e = 0; e < VK; ++e) acc[m][e] = 0.f;
  if (c < N) {  // N % VK == 0: the whole vector is in the row
#pragma unroll 4
    for (int d = sl; d < a.D; d += NS) {
      float wv[VK];
      load16_f32(w + (long long)d * N + c, wv);
#pragma unroll
      for (int m = 0; m < GV_MMAX; ++m) {
        if (m < a.M) {
          const float xv = xs[m * a.D + d];
#pragma unroll
          for (int e = 0; e < VK; ++e) acc[m][e] += xv * wv[e];
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < GV_MMAX; ++m)
#pragma unroll
    for (int e = 0; e < VK; ++e)
      red[(sl * GV_MMAX + m) * GV_COLS + cv * VK + e] = acc[m][e];
  __syncthreads();
  if (tid < GV_MMAX * GV_COLS) {
    const int m = tid / GV_COLS, cc = tid % GV_COLS, n = col0 + cc;
    if (m < a.M && n < N) {
      float s = 0.f;
      for (int k = 0; k < NS; ++k) s += red[(k * GV_MMAX + m) * GV_COLS + cc];
      if (a.b[op]) s += to_f32(static_cast<const T*>(a.b[op])[n]);
      static_cast<T*>(a.o[op])[(long long)m * N + n] = from_f32<T>(s);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) qkv_gemm_kernel(QkvArgs a) {
  __shared__ float xs[BK][BM + 1];  // x tile, transposed; +1: no conflicts
  __shared__ float ws[BK][BN];
  int bx = blockIdx.x;
  const int op = pick_operand(a, BN, bx);
  const int N = a.n[op], col0 = bx * BN, row0 = blockIdx.y * BM;
  const int M = a.M, D = a.D, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // outputs (ty*4.., tx*4..)
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w[op]);
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
  const T* bias = static_cast<const T*>(a.b[op]);
  T* o = static_cast<T*>(a.o[op]);
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

template <typename T>
static void launch(const QkvArgs& a, cudaStream_t st) {
  if (a.M <= GV_MMAX) {
    int tiles = 0;
    for (int i = 0; i < 3; ++i) tiles += (a.n[i] + GV_COLS - 1) / GV_COLS;
    constexpr int NS = NT / (GV_COLS / (16 / sizeof(T)));
    const size_t smem =
        ((size_t)a.M * a.D + NS * GV_MMAX * GV_COLS) * sizeof(float);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(qkv_gemv_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    qkv_gemv_kernel<T><<<tiles, NT, smem, st>>>(a);
  } else {
    int tiles = 0;
    for (int i = 0; i < 3; ++i) tiles += (a.n[i] + BN - 1) / BN;
    qkv_gemm_kernel<T><<<dim3(tiles, (a.M + BM - 1) / BM), NT, 0, st>>>(a);
  }
}

// x (M, D); wq/wk/wv (D, nq/nk/nv); bq/bk/bv (n,) or null; q/k/v out
// (M, n); all f32 (dtype 0) or all bf16 (dtype 1)
extern "C" int qkv_proj(const void* x, const void* wq, const void* wk,
                        const void* wv, const void* bq, const void* bk,
                        const void* bv, void* q, void* k, void* v, int M,
                        int D, int nq, int nk, int nv, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const QkvArgs a{x, {wq, wk, wv}, {bq, bk, bv}, {q, k, v}, {nq, nk, nv},
                  M, D};
  if (dtype == DT_F32)
    launch<float>(a, st);
  else
    launch<__nv_bfloat16>(a, st);
  return static_cast<int>(cudaGetLastError());
}
