// Tiled matmul with f32 accumulation, for Hopper (sm_90a).
//
// Replaces k8s_dra_driver_tpu/ops/kernels.py:121, _matmul_kernel (the
// Pallas TPU kernel launched by _tiled_matmul_forward, :136):
//     c[M, N] = a[M, K] @ b[K, N], summed in f32, written in the input dtype
// (f32 or bf16; the wrapper casts mixed inputs up to one dtype first).
// Each operand is read in place either row-major or as the transpose of a
// row-major matrix (a_t, b_t), so the VJP's dY @ B^T and A^T @ dY cost no
// transposed copy.
//
// Bound: operations. At the flagship's FFN shape, [4096, 2048] @ [2048,
// 16384] in bf16, 2*M*N*K = 2.75e11 flops take 0.278 ms at 989 TFLOP/s
// against 0.05 ms for the 168 MB at 3.35 TB/s; [4096, 2048] @ [2048, 2048]
// in f32 is 3.44e10 flops, 0.513 ms at the 67 TFLOP/s of non-tensor f32.
//
// Design. The Pallas kernel held a whole (bm, K) row panel and (K, bn)
// column panel in VMEM. A Hopper block has 227 KB of shared memory, so here
// each block owns a 128 x 128 tile of c and walks K through shared memory
// in double-buffered slices, loaded with cp.async while the previous slice
// is multiplied. Blocks are numbered in groups of 8 row tiles so that
// neighbours share panels of a and b in L2.
//  - bf16: slices 32 deep; 8 warps as 2 x 4, each with a 64 x 32 f32
//    accumulator (64 registers a thread) fed by mma.sync m16n8k16 on
//    ldmatrix fragments. An operand whose k is contiguous is staged as
//    [128][32 + 8] and read with ldmatrix; one whose m or n is contiguous
//    as [32][128 + 8] and read with ldmatrix.trans (the fused-CE backward
//    kernels serve both products of one tile the same way). Row pitches of
//    80 and 272 bytes put the eight rows of each ldmatrix phase in distinct
//    bank groups. Where the leading dimensions are multiples of 8 and the
//    pointers 16-byte aligned, each 16-byte chunk is one cp.async that reads
//    only its part inside the matrix and zero-fills the rest (ragged
//    edges); otherwise (K = 7, say) the edge-safe element-wise loader.
//  - f32: real f32 (tensor-core TF32 keeps about three digits and would
//    not match a full-precision product), so FFMA on the SIMT cores:
//    slices 16 deep, each operand staged k-major as [16][128 + 4] by
//    4-byte cp.async (any alignment, zero-filled outside the matrix), and
//    each thread holds an 8 x 8 micro-tile of accumulators, read from
//    shared memory as float4s at rows (and columns) 4t..4t+3 and
//    64+4t..64+4t+3.
// The epilogue masks the ragged edges of c. wgmma, TMA and deeper
// pipelines come later.
//
// Plain C interface (loaded with ctypes): tiled_matmul returns the CUDA
// error code of the launch, 0 on success. It allocates nothing and
// launches on the stream it is given.

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 128, BN = 128;  // the c tile of a block, both dtypes
constexpr int GROUP = 8;           // row tiles a group of blocks shares

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int BK = 32;
constexpr int WM = 64, WN = 32;            // warp tile; warps 2 (m) x 4 (n)
constexpr int MI = WM / 16, NJ = WN / 16;  // m16 tiles and n16 pairs a warp
constexpr int PAD = 8;                     // bf16 padding of a shared row

// The shared tile of one operand: [128][BK + PAD] when its k is contiguous
// in memory (KC), else [BK][128 + PAD].
template <bool KC>
struct Tile {
  static constexpr int ROWS = KC ? 128 : BK;
  static constexpr int COLS = KC ? BK : 128;
  static constexpr int PITCH = COLS + PAD;
  static constexpr int ELEMS = ROWS * PITCH;
  static constexpr int CHUNKS = ROWS * COLS / 8;  // 16-byte chunks
  static_assert(CHUNKS % THREADS == 0, "whole chunks a thread");
};

// Row tile mt and column tile nt of block pid, in groups of GROUP row tiles.
__device__ __forceinline__ void tile_of(int pid, int M, int N, int& mt, int& nt) {
  const int tm = (M + BM - 1) / BM, tn = (N + BN - 1) / BN;
  const int per_group = GROUP * tn;
  const int first = pid / per_group * GROUP;
  const int rows = min(tm - first, GROUP);
  const int in = pid % per_group;
  mt = first + in % rows;
  nt = in / rows;
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of the row-major matrix
// src [nrows, ncols] (leading dimension ld) -> dst [ROWS][PITCH], zero
// outside the matrix. VEC: ld % 8 == 0 and src 16-byte aligned, so every
// chunk starts aligned and goes by one cp.async of its bytes inside ncols.
template <bool KC, bool VEC>
__device__ __forceinline__ void load_tile(uint16_t* dst,
                                          const uint16_t* __restrict__ src,
                                          int ld, int nrows, int ncols, int r0,
                                          int c0, int tid) {
  using T = Tile<KC>;
  constexpr int CH = T::COLS / 8;
#pragma unroll
  for (int i = 0; i < T::CHUNKS / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CH, c = (idx % CH) * 8;
    const int row = r0 + r, col = c0 + c;
    uint16_t* d = dst + r * T::PITCH + c;
    if (VEC) {
      const int n = row < nrows ? max(0, min(8, ncols - col)) : 0;
      cp_async16_n(d, n ? src + static_cast<size_t>(row) * ld + col : src, n * 2);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (row < nrows && col + e < ncols)
                   ? src[static_cast<size_t>(row) * ld + col + e]
                   : uint16_t(0);
    }
  }
}

size_t bf16_smem_bytes(bool a_kc, bool b_kc) {
  const int a = a_kc ? Tile<true>::ELEMS : Tile<false>::ELEMS;
  const int b = b_kc ? Tile<true>::ELEMS : Tile<false>::ELEMS;
  return 2 * static_cast<size_t>(a + b) * sizeof(uint16_t);  // two stages
}

// A_KC: a is row-major [M][K] (else a row-major [K][M] read as its
// transpose); B_KC: b is a row-major [N][K] read as its transpose (else
// row-major [K][N]).
template <bool A_KC, bool B_KC, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
matmul_bf16_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                   bf16* __restrict__ c, int M, int N, int K, int lda, int ldb) {
  using TA = Tile<A_KC>;
  using TB = Tile<B_KC>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* as = reinterpret_cast<uint16_t*>(smem);  // 2 x TA
  uint16_t* bs = as + 2 * TA::ELEMS;                  // 2 x TB

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Lanes ln(lane);
  int mt, nt;
  tile_of(blockIdx.x, M, N, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;
  const int wm = (warp / 4) * WM, wn = (warp % 4) * WN;

  auto load_stage = [&](int s, int k0) {
    if (A_KC)
      load_tile<true, VEC>(as + s * TA::ELEMS, a, lda, M, K, m0, k0, tid);
    else
      load_tile<false, VEC>(as + s * TA::ELEMS, a, lda, K, M, k0, m0, tid);
    if (B_KC)
      load_tile<true, VEC>(bs + s * TB::ELEMS, b, ldb, N, K, n0, k0, tid);
    else
      load_tile<false, VEC>(bs + s * TB::ELEMS, b, ldb, K, N, k0, n0, tid);
  };

  // acc[i][j]: c rows m0 + wm + 16 i + lane/4 (+8), columns
  // n0 + wn + 8 j + 2(lane%4) (+1).
  float acc[MI][2 * NJ][4] = {};
  const int nk = (K + BK - 1) / BK;
  if (nk > 0) load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    // Slice kt has landed, and every warp is done with slice kt - 1,
    // whose buffer the next load reuses.
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    const uint16_t* at = as + (kt & 1) * TA::ELEMS;
    const uint16_t* bt = bs + (kt & 1) * TB::ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int m = wm + i * 16;
        if (A_KC)
          ldsm_x4(af[i], at + (m + ln.a_m) * TA::PITCH + kk + ln.a_k0);
        else
          ldsm_x4_t(af[i], at + (kk + ln.at_k) * TA::PITCH + m + ln.at_m0);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = wn + j * 16;
        unsigned bf[4];
        if (B_KC)
          ldsm_x4(bf, bt + (n + ln.bn_n) * TB::PITCH + kk + ln.bn_half * 8);
        else
          ldsm_x4_t(bf, bt + (kk + ln.bt_k) * TB::PITCH + n + ln.bt_half * 8);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma16816(acc[i][2 * j], af[i], bf[0], bf[1]);
          mma16816(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }

  const bool pairs = N % 2 == 0;  // then (row * N + col) is even: 4-byte aligned
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + lane / 4 + h * 8;
        const int col = n0 + wn + j * 8 + (lane % 4) * 2;
        if (row >= M || col >= N) continue;
        bf16* p = c + static_cast<size_t>(row) * N + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        } else {
          p[0] = __float2bfloat16(v0);
          if (col + 1 < N) p[1] = __float2bfloat16(v1);
        }
      }
}

template <bool A_KC, bool B_KC, bool VEC>
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                int lda, int ldb, int grid, cudaStream_t s) {
  matmul_bf16_kernel<A_KC, B_KC, VEC>
      <<<grid, THREADS, bf16_smem_bytes(A_KC, B_KC), s>>>(
          static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
          static_cast<bf16*>(c), M, N, K, lda, ldb);
  return static_cast<int>(cudaGetLastError());
}

template <bool A_KC, bool B_KC>
int launch_bf16_vec(bool vec, const void* a, const void* b, void* c, int M,
                    int N, int K, int lda, int ldb, int grid, cudaStream_t s) {
  return vec ? launch_bf16<A_KC, B_KC, true>(a, b, c, M, N, K, lda, ldb, grid, s)
             : launch_bf16<A_KC, B_KC, false>(a, b, c, M, N, K, lda, ldb, grid, s);
}

// ---- f32 on the SIMT cores ------------------------------------------------

constexpr int FBK = 16;
constexpr int FPITCH = 128 + 4;  // 528-byte rows: float4-aligned

// The [FBK k][128 x] slice (k0, x0) of an operand -> dst [FBK][FPITCH],
// zero outside the matrix. KC: src is row-major [nx][K] (src[x * ld + k]);
// else row-major [K][nx] (src[k * ld + x]). Neighbouring threads take
// neighbouring addresses of src.
template <bool KC>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              int ld, int nx, int K, int x0, int k0,
                                              int tid) {
#pragma unroll
  for (int i = 0; i < FBK * 128 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int x = KC ? e / FBK : e % 128;
    const int k = KC ? e % FBK : e / 128;
    const bool ok = x0 + x < nx && k0 + k < K;
    const float* p = KC ? src + static_cast<size_t>(x0 + x) * ld + k0 + k
                        : src + static_cast<size_t>(k0 + k) * ld + x0 + x;
    cp_async4(dst + k * FPITCH + x, ok ? p : src, ok);
  }
}

// One block an SM: 64 accumulators, 16 fragment values and the loaders'
// addresses do not fit the 128 registers two blocks would leave a thread.
template <bool A_KC, bool B_KC>
__global__ void __launch_bounds__(THREADS, 1)
matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int M, int N, int K, int lda, int ldb) {
  __shared__ __align__(16) float as[2][FBK][FPITCH];
  __shared__ __align__(16) float bs[2][FBK][FPITCH];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  int mt, nt;
  tile_of(blockIdx.x, M, N, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;

  auto load_stage = [&](int s, int k0) {
    load_tile_f32<A_KC>(&as[s][0][0], a, lda, M, K, m0, k0, tid);
    load_tile_f32<B_KC>(&bs[s][0][0], b, ldb, N, K, n0, k0, tid);
  };

  // acc[i][j]: c row m0 + 64 (i / 4) + 4 ty + i % 4, column
  // n0 + 64 (j / 4) + 4 tx + j % 4.
  float acc[8][8] = {};
  const int nk = (K + FBK - 1) / FBK;
  if (nk > 0) load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * FBK);
    cp_async_commit();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[s][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[s][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[s][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[s][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  const bool quads = N % 4 == 0;  // then a 4-column group is 16-byte aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      float* p = c + static_cast<size_t>(row) * N + col;
      if (quads && col < N) {
        *reinterpret_cast<float4*>(p) = make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                                                    acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < N) p[e] = acc[i][h * 4 + e];
      }
    }
  }
}

template <bool A_KC, bool B_KC>
int launch_f32(const void* a, const void* b, void* c, int M, int N, int K,
               int lda, int ldb, int grid, cudaStream_t s) {
  matmul_f32_kernel<A_KC, B_KC><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, N, K, lda, ldb);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// c [M, N] row-major = a [M, K] @ b [K, N]. a_t = 0: a row-major with
// leading dimension lda (a[m * lda + k]); a_t = 1: a[k * lda + m]. b_t = 0:
// b[k * ldb + n]; b_t = 1: b[n * ldb + k]. dtype: 0 float32, 1 bfloat16.
// K may be 0 (c is zeroed).
extern "C" int tiled_matmul(const void* a, const void* b, void* c, int M, int N,
                            int K, int lda, int ldb, int a_t, int b_t, int dtype,
                            void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || lda <= 0 || ldb <= 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a_kc = !a_t, b_kc = b_t != 0;
  if (dtype == 1) {
    const bool vec = lda % 8 == 0 && ldb % 8 == 0 && aligned16(a) && aligned16(b);
    if (a_kc)
      return b_kc ? launch_bf16_vec<true, true>(vec, a, b, c, M, N, K, lda, ldb, grid, s)
                  : launch_bf16_vec<true, false>(vec, a, b, c, M, N, K, lda, ldb, grid, s);
    return b_kc ? launch_bf16_vec<false, true>(vec, a, b, c, M, N, K, lda, ldb, grid, s)
                : launch_bf16_vec<false, false>(vec, a, b, c, M, N, K, lda, ldb, grid, s);
  }
  if (a_kc)
    return b_kc ? launch_f32<true, true>(a, b, c, M, N, K, lda, ldb, grid, s)
                : launch_f32<true, false>(a, b, c, M, N, K, lda, ldb, grid, s);
  return b_kc ? launch_f32<false, true>(a, b, c, M, N, K, lda, ldb, grid, s)
              : launch_f32<false, false>(a, b, c, M, N, K, lda, ldb, grid, s);
}
