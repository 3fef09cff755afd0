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
// bf16 design: wgmma fed by TMA (the tensor cores' full rate is reached
// only through wgmma).
//  - Tiles and warpgroups. A block owns a 128 x 256 tile of c; two consumer
//    warpgroups each own 64 x 256 of it with wgmma m64n256k16 (128 f32
//    accumulators a thread), and K is walked 64 deep, one 128-byte-swizzled
//    panel of each operand a k-step.
//  - Ring. One producer warp (lane 0) keeps 4 stages of A and B tiles in
//    flight by TMA through full/empty mbarriers: 48 KB a stage, 192 KB in
//    all, so one block an SM. A consumer releases a stage as soon as the
//    wgmma group of the next k-step is issued and the previous one has
//    retired (wait_group 1), so the tensor cores never wait on a release.
//  - Operands read in place by descriptor, no transposed copy: A row-major
//    [M, K] K-major; A = h^T (the VJP's dB = A^T dY, h row-major [K, M])
//    MN-major (trans-a); B row-major [K, N] MN-major (trans-b); B = w^T
//    (the VJP's dA = dY B^T, w row-major [N, K]) K-major. TMA needs each
//    leading dimension a multiple of 8 and a 16-byte base: the wrapper
//    copies any operand that fails either (no model path gives one) into
//    an aligned buffer first.
//  - Epilogue. Each warpgroup stages its 64 x 256 of c in bf16 in the
//    (by then idle) ring, 128B-swizzled so the stores meet no bank
//    conflict, and one thread writes it out with four TMA stores: whole
//    128-byte lines, where stores straight from the accumulators write
//    16-byte pieces of eight rows each.
//  - Edges. Ragged M, N and K read zeros through TMA's out-of-bounds fill,
//    and the TMA stores clip c's ragged edges; where N is not a multiple
//    of 8 (c's row pitch then does not suit TMA) the epilogue masks
//    stores straight from the accumulators. K = 0 writes zeros.
//  - Tile order: one block a tile, numbered in groups of 8 row tiles so
//    that neighbours share panels of a and b in L2. At the FFN products
//    the grid is 2048 or 256 tiles on 132 SMs, so the last partial wave
//    costs at most 3%. (A persistent block an SM walking every 132nd
//    tile, its producer loading the next tile while the consumers store
//    the last, ran slower at all four FFN products in a bring-up run.)
// f32 design (SIMT FFMA): real f32 (tensor-core TF32 keeps about three
// digits and would not match a full-precision product): 128 x 128 tiles
// walking K through double-buffered shared memory in slices 16 deep, each
// operand staged k-major as [16][128 + 4] by 4-byte cp.async (any
// alignment, zero-filled outside the matrix), each thread an 8 x 8
// micro-tile of accumulators, read from shared memory as float4s at rows
// (and columns) 4t..4t+3 and 64+4t..64+4t+3. The epilogue masks the ragged
// edges of c.
//
// Plain C interface (loaded with ctypes): tiled_matmul returns the CUDA
// error code of the launch (or a CUresult of the tensor-map encoder), 0
// on success. It allocates nothing and launches on the stream it is given.

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace hopper;
using namespace mma_tiles;

using bf16 = __nv_bfloat16;

constexpr int GROUP = 8;  // row tiles a group of blocks shares

// Row tile mt and column tile nt of block pid, in groups of GROUP row tiles.
template <int TM, int TN>
__device__ __forceinline__ void tile_of(int pid, int M, int N, int& mt, int& nt) {
  const int tm = (M + TM - 1) / TM, tn = (N + TN - 1) / TN;
  const int per_group = GROUP * tn;
  const int first = pid / per_group * GROUP;
  const int rows = min(tm - first, GROUP);
  const int in = pid % per_group;
  mt = first + in % rows;
  nt = in / rows;
}

// ---- bf16: wgmma fed by TMA -----------------------------------------------

constexpr int HBM = 128, HBN = 256, HBK = 64;  // c tile of a block, k-step
constexpr int HST = 4;                         // ring stages
constexpr int HCONSUMERS = 256;                // two warpgroups
constexpr int HTHREADS = HCONSUMERS + 32;      // + the producer warp
constexpr int PANEL = 64 * 128;                // one [64][64] bf16 panel
constexpr int A_BYTES = HBM * HBK * 2;         // 16 KB
constexpr int B_BYTES = HBN * HBK * 2;         // 32 KB
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr size_t HSMEM = 1024 + HST * STAGE + 8 * 2 * HST;

// A_KM: a row-major [M][K] (K-major), else a = h^T, h row-major [K][M]
// (MN-major). B_KM: b = w^T, w row-major [N][K] (K-major), else b
// row-major [K][N] (MN-major). The tiles in shared memory: A K-major one
// [128][64] panel (warpgroup g's rows at 8 KB g), A MN-major two [64 k][64
// m] panels (warpgroup g's at panel g); B K-major one [256][64] panel, B
// MN-major four [64 k][64 n] panels.
template <bool A_KM, bool B_KM>
__global__ void __launch_bounds__(HTHREADS, 1)
matmul_bf16_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tc,
                   bf16* __restrict__ c, int M, int N, int K, int tma_store) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + HST * STAGE);
  uint64_t* empty = full + HST;

  const int t = threadIdx.x;
  int mt, nt;
  tile_of<HBM, HBN>(blockIdx.x, M, N, mt, nt);
  const int m0 = mt * HBM, n0 = nt * HBN;
  const int nk = (K + HBK - 1) / HBK;

  if (t == 0) {
    for (int s = 0; s < HST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], HCONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (t >= HCONSUMERS) {
    // Producer warp: lane 0 issues every copy.
    if (t == HCONSUMERS) {
      prefetch_map(&ta);
      prefetch_map(&tb);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % HST, round = kt / HST;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        mbar_expect_tx(&full[st], STAGE);
        unsigned char* as = smem + st * STAGE;
        unsigned char* bs = as + A_BYTES;
        const int k0 = kt * HBK;
        if (A_KM) {
          tma_load_2d(as, &ta, &full[st], k0, m0);
        } else {
          tma_load_2d(as, &ta, &full[st], m0, k0);
          tma_load_2d(as + PANEL, &ta, &full[st], m0 + 64, k0);
        }
        if (B_KM) {
          tma_load_2d(bs, &tb, &full[st], k0, n0);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p)
            tma_load_2d(bs + p * PANEL, &tb, &full[st], n0 + 64 * p, k0);
        }
      }
    }
    return;
  }

  // Consumer warpgroup g owns rows 64 g .. 64 g + 63 of the tile.
  const int g = t / 128, warp = (t % 128) / 32, lane = t % 32;
  const uint32_t base = smem_u32(smem);
  if (tma_store && t == 0) prefetch_map(&tc);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % HST;
    mbar_wait(&full[st], (kt / HST) & 1);
    const uint32_t a = base + st * STAGE, b = a + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HBK / 16; ++kk) {
      const uint64_t da = A_KM ? desc_kmajor(a + g * 8192 + kk * 32)
                               : desc_mnmajor(a + g * PANEL + kk * 2048, PANEL);
      const uint64_t db = B_KM ? desc_kmajor(b + kk * 32)
                               : desc_mnmajor(b + kk * 2048, PANEL);
      Wgmma<256>::ss<A_KM ? 0 : 1, B_KM ? 0 : 1>(acc, da, db, 1);
    }
    wgmma_commit();
    // The previous k-step's group has retired: release its stage.
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % HST]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4j + {0, 1}]: row 16 warp + lane / 4 of the warpgroup's 64,
  // columns n0 + 8j + 2(lane % 4) + {0, 1}; acc[4j + {2, 3}]: 8 rows below.
  if (tma_store) {
    // Through shared memory: warpgroup g's [64, 256] as four 128B-swizzled
    // [64][64] panels (chunk x of row r at chunk x ^ (r % 8), so the eight
    // rows a store instruction writes fall in distinct banks), then four
    // TMA stores, which clip the ragged edges. The ring is free once both
    // warpgroups have retired their last products.
    named_sync(1, HCONSUMERS);
    unsigned char* cs = smem + g * 4 * PANEL;
    const int row = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            cs + (j / 8) * PANEL + (row + 8 * h) * 128 +
            (((j % 8) ^ (lane / 4)) * 16) + (lane % 4) * 4) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    fence_async_smem();
    named_sync(2 + g, 128);
    if (t % 128 == 0) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        tma_store_2d(&tc, cs + p * PANEL, n0 + 64 * p, m0 + 64 * g);
      bulk_commit();
      bulk_wait_read();
    }
    return;
  }
  // N % 8 != 0 (no tensor map of c): masked stores from the accumulators.
  const int r = m0 + 64 * g + 16 * warp + lane / 4;
  const bool pairs = N % 2 == 0;  // then (row * N + col) is even: 4-byte aligned
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= M || col >= N) continue;
      bf16* p = c + static_cast<size_t>(row) * N + col;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        p[0] = __float2bfloat16(v0);
        if (col + 1 < N) p[1] = __float2bfloat16(v1);
      }
    }
  }
}

template <bool A_KM, bool B_KM>
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                int lda, int ldb, cudaStream_t s) {
  CUtensorMap ta, tb, tc = {};
  const int tma_store = N % 8 == 0;  // c's row pitch, as TMA needs it
  int err = A_KM ? make_map(&ta, a, M, K, HBM, lda) : make_map(&ta, a, K, M, 64, lda);
  if (!err)
    err = B_KM ? make_map(&tb, b, N, K, HBN, ldb) : make_map(&tb, b, K, N, 64, ldb);
  if (!err && tma_store) err = make_map(&tc, c, M, N, 64);
  if (err) return err;
  const int grid = ((M + HBM - 1) / HBM) * ((N + HBN - 1) / HBN);
  return static_cast<int>(launch_cluster(matmul_bf16_kernel<A_KM, B_KM>, dim3(grid),
                                         HTHREADS, HSMEM, 1, s, ta, tb, tc,
                                         static_cast<bf16*>(c), M, N, K,
                                         tma_store));
}

// ---- f32 on the SIMT cores ------------------------------------------------

constexpr int THREADS = 256;       // 8 warps
constexpr int BM = 128, BN = 128;  // the c tile of a block
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
  tile_of<BM, BN>(blockIdx.x, M, N, mt, nt);
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
// b[k * ldb + n]; b_t = 1: b[n * ldb + k]. dtype: 0 float32, 1 bfloat16
// (then lda and ldb multiples of 8, a and b 16-byte aligned). K may be 0
// (c is zeroed).
extern "C" int tiled_matmul(const void* a, const void* b, void* c, int M, int N,
                            int K, int lda, int ldb, int a_t, int b_t, int dtype,
                            void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || lda <= 0 || ldb <= 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a_km = !a_t, b_km = b_t != 0;
  if (dtype == 1) {
    if (lda % 8 || ldb % 8 || !aligned16(a) || !aligned16(b))
      return static_cast<int>(cudaErrorInvalidValue);
    if (K == 0)
      return static_cast<int>(cudaMemsetAsync(
          c, 0, static_cast<size_t>(M) * N * sizeof(bf16), s));
    if (a_km)
      return b_km ? launch_bf16<true, true>(a, b, c, M, N, K, lda, ldb, s)
                  : launch_bf16<true, false>(a, b, c, M, N, K, lda, ldb, s);
    return b_km ? launch_bf16<false, true>(a, b, c, M, N, K, lda, ldb, s)
                : launch_bf16<false, false>(a, b, c, M, N, K, lda, ldb, s);
  }
  const int grid = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (a_km)
    return b_km ? launch_f32<true, true>(a, b, c, M, N, K, lda, ldb, grid, s)
                : launch_f32<true, false>(a, b, c, M, N, K, lda, ldb, grid, s);
  return b_km ? launch_f32<false, true>(a, b, c, M, N, K, lda, ldb, grid, s)
              : launch_f32<false, false>(a, b, c, M, N, K, lda, ldb, grid, s);
}
