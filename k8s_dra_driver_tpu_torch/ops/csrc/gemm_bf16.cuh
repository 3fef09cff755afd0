// The bf16 matrix product of the port's wgmma GEMM kernels, shared by
// tiled_matmul.cu (its bf16 path), fused_ce_fwd.cu, fused_ce_p.cu,
// fused_ce_dx.cu and fused_ce_dw.cu:
//     c[M, N] = a[M, K] @ b[K, N], bf16 operands, f32 sums,
// where what becomes of a block's f32 tile is the epilogue, a template
// parameter that each kernel supplies.
//
// Design (wgmma fed by TMA; the tensor cores' full rate is reached only
// through wgmma):
//  - Tiles and warpgroups. A block owns a 128 x 256 tile of c; two consumer
//    warpgroups each own 64 x 256 of it with wgmma m64n256k16 (128 f32
//    accumulators a thread), and K is walked 64 deep, one 128-byte-swizzled
//    panel of each operand a k-step.
//  - Ring. One producer thread keeps 4 stages of A and B tiles in flight
//    by TMA through full/empty mbarriers: 48 KB a stage, 192 KB in all, so
//    one block an SM. A consumer releases a stage as soon as the wgmma
//    group of the next k-step is issued and the previous one has retired
//    (wait_group 1), so the tensor cores never wait on a release.
//  - Producer. Epi::PRODUCER threads: a lone warp (nine warps leave a
//    thread at most 168 registers, which the accumulators and a plain
//    store fit), or a warpgroup that hands its registers to the consumers
//    by setmaxnreg (40 against 232 a thread), for an epilogue that needs
//    more.
//  - Operands read in place by descriptor, no transposed copy: A row-major
//    [M, K] K-major (A_KM); A = h^T, h row-major [K, M], MN-major; B
//    row-major [K, N] MN-major; B = w^T, w row-major [N, K], K-major
//    (B_KM). TMA needs each leading dimension a multiple of 16 bytes (8
//    bf16) and a 16-byte base: the callers' wrappers copy any operand that
//    fails either into an aligned buffer first.
//  - Edges. Ragged M, N and K read zeros through TMA's out-of-bounds fill;
//    the epilogue masks or clips c's ragged edges.
//  - Tile order: one block a tile, numbered in groups of 8 row tiles so
//    that neighbours share panels of a and b in L2.
//  - Epilogue. After the mainloop, acc[4j + 2h + e] (j < 32, h, e < 2) of
//    a consumer thread is c's element (Tile::row(h), Tile::col(j) + e):
//    the layout of 32 mma.sync m16n8 C fragments a warp. The epilogue is
//    called with acc, the block's Tile (whose ring is free for staging
//    once both warpgroups have passed named barrier 1), c's tensor map
//    (built only where the epilogue's tma_store is set), M and N. Two
//    bf16 stores come with it: store_tma (staged 128B-swizzled in the
//    ring, four TMA stores a warpgroup: whole 128-byte lines, clipped at
//    c's edges, each value mapped by an optional transform as it is
//    packed) and store_direct (masked stores straight from the
//    accumulators, any row pitch).

#pragma once

#include "hopper.cuh"

namespace gemm {

using namespace hopper;
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

constexpr int BM = 128, BN = 256, BK = 64;  // c tile of a block, k-step
constexpr int STAGES = 4;                   // ring stages
constexpr int CONSUMERS = 256;              // two warpgroups
// Registers a thread with a producer warpgroup, after setmaxnreg:
// 2 x 128 x 232 + 128 x 40 <= 64K.
constexpr int REGS_CONSUMER = 232, REGS_PRODUCER = 40;
constexpr int PANEL = 64 * 128;             // one [64][64] bf16 panel
constexpr int A_BYTES = BM * BK * 2;        // 16 KB
constexpr int B_BYTES = BN * BK * 2;        // 32 KB
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr size_t SMEM = 1024 + STAGES * STAGE + 8 * 2 * STAGES;

// Where a consumer thread's accumulators lie in c.
struct Tile {
  unsigned char* smem;  // the ring (1024-byte aligned)
  int m0, n0;           // the block's tile
  int t, g, warp, lane;
  __device__ __forceinline__ int row(int h) const {
    return m0 + 64 * g + 16 * warp + lane / 4 + 8 * h;
  }
  __device__ __forceinline__ int col(int j) const { return n0 + 8 * j + 2 * (lane % 4); }
};

// The tiles in shared memory: A K-major one [128][64] panel (warpgroup
// g's rows at 8 KB g), A MN-major two [64 k][64 m] panels (warpgroup g's
// at panel g); B K-major one [256][64] panel, B MN-major four [64 k][64
// n] panels.
template <bool A_KM, bool B_KM, class Epi>
__global__ void __launch_bounds__(CONSUMERS + Epi::PRODUCER, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc, const Epi epi, int M, int N,
            int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int t = threadIdx.x;
  int mt, nt;
  tile_of<BM, BN>(blockIdx.x, M, N, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;
  const int nk = (K + BK - 1) / BK;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  constexpr bool GIVE = Epi::PRODUCER == 128;  // a producer warpgroup
  if (t >= CONSUMERS) {
    // Producer: one thread issues every copy; a warpgroup's others only
    // hand their registers to the consumers.
    if (GIVE) setmaxnreg_dec<REGS_PRODUCER>();
    if (t == CONSUMERS) {
      prefetch_map(&ta);
      prefetch_map(&tb);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % STAGES, round = kt / STAGES;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        mbar_expect_tx(&full[st], STAGE);
        unsigned char* as = smem + st * STAGE;
        unsigned char* bs = as + A_BYTES;
        const int k0 = kt * BK;
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

  if (GIVE) setmaxnreg_inc<REGS_CONSUMER>();
  // Consumer warpgroup g owns rows 64 g .. 64 g + 63 of the tile.
  const int g = t / 128, warp = (t % 128) / 32, lane = t % 32;
  const uint32_t base = smem_u32(smem);
  if (epi.tma_store && t == 0) prefetch_map(&tc);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    const uint32_t a = base + st * STAGE, b = a + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
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
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  epi(acc, Tile{smem, m0, n0, t, g, warp, lane}, &tc, M, N);
}

// The identity, the value transform of a plain store.
struct Same {
  __device__ __forceinline__ float operator()(float v, int, int) const { return v; }
};

// bf16 f(acc) through shared memory: warpgroup g's [64, 256] as four
// 128B-swizzled [64][64] panels (chunk x of row r at chunk x ^ (r % 8), so
// the eight rows a store instruction writes fall in distinct banks), then
// four TMA stores into tc, which clip the ragged edges. f(v, h, off) maps
// the accumulator v of row h (Tile::row(h)) at column Tile::col(0) + off,
// each pair as it is packed. The ring is free once both warpgroups have
// retired their last products.
template <class F = Same>
__device__ __forceinline__ void store_tma(const float (&acc)[128], const Tile& tl,
                                          const CUtensorMap* tc, F f = F()) {
  named_sync(1, CONSUMERS);
  unsigned char* cs = tl.smem + tl.g * 4 * PANEL;
  const int row = 16 * tl.warp + tl.lane / 4;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          cs + (j / 8) * PANEL + (row + 8 * h) * 128 +
          (((j % 8) ^ (tl.lane / 4)) * 16) + (tl.lane % 4) * 4) =
          pack_bf16(f(acc[4 * j + 2 * h], h, 8 * j), f(acc[4 * j + 2 * h + 1], h, 8 * j + 1));
  fence_async_smem();
  named_sync(2 + tl.g, 128);
  if (tl.t % 128 == 0) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      tma_store_2d(tc, cs + p * PANEL, tl.n0 + 64 * p, tl.m0 + 64 * tl.g);
    bulk_commit();
    bulk_wait_read();
  }
}

// bf16 c [M, N] with row pitch ldc straight from the accumulators, masked
// at c's edges: for a c whose pitch TMA cannot take.
__device__ __forceinline__ void store_direct(const float (&acc)[128], const Tile& tl,
                                             bf16* c, int ldc, int M, int N) {
  const bool pairs = ldc % 2 == 0;  // then (row * ldc + col) is even: 4-byte aligned
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = tl.col(j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tl.row(h);
      if (row >= M || col >= N) continue;
      bf16* p = c + static_cast<size_t>(row) * ldc + col;
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

// The epilogue of a plain product: bf16 c [M, N], row pitch ldc; by TMA
// where tma_store (ldc a multiple of 8, c 16-byte aligned), else direct.
struct StoreBf16 {
  static constexpr int PRODUCER = 32;
  bf16* c;
  int ldc;
  int tma_store;
  __device__ __forceinline__ void operator()(float (&acc)[128], const Tile& tl,
                                             const CUtensorMap* tc, int M, int N) const {
    if (tma_store) store_tma(acc, tl, tc);
    else store_direct(acc, tl, c, ldc, M, N);
  }
};

// Host: a's map, [M, K] row-major (A_KM) or a = h^T with h [K, M]
// row-major, and b's, b = w^T with w [N, K] row-major (B_KM) or [K, N]
// row-major, as the mainloop reads them; row pitches in elements.
template <bool A_KM>
inline int map_a(CUtensorMap* m, const void* a, int M, int K, int lda) {
  return A_KM ? make_map(m, a, M, K, BM, lda) : make_map(m, a, K, M, 64, lda);
}
template <bool B_KM>
inline int map_b(CUtensorMap* m, const void* b, int N, int K, int ldb) {
  return B_KM ? make_map(m, b, N, K, BN, ldb) : make_map(m, b, K, N, 64, ldb);
}

// Host: c = a @ b (K > 0) with epilogue epi on stream s; c's map over [M,
// N] with row pitch ldc is built where epi.tma_store. Returns a CUresult of
// the map encoder or the CUDA error of the launch, 0 on success.
template <bool A_KM, bool B_KM, class Epi>
int run(const void* a, int lda, const void* b, int ldb, void* c, int ldc, const Epi& epi,
        int M, int N, int K, cudaStream_t s) {
  CUtensorMap ta, tb, tc = {};
  int err = map_a<A_KM>(&ta, a, M, K, lda);
  if (!err) err = map_b<B_KM>(&tb, b, N, K, ldb);
  if (!err && epi.tma_store) err = make_map(&tc, c, M, N, 64, ldc);
  if (err) return err;
  const int grid = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  return static_cast<int>(launch_cluster(gemm_kernel<A_KM, B_KM, Epi>, dim3(grid),
                                         CONSUMERS + Epi::PRODUCER, SMEM, 1, s, ta, tb,
                                         tc, epi, M, N, K));
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace gemm
