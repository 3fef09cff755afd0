// Causal flash attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the dkv Pallas TPU kernel of the library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_dkv_kernel, launched by _flash_attention_bwd_dkv).
// With l and m saved by the forward, di[i] = sum(o[i] * do[i]) and do the
// upstream gradient, for each key row j:
//     p[i]  = exp(s[i, j] - m[i]) * (1 / l[i])     (s as in the forward)
//     ds[i] = (do[i] . v[j] - di[i]) * p[i] * scale
//     dv[j] = sum_{i >= j} bf16(p[i]) * do[i]                  (bf16 out)
//     dk[j] = sum_{i >= j} bf16(ds[i]) * q[i]                  (bf16 out)
// with the sums in f32, as the library does. Deterministic, no atomics.
//
// Bound: at the flagship's bench shape (batch 4, 2 heads, S=1024, head_dim
// 1024) the causal half of q k^T, do v^T, p^T do and ds^T q is 34.4
// GFLOP, 0.035 ms at 989 TFLOP/s bf16 dense, against 0.030 ms for the
// 101 MB of q, k, v, do, dk and dv at 3.35 TB/s; at [1, 16, 8192, 128]
// 0.556 ms of operations against 0.060 ms of bytes.
//
// Design, and why.
//  - Tall tiles. A block owns 64 key rows (one consumer warpgroup, each
//    warp 16 whole key rows) with its K and V slices resident in shared
//    memory, and walks the 64-row query tiles from the diagonal down. Each
//    Q/dO tile read from L2 serves 64 key rows, where it served 16.
//  - wgmma in the key-row orientation. S^T = K Q^T and dP^T = V dO^T are
//    wgmma m64n64k16 with both operands K-major, so each thread holds whole
//    key rows' entries of p^T and ds^T. They are formed element by element
//    in registers (a thread's 16 query columns read their l, m and di from
//    shared memory), converted to bf16 in place, and fed as the A operand
//    from registers to dV += P^T dO and dK += dS^T Q (m64n{DS}k16), with dO
//    and Q read MN-major (trans-b) from the same buffers the first products
//    read K-major: no transposed copy.
//  - TMA ring. One producer warp (lane 0) keeps Q and dO tiles in flight
//    through 3 stages guarded by full/empty mbarriers, each stage with
//    the tile's l, m and di (three 256-byte bulk copies). A warp and not a
//    warpgroup, so setmaxnreg is left out (too few registers to move).
//  - Registers. dk and dv together are 2 x 64 x DS f32 in the warpgroup:
//    DS / 2 + DS / 2 = 128 registers a thread at DS = 128, beside the two
//    [64, 64] f32 score tiles (64 more); so one block an SM, and the
//    head_dim is cut into slices of DS = 128 columns (64 up to head_dim 64).
//  - head_dim beyond 128: a thread-block cluster of ceil(D / 128) blocks
//    (8 at head_dim 1024), each with its own slice of K, V, Q, dO, dK and
//    dV; no block reads another's K or V. The partial S^T and dP^T tiles
//    meet as a reduce-scatter and a gather in distributed shared memory:
//    query-column chunk j (8 columns) belongs to rank j % cluster; every
//    thread stores its partial s and dp of chunk j straight into the
//    owner's shared memory (st.async, 4 KB a chunk, counted on the owner's
//    mbarrier), the owner sums all ranks' partials in rank order, forms
//    p^T and ds^T in bf16 and stores them (2 KB a chunk) into every rank.
//    At a cluster of 8 a block takes in 42 KB a step from the others,
//    where an all-read of the two f32 partials would take 224 KB; no
//    staging copy and no block barrier; single buffers suffice, as in
//    flash_fwd.cu. At D <= 128 nothing is exchanged.
//  - Masking and order. Only the diagonal tile is masked; blocks of the
//    longest walks (the first key tiles) are launched first.
//
// Plain C interface (loaded with ctypes): flash_dkv returns the CUDA error
// code of the launch (or a CUresult of the tensor-map encoder), 0 on
// success. It allocates nothing and launches on the stream it is given.

#include <math.h>

#include "hopper.cuh"

extern "C" int flash_dkv_cluster(int D);

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;              // key rows a block
constexpr int BQ = 64;              // query rows a step
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;
constexpr int PANEL = 64 * 128;
constexpr int ST = 3;
constexpr int LMD = 1024;           // l, m, di of a query tile (3 x 256 B)
constexpr int CHUNK = CONSUMERS * 16;  // one float4 (or uint4) a thread
constexpr float LOG2E = 1.4426950408889634f;

// Query-column chunks (of 8) that rank `rank` of `cluster` owns: j with
// j % cluster == rank.
__host__ __device__ inline int owned(int cluster) {
  return (8 + cluster - 1) / cluster;
}
// The exchange buffers: the owned chunks' partials from every rank, and
// every chunk's gathered p^T and ds^T.
__host__ __device__ inline int xbytes(int cluster) {
  return cluster > 1 ? owned(cluster) * cluster * 2 * CHUNK + 8 * CHUNK : 0;
}

template <int DS>
size_t smem_bytes(int cluster) {
  const size_t tile = static_cast<size_t>(DS / 64) * PANEL;
  return 1024 + 2 * tile                           // alignment slack, k, v
         + ST * (2 * tile + LMD)                   // q, do, l/m/di a stage
         + xbytes(cluster) + 8 * (1 + 2 * ST + 2);  // mbarriers
}

// bf16 p^T and ds^T of one thread's entries of query-column chunk j: key
// rows r0 and r1, query columns col and col + 1 (col = 8j + 2c), from the
// summed scores s and dp (in that order: (r0, col), (r0, col + 1),
// (r1, col), (r1, col + 1)). Returns {p r0, p r1, ds r0, ds r1}, each a
// bf16 pair.
__device__ __forceinline__ uint4 probs(float4 s, float4 dp, const float* lmd,
                                       int col, bool diag, int r0, int r1,
                                       float sl, float scale) {
  const float li0 = 1.f / lmd[col], li1 = 1.f / lmd[col + 1];
  const float mb0 = lmd[BQ + col] * LOG2E, mb1 = lmd[BQ + col + 1] * LOG2E;
  const float di0 = lmd[2 * BQ + col], di1 = lmd[2 * BQ + col + 1];
  float p00 = exp2f(fmaf(s.x, sl, -mb0)) * li0;
  float p01 = exp2f(fmaf(s.y, sl, -mb1)) * li1;
  float p10 = exp2f(fmaf(s.z, sl, -mb0)) * li0;
  float p11 = exp2f(fmaf(s.w, sl, -mb1)) * li1;
  if (diag) {  // key row > query column: masked
    if (r0 > col) p00 = 0.f;
    if (r0 > col + 1) p01 = 0.f;
    if (r1 > col) p10 = 0.f;
    if (r1 > col + 1) p11 = 0.f;
  }
  return make_uint4(pack_bf16(p00, p01), pack_bf16(p10, p11),
                    pack_bf16((dp.x - di0) * p00 * scale,
                              (dp.y - di1) * p01 * scale),
                    pack_bf16((dp.z - di0) * p10 * scale,
                              (dp.w - di1) * p11 * scale));
}

template <int DS>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ l, const float* __restrict__ m,
                 const float* __restrict__ di, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int S, int D, float scale,
                 int cluster) {
  constexpr int NP = DS / 64, TILE = NP * PANEL, STAGE = 2 * TILE + LMD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int own = owned(cluster);
  unsigned char* ks = smem;
  unsigned char* vs = ks + TILE;
  unsigned char* stages = vs + TILE;  // stage s: q, do, then l/m/di
  unsigned char* recv = stages + ST * STAGE;  // [own][rank][s, dp][t] f4
  unsigned char* gath = recv + own * cluster * 2 * CHUNK;  // [8][t] uint4
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + ST * STAGE + xbytes(cluster));
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;
  uint64_t* recv_bar = empty + ST;
  uint64_t* gath_bar = recv_bar + 1;

  const int t = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int bh = blockIdx.y;
  const int kt = blockIdx.z;  // the first key tiles walk the longest
  const int nq = S / BQ;
  const int col0 = static_cast<int>(rank) * DS;
  const int row0 = bh * S;

  if (t == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(recv_bar, 1);
    mbar_init(gath_bar, 1);
    fence_mbar_init();
  }
  cluster_sync();

  if (t >= CONSUMERS) {
    if (t == CONSUMERS) {
      mbar_expect_tx(kvbar, 2 * TILE);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load_2d(ks + p * PANEL, &tk, kvbar, col0 + 64 * p, row0 + kt * BK);
        tma_load_2d(vs + p * PANEL, &tv, kvbar, col0 + 64 * p, row0 + kt * BK);
      }
      for (int qi = kt; qi < nq; ++qi) {
        const int n = qi - kt, st = n % ST, round = n / ST;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        mbar_expect_tx(&full[st], 2 * TILE + 3 * BQ * 4);
        unsigned char* qs = stages + st * STAGE;
        unsigned char* dos = qs + TILE;
        float* lmd = reinterpret_cast<float*>(dos + TILE);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load_2d(qs + p * PANEL, &tq, &full[st], col0 + 64 * p,
                      row0 + qi * BQ);
          tma_load_2d(dos + p * PANEL, &tdo, &full[st], col0 + 64 * p,
                      row0 + qi * BQ);
        }
        const size_t row = static_cast<size_t>(row0) + qi * BQ;
        bulk_load(lmd, l + row, BQ * 4, &full[st]);
        bulk_load(lmd + BQ, m + row, BQ * 4, &full[st]);
        bulk_load(lmd + 2 * BQ, di + row, BQ * 4, &full[st]);
      }
    }
    __syncwarp();
    cluster_sync();  // no block leaves while its copies are in flight
    return;
  }

  // Consumer warpgroup. Thread t holds key rows r0 and r0 + 8 of the tile
  // and query columns 8j + 2c + {0, 1} of each step's tile (chunk j).
  const int warp = t / 32, lane = t % 32, c = lane % 4;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const float sl = scale * LOG2E;
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);

  float dka[DS / 2], dva[DS / 2];
#pragma unroll
  for (int i = 0; i < DS / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int qi = kt; qi < nq; ++qi) {
    const int n = qi - kt, st = n % ST;
    unsigned char* qs = stages + st * STAGE;
    const uint32_t q_addr = smem_u32(qs), do_addr = q_addr + TILE;
    const float* lmd = reinterpret_cast<const float*>(qs + 2 * TILE);
    const bool diag = qi == kt;
    mbar_wait(&full[st], (n / ST) & 1);

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk) {
      const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
      Wgmma<64>::ss(s, desc_kmajor(k_addr + off), desc_kmajor(q_addr + off),
                    kk > 0);
      Wgmma<64>::ss(dp, desc_kmajor(v_addr + off), desc_kmajor(do_addr + off),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p^T and ds^T in bf16, as the A operands: k-step kk covers query
    // chunks 2kk (registers 0, 1) and 2kk + 1 (registers 2, 3).
    uint32_t pa[4][4], da[4][4];
    if (cluster == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint4 u = probs(
            make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]),
            make_float4(dp[4 * j], dp[4 * j + 1], dp[4 * j + 2], dp[4 * j + 3]),
            lmd, 8 * j + 2 * c, diag, r0, r1, sl, scale);
        pa[j / 2][2 * (j % 2)] = u.x;
        pa[j / 2][2 * (j % 2) + 1] = u.y;
        da[j / 2][2 * (j % 2)] = u.z;
        da[j / 2][2 * (j % 2) + 1] = u.w;
      }
    } else {
      // Reduce-scatter: chunk j's partial s and dp go to rank j % cluster,
      // which sums all ranks' partials (in rank order) and forms p^T and
      // ds^T there; then every rank gathers the bf16 chunks. Each thread
      // stores its own 16-byte pieces straight into the receiver's shared
      // memory (st.async), counted on the receiver's mbarrier.
      if (t == 0) {
        const int mine = (8 - static_cast<int>(rank) + cluster - 1) / cluster;
        mbar_expect_tx(recv_bar, mine * cluster * 2 * CHUNK);
        mbar_expect_tx(gath_bar, 8 * CHUNK);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        unsigned char* slot =
            recv + ((j / cluster) * cluster + rank) * 2 * CHUNK + t * 16;
        st_async(slot, as_uint4(make_float4(s[4 * j], s[4 * j + 1],
                                            s[4 * j + 2], s[4 * j + 3])),
                 recv_bar, j % cluster);
        st_async(slot + CHUNK,
                 as_uint4(make_float4(dp[4 * j], dp[4 * j + 1], dp[4 * j + 2],
                                      dp[4 * j + 3])),
                 recv_bar, j % cluster);
      }
      mbar_wait(recv_bar, n & 1);
      const float4* rv = reinterpret_cast<const float4*>(recv);
      for (int o = 0; o * cluster + static_cast<int>(rank) < 8; ++o) {
        const int j = o * cluster + rank;
        float4 ss = make_float4(0.f, 0.f, 0.f, 0.f), dd = ss;
        for (int r = 0; r < cluster; ++r) {
          const float4 a = rv[((o * cluster + r) * 2) * CONSUMERS + t];
          const float4 b = rv[((o * cluster + r) * 2 + 1) * CONSUMERS + t];
          ss.x += a.x; ss.y += a.y; ss.z += a.z; ss.w += a.w;
          dd.x += b.x; dd.y += b.y; dd.z += b.z; dd.w += b.w;
        }
        const uint4 u =
            probs(ss, dd, lmd, 8 * j + 2 * c, diag, r0, r1, sl, scale);
        for (int r = 0; r < cluster; ++r)
          st_async(gath + j * CHUNK + t * 16, u, gath_bar, r);
      }
      mbar_wait(gath_bar, n & 1);
      const uint4* g4 = reinterpret_cast<const uint4*>(gath);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint4 u = g4[j * CONSUMERS + t];
        pa[j / 2][2 * (j % 2)] = u.x;
        pa[j / 2][2 * (j % 2) + 1] = u.y;
        da[j / 2][2 * (j % 2)] = u.z;
        da[j / 2][2 * (j % 2) + 1] = u.w;
      }
    }

    // dV += P^T dO, dK += dS^T Q; dO and Q read MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<DS>::template rs<1>(dva, pa[kk],
                                desc_mnmajor(do_addr + kk * 2048, PANEL), 1);
      Wgmma<DS>::template rs<1>(dka, da[kk],
                                desc_mnmajor(q_addr + kk * 2048, PANEL), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    mbar_arrive(&empty[st]);
  }

  const size_t row = static_cast<size_t>(row0) + kt * BK;
  bf16* k0 = dk + (row + r0) * D;
  bf16* k1 = k0 + static_cast<size_t>(8) * D;
  bf16* v0 = dv + (row + r0) * D;
  bf16* v1 = v0 + static_cast<size_t>(8) * D;
#pragma unroll
  for (int j = 0; j < DS / 8; ++j) {
    const int col = col0 + 8 * j + 2 * c;
    if (col < D) {
      *reinterpret_cast<__nv_bfloat162*>(k0 + col) =
          __floats2bfloat162_rn(dka[4 * j], dka[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(k1 + col) =
          __floats2bfloat162_rn(dka[4 * j + 2], dka[4 * j + 3]);
      *reinterpret_cast<__nv_bfloat162*>(v0 + col) =
          __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(v1 + col) =
          __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
  cluster_sync();
}

template <int DS>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* l, const float* m, const float* di, void* dk, void* dv,
           int BH, int S, int D, float scale, cudaStream_t stream) {
  const int cluster = flash_dkv_cluster(D);
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t rows = static_cast<uint64_t>(BH) * S;
  int err = make_map(&tq, q, rows, D, 64);
  if (!err) err = make_map(&tk, k, rows, D, 64);
  if (!err) err = make_map(&tv, v, rows, D, 64);
  if (!err) err = make_map(&tdo, dout, rows, D, 64);
  if (err) return err;
  const dim3 grid(cluster, BH, S / BK);
  return static_cast<int>(launch_cluster(
      flash_dkv_kernel<DS>, grid, THREADS, smem_bytes<DS>(cluster), cluster,
      stream, tq, tk, tv, tdo, l, m, di, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, D, scale, cluster));
}

}  // namespace

// Cluster size (blocks a key tile) at head_dim D: 1 up to 128.
extern "C" int flash_dkv_cluster(int D) {
  return D <= 64 ? 1 : (D + 127) / 128;
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* l, const float* m,
                         const float* di, void* dk, void* dv, int BH, int S,
                         int D, float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || S % BQ || S / BK > 65535 ||
      D <= 0 || D % 16 || D > 1024 ||
      (reinterpret_cast<uintptr_t>(l) | reinterpret_cast<uintptr_t>(m) |
       reinterpret_cast<uintptr_t>(di)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<64>(q, k, v, dout, l, m, di, dk, dv, BH, S, D, scale, s);
  return launch<128>(q, k, v, dout, l, m, di, dk, dv, BH, S, D, scale, s);
}
