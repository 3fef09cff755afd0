// Causal flash attention backward, dq, for Hopper (sm_90a).
//
// Replaces the dq Pallas TPU kernel of the library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_dq_kernel, launched by _flash_attention_bwd_dq). With
// l and m saved by the forward, di[i] = sum(o[i] * do[i]) and do the
// upstream gradient, for each query row i:
//     p[j]  = exp(s[j] - m[i]) * (1 / l[i])      (s as in the forward)
//     ds[j] = (do[i] . v[j] - di[i]) * p[j] * scale
//     dq[i] = sum_{j <= i} bf16(ds[j]) * k[j]                  (bf16 out)
// with the sum in f32, as the library does. The library's ds output exists
// only with an attention bias, which the flagship never passes.
// Deterministic, no atomics.
//
// Bound: at the flagship's bench shape (batch 4, 2 heads, S=1024, head_dim
// 1024) the causal half of q k^T, do v^T and ds k is 25.8 GFLOP, 0.026 ms
// at 989 TFLOP/s bf16 dense, against 0.025 ms for the 84 MB of q, k, v,
// do, dq and the row statistics at 3.35 TB/s; at [1, 16, 8192, 128]
// 0.417 ms of operations against 0.050 ms of bytes.
//
// Design, and why: the row orientation of flash_fwd.cu with the exchange
// of flash_dkv.cu.
//  - Tall tiles. A block owns 64 query rows of one (batch, head) (one
//    consumer warpgroup, each warp 16 whole rows) with its Q and dO slices
//    resident in shared memory (loaded once by TMA) and its rows' l, m and
//    di in registers, and walks the 64-row key tiles up to the diagonal.
//    Each K/V tile read from L2 serves 64 query rows, where it served 16.
//  - wgmma. S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both
//    operands K-major, so each thread holds whole query rows' entries of s
//    and dp. p = exp2(s scale log2(e) - m log2(e)) (1 / l) and ds = (dp -
//    di) p scale are formed in registers (only the diagonal tile is
//    masked), ds is converted to bf16 in place and fed as the A operand
//    from registers to dQ += dS K (m64n{DS}k16), with K read MN-major
//    (trans-b) from the buffer S read K-major: no transposed copy.
//  - TMA ring. One producer warp (lane 0) keeps K and V tiles in flight
//    through full/empty mbarriers: 3 stages at 64-column slices, 2 at 128
//    (two blocks an SM) and 256 (one block an SM). A warp and not a
//    warpgroup, so setmaxnreg is left out, as in the other two flash
//    kernels.
//  - Registers and the head_dim split. The dQ accumulator is 64 x DS f32
//    in the warpgroup, DS / 2 registers a thread beside the two [64, 64]
//    f32 score tiles (64): slices of DS = 64, 128 or 256 columns, as in
//    flash_fwd.cu. At 256 ptxas fits the exchange in 255 registers (223
//    without it) with no spill, so a head_dim of 1024 is a cluster of 4,
//    where slices of 128 (flash_dkv.cu's) would make it 8: half the
//    blocks, each with twice the products between two exchanges.
//  - head_dim beyond 256: a thread-block cluster of ceil(D / 256) blocks,
//    each with its own slice of Q, dO, K, V and dQ; no block reads
//    another's K or V. The partial S and dP tiles meet as a reduce-scatter
//    and a gather in distributed shared memory: key-column chunk j (8
//    columns) belongs to rank j % cluster; every other rank stores its
//    partial s and dp of chunk j straight into the owner's shared memory
//    (st.async, 4 KB a chunk, counted on the owner's mbarrier), the owner
//    sums all ranks' partials (its own from registers) in rank order, so
//    every rank gets the same bits, forms ds in bf16 and stores it (1 KB
//    a chunk: dq needs no p, so half of flash_dkv.cu's gather) into every
//    rank. At a cluster of 4 a block takes in 30 KB a step from the
//    others; no staging copy and no block barrier, and single buffers
//    suffice, as in flash_dkv.cu. Keeping the owner's own partial out of
//    its buffer is what fits the 256-column slice in shared memory (225
//    KB at a cluster of 4). At D <= 256 nothing is exchanged and the
//    exchange is not compiled.
//  - Order. Blocks of the longest walks (the last query tiles) launch
//    first.
//
// Plain C interface (loaded with ctypes): flash_dq returns the CUDA error
// code of the launch (or a CUresult of the tensor-map encoder), 0 on
// success. It allocates nothing and launches on the stream it is given.

#include <math.h>

#include "hopper.cuh"

extern "C" int flash_dq_cluster(int D);

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;              // query rows a block
constexpr int BN = 64;              // key rows a step
constexpr int CONSUMERS = 128;      // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int PANEL = 64 * 128;     // bytes of one [64][64] bf16 panel
constexpr int CHUNK = CONSUMERS * 16;   // one float4 a thread
constexpr int GCHUNK = CONSUMERS * 8;   // one bf16 ds pair of pairs a thread
constexpr float LOG2E = 1.4426950408889634f;

template <int DS>
__host__ __device__ constexpr int stages() {
  return DS == 64 ? 3 : 2;
}

// Key-column chunks (of 8) that rank `rank` of `cluster` owns: j with
// j % cluster == rank.
__host__ __device__ inline int owned(int cluster) {
  return (8 + cluster - 1) / cluster;
}
// The exchange buffers: the owned chunks' partials from every other rank
// (an owner keeps its own in registers), and every chunk's gathered ds.
__host__ __device__ inline int xbytes(int cluster) {
  return cluster > 1 ? owned(cluster) * (cluster - 1) * 2 * CHUNK + 8 * GCHUNK
                     : 0;
}

template <int DS>
size_t smem_bytes(int cluster) {
  const size_t tile = static_cast<size_t>(DS / 64) * PANEL;
  return 1024 + 2 * tile                      // alignment slack, q, do
         + 2 * stages<DS>() * tile            // k and v a stage
         + xbytes(cluster) + 8 * (1 + 2 * stages<DS>() + 2);  // mbarriers
}

// The saved statistics of a thread's two query rows: m log2(e), 1 / l, di.
struct RowStats {
  float mb0, mb1, li0, li1, di0, di1;
};

// bf16 ds of one thread's entries of key-column chunk j: query rows r0
// and r1, key columns col and col + 1 (col = 8j + 2c), from the summed
// scores s and dp (in that order: (r0, col), (r0, col + 1), (r1, col),
// (r1, col + 1)). Returns {ds r0, ds r1}, each a bf16 pair.
__device__ __forceinline__ uint2 dscores(float4 s, float4 dp, const RowStats& w,
                                         int col, bool diag, int r0, int r1,
                                         float sl, float scale) {
  float p00 = exp2f(fmaf(s.x, sl, -w.mb0)) * w.li0;
  float p01 = exp2f(fmaf(s.y, sl, -w.mb0)) * w.li0;
  float p10 = exp2f(fmaf(s.z, sl, -w.mb1)) * w.li1;
  float p11 = exp2f(fmaf(s.w, sl, -w.mb1)) * w.li1;
  if (diag) {  // key column > query row: masked
    if (col > r0) p00 = 0.f;
    if (col + 1 > r0) p01 = 0.f;
    if (col > r1) p10 = 0.f;
    if (col + 1 > r1) p11 = 0.f;
  }
  return make_uint2(pack_bf16((dp.x - w.di0) * p00 * scale,
                              (dp.y - w.di0) * p01 * scale),
                    pack_bf16((dp.z - w.di1) * p10 * scale,
                              (dp.w - w.di1) * p11 * scale));
}

template <int DS, bool CL>
__global__ void __launch_bounds__(THREADS, DS == 256 ? 1 : 2)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ l, const float* __restrict__ m,
                const float* __restrict__ di, bf16* __restrict__ dq, int S,
                int D, float scale, int cluster) {
  constexpr int NP = DS / 64, ST = stages<DS>(), TILE = NP * PANEL;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* dos = qs + TILE;
  unsigned char* kv = dos + TILE;  // stage s: k at 2s, v at 2s + 1
  const int own = owned(cluster);
  unsigned char* recv = kv + 2 * ST * TILE;  // [own][sender][s, dp][t] f4
  unsigned char* gath = recv + own * (cluster - 1) * 2 * CHUNK;  // [8][t] uint2
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(kv + 2 * ST * TILE + xbytes(cluster));
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;
  uint64_t* recv_bar = empty + ST;
  uint64_t* gath_bar = recv_bar + 1;

  const int t = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int bh = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest walks first
  const int col0 = static_cast<int>(rank) * DS;
  const int row0 = bh * S;

  if (t == 0) {
    mbar_init(qbar, 1);
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
    // Producer warp: lane 0 issues every copy.
    if (t == CONSUMERS) {
      mbar_expect_tx(qbar, 2 * TILE);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load_2d(qs + p * PANEL, &tq, qbar, col0 + 64 * p, row0 + qt * BM);
        tma_load_2d(dos + p * PANEL, &tdo, qbar, col0 + 64 * p, row0 + qt * BM);
      }
      for (int kt = 0; kt <= qt; ++kt) {
        const int st = kt % ST, round = kt / ST;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        mbar_expect_tx(&full[st], 2 * TILE);
        unsigned char* ks = kv + (2 * st) * TILE;
        unsigned char* vs = ks + TILE;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load_2d(ks + p * PANEL, &tk, &full[st], col0 + 64 * p,
                      row0 + kt * BN);
          tma_load_2d(vs + p * PANEL, &tv, &full[st], col0 + 64 * p,
                      row0 + kt * BN);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no block leaves while another stores into it
    return;
  }

  // Consumer warpgroup. Thread t holds query rows r0 and r0 + 8 of the
  // tile and key columns 8j + 2c + {0, 1} of each step's tile (chunk j).
  const int warp = t / 32, lane = t % 32, c = lane % 4;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const float sl = scale * LOG2E;
  const size_t row = static_cast<size_t>(row0) + qt * BM;
  const RowStats w = {m[row + r0] * LOG2E,  m[row + r1] * LOG2E,
                      1.f / l[row + r0],    1.f / l[row + r1],
                      di[row + r0],         di[row + r1]};
  const uint32_t q_addr = smem_u32(qs), do_addr = q_addr + TILE;

  float acc[DS / 2];
#pragma unroll
  for (int i = 0; i < DS / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt % ST;
    const uint32_t k_addr = smem_u32(kv + (2 * st) * TILE);
    const uint32_t v_addr = k_addr + TILE;
    const bool diag = kt == qt;
    mbar_wait(&full[st], (kt / ST) & 1);

    // S = Q K^T and dP = dO V^T over this block's slice of head_dim.
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk) {
      const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
      Wgmma<64>::ss(s, desc_kmajor(q_addr + off), desc_kmajor(k_addr + off),
                    kk > 0);
      Wgmma<64>::ss(dp, desc_kmajor(do_addr + off), desc_kmajor(v_addr + off),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // ds in bf16, as the A operand: k-step kk covers key chunks 2kk
    // (registers 0, 1) and 2kk + 1 (registers 2, 3).
    uint32_t da[4][4];
    if constexpr (!CL) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 u = dscores(
            make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]),
            make_float4(dp[4 * j], dp[4 * j + 1], dp[4 * j + 2], dp[4 * j + 3]),
            w, 8 * j + 2 * c, diag, r0, r1, sl, scale);
        da[j / 2][2 * (j % 2)] = u.x;
        da[j / 2][2 * (j % 2) + 1] = u.y;
      }
    } else {
      // Reduce-scatter: chunk j's partial s and dp go to rank j % cluster,
      // which sums all ranks' partials (in rank order) and forms ds there;
      // then every rank gathers the bf16 chunks. Each thread stores its
      // own pieces straight into the receiver's shared memory (st.async),
      // counted on the receiver's mbarrier; an owner keeps its own partial
      // in registers. Sender r's slot at owner o is r, or r - 1 past o.
      const int me = static_cast<int>(rank);
      if (t == 0) {
        const int mine = (8 - me + cluster - 1) / cluster;
        mbar_expect_tx(recv_bar, mine * (cluster - 1) * 2 * CHUNK);
        mbar_expect_tx(gath_bar, 8 * GCHUNK);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = j % cluster;
        if (o == me) continue;
        unsigned char* slot =
            recv + ((j / cluster) * (cluster - 1) + me - (me > o)) * 2 * CHUNK +
            t * 16;
        st_async(slot, as_uint4(make_float4(s[4 * j], s[4 * j + 1],
                                            s[4 * j + 2], s[4 * j + 3])),
                 recv_bar, o);
        st_async(slot + CHUNK,
                 as_uint4(make_float4(dp[4 * j], dp[4 * j + 1], dp[4 * j + 2],
                                      dp[4 * j + 3])),
                 recv_bar, o);
      }
      mbar_wait(recv_bar, kt & 1);
      const float4* rv = reinterpret_cast<const float4*>(recv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j % cluster != me) continue;
        const float4 s_own =
            make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
        const float4 dp_own =
            make_float4(dp[4 * j], dp[4 * j + 1], dp[4 * j + 2], dp[4 * j + 3]);
        const float4* from = rv + (j / cluster) * (cluster - 1) * 2 * CONSUMERS + t;
        float4 ss = make_float4(0.f, 0.f, 0.f, 0.f), dd = ss;
        for (int r = 0; r < cluster; ++r) {
          const int x = r - (r > me);
          const float4 a = r == me ? s_own : from[2 * x * CONSUMERS];
          const float4 b = r == me ? dp_own : from[(2 * x + 1) * CONSUMERS];
          ss.x += a.x; ss.y += a.y; ss.z += a.z; ss.w += a.w;
          dd.x += b.x; dd.y += b.y; dd.z += b.z; dd.w += b.w;
        }
        const uint2 u =
            dscores(ss, dd, w, 8 * j + 2 * c, diag, r0, r1, sl, scale);
        for (int r = 0; r < cluster; ++r)
          st_async(gath + j * GCHUNK + t * 8, u, gath_bar, r);
      }
      mbar_wait(gath_bar, kt & 1);
      const uint2* g2 = reinterpret_cast<const uint2*>(gath);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 u = g2[j * CONSUMERS + t];
        da[j / 2][2 * (j % 2)] = u.x;
        da[j / 2][2 * (j % 2) + 1] = u.y;
      }
    }

    // dQ += dS K, K read MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<DS>::template rs<1>(acc, da[kk],
                                desc_mnmajor(k_addr + kk * 2048, PANEL), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }

  bf16* q0 = dq + (row + r0) * D;
  bf16* q1 = q0 + static_cast<size_t>(8) * D;
#pragma unroll
  for (int j = 0; j < DS / 8; ++j) {
    const int col = col0 + 8 * j + 2 * c;
    if (col < D) {
      *reinterpret_cast<__nv_bfloat162*>(q0 + col) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(q1 + col) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  cluster_sync();
}

template <int DS, bool CL>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* l, const float* m, const float* di, void* dq, int BH,
           int S, int D, float scale, cudaStream_t stream) {
  const int cluster = flash_dq_cluster(D);
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t rows = static_cast<uint64_t>(BH) * S;
  int err = make_map(&tq, q, rows, D, 64);
  if (!err) err = make_map(&tk, k, rows, D, 64);
  if (!err) err = make_map(&tv, v, rows, D, 64);
  if (!err) err = make_map(&tdo, dout, rows, D, 64);
  if (err) return err;
  const dim3 grid(cluster, BH, S / BM);
  return static_cast<int>(launch_cluster(
      flash_dq_kernel<DS, CL>, grid, THREADS, smem_bytes<DS>(cluster),
      cluster, stream, tq, tk, tv, tdo, l, m, di, static_cast<bf16*>(dq), S,
      D, scale, cluster));
}

}  // namespace

// Cluster size (blocks a query tile) at head_dim D: 1 up to 256.
extern "C" int flash_dq_cluster(int D) {
  return D <= 256 ? 1 : (D + 255) / 256;
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* l, const float* m,
                        const float* di, void* dq, int BH, int S, int D,
                        float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || S % BM || S / BM > 65535 ||
      D <= 0 || D % 16 || D > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<64, false>(q, k, v, dout, l, m, di, dq, BH, S, D, scale, s);
  if (D <= 128)
    return launch<128, false>(q, k, v, dout, l, m, di, dq, BH, S, D, scale, s);
  if (D <= 256)
    return launch<256, false>(q, k, v, dout, l, m, di, dq, BH, S, D, scale, s);
  return launch<256, true>(q, k, v, dout, l, m, di, dq, BH, S, D, scale, s);
}
