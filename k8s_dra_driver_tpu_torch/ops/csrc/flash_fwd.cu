// Causal flash attention forward for Hopper (sm_90a).
//
// Replaces the forward Pallas TPU kernel of the library flash attention
// the reference flagship calls with attention="flash"
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_kernel_single_batch, launched by
// _flash_attention_impl). For each row i of each (batch, head):
//     s[j] = (q[i] . k[j]) * scale, masked where j > i
//     m[i] = max_j s[j],  l[i] = sum_j exp(s[j] - m[i])
//     o[i] = sum_j bf16(exp(s[j] - m)) * v[j] / l[i]        (bf16 out)
// with an online (m, l) over key tiles, p rounded to bf16 before p @ v
// and the sum kept in f32, as the library does; l and m (natural-log
// convention) are saved for the backward kernels. The [S, S] scores never
// reach device memory.
//
// Bound: at the flagship's bench shape (batch 4, 2 heads, S=1024, head_dim
// 1024) the causal half of q k^T and p v is 17.2 GFLOP, 0.017 ms at 989
// TFLOP/s bf16 dense, against 0.020 ms for the 67 MB of q, k, v and o at
// 3.35 TB/s: about balanced. At [1, 16, 8192, 128] it is 0.278 ms of
// operations against 0.040 ms of bytes: the tensor cores bound it.
//
// Design, and why.
//  - Tall tiles. A block owns 64 query rows (one consumer warpgroup, each
//    warp 16 whole rows) and walks the 64-key tiles up to the diagonal.
//    Each K/V tile read from L2 now serves 64 rows, where it served 16.
//  - wgmma. S = Q K^T is wgmma m64n64k16 with Q and K both K-major in
//    128B-swizzled shared memory; O += P V is wgmma m64n{DS}k16 with P
//    from registers (the S accumulator converted to bf16 in place, no
//    shuffle) and V read MN-major (trans-b), so V needs no transposed copy.
//  - Softmax in registers. A thread holds two rows' scores; the row max
//    and row sum are two quad shuffles each, so a key step has no
//    shared-memory reduction and no block barrier. exp2 with scale*log2(e)
//    folded into one FMA; the saved m is converted back to natural log.
//  - TMA ring. One producer warp (lane 0) keeps K/V tiles in flight
//    through 2 stages (3 at 64-column slices) guarded by full/empty
//    mbarriers; Q is loaded once. A warp and not a warpgroup, so
//    setmaxnreg is left out: the registers it could hand over (32
//    threads' worth) are too few to matter, and at DS <= 128 two blocks
//    share an SM instead.
//  - Masking and order. Only the diagonal tile is masked; blocks of the
//    longest rows (the last query tiles) are launched first.
//  - head_dim beyond 256. A [64, D] f32 accumulator at D = 1024 would be
//    the SM's whole register file, so the head_dim is split over the
//    blocks of a thread-block cluster of ceil(D / 256) (4 at D = 1024):
//    each block loads and keeps only its 256-column slice of Q, K, V and O
//    (a ragged last slice reads zeros past D through the TMA box), so no
//    block reads another's K or V. The partial [64, 64] score tiles meet in
//    distributed shared memory as a reduce-scatter and a gather of st.async
//    stores, each thread storing its own 16-byte pieces into the
//    receiver's shared memory, counted on the receiver's mbarrier: warp
//    w's 16 rows belong to rank w % cluster; every rank stores its partial
//    rows there (4 KB a warp), the owner sums the cluster's partials in
//    rank order and runs the softmax for those rows, and stores p (bf16),
//    alpha and l (2.5 KB a warp) into every rank, which rescales and
//    multiplies its own slice of O. At a cluster of 4 a block takes in
//    19.5 KB a step from the others, where an all-read of the partial
//    tiles would take 48 KB; no staging copy and no block barrier. A block
//    rewrites its buffers only after its next exchange has completed,
//    which every rank joins only after reading the last one, so single
//    buffers suffice. At D <= 256 the cluster has one block and nothing
//    is exchanged.
// Slice widths (DS) are instantiated at 64, 128 and 256; a head_dim is
// rounded up to one of them and the extra columns are zeros.
//
// Plain C interface (loaded with ctypes): flash_fwd returns the CUDA error
// code of the launch (or a CUresult of the tensor-map encoder), 0 on
// success. It allocates nothing and launches on the stream it is given.

#include <float.h>
#include <math.h>

#include "hopper.cuh"

extern "C" int flash_fwd_cluster(int D);

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;              // query rows a block
constexpr int BN = 64;              // key rows a step
constexpr int CONSUMERS = 128;      // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int PANEL = 64 * 128;     // bytes of one [64][64] bf16 panel
constexpr int WCH = 32 * 32 * 4;    // a warp's partial scores, f32
constexpr int GCH = 32 * 5 * 16;    // a warp's p, alpha and l (5 uint4 each)
constexpr float LOG2E = 1.4426950408889634f;

template <int DS>
__host__ __device__ constexpr int stages() { return DS >= 128 ? 2 : 3; }

// Warps (of 16 rows) that rank `rank` of `cluster` owns: w % cluster ==
// rank. The exchange buffers: the owned warps' partials from every rank,
// and every warp's gathered p / alpha / l.
__host__ __device__ inline int owned(int cluster) {
  return (4 + cluster - 1) / cluster;
}
__host__ __device__ inline int xbytes(int cluster) {
  return cluster > 1 ? owned(cluster) * cluster * WCH + 4 * GCH : 0;
}

template <int DS>
size_t smem_bytes(int cluster) {
  const size_t tile = static_cast<size_t>(DS / 64) * PANEL;
  return 1024                                  // alignment slack
         + tile * (1 + 2 * stages<DS>())      // q, then k and v a stage
         + xbytes(cluster) + 8 * (1 + 2 * stages<DS>() + 2);  // mbarriers
}

template <int DS>
__global__ void __launch_bounds__(THREADS, DS <= 128 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ l_out, float* __restrict__ m_out, int S,
                 int D, float scale, int cluster) {
  constexpr int NP = DS / 64, ST = stages<DS>(), TILE = NP * PANEL;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* kv = qs + TILE;  // stage s: k at 2s, v at 2s + 1
  const int own = owned(cluster);
  unsigned char* recv = kv + 2 * ST * TILE;       // [slot][rank][8][lane] f4
  unsigned char* gath = recv + own * cluster * WCH;  // [warp][5][lane] uint4
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
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest rows first
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
      mbar_expect_tx(qbar, TILE);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load_2d(qs + p * PANEL, &tq, qbar, col0 + 64 * p, row0 + qt * BM);
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
    cluster_sync();  // no block leaves while another reads its scores
    return;
  }

  // Consumer warpgroup. Thread t holds rows r0 and r0 + 8 of the tile.
  const int warp = t / 32, lane = t % 32, c = lane % 4;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const float sl = scale * LOG2E;
  const uint32_t q_addr = smem_u32(qs);

  float acc[DS / 2];
#pragma unroll
  for (int i = 0; i < DS / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // Only 256-column slices (head_dim > 128) run in clusters, so narrower
  // instantiations compile without the exchange. This warp's rows' softmax
  // runs here (always, without a cluster).
  const int ncl = DS == 256 ? cluster : 1;
  const bool owner = warp % ncl == static_cast<int>(rank);

  mbar_wait(qbar, 0);
  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt % ST;
    const uint32_t k_addr = smem_u32(kv + (2 * st) * TILE);
    const uint32_t v_addr = k_addr + TILE;
    mbar_wait(&full[st], (kt / ST) & 1);

    // S = Q K^T over this block's slice of head_dim.
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk) {
      const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
      Wgmma<64>::ss(s, desc_kmajor(q_addr + off), desc_kmajor(k_addr + off),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // With a cluster, warp w's rows are owned by rank w % cluster: every
    // rank pushes its partial rows there, the owner sums them in rank order
    // and runs the softmax, and every rank gathers p, alpha and l back.
    if (ncl > 1) {
      if (t == 0) {
        const int mine = (4 - static_cast<int>(rank) + cluster - 1) / cluster;
        mbar_expect_tx(recv_bar, mine * cluster * WCH);
        mbar_expect_tx(gath_bar, 4 * GCH);
      }
      unsigned char* slot =
          recv + ((warp / cluster) * cluster + rank) * WCH + lane * 16;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        st_async(slot + i * 512,
                 as_uint4(make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                                      s[4 * i + 3])),
                 recv_bar, warp % cluster);
      mbar_wait(recv_bar, kt & 1);
      if (owner) {
        const float4* rv = reinterpret_cast<const float4*>(recv) +
                           (warp / cluster) * cluster * 8 * 32 + lane;
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        for (int r = 0; r < cluster; ++r)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 v = rv[(r * 8 + i) * 32];
            s[4 * i] += v.x;
            s[4 * i + 1] += v.y;
            s[4 * i + 2] += v.z;
            s[4 * i + 3] += v.w;
          }
      }
    }

    uint32_t pa[4][4];
    float a0 = 1.f, a1 = 1.f;
    if (owner) {
      // Mask the diagonal tile; online softmax over raw scores.
      if (kt == qt) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * c + e;
            if (col > r0) s[4 * j + e] = -INFINITY;
            if (col > r1) s[4 * j + 2 + e] = -INFINITY;
          }
      }
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, w));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, w));
      }
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      a0 = exp2f((m0 - n0) * sl);
      a1 = exp2f((m1 - n1) * sl);
      const float b0 = n0 * sl, b1 = n1 * sl;
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j] = exp2f(fmaf(s[4 * j], sl, -b0));
        s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl, -b0));
        s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl, -b1));
        s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl, -b1));
        y0 += s[4 * j] + s[4 * j + 1];
        y1 += s[4 * j + 2] + s[4 * j + 3];
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        y0 += __shfl_xor_sync(0xffffffffu, y0, w);
        y1 += __shfl_xor_sync(0xffffffffu, y1, w);
      }
      l0 = l0 * a0 + y0;
      l1 = l1 * a1 + y1;
      m0 = n0;
      m1 = n1;
      // P in bf16 as the A operand: k-step kk covers key columns 16kk..+15.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          pa[kk][h] = pack_bf16(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);
    }
    if (ncl > 1) {
      if (owner) {
        unsigned char* g = gath + warp * GCH + lane * 16;
        const uint4 al = make_uint4(__float_as_uint(a0), __float_as_uint(a1),
                                    __float_as_uint(l0), __float_as_uint(l1));
        for (int r = 0; r < cluster; ++r) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            st_async(g + kk * 512,
                     make_uint4(pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]),
                     gath_bar, r);
          st_async(g + 4 * 512, al, gath_bar, r);
        }
      }
      mbar_wait(gath_bar, kt & 1);
      const uint4* gb =
          reinterpret_cast<const uint4*>(gath) + warp * 5 * 32 + lane;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 u = gb[kk * 32];
        pa[kk][0] = u.x;
        pa[kk][1] = u.y;
        pa[kk][2] = u.z;
        pa[kk][3] = u.w;
      }
      const uint4 u = gb[4 * 32];
      a0 = __uint_as_float(u.x);
      a1 = __uint_as_float(u.y);
      l0 = __uint_as_float(u.z);
      l1 = __uint_as_float(u.w);
    }
#pragma unroll
    for (int j = 0; j < DS / 8; ++j) {
      acc[4 * j] *= a0;
      acc[4 * j + 1] *= a0;
      acc[4 * j + 2] *= a1;
      acc[4 * j + 3] *= a1;
    }

    // O += P V, V read MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<DS>::template rs<1>(acc, pa[kk],
                                desc_mnmajor(v_addr + kk * 2048, PANEL), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }

  const int q0 = qt * BM;
  if (owner && c == 0) {
    const size_t row = static_cast<size_t>(row0) + q0;
    l_out[row + r0] = l0;
    l_out[row + r1] = l1;
    m_out[row + r0] = m0 * scale;
    m_out[row + r1] = m1 * scale;
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  bf16* o0 = o + (static_cast<size_t>(row0) + q0 + r0) * D;
  bf16* o1 = o0 + static_cast<size_t>(8) * D;
#pragma unroll
  for (int j = 0; j < DS / 8; ++j) {
    const int col = col0 + 8 * j + 2 * c;
    if (col < D) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(acc[4 * j] * i0, acc[4 * j + 1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * i1, acc[4 * j + 3] * i1);
    }
  }
  cluster_sync();
}

template <int DS>
int launch(const void* q, const void* k, const void* v, void* o, float* l,
           float* m, int BH, int S, int D, float scale, cudaStream_t stream) {
  const int cluster = flash_fwd_cluster(D);
  CUtensorMap tq, tk, tv;
  const uint64_t rows = static_cast<uint64_t>(BH) * S;
  int err = make_map(&tq, q, rows, D, 64);
  if (!err) err = make_map(&tk, k, rows, D, 64);
  if (!err) err = make_map(&tv, v, rows, D, 64);
  if (err) return err;
  const dim3 grid(cluster, BH, S / BM);
  return static_cast<int>(launch_cluster(
      flash_fwd_kernel<DS>, grid, THREADS, smem_bytes<DS>(cluster), cluster,
      stream, tq, tk, tv, static_cast<bf16*>(o), l, m, S, D, scale, cluster));
}

}  // namespace

// Cluster size (blocks a query tile) at head_dim D: 1 up to 256.
extern "C" int flash_fwd_cluster(int D) {
  return D <= 128 ? 1 : (D + 255) / 256;
}

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* l, float* m, int BH, int S, int D, float scale,
                         void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || S % BM || S / BM > 65535 ||
      D <= 0 || D % 16 || D > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(q, k, v, o, l, m, BH, S, D, scale, s);
  if (D <= 128) return launch<128>(q, k, v, o, l, m, BH, S, D, scale, s);
  return launch<256>(q, k, v, o, l, m, BH, S, D, scale, s);
}
