// Fused unembed + softmax cross-entropy backward, dx, for Hopper (sm_90a).
//
// Replaces k8s_dra_driver_tpu/ops/fused_ce.py:_dx_kernel (the Pallas TPU
// kernel launched by _fused_ce_bwd). With lse saved by the forward and g
// the upstream gradient (one value per token),
//     p[t, v] = (where(v < V, exp(x[t] . w[:, v] - lse[t]), 0)
//                - (v == labels[t])) * g[t]
//     dx[t]   = sum_v p[t, v] * w[:, v]                        (bf16 out)
// without the [T, V] logits or p ever reaching device memory.
//
// Bound: compute. 4*T*D*V flops (the logits recomputed, then p @ w^T)
// against (2*T*D + D*V)*2 + 12*T bytes; at T=4096, D=2048, V=8192 that is
// 275 GFLOP, 0.278 ms at 989 TFLOP/s bf16 dense, against 0.02 ms for the
// 64 MB at 3.35 TB/s.
//
// Design. The Pallas kernel kept a [256, D] f32 accumulator in VMEM across
// the vocab steps of its grid. A Hopper block has 227 KB of shared memory
// and blocks run in no order, so here one block owns 16 token rows, walks
// the whole vocab itself, and keeps its [16, D] f32 accumulator in
// registers: warp k holds the d-fragments f with f % 8 == k (16 for
// D=2048). The block's x rows [16, D] stay in shared memory; each vocab
// step stages the w tile [D, 16] (double-buffered with cp.async, 64 KiB
// at D=2048) and uses it twice: read with ldmatrix.trans as B of the
// logits tile (mma.sync, bf16 in, f32 accumulate, partial sums over each
// warp's d-slice meeting in shared memory), then read plainly, which
// makes it w^T, as B of p @ w^T. No transposed copy of w is made; columns
// >= V are zero-filled and masked out of p. p is rounded to bf16 for that
// product; the sum stays in f32. T=4096 gives 256 blocks, one a SM at a
// time (206 KB of shared memory). w is re-read from L2 by every block.
// wgmma, TMA and larger token tiles come later.
//
// Plain C interface (loaded with ctypes): fused_ce_dx returns the CUDA
// error code of the launch, 0 on success. It allocates nothing and
// launches on the stream it is given.

#include "fused_ce_bwd.cuh"

namespace {

using namespace fused_ce_bwd;

size_t smem_bytes(int dp) {
  return static_cast<size_t>(TILE) * row_pitch(dp) * 2  // x rows
         + 2 * static_cast<size_t>(dp) * TILE * 2        // two w stages
         + TAIL_BYTES;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_ce_dx_kernel(const uint16_t* __restrict__ x,
                   const uint16_t* __restrict__ w,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   bf16* __restrict__ dx, int T, int D, int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nd = (D + TILE - 1) / TILE, dp = nd * TILE, xld = row_pitch(dp);
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);  // [16][xld]
  uint16_t* ws = xs + TILE * xld;                     // 2 x [dp][16]
  float* red = reinterpret_cast<float*>(ws + 2 * dp * TILE);
  bf16* ps = reinterpret_cast<bf16*>(red + WARPS * FRAG);  // [16][PLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Lanes ln(lane);
  const int t0 = blockIdx.x * TILE;
  // This thread's element of every p tile: row tid / 16, column tid % 16.
  const int row = t0 + tid / TILE, col = tid % TILE;
  const bool live = row < T;
  const int label = live ? labels[row] : -1;
  const float row_lse = live ? lse[row] : 0.f;
  const float row_g = live ? g[row] : 0.f;

  load_rows<VEC>(xs, x, t0, T, D, dp, xld, tid);
  load_cols<VEC>(ws, w, 0, D, V, dp, tid);
  cp_async_commit();

  // acc[j][nt]: dx rows t0 + lane/4 (+8), columns 16 f + 8 nt + 2(lane%4) (+1).
  float acc[MAX_FRAGS][2][4] = {};

  const int nv = (V + TILE - 1) / TILE;
  for (int vt = 0; vt < nv; ++vt) {
    // Stage vt has landed, and every warp is done with stage vt - 1,
    // whose buffer the next load reuses.
    cp_async_wait_all();
    __syncthreads();
    if (vt + 1 < nv)
      load_cols<VEC>(ws + ((vt + 1) & 1) * dp * TILE, w, (vt + 1) * TILE, D,
                     V, dp, tid);
    cp_async_commit();
    const uint16_t* wb = ws + (vt & 1) * dp * TILE;

    partial_logits(xs, xld, wb, nd, warp, lane, ln, red);
    __syncthreads();
    p_element(red, ps, row_lse, row_g, label, vt * TILE + col, V, tid);
    __syncthreads();

    // acc[16 t, 16 d] += p[16 t, 16 v] @ w^T[16 v, 16 d]: the stage read
    // without .trans is w^T.
    unsigned pa[4];
    ldsm_x4(pa, ps + ln.a_m * PLD + ln.a_k0);
#pragma unroll
    for (int j = 0; j < MAX_FRAGS; ++j) {
      const int f = warp + WARPS * j;
      if (f < nd) {
        unsigned b[4];
        ldsm_x4(b, wb + wsw(f * TILE + ln.bn_n, ln.bn_half));
        mma16816(acc[j][0], pa, b[0], b[1]);
        mma16816(acc[j][1], pa, b[2], b[3]);
      }
    }
  }

  const int r0 = t0 + lane / 4, c0 = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < MAX_FRAGS; ++j) {
    const int f = warp + WARPS * j;
    if (f < nd) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = r0 + (e / 2) * 8, d = f * TILE + nt * 8 + c0 + e % 2;
          if (t < T && d < D)
            dx[static_cast<size_t>(t) * D + d] = __float2bfloat16(acc[j][nt][e]);
        }
    }
  }
}

template <bool VEC>
int launch(const void* x, const void* w, const int* labels, const float* lse,
           const float* g, void* dx, int T, int D, int V,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(padded_d(D));
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_dx_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + TILE - 1) / TILE);
  fused_ce_dx_kernel<VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), labels,
      lse, g, static_cast<bf16*>(dx), T, D, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_ce_dx(const void* x, const void* w, const int* labels,
                           const float* lse, const float* g, void* dx, int T,
                           int D, int V, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 8 == 0 && V % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(x, w, labels, lse, g, dx, T, D, V, s)
             : launch<false>(x, w, labels, lse, g, dx, T, D, V, s);
}
