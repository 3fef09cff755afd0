// Fused unembed + softmax cross-entropy backward, dw, for Hopper (sm_90a).
//
// Replaces k8s_dra_driver_tpu/ops/fused_ce.py:_dw_kernel (the Pallas TPU
// kernel launched by _fused_ce_bwd). With lse saved by the forward and g
// the upstream gradient (one value per token),
//     p[t, v]  = (where(v < V, exp(x[t] . w[:, v] - lse[t]), 0)
//                 - (v == labels[t])) * g[t]
//     dw[:, v] = sum_t x[t] * p[t, v]                 (bf16 out, [D, V])
// without the [T, V] logits or p ever reaching device memory.
//
// Bound: compute. 4*T*D*V flops (the logits recomputed, then x^T @ p)
// against (T*D + 2*D*V)*2 + 12*T bytes; at T=4096, D=2048, V=8192 that is
// 275 GFLOP, 0.278 ms at 989 TFLOP/s bf16 dense, against 0.03 ms for the
// 80 MB at 3.35 TB/s.
//
// Design. The Pallas kernel kept a [D, 512] f32 accumulator in VMEM across
// the token steps of its grid. Here one block owns 16 vocab columns, walks
// every token itself, and keeps its [D, 16] f32 accumulator in registers:
// warp k holds the d-fragments f with f % 8 == k (16 for D=2048). The
// block's w columns [D, 16] stay in shared memory; each token step stages
// the x tile [16, D] (double-buffered with cp.async, 64 KiB at D=2048) and
// uses it twice: read plainly as A of the logits tile (mma.sync, bf16 in,
// f32 accumulate, partial sums over each warp's d-slice meeting in shared
// memory), then read with ldmatrix.trans, which makes it x^T, as A of
// x^T @ p. Rows >= T are zero-filled and get g = 0. p is rounded to bf16
// for that product; the sum stays in f32. V=8192 gives 512 blocks, one a
// SM at a time (206 KB of shared memory). x is re-read from L2 by every
// block. wgmma, TMA and wider vocab tiles come later.
//
// Plain C interface (loaded with ctypes): fused_ce_dw returns the CUDA
// error code of the launch, 0 on success. It allocates nothing and
// launches on the stream it is given.

#include "fused_ce_bwd.cuh"

namespace {

using namespace fused_ce_bwd;

size_t smem_bytes(int dp) {
  return static_cast<size_t>(dp) * TILE * 2                  // w columns
         + 2 * static_cast<size_t>(TILE) * row_pitch(dp) * 2  // two x stages
         + TAIL_BYTES;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_ce_dw_kernel(const uint16_t* __restrict__ x,
                   const uint16_t* __restrict__ w,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   bf16* __restrict__ dw, int T, int D, int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nd = (D + TILE - 1) / TILE, dp = nd * TILE, xld = row_pitch(dp);
  uint16_t* wsm = reinterpret_cast<uint16_t*>(smem);  // [dp][16]
  uint16_t* xs = wsm + dp * TILE;                      // 2 x [16][xld]
  float* red = reinterpret_cast<float*>(xs + 2 * TILE * xld);
  bf16* ps = reinterpret_cast<bf16*>(red + WARPS * FRAG);  // [16][PLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Lanes ln(lane);
  const int v0 = blockIdx.x * TILE;
  // This thread's element of every p tile: row tid / 16, column tid % 16.
  const int r = tid / TILE, v = v0 + tid % TILE;

  load_cols<VEC>(wsm, w, v0, D, V, dp, tid);
  load_rows<VEC>(xs, x, 0, T, D, dp, xld, tid);
  cp_async_commit();

  // acc[j][nt]: dw rows 16 f + lane/4 (+8), columns v0 + 8 nt + 2(lane%4) (+1).
  float acc[MAX_FRAGS][2][4] = {};

  const int nt_steps = (T + TILE - 1) / TILE;
  for (int tt = 0; tt < nt_steps; ++tt) {
    // Stage tt has landed, and every warp is done with stage tt - 1,
    // whose buffer the next load reuses.
    cp_async_wait_all();
    __syncthreads();
    if (tt + 1 < nt_steps)
      load_rows<VEC>(xs + ((tt + 1) & 1) * TILE * xld, x, (tt + 1) * TILE, T,
                     D, dp, xld, tid);
    cp_async_commit();
    const uint16_t* xb = xs + (tt & 1) * TILE * xld;

    const int row = tt * TILE + r;
    const bool live = row < T;
    const int label = live ? labels[row] : -1;
    const float row_lse = live ? lse[row] : 0.f;
    const float row_g = live ? g[row] : 0.f;

    partial_logits(xb, xld, wsm, nd, warp, lane, ln, red);
    __syncthreads();
    p_element(red, ps, row_lse, row_g, label, v, V, tid);
    __syncthreads();

    // acc[16 d, 16 v] += x^T[16 d, 16 t] @ p[16 t, 16 v]: the stage read
    // with .trans is x^T.
    unsigned pb[4];
    ldsm_x4_t(pb, ps + ln.bt_k * PLD + ln.bt_half * 8);
#pragma unroll
    for (int j = 0; j < MAX_FRAGS; ++j) {
      const int f = warp + WARPS * j;
      if (f < nd) {
        unsigned a[4];
        ldsm_x4_t(a, xb + ln.at_k * xld + f * TILE + ln.at_m0);
        mma16816(acc[j][0], a, pb[0], pb[1]);
        mma16816(acc[j][1], a, pb[2], pb[3]);
      }
    }
  }

  const int c0 = v0 + (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < MAX_FRAGS; ++j) {
    const int f = warp + WARPS * j;
    if (f < nd) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = f * TILE + lane / 4 + (e / 2) * 8, col = c0 + nt * 8 + e % 2;
          if (d < D && col < V)
            dw[static_cast<size_t>(d) * V + col] = __float2bfloat16(acc[j][nt][e]);
        }
    }
  }
}

template <bool VEC>
int launch(const void* x, const void* w, const int* labels, const float* lse,
           const float* g, void* dw, int T, int D, int V,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(padded_d(D));
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_dw_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((V + TILE - 1) / TILE);
  fused_ce_dw_kernel<VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), labels,
      lse, g, static_cast<bf16*>(dw), T, D, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_ce_dw(const void* x, const void* w, const int* labels,
                           const float* lse, const float* g, void* dw, int T,
                           int D, int V, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 8 == 0 && V % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(x, w, labels, lse, g, dw, T, D, V, s)
             : launch<false>(x, w, labels, lse, g, dw, T, D, V, s);
}
