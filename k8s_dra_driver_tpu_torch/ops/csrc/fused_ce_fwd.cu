// Fused unembed + softmax cross-entropy forward for Hopper (sm_90a).
//
// Replaces k8s_dra_driver_tpu/ops/fused_ce.py:_fwd_kernel (the Pallas TPU
// kernel behind fused_ce_losses). Per token row t it computes
//     lse[t]    = logsumexp_v (x[t] . w[:, v])       over v < V
//     picked[t] = x[t] . w[:, labels[t]]             (0 when the label is -1)
// and the caller forms loss = lse - picked. The [T, V] logits never reach
// device memory: each [BT, BV] logits tile lives in registers and shared
// memory only, and is folded into a running (max, sum) per row.
//
// Bound: compute. The work is 2*T*D*V flops against (T*D + D*V)*2 bytes
// read; at the scoring shapes T=4096, D=2048, V=8192 that is 137 GFLOP,
// about 0.14 ms at 989 TFLOP/s bf16 dense, against 0.014 ms to read the
// 48 MB of operands at 3.35 TB/s.
//
// Design. The Pallas grid walked (token tile, vocab tile) in order on one
// core and carried (m, l, picked) from one vocab step to the next in VMEM
// scratch. Here blocks run in parallel and in no order, so each block owns
// BT token rows and a loop inside it walks the whole vocab; nothing carries
// across blocks. The loop is flattened over (vocab tile, depth tile) and
// double-buffered: cp.async stages the next bf16 x tile [BT, BK] and w tile
// [BK, BV] into shared memory while the tensor cores (WMMA, bf16 in, f32
// accumulate) work on the current pair. After the last depth tile of a
// vocab tile the accumulators go to a shared f32 tile; eight threads per
// row fold it into the row's running max and sum, mask columns >= V (no
// padded copy of w is made), and pick the label's logit. x is re-read from
// L2 once per vocab tile. This simple first version leaves wgmma, TMA and
// deeper pipelines to later work; with BT=32 a T=4096 call fills 128 of
// the card's 132 SMs with one block each.
//
// Plain C interface (loaded with ctypes): fused_ce_fwd returns the CUDA
// error code of the launch, 0 on success. The kernel allocates nothing and
// launches on the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BT = 32;        // token rows per block
constexpr int BV = 128;       // vocab columns per tile
constexpr int BK = 64;        // depth (d_model) per stage
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns) of 16x32
constexpr int XLD = BK + 8;   // shared pitches, padded against bank conflicts
constexpr int WLD = BV + 8;
constexpr int LLD = BV + 8;
constexpr int X_STAGE = BT * XLD;  // bf16 elements per stage
constexpr int W_STAGE = BK * WLD;
constexpr int SMEM_BYTES = 2 * (X_STAGE + W_STAGE) * 2 + BT * LLD * 4;
constexpr int ROW_THREADS = THREADS / BT;  // threads folding one row: 8

static_assert(BT * BK / 8 == THREADS, "one 16-byte x chunk per thread");
static_assert((BK * BV / 8) % THREADS == 0, "whole w chunks per thread");
static_assert(ROW_THREADS == 8, "row fold reduces over 8 lanes");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

// Stage x[t0:t0+BT, k0:k0+BK] and w[k0:k0+BK, v0:v0+BV] into shared
// memory, zero outside [T, D] and [D, V]. VEC: D and V are multiples of 8
// and both bases 16-byte aligned, so every 8-element chunk is wholly in or
// out and is copied with one cp.async; otherwise element by element.
template <bool VEC>
__device__ __forceinline__ void load_stage(uint16_t* xs, uint16_t* ws,
                                           const uint16_t* __restrict__ x,
                                           const uint16_t* __restrict__ w,
                                           int t0, int k0, int v0, int T,
                                           int D, int V, int tid) {
  {
    const int r = tid / (BK / 8), c = (tid % (BK / 8)) * 8;
    const int row = t0 + r, k = k0 + c;
    uint16_t* dst = xs + r * XLD + c;
    if (VEC) {
      const bool ok = row < T && k < D;
      cp_async16(dst, ok ? x + static_cast<size_t>(row) * D + k : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (row < T && k + e < D) ? x[static_cast<size_t>(row) * D + k + e]
                                        : uint16_t(0);
    }
  }
#pragma unroll
  for (int i = 0; i < (BK * BV / 8) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / (BV / 8), c = (idx % (BV / 8)) * 8;
    const int k = k0 + r, col = v0 + c;
    uint16_t* dst = ws + r * WLD + c;
    if (VEC) {
      const bool ok = k < D && col < V;
      cp_async16(dst, ok ? w + static_cast<size_t>(k) * V + col : w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (k < D && col + e < V) ? w[static_cast<size_t>(k) * V + col + e]
                                        : uint16_t(0);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
fused_ce_fwd_kernel(const uint16_t* __restrict__ x,
                    const uint16_t* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ lse,
                    float* __restrict__ picked, int T, int D, int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ws = xs + 2 * X_STAGE;
  float* ls = reinterpret_cast<float*>(ws + 2 * W_STAGE);

  const int tid = threadIdx.x, warp = tid / 32;
  const int t0 = blockIdx.x * BT;
  const int wr = (warp / 4) * 16, wc = (warp % 4) * 32;  // warp's sub-tile

  // Row fold: threads 8r..8r+7 own row r; all eight keep the same state.
  const int urow = tid / ROW_THREADS, upart = tid % ROW_THREADS;
  const int grow = t0 + urow;
  const int label = grow < T ? labels[grow] : -1;
  float m_run = -INFINITY, l_run = 0.f, pk = 0.f;

  const int nkt = (D + BK - 1) / BK, nvt = (V + BV - 1) / BV;
  const int n = nkt * nvt;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  load_stage<VEC>(xs, ws, x, w, t0, 0, 0, T, D, V, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  for (int i = 0; i < n; ++i) {
    const int vt = i / nkt, kt = i - vt * nkt;
    if (i + 1 < n) {
      const int vn = (i + 1) / nkt, kn = (i + 1) - vn * nkt;
      const int s = (i + 1) & 1;
      load_stage<VEC>(xs + s * X_STAGE, ws + s * W_STAGE, x, w, t0, kn * BK,
                      vn * BV, T, D, V, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const bf16* xb = reinterpret_cast<const bf16*>(xs + (i & 1) * X_STAGE);
    const bf16* wb = reinterpret_cast<const bf16*>(ws + (i & 1) * W_STAGE);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xb + wr * XLD + kk, XLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wb + kk * WLD + wc + j * 16, WLD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();  // the stage just read is refilled next iteration

    if (kt == nkt - 1) {
      // The two __syncthreads of every iteration separate this tile's
      // reads of `ls` from the next tile's stores.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(ls + wr * LLD + wc + j * 16, acc[j], LLD,
                                wmma::mem_row_major);
        wmma::fill_fragment(acc[j], 0.f);
      }
      __syncthreads();

      const int v0 = vt * BV;
      const float* lrow = ls + urow * LLD;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < BV / ROW_THREADS; ++j) {
        const int col = upart + ROW_THREADS * j;
        if (v0 + col < V) tmax = fmaxf(tmax, lrow[col]);
      }
#pragma unroll
      for (int o = 1; o < ROW_THREADS; o <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      // Every tile holds at least one column < V, so m_new is finite.
      const float m_new = fmaxf(m_run, tmax);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < BV / ROW_THREADS; ++j) {
        const int col = upart + ROW_THREADS * j;
        if (v0 + col < V) s += expf(lrow[col] - m_new);
      }
#pragma unroll
      for (int o = 1; o < ROW_THREADS; o <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      l_run = l_run * expf(m_run - m_new) + s;
      m_run = m_new;
      if (label >= v0 && label < v0 + BV && label < V) pk = lrow[label - v0];
    }
  }

  if (upart == 0 && grow < T) {
    lse[grow] = m_run + logf(l_run);
    picked[grow] = pk;
  }
}

template <bool VEC>
int launch(const void* x, const void* w, const int* labels, float* lse,
           float* picked, int T, int D, int V, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_fwd_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BT - 1) / BT);
  fused_ce_fwd_kernel<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), labels,
      lse, picked, T, D, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_ce_fwd(const void* x, const void* w, const int* labels,
                            float* lse, float* picked, int T, int D, int V,
                            void* stream) {
  if (T <= 0 || D <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 8 == 0 && V % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(x, w, labels, lse, picked, T, D, V, s)
             : launch<false>(x, w, labels, lse, picked, T, D, V, s);
}
