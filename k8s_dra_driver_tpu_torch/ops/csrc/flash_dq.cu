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
//
// Bound: at the flagship's bench shape (batch 4, 2 heads, S=1024, head_dim
// 1024) the causal half of q k^T, do v^T and ds k is 25.8 GFLOP, 0.026 ms
// at 989 TFLOP/s bf16 dense, against 0.025 ms for the 84 MB of q, k, v,
// do, dq and the row statistics at 3.35 TB/s.
//
// Design. As flash_fwd.cu: one block owns 16 query rows of one (batch,
// head) and walks the key tiles of 16 up to the diagonal, its [16,
// head_dim] f32 dq accumulator in registers split over the 8 warps by
// 16-column slices. q and do stay in shared memory; each step stages the
// k and v tiles (double-buffered with cp.async), forms the two partial
// score tiles (q k^T and do v^T) per warp, sums each in shared memory,
// computes ds with one thread per element, and multiplies the bf16 ds
// tile into every warp's slice of dq, reading the k tile with
// ldmatrix.trans (no transposed copy). 215 KB of shared memory at
// head_dim 1024: one block a SM. Deterministic, no atomics.
//
// Plain C interface (loaded with ctypes): flash_dq returns the CUDA error
// code of the launch, 0 on success. It allocates nothing and launches on
// the stream it is given.

#include "flash_common.cuh"

namespace {

using namespace flash;

size_t smem_bytes(int D) {
  return 6 * tile_bytes(D)          // q, do, two k stages, two v stages
         + 2 * WARPS * FRAG * 4     // partial scores of q k^T and do v^T
         + TILE * PLD * 2;          // ds tile
}

template <int FR>
__global__ void __launch_bounds__(THREADS, FR >= 8 ? 1 : 2)
flash_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                const float* __restrict__ l, const float* __restrict__ m,
                const float* __restrict__ di, bf16* __restrict__ dq, int S,
                int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tl = TILE * pitch(D);
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);  // [16][pitch]
  uint16_t* dos = qs + tl;                             // [16][pitch]
  uint16_t* ks = dos + tl;                             // 2 x [16][pitch]
  uint16_t* vs = ks + 2 * tl;                          // 2 x [16][pitch]
  float* red_s = reinterpret_cast<float*>(vs + 2 * tl);  // 8 x [16][16]
  float* red_p = red_s + WARPS * FRAG;                   // 8 x [16][16]
  bf16* dss = reinterpret_cast<bf16*>(red_p + WARPS * FRAG);  // [16][PLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Lanes ln(lane);
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dq += base;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TILE;
  // This thread's score of every tile: query row q0 + r, key column c.
  const int r = tid / TILE, c = tid % TILE;
  const size_t row = static_cast<size_t>(blockIdx.x) * S + q0 + r;
  const float m_row = m[row], l_inv = 1.f / l[row], di_row = di[row];

  load_tile(qs, q, q0, D, tid);
  load_tile(dos, dout, q0, D, tid);
  load_tile(ks, k, 0, D, tid);
  load_tile(vs, v, 0, D, tid);
  cp_async_commit();

  float acc[FR][2][4] = {};
  for (int kt = 0; kt <= qt; ++kt) {
    // Stage kt has landed, and every warp is done with stage kt - 1,
    // whose buffers the next loads reuse.
    cp_async_wait_all();
    __syncthreads();
    if (kt < qt) {
      load_tile(ks + ((kt + 1) & 1) * tl, k, (kt + 1) * TILE, D, tid);
      load_tile(vs + ((kt + 1) & 1) * tl, v, (kt + 1) * TILE, D, tid);
    }
    cp_async_commit();
    const uint16_t* kb = ks + (kt & 1) * tl;
    const uint16_t* vb = vs + (kt & 1) * tl;

    partial_scores<FR>(qs, kb, D, warp, lane, ln, red_s);
    partial_scores<FR>(dos, vb, D, warp, lane, ln, red_p);
    __syncthreads();
    float s = sum_slots(red_s, tid) * scale;
    if (kt == qt && c > r) s += MASK_VALUE;
    const float p = expf(s - m_row) * l_inv;
    float ds = (sum_slots(red_p, tid) - di_row) * p;
    ds = ds * scale;
    dss[r * PLD + c] = __float2bfloat16(ds);
    __syncthreads();

    accumulate<FR>(acc, dss, kb, D, warp, ln);
  }
  store_rows<FR>(dq, acc, q0, D, warp, lane, 1.f, 1.f);
}

template <int FR>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* l, const float* m, const float* di, void* dq, int BH,
           int S, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<FR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, S / TILE);
  flash_dq_kernel<FR><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout), l,
      m, di, static_cast<bf16*>(dq), S, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* l, const float* m,
                        const float* di, void* dq, int BH, int S, int D,
                        float scale, void* stream) {
  if (BH <= 0 || S <= 0 || S % TILE || S / TILE > 65535 || D <= 0 ||
      D % TILE || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (frags_per_warp(D)) {
    case 1: return launch<1>(q, k, v, dout, l, m, di, dq, BH, S, D, scale, s);
    case 2: return launch<2>(q, k, v, dout, l, m, di, dq, BH, S, D, scale, s);
    case 4: return launch<4>(q, k, v, dout, l, m, di, dq, BH, S, D, scale, s);
    default: return launch<8>(q, k, v, dout, l, m, di, dq, BH, S, D, scale, s);
  }
}
