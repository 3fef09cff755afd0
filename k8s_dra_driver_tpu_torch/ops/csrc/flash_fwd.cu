// Causal flash attention forward for Hopper (sm_90a).
//
// Replaces the forward Pallas TPU kernel of the library flash attention
// the reference flagship calls with attention="flash"
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_kernel_single_batch, launched by
// _flash_attention_impl). For each row i of each (batch, head):
//     s[j] = (q[i] . k[j]) * scale, + MASK_VALUE where j > i
//     m[i] = max_j s[j],  l[i] = sum_j exp(s[j] - m[i])
//     o[i] = sum_j bf16(exp(s[j] - m)) * v[j] / l[i]        (bf16 out)
// with an online (m, l) over key tiles, p rounded to bf16 before p @ v
// and the sum kept in f32, as the library does; l and m are saved for the
// backward kernels. The [S, S] scores never reach device memory.
//
// Bound: at the flagship's bench shape (batch 4, 2 heads, S=1024, head_dim
// 1024) the causal half of q k^T and p v is 17.2 GFLOP, 0.017 ms at 989
// TFLOP/s bf16 dense, against 0.020 ms for the 67 MB of q, k, v and o at
// 3.35 TB/s: about balanced.
//
// Design. The Pallas kernel kept a [128, head_dim] f32 accumulator in VMEM
// across the key steps of its grid. Here one block owns 16 query rows of
// one (batch, head), walks the key tiles of 16 up to the diagonal itself,
// and keeps its [16, head_dim] f32 accumulator in registers, split over
// the 8 warps by 16-column slices of head_dim (flash_common.cuh): 64
// registers a thread at head_dim 1024, where the textbook layout (a warp
// owning whole rows) would need 512. Each key step stages the k and v
// tiles (double-buffered with cp.async, 33 KB each at head_dim 1024),
// forms the partial scores per warp, sums them in shared memory, runs the
// online softmax with one thread per score, and multiplies the bf16 p tile
// into every warp's slice. Only the diagonal tile is masked. The
// accumulator is rescaled by exp(m_old - m_new) each step and divided by l
// once at the end (the library renormalizes each step: the same value up
// to f32 rounding). Blocks of the longest rows are launched first. Every
// block reads k and v up to its diagonal from L2; wgmma, TMA and taller
// query tiles come later.
//
// Plain C interface (loaded with ctypes): flash_fwd returns the CUDA error
// code of the launch, 0 on success. It allocates nothing and launches on
// the stream it is given.

#include "flash_common.cuh"

namespace {

using namespace flash;

size_t smem_bytes(int D) {
  return 5 * tile_bytes(D)                 // q, two k stages, two v stages
         + WARPS * FRAG * 4                // partial scores
         + TILE * PLD * 2 + TILE * 4;      // p tile, per-row factor
}

template <int FR>
__global__ void __launch_bounds__(THREADS, FR >= 8 ? 1 : 2)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ l_out, float* __restrict__ m_out, int S,
                 int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tl = TILE * pitch(D);
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);  // [16][pitch]
  uint16_t* ks = qs + tl;                              // 2 x [16][pitch]
  uint16_t* vs = ks + 2 * tl;                          // 2 x [16][pitch]
  float* red = reinterpret_cast<float*>(vs + 2 * tl);  // 8 x [16][16]
  bf16* ps = reinterpret_cast<bf16*>(red + WARPS * FRAG);  // [16][PLD]
  float* row_f = reinterpret_cast<float*>(ps + TILE * PLD);  // [16]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Lanes ln(lane);
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  q += base;
  k += base;
  v += base;
  o += base;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TILE;
  // This thread's score of every tile: query row q0 + r, key column c.
  const int r = tid / TILE, c = tid % TILE;

  load_tile(qs, q, q0, D, tid);
  load_tile(ks, k, 0, D, tid);
  load_tile(vs, v, 0, D, tid);
  cp_async_commit();

  float m_run = -INFINITY, l_run = 0.f;
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

    partial_scores<FR>(qs, kb, D, warp, lane, ln, red);
    __syncthreads();
    float s = sum_slots(red, tid) * scale;
    if (kt == qt && c > r) s += MASK_VALUE;
    const float m_new = fmaxf(m_run, row_max(s));
    const float p = expf(s - m_new);
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    l_run = l_run * alpha + row_sum(p);
    m_run = m_new;
    ps[r * PLD + c] = __float2bfloat16(p);
    if (c == 0) row_f[r] = alpha;
    __syncthreads();

    const float a0 = row_f[lane / 4], a1 = row_f[lane / 4 + 8];
#pragma unroll
    for (int j = 0; j < FR; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[j][nt][0] *= a0;
        acc[j][nt][1] *= a0;
        acc[j][nt][2] *= a1;
        acc[j][nt][3] *= a1;
      }
    accumulate<FR>(acc, ps, vb, D, warp, ln);
  }

  __syncthreads();  // every warp has read the last tile's row factors
  if (c == 0) {
    const size_t row = static_cast<size_t>(blockIdx.x) * S + q0 + r;
    l_out[row] = l_run;
    m_out[row] = m_run;
    row_f[r] = l_run == 0.f ? 1.f : 1.f / l_run;
  }
  __syncthreads();
  store_rows<FR>(o, acc, q0, D, warp, lane, row_f[lane / 4],
                 row_f[lane / 4 + 8]);
}

template <int FR>
int launch(const void* q, const void* k, const void* v, void* o, float* l,
           float* m, int BH, int S, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<FR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, S / TILE);
  flash_fwd_kernel<FR><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<bf16*>(o), l, m, S, D,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* l, float* m, int BH, int S, int D, float scale,
                         void* stream) {
  if (BH <= 0 || S <= 0 || S % TILE || S / TILE > 65535 || D <= 0 ||
      D % TILE || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (frags_per_warp(D)) {
    case 1: return launch<1>(q, k, v, o, l, m, BH, S, D, scale, s);
    case 2: return launch<2>(q, k, v, o, l, m, BH, S, D, scale, s);
    case 4: return launch<4>(q, k, v, o, l, m, BH, S, D, scale, s);
    default: return launch<8>(q, k, v, o, l, m, BH, S, D, scale, s);
  }
}
