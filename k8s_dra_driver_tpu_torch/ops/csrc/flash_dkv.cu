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
// with the sums in f32, as the library does.
//
// Bound: at the flagship's bench shape (batch 4, 2 heads, S=1024, head_dim
// 1024) the causal half of q k^T, do v^T, p^T do and ds^T q is 34.4
// GFLOP, 0.035 ms at 989 TFLOP/s bf16 dense, against 0.030 ms for the
// 101 MB of q, k, v, do, dk and dv at 3.35 TB/s.
//
// Design. One block owns 16 key rows of one (batch, head) and walks the
// query tiles of 16 from the diagonal down. Its two [16, head_dim] f32
// accumulators, dk and dv, both stay in registers, split over the 8 warps
// by 16-column slices (flash_common.cuh): 128 registers a thread at
// head_dim 1024, as the fused-CE backward kernels hold at d_model 2048
// (chosen over dv in shared memory, which would leave no room to
// double-buffer the q and do tiles, and over two passes, which would
// recompute the scores). k and v stay in shared memory; each step stages
// the q and do tiles (double-buffered with cp.async), forms the partial
// score tiles q k^T and do v^T per warp, sums each in shared memory,
// computes p and ds with one thread per element and stores both
// transposed (key-major) in bf16, then multiplies p^T into every warp's
// slice of dv against the do tile and ds^T into dk against the q tile,
// both read with ldmatrix.trans. 216 KB of shared memory at head_dim 1024:
// one block a SM; blocks of the longest walks are launched first.
// Deterministic, no atomics.
//
// Plain C interface (loaded with ctypes): flash_dkv returns the CUDA
// error code of the launch, 0 on success. It allocates nothing and
// launches on the stream it is given.

#include "flash_common.cuh"

namespace {

using namespace flash;

size_t smem_bytes(int D) {
  return 6 * tile_bytes(D)          // k, v, two q stages, two do stages
         + 2 * WARPS * FRAG * 4     // partial scores of q k^T and do v^T
         + 2 * TILE * PLD * 2;      // p^T and ds^T tiles
}

template <int FR>
__global__ void __launch_bounds__(THREADS, FR >= 8 ? 1 : 2)
flash_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v,
                 const uint16_t* __restrict__ dout, const float* __restrict__ l,
                 const float* __restrict__ m, const float* __restrict__ di,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int D,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tl = TILE * pitch(D);
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem);  // [16][pitch]
  uint16_t* vs = ks + tl;                              // [16][pitch]
  uint16_t* qs = vs + tl;                              // 2 x [16][pitch]
  uint16_t* dos = qs + 2 * tl;                         // 2 x [16][pitch]
  float* red_s = reinterpret_cast<float*>(dos + 2 * tl);  // 8 x [16][16]
  float* red_p = red_s + WARPS * FRAG;                    // 8 x [16][16]
  bf16* pts = reinterpret_cast<bf16*>(red_p + WARPS * FRAG);  // [16][PLD]
  bf16* dsts = pts + TILE * PLD;                              // [16][PLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Lanes ln(lane);
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dk += base;
  dv += base;
  const float* lb = l + static_cast<size_t>(blockIdx.x) * S;
  const float* mb = m + static_cast<size_t>(blockIdx.x) * S;
  const float* dib = di + static_cast<size_t>(blockIdx.x) * S;
  const int kt = blockIdx.y, k0 = kt * TILE, nqt = S / TILE;
  // This thread's score of every tile: query row r of the tile, key k0 + c.
  const int r = tid / TILE, c = tid % TILE;

  load_tile(ks, k, k0, D, tid);
  load_tile(vs, v, k0, D, tid);
  load_tile(qs, q, k0, D, tid);
  load_tile(dos, dout, k0, D, tid);
  cp_async_commit();

  float dk_acc[FR][2][4] = {};
  float dv_acc[FR][2][4] = {};
  for (int qt = kt; qt < nqt; ++qt) {
    const int st = (qt - kt) & 1;
    // Stage qt has landed, and every warp is done with stage qt - 1,
    // whose buffers the next loads reuse.
    cp_async_wait_all();
    __syncthreads();
    if (qt + 1 < nqt) {
      load_tile(qs + (st ^ 1) * tl, q, (qt + 1) * TILE, D, tid);
      load_tile(dos + (st ^ 1) * tl, dout, (qt + 1) * TILE, D, tid);
    }
    cp_async_commit();
    const uint16_t* qb = qs + st * tl;
    const uint16_t* dob = dos + st * tl;
    const int row = qt * TILE + r;
    const float m_row = mb[row], l_inv = 1.f / lb[row], di_row = dib[row];

    partial_scores<FR>(qb, ks, D, warp, lane, ln, red_s);
    partial_scores<FR>(dob, vs, D, warp, lane, ln, red_p);
    __syncthreads();
    float s = sum_slots(red_s, tid) * scale;
    if (qt == kt && c > r) s += MASK_VALUE;
    const float p = expf(s - m_row) * l_inv;
    float ds = (sum_slots(red_p, tid) - di_row) * p;
    ds = ds * scale;
    pts[c * PLD + r] = __float2bfloat16(p);
    dsts[c * PLD + r] = __float2bfloat16(ds);
    __syncthreads();

    accumulate<FR>(dv_acc, pts, dob, D, warp, ln);
    accumulate<FR>(dk_acc, dsts, qb, D, warp, ln);
  }
  store_rows<FR>(dk, dk_acc, k0, D, warp, lane, 1.f, 1.f);
  store_rows<FR>(dv, dv_acc, k0, D, warp, lane, 1.f, 1.f);
}

template <int FR>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* l, const float* m, const float* di, void* dk, void* dv,
           int BH, int S, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<FR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, S / TILE);
  flash_dkv_kernel<FR><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout), l,
      m, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* l, const float* m,
                         const float* di, void* dk, void* dv, int BH, int S,
                         int D, float scale, void* stream) {
  if (BH <= 0 || S <= 0 || S % TILE || S / TILE > 65535 || D <= 0 ||
      D % TILE || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (frags_per_warp(D)) {
    case 1:
      return launch<1>(q, k, v, dout, l, m, di, dk, dv, BH, S, D, scale, s);
    case 2:
      return launch<2>(q, k, v, dout, l, m, di, dk, dv, BH, S, D, scale, s);
    case 4:
      return launch<4>(q, k, v, dout, l, m, di, dk, dv, BH, S, D, scale, s);
    default:
      return launch<8>(q, k, v, dout, l, m, di, dk, dv, BH, S, D, scale, s);
  }
}
