// Fused unembed + softmax cross-entropy forward for Hopper (sm_90a).
//
// Replaces k8s_dra_driver_tpu/ops/fused_ce.py:_fwd_kernel (the Pallas TPU
// kernel behind fused_ce_losses). Per token row t it computes
//     lse[t]    = logsumexp_v (x[t] . w[:, v])       over v < V
//     picked[t] = x[t] . w[:, labels[t]]             (0 for a label outside [0, V))
// both f32, and the caller forms loss = lse - picked. The [T, V] logits
// never reach device memory.
//
// Bound: operations. The product is 2*T*D*V flops; at T=4096, D=2048,
// V=8192, 137 GFLOP, 0.139 ms at 989 TFLOP/s bf16 dense. Its bytes are x
// and w read once (48 MB), the partials below written and read once (1
// MB) and lse and picked written: 0.015 ms at 3.35 TB/s.
//
// Design: the shared wgmma mainloop of gemm_bf16.cuh (128 x 256 tiles,
// m64n256k16, a 4-stage TMA ring) on the product x @ w over the whole
// vocab in one launch, x [T, D] read K-major and w [D, V] MN-major, both in
// place by descriptor. The grid is row tiles x vocab tiles (32 x 32 = 1024
// blocks at the shape above), where the Pallas kernel walked the vocab in
// order on one core. The TPU kernel's online (max, sum) carried across
// vocab steps becomes a two-level logsumexp:
//  - The epilogue of a block works on its f32 logits tile in registers.
//    A consumer thread holds 64 columns of each of its two rows, and the
//    four lanes of a quad together hold a row's 256: the row's max and
//    its sum of exp are an in-register pass and two __shfl_xor_sync, no
//    shared memory and no barrier (exp as ex2.approx of a fused
//    multiply-add). Columns >= V, which TMA fills with zeros, are masked
//    by compile-time offset tests in the last vocab tile; the others take
//    an unmasked pass. The tile's (max, sum) pair of each row goes to an
//    f32 scratch part [2][n_vocab_tiles][T]. The thread whose columns
//    hold a row's label writes picked from its f32 accumulator: exactly
//    one tile holds a given label. The producer is a lone warp: the
//    epilogue fits the consumers' 168 registers a thread.
//  - The fold. Each block counts its arrival on its row tile's counter
//    (after a __threadfence that publishes its partials); the last block
//    of a row tile folds the partials of its 128 rows, lse = M + log
//    sum_i l_i exp(m_i - M), M = max_i m_i (32 KB from L2 at the shape
//    above), writes 0 to picked where the label is no class, and resets
//    the counter to 0. One launch a call, no second pass.
// Rows >= T write nothing; ragged T, V and D read zeros through TMA; D has
// no cap. x or w off TMA's 16-byte rule come as an aligned copy from the
// wrapper (ops/fused_ce.py:_tma_rows).
//
// Plain C interface (loaded with ctypes): fused_ce_fwd returns the CUDA
// error code of the launch (or a CUresult of the tensor-map encoder), 0 on
// success. It allocates nothing and launches on the stream it is given.

#include <math.h>

#include "gemm_bf16.cuh"

namespace {

using namespace gemm;

// 2^x, one instruction (relative error about 2^-22; 0 for x below -126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The (max, sum of exp) pair of row h over the thread's 64 columns of it,
// reduced over the quad that holds the row's 256 (lanes 4k .. 4k + 3),
// and the label's logit where the label's column offset `off` from the
// thread's first column is one of the thread's. MASK: offsets >= past lie
// beyond the vocab and count in neither (else every column counts).
template <bool MASK>
__device__ __forceinline__ void row_stats(const float (&acc)[128], int h, int past, int off,
                                          float& m, float& s, float& pk, bool& hit) {
  constexpr float LOG2E = 1.4426950408889634f;
  m = -INFINITY;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (!MASK || 8 * j + e < past) m = fmaxf(m, acc[4 * j + 2 * h + e]);
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  // Every tile holds a column < V, so m is finite.
  const float m2 = m * LOG2E;
  s = 0.f;
  pk = 0.f;
  hit = false;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = acc[4 * j + 2 * h + e];
      if (!MASK || 8 * j + e < past) s += ex2(fmaf(v, LOG2E, -m2));
      if (8 * j + e == off) {
        pk = v;
        hit = true;
      }
    }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
}

struct FwdEpilogue {
  // A lone producer warp: the epilogue fits beside the 128 accumulators
  // within the 168 registers a thread that leaves (only the last vocab
  // tile takes the masked pass: masking every tile spilled).
  static constexpr int PRODUCER = 32;
  const int* labels;
  float* part;     // [2][nv][T]: each vocab tile's row max, then its row sum
  int* arrived;    // [row tiles], zero before the launch and after it
  float* lse;
  float* picked;
  int tma_store;   // 0: nothing goes through store_tma
  __device__ __forceinline__ void operator()(float (&acc)[128], const Tile& tl,
                                             const CUtensorMap*, int M, int N) const {
    const int nv = (N + BN - 1) / BN, vt = tl.n0 / BN;
    // Column offsets 8j + e from the thread's first column c0 are
    // compile-time constants; row_stats compares against them. Only the
    // last vocab tile can reach past the vocab: the others skip the mask.
    const int c0 = tl.col(0);
    const int past = N - c0;  // offsets >= past lie beyond the vocab
    const bool whole = N - tl.n0 >= BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tl.row(h);
      const int off = (row < M ? labels[row] : -1) - c0;
      float m, s, pk;
      bool hit;
      if (whole) row_stats<false>(acc, h, past, off, m, s, pk, hit);
      else row_stats<true>(acc, h, past, off, m, s, pk, hit);
      if (row < M) {
        if (hit && off < past) picked[row] = pk;
        if (tl.lane % 4 == 0) {
          part[static_cast<size_t>(vt) * M + row] = m;
          part[static_cast<size_t>(nv + vt) * M + row] = s;
        }
      }
    }

    // Arrival: the last block of this row tile folds its partials.
    __shared__ int last;
    const int mt = tl.m0 / BM;
    __threadfence();
    named_sync(1, CONSUMERS);
    if (tl.t == 0) last = atomicAdd(&arrived[mt], 1) == nv - 1;
    named_sync(1, CONSUMERS);
    if (!last) return;
    __threadfence();
    const int row = tl.m0 + tl.t;
    if (tl.t < BM && row < M) {
      // Straight from L2 (__ldcg): other blocks wrote these.
      const float* pm = part + row;
      const float* pl = part + static_cast<size_t>(nv) * M + row;
      float mx = -INFINITY;
#pragma unroll 8
      for (int i = 0; i < nv; ++i) mx = fmaxf(mx, __ldcg(pm + static_cast<size_t>(i) * M));
      float l = 0.f;
#pragma unroll 8
      for (int i = 0; i < nv; ++i)
        l += __ldcg(pl + static_cast<size_t>(i) * M) *
             expf(__ldcg(pm + static_cast<size_t>(i) * M) - mx);
      lse[row] = mx + logf(l);
      const int lab = labels[row];
      if (lab < 0 || lab >= N) picked[row] = 0.f;
    }
    if (tl.t == 0) arrived[mt] = 0;
  }
};

}  // namespace

// lse and picked [T] f32 from x [T, D] (row pitch ldx) and w [D, V] (row
// pitch ldw), with labels [T] int32; part is f32 scratch of 2 *
// ceil(V / 256) * T values, arrived int32 [ceil(T / 128)] zeroed (the
// kernel leaves it zeroed). Pitches are multiples of 8 elements, x and w
// 16-byte aligned.
extern "C" int fused_ce_fwd(const void* x, const void* w, const int* labels, float* part,
                            int* arrived, float* lse, float* picked, int T, int D, int V,
                            int ldx, int ldw, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || ldx < D || ldw < V || ldx % 8 || ldw % 8 ||
      !aligned16(x) || !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdEpilogue epi{labels, part, arrived, lse, picked, 0};
  return run<true, false>(x, ldx, w, ldw, nullptr, 0, epi, T, V, D,
                          static_cast<cudaStream_t>(stream));
}
