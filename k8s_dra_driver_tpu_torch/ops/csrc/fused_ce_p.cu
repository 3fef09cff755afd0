// Fused unembed + softmax cross-entropy backward, step 1 of 3 for each
// vocab chunk: the chunk of p, for Hopper (sm_90a).
//
// Replaces the logits recompute that both TPU backward kernels of
// k8s_dra_driver_tpu/ops/fused_ce.py do, _dx_kernel (:127-131) and
// _dw_kernel (:153-157), now done once for dx and dw together. With lse
// saved by the forward and g the upstream gradient (one value per token),
// for the vocab columns v of the chunk [v0, v0 + nc):
//     p[t, v - v0] = (where(v < V, exp(x[t] . w[:, v] - lse[t]), 0)
//                     - (v == labels[t])) * g[t]                (bf16 out)
// The wrapper walks the vocab in chunks whose p_c, [T, nc] bf16, fits a
// fixed budget (ops/fused_ce.py:P_BUDGET), and fused_ce_dx.cu and
// fused_ce_dw.cu read p_c before the next chunk overwrites it: the [T, V]
// logits never reach device memory, and p only one chunk at a time.
//
// Bound: operations. The whole backward (this kernel, dx and dw over every
// chunk) is three products of 2*T*D*V flops, 6*T*D*V: at T=4096, D=2048,
// V=8192, 412 GFLOP, 0.417 ms at 989 TFLOP/s bf16 dense; this kernel's
// share is 2*T*D*V, 0.139 ms. Its bytes are x and w read and p written
// once (T*V*2): 112 MB, 0.033 ms at 3.35 TB/s.
//
// Design: the shared wgmma mainloop of gemm_bf16.cuh (128 x 256 tiles,
// m64n256k16, a 4-stage TMA ring) on the product x @ w[:, chunk], x [T, D]
// read K-major and the w chunk MN-major, both in place by descriptor (the
// chunk's map starts at w + v0: v0 is a multiple of 256). The epilogue
// reads lse, g and the label once for each of a thread's two rows, forms
// p pair by pair from the f32 accumulators as it packs them to bf16 in the
// ring (exp as ex2.approx of a fused multiply-add, column tests against
// compile-time offsets), and stores p by TMA. The consumers hold 232
// registers a thread, from a producer warpgroup that gives its own away
// (setmaxnreg): with the lone producer warp of the plain product, p's
// arithmetic spilled. Columns past the chunk
// read zeros and are clipped by the store; columns >= V are masked to 0;
// rows past T have g = 0 and are clipped.
//
// Plain C interface (loaded with ctypes): fused_ce_p returns the CUDA error
// code of the launch (or a CUresult of the tensor-map encoder), 0 on
// success. It allocates nothing and launches on the stream it is given.

#include "gemm_bf16.cuh"

namespace {

using namespace gemm;

// 2^x, one instruction (relative error about 2^-22; 0 for x below -126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p of one accumulator: the logit v of row h at column offset off (from
// the thread's first vocab column c0) -> (exp(v - lse) masked past the
// vocab, less 1 at the label) * g.
struct PValue {
  float lse2[2], g[2];  // lse * log2(e) and g of the thread's two rows
  int label[2];         // the label's column offset (< 0: none)
  int past;             // offsets >= past lie beyond the vocab
  __device__ __forceinline__ float operator()(float v, int h, int off) const {
    constexpr float LOG2E = 1.4426950408889634f;
    const float s = off < past ? ex2(fmaf(v, LOG2E, -lse2[h])) : 0.f;
    return (off == label[h] ? s - 1.f : s) * g[h];
  }
};

struct PEpilogue {
  // A producer warpgroup: p's arithmetic beside the 128 accumulators
  // spilled within the 168 registers a lone producer warp leaves.
  static constexpr int PRODUCER = 128;
  const float* lse;
  const float* g;
  const int* labels;
  int v0, V;
  int tma_store;  // always: p_c's pitch is a multiple of 8
  __device__ __forceinline__ void operator()(float (&acc)[128], const Tile& tl,
                                             const CUtensorMap* tc, int M, int N) const {
    constexpr float LOG2E = 1.4426950408889634f;
    // Column offsets 8j + e from the thread's first vocab column are
    // compile-time constants: the tests in PValue compare against them.
    const int c0 = v0 + tl.col(0);
    PValue f;
    f.past = V - c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tl.row(h);
      const bool live = row < M;
      f.lse2[h] = live ? lse[row] * LOG2E : 0.f;
      f.g[h] = live ? g[row] : 0.f;
      f.label[h] = (live ? labels[row] : -1) - c0;
    }
    // p is formed pair by pair as the store packs it.
    store_tma(acc, tl, tc, f);
  }
};

}  // namespace

// p [T, nc] bf16, row pitch ldp, from x [T, D] (row pitch ldx) and the
// columns [v0, v0 + nc) of w [D, V] (row pitch ldw), with labels [T]
// int32, lse and g [T] f32. Pitches are multiples of 8 elements, x, w and
// p 16-byte aligned, v0 a multiple of 8, v0 + nc <= V.
extern "C" int fused_ce_p(const void* x, const void* w, const int* labels,
                          const float* lse, const float* g, void* p, int T, int D,
                          int V, int ldx, int ldw, int ldp, int v0, int nc,
                          void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || nc <= 0 || v0 < 0 || v0 % 8 || v0 + nc > V ||
      ldx < D || ldw < V || ldp < nc || ldx % 8 || ldw % 8 || ldp % 8 ||
      !aligned16(x) || !aligned16(w) || !aligned16(p))
    return static_cast<int>(cudaErrorInvalidValue);
  const PEpilogue epi{lse, g, labels, v0, V, 1};
  const bf16* wc = static_cast<const bf16*>(w) + v0;
  return run<true, false>(x, ldx, wc, ldw, p, ldp, epi, T, nc, D,
                          static_cast<cudaStream_t>(stream));
}
