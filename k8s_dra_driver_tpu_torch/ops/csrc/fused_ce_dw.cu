// Fused unembed + softmax cross-entropy backward, dw, for Hopper (sm_90a):
// step 3 of 3 for each vocab chunk.
//
// Replaces k8s_dra_driver_tpu/ops/fused_ce.py:_dw_kernel (the Pallas TPU
// kernel launched by _fused_ce_bwd). With p_c the chunk [v0, v0 + nc) of
// p that fused_ce_p.cu wrote (bf16 [T, nc]),
//     dw[:, v0:v0 + nc] = x^T @ p_c                    ([D, V], bf16 out)
// each chunk's columns written once, summed over every token in f32.
//
// Bound: operations. 2*T*D*V flops over the chunks: at T=4096, D=2048,
// V=8192, 137 GFLOP, 0.139 ms at 989 TFLOP/s bf16 dense. Its bytes are x
// and p (T*V*2) read and dw written once, 96 MB, 0.029 ms at 3.35 TB/s.
//
// Design: the shared wgmma mainloop of gemm_bf16.cuh (128 x 256 tiles,
// m64n256k16, a 4-stage TMA ring) with M = D, N = nc, K = T: A is x^T and B
// is p_c, both MN-major, read in place by descriptor (wgmma's transpose
// bits), no copy. D is M, tiled like any GEMM, so d_model has no cap. The
// epilogue is the plain product's: bf16 staged in the ring and stored by
// TMA into dw's columns (the map starts at dw + v0, row pitch V), clipped
// at the edges; where V % 8 != 0 (dw's pitch then does not suit TMA),
// masked stores straight from the accumulators.
//
// Plain C interface (loaded with ctypes): fused_ce_dw returns the CUDA
// error code of the launch (or a CUresult of the tensor-map encoder), 0 on
// success. It allocates nothing and launches on the stream it is given.

#include "gemm_bf16.cuh"

using namespace gemm;

// Columns [v0, v0 + nc) of dw [D, V] bf16 (contiguous) = x^T @ p, x [T, D]
// (row pitch ldx), p [T, nc] bf16 (row pitch ldp). Pitches are multiples
// of 8 elements, x, p and dw 16-byte aligned, v0 a multiple of 8, v0 + nc
// <= V.
extern "C" int fused_ce_dw(const void* x, const void* p, void* dw, int T, int D, int V,
                           int ldx, int ldp, int v0, int nc, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || nc <= 0 || v0 < 0 || v0 % 8 || v0 + nc > V ||
      ldx < D || ldp < nc || ldx % 8 || ldp % 8 || !aligned16(x) || !aligned16(p) ||
      !aligned16(dw))
    return static_cast<int>(cudaErrorInvalidValue);
  bf16* dwc = static_cast<bf16*>(dw) + v0;
  const StoreBf16 epi{dwc, V, V % 8 == 0};
  return run<false, false>(x, ldx, p, ldp, dwc, V, epi, D, nc, T,
                           static_cast<cudaStream_t>(stream));
}
