// Fused unembed + softmax cross-entropy backward, dx, for Hopper (sm_90a):
// step 2 of 3 for each vocab chunk.
//
// Replaces k8s_dra_driver_tpu/ops/fused_ce.py:_dx_kernel (the Pallas TPU
// kernel launched by _fused_ce_bwd). With p_c the chunk [v0, v0 + nc) of
// p that fused_ce_p.cu wrote (bf16 [T, nc]),
//     dx += p_c @ w[:, v0:v0 + nc]^T                   ([T, D], bf16 out)
// summed over the chunks in f32. The first chunk stores its product to an
// f32 [T, D] scratch, later chunks add into it, and the last one adds and
// writes bf16 dx; with one chunk dx is written straight away.
//
// Bound: operations. 2*T*D*V flops over the chunks: at T=4096, D=2048,
// V=8192, 137 GFLOP, 0.139 ms at 989 TFLOP/s bf16 dense. Its bytes are p
// (T*V*2) and w read and dx written once, 112 MB, 0.033 ms at 3.35 TB/s;
// the design adds the scratch's f32 traffic, 4*T*D bytes written by the
// first chunk and read and written by each later one (at 4 chunks 224 MB,
// much of it in L2).
//
// Design: the shared wgmma mainloop of gemm_bf16.cuh (128 x 256 tiles,
// m64n256k16, a 4-stage TMA ring) with M = T, N = D, K = nc: A is p_c,
// K-major; B is w[:, chunk] read as [nc, D], which w's row-major [D, V]
// makes K-major: both in place by descriptor, no copy (the chunk's map
// starts at w + v0). D is N, tiled like any GEMM, so d_model has no cap.
// The epilogue adds and stores the f32 scratch in pairs straight from the
// accumulators (a warp's access covers whole 32-byte sectors), masked at
// the edges; the last chunk's bf16 dx goes out through the ring by TMA
// (masked stores where D % 8 != 0).
//
// Plain C interface (loaded with ctypes): fused_ce_dx returns the CUDA
// error code of the launch (or a CUresult of the tensor-map encoder), 0 on
// success. It allocates nothing and launches on the stream it is given.

#include "gemm_bf16.cuh"

namespace {

using namespace gemm;

// Each accumulator pair with c [M, N] f32, row pitch ld, masked at the
// edges: ADD adds c into the pair, else the pair is stored to c. A row's
// pairs are at compile-time offsets 8j from one pointer.
template <bool ADD>
__device__ __forceinline__ void f32_pass(float (&acc)[128], const Tile& tl, float* c,
                                         int ld, int M, int N) {
  const bool pairs = ld % 2 == 0;  // then (row * ld + col) is even: 8-byte aligned
  const int col0 = tl.col(0);
  const int left = N - col0;  // offsets >= left lie past c's last column
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = tl.row(h);
    if (row >= M) continue;
    float* base = c + static_cast<size_t>(row) * ld + col0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (8 * j >= left) continue;
      float* p = base + 8 * j;
      float& v0 = acc[4 * j + 2 * h];
      float& v1 = acc[4 * j + 2 * h + 1];
      if (ADD) {
        if (pairs) {
          const float2 s = *reinterpret_cast<const float2*>(p);
          v0 += s.x;
          v1 += s.y;
        } else {
          v0 += p[0];
          if (8 * j + 1 < left) v1 += p[1];
        }
      } else if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (8 * j + 1 < left) p[1] = v1;
      }
    }
  }
}

struct DxEpilogue {
  static constexpr int PRODUCER = 32;
  float* acc;  // the f32 scratch [T, D]
  bf16* dx;    // [T, D]
  int first, last;
  int tma_store;  // the last chunk, D % 8 == 0
  __device__ __forceinline__ void operator()(float (&a)[128], const Tile& tl,
                                             const CUtensorMap* tc, int M, int N) const {
    if (!first) f32_pass<true>(a, tl, acc, N, M, N);
    if (!last) {
      f32_pass<false>(a, tl, acc, N, M, N);
    } else if (tma_store) {
      store_tma(a, tl, tc);
    } else {
      store_direct(a, tl, dx, N, M, N);
    }
  }
};

}  // namespace

// One chunk of dx: p [T, nc] bf16 (row pitch ldp) times the columns [v0,
// v0 + nc) of w [D, V] (row pitch ldw) transposed, into the f32 scratch
// acc [T, D] (read unless first, written unless last) or, for the last
// chunk, into dx [T, D] bf16. Pitches are multiples of 8 elements, p and w
// 16-byte aligned, v0 a multiple of 8.
extern "C" int fused_ce_dx(const void* p, const void* w, float* acc, void* dx, int T,
                           int D, int ldp, int ldw, int v0, int nc, int first,
                           int last, void* stream) {
  if (T <= 0 || D <= 0 || nc <= 0 || v0 < 0 || v0 % 8 || ldp < nc || ldp % 8 ||
      ldw % 8 || !aligned16(p) || !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  const DxEpilogue epi{acc, static_cast<bf16*>(dx), first != 0, last != 0,
                       last != 0 && D % 8 == 0};
  const bf16* wc = static_cast<const bf16*>(w) + v0;
  return run<true, true>(p, ldp, wc, ldw, dx, D, epi, T, D, nc,
                         static_cast<cudaStream_t>(stream));
}
