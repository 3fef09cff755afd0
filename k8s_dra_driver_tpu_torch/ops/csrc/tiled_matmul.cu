// Tiled matmul with f32 accumulation, for Hopper (sm_90a).
//
// Replaces k8s_dra_driver_tpu/ops/kernels.py:121, _matmul_kernel (the
// Pallas TPU kernel launched by _tiled_matmul_forward, :136):
//     c[M, N] = a[M, K] @ b[K, N], summed in f32, written in the input dtype
// (f32 or bf16; the wrapper casts mixed inputs up to one dtype first).
// Each operand is read in place either row-major or as the transpose of a
// row-major matrix (a_t, b_t), so the VJP's dY @ B^T and A^T @ dY cost no
// transposed copy.
//
// Bound: operations. At the flagship's FFN shape, [4096, 2048] @ [2048,
// 16384] in bf16, 2*M*N*K = 2.75e11 flops take 0.278 ms at 989 TFLOP/s
// against 0.05 ms for the 168 MB at 3.35 TB/s. [4096, 2048] @ [2048, 2048]
// in f32 is 3.44e10 flops: 0.513 ms at the 67 TFLOP/s of the FFMA cores,
// or, as this kernel computes it (three TF32 products), 1.03e11 tensor
// flops, 0.209 ms at 495 TFLOP/s.
//
// bf16 design: the shared wgmma mainloop of gemm_bf16.cuh (128 x 256
// tiles, two consumer warpgroups on m64n256k16, a 4-stage TMA ring from
// one producer warp, all four operand orientations read in place by
// descriptor, ragged edges through TMA's zero fill, tiles in groups of 8
// row tiles) with its plain bf16 epilogue: c staged 128B-swizzled in the
// idle ring and written by four TMA stores a warpgroup (whole 128-byte
// lines), or, where N is not a multiple of 8 (c's row pitch then does not
// suit TMA), masked stores straight from the accumulators. K = 0 writes
// zeros. At the FFN products the grid is 2048 or 256 tiles on 132 SMs, so
// the last partial wave costs at most 3%. (A persistent block an SM
// walking every 132nd tile, its producer loading the next tile while the
// consumers store the last, ran slower at all four FFN products in a
// bring-up run.)
// f32 design: 3xTF32 on wgmma, fed by TMA. TF32 keeps 10 mantissa bits
// (about three digits), so each operand is split: v = hi + lo with hi =
// tf32(v), lo = tf32(v - hi), both rounded to nearest (cvt.rna), and c
// sums a_lo b_hi + a_hi b_lo + a_hi b_hi. What is dropped (a_lo b_lo and
// lo's own rounding) is below 2^-20 of |a b|.
//  - Sums. The tensor cores do not round their f32 sums to nearest: with
//    every product added straight into c's accumulators the error grew
//    with K past the 1e-5 of max|c| the kernel is held to (at K = 2048,
//    and by an order of magnitude at K = 16384, in a bring-up build). So
//    each k-step's twelve products go to a second set of accumulators,
//    which an f32 add (rounded to nearest) folds into c's sums; that keeps
//    f32's accuracy at K = 16384.
//  - Tiles. A block owns a 128 x 128 tile of c; two consumer warpgroups
//    each own 64 x 128 of it with wgmma m64n128k8 (64 f32 accumulators a
//    thread, and 64 more for a k-step), and K is walked 32 deep: one
//    128-byte row of f32.
//  - Ring. One thread of a producer warpgroup keeps 3 stages of raw a and
//    b tiles (32 KB a stage) in flight by TMA through full/empty
//    mbarriers. The warpgroup hands its registers to the consumers
//    (setmaxnreg: 40 against 232 a thread), which hold two sets of
//    accumulators and the split; with a lone producer warp (nine warps,
//    168 registers a thread at most) the split's registers spilled.
//  - Split. TF32 wgmma reads K-major operands only (no transpose, unlike
//    bf16). The consumers split each raw stage into two buffers of the
//    four halves (64 KB each), K-major and 128B-swizzled, and release the
//    raw stage: a K-major operand (a row-major, b = w^T) arrives in that
//    layout and each element keeps its position; an MN-major one (b
//    row-major, a = h^T) arrives as unswizzled [32 k][128] boxes and the
//    split transposes it, all without bank conflicts. The split of k-step
//    kt + 1 runs while the tensor cores work on kt; one named barrier a
//    k-step hands the buffers over. 3 x 32 + 2 x 64 = 224 KB of shared
//    memory: one block an SM.
//  - Epilogue: f32 pairs stored straight from the accumulators, masked at
//    c's ragged edges. Edges: TMA's out-of-bounds fill reads zeros, which
//    split to zeros. K = 0 writes zeros. TMA needs each leading dimension
//    a multiple of 4 and a 16-byte base: the wrapper copies any operand
//    that fails either into an aligned buffer first, as for bf16.
//
// Plain C interface (loaded with ctypes): tiled_matmul returns the CUDA
// error code of the launch (or a CUresult of the tensor-map encoder), 0
// on success. It allocates nothing and launches on the stream it is given.

#include "gemm_bf16.cuh"

namespace {

using namespace gemm;

// ---- bf16: the shared mainloop, plain bf16 epilogue ------------------------

template <bool A_KM, bool B_KM>
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                int lda, int ldb, cudaStream_t s) {
  const int tma_store = N % 8 == 0;  // c's row pitch, as TMA needs it
  const StoreBf16 epi{static_cast<bf16*>(c), N, tma_store};
  return run<A_KM, B_KM>(a, lda, b, ldb, c, N, epi, M, N, K, s);
}

// ---- f32: 3xTF32 on wgmma fed by TMA --------------------------------------

constexpr int FBM = 128, FBN = 128, FBK = 32;  // c tile of a block, k-step
constexpr int FRST = 3;                        // ring stages of raw tiles
constexpr int FTILE = 128 * FBK * 4;           // one [128][32] f32 tile: 16 KB
constexpr int FRAW = 2 * FTILE;                // a and b as TMA brings them
constexpr int FSPLIT = 4 * FTILE;              // a_hi, a_lo, b_hi, b_lo
constexpr size_t FSMEM = 1024 + FRST * FRAW + 2 * FSPLIT + 8 * 2 * FRST;
constexpr int FTHREADS = CONSUMERS + 128;  // + the producer warpgroup

// v = hi + lo + (what is dropped, below 2^-22 |v|): hi = tf32(v), lo =
// tf32(v - hi), both rounded to nearest, ties away (v - hi is exact).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// The raw [128 x][32 k] tile of an operand -> its TF32 halves, each K-major
// [128][32] with the 128B swizzle (16-byte chunk c of row x at chunk
// c ^ (x % 8)), as wgmma reads them. KM: the raw tile has that layout
// already (TMA's swizzled box); else it is [32 k][128 x] unswizzled (an
// MN-major operand) and the split transposes it. Consumer thread t takes
// chunks t + 256 i; a warp's reads and writes meet no bank conflict.
template <bool KM>
__device__ __forceinline__ void split_tile(const unsigned char* raw, unsigned char* hi,
                                           unsigned char* lo, int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = t + CONSUMERS * i;
    const int x = KM ? q / 8 : q % 128, c = KM ? q % 8 : q / 128;
    const int off = x * 128 + ((c ^ (x % 8)) << 4);
    float v[4];
    if (KM) {
      const float4 w = *reinterpret_cast<const float4*>(raw + off);
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    } else {
      const float* r = reinterpret_cast<const float*>(raw) + 4 * c * 128 + x;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = r[128 * j];
    }
    uint4 h, l;
    split_tf32(v[0], h.x, l.x);
    split_tf32(v[1], h.y, l.y);
    split_tf32(v[2], h.z, l.z);
    split_tf32(v[3], h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// A_KM: a row-major [M][K], else a = h^T with h row-major [K][M]. B_KM:
// b = w^T with w row-major [N][K], else b row-major [K][N].
template <bool A_KM, bool B_KM>
__global__ void __launch_bounds__(FTHREADS, 1)
matmul_f32_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb, float* __restrict__ c,
                  int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* halves = smem + FRST * FRAW;
  uint64_t* full = reinterpret_cast<uint64_t*>(halves + 2 * FSPLIT);
  uint64_t* empty = full + FRST;

  const int t = threadIdx.x;
  int mt, nt;
  tile_of<FBM, FBN>(blockIdx.x, M, N, mt, nt);
  const int m0 = mt * FBM, n0 = nt * FBN;
  const int nk = (K + FBK - 1) / FBK;

  if (t == 0) {
    for (int s = 0; s < FRST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (t >= CONSUMERS) {
    // Producer warpgroup: one thread issues every copy; the others only
    // hand their registers to the consumers.
    setmaxnreg_dec<REGS_PRODUCER>();
    if (t == CONSUMERS) {
      prefetch_map(&ta);
      prefetch_map(&tb);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % FRST, round = kt / FRST;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        mbar_expect_tx(&full[st], FRAW);
        unsigned char* as = smem + st * FRAW;
        const int k0 = kt * FBK;
        if (A_KM) tma_load_2d(as, &ta, &full[st], k0, m0);
        else tma_load_2d(as, &ta, &full[st], m0, k0);
        if (B_KM) tma_load_2d(as + FTILE, &tb, &full[st], k0, n0);
        else tma_load_2d(as + FTILE, &tb, &full[st], n0, k0);
      }
    }
    return;
  }

  setmaxnreg_inc<REGS_CONSUMER>();
  // k-step kt's raw tiles -> split buffer kt % 2; the raw stage is then free.
  auto split_step = [&](int kt) {
    const int st = kt % FRST;
    mbar_wait(&full[st], (kt / FRST) & 1);
    const unsigned char* raw = smem + st * FRAW;
    unsigned char* sp = halves + (kt % 2) * FSPLIT;
    split_tile<A_KM>(raw, sp, sp + FTILE, t);
    split_tile<B_KM>(raw + FTILE, sp + 2 * FTILE, sp + 3 * FTILE, t);
    mbar_arrive(&empty[st]);
    fence_async_smem();  // the halves, visible to wgmma
  };

  // Consumer warpgroup g owns rows 64 g .. 64 g + 63 of the tile. The
  // tensor cores sum a k-step's twelve products in part; acc, c's sums,
  // takes part with an f32 add, rounded to nearest, each k-step.
  const int g = t / 128, warp = (t % 128) / 32, lane = t % 32;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  split_step(0);
  named_sync(1, CONSUMERS);
  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t a_hi = smem_u32(halves + (kt % 2) * FSPLIT) + g * (FTILE / 2);
    const uint32_t a_lo = a_hi + FTILE;
    const uint32_t b_hi = smem_u32(halves + (kt % 2) * FSPLIT) + 2 * FTILE;
    const uint32_t b_lo = b_hi + FTILE;
    wgmma_fence();
    // The small products first, then hi·hi.
#pragma unroll
    for (int kk = 0; kk < FBK / 8; ++kk) {
      WgmmaTf32<128>::ss(part, desc_kmajor(a_lo + kk * 32), desc_kmajor(b_hi + kk * 32),
                         kk > 0);
      WgmmaTf32<128>::ss(part, desc_kmajor(a_hi + kk * 32), desc_kmajor(b_lo + kk * 32), 1);
    }
#pragma unroll
    for (int kk = 0; kk < FBK / 8; ++kk)
      WgmmaTf32<128>::ss(part, desc_kmajor(a_hi + kk * 32), desc_kmajor(b_hi + kk * 32), 1);
    wgmma_commit();
    // The next k-step's split runs while the tensor cores work on this one.
    if (kt + 1 < nk) split_step(kt + 1);
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    // Both warpgroups: the next halves written, this step's halves read.
    named_sync(1, CONSUMERS);
  }

  // acc[4j + {0, 1}]: row 16 warp + lane / 4 of the warpgroup's 64,
  // columns n0 + 8j + 2(lane % 4) + {0, 1}; acc[4j + {2, 3}]: 8 rows below.
  const int r = m0 + 64 * g + 16 * warp + lane / 4;
  const bool pairs = N % 2 == 0;  // then (row * N + col) is even: 8-byte aligned
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= M || col >= N) continue;
      float* p = c + static_cast<size_t>(row) * N + col;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (col + 1 < N) p[1] = v1;
      }
    }
  }
}

template <bool A_KM, bool B_KM>
int launch_f32(const void* a, const void* b, void* c, int M, int N, int K,
               int lda, int ldb, cudaStream_t s) {
  // K-major operands in swizzled [128][32] boxes, MN-major ones in
  // unswizzled [32 k][128] boxes.
  CUtensorMap ta, tb;
  int err = A_KM ? encode_map(&ta, a, M, K, FBM, FBK, lda, 4, true)
                 : encode_map(&ta, a, K, M, FBK, FBM, lda, 4, false);
  if (!err)
    err = B_KM ? encode_map(&tb, b, N, K, FBN, FBK, ldb, 4, true)
               : encode_map(&tb, b, K, N, FBK, FBN, ldb, 4, false);
  if (err) return err;
  const int grid = ((M + FBM - 1) / FBM) * ((N + FBN - 1) / FBN);
  return static_cast<int>(launch_cluster(matmul_f32_kernel<A_KM, B_KM>, dim3(grid),
                                         FTHREADS, FSMEM, 1, s, ta, tb,
                                         static_cast<float*>(c), M, N, K));
}

}  // namespace

// c [M, N] row-major = a [M, K] @ b [K, N]. a_t = 0: a row-major with
// leading dimension lda (a[m * lda + k]); a_t = 1: a[k * lda + m]. b_t = 0:
// b[k * ldb + n]; b_t = 1: b[n * ldb + k]. dtype: 0 float32, 1 bfloat16.
// lda and ldb span a multiple of 16 bytes, a and b are 16-byte aligned.
// K may be 0 (c is zeroed).
extern "C" int tiled_matmul(const void* a, const void* b, void* c, int M, int N,
                            int K, int lda, int ldb, int a_t, int b_t, int dtype,
                            void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || lda <= 0 || ldb <= 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 1 ? 2 : 4, vec = 16 / elem;
  if (lda % vec || ldb % vec || !aligned16(a) || !aligned16(b))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 0)
    return static_cast<int>(cudaMemsetAsync(c, 0, static_cast<size_t>(M) * N * elem, s));
  const bool a_km = !a_t, b_km = b_t != 0;
  if (dtype == 1) {
    if (a_km)
      return b_km ? launch_bf16<true, true>(a, b, c, M, N, K, lda, ldb, s)
                  : launch_bf16<true, false>(a, b, c, M, N, K, lda, ldb, s);
    return b_km ? launch_bf16<false, true>(a, b, c, M, N, K, lda, ldb, s)
                : launch_bf16<false, false>(a, b, c, M, N, K, lda, ldb, s);
  }
  if (a_km)
    return b_km ? launch_f32<true, true>(a, b, c, M, N, K, lda, ldb, s)
                : launch_f32<true, false>(a, b, c, M, N, K, lda, ldb, s);
  return b_km ? launch_f32<false, true>(a, b, c, M, N, K, lda, ldb, s)
              : launch_f32<false, false>(a, b, c, M, N, K, lda, ldb, s);
}
