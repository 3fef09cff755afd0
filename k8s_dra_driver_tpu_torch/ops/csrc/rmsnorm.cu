// Fused RMSNorm over the last dim, for Hopper (sm_90a).
//
// Replaces k8s_dra_driver_tpu/ops/kernels.py:40, _rmsnorm_kernel (the
// Pallas TPU kernel launched by _rmsnorm_forward, :58):
//     y[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * g)   in f32,
// written in x's dtype. x is f32 or bf16, g f32 or bf16, each any mix.
//
// Bound: bytes. Each element of x is read and each of y written once, with
// a handful of flops between; at [4096, 2048] bf16 that is 33.6 MB, 10.0 us
// at 3.35 TB/s (f32: 67.1 MB, 20.0 us). g (d elements) stays in L1/L2.
//
// Design. The Pallas kernel kept a (block_rows, d) block in VMEM. Here,
// where d is a whole number of 16-byte chunks and the pointers are 16-byte
// aligned (the vector kernels), a row lives in registers:
//  - Rows a warp. A group of L lanes (a power of two, 4 to 32) owns a row,
//    each lane NC chunks of it as raw 16-byte words (chunks = d / V, V
//    elements a chunk; NC * L >= chunks): at d = 2048 in bf16, 8 chunks a
//    lane; at d = 128 in bf16 L = 16, two rows a warp. The f32 sum of
//    squares is reduced with L-lane shuffles only: no shared memory and no
//    block barrier.
//  - Walk. A grid of as many blocks of 8 warps as fit the card at once
//    (at bf16 [4096, 2048], every row at once) walks the rows. At up to 4
//    chunks a lane each lane group issues the loads of its next row
//    before it stores this one; at 8 the second buffer would cost the SM
//    half its warps, and was slower. g (d elements, in L1) is read once a
//    row.
//  - Wide rows. Above 8 chunks a lane (bf16 d > 2048, f32 d > 1024) a
//    block of up to 256 threads owns a row instead, keeps up to CACHE
//    chunks a thread in registers and sums across warps through shared
//    memory: at 16 chunks a lane the rows-a-warp form was no faster in
//    f32 and slower in bf16.
// Otherwise (odd d such as 7 or 129, or an unaligned pointer) a block a
// row walks single elements and reads its row twice. rsqrt(mean + eps) is
// taken once a row.
//
// Plain C interface (loaded with ctypes): rmsnorm returns the CUDA error
// code of the launch, 0 on success. It allocates nothing and launches on
// the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_THREADS = 256;  // the block-a-row kernels
constexpr int ROW_THREADS = 256;  // 8 warps: the rows-a-warp kernel
constexpr int CACHE = 4;  // 16-byte chunks of x a thread keeps in registers

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, bf16* out) { *out = __float2bfloat16(v); }

// N elements of U at p, whose address is a multiple of N * sizeof(U)
// bytes (8 or a multiple of 16), as floats.
template <typename U, int N>
__device__ __forceinline__ void load_f(const U* __restrict__ p, float (&out)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(U));
  static_assert(BYTES == 8 || BYTES % 16 == 0, "whole 8- or 16-byte words");
  alignas(16) U tmp[N];
  if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(tmp) = *reinterpret_cast<const uint2*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<int4*>(tmp)[i] = reinterpret_cast<const int4*>(p)[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(tmp[i]);
}

// One 16-byte chunk of T at p (16-byte aligned) from floats.
template <typename T, int N>
__device__ __forceinline__ void store_f(T* __restrict__ p, const float (&v)[N]) {
  static_assert(N * sizeof(T) == 16, "one 16-byte chunk");
  alignas(16) T tmp[N];
#pragma unroll
  for (int i = 0; i < N; ++i) from_f(v[i], &tmp[i]);
  *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(tmp);
}

// One 16-byte word of N elements of T as floats.
template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4& w, float (&out)[N]) {
  alignas(16) T tmp[N];
  *reinterpret_cast<uint4*>(tmp) = w;
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(tmp[i]);
}

// Rows in registers: see "Rows a warp" above. chunks <= NC * L <= 256.
template <typename T, typename G, int NC, int L>
__global__ void __launch_bounds__(ROW_THREADS)
rmsnorm_rows_kernel(const T* __restrict__ x, const G* __restrict__ g,
                    T* __restrict__ y, int rows, int chunks, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int RPW = 32 / L;  // rows a warp holds at once
  // The next row's loads go out before this row's stores only where the
  // second buffer costs few registers: at 8 chunks a lane it would halve
  // the warps an SM holds, and all of them in flight at once are faster.
  constexpr bool PREFETCH = NC <= 4;
  const int lane = threadIdx.x % 32, sub = lane % L;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int stride = gridDim.x * blockDim.x / 32 * RPW;
  const size_t d = static_cast<size_t>(chunks) * V;

  auto load_row = [&](int row, uint4 (&w)[NC]) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + i * L;
      w[i] = row < rows && c < chunks
                 ? *reinterpret_cast<const uint4*>(x + row * d + c * V)
                 : make_uint4(0, 0, 0, 0);
    }
  };

  // The loop bound is the same for every lane of the warp, so the shuffles
  // always see all 32; lanes past the last row load zeros, store nothing.
  int row = warp * RPW + lane / L;
  uint4 cur[NC], nxt[NC];
  if constexpr (PREFETCH) load_row(row, cur);
  for (int base = warp * RPW; base < rows; base += stride, row += stride) {
    if constexpr (PREFETCH) load_row(row + stride, nxt);
    else load_row(row, cur);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      float v[V];
      unpack<T, V>(cur[i], v);
#pragma unroll
      for (int e = 0; e < V; ++e) ss += v[e] * v[e];
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = sub + i * L;
        if (c < chunks) {
          float v[V], gv[V];
          unpack<T, V>(cur[i], v);
          load_f<G, V>(g + c * V, gv);
#pragma unroll
          for (int e = 0; e < V; ++e) v[e] = v[e] * r * gv[e];
          store_f<T, V>(y + row * d + c * V, v);
        }
      }
    }
    if constexpr (PREFETCH) {
#pragma unroll
      for (int i = 0; i < NC; ++i) cur[i] = nxt[i];
    }
  }
}

// Sum of v over the block (blockDim.x a multiple of 32), returned to every
// thread: shuffles within each warp, then each warp sums the partials.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x / 32) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Wide rows: d % V == 0 and x, y, g 16-byte aligned (V elements of T in a
// chunk).
template <typename T, typename G>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_vec_kernel(const T* __restrict__ x, const G* __restrict__ g,
                   T* __restrict__ y, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const T* xr = x + base;
  T* yr = y + base;
  const int chunks = d / V, step = blockDim.x;

  float cache[CACHE][V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CACHE; ++i) {
    const int c = threadIdx.x + i * step;
    if (c < chunks) {
      load_f<T, V>(xr + c * V, cache[i]);
#pragma unroll
      for (int e = 0; e < V; ++e) ss += cache[i][e] * cache[i][e];
    }
  }
  for (int c = threadIdx.x + CACHE * step; c < chunks; c += step) {
    float v[V];
    load_f<T, V>(xr + c * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) ss += v[e] * v[e];
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < CACHE; ++i) {
    const int c = threadIdx.x + i * step;
    if (c < chunks) {
      float gv[V], out[V];
      load_f<G, V>(g + c * V, gv);
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = cache[i][e] * r * gv[e];
      store_f<T, V>(yr + c * V, out);
    }
  }
  for (int c = threadIdx.x + CACHE * step; c < chunks; c += step) {
    float v[V], gv[V];
    load_f<T, V>(xr + c * V, v);
    load_f<G, V>(g + c * V, gv);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = v[e] * r * gv[e];
    store_f<T, V>(yr + c * V, v);
  }
}

// Any d and alignment: element by element, the row read twice.
template <typename T, typename G>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_scalar_kernel(const T* __restrict__ x, const G* __restrict__ g,
                      T* __restrict__ y, int d, float eps) {
  __shared__ float red[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const T* xr = x + base;
  T* yr = y + base;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    from_f(to_f(xr[i]) * r * to_f(g[i]), &yr[i]);
}

int threads_for(int work) {
  const int t = (work + 31) / 32 * 32;
  return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// As many blocks as fit the card at once, and no more than the rows need.
template <typename T, typename G, int NC, int L>
cudaError_t launch_rows(const T* x, const G* g, T* y, int rows, int chunks,
                        float eps, cudaStream_t stream) {
  auto kernel = rmsnorm_rows_kernel<T, G, NC, L>;
  static int resident = 0;  // blocks on the card at once
  if (!resident) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                  ROW_THREADS, 0);
    if (err) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int per_block = ROW_THREADS / 32 * (32 / L);  // rows a block holds
  const int need = (rows + per_block - 1) / per_block;
  kernel<<<need < resident ? need : resident, ROW_THREADS, 0, stream>>>(
      x, g, y, rows, chunks, eps);
  return cudaGetLastError();
}

template <typename T, typename G>
int launch(const void* x, const void* g, void* y, int rows, int d, float eps,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const G* gt = static_cast<const G*>(g);
  T* yt = static_cast<T*>(y);
  if (d % V || !aligned16(x) || !aligned16(y) || !aligned16(g)) {
    rmsnorm_scalar_kernel<T, G><<<rows, threads_for(d), 0, stream>>>(xt, gt, yt, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = d / V;
  cudaError_t err;
  if (chunks <= 4) err = launch_rows<T, G, 1, 4>(xt, gt, yt, rows, chunks, eps, stream);
  else if (chunks <= 8) err = launch_rows<T, G, 1, 8>(xt, gt, yt, rows, chunks, eps, stream);
  else if (chunks <= 16) err = launch_rows<T, G, 1, 16>(xt, gt, yt, rows, chunks, eps, stream);
  else if (chunks <= 32) err = launch_rows<T, G, 1, 32>(xt, gt, yt, rows, chunks, eps, stream);
  else if (chunks <= 64) err = launch_rows<T, G, 2, 32>(xt, gt, yt, rows, chunks, eps, stream);
  else if (chunks <= 128) err = launch_rows<T, G, 4, 32>(xt, gt, yt, rows, chunks, eps, stream);
  else if (chunks <= 256) err = launch_rows<T, G, 8, 32>(xt, gt, yt, rows, chunks, eps, stream);
  else {
    rmsnorm_vec_kernel<T, G><<<rows, threads_for(chunks), 0, stream>>>(xt, gt, yt, d, eps);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// x_dtype, g_dtype: 0 float32, 1 bfloat16. x and y are [rows, d] row-major.
extern "C" int rmsnorm(const void* x, const void* g, void* y, int rows, int d,
                       float eps, int x_dtype, int g_dtype, void* stream) {
  if (rows <= 0 || d <= 0 || x_dtype < 0 || x_dtype > 1 || g_dtype < 0 || g_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + g_dtype) {
    case 0: return launch<float, float>(x, g, y, rows, d, eps, s);
    case 1: return launch<float, bf16>(x, g, y, rows, d, eps, s);
    case 2: return launch<bf16, float>(x, g, y, rows, d, eps, s);
    default: return launch<bf16, bf16>(x, g, y, rows, d, eps, s);
  }
}
