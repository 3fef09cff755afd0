// Pieces of the mma.sync flash-attention kernel flash_dq.cu: the tile
// size, the row-tile loader, the split score product and the accumulating
// product. (flash_fwd.cu and flash_dkv.cu are warpgroup kernels built on
// hopper.cuh instead.)
//
// q, k, v, do and the outputs are [batch * heads, S, D] bf16, row-major,
// S a multiple of 16 and D (head_dim) a multiple of 16 up to 1024. The
// kernel walks 16-row tiles with 256 threads (8 warps), and every warp
// owns the same slice of head_dim: d-fragment f (16 columns) belongs to
// warp f % 8, so a warp holds FR <= 1024 / 16 / 8 = 8 f32 accumulator
// fragments of each [16, D] accumulator (64 registers a thread). A score
// tile [16, 16] is a sum over head_dim, so each warp computes a partial
// tile over its slice and the eight partials meet in shared memory
// (`red`), where one thread per element adds them up and applies the
// softmax arithmetic; the bf16 [16, 16] tile it writes (p or ds) is then
// the A operand every warp multiplies into its own slice.
//
// Row tiles [16, D] are stored with a pitch of D + 8 elements: rows start
// an odd multiple of 16 bytes apart modulo 128, so the eight rows that one
// ldmatrix phase reads fall in eight distinct bank groups.

#pragma once

#include <float.h>
#include <math.h>

#include "mma_tiles.cuh"

namespace flash {

using namespace mma_tiles;
using bf16 = __nv_bfloat16;

constexpr int TILE = 16;      // query or key rows a tile
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 1024;
constexpr int FRAG = TILE * TILE;  // elements of one score tile
constexpr int PLD = TILE + 8;      // pitch of a bf16 [16][16] tile (48 bytes)
// The library's additive causal mask (-0.7 * float32 max).
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

static_assert(FRAG == THREADS, "one thread per element of a score tile");

__host__ __device__ inline int pitch(int D) { return D + 8; }
inline size_t tile_bytes(int D) {
  return static_cast<size_t>(TILE) * pitch(D) * 2;
}

// Accumulator fragments a warp needs at head_dim D, rounded up to the
// instantiated 1, 2, 4 or 8.
inline int frags_per_warp(int D) {
  const int need = (D / TILE + WARPS - 1) / WARPS;
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
}

// Rows [r0, r0 + 16) of a [S, D] matrix -> dst [16][pitch], by cp.async.
__device__ __forceinline__ void load_tile(uint16_t* dst,
                                          const uint16_t* __restrict__ src,
                                          int r0, int D, int tid) {
  const int chunks = D / 8, ld = pitch(D);
  for (int idx = tid; idx < TILE * chunks; idx += THREADS) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    cp_async16(dst + r * ld + c, src + static_cast<size_t>(r0 + r) * D + c,
               true);
  }
}

// This warp's partial scores [16 a-rows, 16 b-rows] = sum over its
// d-fragments f of a[:, 16f:16f+16] @ b[:, 16f:16f+16]^T, stored to its
// slot of `red`. `a` and `b` are [16][pitch] row tiles (q and k, or do and
// v); b's rows are the n of the product, read without .trans. Two sets of
// accumulators halve the dependent chain of tensor-core ops.
template <int FR>
__device__ __forceinline__ void partial_scores(const uint16_t* a,
                                               const uint16_t* b, int D,
                                               int warp, int lane,
                                               const Lanes& ln, float* red) {
  const int nd = D / TILE, ld = pitch(D);
  float acc[2][2][4] = {};
#pragma unroll
  for (int j = 0; j < FR; ++j) {
    const int f = warp + WARPS * j;
    if (f < nd) {
      unsigned fa[4], fb[4];
      ldsm_x4(fa, a + ln.a_m * ld + f * TILE + ln.a_k0);
      ldsm_x4(fb, b + ln.bn_n * ld + f * TILE + ln.bn_half * 8);
      mma16816(acc[j & 1][0], fa, fb[0], fb[1]);
      mma16816(acc[j & 1][1], fa, fb[2], fb[3]);
    }
  }
  const int g = lane / 4, c = (lane % 4) * 2;
  float* slot = red + warp * FRAG;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    *reinterpret_cast<float2*>(slot + g * TILE + nt * 8 + c) = make_float2(
        acc[0][nt][0] + acc[1][nt][0], acc[0][nt][1] + acc[1][nt][1]);
    *reinterpret_cast<float2*>(slot + (g + 8) * TILE + nt * 8 + c) =
        make_float2(acc[0][nt][2] + acc[1][nt][2],
                    acc[0][nt][3] + acc[1][nt][3]);
  }
}

// Element `tid` (row tid / 16, column tid % 16) of the summed score tile.
__device__ __forceinline__ float sum_slots(const float* red, int tid) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w * FRAG + tid];
  return s;
}

// acc[16, this warp's d-fragments] += t[16, 16] @ b[16, D]: `t` a bf16
// [16][PLD] tile (p, ds or their transposes), `b` a [16][pitch] row tile
// whose rows are the k of the product, read with .trans.
template <int FR>
__device__ __forceinline__ void accumulate(float (&acc)[FR][2][4],
                                           const bf16* t, const uint16_t* b,
                                           int D, int warp, const Lanes& ln) {
  const int nd = D / TILE, ld = pitch(D);
  unsigned fa[4];
  ldsm_x4(fa, t + ln.a_m * PLD + ln.a_k0);
#pragma unroll
  for (int j = 0; j < FR; ++j) {
    const int f = warp + WARPS * j;
    if (f < nd) {
      unsigned fb[4];
      ldsm_x4_t(fb, b + ln.bt_k * ld + f * TILE + ln.bt_half * 8);
      mma16816(acc[j][0], fa, fb[0], fb[1]);
      mma16816(acc[j][1], fa, fb[2], fb[3]);
    }
  }
}

// out[r0 + row, :] = acc * scale of the row, in bf16: lane l holds rows
// l / 4 (scaled by s0) and l / 4 + 8 (by s1) of each of its fragments.
template <int FR>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[FR][2][4],
                                           int r0, int D, int warp, int lane,
                                           float s0, float s1) {
  const int nd = D / TILE, g = lane / 4, c = (lane % 4) * 2;
  bf16* row0 = out + static_cast<size_t>(r0 + g) * D;
  bf16* row1 = row0 + static_cast<size_t>(8) * D;
#pragma unroll
  for (int j = 0; j < FR; ++j) {
    const int f = warp + WARPS * j;
    if (f < nd) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = f * TILE + nt * 8 + c;
        *reinterpret_cast<__nv_bfloat162*>(row0 + col) =
            __floats2bfloat162_rn(acc[j][nt][0] * s0, acc[j][nt][1] * s0);
        *reinterpret_cast<__nv_bfloat162*>(row1 + col) =
            __floats2bfloat162_rn(acc[j][nt][2] * s1, acc[j][nt][3] * s1);
      }
    }
  }
}

}  // namespace flash
