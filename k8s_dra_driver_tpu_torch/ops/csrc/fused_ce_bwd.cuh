// Pieces shared by the fused-CE backward kernels (fused_ce_dx.cu,
// fused_ce_dw.cu): the tile size, the shared-memory loaders, the
// tensor-core primitives and the recompute of one [16 tokens, 16 vocab]
// tile of p.
//
// Both kernels give each warp of a 256-thread block the same slice of the
// model dimension: d-fragment f (16 columns of d_model) belongs to warp
// f % 8, so a warp holds at most MAX_FRAGS = 2048 / 16 / 8 = 16 f32
// accumulator fragments (128 registers a thread) and d_model <= 2048.
// The logits of a tile are a sum over d_model, so each warp computes a
// partial [16, 16] tile over its slice, and the eight partials meet in
// shared memory (`red`), where one thread per element adds them and forms
//     p = (where(v < V, exp(logit - lse[t]), 0) - (v == label[t])) * g[t]
// rounded to bf16 for the second tensor-core product (f32 accumulate).
//
// Products are mma.sync m16n8k16 (bf16 in, f32 accumulate, from
// mma_tiles.cuh) on fragments loaded with ldmatrix, whose .trans form
// reads an operand stored the other way round: one shared tile serves as
// B of x @ w and of p @ w^T (or as A of x @ w and of x^T @ p) with no
// transposed copy. A [16, 16] tile of w columns is stored as 16 rows of
// 32 bytes with the two 16-byte halves of rows 4-7 and 12-15 swapped
// (`wsw`), so the eight rows that one ldmatrix phase reads fall in eight
// distinct bank groups.

#pragma once

#include <math.h>

#include "mma_tiles.cuh"

namespace fused_ce_bwd {

using namespace mma_tiles;

using bf16 = __nv_bfloat16;

constexpr int TILE = 16;                 // token rows or vocab columns a step
constexpr int THREADS = 256;             // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 2048;
constexpr int MAX_FRAGS = MAX_D / TILE / WARPS;  // d-fragments a warp: 16
constexpr int FRAG = TILE * TILE;        // elements of one 16x16 tile
constexpr int PLD = TILE + 8;            // pitch of the bf16 p tile (48 bytes)

static_assert(FRAG == THREADS, "one thread per element of a p tile");

// Padded d_model (a multiple of 16) and the pitch of a [16, dp] row tile,
// padded by 8 against bank conflicts.
__host__ __device__ inline int padded_d(int D) { return (D + TILE - 1) / TILE * TILE; }
__host__ __device__ inline int row_pitch(int dp) { return dp + 8; }

// Bytes of the common tail: the eight partial-logits slots and the p tile.
constexpr int TAIL_BYTES = WARPS * FRAG * 4 + TILE * PLD * 2;

// Offset of 16-byte chunk `half` (0 or 1) of row k of a [dp][16] tile.
__device__ __forceinline__ int wsw(int k, int half) {
  return k * TILE + ((half ^ ((k >> 2) & 1)) << 3);
}

// x[t0:t0+16, 0:dp] -> dst [16][pitch], zero outside [T, D]. VEC: D is a
// multiple of 8 and x 16-byte aligned, so each 8-element chunk is wholly
// in or out and goes by one cp.async; otherwise element by element.
template <bool VEC>
__device__ __forceinline__ void load_rows(uint16_t* dst,
                                          const uint16_t* __restrict__ x,
                                          int t0, int T, int D, int dp,
                                          int pitch, int tid) {
  const int chunks = dp / 8;
  for (int idx = tid; idx < TILE * chunks; idx += THREADS) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    const int row = t0 + r;
    uint16_t* d = dst + r * pitch + c;
    if (VEC) {
      const bool ok = row < T && c < D;
      cp_async16(d, ok ? x + static_cast<size_t>(row) * D + c : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (row < T && c + e < D) ? x[static_cast<size_t>(row) * D + c + e]
                                      : uint16_t(0);
    }
  }
}

// w[0:dp, v0:v0+16] -> dst [dp][16] in the `wsw` layout, zero outside
// [D, V]. VEC: V and D multiples of 8, w 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void load_cols(uint16_t* dst,
                                          const uint16_t* __restrict__ w,
                                          int v0, int D, int V, int dp,
                                          int tid) {
  for (int idx = tid; idx < dp * 2; idx += THREADS) {
    const int k = idx >> 1, half = idx & 1;
    const int col = v0 + half * 8;
    uint16_t* d = dst + wsw(k, half);
    if (VEC) {
      const bool ok = k < D && col < V;
      cp_async16(d, ok ? w + static_cast<size_t>(k) * V + col : w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (k < D && col + e < V) ? w[static_cast<size_t>(k) * V + col + e]
                                      : uint16_t(0);
    }
  }
}

// This warp's partial logits [16 t, 16 v] = sum over its d-fragments f of
// x[16 t, 16 d_f] @ w[16 d_f, 16 v], stored to its slot of `red`. `xs` is
// a [16][xld] row tile, `ws` a [dp][16] tile of w columns. Two sets of
// accumulators halve the dependent chain of tensor-core ops.
__device__ __forceinline__ void partial_logits(const uint16_t* xs, int xld,
                                               const uint16_t* ws, int nd,
                                               int warp, int lane,
                                               const Lanes& ln, float* red) {
  float l[2][2][4] = {};
#pragma unroll
  for (int j = 0; j < MAX_FRAGS; ++j) {
    const int f = warp + WARPS * j;
    if (f < nd) {
      unsigned a[4], b[4];
      ldsm_x4(a, xs + ln.a_m * xld + f * TILE + ln.a_k0);
      ldsm_x4_t(b, ws + wsw(f * TILE + ln.bt_k, ln.bt_half));
      mma16816(l[j & 1][0], a, b[0], b[1]);
      mma16816(l[j & 1][1], a, b[2], b[3]);
    }
  }
  const int g = lane / 4, c = (lane % 4) * 2;
  float* slot = red + warp * FRAG;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    *reinterpret_cast<float2*>(slot + g * TILE + nt * 8 + c) =
        make_float2(l[0][nt][0] + l[1][nt][0], l[0][nt][1] + l[1][nt][1]);
    *reinterpret_cast<float2*>(slot + (g + 8) * TILE + nt * 8 + c) =
        make_float2(l[0][nt][2] + l[1][nt][2], l[0][nt][3] + l[1][nt][3]);
  }
}

// Element `tid` of the p tile (row tid / 16, column tid % 16), from the
// eight partials, into ps [16][PLD]. `v` is its vocab column; lse, g and
// label its row's.
__device__ __forceinline__ void p_element(const float* red, bf16* ps,
                                          float lse, float g, int label,
                                          int v, int V, int tid) {
  float logit = 0.f;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) logit += red[k * FRAG + tid];
  float p = v < V ? expf(logit - lse) : 0.f;
  if (v == label) p -= 1.f;
  ps[(tid / TILE) * PLD + tid % TILE] = __float2bfloat16(p * g);
}

}  // namespace fused_ce_bwd
