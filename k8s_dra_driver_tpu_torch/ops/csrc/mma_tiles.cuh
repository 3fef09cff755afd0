// Tensor-core and copy primitives shared by the port's mma.sync kernels
// (fused_ce_dx.cu, fused_ce_dw.cu):
// cp.async copies into shared memory
// (16 bytes, or 16 bytes of which only a leading part is read), ldmatrix
// (plain and .trans) fragment loads, and mma.sync m16n8k16 (bf16 in, f32
// accumulate), with the per-lane ldmatrix offsets of the operand layouts
// the kernels use.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tiles {

// The first `bytes` (0 to 16) of the 16 at gmem; the rest are zeroed.
__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem,
                                             int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  cp_async16_n(smem, gmem, pred ? 16 : 0);  // 0 source bytes: all zeroed
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each matrix, row l / 4, columns 2(l % 4) and +1
// (.trans: rows 2(l % 4) and +1, column l / 4).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d[16x8] += a[16x16] @ b[16x8], bf16 in, f32 accumulate. Lane l holds
// d rows l/4 and l/4 + 8, columns 2(l % 4) and +1.
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Per-lane ldmatrix offsets (elements) into the operand layouts used here.
// A [16 m, 16 k] and B [16 k, 16 n] fragments of one m16n8k16 pair: B's
// four registers are (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
// (k 8-15, n 8-15), so b[0..1] and b[2..3] feed the two n8 products.
struct Lanes {
  int a_m, a_k0;      // A from an m-major tile: row a_m, column a_k0
  int bt_k, bt_half;  // B from a k-major tile ([k][n] rows), .trans
  int bn_n, bn_half;  // B from an n-major tile ([n][k] rows)
  int at_k, at_m0;    // A from a k-major tile ([k][m] rows), .trans
  __device__ explicit Lanes(int lane) {
    const int r = lane % 8, j = lane / 8;
    a_m = r + (j % 2) * 8;
    a_k0 = (j / 2) * 8;
    bt_k = r + (j % 2) * 8;
    bt_half = j / 2;
    bn_n = r + (j / 2) * 8;
    bn_half = j % 2;
    at_k = r + (j / 2) * 8;
    at_m0 = (j % 2) * 8;
  }
};

}  // namespace mma_tiles
