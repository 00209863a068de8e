// bf16 x bf16 -> fp32 tensor-core pieces for NVIDIA Hopper (sm_90a), as
// inline PTX: `mma.sync.aligned.m16n8k16` with its operands loaded from
// shared memory by `ldmatrix`, and the `cp.async` copies that stage them.
// Used by int_split.cu (the tensor-core probe, tc_occupancy.cu, runs
// wgmma: hopper_async.cuh).
//
// Fragments of one m16n8k16 product (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), lane l, g = l / 4, c = l % 4:
//   A 16 x 16 row-major, 4 registers of 2 bf16: (g, 2c..2c+1),
//     (g + 8, 2c..), (g, 2c + 8..), (g + 8, 2c + 8..);
//   B 16 x 8 "col" (k-major per column), 2 registers: rows (2c, 2c + 1) and
//     (2c + 8, 2c + 9) of column g;
//   C/D 16 x 8 fp32, 4 registers: (g, 2c), (g, 2c + 1), (g + 8, 2c),
//     (g + 8, 2c + 1).
// `ldmatrix_a` loads A from a row-major tile; `ldmatrix_b2` loads two
// B fragments (16 k x 16 n) from a ROW-major [k][n] tile with .trans, so the
// k-major tile needs no transposed copy.  Row pitches should be an
// odd multiple of 16 bytes (e.g. 8 bf16 of padding per row): the eight row
// addresses of one 8 x 8 matrix then fall in distinct bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wrp {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy, asynchronous (L2 only: .cg)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major bf16
// tile with row pitch `pitch` elements.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                           int pitch, int r0, int k0, int lane) {
  // lanes 8i..8i+7 address the rows of 8 x 8 matrix i: i & 1 picks rows
  // +8, i >> 1 columns +8 (the a0..a3 order above)
  const __nv_bfloat16* p =
      tile + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * pitch + k0 + 8 * (lane >> 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The B fragments of columns n0..n0+7 (b[0], b[1]) and n0+8..n0+15 (b[2],
// b[3]), rows k0..k0+15, of a ROW-major [k][n] bf16 tile with row pitch
// `pitch` elements.
__device__ __forceinline__ void ldmatrix_b2(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                            int pitch, int k0, int n0, int lane) {
  const __nv_bfloat16* p =
      tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * pitch + n0 + 8 * (lane >> 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(p)));
}

// d += A B on the tensor cores, bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace wrp
