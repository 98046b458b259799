// Tensor-core building blocks for bf16 kernels on Hopper (sm_90a), shared by
// the flash kernels: 16-byte cp.async tile loads with zero fill, ldmatrix
// (plain and transposed) and mma.sync m16n8k16 with fp32 accumulators.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16" for .bf16), with lane = 32-thread
// lane, g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][8+2t..], a3 = A[g+8][8+2t..];
//   B (16 x 8, "col": consecutive k of one column n in one register):
//     b0 = B[2t..2t+1][g], b1 = B[8+2t..8+2t+1][g];
//   C (16 x 8, fp32): c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16 and
// packed in pairs, are the A fragment of one 16-deep step: a score tile
// computed by one product feeds the next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; when `fill` is false nothing is read and the 16
// bytes are zeroed (source size 0).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(fill ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zeroed when `fill` is false.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of one head of a [B, S, heads, D] bf16 tensor (`src`
// points at row 0 of the head, `stride` elements between rows) into a shared
// tile of ROWS rows of LD elements, by NTHREADS threads, 16 bytes per copy.
// Rows past S are zero-filled and their source is never read.
template <int ROWS, int D, int LD, int NTHREADS>
__device__ __forceinline__ void cp_async_tile(bf16* dst, const bf16* src, long stride, int r0,
                                              int S) {
  constexpr int CHUNKS = D / 8;
  static_assert(D % 8 == 0 && LD % 8 == 0, "rows are copied in 16-byte chunks");
  static_assert(ROWS * CHUNKS % NTHREADS == 0, "every thread copies as many chunks");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NTHREADS; ++i) {
    const int e = threadIdx.x + i * NTHREADS;
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    const int pos = r0 + r;
    const bool in = pos < S;
    cp_async_16(dst + r * LD + c, src + long(in ? pos : 0) * stride + c, in);
  }
}

// ROWS fp32 values src[r0 ..] into dst, zero past S (never read there).
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void cp_async_rows(float* dst, const float* src, int r0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += NTHREADS) {
    const int pos = r0 + r;
    const bool in = pos < S;
    cp_async_4(dst + r, src + (in ? pos : 0), in);
  }
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8, and register i receives matrix i in the A/B/C
// fragment order above (row g, columns 2t and 2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed: register i holds rows 2t and 2t+1
// of column g of the stored matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Lane offsets (row, column) into a row-major shared tile for the three
// ldmatrix_x4 uses, each covering 16 rows x 16 columns from (0, 0):
//  - an A fragment of a row-major [m][k] tile, or two k-major B fragments
//    (8 columns n each) of a row-major [k][n] tile with the .trans load:
//    row l % 16, column (l / 16) * 8;
//  - two B fragments (8 rows n each) of an n-major [n][k] tile, plain load:
//    row (l % 8) + (l / 16) * 8, column ((l / 8) % 2) * 8.
__device__ __forceinline__ int frag_row_a(int lane) { return lane & 15; }
__device__ __forceinline__ int frag_col_a(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int frag_row_bn(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int frag_col_bn(int lane) { return ((lane >> 3) & 1) << 3; }

// c += a . b on the tensor cores: 16 x 8 fp32 += (16 x 16 bf16) . (16 x 8 bf16).
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even) in one register, lo in the
// low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of 16-deep step j from C fragments c[2j], c[2j+1] (the 16
// columns 16j .. 16j+15 of a 16-row score tile), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

}  // namespace mma_bf16
