// PTX wrappers shared by the tensor-core kernels of this directory: cp.async
// staging, ldmatrix fragment loads and the mma.sync products. Each source
// that includes this header compiles into its own library (ops/_build.py,
// whose library hash covers this file too).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// cp_async16 that, when valid is false, reads nothing and fills the 16 bytes
// with zeros.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory: for int8 data, exactly the
// A fragment of mma m16n8k32 when lane l points at row (l & 7) + 8 * ((l >> 3) & 1)
// of the 16-row tile, byte offset 16 * (l >> 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The B fragments of one or two n8 tiles from a [k][n] bf16 tile: lane l
// points at k row (l & 7) + 8 * ((l >> 3) & 1) of n tile l >> 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const uint16_t* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// The B fragments of NT n8 tiles, k rows k0 .. k0 + 15 of a [k][pitch] bf16
// tile in shared memory.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], const uint16_t* tile, int pitch,
                                       int k0, int lane) {
  if constexpr (NT == 1) {
    uint32_t r[2];
    ldmatrix_x2_trans(r, tile + (k0 + (lane & 15)) * pitch);
    b[0][0] = r[0];
    b[0][1] = r[1];
  } else {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      const int q = lane >> 3;
      ldmatrix_x4_trans(r, tile + (k0 + (lane & 7) + 8 * (q & 1)) * pitch + (j + (q >> 1)) * 8);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
  }
}

// D += A . B, A [16 rows, 32 k] and B [32 k, 8 n], int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A . B, A [16 rows, 16 k] and B [16 k, 8 n], bf16 in, f32 accumulation.
// a0/a2 belong to row g, a1/a3 to row g + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
