// PTX wrappers shared by the kernels of this directory: cp.async staging,
// mbarriers and bulk copies, ldmatrix fragment loads and the mma.sync
// products. Each source
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier whose phase completes after `count` arrivals (and the bytes
// that bulk copies announced).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// An arrival on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// bytes from global src into shared dst by the copy engine, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// waits until bar's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
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
