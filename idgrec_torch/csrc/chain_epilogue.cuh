// The per-element arithmetic of the chain's epilogues, one copy for every
// kernel that runs them: K2 (chain_sweep_epilogue.cu), K9 and K10
// (chain_sweep_tanh.cu) on their own, and the same epilogues in the turn-out
// of K1 and K5 (dual_turns.cuh); and the quantization of K3
// (quantize_rows.cu), which the turn-in of K1 and K5 runs for the chain's
// sweeps. The fused sweeps equal the standalone kernels bit for bit because
// both round through these functions: each operation rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn, and the sources are built with
// -fmad=false), in the TPU kernel's order.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the combine modes of K2 and K9 (chainmm.COMBINE_*)
enum Combine { kNone = 0, kSet = 1, kAdd = 2 };

// K3's per-feature scale from the feature's amax: amax / 127, or 1 where
// amax is not above 0 (NaN included); an infinite amax gives s = inf
__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
}

// K3's rounding of one value: round-half-even(v / s) as int8 (IEEE
// division; a NaN or out-of-range quotient takes __float2int_rn's value,
// then its low byte), as a byte
__device__ __forceinline__ uint32_t q8(float v, float s) {
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(__float2int_rn(__fdiv_rn(v, s)))));
}

// four consecutive values rounded, the first in the low byte
__device__ __forceinline__ uint32_t q8x4(const float4 v, float s) {
  return q8(v.x, s) | (q8(v.y, s) << 8) | (q8(v.z, s) << 16) | (q8(v.w, s) << 24);
}

// dequantize and normalize: post * (y * s)
__device__ __forceinline__ float dequant(float post, float y, float s) {
  return __fmul_rn(post, __fmul_rn(y, s));
}

// (1 - h*h) * store, the derivative of tanh applied (K10)
__device__ __forceinline__ float tanh_grad(float h, float store) {
  return __fmul_rn(__fsub_rn(1.0f, __fmul_rn(h, h)), store);
}

__device__ __forceinline__ float max_abs4(const float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// Block max of `local` over BLOCK_THREADS threads, then one atomicMax on the
// float's bits: for non-negative floats the integer order is the float
// order.
template <int BLOCK_THREADS>
__device__ __forceinline__ void block_atomic_max(float local, float* amax_f) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
  __shared__ float warp_max[BLOCK_THREADS / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_max[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < BLOCK_THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(reinterpret_cast<int*>(amax_f), __float_as_int(m));
  }
}

}  // namespace
