// K3 quantize_rows: symmetric per-feature int8 quantization of an
// activation in [d, N] layout, given its per-feature absolute maximum.
//
//   s[f] = amax[f] > 0 ? amax[f] / 127 : 1
//   q[f, n] = round_half_even(z[f, n] / s[f])          -> int8
//
// Replaces the quantization of idgrec_tpu/ops/propagate.py _quantize_rows
// (l.236), run by the chain prologue (ops/chainmm.py _run_chain l.670-671)
// and inside _make_chain_kernel for every sweep (the lazy round, l.236-260).
// The chain's sweeps round in the turn-in of K1 and K5 (dual_turns.cuh)
// through the same functions; this kernel serves the per-layer route
// (ops/propagate.py quant_fused_dual_t) and is the reference the fold is
// held to.
//
// Bound on the H100: bytes (4 bytes read and 1 written per element).
//
// Numerics: IEEE division (__fdiv_rn) and round-half-even (__float2int_rn),
// as jnp.round(z / s) computes; no fast-math (chain_epilogue.cuh scale_of,
// q8).

#include "chain_epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int PER_BLOCK = THREADS * PER_THREAD;

__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const float* __restrict__ z, const float* __restrict__ amax,
                     int8_t* __restrict__ q, float* __restrict__ scale, int n) {
  const int f = blockIdx.y;
  const float s = scale_of(amax[f]);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[f] = s;
  const int n0 = blockIdx.x * PER_BLOCK + threadIdx.x * PER_THREAD;
  if (n0 >= n) return;
  const size_t row = static_cast<size_t>(f) * n;
  const float4 v = *reinterpret_cast<const float4*>(z + row + n0);
  *reinterpret_cast<uint32_t*>(q + row + n0) = q8x4(v, s);
}

}  // namespace

extern "C" {

// z: f32 [d, n]; amax, scale: f32 [d]; q: int8 [d, n]. n % 4 == 0 and
// 16-byte aligned rows. Returns cudaGetLastError().
int quantize_rows(const void* z, const void* amax, void* q, void* scale, int d, int n,
                  void* stream) {
  dim3 grid((n + PER_BLOCK - 1) / PER_BLOCK, d);
  quantize_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(amax),
      static_cast<int8_t*>(q), static_cast<float*>(scale), n);
  return static_cast<int>(cudaGetLastError());
}

const char* quantize_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
