// K2 chain_sweep_epilogue: the per-element work between two sweeps of the
// quantized LightGCN chain, for one side (users or items) in [d, N] layout.
//
//   nh = post[n] * (y[f, n] * s_in[f])        dequantize + left-normalize
//   c  = nh  or  c + nh                       layer combine (optional)
//   z  = pre[n] * nh                          right-normalized next input
//   amax[f] = max_n |z[f, n]|                 for the next quantization
//
// Replaces the completion chunks of idgrec_tpu/ops/chainmm.py
// _make_chain_kernel (mode 'fwd', no activation: _chunk l.322-359 and the
// amax update l.311-320), launched by _chain_call (l.548). The chain's
// prologue uses it too, with post = 1 and s_in = 1 (multiplication by one
// is exact), to combine h0 and form pre * h0.
//
// Bound on the H100: bytes. No tensor cores; every element is read and
// written once, and the per-feature max is one block reduction plus one
// atomicMax per block. The maximum is order-free, so it is exact.
//
// Numerics: the TPU kernel's operation order, post * (raw * s), with
// __fmul_rn/__fadd_rn so that no multiply-add is contracted into an FMA.
//
// chain_sweep_inject is the same pass for the straight-through backward
// chain (mode 'bwd' of the same TPU kernel, the inject branch of _chunk
// l.341-352, driven by _chain_bwd l.700):
//
//   nh    = post[n] * (y[f, n] * s_in[f])
//   store = g[f, n] + nh   or   nh            cotangent inject (optional)
//   out   = pre[n] * store, amax[f] = max |out|   when a sweep follows
//   out   = store                                 on the last sweep
//
// g is read only, and the last sweep's store is the chain's result, so it
// is written also when no next input is wanted. Same bound and numerics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int PER_BLOCK = THREADS * PER_THREAD;

enum Combine { kNone = 0, kSet = 1, kAdd = 2 };

__device__ __forceinline__ float max_abs4(const float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// Block max of `local`, then one atomicMax on the float's bits: for
// non-negative floats the integer order is the float order.
__device__ __forceinline__ void block_atomic_max(float local, float* amax_f) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
  __shared__ float warp_max[THREADS / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_max[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(reinterpret_cast<int*>(amax_f), __float_as_int(m));
  }
}

__global__ void __launch_bounds__(THREADS)
chain_sweep_epilogue_kernel(const float* __restrict__ y, const float* __restrict__ s_in,
                            const float* __restrict__ post, const float* __restrict__ pre,
                            float* __restrict__ c, float* __restrict__ z,
                            float* __restrict__ amax, int n, int combine, int want_next) {
  const int f = blockIdx.y;
  const int n0 = blockIdx.x * PER_BLOCK + threadIdx.x * PER_THREAD;
  const size_t row = static_cast<size_t>(f) * n;
  const float s = s_in[f];
  float local = 0.0f;
  if (n0 < n) {
    const float4 yv = *reinterpret_cast<const float4*>(y + row + n0);
    const float4 pv = *reinterpret_cast<const float4*>(post + n0);
    float4 nh;
    nh.x = __fmul_rn(pv.x, __fmul_rn(yv.x, s));
    nh.y = __fmul_rn(pv.y, __fmul_rn(yv.y, s));
    nh.z = __fmul_rn(pv.z, __fmul_rn(yv.z, s));
    nh.w = __fmul_rn(pv.w, __fmul_rn(yv.w, s));
    if (combine == kSet) {
      *reinterpret_cast<float4*>(c + row + n0) = nh;
    } else if (combine == kAdd) {
      float4 cv = *reinterpret_cast<const float4*>(c + row + n0);
      cv.x = __fadd_rn(cv.x, nh.x);
      cv.y = __fadd_rn(cv.y, nh.y);
      cv.z = __fadd_rn(cv.z, nh.z);
      cv.w = __fadd_rn(cv.w, nh.w);
      *reinterpret_cast<float4*>(c + row + n0) = cv;
    }
    if (want_next) {
      const float4 rv = *reinterpret_cast<const float4*>(pre + n0);
      float4 zv;
      zv.x = __fmul_rn(rv.x, nh.x);
      zv.y = __fmul_rn(rv.y, nh.y);
      zv.z = __fmul_rn(rv.z, nh.z);
      zv.w = __fmul_rn(rv.w, nh.w);
      *reinterpret_cast<float4*>(z + row + n0) = zv;
      local = max_abs4(zv);
    }
  }
  if (!want_next) return;  // uniform across the grid
  block_atomic_max(local, amax + f);
}

__global__ void __launch_bounds__(THREADS)
chain_sweep_inject_kernel(const float* __restrict__ y, const float* __restrict__ s_in,
                          const float* __restrict__ post, const float* __restrict__ pre,
                          const float* __restrict__ g, float* __restrict__ out,
                          float* __restrict__ amax, int n, int inject, int want_next) {
  const int f = blockIdx.y;
  const int n0 = blockIdx.x * PER_BLOCK + threadIdx.x * PER_THREAD;
  const size_t row = static_cast<size_t>(f) * n;
  const float s = s_in[f];
  float local = 0.0f;
  if (n0 < n) {
    const float4 yv = *reinterpret_cast<const float4*>(y + row + n0);
    const float4 pv = *reinterpret_cast<const float4*>(post + n0);
    float4 st;
    st.x = __fmul_rn(pv.x, __fmul_rn(yv.x, s));
    st.y = __fmul_rn(pv.y, __fmul_rn(yv.y, s));
    st.z = __fmul_rn(pv.z, __fmul_rn(yv.z, s));
    st.w = __fmul_rn(pv.w, __fmul_rn(yv.w, s));
    if (inject) {
      const float4 gv = *reinterpret_cast<const float4*>(g + row + n0);
      st.x = __fadd_rn(gv.x, st.x);
      st.y = __fadd_rn(gv.y, st.y);
      st.z = __fadd_rn(gv.z, st.z);
      st.w = __fadd_rn(gv.w, st.w);
    }
    if (want_next) {
      const float4 rv = *reinterpret_cast<const float4*>(pre + n0);
      st.x = __fmul_rn(rv.x, st.x);
      st.y = __fmul_rn(rv.y, st.y);
      st.z = __fmul_rn(rv.z, st.z);
      st.w = __fmul_rn(rv.w, st.w);
      local = max_abs4(st);
    }
    *reinterpret_cast<float4*>(out + row + n0) = st;
  }
  if (!want_next) return;  // uniform across the grid
  block_atomic_max(local, amax + f);
}

}  // namespace

extern "C" {

int chain_sweep_epilogue_elems_per_thread() { return PER_THREAD; }

// y, c, z: f32 [d, n]; s_in, amax: f32 [d]; post, pre: f32 [n]. amax must be
// zeroed when want_next is set. n % 4 == 0 and 16-byte aligned rows.
// Returns cudaGetLastError().
int chain_sweep_epilogue(const void* y, const void* s_in, const void* post,
                         const void* pre, void* c, void* z, void* amax, int d,
                         int n, int combine, int want_next, void* stream) {
  dim3 grid((n + PER_BLOCK - 1) / PER_BLOCK, d);
  chain_sweep_epilogue_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(s_in),
      static_cast<const float*>(post), static_cast<const float*>(pre),
      static_cast<float*>(c), static_cast<float*>(z), static_cast<float*>(amax), n,
      combine, want_next);
  return static_cast<int>(cudaGetLastError());
}

// y, g, out: f32 [d, n]; s_in, amax: f32 [d]; post, pre: f32 [n]. out must
// not alias y or g. amax must be zeroed when want_next is set. n % 4 == 0 and
// 16-byte aligned rows. Returns cudaGetLastError().
int chain_sweep_inject(const void* y, const void* s_in, const void* post,
                       const void* pre, const void* g, void* out, void* amax, int d,
                       int n, int inject, int want_next, void* stream) {
  dim3 grid((n + PER_BLOCK - 1) / PER_BLOCK, d);
  chain_sweep_inject_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(s_in),
      static_cast<const float*>(post), static_cast<const float*>(pre),
      static_cast<const float*>(g), static_cast<float*>(out), static_cast<float*>(amax), n,
      inject, want_next);
  return static_cast<int>(cudaGetLastError());
}

const char* chain_sweep_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
