// K9 chain_sweep_tanh and K10 chain_sweep_tanh_inject: the per-element work
// between two sweeps of the quantized tanh chain (EGCF), for one side (users
// or items) in [d, N] layout.
//
// K9, one side of one forward sweep:
//
//   h  = tanh(post[n] * (y[f, n] * s_in[f]))  dequantize, normalize, tanh
//   hs[f, n] = h                              the h stream the backward reads
//   c  = h  or  c + h                         layer combine (optional)
//   z  = pre[n] * h                           next input, when a sweep follows
//   amax[f] = max_n |z[f, n]|                 for the next quantization
//
// K10, one side of one backward sweep:
//
//   store = post[n] * (y[f, n] * s_in[f])     dequantize, normalize
//   store = g[f, n] + store                   cotangent inject (optional)
//   out   = pre[n] * ((1 - h*h) * store)      when a sweep follows, h read from
//   amax[f] = max |out|                       the forward's stream
//   out   = store                             on the last sweep
//
// With post = 1 and s_in = 1 (multiplication by one is exact) K10 is the
// backward's prologue, pre * ((1 - h_K^2) * g).
//
// Replaces the tanh completion chunks of idgrec_tpu/ops/chainmm.py
// _make_chain_kernel: _chunk_fwd_act (l.366-389) and _chunk_bwd_act
// (l.391-452), launched by _chain_call (l.612). The TPU kernel keeps the
// whole chain resident in VMEM; here each sweep is K3 (quantize), K1 or K5
// (the dual product) and one launch of K9 or K10 per side. The seed sweep's
// bookkeeping (which side is skipped, which quantization is reused) lives in
// the Python code that launches them, ops/chainmm.py _run_chain_act and
// _run_chain_act_bwd.
//
// Bound on the H100: bytes. No tensor cores; every element is read and
// written once (K9: y in; h, z and the combine out; K10: y, g and h in, out
// out), and the per-feature max is one block reduction plus one atomicMax per
// block. The maximum is order-free, so it is exact.
//
// Numerics: the TPU kernel's operation order, with __fmul_rn/__fadd_rn/
// __fsub_rn so that no multiply-add is contracted into an FMA (the source is
// also built with -fmad=false, as K2), through chain_epilogue.cuh as the
// fused sweeps of dual_turns.cuh. tanh is the CUDA math library's tanhf,
// the function PyTorch's tanh calls on the card; chip_smoke.py holds K9 to
// torch.tanh bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int PER_BLOCK = THREADS * PER_THREAD;

__global__ void __launch_bounds__(THREADS)
chain_sweep_tanh_kernel(const float* __restrict__ y, const float* __restrict__ s_in,
                        const float* __restrict__ post, const float* __restrict__ pre,
                        float* __restrict__ c, float* __restrict__ hs, float* __restrict__ z,
                        float* __restrict__ amax, int n, int combine, int want_next) {
  const int f = blockIdx.y;
  const int n0 = blockIdx.x * PER_BLOCK + threadIdx.x * PER_THREAD;
  const size_t row = static_cast<size_t>(f) * n;
  const float s = s_in[f];
  float local = 0.0f;
  if (n0 < n) {
    const float4 yv = *reinterpret_cast<const float4*>(y + row + n0);
    const float4 pv = *reinterpret_cast<const float4*>(post + n0);
    float4 h;
    h.x = tanhf(dequant(pv.x, yv.x, s));
    h.y = tanhf(dequant(pv.y, yv.y, s));
    h.z = tanhf(dequant(pv.z, yv.z, s));
    h.w = tanhf(dequant(pv.w, yv.w, s));
    *reinterpret_cast<float4*>(hs + row + n0) = h;
    if (combine == kSet) {
      *reinterpret_cast<float4*>(c + row + n0) = h;
    } else if (combine == kAdd) {
      float4 cv = *reinterpret_cast<const float4*>(c + row + n0);
      cv.x = __fadd_rn(cv.x, h.x);
      cv.y = __fadd_rn(cv.y, h.y);
      cv.z = __fadd_rn(cv.z, h.z);
      cv.w = __fadd_rn(cv.w, h.w);
      *reinterpret_cast<float4*>(c + row + n0) = cv;
    }
    if (want_next) {
      const float4 rv = *reinterpret_cast<const float4*>(pre + n0);
      float4 zv;
      zv.x = __fmul_rn(rv.x, h.x);
      zv.y = __fmul_rn(rv.y, h.y);
      zv.z = __fmul_rn(rv.z, h.z);
      zv.w = __fmul_rn(rv.w, h.w);
      *reinterpret_cast<float4*>(z + row + n0) = zv;
      local = max_abs4(zv);
    }
  }
  if (!want_next) return;  // uniform across the grid
  block_atomic_max<THREADS>(local, amax + f);
}

__global__ void __launch_bounds__(THREADS)
chain_sweep_tanh_inject_kernel(const float* __restrict__ y, const float* __restrict__ s_in,
                               const float* __restrict__ post, const float* __restrict__ pre,
                               const float* __restrict__ g, const float* __restrict__ hs,
                               float* __restrict__ out, float* __restrict__ amax, int n,
                               int inject, int want_next) {
  const int f = blockIdx.y;
  const int n0 = blockIdx.x * PER_BLOCK + threadIdx.x * PER_THREAD;
  const size_t row = static_cast<size_t>(f) * n;
  const float s = s_in[f];
  float local = 0.0f;
  if (n0 < n) {
    const float4 yv = *reinterpret_cast<const float4*>(y + row + n0);
    const float4 pv = *reinterpret_cast<const float4*>(post + n0);
    float4 st;
    st.x = dequant(pv.x, yv.x, s);
    st.y = dequant(pv.y, yv.y, s);
    st.z = dequant(pv.z, yv.z, s);
    st.w = dequant(pv.w, yv.w, s);
    if (inject) {
      const float4 gv = *reinterpret_cast<const float4*>(g + row + n0);
      st.x = __fadd_rn(gv.x, st.x);
      st.y = __fadd_rn(gv.y, st.y);
      st.z = __fadd_rn(gv.z, st.z);
      st.w = __fadd_rn(gv.w, st.w);
    }
    if (want_next) {
      const float4 hv = *reinterpret_cast<const float4*>(hs + row + n0);
      const float4 rv = *reinterpret_cast<const float4*>(pre + n0);
      st.x = __fmul_rn(rv.x, tanh_grad(hv.x, st.x));
      st.y = __fmul_rn(rv.y, tanh_grad(hv.y, st.y));
      st.z = __fmul_rn(rv.z, tanh_grad(hv.z, st.z));
      st.w = __fmul_rn(rv.w, tanh_grad(hv.w, st.w));
      local = max_abs4(st);
    }
    *reinterpret_cast<float4*>(out + row + n0) = st;
  }
  if (!want_next) return;  // uniform across the grid
  block_atomic_max<THREADS>(local, amax + f);
}

}  // namespace

extern "C" {

// y, c, hs, z: f32 [d, n] (hs one slice of the [sweeps, d, n] stream); s_in,
// amax: f32 [d]; post, pre: f32 [n]. amax must be zeroed when want_next is
// set. n % 4 == 0 and 16-byte aligned rows. Returns cudaGetLastError().
int chain_sweep_tanh(const void* y, const void* s_in, const void* post, const void* pre,
                     void* c, void* hs, void* z, void* amax, int d, int n, int combine,
                     int want_next, void* stream) {
  dim3 grid((n + PER_BLOCK - 1) / PER_BLOCK, d);
  chain_sweep_tanh_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(s_in),
      static_cast<const float*>(post), static_cast<const float*>(pre),
      static_cast<float*>(c), static_cast<float*>(hs), static_cast<float*>(z),
      static_cast<float*>(amax), n, combine, want_next);
  return static_cast<int>(cudaGetLastError());
}

// y, g, hs, out: f32 [d, n]; s_in, amax: f32 [d]; post, pre: f32 [n]. out
// must not alias y, g or hs. hs is read only when want_next is set. amax must
// be zeroed when want_next is set. n % 4 == 0 and 16-byte aligned rows.
// Returns cudaGetLastError().
int chain_sweep_tanh_inject(const void* y, const void* s_in, const void* post,
                            const void* pre, const void* g, const void* hs, void* out,
                            void* amax, int d, int n, int inject, int want_next,
                            void* stream) {
  dim3 grid((n + PER_BLOCK - 1) / PER_BLOCK, d);
  chain_sweep_tanh_inject_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(s_in),
      static_cast<const float*>(post), static_cast<const float*>(pre),
      static_cast<const float*>(g), static_cast<const float*>(hs), static_cast<float*>(out),
      static_cast<float*>(amax), n, inject, want_next);
  return static_cast<int>(cudaGetLastError());
}

const char* chain_sweep_tanh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
