// K6 dual_bf16: both directions of the exact-mode adjacency product on
// bf16 activations in the [N, d] layout, float32 results,
//
//   yu[u, f] = sum_i M[u, i] * zi[i, f]      (M  @ zi, [U_pad, d])
//   yi[i, f] = sum_u M[u, i] * zu[u, f]      (M^T @ zu, [I_pad, d])
//
// from a walk of M's plan (dual_bf16_plan) or, where the caller holds no
// plan, one read of the int8 count matrix per feature group (dual_bf16).
//
// Replaces idgrec_tpu/ops/fusedmm.py _fused_kernel (l.98, launched by
// _fused_call l.155); entry fused_adj_matmul (l.618), whose backward is this
// same kernel on the swapped cotangents. The TPU body kept the whole
// [I_pad, d] f32 yi accumulator in VMEM across a sequential grid; Hopper
// blocks run in no order.
//
// Bound on the H100: bytes. The walk moves the plan (about 10 bytes a
// non-zero entry), the activations once and the sums once; the scan reads
// M once per feature group (U_pad * I_pad bytes). The function's operations
// are 4 * nnz * d (the non-zero entries only).
//
// Design: three launches a call, in the arithmetic FixedSums below:
// * prep: the float32 activations ([nu, d] and [ni, d]) become one bf16
//   copy [U_pad + I_pad, d], rounded to nearest even as .to(bfloat16)
//   rounds and zero in the padding rows; the same pass zeroes the int64 sums
//   and writes each block's largest |bf16| of either side.
// * the products: the walk of dual_walk.cuh (its note gives the
//   design) or the scan of dual_scan.cuh (K7's; 128, 64 or 32 features a
//   read of M, fusedmm.scan_feature_group; the launcher reports the reads).
//   Each block first reduces the prep blocks' maxima to amax, a side's
//   largest |activation|. An entry's product v * z is exact in float32
//   (|v| <= 128 has 8 significant bits, z 8); it is scaled by the power of
//   two 2^(31 - e) of the side it sums (amax < 2^e: fixed_shift) and
//   rounded to int64 once. The walk keeps a run's sums in int64 registers
//   and stores them once (one 64-bit atomic add a feature where a run is
//   split between warps); the scan keeps yu's over a warp's run of the row
//   and adds one 64-bit atomic an entry and feature into yi. Every sum is
//   thus an exact integer sum of per-entry rounded products: it does not
//   depend on the order, the path, the grid or the SM count, and two
//   launches give the same bits (training promises that a resumed run
//   equals a straight one).
// * convert: the sums times 2^-shift as float32, NaN over a side whose amax
//   is not finite (NaN or inf in the activations it sums; a zero count would
//   have multiplied them on the TPU).
// Precision: a product's rounding is at most 2^(e - 32) <= amax * 2^-31; with
// row and column sums of |M| below 2^30 every sum stays below 2^61.
// fusedmm.fused_adj_matmul_fixed_plain repeats this arithmetic in PyTorch.
// The tile kernel the scan replaced (mma.sync on 64 x 256 stages of M,
// zero-tile votes, a fixed-point partial a block) read M once per 64
// features and took 1.23 ms at d = 64 on an H100 (PERF.md); its wrapper's
// pads, casts, maxima and fills were about ten more launches.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "dual_scan.cuh"
#include "dual_walk.cuh"

namespace {

constexpr int PREP_THREADS = 256;
constexpr int MAX_PREP_BLOCKS = 1024;  // the wrapper's scratch holds their maxima
constexpr int CONVERT_THREADS = 256;
constexpr int BLOCKS_AN_SM = 4;        // prep and convert: grid-stride blocks an SM
constexpr int MAX_SHIFT = 120;
constexpr uint32_t BF16_ABS = 0x7fffu;
constexpr uint32_t F32_INF = 0x7f800000u;

// The power of two 2^shift that scales products of activations bounded by
// amax into 64-bit fixed point: amax < 2^e gives shift = 31 - e.
__device__ __forceinline__ int fixed_shift(float amax) {
  if (!(amax > 0.0f) || !isfinite(amax)) return 0;
  int e;
  frexpf(amax, &e);
  const int shift = 31 - e;
  return shift > MAX_SHIFT ? MAX_SHIFT : shift;
}

// The block's largest (mu, mi) into am[0..1] (shared memory), by the whole
// block. The values are the bits of non-negative floats: as unsigned
// integers they order as the floats do, NaN above inf, so the integer max
// keeps a NaN.
__device__ __forceinline__ void block_max2(unsigned mu, unsigned mi, unsigned* am) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mu = max(mu, __shfl_xor_sync(FULL, mu, o));
    mi = max(mi, __shfl_xor_sync(FULL, mi, o));
  }
  if (threadIdx.x == 0) am[0] = am[1] = 0u;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&am[0], mu);
    atomicMax(&am[1], mi);
  }
  __syncthreads();
}

// (max |zu|, max |zi|) over the n pairs of prep-block maxima, into am[0..1].
__device__ __forceinline__ void block_amax(const unsigned* __restrict__ parts, int n,
                                           unsigned* am) {
  unsigned mu = 0u, mi = 0u;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    mu = max(mu, parts[2 * k]);
    mi = max(mi, parts[2 * k + 1]);
  }
  block_max2(mu, mi, am);
}

__device__ __forceinline__ float bf16_float(uint32_t b) { return __uint_as_float(b << 16); }

// The scan's arithmetic for bf16 activations: each entry's product scaled by
// its side's power of two and rounded to int64 (round half to even), 64-bit
// sums. aux: the prep blocks' maxima.
struct FixedSums {
  using Act = uint16_t;  // bf16 bits
  using Val = float;     // the activation times its side's power of two (exact)
  using Sum = long long;
  struct Scales {
    float u, i;  // yu sums zi, yi sums zu
  };
  __device__ static Scales scales(const unsigned* parts, int n) {
    __shared__ unsigned am[2];
    block_amax(parts, n, am);
    return {ldexpf(1.0f, fixed_shift(__uint_as_float(am[1]))),
            ldexpf(1.0f, fixed_shift(__uint_as_float(am[0])))};
  }
  __device__ static Val val(Act a, float scale) { return bf16_float(a) * scale; }
  __device__ static Sum product(int v, Val a) { return __float2ll_rn(static_cast<float>(v) * a); }
};

// float32 to bf16 bits, round to nearest even (as PyTorch's .to(bfloat16)
// rounds; a NaN stays a NaN)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  if (isnan(x)) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// Eight consecutive activations of one row as bf16 bits, two to a word.
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(bf16_bits(a.x) | (bf16_bits(a.y) << 16),
                    bf16_bits(a.z) | (bf16_bits(a.w) << 16),
                    bf16_bits(b.x) | (bf16_bits(b.y) << 16),
                    bf16_bits(b.z) | (bf16_bits(b.w) << 16));
}

__device__ __forceinline__ unsigned abs_max8(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) m = max(m, max(w[k] & BF16_ABS, (w[k] >> 16) & BF16_ABS));
  return m << 16;
}

// The bf16 copy z [u_pad + i_pad, d] (users, then items; zero rows past nu
// and ni), the int64 sums zeroed, and this block's (max |zu|, max |zi|) into
// parts[2 b], parts[2 b + 1]. Eight features a thread a step, grid-stride.
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const float* __restrict__ zu, const float* __restrict__ zi, int nu, int ni, int u_pad,
            int i_pad, int d, uint16_t* __restrict__ z, long long* __restrict__ sums,
            unsigned* __restrict__ parts) {
  const long long n8 = static_cast<long long>(u_pad + i_pad) * d / 8;
  const long long stride = static_cast<long long>(gridDim.x) * PREP_THREADS;
  unsigned mu = 0u, mi = 0u;
  for (long long p = static_cast<long long>(blockIdx.x) * PREP_THREADS + threadIdx.x; p < n8;
       p += stride) {
    const long long e = 8 * p;
    const int r = static_cast<int>(e / d), f = static_cast<int>(e - static_cast<long long>(r) * d);
    const bool user = r < u_pad;
    const int row = user ? r : r - u_pad;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < (user ? nu : ni)) {
      v = load8((user ? zu : zi) + static_cast<size_t>(row) * d + f);
      const unsigned m = abs_max8(v);
      if (user) mu = max(mu, m);
      else mi = max(mi, m);
    }
    *reinterpret_cast<uint4*>(z + e) = v;
    uint4* s = reinterpret_cast<uint4*>(sums + e);
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  __shared__ unsigned am[2];
  block_max2(mu, mi, am);
  if (threadIdx.x == 0) {
    parts[2 * blockIdx.x] = am[0];
    parts[2 * blockIdx.x + 1] = am[1];
  }
}

// y[k] = sums[k] * 2^-shift as float32 for the n_u user sums, then the item
// sums; NaN over a side whose amax is not finite. Grid-stride.
__global__ void __launch_bounds__(CONVERT_THREADS)
convert_kernel(const long long* __restrict__ sums, float* __restrict__ y, long long n_u,
               long long n, const unsigned* __restrict__ parts, int n_parts) {
  __shared__ unsigned am[2];
  block_amax(parts, n_parts, am);
  // yu sums zi (am[1]), yi sums zu (am[0])
  const bool ok_u = am[1] < F32_INF, ok_i = am[0] < F32_INF;
  const int shift_u = fixed_shift(__uint_as_float(am[1]));
  const int shift_i = fixed_shift(__uint_as_float(am[0]));
  const long long stride = static_cast<long long>(gridDim.x) * CONVERT_THREADS;
  for (long long k = static_cast<long long>(blockIdx.x) * CONVERT_THREADS + threadIdx.x; k < n;
       k += stride) {
    const bool user = k < n_u;
    y[k] = (user ? ok_u : ok_i)
               ? static_cast<float>(ldexp(static_cast<double>(sums[k]), -(user ? shift_u : shift_i)))
               : nanf("");
  }
}

int grid_for(long long items, int threads, int sms, int cap) {
  const long long want = (items + threads - 1) / threads;
  long long g = static_cast<long long>(sms) * BLOCKS_AN_SM;
  if (g > cap) g = cap;
  if (g > want) g = want;
  return g > 0 ? static_cast<int>(g) : 1;
}

// The three launches of a K6 call around ``products(z, sums, parts,
// prep_blocks)``, which launches the scan or the walk. Checks the shapes
// both entry points take.
template <class Products>
int run_dual_bf16(const void* zu, const void* zi, int nu, int ni, void* scratch, void* y,
                  int u_pad, int i_pad, int d, cudaStream_t s, Products products) {
  if (d <= 0 || d % 32 != 0 || u_pad <= 0 || i_pad <= 0 || nu < 0 || ni < 0 || nu > u_pad ||
      ni > i_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(u_pad + i_pad) * d;
  long long* sums = static_cast<long long*>(scratch);
  uint16_t* z = reinterpret_cast<uint16_t*>(sums + n);
  unsigned* parts = reinterpret_cast<unsigned*>(z + n);
  const int prep_blocks = grid_for(n / 8, PREP_THREADS, sms, MAX_PREP_BLOCKS);
  prep_kernel<<<prep_blocks, PREP_THREADS, 0, s>>>(static_cast<const float*>(zu),
                                                    static_cast<const float*>(zi), nu, ni, u_pad,
                                                    i_pad, d, z, sums, parts);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = products(z, sums, parts, prep_blocks)) != cudaSuccess) return static_cast<int>(err);
  convert_kernel<<<grid_for(n, CONVERT_THREADS, sms, 1 << 30), CONVERT_THREADS, 0, s>>>(
      sums, static_cast<float*>(y), static_cast<long long>(u_pad) * d, n, parts, prep_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// m int8 [u_pad, i_pad]; zu [nu, d] and zi [ni, d] float32, contiguous and
// 16-byte aligned, nu <= u_pad, ni <= i_pad. scratch: dual_bf16_scratch_bytes(u_pad, i_pad, d) bytes,
// 16-byte aligned, no zeroing needed. y float32 [u_pad + i_pad, d] receives
// yu (rows 0 .. u_pad) and yi (rows u_pad ..). d % 32 == 0; the wrapper also
// checks i_pad % 256 == 0, u_pad % 64 == 0 and u_pad, i_pad <= 2^23. *passes:
// the reads of M launched. Three launches on the stream, no
// synchronisation. Returns cudaGetLastError().
int dual_bf16(const void* m, const void* zu, const void* zi, int nu, int ni, void* scratch,
              void* y, int u_pad, int i_pad, int d, int* passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_u = static_cast<long long>(u_pad) * d;
  return run_dual_bf16(zu, zi, nu, ni, scratch, y, u_pad, i_pad, d, s,
                       [&](uint16_t* z, long long* sums, unsigned* parts, int prep_blocks) {
                         return launch_scan_of<FixedSums, false>(
                             static_cast<const int8_t*>(m), z, z + n_u, sums, sums + n_u, u_pad,
                             i_pad, d, passes, parts, prep_blocks, s);
                       });
}

// dual_bf16 from the plan of M [u_pad, i_pad] instead of M: lists the eight
// device pointers of the plan (fusedmm.DualPlan: the row list's offsets,
// columns, counts and table of runs, then the column list's), nnz its
// entries; walk_u: compute yu (zi given), walk_i: compute yi (zu given);
// the rows of a side not computed are zero. fpl features a lane (1, 2, 3, 4,
// 6 or 8; d % (32 fpl) == 0), chunk entries a warp (a multiple of 32).
// Three launches, no synchronisation; M is not read.
int dual_bf16_plan(const void* const* lists, long long nnz, const void* zu, const void* zi,
                   int nu, int ni, int walk_u, int walk_i, void* scratch, void* y, int u_pad,
                   int i_pad, int d, int fpl, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_u = static_cast<long long>(u_pad) * d;
  return run_dual_bf16(zu, zi, nu, ni, scratch, y, u_pad, i_pad, d, s,
                       [&](uint16_t* z, long long* sums, unsigned* parts, int prep_blocks) {
                         return launch_walk<FixedSums>(lists, nnz, u_pad, i_pad, walk_u != 0,
                                                       walk_i != 0, z, z + n_u, sums,
                                                       sums + n_u, d, fpl, chunk, parts,
                                                       prep_blocks, s);
                       });
}

// Bytes of scratch dual_bf16 and dual_bf16_plan take: the int64 sums, the
// bf16 copy, the prep blocks' maxima.
long long dual_bf16_scratch_bytes(int u_pad, int i_pad, int d) {
  const long long n = static_cast<long long>(u_pad + i_pad) * d;
  return 10 * n + 8LL * MAX_PREP_BLOCKS;
}

const char* dual_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
