// K7 dual_int8_n: both directions of the int8 adjacency product from one
// read of M per feature group, activations in the [N, d] layout of the
// per-application product.
//
//   yu[u, f] = sum_i M[u, i] * qi[i, f]      (M  @ qi, [U_pad, d])
//   yi[i, f] = sum_u M[u, i] * qu[u, f]      (M^T @ qu, [I_pad, d])
//
// Replaces idgrec_tpu/ops/fusedmm.py _fused_kernel_int8_small (l.211,
// launched by _fused_small_call l.250) and _fused_kernel_int8 (l.283,
// launched at l.345); entry fused_adj_matmul_int8 (l.320). The TPU needed a
// single-panel and a panelized body because its yi or yu accumulator had to
// fit VMEM; here one kernel covers both. Its sums equal K1's (dual_int8_t.cu)
// on the transposed activations bit for bit: the same integer products, and
// integer addition is associative.
//
// Bound on the H100: bytes. M (U_pad * I_pad int8, 1.22 GB at yelp2018
// scale) is read once per feature group; the operations on it are 4 *
// U_pad * I_pad * d int8 multiply-adds if every entry is multiplied, and
// 4 * nnz * d if only the non-zero ones are.
//
// Design. K1's tiles (mma.sync on 64 x 256 stages of M in shared memory,
// zero-tile votes, byte gathers for the M^T fragments) are limited by work
// inside the SM, not by the stream of M: their ablation on an H100
// (scripts/torch_k7_ablation.py, PERF.md) gave the stream alone 0.435 ms
// of 0.79 at d = 64 and the tile machinery the rest, and a block of 128
// features sharing each stage between two halves took as long as two
// passes. An interaction matrix is sparse (yelp2018: 0.1 % of M's entries
// are non-zero, about 16 in a 64 x 256 tile), so the tiles spend that work
// proving zeros. This kernel spends it on the non-zero entries only:
// * The scan: every thread streams M in 16-byte pieces (four a round, the
//   next round's loaded before this round's entries are taken, with the
//   streaming cache hint so that M does not push the activations out of
//   L2) and tests each piece for a non-zero byte.
//   The scan is the kernel's bytes bound: one read of M a feature group.
// * Each non-zero entry M[u, i] = v is taken by the whole warp (ballot,
//   then the piece broadcast by shuffles): lane l handles features l,
//   l + 32, ... of the group, reads qi[i, f] and qu[u, f] (rows of the
//   activations that stay in L2) and adds v * qi[i, f] to yu[u, f] and
//   v * qu[u, f] to yi[i, f] with int32 atomicAdd (red.global: exact and
//   order-free, so every launch gives the same bits). A warp's 32 adds of
//   one instruction cover 32 consecutive features, 128 bytes. The entries
//   a warp finds in a round are taken a few at a time, their activation
//   rows loaded together, and the next round's pieces of M are already in
//   flight: an entry taken alone, its loads queued behind the stream's, is
//   a chain of latencies (1.33 ms at d = 64 on an H100, against 0.44 ms
//   for the scan alone).
// * No shared memory, no tensor cores, no barriers: nothing holds a warp
//   but its own loads, and the other warps of the SM (two blocks of eight
//   at the kernel's 100-120 registers) cover them. The work per feature
//   group is the scan plus 2 * nnz * group atomic adds (3.2e8 at
//   d = 128).
// * Feature groups: 128 features when d % 128 == 0, else 64 (d % 64 == 0),
//   else 32 (fusedmm.k7_feature_group states the same rule); each group is
//   one scan of M, so d = 128 reads M once and d = 2,048 sixteen times. The
//   launcher reports the scans it launched (the grid's y dimension).
// * Not used, and why: TMA and wgmma. The scan needs no shared memory or
//   staging for a bulk copy to feed, and the products are 0.1 % of the
//   dense ones the tensor cores would make.
// * A second kernel converts the int32 sums to float32 in place, once: exact
//   while every sum stays below 2^24 (degree * 127 * count; the wrapper's
//   docstring states it). The launcher reads the SM count once per process
//   and device, not once per call.
// A dense M makes the warp-per-entry work scale with its non-zeros: the
// kernel stays exact there (the card tests take matrices up to fully dense)
// but is built for interaction matrices.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // 16-byte pieces of M a thread has in flight
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void add_nonzero(int* dst, int v) {
  if (v != 0) atomicAdd(dst, v);
}

// The n <= 32 non-zero entries of M a warp found, lane e < n holding entry
// e's row u, column i and count v, BATCH at a time: the warp reads the
// activation rows of BATCH entries first (lane l: features f0 + l + 32 k),
// then adds v * qi[i, f] to yu[u, f] and v * qu[u, f] to yi[i, f]. Not
// inlined: a round of the scan calls it once or not at all.
template <int FPL>
__device__ __noinline__ void take_entries(int n, int eu, int ei, int ev,
                                          const int8_t* __restrict__ qu,
                                          const int8_t* __restrict__ qi, int* __restrict__ yu,
                                          int* __restrict__ yi, int d, int f0, int lane) {
  // entries whose activation rows load together (16 / FPL: 0.7955 ms against
  // 0.6965 at d = 64 on an H100)
  constexpr int BATCH = 8 / FPL;
  for (int e0 = 0; e0 < n; e0 += BATCH) {
    int a[BATCH][FPL], b[BATCH][FPL];
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int u = __shfl_sync(FULL, eu, (e0 + e) & 31), i = __shfl_sync(FULL, ei, (e0 + e) & 31);
#pragma unroll
      for (int k = 0; k < FPL; ++k) {
        a[e][k] = e0 + e < n ? __ldg(qi + static_cast<size_t>(i) * d + f0 + lane + 32 * k) : 0;
        b[e][k] = e0 + e < n ? __ldg(qu + static_cast<size_t>(u) * d + f0 + lane + 32 * k) : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int u = __shfl_sync(FULL, eu, (e0 + e) & 31), i = __shfl_sync(FULL, ei, (e0 + e) & 31);
      const int v = __shfl_sync(FULL, ev, (e0 + e) & 31);
      if (e0 + e < n) {
        int* yu_row = yu + static_cast<size_t>(u) * d + f0 + lane;
        int* yi_row = yi + static_cast<size_t>(i) * d + f0 + lane;
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
          add_nonzero(yu_row + 32 * k, v * a[e][k]);
          add_nonzero(yi_row + 32 * k, v * b[e][k]);
        }
      }
    }
  }
}

// One bit per non-zero byte of w.
__device__ __forceinline__ unsigned nonzero_bytes(uint32_t w) {
  const uint32_t m = __vcmpne4(w, 0u);  // 0xff in each non-zero byte
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) | ((m >> 28) & 8u);
}

// FPL features a lane: group = 32 * FPL. blockIdx.y is the feature group;
// the blocks of one group scan all of M, pieces in a grid-stride loop. The
// next round's pieces are loaded before this round's entries are taken, so
// the stream of M does not wait on the activation rows.
template <int FPL>
__global__ void __launch_bounds__(THREADS)
dual_int8_n_kernel(const int8_t* __restrict__ m, const int8_t* __restrict__ qu,
                   const int8_t* __restrict__ qi, int* __restrict__ yu,
                   int* __restrict__ yi, int u_pad, int i_pad, int d) {
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * 32 * FPL;
  const int pieces_per_row = i_pad / 16;
  const long long pieces = static_cast<long long>(u_pad) * pieces_per_row;
  const long long step = static_cast<long long>(gridDim.x) * THREADS * UNROLL;
  const uint4* src = reinterpret_cast<const uint4*>(m);
  // the loop runs on the warp's first piece, so whole warps leave together
  long long w0 = static_cast<long long>(blockIdx.x) * THREADS * UNROLL + (threadIdx.x & ~31);
  uint4 cur[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const long long p = w0 + lane + k * static_cast<long long>(THREADS);
    cur[k] = p < pieces ? __ldcs(src + p) : make_uint4(0u, 0u, 0u, 0u);
  }
  for (; w0 < pieces; w0 += step) {
    uint4 nxt[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long p = w0 + step + lane + k * static_cast<long long>(THREADS);
      nxt[k] = p < pieces ? __ldcs(src + p) : make_uint4(0u, 0u, 0u, 0u);
    }
    int n = 0, eu = 0, ei = 0, ev = 0;  // lane e < n: entry e
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const uint4 v = cur[k];
      unsigned todo = __ballot_sync(FULL, (v.x | v.y | v.z | v.w) != 0u);
      while (todo) {
        const int src_lane = __ffs(todo) - 1;
        todo &= todo - 1;
        const uint32_t w0x = __shfl_sync(FULL, v.x, src_lane), w1 = __shfl_sync(FULL, v.y, src_lane);
        const uint32_t w2 = __shfl_sync(FULL, v.z, src_lane), w3 = __shfl_sync(FULL, v.w, src_lane);
        // the place of lane src_lane's piece
        const long long p = w0 + src_lane + k * static_cast<long long>(THREADS);
        const int u = static_cast<int>(p / pieces_per_row);
        const int i0 = static_cast<int>(p - static_cast<long long>(u) * pieces_per_row) * 16;
        unsigned bytes = nonzero_bytes(w0x) | (nonzero_bytes(w1) << 4) |
                         (nonzero_bytes(w2) << 8) | (nonzero_bytes(w3) << 12);
        while (bytes) {
          const int j = __ffs(bytes) - 1;
          bytes &= bytes - 1;
          const uint32_t wj = j < 8 ? (j < 4 ? w0x : w1) : (j < 12 ? w2 : w3);
          if (lane == n) {
            eu = u;
            ei = i0 + j;
            ev = static_cast<int8_t>((wj >> (8 * (j & 3))) & 0xffu);
          }
          if (++n == 32) {
            take_entries<FPL>(n, eu, ei, ev, qu, qi, yu, yi, d, f0, lane);
            n = 0;
          }
        }
      }
    }
    if (n > 0) take_entries<FPL>(n, eu, ei, ev, qu, qi, yu, yi, d, f0, lane);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) cur[k] = nxt[k];
  }
}

__global__ void int32_to_float_inplace(int* __restrict__ x, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    const float v = static_cast<float>(x[i]);
    reinterpret_cast<float*>(x)[i] = v;
  }
}

// the SM count of each device, read once per process (0: not read yet)
int g_sms[MAX_DEVICES];

template <int FPL>
cudaError_t launch(const int8_t* m, const int8_t* qu, const int8_t* qi, int* yu, int* yi,
                   int u_pad, int i_pad, int d, int* passes, cudaStream_t s) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (g_sms[device] == 0 &&
      (err = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  // enough blocks to fill the card once; a group's blocks share the scan
  const long long pieces = static_cast<long long>(u_pad) * (i_pad / 16);
  const long long per_block = static_cast<long long>(THREADS) * UNROLL;
  const long long want = (pieces + per_block - 1) / per_block;
  const int groups = d / (32 * FPL);
  const long long fill = static_cast<long long>(g_sms[device]) * BLOCKS_PER_SM;
  const int blocks = static_cast<int>(want < fill ? want : fill);
  dim3 grid(blocks > 0 ? blocks : 1, groups);
  *passes = static_cast<int>(grid.y);
  dual_int8_n_kernel<FPL><<<grid, THREADS, 0, s>>>(m, qu, qi, yu, yi, u_pad, i_pad, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// m int8 [u_pad, i_pad]; qu int8 [u_pad, d]; qi int8 [i_pad, d]. yu [u_pad, d]
// and yi [i_pad, d] must be zeroed int32 buffers; on return they hold the
// float32 sums (bit-cast in place). d % 32 == 0; the wrapper also checks
// i_pad % 256 == 0 and u_pad % 64 == 0. *passes: the scans of M launched.
// Returns cudaGetLastError().
int dual_int8_n(const void* m, const void* qu, const void* qi, void* yu, void* yi,
                int u_pad, int i_pad, int d, int* passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* mp = static_cast<const int8_t*>(m);
  const int8_t* qup = static_cast<const int8_t*>(qu);
  const int8_t* qip = static_cast<const int8_t*>(qi);
  int* yup = static_cast<int*>(yu);
  int* yip = static_cast<int*>(yi);
  if (d <= 0 || d % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      d % 128 == 0 ? launch<4>(mp, qup, qip, yup, yip, u_pad, i_pad, d, passes, s)
      : d % 64 == 0 ? launch<2>(mp, qup, qip, yup, yip, u_pad, i_pad, d, passes, s)
                    : launch<1>(mp, qup, qip, yup, yip, u_pad, i_pad, d, passes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nu = static_cast<long long>(d) * u_pad;
  const long long ni = static_cast<long long>(d) * i_pad;
  int32_to_float_inplace<<<static_cast<unsigned>((nu + 255) / 256), 256, 0, s>>>(yup, nu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int32_to_float_inplace<<<static_cast<unsigned>((ni + 255) / 256), 256, 0, s>>>(yip, ni);
  return static_cast<int>(cudaGetLastError());
}

const char* dual_int8_n_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
