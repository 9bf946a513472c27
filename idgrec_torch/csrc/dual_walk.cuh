// The walk of a plan of M's non-zero entries that K6 (dual_bf16.cu) and K7
// (dual_int8_n.cu) take where the caller holds the plan
// (ops/fusedmm.py DualPlan): both directions of the adjacency product,
//
//   yu[u, f] += sum_i M[u, i] * qi[i, f]      (M  @ qi, [U_pad, d])
//   yi[i, f] += sum_u M[u, i] * qu[u, f]      (M^T @ qu, [I_pad, d])
//
// in the arithmetic of dual_scan.cuh (IntSums for K7, FixedSums for K6),
// so every sum is the same integer sum as the scan's and the results are
// the same bits.
//
// Why a walk (the scan's note gives what it replaces): the scan streams the
// whole dense int8 M (1,219 MB at yelp2018 scale, 0.1 % of it non-zero)
// once per feature group, three times at d = 192 and sixteen at d = 2,048,
// and adds every entry into yi with an atomic add a feature. The plan is
// about 13 MB at that scale: the entries in row order (for yu) and in
// column order (for yi), each list as its runs' offsets (int64), the other
// index (int32) and the count (int8), and the run of every PLAN_STEP-th
// entry. No launch reads M.
// * Each warp takes a chunk of `chunk` consecutive entries of one list, so a
//   hot column of thousands of entries is split among warps. Lane l holds
//   the features [f0 + FPL l, f0 + FPL (l + 1)) of the block's feature slice
//   (blockIdx.y; FPL features a lane, 32 FPL a slice) and keeps the run's
//   sums in registers while the entries stay in the run. A run whose entries
//   all lie in the chunk is stored once (no other warp writes it, and the
//   sums were zeroed before); a run split across chunks ends in one atomic
//   add a feature.
// * The warp reads 32 entries at a time (their other index and count, one
//   coalesced load each), then the gathered activation rows of BATCH
//   entries together (one vector load a lane and entry: FPL contiguous
//   activations), then adds their products. The runs' ends come from a
//   window of 32 offsets, one a lane, reloaded when the warp has passed 32
//   runs: a run change is a shuffle, not a dependent load.
// * Feature slices: the grid's y dimension. A slice's activations stay in
//   L2 while the plan streams through once a slice; the blocks of one slice
//   are dispatched before the next slice's. The widest slice a lane can
//   hold (fusedmm.walk_features: up to 8 features a lane) measured fastest
//   at every width timed on an H100 (scripts/torch_dual_plan.py): K6 at
//   d = 2,048 4.60 ms in slices of 256 features, 5.35 in 128, 6.80 in 64;
//   at d = 192 (chunks of 128 entries) 0.557 ms in one slice, 0.672 in two,
//   0.696 in three.
// * The grid is persistent in x (at most WALK_BLOCKS_AN_SM blocks an SM),
//   each warp taking chunks warp, warp + warps, ...: the block reduces its
//   arithmetic's scales once (A::scales), not once a chunk.
// * Bound on an H100: the function's bytes are the plan, the activations
//   read once and the sums written once; the work is 2 nnz d products. Each
//   entry gathers a row slice of the other side's activations (from L2).
// * Not used, and why: TMA and wgmma. The products are the non-zero ones,
//   about 0.1 % of the dense product the tensor cores would make, and a
//   gathered row needs no staging.

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "dual_scan.cuh"

namespace {

constexpr int WALK_THREADS = 256;
constexpr int WALK_WARPS = WALK_THREADS / 32;
constexpr int WALK_BLOCKS_AN_SM = 4;
// the plan's table holds the run of every PLAN_STEP-th entry (fusedmm.PLAN_STEP)
constexpr int PLAN_STEP = 32;
constexpr long long NO_END = 0x7fffffffffffffffLL;

// One list of the plan: its runs' offsets, the other index and the count of
// each entry in run order, and the run of entry PLAN_STEP k.
struct PlanList {
  const long long* ptr;  // [runs + 1]
  const int* idx;        // [nnz]
  const int8_t* val;     // [nnz]
  const int* first;      // [ceil(nnz / PLAN_STEP)]
  long long nnz;
  int runs;
};

template <int BYTES>
struct LoadUnit;
template <>
struct LoadUnit<16> {
  using T = uint4;
};
template <>
struct LoadUnit<8> {
  using T = uint2;
};
template <>
struct LoadUnit<4> {
  using T = unsigned int;
};
template <>
struct LoadUnit<2> {
  using T = unsigned short;
};
template <>
struct LoadUnit<1> {
  using T = unsigned char;
};

// N consecutive activations at p in the widest loads their bytes allow (p is
// aligned to that width: rows are d % 32 == 0 long, a lane's features start
// at a multiple of N).
template <class Act, int N>
__device__ __forceinline__ void load_acts(const Act* __restrict__ p, Act (&out)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(Act));
  constexpr int UNIT = BYTES % 16 == 0 ? 16
                       : BYTES % 8 == 0 ? 8
                       : BYTES % 4 == 0 ? 4
                       : BYTES % 2 == 0 ? 2
                                        : 1;
  using U = typename LoadUnit<UNIT>::T;
  U buf[BYTES / UNIT];
  const U* src = reinterpret_cast<const U*>(p);
#pragma unroll
  for (int k = 0; k < BYTES / UNIT; ++k) buf[k] = __ldg(src + k);
  memcpy(out, buf, BYTES);
}

// The run's sums into y_row (this lane's FPL features): a store where the
// warp saw all of the run's entries, else atomic adds.
template <class A, int FPL>
__device__ __forceinline__ void flush_run(const typename A::Sum (&acc)[FPL],
                                          typename A::Sum* __restrict__ y_row, bool split) {
  if (split) {
#pragma unroll
    for (int k = 0; k < FPL; ++k) add_nonzero(y_row + k, acc[k]);
  } else {
#pragma unroll
    for (int k = 0; k < FPL; ++k) y_row[k] = acc[k];
  }
}

// The entries [lo, hi) of list L (lo a multiple of PLAN_STEP): each adds
// A::product(v, A::val(q[idx, f], scale)) to its run's row of y, for the
// lane's features f = f (.. + FPL).
template <class A, int FPL>
__device__ __forceinline__ void walk_chunk(const PlanList& L, long long lo, long long hi,
                                           const typename A::Act* __restrict__ q,
                                           typename A::Sum* __restrict__ y, int d, int f,
                                           int lane, float scale) {
  // entries whose activation rows load together
  constexpr int BATCH = FPL <= 3 ? 8 : FPL <= 4 ? 6 : 4;
  int r = __ldg(L.first + lo / PLAN_STEP);  // the run of entry lo
  long long start = __ldg(L.ptr + r);
  int wb = r;  // the window: lane j holds the end of run wb + j
  long long win = wb + 1 + lane <= L.runs ? __ldg(L.ptr + wb + 1 + lane) : NO_END;
  long long end = __shfl_sync(FULL, win, 0);
  typename A::Sum acc[FPL];
#pragma unroll
  for (int k = 0; k < FPL; ++k) acc[k] = 0;
  for (long long b = lo; b < hi; b += 32) {
    const int n = hi - b < 32 ? static_cast<int>(hi - b) : 32;
    int my_i = 0, my_v = 0;  // lane e < n: entry b + e
    if (lane < n) {
      my_i = __ldg(L.idx + b + lane);
      my_v = __ldg(L.val + b + lane);
    }
    for (int e0 = 0; e0 < n; e0 += BATCH) {
      typename A::Act a[BATCH][FPL];
#pragma unroll
      for (int e = 0; e < BATCH; ++e) {
        const int i = __shfl_sync(FULL, my_i, (e0 + e) & 31);
        if (e0 + e < n) {
          load_acts<typename A::Act, FPL>(q + static_cast<size_t>(i) * d + f, a[e]);
        } else {
#pragma unroll
          for (int k = 0; k < FPL; ++k) a[e][k] = 0;
        }
      }
#pragma unroll
      for (int e = 0; e < BATCH; ++e) {
        const int v = __shfl_sync(FULL, my_v, (e0 + e) & 31);
        if (e0 + e < n) {
          const long long g = b + e0 + e;
          while (g >= end) {  // warp-uniform: the entry is in a later run
            if (end > start)
              flush_run<A, FPL>(acc, y + static_cast<size_t>(r) * d + f, start < lo || end > hi);
            ++r;
            start = end;
            if (r - wb == 32) {
              wb = r;
              win = wb + 1 + lane <= L.runs ? __ldg(L.ptr + wb + 1 + lane) : NO_END;
            }
            end = __shfl_sync(FULL, win, r - wb);
#pragma unroll
            for (int k = 0; k < FPL; ++k) acc[k] = 0;
          }
#pragma unroll
          for (int k = 0; k < FPL; ++k) acc[k] += A::product(v, A::val(a[e][k], scale));
        }
      }
    }
  }
  flush_run<A, FPL>(acc, y + static_cast<size_t>(r) * d + f, start < lo || end > hi);
}

// FPL features a lane: slice = 32 * FPL, blockIdx.y the slice. Warps take
// the chunks_u chunks of the row list (into yu, gathering qi) and then the
// chunks_i chunks of the column list (into yi, gathering qu), `chunk`
// entries each, grid-stride. aux, n_aux: what A::scales reads.
template <class A, int FPL>
__global__ void __launch_bounds__(WALK_THREADS)
dual_walk_kernel(PlanList rows, PlanList cols, long long chunks_u, long long chunks_i, int chunk,
                 const typename A::Act* __restrict__ qu, const typename A::Act* __restrict__ qi,
                 typename A::Sum* __restrict__ yu, typename A::Sum* __restrict__ yi, int d,
                 const unsigned* __restrict__ aux, int n_aux) {
  const typename A::Scales sc = A::scales(aux, n_aux);
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.y * 32 * FPL + lane * FPL;
  const long long warps = static_cast<long long>(gridDim.x) * WALK_WARPS;
  const long long total = chunks_u + chunks_i;
  for (long long c = static_cast<long long>(blockIdx.x) * WALK_WARPS + (threadIdx.x >> 5);
       c < total; c += warps) {
    const bool by_row = c < chunks_u;
    const PlanList& L = by_row ? rows : cols;
    const long long lo = (by_row ? c : c - chunks_u) * chunk;
    const long long hi = lo + chunk < L.nnz ? lo + chunk : L.nnz;
    walk_chunk<A, FPL>(L, lo, hi, by_row ? qi : qu, by_row ? yu : yi, d, f, lane,
                       by_row ? sc.u : sc.i);
  }
}

template <class A, int FPL>
cudaError_t launch_walk_fpl(const PlanList& rows, const PlanList& cols, long long chunks_u,
                            long long chunks_i, int chunk, const typename A::Act* qu,
                            const typename A::Act* qi, typename A::Sum* yu,
                            typename A::Sum* yi, int d, const unsigned* aux, int n_aux,
                            cudaStream_t s) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long want = (chunks_u + chunks_i + WALK_WARPS - 1) / WALK_WARPS;
  const long long fill = static_cast<long long>(sms) * WALK_BLOCKS_AN_SM;
  dim3 grid(static_cast<unsigned>(want < fill ? want : fill), d / (32 * FPL));
  dual_walk_kernel<A, FPL><<<grid, WALK_THREADS, 0, s>>>(rows, cols, chunks_u, chunks_i, chunk,
                                                         qu, qi, yu, yi, d, aux, n_aux);
  return cudaGetLastError();
}

// The host's view of a plan: lists[0..3] the row list's ptr, idx, val,
// first; lists[4..7] the column list's (device pointers).
inline PlanList plan_list(const void* const* lists, long long nnz, int runs) {
  return {static_cast<const long long*>(lists[0]), static_cast<const int*>(lists[1]),
          static_cast<const int8_t*>(lists[2]), static_cast<const int*>(lists[3]), nnz, runs};
}

// One launch: the walk of the plan (nnz entries of M [u_pad, i_pad]) for
// every feature slice of d (32 * fpl features, fpl in 1, 2, 3, 4, 6, 8),
// adding into the zeroed sums yu [u_pad, d] (walk_u) and yi [i_pad, d]
// (walk_i) in A's arithmetic; `chunk` entries a warp (a multiple of
// PLAN_STEP). A side not walked is neither read nor written. No launch
// where neither is walked or M has no entry.
template <class A>
cudaError_t launch_walk(const void* const* lists, long long nnz, int u_pad, int i_pad,
                        bool walk_u, bool walk_i, const typename A::Act* qu,
                        const typename A::Act* qi, typename A::Sum* yu, typename A::Sum* yi,
                        int d, int fpl, int chunk, const unsigned* aux, int n_aux,
                        cudaStream_t s) {
  if (d <= 0 || fpl <= 0 || d % (32 * fpl) != 0 || chunk <= 0 || chunk % PLAN_STEP != 0 ||
      nnz < 0)
    return cudaErrorInvalidValue;
  const PlanList rows = plan_list(lists, nnz, u_pad);
  const PlanList cols = plan_list(lists + 4, nnz, i_pad);
  const long long chunks = (nnz + chunk - 1) / chunk;
  const long long cu = walk_u ? chunks : 0, ci = walk_i ? chunks : 0;
  if (cu + ci == 0) return cudaSuccess;
  switch (fpl) {
    case 1:
      return launch_walk_fpl<A, 1>(rows, cols, cu, ci, chunk, qu, qi, yu, yi, d, aux, n_aux, s);
    case 2:
      return launch_walk_fpl<A, 2>(rows, cols, cu, ci, chunk, qu, qi, yu, yi, d, aux, n_aux, s);
    case 3:
      return launch_walk_fpl<A, 3>(rows, cols, cu, ci, chunk, qu, qi, yu, yi, d, aux, n_aux, s);
    case 4:
      return launch_walk_fpl<A, 4>(rows, cols, cu, ci, chunk, qu, qi, yu, yi, d, aux, n_aux, s);
    case 6:
      return launch_walk_fpl<A, 6>(rows, cols, cu, ci, chunk, qu, qi, yu, yi, d, aux, n_aux, s);
    case 8:
      return launch_walk_fpl<A, 8>(rows, cols, cu, ci, chunk, qu, qi, yu, yi, d, aux, n_aux, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
