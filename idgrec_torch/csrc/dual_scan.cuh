// The scan of the count matrix that K1 (dual_int8_t.cu), K7 (dual_int8_n.cu),
// K8 (dual_int4_n.cu) and K6 (dual_bf16.cu) share: both directions of the
// adjacency product from one read of M per feature group, on activations in
// the [N, d] layout,
//
//   yu[u, f] += sum_i M[u, i] * qi[i, f]      (M  @ qi, [U_pad, d])
//   yi[i, f] += sum_u M[u, i] * qu[u, f]      (M^T @ qu, [I_pad, d])
//
// as exact integer sums, then converted to float32 once. The arithmetic is
// a template argument (struct IntSums below has the members it needs): K1,
// K7 and K8 take int8 activations and exact int32 sums of the integer
// products (IntSums); K6 takes bfloat16 activations and sums in 64-bit fixed
// point, each entry's product rounded once to an integer (FixedSums in
// dual_bf16.cu). Either way every sum is an integer sum, so it does not
// depend on the order of the atomics, and two launches give the same bits.
//
// M is stored either as int8 [U_pad, I_pad] (K1, K7) or nibble-packed as
// [U_pad, I_pad / 2] (K8): within each tile of 2,048 logical columns, byte p
// (0..1023) holds column p in its low nibble and column 1,024 + p in its high
// nibble, unsigned (ops/fusedmm.py pack_nibbles). One scan reads the stored
// bytes once, so the packed matrix costs half the stream.
//
// Why a scan (measured on an H100, scripts/torch_k7_ablation.py, PERF.md):
// the tile kernels (mma.sync on 64 x 256 stages of M in shared memory,
// zero-tile votes, byte gathers for the M^T fragments) were limited by work
// inside the SM, not by the stream of M: the stream alone took 0.435 ms of
// 0.79 at d = 64. An interaction matrix is sparse (yelp2018: 0.1 % of M's
// entries are non-zero, about 16 in a 64 x 256 tile), so the tiles spent that
// work proving zeros. This scan spends it on the non-zero entries only:
// * Each warp streams its own contiguous share of M in 16-byte pieces, 2 KB
//   a round (four pieces a lane, the next round's loaded before this round's
//   entries are taken, with the streaming cache hint so that M does not push
//   the activations and sums out of L2), and tests each piece for a non-zero
//   byte. The scan is the bytes bound: one read of the stored matrix a
//   feature group. Each lane keeps its pieces' row and column, advanced each
//   round (no division in the loop), and finds its own piece's entries; the
//   warp then takes the non-zero pieces one by one (ballot, shuffles).
//   Finding a piece's row (a 64-bit division) and entries by the whole warp,
//   once a non-zero piece, made K8 0.705 ms at d = 64 against 0.554.
// * Each non-zero entry M[u, i] = v is taken by the whole warp: lane l
//   handles features l, l + 32, ... of the group, reads qi[i, f] (a row of
//   the activations that stays in L2) and adds v * qu[u, f] to yi[i, f] with
//   int32 atomicAdd (red.global: exact and order-free, so every launch gives
//   the same bits); a warp's 32 adds of one instruction cover 32 consecutive
//   features, 128 bytes. A warp's entries come in row order, so it keeps the
//   row's qu values and its partial sums of yu (v * qi[i, f]) in registers
//   and adds them into yu when the row changes: yu gets one atomic add a row
//   and warp instead of one an entry (at d = 128 those took 0.17 ms of
//   0.88). The entries a warp finds in a round are buffered one per lane and
//   taken a few at a time, their qi rows loaded together, while the next
//   round's pieces are in flight: an entry taken alone, its loads queued
//   behind the stream's, is a chain of latencies (1.33 ms at d = 64 on an
//   H100, against 0.44 ms for the scan alone).
// * A packed byte yields up to two entries (its two nibbles), an int8 byte
//   one; a piece's entries are numbered by one bit each of a 16-bit (int8)
//   or 32-bit (packed: low nibbles, then high nibbles) mask, and the warp's
//   32-entry buffer is flushed whenever it fills, also between the two
//   nibbles of one byte.
// * No shared memory, no tensor cores, no barriers in the loop: nothing holds
//   a warp but its own loads, and the other warps of the SM (two blocks of
//   eight, the register budget capped at 128 for that; 104-108 used) cover
//   them. The work per feature group is the scan, nnz * group atomic adds
//   into yi and about one row's flush per row and warp into yu. (K6's
//   arithmetic reduces its scales once per block before the loop.)
// * Feature groups: 128 features when d % 128 == 0, else 64 (d % 64 == 0),
//   else 32 (fusedmm.scan_feature_group states the same rule); each group is
//   one scan of M (the grid's y dimension, which the launcher reports).
// * Not used, and why: TMA and wgmma. The scan needs no shared memory or
//   staging for a bulk copy to feed, and the products are 0.1 % of the dense
//   ones the tensor cores would make.
// * The int32 sums become float32 once, in place or on their way to another
//   layout: exact while every sum stays below 2^24 (degree * 127 * count; the
//   wrappers' docstrings state it); K6's 64-bit sums are scaled back by its
//   own pass. The launcher reads the SM count once per process and device,
//   not once per call.
// A dense M makes the warp-per-entry work scale with its non-zeros: the scan
// stays exact there (the card tests take matrices up to fully dense) but is
// built for interaction matrices.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int UNROLL = 4;  // 16-byte pieces of M a thread has in flight
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_DEVICES = 64;
constexpr int HALF_TILE = 1024;  // packed: bytes of a 2,048-column tile
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t LO_NIBBLES = 0x0F0F0F0Fu;
constexpr uint32_t HI_NIBBLES = 0xF0F0F0F0u;

__device__ __forceinline__ void add_nonzero(int* dst, int v) {
  if (v != 0) atomicAdd(dst, v);
}

// two's complement: the 64-bit sums wrap as signed ones would
__device__ __forceinline__ void add_nonzero(long long* dst, long long v) {
  if (v != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(dst), static_cast<unsigned long long>(v));
}

// The scan's arithmetic for int8 activations: exact int32 products and sums
// (K1, K7, K8). A scan's arithmetic A names the stored activation (Act), an
// activation as a lane holds it (Val), the sums (Sum), the per-side factors
// the kernel computes once per block from the launcher's aux data (Scales,
// scales), how a loaded activation becomes a Val (val) and an entry's
// contribution (product).
struct IntSums {
  using Act = int8_t;
  using Val = int;
  using Sum = int;
  struct Scales {
    float u, i;
  };
  __device__ static Scales scales(const unsigned*, int) { return {1.0f, 1.0f}; }
  __device__ static Val val(Act a, float) { return a; }
  __device__ static Sum product(int v, Val a) { return v * a; }
};

// The row of M a warp is in: its partial sums of yu (lane l: features
// f0 + l + 32 k) and its row of qu, loaded once per row.
template <class A, int FPL>
struct RowState {
  int u;  // -1: no row yet
  typename A::Sum acc[FPL];
  typename A::Val q[FPL];
};

// Adds the row's partial sums into yu (another warp may hold the same row:
// atomics).
template <class A, int FPL>
__device__ __forceinline__ void flush_row(const RowState<A, FPL>& s,
                                          typename A::Sum* __restrict__ yu, int d, int f0,
                                          int lane) {
  if (s.u < 0) return;
  typename A::Sum* yu_row = yu + static_cast<size_t>(s.u) * d + f0 + lane;
#pragma unroll
  for (int k = 0; k < FPL; ++k) add_nonzero(yu_row + 32 * k, s.acc[k]);
}

// The n <= 32 non-zero entries of M a warp found, in scan order (rows never
// decrease), lane e < n holding entry e's row u, column i and count v, BATCH
// at a time: the warp reads the qi rows of BATCH entries first, then adds
// v * qi[i, f] to the row's partial sums (flushed into yu when the row
// changes) and v * qu[u, f] to yi[i, f], each as A::product forms it.
template <class A, int FPL>
__device__ __forceinline__ void take_entries(int n, int eu, int ei, int ev,
                                             const typename A::Act* __restrict__ qu,
                                             const typename A::Act* __restrict__ qi,
                                             typename A::Sum* __restrict__ yu,
                                             typename A::Sum* __restrict__ yi, int d, int f0,
                                             int lane, const typename A::Scales& sc,
                                             RowState<A, FPL>& s) {
  // entries whose activation rows load together (16 / FPL: 0.7955 ms against
  // 0.6965 at d = 64 on an H100, before the rows were kept)
  constexpr int BATCH = 8 / FPL;
  for (int e0 = 0; e0 < n; e0 += BATCH) {
    typename A::Val a[BATCH][FPL];
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int i = __shfl_sync(FULL, ei, (e0 + e) & 31);
#pragma unroll
      for (int k = 0; k < FPL; ++k)
        a[e][k] = e0 + e < n
                      ? A::val(__ldg(qi + static_cast<size_t>(i) * d + f0 + lane + 32 * k), sc.u)
                      : A::val(0, sc.u);
    }
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int u = __shfl_sync(FULL, eu, (e0 + e) & 31), i = __shfl_sync(FULL, ei, (e0 + e) & 31);
      const int v = __shfl_sync(FULL, ev, (e0 + e) & 31);
      if (e0 + e < n) {
        if (u != s.u) {  // warp-uniform: a new row
          flush_row(s, yu, d, f0, lane);
          s.u = u;
#pragma unroll
          for (int k = 0; k < FPL; ++k) {
            s.acc[k] = 0;
            s.q[k] = A::val(__ldg(qu + static_cast<size_t>(u) * d + f0 + lane + 32 * k), sc.i);
          }
        }
        typename A::Sum* yi_row = yi + static_cast<size_t>(i) * d + f0 + lane;
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
          s.acc[k] += A::product(v, a[e][k]);
          add_nonzero(yi_row + 32 * k, A::product(v, s.q[k]));
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

// The entries of one 16-byte piece (words w0..w3), one bit each: int8, bit j
// is byte j; packed, bit j is byte j's low nibble and bit 16 + j its high one.
template <bool PACKED>
__device__ __forceinline__ unsigned piece_entries(uint32_t w0, uint32_t w1, uint32_t w2,
                                                  uint32_t w3) {
  if constexpr (PACKED) {
    const unsigned lo = nonzero_bytes(w0 & LO_NIBBLES) | (nonzero_bytes(w1 & LO_NIBBLES) << 4) |
                        (nonzero_bytes(w2 & LO_NIBBLES) << 8) |
                        (nonzero_bytes(w3 & LO_NIBBLES) << 12);
    const unsigned hi = nonzero_bytes(w0 & HI_NIBBLES) | (nonzero_bytes(w1 & HI_NIBBLES) << 4) |
                        (nonzero_bytes(w2 & HI_NIBBLES) << 8) |
                        (nonzero_bytes(w3 & HI_NIBBLES) << 12);
    return lo | (hi << 16);
  } else {
    return nonzero_bytes(w0) | (nonzero_bytes(w1) << 4) | (nonzero_bytes(w2) << 8) |
           (nonzero_bytes(w3) << 12);
  }
}

// FPL features a lane: group = 32 * FPL. blockIdx.y is the feature group;
// each warp of a group scans its own contiguous range of the stored matrix
// (row_bytes bytes a row), ROUND pieces a round, lane l taking pieces l,
// l + 32, ... of the round. The next round's pieces are loaded before this
// round's entries are taken, so the stream of M does not wait on the
// activation rows. Each lane keeps the row and column of its first piece of
// the round, advanced by ROUND each round (no division in the loop), and the
// lanes of a warp find their own pieces' entries at once; then the warp
// takes the non-zero pieces one by one from their lanes. The entries come in
// row order, so the warp keeps the row's yu sums and qu row in registers.
// aux, n_aux: what A::scales reads (nothing for IntSums).
template <class A, int FPL, bool PACKED>
__global__ void __launch_bounds__(SCAN_THREADS, 2)
dual_scan_kernel(const int8_t* __restrict__ m, const typename A::Act* __restrict__ qu,
                 const typename A::Act* __restrict__ qi, typename A::Sum* __restrict__ yu,
                 typename A::Sum* __restrict__ yi, int u_pad, int row_bytes, int d,
                 const unsigned* __restrict__ aux, int n_aux) {
  constexpr int ROUND = 32 * UNROLL;
  const typename A::Scales sc = A::scales(aux, n_aux);
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * 32 * FPL;
  const int pieces_per_row = row_bytes / 16;
  const long long pieces = static_cast<long long>(u_pad) * pieces_per_row;
  // this warp's range of pieces: an even share, in whole rounds
  const long long warps = static_cast<long long>(gridDim.x) * (SCAN_THREADS / 32);
  const long long warp =
      static_cast<long long>(blockIdx.x) * (SCAN_THREADS / 32) + (threadIdx.x >> 5);
  const long long share = ((pieces + warps - 1) / warps + ROUND - 1) / ROUND * ROUND;
  const long long begin = warp * share;
  const long long end = begin + share < pieces ? begin + share : pieces;
  const uint4* src = reinterpret_cast<const uint4*>(m);
  // this lane's first piece of the round: row, piece of the row
  int row = static_cast<int>((begin + lane) / pieces_per_row);
  int col = static_cast<int>(begin + lane - static_cast<long long>(row) * pieces_per_row);
  uint4 cur[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const long long p = begin + 32 * k + lane;
    cur[k] = p < end ? __ldcs(src + p) : make_uint4(0u, 0u, 0u, 0u);
  }
  RowState<A, FPL> rs;
  rs.u = -1;
#pragma unroll
  for (int k = 0; k < FPL; ++k) {
    rs.acc[k] = 0;
    rs.q[k] = 0;
  }
  for (long long w0 = begin; w0 < end; w0 += ROUND) {
    uint4 nxt[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long p = w0 + ROUND + 32 * k + lane;
      nxt[k] = p < end ? __ldcs(src + p) : make_uint4(0u, 0u, 0u, 0u);
    }
    int n = 0, eu = 0, ei = 0, ev = 0;  // lane e < n: entry e
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const uint4 v = cur[k];
      unsigned todo = __ballot_sync(FULL, (v.x | v.y | v.z | v.w) != 0u);
      if (todo == 0u) continue;
      // every lane: its piece's entries, row, and the logical column of its
      // byte 0 (packed: of byte 0's low nibble, 2,048 t + c0 % 1,024)
      const unsigned mine = piece_entries<PACKED>(v.x, v.y, v.z, v.w);
      int r = row, c = col + 32 * k;
      while (c >= pieces_per_row) {
        c -= pieces_per_row;
        ++r;
      }
      const int c0 = c * 16;
      const int base_mine = PACKED ? 2 * c0 - c0 % HALF_TILE : c0;
      do {
        const int src_lane = __ffs(todo) - 1;
        todo &= todo - 1;
        unsigned bits = __shfl_sync(FULL, mine, src_lane);
        const int u = __shfl_sync(FULL, r, src_lane);
        const int base = __shfl_sync(FULL, base_mine, src_lane);
        const uint32_t w0x = __shfl_sync(FULL, v.x, src_lane), w1 = __shfl_sync(FULL, v.y, src_lane);
        const uint32_t w2 = __shfl_sync(FULL, v.z, src_lane), w3 = __shfl_sync(FULL, v.w, src_lane);
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const int j = b & 15;
          const uint32_t wj = j < 8 ? (j < 4 ? w0x : w1) : (j < 12 ? w2 : w3);
          const uint32_t byte = (wj >> (8 * (j & 3))) & 0xffu;
          if (lane == n) {
            eu = u;
            if constexpr (PACKED) {
              const int high = b >> 4;
              ei = base + j + high * HALF_TILE;
              ev = static_cast<int>((byte >> (4 * high)) & 0xfu);
            } else {
              ei = base + j;
              ev = static_cast<int8_t>(byte);
            }
          }
          if (++n == 32) {
            take_entries<A, FPL>(n, eu, ei, ev, qu, qi, yu, yi, d, f0, lane, sc, rs);
            n = 0;
          }
        }
      } while (todo);
    }
    if (n > 0) take_entries<A, FPL>(n, eu, ei, ev, qu, qi, yu, yi, d, f0, lane, sc, rs);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) cur[k] = nxt[k];
    col += ROUND;
    while (col >= pieces_per_row) {
      col -= pieces_per_row;
      ++row;
    }
  }
  flush_row(rs, yu, d, f0, lane);
}

// a's na and b's nb int32 sums to float32 in place, one launch for both
__global__ void int32_to_float_inplace(int* __restrict__ a, long long na, int* __restrict__ b,
                                       long long nb) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int* x = i < na ? a + i : b + (i - na);
  if (i < na + nb) {
    const float v = static_cast<float>(*x);
    *reinterpret_cast<float*>(x) = v;
  }
}

cudaError_t convert_sums(int* a, long long na, int* b, long long nb, cudaStream_t s) {
  const long long n = na + nb;
  int32_to_float_inplace<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(a, na, b, nb);
  return cudaGetLastError();
}

// the SM count of each device, read once per process (0: not read yet)
int g_sms[MAX_DEVICES];

// *sms: the current device's SM count, read once per process and device.
cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (g_sms[device] == 0 &&
      (err = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  *sms = g_sms[device];
  return cudaSuccess;
}

template <class A, int FPL, bool PACKED>
cudaError_t launch_group(const int8_t* m, const typename A::Act* qu, const typename A::Act* qi,
                         typename A::Sum* yu, typename A::Sum* yi, int u_pad, int row_bytes,
                         int d, int* passes, const unsigned* aux, int n_aux, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card once; a group's blocks share the scan
  const long long pieces = static_cast<long long>(u_pad) * (row_bytes / 16);
  const long long per_block = static_cast<long long>(SCAN_THREADS) * UNROLL;
  const long long want = (pieces + per_block - 1) / per_block;
  const int groups = d / (32 * FPL);
  const long long fill = static_cast<long long>(sms) * BLOCKS_PER_SM;
  const int blocks = static_cast<int>(want < fill ? want : fill);
  dim3 grid(blocks > 0 ? blocks : 1, groups);
  *passes = static_cast<int>(grid.y);
  dual_scan_kernel<A, FPL, PACKED><<<grid, SCAN_THREADS, 0, s>>>(m, qu, qi, yu, yi, u_pad,
                                                                 row_bytes, d, aux, n_aux);
  return cudaGetLastError();
}

// One launch: the scans of the stored matrix (row_bytes bytes a row; PACKED:
// nibble-packed) for every feature group of d (d % 32 == 0), adding into the
// zeroed sums yu [u_pad, d] and yi [rows of M's columns, d] in A's
// arithmetic. *passes: the scans launched.
template <class A, bool PACKED>
cudaError_t launch_scan_of(const int8_t* m, const typename A::Act* qu,
                           const typename A::Act* qi, typename A::Sum* yu, typename A::Sum* yi,
                           int u_pad, int row_bytes, int d, int* passes, const unsigned* aux,
                           int n_aux, cudaStream_t s) {
  if (d <= 0 || d % 32 != 0 || row_bytes % 16 != 0) return cudaErrorInvalidValue;
  return d % 128 == 0 ? launch_group<A, 4, PACKED>(m, qu, qi, yu, yi, u_pad, row_bytes, d,
                                                   passes, aux, n_aux, s)
         : d % 64 == 0 ? launch_group<A, 2, PACKED>(m, qu, qi, yu, yi, u_pad, row_bytes, d,
                                                    passes, aux, n_aux, s)
                       : launch_group<A, 1, PACKED>(m, qu, qi, yu, yi, u_pad, row_bytes, d,
                                                    passes, aux, n_aux, s);
}

// launch_scan_of in the int8 arithmetic: exact int32 sums (K1, K7, K8).
template <bool PACKED>
cudaError_t launch_scan(const int8_t* m, const int8_t* qu, const int8_t* qi, int* yu, int* yi,
                        int u_pad, int row_bytes, int d, int* passes, cudaStream_t s) {
  return launch_scan_of<IntSums, PACKED>(m, qu, qi, yu, yi, u_pad, row_bytes, d, passes, nullptr,
                                         0, s);
}

}  // namespace
