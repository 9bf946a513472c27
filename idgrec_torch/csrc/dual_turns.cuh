// The duals of the quantized chain, K1 (dual_int8_t.cu, int8 M) and K5
// (dual_int4_t.cu, nibble-packed M): the scan of dual_scan.cuh between two
// layout turns, three launches a call,
//
//   yuT[f, u] = sum_i qiT[f, i] * M[u, i]      (M  @ qi, as [d, U_pad])
//   yiT[f, i] = sum_u quT[f, u] * M[u, i]      (M^T @ qu, as [d, I_pad])
//
// with the chain's activations in the transposed [d, N] layout, d = 64:
// * turn in: quT and qiT become one int8 [U_pad + I_pad, 64] scratch (users,
//   then items), through a 64 x 64 shared-memory tile so that reads and
//   writes both coalesce; the same blocks zero the int32 sums the scan adds
//   into (and, for a chain sweep where a side wants a next input, the amax
//   outputs and the NaN-tile counts below). A warp-per-entry scan reading a
//   column of qiT straight from [d, N] would touch 64 separate 32-byte
//   sectors per entry where the [N, d] row touches 2, and so would the
//   atomics into [d, N] sums. Each side's input has a mode (SideInput): the
//   int8 q with its scale (the public entries, and a sweep on K3's output);
//   for the chain's sweeps the previous sweep's float32 z with its amax,
//   rounded on the way into the tile as K3 (quantize_rows.cu) rounds it,
//   through the same functions of chain_epilogue.cuh (s = amax / 127, or 1;
//   q = round-half-even(z / s)); or a zero input (q = 0, s = 1: EGCF's seed
//   sweeps). A sweep on (z, amax) so equals K3 on each side followed by the
//   sweep on (q, s), bit for bit, without K3's launches and its int8 copy of
//   q; the TPU kernel likewise rounded the previous sweep's output at each
//   block's first use (idgrec_tpu/ops/chainmm.py _consume_u / _consume_i,
//   l.228-262). The turn-in's first block writes each input's scale (K3's
//   s for z, the given scale for q, 1 for a zero input) into the sweep's
//   aux, and the turn-out dequantizes each side's sums by the other side's,
//   a plain load as before: a division there would cost the turn-out 0.005
//   ms a sweep on an H100 (PERF.md).
// * the scan: one feature group of 64, one read of the stored matrix, int32
//   atomics into [U_pad + I_pad, 64].
// * turn out: a block holds the int32 sums of 64 nodes x 64 features in
//   shared memory, converts each to float32 once (exact while every sum
//   stays below 2^24) and writes it transposed into the [d, N] layout, both
//   sides in one launch. The raw mode writes the sums (the public entries:
//   fused_adj_matmul_int8_t / _int4_t). A chain sweep's mode writes, in the
//   same pass, what the separate epilogue kernels computed from those sums
//   in two more launches, nh = post[n] * (y * s_in[f]) first:
//     forward      (K2, chain_sweep_epilogue.cu) c = nh or c + nh (the
//                  combine); z = pre[n] * nh and amax[f] = max |z| when a
//                  sweep follows
//     inject       (K2's inject mode) st = nh, g + st when injecting;
//                  out = pre[n] * st and its amax when a sweep follows, else st
//     tanh         (K9, chain_sweep_tanh.cu) h = tanhf(nh) into the side's h
//                  slice; c = h or c + h; z = pre[n] * h and its amax when a
//                  sweep follows
//     tanh inject  (K10) st = nh, g + st when injecting; when a sweep follows
//                  out = pre[n] * ((1 - h * h) * st) with h read from the
//                  forward's slice, and its amax; else out = st
//   (their operation order, through the functions of chain_epilogue.cuh
//   that they use too, no FMA contraction, the CUDA math library's tanhf), so the sweep equals K1 or
//   K5 followed by two K2, K9 or K10 launches bit for bit. This replaces
//   the completion that the TPU kernel ran at each block's last reduction
//   step (idgrec_tpu/ops/chainmm.py _chunk l.322-359, the amax update
//   l.311-320, the inject branch l.341-352, the tanh chunks _chunk_fwd_act
//   l.366 and _chunk_bwd_act l.391).
//
// Each side of a sweep has its own state (SideSweep): whether it wants a
// next input, and whether it runs at all; the flag (the combine, or whether
// g is added) is the sweep's. EGCF's seed sweeps need that (idgrec_tpu/ops/chainmm.py l.477-535): the forward's seed sweep runs
// only the user side; the backward's sweep K - 1 wants a next input of the
// users alone; its sweep K runs only the item side. The turn-out's grid
// leaves a skipped side's tiles out (from the first tile of the item side
// when the users are skipped); only a side that wants a next input counts
// its blocks in `done`, and the last of them writes that side's amax alone.
//
// The per-feature amax: each warp reduces its features over the tile's 64
// nodes with fmaxf and adds its maxima with one atomicMax on the float's
// bits (non-negative floats order as their bits), order-free and so exact,
// into the maximum of the tile's K2 block (below); the last turn-out block
// to finish takes the maximum over those into amax. A single amax target
// would take 64 atomics from each of the 1,096 tiles at yelp2018 scale on
// four cache lines, and cost the sweep 0.02 ms on an H100; the K2 blocks'
// maxima spread them over 138 lines (scripts/torch_k7_ablation.py, its
// sweep section, measures both; PERF.md). fmaxf drops a NaN beside a
// number, and K2, K9 and K10 reduce over blocks of 1,024 nodes before their
// atomicMax, so their amax is NaN only where some block of 1,024 nodes holds
// nothing but NaN (its last block, partly outside N, also reduces a 0 in).
// To give the same bits here, a tile whose 64 values are all NaN is counted
// per feature and K2 block instead of sent; the tile that completes a
// block's count of 16 sends its NaN. The turn-in zeroes the counts, the
// maxima and the count of finished blocks.
//
// K1 replaces idgrec_tpu/ops/fusedmm.py _tkernel_int8 (l.674, launched by
// _tdual_small_call l.758) and _tkernel_int8_panel (l.797, launched by
// _tdual_panel_call l.881); K5 _tkernel_int4 (l.708) and _tkernel_int4_panel
// (l.832), entry fused_adj_matmul_int4_t (l.944). The TPU needed two bodies
// because its yi accumulator had to fit VMEM; here one scan covers both.
// The launchers make no per-call attribute or occupancy query: the turns
// use static shared memory, and the scan's launcher reads the SM count once
// per process and device.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_epilogue.cuh"
#include "dual_scan.cuh"

namespace {

constexpr int D = 64;       // feature rows of the activations
constexpr int TILE = 64;    // nodes per block of the turns
constexpr int TURN_THREADS = 256;
constexpr int TURN_WARPS = TURN_THREADS / 32;
constexpr int Q_PITCH = TILE + 4;  // bytes per feature row of the turn-in tile (skews banks)
// nodes a block of K2 (chain_sweep_epilogue.cu: THREADS * PER_THREAD)
// reduces before its atomicMax, and the turn-out tiles in it
constexpr int K2_BLOCK = 1024;
constexpr int K2_BLOCK_TILES = K2_BLOCK / TILE;

// what the turn-out writes (fusedmm.SWEEP_*)
enum TurnMode { kRaw = 0, kForward = 1, kInject = 2, kTanh = 3, kTanhInject = 4 };
// what the turn-in reads of a side (fusedmm.INPUT_*)
enum InputMode { kInQ = 0, kInZ = 1, kInZero = 2 };

// One side's input of a call, [64, n] layout.
struct SideInput {
  const void* x;   // kInQ: int8 q; kInZ: float32 z; kInZero: unused
  const float* a;  // [64] kInQ: q's scale; kInZ: z's per-feature amax; kInZero: unused
  int mode;
};

// the scale of feature f of a side's input, the one K3 gives for (z, amax)
__device__ __forceinline__ float input_scale(const SideInput& in, int f) {
  if (in.mode == kInQ) return in.a[f];
  return in.mode == kInZ ? scale_of(in.a[f]) : 1.0f;
}

// One side (users or items) of a chain sweep's epilogue, [d, n] layout.
struct SideSweep {
  const float* s_in;  // [64] the other side's input scale, written by the turn-in
  const float* post;  // [n]
  const float* pre;   // [n], read when a sweep follows
  float* ext;         // forward, tanh: the combine c, read and written; inject, tanh
                      // inject: g, read only
  float* out;         // raw: the sums; forward, tanh: z (when a sweep follows); inject,
                      // tanh inject: out
  float* hs;          // tanh: the h slice, written; tanh inject: h, read when a sweep follows
  float* amax;        // [64], zeroed by the turn-in when this side wants a next input
  int n;
  int want_next;
};

struct Sweep {
  SideSweep side[2];   // users, items
  int flag;            // forward, tanh: the combine mode; inject, tanh inject: whether g is added
  // zeroed by the turn-in when a side wants a next input:
  int* nan_tiles;      // [K2 blocks of both sides, 64] all-NaN tiles
  int* block_max;      // [K2 blocks of both sides, 64] the float bits of their maxima
  int* done;           // turn-out blocks finished, of the sides that want a next input
  int u_blocks;        // K2 blocks of the user side
  int k2_blocks;       // K2 blocks of both sides
  int first_tile;      // the turn-out's first tile: 0, or u_pad / 64 with the users skipped
  int tiles;           // the turn-out's grid: the tiles of the sides that run
  int counted;         // the tiles of the sides that want a next input
};

// Block b turns 64 nodes: b < u_pad / 64 the users of in_u, else the items
// of in_i. Its [64, n] input -> q rows [row0, row0 + 64) of [U_pad + I_pad,
// 64] (z rounded by its scale on the way, a zero input written as zeros),
// and the same rows of the int32 sums zeroed; extra[0, n_extra) zeroed too.
// Block 0 writes the inputs' scales to scales[0, 128) (users', then
// items'), where not null.
__global__ void __launch_bounds__(TURN_THREADS)
turn_in(SideInput in_u, SideInput in_i, int8_t* __restrict__ q, int* __restrict__ acc, int u_pad,
        int i_pad, int* __restrict__ extra, int n_extra, float* __restrict__ scales) {
  static_assert(TURN_THREADS >= 2 * D, "one thread for each of the 2 x 64 scales");
  __shared__ __align__(16) int8_t tile[D * Q_PITCH];
  const int t = threadIdx.x;
  const int user_blocks = u_pad / TILE;
  const bool user = static_cast<int>(blockIdx.x) < user_blocks;
  const SideInput in = user ? in_u : in_i;  // its mode is uniform across the block
  const int n_stride = user ? u_pad : i_pad;
  const int n0 = (user ? blockIdx.x : blockIdx.x - user_blocks) * TILE;
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE;
  for (int e = blockIdx.x * TURN_THREADS + t; e < n_extra; e += gridDim.x * TURN_THREADS)
    extra[e] = 0;
  // each parameter struct read directly: picking one per thread would put
  // both in local memory, and every thread's input reads behind them
  if (scales != nullptr && blockIdx.x == 0 && t < 2 * D)
    scales[t] = t < D ? input_scale(in_u, t) : input_scale(in_i, t - D);
  // read: feature f, nodes c .. c + 15 (16 bytes a thread, 64 bytes a row of
  // q; z: four float4 loads, all in flight before the rounding)
  {
    const int f = t >> 2, c = (t & 3) * 16;
    const size_t at = static_cast<size_t>(f) * n_stride + n0 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (in.mode == kInQ) {
      v = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(in.x) + at);
    } else if (in.mode == kInZ) {
      const float4* z = reinterpret_cast<const float4*>(static_cast<const float*>(in.x) + at);
      const float4 z0 = z[0], z1 = z[1], z2 = z[2], z3 = z[3];
      const float s = scale_of(in.a[f]);
      v = make_uint4(q8x4(z0, s), q8x4(z1, s), q8x4(z2, s), q8x4(z3, s));
    }
    uint32_t* row = reinterpret_cast<uint32_t*>(tile + f * Q_PITCH + c);
    row[0] = v.x;
    row[1] = v.y;
    row[2] = v.z;
    row[3] = v.w;
  }
  // zero the int32 sums of these 64 rows: 16 KB, four 16-byte stores a thread
  uint4* dst = reinterpret_cast<uint4*>(acc + row0 * D);
#pragma unroll
  for (int k = 0; k < 4; ++k) dst[t + k * TURN_THREADS] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // write: node n, features f .. f + 15 gathered from the tile's column n
  const int n = t >> 2, f = (t & 3) * 16;
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int8_t* col = tile + (f + 4 * k) * Q_PITCH + n;
    w[k] = static_cast<uint32_t>(static_cast<uint8_t>(col[0])) |
           (static_cast<uint32_t>(static_cast<uint8_t>(col[Q_PITCH])) << 8) |
           (static_cast<uint32_t>(static_cast<uint8_t>(col[2 * Q_PITCH])) << 16) |
           (static_cast<uint32_t>(static_cast<uint8_t>(col[3 * Q_PITCH])) << 24);
  }
  *reinterpret_cast<uint4*>(q + (row0 + n) * D + f) = make_uint4(w[0], w[1], w[2], w[3]);
}

// A tile's maximum of feature f (m: fmaxf over its 64 values) into its K2
// block's: a number by its bits; an all-NaN tile counted in the block,
// whose 16th such tile sends the NaN.
__device__ __forceinline__ void tile_max(float m, int* block_max, int* nan_count) {
  if (isnan(m)) {
    if (atomicAdd(nan_count, 1) == K2_BLOCK_TILES - 1) atomicMax(block_max, __float_as_int(m));
  } else if (m > 0.0f) {
    atomicMax(block_max, __float_as_int(m));
  }
}

// The last counted turn-out block to finish: amax[f] of each side that
// wants a next input, the maximum of its K2 blocks' (as float bits; at
// least 0). Two threads an output, each over every other K2 block, their
// loads independent.
__device__ __forceinline__ void finish_amax(const Sweep& sw) {
  static_assert(TURN_THREADS == 4 * D, "two threads for each of the 2 x 64 outputs");
  __shared__ int part[TURN_THREADS];
  const int i = threadIdx.x % (2 * D), half = threadIdx.x / (2 * D);
  const int f = i % D;
  const bool items = i >= D;
  const bool wanted = sw.side[items ? 1 : 0].want_next;
  const int b1 = items ? sw.k2_blocks : sw.u_blocks;
  int v = 0;
  if (wanted) {
#pragma unroll 8
    for (int b = (items ? sw.u_blocks : 0) + half; b < b1; b += 2)
      v = max(v, __ldcg(sw.block_max + b * D + f));
  }
  part[threadIdx.x] = v;
  __syncthreads();
  if (half == 0 && wanted)
    sw.side[items ? 1 : 0].amax[f] = __int_as_float(max(v, part[i + 2 * D]));
}

// Tile b = blockIdx.x + first_tile turns 64 rows of the int32 sums back:
// b < u_pad / 64 into the user side [64, u_pad], else into the item side
// [64, i_pad], converted to float32 on the way and, in a chain sweep's mode,
// completed by its epilogue. Warp w writes features w, w + 8, ..., lane l
// nodes l and l + 32 of the tile: 32 consecutive floats a store. A thread
// issues all its reads of the combine or cotangent, of h, the scales and
// the vectors before the sums' tile: its loads in flight together, not one
// at a time behind its stores. The flag and a side's want_next are uniform
// across its blocks.
template <int MODE>
__global__ void __launch_bounds__(TURN_THREADS)
turn_out(const int* __restrict__ acc, Sweep sw, int u_pad) {
  constexpr int KF = D / TURN_WARPS;  // features a warp writes
  constexpr bool kCombines = MODE == kForward || MODE == kTanh;  // else g is injected
  __shared__ float tile[TILE][D + 1];
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int user_blocks = u_pad / TILE;
  const int b = static_cast<int>(blockIdx.x) + sw.first_tile;
  const bool user = b < user_blocks;
  const SideSweep sd = user ? sw.side[0] : sw.side[1];
  const int n0 = (user ? b : b - user_blocks) * TILE;
  const size_t at0 = static_cast<size_t>(warp) * sd.n + n0 + lane;  // feature warp, node lane
  const size_t f_step = static_cast<size_t>(TURN_WARPS) * sd.n;
  float post[2] = {}, pre[2] = {}, s_in[KF] = {}, ext[KF][2] = {}, hv[KF][2] = {};
  if constexpr (MODE != kRaw) {
    const bool reads_ext = kCombines ? sw.flag == kAdd : sw.flag != 0;
    const bool reads_h = MODE == kTanhInject && sd.want_next;
#pragma unroll
    for (int k = 0; k < KF; ++k) {
      s_in[k] = sd.s_in[warp + TURN_WARPS * k];
      if (reads_ext) {
        ext[k][0] = sd.ext[at0 + k * f_step];
        ext[k][1] = sd.ext[at0 + k * f_step + 32];
      }
      if (reads_h) {
        hv[k][0] = sd.hs[at0 + k * f_step];
        hv[k][1] = sd.hs[at0 + k * f_step + 32];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      post[h] = sd.post[n0 + lane + 32 * h];
      if (sd.want_next) pre[h] = sd.pre[n0 + lane + 32 * h];
    }
  }
  const int4* src = reinterpret_cast<const int4*>(acc + static_cast<long long>(b) * TILE * D);
  // read: 64 rows of 64 sums, 16 bytes a thread a round
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int idx = t + k * TURN_THREADS;
    const int r = idx >> 4, c = (idx & 15) * 4;
    const int4 v = src[idx];
    tile[r][c] = static_cast<float>(v.x);
    tile[r][c + 1] = static_cast<float>(v.y);
    tile[r][c + 2] = static_cast<float>(v.z);
    tile[r][c + 3] = static_cast<float>(v.w);
  }
  __syncthreads();
  const int k2_block = ((user ? 0 : sw.u_blocks) + n0 / K2_BLOCK) * D;
#pragma unroll
  for (int k = 0; k < KF; ++k) {
    const int f = warp + TURN_WARPS * k;
    const size_t at = at0 + k * f_step;
    if constexpr (MODE == kRaw) {
      sd.out[at] = tile[lane][f];
      sd.out[at + 32] = tile[lane + 32][f];
    } else {
      float a[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t e = at + 32 * h;
        const float nh = dequant(post[h], tile[lane + 32 * h][f], s_in[k]);
        if constexpr (kCombines) {
          float v = nh;
          if constexpr (MODE == kTanh) {
            v = tanhf(nh);
            sd.hs[e] = v;
          }
          if (sw.flag == kSet) {
            sd.ext[e] = v;
          } else if (sw.flag == kAdd) {
            sd.ext[e] = __fadd_rn(ext[k][h], v);
          }
          if (sd.want_next) {
            const float z = __fmul_rn(pre[h], v);
            sd.out[e] = z;
            a[h] = fabsf(z);
          }
        } else {
          float st = sw.flag ? __fadd_rn(ext[k][h], nh) : nh;
          if (sd.want_next) {
            st = __fmul_rn(pre[h], MODE == kTanhInject ? tanh_grad(hv[k][h], st) : st);
            a[h] = fabsf(st);
          }
          sd.out[e] = st;
        }
      }
      if (sd.want_next) {  // uniform across the block
        float m = fmaxf(a[0], a[1]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
        if (lane == 0) tile_max(m, sw.block_max + k2_block + f, sw.nan_tiles + k2_block + f);
      }
    }
  }
  if constexpr (MODE != kRaw) {
    if (sd.want_next) {  // uniform across the block
      __shared__ bool last;
      if (lane == 0) __threadfence();  // this warp's maxima before the block's count
      __syncthreads();
      if (t == 0) last = atomicAdd(sw.done, 1) == sw.counted - 1;
      __syncthreads();
      if (last) {
        __threadfence();
        finish_amax(sw);
      }
    }
  }
}

// The three launches of one call on the stored matrix m (PACKED: nibble-
// packed, [u_pad, i_pad / 2]) and the inputs in_u [64, u_pad], in_i [64,
// i_pad]. q_scratch: int8 [(u_pad + i_pad) * 64]; acc_scratch: int32
// [(u_pad + i_pad) * 64]; both 16-byte aligned. extra[0, n_extra) is zeroed
// by the turn-in, scales[0, 128) written (where not null).
template <bool PACKED, int MODE>
cudaError_t launch_turned(const void* m, const SideInput& in_u, const SideInput& in_i,
                          void* q_scratch, void* acc_scratch, int* extra, int n_extra,
                          float* scales, const Sweep& sw, int u_pad, int i_pad, cudaStream_t s) {
  if (u_pad <= 0 || i_pad <= 0 || u_pad % TILE != 0 || i_pad % TILE != 0 ||
      (PACKED && i_pad % (2 * HALF_TILE) != 0))
    return cudaErrorInvalidValue;
  int8_t* q = static_cast<int8_t*>(q_scratch);
  int* acc = static_cast<int*>(acc_scratch);
  const unsigned blocks = static_cast<unsigned>((u_pad + i_pad) / TILE);
  turn_in<<<blocks, TURN_THREADS, 0, s>>>(in_u, in_i, q, acc, u_pad, i_pad, extra, n_extra,
                                          scales);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int passes = 0;
  err = launch_scan<PACKED>(static_cast<const int8_t*>(m), q, q + static_cast<size_t>(u_pad) * D,
                            acc, acc + static_cast<size_t>(u_pad) * D, u_pad,
                            PACKED ? i_pad / 2 : i_pad, D, &passes, s);
  if (err != cudaSuccess) return err;
  turn_out<MODE><<<static_cast<unsigned>(sw.tiles), TURN_THREADS, 0, s>>>(acc, sw, u_pad);
  return cudaGetLastError();
}

// The raw sums: yuT [64, u_pad], yiT [64, i_pad] float32 (no zeroing needed).
template <bool PACKED>
int dual_t(const void* m, const void* quT, const void* qiT, void* yuT, void* yiT,
           void* q_scratch, void* acc_scratch, int u_pad, int i_pad, void* stream) {
  Sweep sw = {};
  sw.side[0].out = static_cast<float*>(yuT);
  sw.side[0].n = u_pad;
  sw.side[1].out = static_cast<float*>(yiT);
  sw.side[1].n = i_pad;
  sw.tiles = (u_pad + i_pad) / TILE;
  const SideInput in_u = {quT, nullptr, kInQ}, in_i = {qiT, nullptr, kInQ};
  return static_cast<int>(launch_turned<PACKED, kRaw>(m, in_u, in_i, q_scratch, acc_scratch,
                                                      nullptr, 0, nullptr, sw, u_pad, i_pad,
                                                      static_cast<cudaStream_t>(stream)));
}

// K2 blocks of a side of n nodes
__host__ __device__ constexpr int k2_blocks(int n) { return (n + K2_BLOCK - 1) / K2_BLOCK; }

// the words of a sweep's aux buffer that the turn-in zeroes
__host__ __device__ constexpr int sweep_zeroed_words(int u_pad, int i_pad) {
  return 2 * D + 2 * D * (k2_blocks(u_pad) + k2_blocks(i_pad)) + 4;
}

// the words of a sweep's aux buffer: those, then the inputs' scales
__host__ __device__ constexpr int sweep_aux_words(int u_pad, int i_pad) {
  return sweep_zeroed_words(u_pad, i_pad) + 2 * D;
}

// One chain sweep (mode 1 forward, 2 inject, 3 tanh, 4 tanh inject; see the
// note at the top). x_u, a_u / x_i, a_i: the user and the item input, by
// in_u / in_i: kInQ int8 q [64, n] and its scale [64]; kInZ float32 z
// [64, n] and its amax [64], rounded in the turn-in as K3 rounds it; kInZero
// no pointer (q = 0, s = 1). The user sums dequantize by the item input's
// scale, the item sums by the user input's. An amax may lie in the previous
// sweep's aux: this sweep's turn-in and turn-out read it, so it must not be
// this sweep's aux. post_*, pre_*: [n] of each side; ext_*: the combine c
// (forward, tanh) or the cotangent g (inject, tanh inject), [64, n]; out_*:
// z (forward, tanh: when a sweep follows) or out (inject, tanh inject),
// [64, n], not aliasing ext_*; hs_*: the side's h slice [64, n] (tanh:
// written; tanh inject: read when a sweep follows; otherwise unused). aux:
// float32 [sweep_aux_words(u_pad, i_pad)]: the two amax vectors (users,
// items), then the NaN-tile counts, the K2 blocks' maxima and the count of
// finished blocks, zeroed here when a side wants a next input; then the
// inputs' scales (users', items'), written by the turn-in. sides: 1 the
// users, 2 the items, 3 both; a side left out writes nothing and wants no
// next input (its input is still turned in: the other side's sums need it).
// flag: the combine mode (forward, tanh) or whether g is added (inject, tanh
// inject), both sides alike; next_*: whether the side wants a next input and
// its amax.
template <bool PACKED>
int dual_t_sweep(const void* m, const void* x_u, const void* x_i, const void* a_u,
                 const void* a_i, void* q_scratch, void* acc_scratch, void* aux,
                 const void* post_u, const void* pre_u, const void* post_i, const void* pre_i,
                 void* ext_u, void* ext_i, void* out_u, void* out_i, void* hs_u, void* hs_i,
                 int u_pad, int i_pad, int in_u, int in_i, int mode, int sides, int flag,
                 int next_u, int next_i, void* stream) {
  const bool combines = mode == kForward || mode == kTanh;
  const bool runs[2] = {(sides & 1) != 0, (sides & 2) != 0};
  if (sides < 1 || sides > 3 || mode < kForward || mode > kTanhInject ||
      (combines && (flag < kNone || flag > kAdd)) || in_u < kInQ || in_u > kInZero ||
      in_i < kInQ || in_i > kInZero)
    return static_cast<int>(cudaErrorInvalidValue);
  const SideInput in[2] = {{x_u, static_cast<const float*>(a_u), in_u},
                           {x_i, static_cast<const float*>(a_i), in_i}};
  float* amax = static_cast<float*>(aux);
  const int u_blocks = k2_blocks(u_pad);
  const int u_tiles = u_pad / TILE, i_tiles = i_pad / TILE;
  float* scales = amax + sweep_zeroed_words(u_pad, i_pad);
  Sweep sw;
  sw.side[0] = {scales + D, static_cast<const float*>(post_u),
                static_cast<const float*>(pre_u), static_cast<float*>(ext_u),
                static_cast<float*>(out_u), static_cast<float*>(hs_u), amax, u_pad,
                runs[0] && next_u != 0};
  sw.side[1] = {scales, static_cast<const float*>(post_i),
                static_cast<const float*>(pre_i), static_cast<float*>(ext_i),
                static_cast<float*>(out_i), static_cast<float*>(hs_i), amax + D, i_pad,
                runs[1] && next_i != 0};
  sw.flag = flag;
  sw.u_blocks = u_blocks;
  sw.k2_blocks = u_blocks + k2_blocks(i_pad);
  sw.nan_tiles = reinterpret_cast<int*>(amax + 2 * D);
  sw.block_max = sw.nan_tiles + D * sw.k2_blocks;
  sw.done = sw.block_max + D * sw.k2_blocks;
  sw.first_tile = runs[0] ? 0 : u_tiles;
  sw.tiles = (runs[0] ? u_tiles : 0) + (runs[1] ? i_tiles : 0);
  sw.counted = (sw.side[0].want_next ? u_tiles : 0) + (sw.side[1].want_next ? i_tiles : 0);
  const int n_extra = sw.counted ? sweep_zeroed_words(u_pad, i_pad) : 0;
  int* extra = reinterpret_cast<int*>(aux);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kForward:
      err = launch_turned<PACKED, kForward>(m, in[0], in[1], q_scratch, acc_scratch, extra,
                                            n_extra, scales, sw, u_pad, i_pad, s);
      break;
    case kInject:
      err = launch_turned<PACKED, kInject>(m, in[0], in[1], q_scratch, acc_scratch, extra,
                                           n_extra, scales, sw, u_pad, i_pad, s);
      break;
    case kTanh:
      err = launch_turned<PACKED, kTanh>(m, in[0], in[1], q_scratch, acc_scratch, extra, n_extra,
                                         scales, sw, u_pad, i_pad, s);
      break;
    default:
      err = launch_turned<PACKED, kTanhInject>(m, in[0], in[1], q_scratch, acc_scratch, extra,
                                               n_extra, scales, sw, u_pad, i_pad, s);
  }
  return static_cast<int>(err);
}

}  // namespace
