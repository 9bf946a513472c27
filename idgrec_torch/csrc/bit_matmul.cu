// K11 bit_matmul: one direction of the bit-packed binary adjacency product,
// activations rounded to bf16, float32 sums, output in natural row order.
//
//   y[r, f] = sum_c bit(r, c) * x[c, f],    bit(r, c) = (packed[r / 8, c] >> (r % 8)) & 1
//
// Replaces idgrec_tpu/ops/bitmm.py _mm_kernel (l.94), launched by _bit_matmul
// (l.114); entry bit_adj_matmul, one launch per direction (M and M^T each
// have their own packing), whose backward is the same two launches on the
// swapped cotangents. The TPU kernel wrote the row-group layout
// [8, R_pad / 8, d] so that unpacked bit-planes line up with sublanes; here
// the rows come out in natural order and no layout pass follows.
//
// Bound on the H100: bytes. The function needs one add per set bit and
// feature, 2 * nnz * d operations, far less than reading the
// R_pad * C_pad / 8 bytes of bits takes. The TPU kernel and this kernel's
// first version multiplied every bit, zeros included, on the matrix units:
// 2 * R_pad * C_pad * d bf16 operations, 3.2 times the byte bound at the
// bf16 peak (1.23 ms an application at yelp2018 scale on an H100, PERF.md).
// The matrix is 0.1 % dense, so this version follows the set bits instead.
//
// Design: a scan of the packed rows, the lesson of the dual scan
// (dual_scan.cuh) applied to the bits, with the work split by a plan.
// * The packed matrix is cut into stripes: 32 pieces of 16 bytes of one
//   packed row (a row group: 8 output rows), the last of a row cut short, in
//   row-major order. Warp w of the launch takes stripes plan[w] ..
//   plan[w + 1] - 1 (bitmm.plan_rows makes the plan once per packed matrix,
//   from its non-zero bytes, so that the warps' work is about equal; a
//   launch has one warp a part of the plan). Interaction matrices are
//   skewed: at yelp2018 scale the heaviest item group holds 30,723 non-zero
//   bytes against a mean of 239; one block a group took 2.37 ms on it, and
//   clusters of blocks on one group each cost the light groups more than
//   they saved (PERF.md). Any non-decreasing plan gives the same sums; the
//   plan only balances the work.
// * Each warp streams its stripes through a ring of RING stripes in shared
//   memory, filled by the copy engine (cp.async.bulk, one mbarrier a slot;
//   1 KB a warp in flight, no registers held), and finds the non-zero pieces
//   by ballot. Each non-zero byte at column c is an entry: its 8 bits say
//   which of the group's rows take x[c, :]. The lanes list their pieces'
//   entries in the warp's list in shared memory, in column order (a prefix
//   sum of their counts; the whole warp finding them one at a time was
//   slower, PERF.md). Whenever BATCH entries (2 KB of rows) are listed,
//   the warp copies their rows of x into one of its two stages in shared
//   memory by cp.async (whole rows an instruction, the batch in flight at
//   once, no registers held) and adds the batch before, which has landed:
//   for each of the 8 rows a ballot names the entries whose bit is set, and
//   the warp adds their staged rows, rounded to bf16 as .to(bfloat16)
//   rounds (cvt.rn), one set bit at a time.
// * Lanes: V consecutive features a lane, LPR lanes across the group's
//   DF = V * LPR features; at DF < 32 the 32 / LPR lane slices split the 8
//   rows, so d = 8 and 16 keep every lane busy. A lane holds 8 * DF / 32
//   sums in registers.
// * No atomics. A warp sums each row group's entries in column order; a
//   group that lies wholly in one warp's stripes is written by that warp.
//   The others (a warp's first and last group may be shared) go to a record
//   of the warp, and a second launch adds a group's records in a fixed
//   order (the first warp's, then eight running sums over the others). The
//   order depends on the plan and the shapes alone, so two launches give the
//   same bits.
// * The bf16 rounding of float32 x is done here, on the values the entries
//   load, so the wrapper issues no cast or pad: a column past x's rows adds
//   nothing, as a zero-padded row would. A non-finite x value reaches only the rows
//   whose bits select it (the function's sum over set bits; a zero bit never
//   multiplies it).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

constexpr int WARPS = 4;            // warps a block; a launch has as many as the plan's parts
constexpr int THREADS = WARPS * 32;
constexpr int FIX_THREADS = 512;    // the fixup: a thread an output element of a group (at DF = 64)
constexpr int STRIPE = 32;          // pieces a warp reads at once, one a lane
constexpr int STRIPE_BYTES = 16 * STRIPE;
constexpr int RING = 2;             // stripes a warp has in flight
constexpr int LIST = 1024;          // entries a warp's list holds (a ring; a stripe adds <= 512)
constexpr unsigned FULL = 0xffffffffu;

// V features a lane, LPR lanes across a group's DF features; RS lane slices
// split the 8 rows, NR rows a lane.
template <int V, int LPR>
struct Lay {
  static constexpr int DF = V * LPR;
  static constexpr int RS = 32 / LPR;
  static constexpr int NR = 8 / RS;
  // entries a stage holds: 2 KB of float32 rows, at most 32 (one a lane)
  static constexpr int BATCH = 512 / DF < 32 ? 512 / DF : 32;
};

// A warp's shared memory: its ring of stripes, its two stages of x rows, its
// ring's barriers.
template <int V, int LPR>
struct WarpSmem {
  static constexpr int STAGE_BYTES = Lay<V, LPR>::BATCH * Lay<V, LPR>::DF * 4;
  static constexpr int USED = RING * STRIPE_BYTES + LIST * 4 + 2 * STAGE_BYTES + RING * 8;
  static constexpr int BYTES = (USED + 15) / 16 * 16;  // the next warp's 16-byte aligned
};

// One bit per non-zero byte of w.
__device__ __forceinline__ unsigned nonzero_bytes(uint32_t w) {
  const uint32_t m = __vcmpne4(w, 0u);  // 0xff in each non-zero byte
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) | ((m >> 28) & 8u);
}

// a and b rounded to bf16 (cvt.rn: round to nearest even, as PyTorch's
// .to(bfloat16); a NaN stays a NaN) and back to float
__device__ __forceinline__ void bf16_round2(float a, float b, float& ra, float& rb) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  ra = __uint_as_float(u << 16);
  rb = __uint_as_float(u & 0xffff0000u);
}

// V consecutive values of a staged row of x at p, as float, rounded to bf16.
template <int V>
__device__ __forceinline__ void staged(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    bf16_round2(a.x, a.y, o[0], o[1]);
    bf16_round2(a.z, a.w, o[2], o[3]);
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    bf16_round2(a.x, a.y, o[0], o[1]);
  } else {
    o[0] = __bfloat162float(__float2bfloat16_rn(*p));
  }
}

// The n <= BATCH entries a warp found, in column order, lane e < n holding
// entry e's column ec and bits em: their rows of x (the group's DF
// features) copied into rows 0 .. n - 1 of the stage by cp.async, one
// commit group. The warp copies 32 / CPR rows an instruction, CPR lanes a
// row, so that each instruction reads whole rows. Returns the lane's entry
// bits, 0 for no entry or a column past x's rows (which adds nothing).
template <int DF>
__device__ __forceinline__ int issue(int n, int ec, int em, const float* __restrict__ x,
                                     int x_rows, int d, int f0, float* stage) {
  constexpr int CHUNK = 4;         // floats a copy
  constexpr int CPR = DF / CHUNK;  // copies a row
  constexpr int RPI = 32 / CPR;    // rows an instruction
  const int lane = threadIdx.x & 31;
  const int q = lane % CPR;
  for (int e0 = 0; e0 < n; e0 += RPI) {
    const int e = e0 + lane / CPR;
    const int c = __shfl_sync(FULL, ec, e & 31);
    if (e < n && c < x_rows)
      cp_async16(stage + e * DF + q * CHUNK, x + static_cast<size_t>(c) * d + f0 + q * CHUNK);
  }
  cp_async_commit();
  return lane < n && ec < x_rows ? em : 0;
}

// The staged entries' rows added into the sums: for each of the 8 rows a
// ballot names the entries whose bit is set (lane e holds entry e's bits),
// and the warp adds their rows, rounded to bf16, one set bit at a time in
// entry order. The copies must have landed (cp_async_wait, __syncwarp).
template <int V, int LPR>
__device__ __forceinline__ void add_staged(int bits, const float* stage, int fo, int rb,
                                           float (&acc)[Lay<V, LPR>::NR][V]) {
  using L = Lay<V, LPR>;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    unsigned take = __ballot_sync(FULL, (bits >> k) & 1);
    while (take) {
      const int e = __ffs(take) - 1;
      take &= take - 1;
      if (k % L::RS == rb) {
        float a[V];
        staged<V>(stage + e * L::DF + fo, a);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[k / L::RS][v] += a[v];
      }
    }
  }
  __syncwarp();  // every lane is done with this stage
}

// Warp w takes stripes plan[w] .. plan[w + 1] - 1 (rows of groups stripes
// each) for feature group blockIdx.y. rec: two records of 8 x d sums a warp,
// for its first and its last row group where another warp shares them. Its
// entries go through two stages in turn: one batch's rows are in flight
// while the next batch is found, and are added when that one is issued.
template <int V, int LPR>
__global__ void __launch_bounds__(THREADS, 6)
bit_scan_kernel(const int8_t* __restrict__ packed, const float* __restrict__ x,
                float* __restrict__ y, const int* __restrict__ plan, float* __restrict__ rec,
                int parts, int n_rows, int x_rows, int groups, int c_pad, int d) {
  using L = Lay<V, LPR>;
  constexpr int STAGE = L::BATCH * L::DF;  // elements of a stage: BATCH rows of DF features
  extern __shared__ __align__(16) unsigned char smem[];
  // this warp's ring of RING stripes, its two stages, its RING barriers
  unsigned char* mine_smem = smem + (threadIdx.x >> 5) * WarpSmem<V, LPR>::BYTES;
  unsigned char* ring = mine_smem;
  unsigned* list = reinterpret_cast<unsigned*>(mine_smem + RING * STRIPE_BYTES);
  float* stages = reinterpret_cast<float*>(mine_smem + RING * STRIPE_BYTES + LIST * 4);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(mine_smem + RING * STRIPE_BYTES + LIST * 4 + 2 * STAGE * 4);
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int pieces = c_pad / 16;  // of a packed row
  const int stripes = (pieces + STRIPE - 1) / STRIPE;
  const long long all = static_cast<long long>(groups) * stripes;
  if (w >= parts) return;
  const int s_lo = plan[w];
  const int s_hi = static_cast<int>(plan[w + 1] < all ? plan[w + 1] : all);
  const int fo = (lane % LPR) * V;  // this lane's first feature of the group
  const int rb = lane / LPR;        // this lane's first row; then rb + RS j
  const int f0 = blockIdx.y * L::DF, f = f0 + fo;
  if (s_lo >= s_hi) {  // no stripes: a zero record, which the fixup may add
    float* r = rec + static_cast<size_t>(2 * w) * 8 * d + f;
#pragma unroll
    for (int j = 0; j < L::NR; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) r[static_cast<size_t>(rb + L::RS * j) * d + v] = 0.0f;
    return;
  }

  // stripe s into ring slot (s - s_lo) % RING by the copy engine (lane 0)
  auto fetch = [&](int s) {
    const int gs = s / stripes, off = (s - gs * stripes) * STRIPE_BYTES;
    const int bytes = c_pad - off < STRIPE_BYTES ? c_pad - off : STRIPE_BYTES;
    const int slot = (s - s_lo) % RING;
    bulk_load(ring + slot * STRIPE_BYTES, packed + static_cast<size_t>(gs) * c_pad + off, bytes,
              bar + slot);
  };
  if (lane == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = s_lo; s < s_hi && s < s_lo + RING; ++s) fetch(s);
  }
  __syncwarp();

  float acc[L::NR][V];
#pragma unroll
  for (int j = 0; j < L::NR; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[j][v] = 0.0f;
  // the entries found and not yet issued: list[head % LIST .. tail % LIST),
  // (column << 8) | bits in column order
  int head = 0, tail = 0;
  int cur = 0;       // the stage the next batch goes to
  int pending = -1;  // the bits of the batch in flight in the other stage; -1: none
  // up to BATCH listed entries issued (lane e: entry e); the batch before
  // them added
  auto flush = [&]() {
    const int n = tail - head < L::BATCH ? tail - head : L::BATCH;
    const unsigned ent = lane < n ? list[(head + lane) & (LIST - 1)] : 0u;
    const int bits = issue<L::DF>(n, static_cast<int>(ent >> 8), static_cast<int>(ent & 0xffu), x,
                                  x_rows, d, f0, stages + cur * STAGE);
    head += n;
    if (pending >= 0) {
      cp_async_wait<1>();
      __syncwarp();
      add_staged<V, LPR>(pending, stages + (cur ^ 1) * STAGE, fo, rb, acc);
    }
    pending = bits;
    cur ^= 1;
  };
  // every listed and staged entry added
  auto drain = [&]() {
    while (tail > head) flush();
    if (pending >= 0) {
      cp_async_wait<0>();
      __syncwarp();
      add_staged<V, LPR>(pending, stages + (cur ^ 1) * STAGE, fo, rb, acc);
      pending = -1;
    }
  };
  int g = s_lo / stripes, seg = s_lo;  // the current group, its first stripe here
  // the sums of group g's stripes seg .. b - 1: into y when they are all of
  // the group's, else into the warp's record; then zeroed
  auto finish = [&](int b) {
    drain();
    const bool whole = seg == g * stripes && b == (g + 1) * stripes;
    float* dst = whole ? y + static_cast<size_t>(8) * g * d
                       : rec + static_cast<size_t>(2 * w + (seg == s_lo ? 0 : 1)) * 8 * d;
#pragma unroll
    for (int j = 0; j < L::NR; ++j) {
      const int row = rb + L::RS * j;
      if (!whole || 8 * g + row < n_rows) {
#pragma unroll
        for (int v = 0; v < V; ++v) dst[static_cast<size_t>(row) * d + f + v] = acc[j][v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[j][v] = 0.0f;
    }
  };

  for (int s = s_lo; s < s_hi; ++s) {
    if (s == (g + 1) * stripes) {  // warp-uniform: the next group
      finish(s);
      ++g;
      seg = s;
    }
    const int t = s - s_lo, slot = t % RING;
    mbar_wait(bar + slot, (t / RING) & 1);
    const int p0 = (s - g * stripes) * STRIPE;  // the stripe's first piece
    const uint4 wd = p0 + lane < pieces
                         ? reinterpret_cast<const uint4*>(ring + slot * STRIPE_BYTES)[lane]
                         : make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();  // the slot is read: refill it
    if (lane == 0 && s + RING < s_hi) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(s + RING);
    }
    unsigned todo = __ballot_sync(FULL, (wd.x | wd.y | wd.z | wd.w) != 0u);
    if (todo == 0u) continue;
    // each lane lists its piece's non-zero bytes, the lanes in order
    const unsigned mine = nonzero_bytes(wd.x) | (nonzero_bytes(wd.y) << 4) |
                          (nonzero_bytes(wd.z) << 8) | (nonzero_bytes(wd.w) << 12);
    const int cnt = __popc(mine);
    int upto = cnt;  // this lane's and the lanes' before it
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t_ = __shfl_up_sync(FULL, upto, o);
      if (lane >= o) upto += t_;
    }
    int pos = tail + upto - cnt;
    unsigned bytes = mine;
    const int c0 = 16 * (p0 + lane);
    while (bytes) {
      const int j = __ffs(bytes) - 1;
      bytes &= bytes - 1;
      const uint32_t wj = j < 8 ? (j < 4 ? wd.x : wd.y) : (j < 12 ? wd.z : wd.w);
      const unsigned bits = (wj >> (8 * (j & 3))) & 0xffu;
      list[pos++ & (LIST - 1)] = (static_cast<unsigned>(c0 + j) << 8) | bits;
    }
    tail += __shfl_sync(FULL, upto, 31);
    __syncwarp();
    while (tail - head >= L::BATCH) flush();
  }
  finish(s_hi);
}

// The row groups whose stripes more than one warp took: their records added
// in a fixed order into y. Block (g, y): group g, feature group y. owners: the
// first and the last warp of each group's stripes (bitmm.plan_rows).
template <int DF>
__global__ void __launch_bounds__(FIX_THREADS)
bit_fixup_kernel(float* __restrict__ y, const int* __restrict__ plan,
                 const int* __restrict__ owners, const float* __restrict__ rec, int n_rows,
                 int c_pad, int d) {
  const int g = blockIdx.x;
  const int w_lo = owners[2 * g], w_hi = owners[2 * g + 1];
  if (w_lo == w_hi) return;  // one warp wrote the group
  const int stripes = (c_pad / 16 + STRIPE - 1) / STRIPE;
  for (int i = threadIdx.x; i < 8 * DF; i += FIX_THREADS) {
    const int row = i / DF, col = blockIdx.y * DF + i % DF;
    if (8 * g + row >= n_rows) continue;
    const float* r = rec + static_cast<size_t>(row) * d + col;
    const size_t slot = static_cast<size_t>(8) * d;
    // w_lo shares its last group; the warps after it start in this one (a
    // warp with no stripes wrote a zero record). Eight running sums (warps
    // w_lo + 1 + 8 i + q) keep loads in flight; they are added in a fixed
    // order.
    float part[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int w0 = w_lo + 1; w0 <= w_hi; w0 += 8) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (w0 + q <= w_hi) part[q] += r[2 * (w0 + q) * slot];
    }
    const float first = r[(2 * w_lo + (plan[w_lo] / stripes == g ? 0 : 1)) * slot];
    y[static_cast<size_t>(8 * g + row) * d + col] =
        first + (((part[0] + part[1]) + (part[2] + part[3])) +
                 ((part[4] + part[5]) + (part[6] + part[7])));
  }
}

template <int V, int LPR>
cudaError_t launch(const int8_t* packed, const float* x, float* y, const int* plan, float* rec,
                   int parts, int n_rows, int x_rows, int groups, int c_pad, int d,
                   cudaStream_t s) {
  constexpr int DF = Lay<V, LPR>::DF;
  constexpr int smem = WARPS * WarpSmem<V, LPR>::BYTES;
  const int used = (n_rows + 7) / 8;
  if (used == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(bit_scan_kernel<V, LPR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bit_scan_kernel<V, LPR><<<dim3((parts + WARPS - 1) / WARPS, d / DF), THREADS, smem, s>>>(
      packed, x, y, plan, rec, parts, n_rows, x_rows, groups, c_pad, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bit_fixup_kernel<DF><<<dim3(used, d / DF), FIX_THREADS, 0, s>>>(y, plan, plan + parts + 1,
                                                                  rec, n_rows, c_pad, d);
  return cudaGetLastError();
}

cudaError_t launch_width(const int8_t* packed, const float* x, float* y, const int* plan,
                         float* rec, int parts, int n_rows, int x_rows, int groups, int c_pad,
                         int d, cudaStream_t s) {
  if (d % 128 == 0)
    return launch<4, 32>(packed, x, y, plan, rec, parts, n_rows, x_rows, groups, c_pad, d, s);
  if (d % 64 == 0)
    return launch<2, 32>(packed, x, y, plan, rec, parts, n_rows, x_rows, groups, c_pad, d, s);
  if (d % 32 == 0)
    return launch<1, 32>(packed, x, y, plan, rec, parts, n_rows, x_rows, groups, c_pad, d, s);
  if (d % 16 == 0)
    return launch<1, 16>(packed, x, y, plan, rec, parts, n_rows, x_rows, groups, c_pad, d, s);
  return launch<1, 8>(packed, x, y, plan, rec, parts, n_rows, x_rows, groups, c_pad, d, s);
}

}  // namespace

extern "C" {

// packed int8 [groups, c_pad] (groups = r_pad / 8); x float32 [x_rows, d],
// 1 <= x_rows <= c_pad; plan int32 [parts + 1 + 2 * groups]
// (bitmm.plan_rows: the warps' first stripes, then each group's first and
// last warp); rec float32 scratch of 2 * parts * 8 * d, no zeroing needed;
// y float32 [n_rows, d], n_rows <= 8 * groups, receives every element. The
// wrapper checks c_pad % 128 == 0, c_pad <= 2^24 (a listed entry keeps its
// column in 24 bits), d % 8 == 0, and that the tensors are contiguous and
// 16-byte aligned. Two launches (the scan, the shared groups' sums), no
// synchronisation. Returns cudaGetLastError().
int bit_matmul(const void* packed, const void* x, void* y, const void* plan, void* rec,
               int parts, int n_rows, int x_rows, int groups, int c_pad, int d, void* stream) {
  if (parts <= 0 || d <= 0 || d % 8 != 0 || c_pad % 16 != 0 || c_pad > (1 << 24) || n_rows < 0 ||
      n_rows > 8 * groups || x_rows < 1 || x_rows > c_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_width(
      static_cast<const int8_t*>(packed), static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const int*>(plan), static_cast<float*>(rec), parts, n_rows, x_rows, groups, c_pad,
      d, static_cast<cudaStream_t>(stream)));
}

const char* bit_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
