// K12 gather_rows_matmul and K13 gather_rows_matmul_t: the batch-row partial
// product of the dense adjacency and its backward, over the 2-D int8 count
// matrix M [R, C] (C % 128 == 0) and a batch of row ids (repeats allowed).
//
//   K12: out[b, f] = sum_c M[rows[b], c] * z[c, f]        out float32 [B, d]
//   K13: dz[c, f]  = sum_b M[rows[b], c] * g[b, f]        dz float32 [C, d]
//
// z and g are bfloat16 or float32; the sums are float32. The bfloat16 route
// multiplies on the tensor cores (mma.sync m16n8k16; a count of int8 is
// exact in bf16, so every product is exact); the float32 route uses fmaf on
// the CUDA cores, never TF32.
//
// Replaces idgrec_tpu/ops/gathermm.py _make_kernel (l.58), launched by
// _fwd_call (l.109) and _bwd_call (l.144). The TPU needed one DMA descriptor
// per row and a 3-D [R, C / 1024, 1024] copy of M, because Mosaic cannot
// slice single rows of a tiled 2-D array; here a row of M is one contiguous
// run of C bytes and M stays 2-D.
//
// Bound on the H100: bytes. Each direction reads the batch's rows of M (208
// MB a LightGCN step at yelp2018 scale: 2,048 user rows of 38,144 bytes,
// 4,096 item rows of 31,744) against 2 * B * C * d operations, 128 per byte
// at d = 64, under the card's ~295 for bf16 (the float32 route's dense count
// is bound by its 67 TFLOP/s). The user rows hold 0.1 % non-zero counts, the
// item rows 2.1 % (positives are drawn by interaction, so popular items; the
// largest is two thirds non-zero).
//
// Design. The features are the mma's m (four m16 tiles of 64), the batch
// rows (K12) or M's columns (K13) its n, so a warp's z or g fragments, read
// once by ldmatrix, serve 32 rows or columns. Counts in [0, 127] turn into
// bf16 in two instructions a pair (a byte under the bf16 exponent of 128,
// less 128), others through an exact float; one warp reduction a half stage
// tells which. The float32 routes give a lane one row (K12) or column (K13)
// and all 64 features, and add z's (g's) row, broadcast from shared memory,
// where a warp vote finds a count.
// * K12, bf16: a block owns 256 batch rows (8 consumer warps, 32 rows each),
//   64 features and one of S column shares. Four producer warps copy each
//   stage (the rows' 128-byte runs of M, z's 128 rows in the mma's k order:
//   one 32-bit load of M gives four columns, which the mma takes as k = 2t,
//   2t + 1, 2t + 8, 2t + 9) by cp.async onto the stage's `full` mbarrier;
//   the consumers multiply every tile and release the stage on its `empty`
//   mbarrier. No block barrier, so the ring stays as full as the consumers
//   allow (one block an SM). K12, float32: the same block of rows, a ring of
//   64-column stages that all threads fill, a block barrier a stage. S
//   (ops/gathermm.py plan_rows_matmul) fills one wave of the blocks an SM
//   holds; each share writes its float32 partial [S, B, d] and a second
//   launch adds the S partials in share order (none when S == 1). A row id
//   outside [0, R) reads nothing and its output row is NaN (the wrapper does
//   not read a flag back); a column at or past z's rows adds nothing, as a
//   zero-padded z would.
// * K13: a block owns 256 columns (32 a warp), 64 features and one of S
//   batch shares, walking its rows in order, KB a stage: their 256-byte runs
//   of M and g's rows by cp.async, STAGES deep, the row ids read a stage
//   ahead of their copies. A warp vote skips the n8 tiles of zeros. B
//   fragments: four 32-bit loads of rows 2t, 2t+1, 2t+8, 2t+9 give one byte
//   pair for each of four n8 tiles (the tiles' columns interleaved by four).
//   The S shares of a tile form a thread-block cluster: each block parks its
//   sums in shared memory and, once the cluster has run, each rank adds its
//   slice of the columns over the ranks in rank order through distributed
//   shared memory and writes dz. A row id outside [0, R) adds nothing.
// No atomics; the split and every order depend on the shapes and the card
// alone, so two launches give the same bits.
//
// Measured (PERF.md, PR 13; an H100, both sides of a step): the tile kernel
// this replaced multiplied every zero and left a second wave nearly empty
// (0.30 ms bf16 for K12, 0.31 for K13); this design takes about 0.13 and
// 0.18. K12's stream, fed by producer warps, moves its bytes in 0.10 ms
// (plain 16-byte loads of the same rows: 0.075), and its products, every
// tile multiplied, take about as long: skipping zero tiles cost the
// consumers more in branches than it saved. K13's stages still wait as a
// block: with nothing multiplied it moves its bytes in 0.13 ms.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;  // K12's consumers or float32 block; K13's block is CT threads
constexpr int FG = 64;  // features of a block
// K12's float32 route: columns a stage, M's pitch in shared memory
constexpr int KC = 64;
constexpr int M12_PITCH = KC + 16;
// K13: columns of a block, batch rows a stage, M's pitch in shared memory
constexpr int CT = 256;
constexpr int KB = 32;
constexpr int M13_PITCH = CT + 16;

__device__ __forceinline__ bool in_range(long long row, int n_rows) {
  return row >= 0 && row < n_rows;
}

// Signed byte i of w as an exact float: 2^23 + (byte ^ 0x80), less 2^23 + 128.
__device__ __forceinline__ float byte_float(uint32_t flipped, int sel) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, sel)) - 8388736.0f;
}

// Two exact floats of small integers as a bf16 pair (a in the low half):
// their upper halves, no rounding.
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// Bytes i and j of w (signed) as a bf16 pair, byte i in the low half.
__device__ __forceinline__ uint32_t bytes_bf16(uint32_t flipped, int i, int j) {
  return bf16_pair(byte_float(flipped, 0x7440 + i), byte_float(flipped, 0x7440 + j));
}

// Byte i of u (low half) and of v (high half), both signed, as a bf16 pair.
__device__ __forceinline__ uint32_t column_bf16(uint32_t u, uint32_t v, int i) {
  return bf16_pair(byte_float(u, 0x7440 + i), byte_float(v, 0x7440 + i));
}

// The same for counts in [0, 127], two instructions a pair: bytes sel of x
// (two non-negative bytes, selector 0x5140 for bytes 0, 1 or 0x5342 for 2, 3)
// under the bf16 exponent of 128 give 128 + count, exact in 7 mantissa bits;
// less 128, exact.
__device__ __forceinline__ uint32_t small_bf16(uint32_t x, int sel) {
  uint32_t v = __byte_perm(x, 0x43434343u, sel);
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             __floats2bfloat162_rn(128.0f, 128.0f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The staged row of z for column p of a 16-column group: a lane's 32-bit
// load of M holds columns 4t .. 4t + 3, which the mma takes as k = 2t, 2t + 1
// (b0) and 2t + 8, 2t + 9 (b1).
__device__ __forceinline__ int k_of_column(int p) {
  return (p & ~15) + 2 * ((p & 15) >> 2) + (p & 1) + 8 * ((p >> 1) & 1);
}

// Stages a [n, FG] slice (features f0 .. f0 + dg) of a row-major [*, d]
// matrix v from row `first` (rows at or past `limit` zero) at dst, pitch
// bytes a row, ESZ bytes an element; row r lands at k_of_column(r) when
// PERMUTE (z for K12's bf16 route), else at r.
template <int ESZ, bool PERMUTE, int NTHREADS, int FIRST = 0>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int pitch, const void* v, int first,
                                           int n, int limit, int d, int f0, int dg) {
  constexpr int PIECES = FG * ESZ / 16;
  const unsigned char* src = static_cast<const unsigned char*>(v);
  for (int p = threadIdx.x - FIRST; p < n * PIECES; p += NTHREADS) {
    const int r = p / PIECES, q = p % PIECES;
    const bool ok = first + r < limit && 16 * q < dg * ESZ;
    cp_async16_zfill(dst + (PERMUTE ? k_of_column(r) : r) * pitch + 16 * q,
                     src + (static_cast<size_t>(ok ? first + r : 0) * d + f0) * ESZ + 16 * q, ok);
  }
}

// ---- K12 -------------------------------------------------------------------

// The bf16 route. Block: 8 consumer warps (32 batch rows each, 256 a block)
// and WS_PRODUCERS producer warps. The producers copy each stage (the rows'
// 128-byte runs of M and z's 128 rows in the mma's k order, by cp.async
// onto the stage's `full` mbarrier); the consumers multiply it and release
// it on its `empty` mbarrier. No block barrier: the ring stays as full as
// the consumers allow, one block an SM.
constexpr int WS_PRODUCERS = 4;
constexpr int WS_KC = 128;     // columns a stage
constexpr int WS_STAGES = 4;
constexpr int WS_THREADS = THREADS + 32 * WS_PRODUCERS;
struct Ws {
  static constexpr int RB = THREADS;   // batch rows a block
  static constexpr int M_PITCH = WS_KC + 16;
  static constexpr int Z_PITCH = (FG + 8) * 2;
  static constexpr int M_BYTES = RB * M_PITCH;
  static constexpr int STAGE_BYTES = M_BYTES + WS_KC * Z_PITCH;
  static constexpr int SMEM_BYTES = WS_STAGES * STAGE_BYTES;
};

// Loads rows[b0 ..] into srow: -1 for a row past the batch or out of range,
// which reads nothing.
__device__ __forceinline__ void block_rows(long long* srow, int n, const long long* rows, int b0,
                                           int batch, int n_rows, int nthreads) {
  for (int r = threadIdx.x; r < n; r += nthreads) {
    const long long id = b0 + r < batch ? rows[b0 + r] : -1;
    srow[r] = in_range(id, n_rows) ? id : -1;
  }
}

// The block's share of M's columns, in stages of kc: the first and the count.
__device__ __forceinline__ void column_share(int c, int kc, int& begin, int& count) {
  const int chunks = c / kc;
  begin = static_cast<int>(static_cast<long long>(blockIdx.y) * chunks / gridDim.y);
  count = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * chunks / gridDim.y) - begin;
}

// Grid: (row blocks, shares, feature groups). part: [shares, batch, d].
__global__ void __launch_bounds__(WS_THREADS, 1)
gather_fwd_bf16(const int8_t* __restrict__ m, const long long* __restrict__ rows,
                const __nv_bfloat16* __restrict__ z, float* __restrict__ part, int n_rows, int c,
                int z_rows, int batch, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long srow[Ws::RB];
  __shared__ __align__(8) uint64_t full[WS_STAGES], empty[WS_STAGES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * Ws::RB;
  const int f0 = blockIdx.z * FG;
  const int dg = min(FG, d - f0);
  int c_begin, n_chunks;
  column_share(c, WS_KC, c_begin, n_chunks);
  block_rows(srow, Ws::RB, rows, b0, batch, n_rows, WS_THREADS);
  if (tid == 0) {
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(full + s, 32 * WS_PRODUCERS);
      mbar_init(empty + s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= THREADS / 32) {  // a producer
    for (int i = 0; i < n_chunks; ++i) {
      const int slot = i % WS_STAGES;
      if (i >= WS_STAGES) mbar_wait(empty + slot, ((i / WS_STAGES) - 1) & 1);
      unsigned char* ms = smem + slot * Ws::STAGE_BYTES;
      const int col0 = (c_begin + i) * WS_KC;
      for (int p = tid - THREADS; p < Ws::RB * WS_KC / 16; p += 32 * WS_PRODUCERS) {
        const int r = p / (WS_KC / 16), q = p % (WS_KC / 16);
        const long long id = srow[r];
        cp_async16_zfill(ms + r * Ws::M_PITCH + 16 * q, m + (id < 0 ? 0 : id * c) + col0 + 16 * q,
                         id >= 0);
      }
      stage_rows<2, true, 32 * WS_PRODUCERS, THREADS>(ms + Ws::M_BYTES, Ws::Z_PITCH, z, col0,
                                                      WS_KC, z_rows, d, f0, dg);
      mbar_arrive_copies(full + slot);
    }
    return;
  }

  // B: n8 tile j is rows 32 warp + 8 j + g, this lane's columns 16 ks + 4t ..
  const int g = lane >> 2, t = lane & 3, q8 = lane >> 3;
  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int i = 0; i < n_chunks; ++i) {
    const int slot = i % WS_STAGES;
    mbar_wait(full + slot, (i / WS_STAGES) & 1);
    const unsigned char* ms = smem + slot * Ws::STAGE_BYTES;
    const unsigned char* zs = ms + Ws::M_BYTES;
    // every tile multiplied (skipping the zero ones cost more than it saved,
    // PERF.md); a half stage's words first, to tell whether a count is negative
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      constexpr int KS = WS_KC / 32;  // k16 steps a half stage
      uint32_t w[KS][4];
      unsigned sign = 0;
#pragma unroll
      for (int k = 0; k < KS; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[k][j] = *reinterpret_cast<const uint32_t*>(
              ms + (32 * warp + 8 * j + g) * Ws::M_PITCH + 16 * (KS * half + k) + 4 * t);
          sign |= w[k][j];
        }
      const bool negative = __reduce_or_sync(FULL, sign & 0x80808080u) != 0u;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int ks = KS * half + k;
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4_trans(a[mt], reinterpret_cast<const uint16_t*>(
                                       zs + (16 * ks + (lane & 7) + 8 * (q8 >> 1)) * Ws::Z_PITCH) +
                                       16 * mt + 8 * (q8 & 1));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t lo, hi;
          if (negative) {
            const uint32_t u = w[k][j] ^ 0x80808080u;
            lo = bytes_bf16(u, 0, 1);
            hi = bytes_bf16(u, 2, 3);
          } else {
            lo = small_bf16(w[k][j], 0x5140);
            hi = small_bf16(w[k][j], 0x5342);
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            mma_bf16(acc[mt][j], a[mt][0], a[mt][1], a[mt][2], a[mt][3], lo, hi);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
  }

  // acc[mt][j]: features 16 mt + g (+ 8), rows 32 warp + 8 j + 2t (+ 1)
  float* out = part + static_cast<size_t>(blockIdx.y) * batch * d;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 32 * warp + 8 * j + 2 * t + e;
      if (b0 + r >= batch) continue;
      float* o = out + static_cast<size_t>(b0 + r) * d + f0;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 16 * mt + g + 8 * h;
          if (f < dg) o[f] = srow[r] >= 0 ? acc[mt][j][2 * h + e] : nanf("");
        }
    }
}

// The float32 route: a lane owns batch row 32 warp + lane (256 a block) and
// all 64 features; the rows' runs of M (64 bytes a row a stage) and z's rows
// land by cp.async, STAGES deep, all threads copying and a block barrier a
// stage.
struct Fwd32 {
  static constexpr int STAGES = 3;
  static constexpr int RB = THREADS;
  static constexpr int Z_PITCH = FG * 4;  // bytes
  static constexpr int M_BYTES = RB * M12_PITCH;
  static constexpr int STAGE_BYTES = M_BYTES + KC * Z_PITCH;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

__global__ void __launch_bounds__(THREADS)
gather_fwd_f32(const int8_t* __restrict__ m, const long long* __restrict__ rows,
               const float* __restrict__ z, float* __restrict__ part, int n_rows, int c,
               int z_rows, int batch, int d) {
  using G = Fwd32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long srow[G::RB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * G::RB;
  const int f0 = blockIdx.z * FG;
  const int dg = min(FG, d - f0);
  int c_begin, n_chunks;
  column_share(c, KC, c_begin, n_chunks);
  block_rows(srow, G::RB, rows, b0, batch, n_rows, THREADS);
  __syncthreads();

  auto load = [&](int stage, int chunk) {
    unsigned char* ms = smem + stage * G::STAGE_BYTES;
    const int col0 = chunk * KC;
    for (int p = tid; p < G::RB * KC / 16; p += THREADS) {
      const int r = p / (KC / 16), q = p % (KC / 16);
      const long long id = srow[r];
      cp_async16_zfill(ms + r * M12_PITCH + 16 * q, m + (id < 0 ? 0 : id * c) + col0 + 16 * q,
                       id >= 0);
    }
    stage_rows<4, false, THREADS>(ms + G::M_BYTES, G::Z_PITCH, z, col0, KC, z_rows, d, f0, dg);
  };

  float acc[4][4][4];  // [f / 16][f / 4 % 4][f % 4]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < n_chunks) load(s, c_begin + s);
    cp_async_commit();
  }
  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();
    if (it + G::STAGES - 1 < n_chunks)
      load((it + G::STAGES - 1) % G::STAGES, c_begin + it + G::STAGES - 1);
    cp_async_commit();
    const unsigned char* ms = smem + (it % G::STAGES) * G::STAGE_BYTES;
    const unsigned char* zs = ms + G::M_BYTES;
    const unsigned char* mrow = ms + (32 * warp + lane) * M12_PITCH;
#pragma unroll
    for (int kq = 0; kq < KC / 16; ++kq) {
      const uint4 piece = *reinterpret_cast<const uint4*>(mrow + 16 * kq);
      const uint32_t words[4] = {piece.x, piece.y, piece.z, piece.w};
      if (!__any_sync(FULL, (piece.x | piece.y | piece.z | piece.w) != 0u)) continue;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int8_t cnt = static_cast<int8_t>(words[k >> 2] >> (8 * (k & 3)));
        if (!__any_sync(FULL, cnt != 0)) continue;
        const float v = static_cast<float>(cnt);
        const float4* zr = reinterpret_cast<const float4*>(zs + (16 * kq + k) * G::Z_PITCH);
#pragma unroll
        for (int f4 = 0; f4 < 16; ++f4) {
          const float4 zv = zr[f4];
          float* a = acc[f4 >> 2][f4 & 3];
          if (cnt != 0) {
            a[0] = fmaf(v, zv.x, a[0]);
            a[1] = fmaf(v, zv.y, a[1]);
            a[2] = fmaf(v, zv.z, a[2]);
            a[3] = fmaf(v, zv.w, a[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const int r = 32 * warp + lane;
  if (b0 + r >= batch) return;
  const float nan = nanf("");
  float4* o = reinterpret_cast<float4*>(part + (static_cast<size_t>(blockIdx.y) * batch + b0 + r) *
                                                   d + f0);
#pragma unroll
  for (int f4 = 0; f4 < 16; ++f4)
    if (4 * f4 < dg) {
      const float* a = acc[f4 >> 2][f4 & 3];
      o[f4] = srow[r] >= 0 ? make_float4(a[0], a[1], a[2], a[3]) : make_float4(nan, nan, nan, nan);
    }
}

// out[i] = the S partials' sum in share order (a NaN row stays NaN).
__global__ void sum_shares(const float* __restrict__ part, float* __restrict__ out, int shares,
                           long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < shares; ++k) s = __fadd_rn(s, part[k * n + i]);
  out[i] = s;
}

// ---- K13 -------------------------------------------------------------------

template <bool BF16>
struct Bwd {
  static constexpr int ESZ = BF16 ? 2 : 4;
  static constexpr int STAGES = BF16 ? 6 : 4;
  static constexpr int G_PITCH = BF16 ? (FG + 8) * 2 : FG * 4;  // bytes
  static constexpr int M_BYTES = KB * M13_PITCH;
  static constexpr int STAGE_BYTES = M_BYTES + KB * G_PITCH;
  static constexpr int ACC_BYTES = CT * FG * 4;  // the sums parked at the end
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int SMEM_BYTES = RING_BYTES > ACC_BYTES ? RING_BYTES : ACC_BYTES;
};

// Grid: (column tiles * shares, 1, feature groups); the `shares` blocks of
// a tile are one cluster, rank s taking batch rows [s B / S, (s + 1) B / S).
template <bool BF16>
__global__ void __launch_bounds__(CT)
gather_bwd_kernel(const int8_t* __restrict__ m, const long long* __restrict__ rows,
                  const void* __restrict__ gv, float* __restrict__ dz, int n_rows, int c,
                  int batch, int d, int shares) {
  using G = Bwd<BF16>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int share = blockIdx.x % shares;
  const int col0 = blockIdx.x / shares * CT;
  const int f0 = blockIdx.z * FG;
  const int dg = min(FG, d - f0);
  const int b_begin = static_cast<int>(static_cast<long long>(share) * batch / shares);
  const int b_end = static_cast<int>(static_cast<long long>(share + 1) * batch / shares);
  const int chunks = (b_end - b_begin + KB - 1) / KB;

  // this thread's pieces of M in a stage: rows tid / 16 + 16 j, piece tid % 16;
  // their row ids are read a stage ahead, so no copy waits on them
  constexpr int MP = KB * (CT / 16) / CT;
  long long ids[MP];
  auto read_ids = [&](int chunk) {
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      const int b = b_begin + chunk * KB + tid / (CT / 16) + j * 16;
      ids[j] = chunk < chunks && b < b_end ? rows[b] : -1;
    }
  };
  auto load = [&](int stage, int chunk) {
    unsigned char* ms = smem + stage * G::STAGE_BYTES;
    const int q = tid % (CT / 16), col = col0 + 16 * q;
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      const int r = tid / (CT / 16) + j * 16;
      const bool ok = in_range(ids[j], n_rows) && col < c;
      cp_async16_zfill(ms + r * M13_PITCH + 16 * q, m + (ok ? ids[j] * c + col : 0), ok);
    }
    stage_rows<G::ESZ, false, CT>(ms + G::M_BYTES, G::G_PITCH, gv, b_begin + chunk * KB, KB,
                                  b_end, d, f0, dg);
  };

  const int g = lane >> 2, t = lane & 3;
  float acc[4][4][4];  // bf16: [m16 tile][n8 tile][fragment]; float32: [f / 16][f / 4 % 4][f % 4]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    read_ids(s);
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  read_ids(G::STAGES - 1);
  for (int it = 0; it < chunks; ++it) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();
    if (it + G::STAGES - 1 < chunks) load((it + G::STAGES - 1) % G::STAGES, it + G::STAGES - 1);
    cp_async_commit();
    read_ids(it + G::STAGES);
    const unsigned char* ms = smem + (it % G::STAGES) * G::STAGE_BYTES;
    const unsigned char* gs = ms + G::M_BYTES;
    if constexpr (BF16) {
      // B: rows 16 ks + 2t, + 1, + 8, + 9 at the warp's columns 4g .. 4g + 3;
      // byte i of each belongs to n8 tile i (column 32 warp + 4 n + i). All
      // the stage's words first, then one warp reduction as in K12.
      uint32_t w[KB / 16][4];
      unsigned live = 0, sign = 0;
#pragma unroll
      for (int ks = 0; ks < KB / 16; ++ks) {
        const unsigned char* p = ms + (16 * ks + 2 * t) * M13_PITCH + 32 * warp + 4 * g;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[ks][e] = *reinterpret_cast<const uint32_t*>(p + (e & 1) * M13_PITCH +
                                                        (e >> 1) * 8 * M13_PITCH);
        const uint32_t any = w[ks][0] | w[ks][1] | w[ks][2] | w[ks][3];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          live |= static_cast<unsigned>(((any >> (8 * i)) & 0xffu) != 0u) << (4 * ks + i);
        sign |= any;
      }
      live = __reduce_or_sync(FULL, live);
      const bool negative = __reduce_or_sync(FULL, sign & 0x80808080u) != 0u;
#pragma unroll
      for (int ks = 0; ks < KB / 16; ++ks) {
        if (!((live >> (4 * ks)) & 0xfu)) continue;
        uint32_t a[4][4];
        const int q = lane >> 3;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4_trans(a[mt], reinterpret_cast<const uint16_t*>(
                                       gs + (16 * ks + (lane & 7) + 8 * (q >> 1)) * G::G_PITCH) +
                                       16 * mt + 8 * (q & 1));
        // byte i of rows (2t, 2t + 1): x01 holds tiles 0, 1, x23 tiles 2, 3
        const uint32_t lo01 = __byte_perm(w[ks][0], w[ks][1], 0x5140);
        const uint32_t lo23 = __byte_perm(w[ks][0], w[ks][1], 0x7362);
        const uint32_t hi01 = __byte_perm(w[ks][2], w[ks][3], 0x5140);
        const uint32_t hi23 = __byte_perm(w[ks][2], w[ks][3], 0x7362);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!((live >> (4 * ks + i)) & 1u)) continue;
          uint32_t lo, hi;
          if (negative) {
            lo = column_bf16(w[ks][0] ^ 0x80808080u, w[ks][1] ^ 0x80808080u, i);
            hi = column_bf16(w[ks][2] ^ 0x80808080u, w[ks][3] ^ 0x80808080u, i);
          } else {
            const int sel = i & 1 ? 0x5342 : 0x5140;
            lo = small_bf16(i < 2 ? lo01 : lo23, sel);
            hi = small_bf16(i < 2 ? hi01 : hi23, sel);
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            mma_bf16(acc[mt][i], a[mt][0], a[mt][1], a[mt][2], a[mt][3], lo, hi);
        }
      }
    } else {
      // a lane owns column 32 warp + lane
      const unsigned char* mcol = ms + 32 * warp + lane;
#pragma unroll 4
      for (int k = 0; k < KB; ++k) {
        const int8_t cnt = static_cast<int8_t>(mcol[k * M13_PITCH]);
        if (!__any_sync(FULL, cnt != 0)) continue;
        const float v = static_cast<float>(cnt);
        const float4* gr = reinterpret_cast<const float4*>(gs + k * G::G_PITCH);
#pragma unroll
        for (int f4 = 0; f4 < 16; ++f4) {
          const float4 gq = gr[f4];
          float* a = acc[f4 >> 2][f4 & 3];
          if (cnt != 0) {
            a[0] = fmaf(v, gq.x, a[0]);
            a[1] = fmaf(v, gq.y, a[1]);
            a[2] = fmaf(v, gq.z, a[2]);
            a[3] = fmaf(v, gq.w, a[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the sums go there, [column][feature]

  float* sacc = reinterpret_cast<float*>(smem);
  if constexpr (BF16) {
    // acc[mt][i]: features 16 mt + g (+ 8), columns 32 warp + 4 (2t + e) + i
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sacc[(32 * warp + 4 * (2 * t + e) + i) * FG + 16 * mt + g + 8 * h] =
                acc[mt][i][2 * h + e];
  } else {
    float4* row = reinterpret_cast<float4*>(sacc + (32 * warp + lane) * FG);
#pragma unroll
    for (int f4 = 0; f4 < 16; ++f4) {
      const float* a = acc[f4 >> 2][f4 & 3];
      row[f4] = make_float4(a[0], a[1], a[2], a[3]);
    }
  }

  // every rank's sums parked; rank `share` writes its slice of the columns,
  // the ranks' sums added in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float4* sums[8];  // the ranks' parked sums
#pragma unroll
  for (int k = 0; k < 8; ++k)
    sums[k] = reinterpret_cast<const float4*>(cluster.map_shared_rank(sacc, k < shares ? k : 0));
  const int cols = CT / shares;
#pragma unroll 4
  for (int i = tid; i < cols * (FG / 4); i += CT) {
    const int col = share * cols + i / (FG / 4), f4 = i % (FG / 4);
    if (4 * f4 >= dg || col0 + col >= c) continue;
    const int at = col * (FG / 4) + f4;
    float4 s = sums[0][at];
#pragma unroll
    for (int k = 1; k < 8; ++k)
      if (k < shares) {
        const float4 o = sums[k][at];
        s = make_float4(s.x + o.x, s.y + o.y, s.z + o.z, s.w + o.w);
      }
    *reinterpret_cast<float4*>(dz + static_cast<size_t>(col0 + col) * d + f0 + 4 * f4) = s;
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// ---- launchers ---------------------------------------------------------------

// The kernels' dynamic shared memory, set once for each device.
template <bool BF16>
cudaError_t set_smem() {
  static unsigned long long done = 0;  // a bit for each device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || ((done >> dev) & 1ull)) return err;
  err = BF16 ? cudaFuncSetAttribute(gather_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    Ws::SMEM_BYTES)
             : cudaFuncSetAttribute(gather_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    Fwd32::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gather_bwd_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Bwd<BF16>::SMEM_BYTES);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

template <bool BF16>
cudaError_t launch_fwd(const int8_t* m, const long long* rows, const void* z, float* part,
                       float* out, int n_rows, int c, int z_rows, int batch, int d, int shares,
                       cudaStream_t s) {
  cudaError_t err = set_smem<BF16>();
  if (err != cudaSuccess) return err;
  dim3 grid((batch + THREADS - 1) / THREADS, shares, (d + FG - 1) / FG);  // 256 rows a block
  float* dst = shares == 1 ? out : part;
  if constexpr (BF16)
    gather_fwd_bf16<<<grid, WS_THREADS, Ws::SMEM_BYTES, s>>>(
        m, rows, static_cast<const __nv_bfloat16*>(z), dst, n_rows, c, z_rows, batch, d);
  else
    gather_fwd_f32<<<grid, THREADS, Fwd32::SMEM_BYTES, s>>>(
        m, rows, static_cast<const float*>(z), dst, n_rows, c, z_rows, batch, d);
  if ((err = cudaGetLastError()) != cudaSuccess || shares == 1) return err;
  const long long n = static_cast<long long>(batch) * d;
  sum_shares<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(part, out, shares, n);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_bwd(const int8_t* m, const long long* rows, const void* g, float* dz,
                       int n_rows, int c, int batch, int d, int shares, cudaStream_t s) {
  cudaError_t err = set_smem<BF16>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c + CT - 1) / CT * shares, 1, (d + FG - 1) / FG);
  cfg.blockDim = dim3(CT);
  cfg.dynamicSmemBytes = Bwd<BF16>::SMEM_BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = shares;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gather_bwd_kernel<BF16>, m, rows, g, dz, n_rows, c, batch, d,
                           shares);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t occupancy(int backward, int* blocks) {
  cudaError_t err = set_smem<BF16>();
  if (err != cudaSuccess) return err;
  if (backward)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gather_bwd_kernel<BF16>, CT,
                                                         Bwd<BF16>::SMEM_BYTES);
  return BF16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gather_fwd_bf16, WS_THREADS,
                                                              Ws::SMEM_BYTES)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gather_fwd_f32, THREADS,
                                                              Fwd32::SMEM_BYTES);
}

}  // namespace

extern "C" {

// m int8 [n_rows, c]; rows int64 [batch]; z [z_rows, d] (z_rows <= c; the
// columns past it add nothing), bf16 when bf16 != 0 else float32; part
// float32 [shares, batch, d] scratch (unused when shares == 1); out float32
// [batch, d]. The wrapper checks c % 128 == 0, d % 8 == 0, 1 <= shares <=
// c / 64, batch >= 1, contiguity and 16-byte alignment. Returns
// cudaGetLastError().
int gather_rows_matmul(const void* m, const void* rows, const void* z, void* part, void* out,
                       int n_rows, int c, int z_rows, int batch, int d, int shares, int bf16,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* mp = static_cast<const int8_t*>(m);
  const long long* rp = static_cast<const long long*>(rows);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(out);
  cudaError_t err =
      bf16 ? launch_fwd<true>(mp, rp, z, pp, op, n_rows, c, z_rows, batch, d, shares, s)
           : launch_fwd<false>(mp, rp, z, pp, op, n_rows, c, z_rows, batch, d, shares, s);
  return static_cast<int>(err);
}

// m int8 [n_rows, c]; rows int64 [batch]; g [batch, d], bf16 when bf16 != 0
// else float32; dz float32 [c, d] receives every element. shares: 1, 2, 4
// or 8 batch shares (a cluster). The wrapper checks c % 128 == 0, d % 8 ==
// 0, batch >= 1, contiguity and 16-byte alignment. Returns
// cudaGetLastError().
int gather_rows_matmul_t(const void* m, const void* rows, const void* g, void* dz, int n_rows,
                         int c, int batch, int d, int shares, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* mp = static_cast<const int8_t*>(m);
  const long long* rp = static_cast<const long long*>(rows);
  float* dp = static_cast<float*>(dz);
  cudaError_t err = bf16 ? launch_bwd<true>(mp, rp, g, dp, n_rows, c, batch, d, shares, s)
                         : launch_bwd<false>(mp, rp, g, dp, n_rows, c, batch, d, shares, s);
  return static_cast<int>(err);
}

// The blocks of K12 (backward == 0) or K13 an SM holds at once, bf16 or
// float32, into *blocks. Returns the CUDA error code.
int gather_rows_blocks_per_sm(int backward, int bf16, int* blocks) {
  return static_cast<int>(bf16 ? occupancy<true>(backward, blocks)
                               : occupancy<false>(backward, blocks));
}

const char* gather_rows_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* gather_rows_matmul_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
