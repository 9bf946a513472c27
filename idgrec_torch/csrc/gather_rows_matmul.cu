// K12 gather_rows_matmul and K13 gather_rows_matmul_t: the batch-row partial
// product of the dense adjacency and its backward, over the 2-D int8 count
// matrix M [R, C] (C % 128 == 0) and a batch of row ids (repeats allowed).
//
//   K12: out[b, f] = sum_c M[rows[b], c] * z[c, f]        out float32 [B, d]
//   K13: dz[c, f]  = sum_b M[rows[b], c] * g[b, f]        dz float32 [C, d]
//
// z and g are bfloat16 or float32; the sums are float32. The bfloat16 route
// multiplies on the tensor cores (mma.sync m16n8k16, counts <= 127 are exact
// in bf16, so every product is exact); the float32 route uses fmaf on the
// CUDA cores, never TF32.
//
// Replaces idgrec_tpu/ops/gathermm.py _make_kernel (l.58), launched by
// _fwd_call (l.109) and _bwd_call (l.144). The TPU needed one DMA descriptor
// per row and a 3-D [R, C / 1024, 1024] copy of M, because Mosaic cannot
// slice single rows of a tiled 2-D array; here a row of M is one contiguous
// run of C bytes, read with 16-byte coalesced loads, and M stays 2-D.
//
// Bound on the H100: bytes. Each direction reads B rows of M (B * C bytes)
// against 2 * B * C * d operations: 128 per byte at d = 64, under the
// card's ~295 for bf16 (the float32 route is bound by its 67 TFLOP/s).
//
// Design:
// * K12: block (x, y, z) owns 64 batch rows, the y-th of S column shares and
//   feature group z (DF = 64 features when d % 64 == 0, else 32, 16 or 8).
//   The 64 rows of M and z's rows of one column chunk go through shared
//   memory by cp.async, three stages deep. With a few thousand rows there are
//   only B / 64 row blocks, so the columns are split S ways to fill the
//   card; each share writes its own float32 partial [S, B, d] and a second
//   kernel adds the S partials in share order. No atomics: two launches give
//   the same bits. A row id outside [0, R) reads nothing and its output row
//   is NaN (the wrapper does not read a flag back).
// * K13: block (x, z) owns 128 columns and feature group z and walks the
//   whole batch in order, 32 rows at a time: the rows' 128-byte runs of M
//   and g's rows through shared memory. bf16: each warp owns 32 columns (two
//   m16 tiles, the columns as the mma's m and the batch as its k); the A
//   fragment gathers bytes of two batch rows. float32: a thread owns 4
//   columns by DF / 8 features. Every sum runs in batch order inside one
//   block, so repeated rows add up and the result repeats bit for bit. A row
//   id outside [0, R) adds nothing.
// * Repeated rows are read again; reading each distinct row once is later
//   speed work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int STAGES = 3;
// K12 geometry: batch rows per block, columns per stage (bf16 / float32)
constexpr int RB = 64;
constexpr int KC16 = 128;
constexpr int KC32 = 64;
// K13 geometry: columns per block (bf16 / float32), batch rows per stage
constexpr int CS16 = 128;
constexpr int CS32 = 64;
constexpr int KB = 32;

// Two signed bytes of w (the lower first) as a bf16 pair: exact.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t w) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                            static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool in_range(long long row, int n_rows) {
  return row >= 0 && row < n_rows;
}

// ---- K12 -------------------------------------------------------------------

// bf16 route, NT n8 tiles of features per block; each warp owns 16 batch rows.
template <int NT>
struct Fwd16 {
  static constexpr int DF = 8 * NT;
  static constexpr int M_PITCH = KC16 + 16;   // bytes
  static constexpr int Z_PITCH = DF + 8;      // bf16 elements
  static constexpr int M_BYTES = RB * M_PITCH;
  static constexpr int STAGE_BYTES = M_BYTES + KC16 * Z_PITCH * 2;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

// float32 route: thread (tx, ty) owns rows 4 ty .. 4 ty + 3 and features
// tx + 8 j, j < NT.
template <int NT>
struct Fwd32 {
  static constexpr int DF = 8 * NT;
  static constexpr int M_PITCH = KC32 + 16;
  static constexpr int M_BYTES = RB * M_PITCH;
  static constexpr int STAGE_BYTES = M_BYTES + KC32 * DF * 4;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

template <int NT, bool BF16>
__global__ void __launch_bounds__(THREADS)
gather_fwd_kernel(const int8_t* __restrict__ m, const long long* __restrict__ rows,
                  const void* __restrict__ zv, float* __restrict__ part, int n_rows, int c,
                  int batch, int d) {
  using G16 = Fwd16<NT>;
  using G32 = Fwd32<NT>;
  constexpr int KC = BF16 ? KC16 : KC32;
  constexpr int M_PITCH = BF16 ? G16::M_PITCH : G32::M_PITCH;
  constexpr int M_BYTES = RB * M_PITCH;
  constexpr int STAGE_BYTES = BF16 ? G16::STAGE_BYTES : G32::STAGE_BYTES;
  constexpr int DF = 8 * NT;
  constexpr int ESZ = BF16 ? 2 : 4;                       // bytes per z element
  constexpr int Z_PITCH = BF16 ? G16::Z_PITCH : DF;       // elements
  constexpr int Z_PIECES = DF * ESZ / 16;                 // 16-byte pieces per z row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long srow[RB];

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * RB;
  const int f0 = blockIdx.z * DF;
  const int chunks = c / KC;
  const int c_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * chunks / gridDim.y);
  const int n_chunks =
      static_cast<int>(static_cast<long long>(blockIdx.y + 1) * chunks / gridDim.y) - c_begin;
  // -1 marks a row past the batch or out of range: it reads nothing
  for (int r = tid; r < RB; r += THREADS) {
    const long long id = b0 + r < batch ? rows[b0 + r] : -1;
    srow[r] = in_range(id, n_rows) ? id : -1;
  }
  __syncthreads();

  auto load = [&](int stage, int chunk) {
    unsigned char* ms = smem + stage * STAGE_BYTES;
    unsigned char* zs = ms + M_BYTES;
    const int col0 = chunk * KC;
    for (int p = tid; p < RB * KC / 16; p += THREADS) {
      const int r = p / (KC / 16), cc = (p % (KC / 16)) * 16;
      const long long id = srow[r];
      cp_async16_zfill(ms + r * M_PITCH + cc, m + (id < 0 ? 0 : id * c) + col0 + cc, id >= 0);
    }
    const unsigned char* z = static_cast<const unsigned char*>(zv);
    for (int p = tid; p < KC * Z_PIECES; p += THREADS) {
      const int r = p / Z_PIECES, pc = (p % Z_PIECES) * 16;
      cp_async16(zs + r * Z_PITCH * ESZ + pc,
                 z + (static_cast<size_t>(col0 + r) * d + f0) * ESZ + pc);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tx = tid & 7, ty = tid >> 3;
  float acc16[NT][4];
  float acc32[4][NT];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc16[j][r] = acc32[r][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load(s, c_begin + s);
    cp_async_commit();
  }
  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < n_chunks) load((it + STAGES - 1) % STAGES, c_begin + it + STAGES - 1);
    cp_async_commit();
    const unsigned char* ms = smem + (it % STAGES) * STAGE_BYTES;
    if constexpr (BF16) {
      const uint16_t* zs = reinterpret_cast<const uint16_t*>(ms + M_BYTES);
      const unsigned char* mrow = ms + (warp * 16 + g) * M_PITCH + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t b[NT][2];
        load_b<NT>(b, zs, Z_PITCH, ks * 16, lane);
        const unsigned char* p = mrow + ks * 16;
        const uint32_t a0 = bf16_pair(*reinterpret_cast<const uint16_t*>(p));
        const uint32_t a1 = bf16_pair(*reinterpret_cast<const uint16_t*>(p + 8 * M_PITCH));
        const uint32_t a2 = bf16_pair(*reinterpret_cast<const uint16_t*>(p + 8));
        const uint32_t a3 = bf16_pair(*reinterpret_cast<const uint16_t*>(p + 8 * M_PITCH + 8));
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc16[j], a0, a1, a2, a3, b[j][0], b[j][1]);
      }
    } else {
      const float* zs = reinterpret_cast<const float*>(ms + M_BYTES);
      const int8_t* mrow = reinterpret_cast<const int8_t*>(ms) + (4 * ty) * M_PITCH;
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float mv[4], zv_[NT];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = static_cast<float>(mrow[r * M_PITCH + k]);
#pragma unroll
        for (int j = 0; j < NT; ++j) zv_[j] = zs[k * DF + tx + 8 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < NT; ++j) acc32[r][j] = fmaf(mv[r], zv_[j], acc32[r][j]);
      }
    }
  }
  cp_async_wait<0>();

  float* out = part + static_cast<size_t>(blockIdx.y) * batch * d;
  if constexpr (BF16) {
    // acc16[j]: rows warp * 16 + g (+ 8), features j * 8 + 2t (+ 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + warp * 16 + g + 8 * h;
      if (b >= batch) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(b) * d + f0 + j * 8 + 2 * t) =
            make_float2(acc16[j][2 * h], acc16[j][2 * h + 1]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int b = b0 + 4 * ty + r;
      if (b >= batch) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) out[static_cast<size_t>(b) * d + f0 + tx + 8 * j] = acc32[r][j];
    }
  }
}

// out[b, f] = sum over the S shares of part[s, b, f], in share order; NaN
// for a row id out of range.
__global__ void sum_shares(const float* __restrict__ part, const long long* __restrict__ rows,
                           float* __restrict__ out, int shares, int batch, int d, int n_rows) {
  const long long n = static_cast<long long>(batch) * d;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < shares; ++k) s = __fadd_rn(s, part[k * n + i]);
  out[i] = in_range(rows[i / d], n_rows) ? s : nanf("");
}

// ---- K13 -------------------------------------------------------------------

template <int NT, bool BF16>
struct Bwd {
  static constexpr int DF = 8 * NT;
  static constexpr int CS = BF16 ? CS16 : CS32;
  static constexpr int M_PITCH = CS + 16;                 // bytes
  static constexpr int G_PITCH = BF16 ? DF + 8 : DF;      // elements
  static constexpr int ESZ = BF16 ? 2 : 4;
  static constexpr int M_BYTES = KB * M_PITCH;
  static constexpr int STAGE_BYTES = M_BYTES + KB * G_PITCH * ESZ;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

template <int NT, bool BF16>
__global__ void __launch_bounds__(THREADS)
gather_bwd_kernel(const int8_t* __restrict__ m, const long long* __restrict__ rows,
                  const void* __restrict__ gv, float* __restrict__ dz, int n_rows, int c,
                  int batch, int d) {
  using G = Bwd<NT, BF16>;
  constexpr int DF = G::DF;
  constexpr int CS = G::CS;
  constexpr int G_PIECES = DF * G::ESZ / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * CS;
  const int f0 = blockIdx.z * DF;
  const int chunks = (batch + KB - 1) / KB;

  auto load = [&](int stage, int chunk) {
    unsigned char* ms = smem + stage * G::STAGE_BYTES;
    unsigned char* gs = ms + G::M_BYTES;
    const int kb0 = chunk * KB;
    for (int p = tid; p < KB * CS / 16; p += THREADS) {
      const int r = p / (CS / 16), cc = (p % (CS / 16)) * 16;
      const long long id = kb0 + r < batch ? rows[kb0 + r] : -1;
      const bool ok = in_range(id, n_rows);
      cp_async16_zfill(ms + r * G::M_PITCH + cc, m + (ok ? id * c : 0) + col0 + cc, ok);
    }
    const unsigned char* gp = static_cast<const unsigned char*>(gv);
    for (int p = tid; p < KB * G_PIECES; p += THREADS) {
      const int r = p / G_PIECES, pc = (p % G_PIECES) * 16;
      const bool ok = kb0 + r < batch;
      cp_async16_zfill(gs + r * G::G_PITCH * G::ESZ + pc,
                       gp + (static_cast<size_t>(ok ? kb0 + r : 0) * d + f0) * G::ESZ + pc,
                       ok);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tx = tid & 7, ty = tid >> 3;
  float acc16[2][NT][4];
  float acc32[4][NT];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc16[0][j][r] = acc16[1][j][r] = acc32[r][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < chunks; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < chunks) load((it + STAGES - 1) % STAGES, it + STAGES - 1);
    cp_async_commit();
    const unsigned char* ms = smem + (it % STAGES) * G::STAGE_BYTES;
    if constexpr (BF16) {
      const uint16_t* gs = reinterpret_cast<const uint16_t*>(ms + G::M_BYTES);
#pragma unroll
      for (int ks = 0; ks < KB / 16; ++ks) {
        uint32_t b[NT][2];
        load_b<NT>(b, gs, G::G_PITCH, ks * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // A: rows = columns warp * 32 + mt * 16 + g (+ 8), k = batch rows
          // ks * 16 + 2t, 2t + 1 (+ 8): two bytes of one column from two rows
          const unsigned char* p = ms + (ks * 16 + 2 * t) * G::M_PITCH + warp * 32 + mt * 16 + g;
          auto pair = [&](const unsigned char* q) {
            return bf16_pair(static_cast<uint32_t>(q[0]) |
                             (static_cast<uint32_t>(q[G::M_PITCH]) << 8));
          };
          const uint32_t a0 = pair(p), a1 = pair(p + 8);
          const uint32_t a2 = pair(p + 8 * G::M_PITCH), a3 = pair(p + 8 * G::M_PITCH + 8);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc16[mt][j], a0, a1, a2, a3, b[j][0], b[j][1]);
        }
      }
    } else {
      const float* gs = reinterpret_cast<const float*>(ms + G::M_BYTES);
      const int8_t* mcol = reinterpret_cast<const int8_t*>(ms) + 4 * ty;
#pragma unroll 4
      for (int k = 0; k < KB; ++k) {
        float mv[4], gv_[NT];
        const uint32_t w = *reinterpret_cast<const uint32_t*>(mcol + k * G::M_PITCH);
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = static_cast<float>(static_cast<int8_t>(w >> (8 * r)));
#pragma unroll
        for (int j = 0; j < NT; ++j) gv_[j] = gs[k * DF + tx + 8 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < NT; ++j) acc32[r][j] = fmaf(mv[r], gv_[j], acc32[r][j]);
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (BF16) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t col = col0 + warp * 32 + mt * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *reinterpret_cast<float2*>(dz + col * d + f0 + j * 8 + 2 * t) =
              make_float2(acc16[mt][j][2 * h], acc16[mt][j][2 * h + 1]);
      }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const size_t col = col0 + 4 * ty + r;
#pragma unroll
      for (int j = 0; j < NT; ++j) dz[col * d + f0 + tx + 8 * j] = acc32[r][j];
    }
  }
}

template <int NT, bool BF16>
cudaError_t launch_fwd(const int8_t* m, const long long* rows, const void* z, float* part,
                       float* out, int n_rows, int c, int batch, int d, int shares,
                       cudaStream_t s) {
  const int smem_bytes = BF16 ? Fwd16<NT>::SMEM_BYTES : Fwd32<NT>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(gather_fwd_kernel<NT, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((batch + RB - 1) / RB, shares, d / (8 * NT));
  gather_fwd_kernel<NT, BF16><<<grid, THREADS, smem_bytes, s>>>(m, rows, z, part, n_rows, c,
                                                                batch, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = static_cast<long long>(batch) * d;
  sum_shares<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(part, rows, out, shares,
                                                                    batch, d, n_rows);
  return cudaGetLastError();
}

template <int NT, bool BF16>
cudaError_t launch_bwd(const int8_t* m, const long long* rows, const void* g, float* dz,
                       int n_rows, int c, int batch, int d, cudaStream_t s) {
  using G = Bwd<NT, BF16>;
  cudaError_t err = cudaFuncSetAttribute(gather_bwd_kernel<NT, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(c / G::CS, 1, d / G::DF);
  gather_bwd_kernel<NT, BF16><<<grid, THREADS, G::SMEM_BYTES, s>>>(m, rows, g, dz, n_rows, c,
                                                                   batch, d);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t fwd_by_width(const int8_t* m, const long long* rows, const void* z, float* part,
                         float* out, int n_rows, int c, int batch, int d, int shares,
                         cudaStream_t s) {
  if (d % 64 == 0) return launch_fwd<8, BF16>(m, rows, z, part, out, n_rows, c, batch, d, shares, s);
  if (d % 32 == 0) return launch_fwd<4, BF16>(m, rows, z, part, out, n_rows, c, batch, d, shares, s);
  if (d % 16 == 0) return launch_fwd<2, BF16>(m, rows, z, part, out, n_rows, c, batch, d, shares, s);
  return launch_fwd<1, BF16>(m, rows, z, part, out, n_rows, c, batch, d, shares, s);
}

template <bool BF16>
cudaError_t bwd_by_width(const int8_t* m, const long long* rows, const void* g, float* dz,
                         int n_rows, int c, int batch, int d, cudaStream_t s) {
  if (d % 64 == 0) return launch_bwd<8, BF16>(m, rows, g, dz, n_rows, c, batch, d, s);
  if (d % 32 == 0) return launch_bwd<4, BF16>(m, rows, g, dz, n_rows, c, batch, d, s);
  if (d % 16 == 0) return launch_bwd<2, BF16>(m, rows, g, dz, n_rows, c, batch, d, s);
  return launch_bwd<1, BF16>(m, rows, g, dz, n_rows, c, batch, d, s);
}

}  // namespace

extern "C" {

// m int8 [n_rows, c]; rows int64 [batch]; z [c, d], bf16 when bf16 != 0 else
// float32; part float32 [shares, batch, d] scratch; out float32 [batch, d].
// The wrapper checks c % 128 == 0, d % 8 == 0, 1 <= shares <= c / 128
// (c / 64 for float32), batch >= 1, contiguity and 16-byte alignment.
// Returns cudaGetLastError().
int gather_rows_matmul(const void* m, const void* rows, const void* z, void* part, void* out,
                       int n_rows, int c, int batch, int d, int shares, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* mp = static_cast<const int8_t*>(m);
  const long long* rp = static_cast<const long long*>(rows);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(out);
  cudaError_t err = bf16 ? fwd_by_width<true>(mp, rp, z, pp, op, n_rows, c, batch, d, shares, s)
                         : fwd_by_width<false>(mp, rp, z, pp, op, n_rows, c, batch, d, shares, s);
  return static_cast<int>(err);
}

// m int8 [n_rows, c]; rows int64 [batch]; g [batch, d], bf16 when bf16 != 0
// else float32; dz float32 [c, d] receives every element. The wrapper checks
// c % 128 == 0, d % 8 == 0, batch >= 1, contiguity and 16-byte alignment.
// Returns cudaGetLastError().
int gather_rows_matmul_t(const void* m, const void* rows, const void* g, void* dz, int n_rows,
                         int c, int batch, int d, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* mp = static_cast<const int8_t*>(m);
  const long long* rp = static_cast<const long long*>(rows);
  float* dp = static_cast<float*>(dz);
  cudaError_t err = bf16 ? bwd_by_width<true>(mp, rp, g, dp, n_rows, c, batch, d, s)
                         : bwd_by_width<false>(mp, rp, g, dp, n_rows, c, batch, d, s);
  return static_cast<int>(err);
}

const char* gather_rows_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* gather_rows_matmul_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
