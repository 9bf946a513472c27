// K5 dual_int4_t: both directions of the adjacency product from one read of
// the nibble-packed count matrix, activations int8 in the transposed [d, N]
// layout.
//
//   yuT[f, u] = sum_c qiT[f, c] * M[u, c]      (M  @ qi, as [d, U_pad])
//   yiT[f, c] = sum_u quT[f, u] * M[u, c]      (M^T @ qu, as [d, I_pad])
//
// M [U_pad, I_pad] holds counts 0..15 and is stored packed as m4
// [U_pad, I_pad / 2]: within each tile of 2048 logical columns, byte p
// (0..1023) of the tile holds column p in its low nibble and column 1024 + p
// in its high nibble (ops/fusedmm.py pack_nibbles). The integer products are
// those of K1 (dual_int8_t.cu) on the unpacked matrix, bit for bit.
//
// Replaces idgrec_tpu/ops/fusedmm.py _tkernel_int4 (l.708, launched by
// _tdual_small_call l.758) and _tkernel_int4_panel (l.832, launched by
// _tdual_panel_call l.881); entry fused_adj_matmul_int4_t (l.944). The TPU
// body masks the high nibble in place and shifts the products, because its
// vector unit has no int8 shift; here each 32-bit word of packed bytes is
// unpacked in registers (w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F, unsigned, so
// no sign bit smears) into two s8 operands of mma.sync m16n8k32. The .s4
// operand forms are not used: the activations are int8.
//
// Bound on the H100: bytes. One sweep reads m4 once (U_pad * I_pad / 2
// bytes) against 4 * U_pad * I_pad * d int8 operations: 512 operations per
// byte of M, still below the ~590 int8 ops/byte ridge of the card.
//
// Design: K1's, with a strip of 128 packed bytes.
// * Block (x, y) owns packed strip x (128 byte columns of one tile, so two
//   spans of 128 logical columns, 1024 apart) and the y-th even share of the
//   64-row chunks. One read of a packed chunk feeds four products: yu from
//   the low and from the high span, yi of the low and of the high span.
// * Chunks stream through shared memory (cp.async, STAGES deep); qiT of both
//   spans sits in shared memory side by side ([64, 128 | 128]).
// * yu: a warp owns 8 chunk rows and all 64 features. A word of a packed row
//   is the B fragment of two mmas: its low nibbles against qiT of the low
//   span, its high nibbles against qiT of the high span.
// * yi: a warp owns 16 packed byte columns, so 2 x 16 logical columns, all 64
//   features, in registers over the block's rows. The B fragment gathers four
//   bytes of one packed column over four rows once and is unpacked twice.
// * Tiles whose nibbles are all zero are skipped (warp-uniform votes on the
//   low and on the high nibbles of 16-byte loads): a zero byte is two zero
//   nibbles, and the matrix is sparse.
// * Cross-block sums are int32 atomicAdd into the zeroed outputs the wrapper
//   allocates (order-free, exact); zero partial sums are not sent; each warp
//   stages its yu tile so that one atomic instruction covers 4 sectors.
// * A second kernel converts the int32 sums to float32 in place, once: exact
//   while every sum stays below 2^24 (counts <= 15 and |q| <= 127 allow
//   8,800 non-zero entries per row or column at the worst).

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

constexpr int D = 64;                  // feature rows of the activations
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PSTRIP = WARPS * 16;     // packed byte columns of m4 per block
constexpr int SPAN = PSTRIP;           // logical columns per nibble span
constexpr int HALF_TILE = 1024;        // packed bytes per tile = distance of the spans
constexpr int CHUNK = 64;              // rows of M per stage (two mma k-steps)
constexpr int STAGES = 4;
constexpr int M_STRIDE = PSTRIP + 16;  // smem row pitch (bytes) of a packed chunk
constexpr int Q_STRIDE = CHUNK + 16;   // smem row pitch of the quT chunk
constexpr int QI_STRIDE = 2 * SPAN + 16;  // smem row pitch of qiT (both spans)
constexpr int M_STAGE_BYTES = CHUNK * M_STRIDE;
constexpr int Q_STAGE_BYTES = D * Q_STRIDE;
constexpr int STAGE_BYTES = M_STAGE_BYTES + Q_STAGE_BYTES;
constexpr int QI_BYTES = D * QI_STRIDE;
constexpr int YU_PITCH = 8 + 1;             // words per feature row of a warp's yu tile
constexpr int YU_BYTES = WARPS * D * YU_PITCH * 4;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + QI_BYTES + YU_BYTES;
constexpr uint32_t LO = 0x0F0F0F0Fu;
constexpr uint32_t HI = 0xF0F0F0F0u;

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four packed bytes of one byte column from four consecutive smem rows, low
// byte first: unpacked, the k-major B fragments of the M^T product for the
// column's low-span and high-span logical columns.
__device__ __forceinline__ uint32_t column4(const int8_t* p) {
  return static_cast<uint32_t>(static_cast<uint8_t>(p[0])) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[M_STRIDE])) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[2 * M_STRIDE])) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[3 * M_STRIDE])) << 24);
}

__device__ __forceinline__ void add_nonzero(int* dst, int v) {
  if (v != 0) atomicAdd(dst, v);
}

__global__ void __launch_bounds__(THREADS, 2)
dual_int4_t_kernel(const int8_t* __restrict__ m4, const int8_t* __restrict__ qu,
                   const int8_t* __restrict__ qi, int* __restrict__ yu,
                   int* __restrict__ yi, int u_pad, int i_pad) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* qis = smem + STAGES * STAGE_BYTES;  // qiT of the block's two spans
  // this warp's [64 features, 8 rows] yu tile, staged so that each atomic
  // instruction covers 4 feature rows x 8 contiguous u (4 sectors, not 8)
  int* yus = reinterpret_cast<int*>(qis + QI_BYTES) + (threadIdx.x >> 5) * D * YU_PITCH;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma threadID_in_group
  // Block (x, y) owns packed strip x and the y-th of gridDim.y even shares of
  // the 64-row chunks. Packed byte column pcol0 lies in tile pcol0 / 1024 at
  // offset pcol0 % 1024; its nibbles are logical columns lo0 + j and hi0 + j.
  const int m_cols = i_pad / 2;
  const int pcol0 = blockIdx.x * PSTRIP;
  const int lo0 = (pcol0 / HALF_TILE) * (2 * HALF_TILE) + pcol0 % HALF_TILE;
  const int hi0 = lo0 + HALF_TILE;
  const int chunks = u_pad / CHUNK;
  const int c_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * chunks / gridDim.y);
  const int n_chunks =
      static_cast<int>(static_cast<long long>(blockIdx.y + 1) * chunks / gridDim.y) - c_begin;

  // yi product role: packed byte columns [warp * 16, warp * 16 + 16) of the
  // strip; n-tile nt = 2 * pt + span covers the 8 logical columns of packed
  // tile pt (0, 1) in span 0 (low nibbles) or 1 (high nibbles).
  int acc_i[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_i[mt][nt][r] = 0;

  auto load_stage = [&](int stage, int chunk) {
    int8_t* ms = smem + stage * STAGE_BYTES;
    int8_t* qs = ms + M_STAGE_BYTES;
    const int r0 = chunk * CHUNK;
    // packed chunk: CHUNK rows x PSTRIP bytes = 512 16-byte pieces.
#pragma unroll
    for (int k = 0; k < CHUNK * PSTRIP / 16 / THREADS; ++k) {
      const int p = tid + k * THREADS;
      const int r = p / (PSTRIP / 16);
      const int c = (p % (PSTRIP / 16)) * 16;
      cp_async16(ms + r * M_STRIDE + c, m4 + static_cast<size_t>(r0 + r) * m_cols + pcol0 + c);
    }
    // quT chunk: D rows x CHUNK bytes = 256 16-byte pieces, one per thread.
    {
      const int r = tid / (CHUNK / 16);
      const int c = (tid % (CHUNK / 16)) * 16;
      cp_async16(qs + r * Q_STRIDE + c, qu + static_cast<size_t>(r) * u_pad + r0 + c);
    }
  };

  // qiT [D, SPAN | SPAN] of the two spans into shared memory; the first
  // barrier of the loop publishes it.
#pragma unroll
  for (int k = 0; k < D * 2 * SPAN / 16 / THREADS; ++k) {
    const int p = tid + k * THREADS;
    const int r = p / (2 * SPAN / 16);
    const int c = (p % (2 * SPAN / 16)) * 16;
    const int src = c < SPAN ? lo0 + c : hi0 + (c - SPAN);
    *reinterpret_cast<uint4*>(qis + r * QI_STRIDE + c) =
        __ldg(reinterpret_cast<const uint4*>(qi + static_cast<size_t>(r) * i_pad + src));
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_stage(s, c_begin + s);
    cp_async_commit();
  }

  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this stage landed; every warp is done with the last
    const int next = it + STAGES - 1;
    if (next < n_chunks) load_stage(next % STAGES, c_begin + next);
    cp_async_commit();

    const int8_t* ms = smem + (it % STAGES) * STAGE_BYTES;
    const int8_t* qs = ms + M_STAGE_BYTES;
    const int r0 = (c_begin + it) * CHUNK;

    // ---- yu[f, u] for this warp's 8 chunk rows and all four feature
    // m-tiles: k runs over the strip's two spans, four independent chains.
    {
      int acc_u[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc_u[mt][r] = 0;
      // which 32-column groups of the warp's rows hold a non-zero: bit 2 * ks
      // for the low nibbles of packed bytes [32 ks, 32 ks + 32), bit
      // 2 * ks + 1 for their high nibbles. Lane l reads row warp * 8 + l / 4,
      // packed bytes 32 * (l % 4) .. + 31.
      unsigned tiles = 0;
      {
        const int q = lane & 3;
        const uint4* row = reinterpret_cast<const uint4*>(
            ms + (warp * 8 + (lane >> 2)) * M_STRIDE + q * 32);
        const uint4 v0 = row[0], v1 = row[1];
        const uint32_t any = v0.x | v0.y | v0.z | v0.w | v1.x | v1.y | v1.z | v1.w;
        const unsigned lo = __ballot_sync(0xffffffffu, (any & LO) != 0);
        const unsigned hi = __ballot_sync(0xffffffffu, (any & HI) != 0);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          if (lo & (0x11111111u << qq)) tiles |= 1u << (2 * qq);
          if (hi & (0x11111111u << qq)) tiles |= 1u << (2 * qq + 1);
        }
      }
      const int8_t* mrow = ms + (warp * 8 + g) * M_STRIDE + t * 4;
      const int8_t* arow = qis + ((lane & 7) + ((lane >> 3) & 1) * 8) * QI_STRIDE +
                           (lane >> 4) * 16;
#pragma unroll
      for (int ks = 0; ks < PSTRIP / 32; ++ks) {
        const unsigned bits = (tiles >> (2 * ks)) & 3u;
        // an all-zero tile of M adds nothing: skip its products
        if (bits == 0) continue;
        const uint32_t w0 = ld32(mrow + ks * 32), w1 = ld32(mrow + ks * 32 + 16);
        if (bits & 1u) {
          const uint32_t b0 = w0 & LO, b1 = w1 & LO;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t a1[4];
            ldmatrix_x4(a1, arow + mt * 16 * QI_STRIDE + ks * 32);
            mma_s8(acc_u[mt], a1, b0, b1);
          }
        }
        if (bits & 2u) {
          const uint32_t b0 = (w0 >> 4) & LO, b1 = (w1 >> 4) & LO;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t a1[4];
            ldmatrix_x4(a1, arow + mt * 16 * QI_STRIDE + SPAN + ks * 32);
            mma_s8(acc_u[mt], a1, b0, b1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        int* row = yus + (mt * 16 + g) * YU_PITCH + 2 * t;
        row[0] = acc_u[mt][0];
        row[1] = acc_u[mt][1];
        row[8 * YU_PITCH] = acc_u[mt][2];
        row[8 * YU_PITCH + 1] = acc_u[mt][3];
      }
      __syncwarp();
      const int uu = lane & 7;
      int* dst = yu + static_cast<size_t>(lane >> 3) * u_pad + r0 + warp * 8 + uu;
#pragma unroll
      for (int k = 0; k < D / 4; ++k) {
        add_nonzero(dst + static_cast<size_t>(4 * k) * u_pad,
                    yus[(4 * k + (lane >> 3)) * YU_PITCH + uu]);
      }
      __syncwarp();
    }

    // ---- yi[f, c] += quT[f, chunk rows] . M[chunk rows, c], two k-steps.
#pragma unroll
    for (int kk = 0; kk < CHUNK / 32; ++kk) {
      // which of the warp's four 32x8 tiles of M hold a non-zero: lane l
      // reads row kk * 32 + l of the warp's 16 packed byte columns
      const uint4 x = *reinterpret_cast<const uint4*>(
          ms + (kk * 32 + lane) * M_STRIDE + warp * 16);
      const uint32_t p0 = x.x | x.y, p1 = x.z | x.w;
      const unsigned nz = (__any_sync(0xffffffffu, (p0 & LO) != 0) ? 1u : 0u) |
                          (__any_sync(0xffffffffu, (p0 & HI) != 0) ? 2u : 0u) |
                          (__any_sync(0xffffffffu, (p1 & LO) != 0) ? 4u : 0u) |
                          (__any_sync(0xffffffffu, (p1 & HI) != 0) ? 8u : 0u);
      if (nz == 0) continue;
      uint32_t a2[4][4];
      const int8_t* qrow = qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * Q_STRIDE + kk * 32 +
                           (lane >> 4) * 16;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(a2[mt], qrow + mt * 16 * Q_STRIDE);
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
        if (!((nz >> (2 * pt)) & 3u)) continue;  // all-zero packed tile
        // the fragment is gathered once and unpacked twice
        const int8_t* mcol = ms + (kk * 32 + t * 4) * M_STRIDE + warp * 16 + pt * 8 + g;
        const uint32_t w0 = column4(mcol);
        const uint32_t w1 = column4(mcol + 16 * M_STRIDE);
        if ((nz >> (2 * pt)) & 1u) {
          const uint32_t b0 = w0 & LO, b1 = w1 & LO;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_s8(acc_i[mt][2 * pt], a2[mt], b0, b1);
        }
        if ((nz >> (2 * pt + 1)) & 1u) {
          const uint32_t b0 = (w0 >> 4) & LO, b1 = (w1 >> 4) & LO;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_s8(acc_i[mt][2 * pt + 1], a2[mt], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = ((nt & 1) ? hi0 : lo0) + warp * 16 + (nt >> 1) * 8 + 2 * t;
      int* dst = yi + static_cast<size_t>(mt * 16 + g) * i_pad + i;
      add_nonzero(dst, acc_i[mt][nt][0]);
      add_nonzero(dst + 1, acc_i[mt][nt][1]);
      add_nonzero(dst + 8 * static_cast<size_t>(i_pad), acc_i[mt][nt][2]);
      add_nonzero(dst + 8 * static_cast<size_t>(i_pad) + 1, acc_i[mt][nt][3]);
    }
  }
}

__global__ void int32_to_float_inplace(int* __restrict__ x, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    const float v = static_cast<float>(x[i]);
    reinterpret_cast<float*>(x)[i] = v;
  }
}

}  // namespace

extern "C" {

// m4 is the packed matrix [u_pad, i_pad / 2]. yu [D, u_pad] and yi [D, i_pad]
// must be zeroed int32 buffers; on return they hold the float32 sums
// (bit-cast in place). The wrapper checks d == 64, i_pad % 2048 == 0 and
// u_pad % 64 == 0. Returns cudaGetLastError().
int dual_int4_t(const void* m4, const void* qu, const void* qi, void* yu, void* yi,
                int u_pad, int i_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      dual_int4_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dual_int4_t_kernel, THREADS,
                                                           SMEM_BYTES)) != cudaSuccess)
    return static_cast<int>(err);
  // Row splits: each split adds one flush of yi per strip (atomics), so take
  // the fewest in 4..16 whose grid best fills its last wave.
  const int strips = i_pad / 2 / PSTRIP, chunks = u_pad / CHUNK;
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  int splits = 1;
  double best = -1.0;
  for (int r = 4; r <= 16 && r <= chunks; ++r) {
    const long long blocks = static_cast<long long>(strips) * r;
    const double fill = static_cast<double>(blocks) / (((blocks + slots - 1) / slots) * slots);
    if (fill > best + 1e-9) { best = fill; splits = r; }
  }
  dim3 grid(strips, splits);
  dual_int4_t_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const int8_t*>(m4), static_cast<const int8_t*>(qu),
      static_cast<const int8_t*>(qi), static_cast<int*>(yu), static_cast<int*>(yi),
      u_pad, i_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nu = static_cast<long long>(D) * u_pad;
  const long long ni = static_cast<long long>(D) * i_pad;
  int32_to_float_inplace<<<static_cast<unsigned>((nu + 255) / 256), 256, 0, s>>>(
      static_cast<int*>(yu), nu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int32_to_float_inplace<<<static_cast<unsigned>((ni + 255) / 256), 256, 0, s>>>(
      static_cast<int*>(yi), ni);
  return static_cast<int>(cudaGetLastError());
}

const char* dual_int4_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
