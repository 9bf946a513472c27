// K1 dual_int8_t: both directions of the int8 adjacency product from one
// read of each M tile, activations in the transposed [d, N] layout.
//
//   yuT[f, u] = sum_i qiT[f, i] * M[u, i]      (M  @ qi, as [d, U_pad])
//   yiT[f, i] = sum_u quT[f, u] * M[u, i]      (M^T @ qu, as [d, I_pad])
//
// Replaces idgrec_tpu/ops/fusedmm.py _tkernel_int8 (l.674, launched by
// _tdual_small_call l.758) and _tkernel_int8_panel (l.797, launched by
// _tdual_panel_call l.881); entry fused_adj_matmul_int8_t (l.923). The TPU
// needed two bodies because its yi accumulator had to fit VMEM; here one
// kernel covers both.
//
// Bound on the H100: bytes. One sweep reads M once (U_pad * I_pad bytes,
// 1.22 GB at yelp2018 scale) against 4 * U_pad * I_pad * d int8 operations,
// 256 operations per byte, below the ~590 int8 ops/byte ridge of the card.
//
// Design:
// * Block (x, y) owns column strip x (256 columns) and the y-th even share
//   of the 64-row chunks. The host picks the number of shares so the grid
//   fills whole waves of the blocks the card holds at once (two per SM);
//   each share adds one flush of yi atomics, so it takes as few as it can.
// * A block streams its chunks through shared memory (cp.async, STAGES
//   deep), so every byte of M is read from device memory once and feeds both
//   products from shared memory.
// * Both products run on the tensor cores as mma.sync m16n8k32 s8*s8->s32.
//   yi for the strip ([64, 256] int32) stays in registers over the block's
//   rows; yu for a chunk is complete over the strip after the chunk. qiT of
//   the strip sits in shared memory (ldmatrix), which keeps the kernel within
//   128 registers, so two blocks share an SM. A warp computes yu for 8 rows
//   of the chunk and all 64 features: four independent accumulation chains.
// * A product whose tile of M is all zero adds nothing, so it is skipped
//   (warp-uniform votes on 16-byte loads of the warp's own rows or
//   columns). Interaction matrices are sparse: at yelp2018 scale about 16 %
//   of the 8x32 and 32x8 tiles hold a non-zero, so most tensor-core work is
//   skipped while every byte of M is still read once. Dense matrices just
//   skip nothing.
// * Cross-block sums are int32 atomicAdd into the zeroed int32 outputs the
//   wrapper allocates. Integer addition is associative, so the result does
//   not depend on block order. Zero partial sums are not sent: M is sparse,
//   so most yu partials of a 256-column strip are zero. L2 charges atomics
//   per 32-byte sector, so each warp stages its yu tile in shared memory and
//   sends rows of 8 contiguous values (4 sectors per instruction, not 8).
// * A second kernel converts the int32 sums to float32 in place, once. This
//   equals the TPU kernel's per-tile int32->f32 then f32 accumulation while
//   every partial sum stays below 2^24.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

constexpr int D = 64;                  // feature rows of the activations
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STRIP = WARPS * 32;      // columns of M per block
constexpr int CHUNK = 64;              // rows of M per stage (two mma k-steps)
constexpr int STAGES = 3;
constexpr int M_STRIDE = STRIP + 16;   // smem row pitch (bytes), skews banks
constexpr int Q_STRIDE = CHUNK + 16;   // smem row pitch of the quT chunk
constexpr int M_STAGE_BYTES = CHUNK * M_STRIDE;
constexpr int Q_STAGE_BYTES = D * Q_STRIDE;
constexpr int STAGE_BYTES = M_STAGE_BYTES + Q_STAGE_BYTES;
constexpr int QI_BYTES = D * M_STRIDE;      // qiT of one strip
constexpr int YU_PITCH = 8 + 1;             // words per feature row of a warp's yu tile
constexpr int YU_BYTES = WARPS * D * YU_PITCH * 4;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + QI_BYTES + YU_BYTES;

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four bytes of one column from four consecutive smem rows, packed low
// byte first: the k-major B fragment of the M^T product.
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
dual_int8_t_kernel(const int8_t* __restrict__ m, const int8_t* __restrict__ qu,
                   const int8_t* __restrict__ qi, int* __restrict__ yu,
                   int* __restrict__ yi, int u_pad, int i_pad) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* qis = smem + STAGES * STAGE_BYTES;  // qiT of the block's strip
  // this warp's [64 features, 8 rows] yu tile, staged so that each atomic
  // instruction covers 4 feature rows x 8 contiguous u (4 sectors, not 8)
  int* yus = reinterpret_cast<int*>(qis + QI_BYTES) + (threadIdx.x >> 5) * D * YU_PITCH;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma threadID_in_group
  // Block (x, y) owns column strip x and the y-th of gridDim.y even shares
  // of the 64-row chunks. Blocks are scheduled x-fastest, so the blocks on
  // the card at once read neighbouring strips of the same rows.
  const int col0 = blockIdx.x * STRIP;
  const int chunks = u_pad / CHUNK;
  const int c_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * chunks / gridDim.y);
  const int n_chunks =
      static_cast<int>(static_cast<long long>(blockIdx.y + 1) * chunks / gridDim.y) - c_begin;

  // yu product role: chunk rows [warp * 8, warp * 8 + 8), all 64 features.

  // yi product role: columns [warp * 32, warp * 32 + 32) of the strip, all
  // four feature m-tiles, accumulated over the block's rows.
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
    // M chunk: CHUNK rows x STRIP bytes = 1024 16-byte pieces.
#pragma unroll
    for (int k = 0; k < CHUNK * STRIP / 16 / THREADS; ++k) {
      const int p = tid + k * THREADS;
      const int r = p / (STRIP / 16);
      const int c = (p % (STRIP / 16)) * 16;
      cp_async16(ms + r * M_STRIDE + c, m + static_cast<size_t>(r0 + r) * i_pad + col0 + c);
    }
    // quT chunk: D rows x CHUNK bytes = 256 16-byte pieces, one per thread.
    {
      const int r = tid / (CHUNK / 16);
      const int c = (tid % (CHUNK / 16)) * 16;
      cp_async16(qs + r * Q_STRIDE + c, qu + static_cast<size_t>(r) * u_pad + r0 + c);
    }
  };

  // qiT [D, STRIP] of the strip into shared memory; the first barrier of
  // the loop publishes it.
#pragma unroll
  for (int k = 0; k < D * STRIP / 16 / THREADS; ++k) {
    const int p = tid + k * THREADS;
    const int r = p / (STRIP / 16);
    const int c = (p % (STRIP / 16)) * 16;
    *reinterpret_cast<uint4*>(qis + r * M_STRIDE + c) =
        __ldg(reinterpret_cast<const uint4*>(qi + static_cast<size_t>(r) * i_pad + col0 + c));
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
    // m-tiles: k runs over the strip's columns, four independent chains.
    {
      int acc_u[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc_u[mt][r] = 0;
      // which 32-column groups of the warp's rows hold a non-zero (bit ks):
      // lane l reads row warp * 8 + l / 4, columns 64 * (l % 4) .. + 63
      unsigned tiles = 0;
      {
        const int q = lane & 3;
        const uint4* row = reinterpret_cast<const uint4*>(
            ms + (warp * 8 + (lane >> 2)) * M_STRIDE + q * 64);
        const uint4 v0 = row[0], v1 = row[1], v2 = row[2], v3 = row[3];
        const unsigned lo = __ballot_sync(
            0xffffffffu, (v0.x | v0.y | v0.z | v0.w | v1.x | v1.y | v1.z | v1.w) != 0);
        const unsigned hi = __ballot_sync(
            0xffffffffu, (v2.x | v2.y | v2.z | v2.w | v3.x | v3.y | v3.z | v3.w) != 0);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          if (lo & (0x11111111u << qq)) tiles |= 1u << (2 * qq);
          if (hi & (0x11111111u << qq)) tiles |= 1u << (2 * qq + 1);
        }
      }
      const int8_t* mrow = ms + (warp * 8 + g) * M_STRIDE + t * 4;
      const int8_t* arow = qis + ((lane & 7) + ((lane >> 3) & 1) * 8) * M_STRIDE +
                           (lane >> 4) * 16;
#pragma unroll
      for (int ks = 0; ks < STRIP / 32; ++ks) {
        // an all-zero tile of M adds nothing: skip its products
        if (!((tiles >> ks) & 1u)) continue;
        const uint32_t b0 = ld32(mrow + ks * 32), b1 = ld32(mrow + ks * 32 + 16);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a1[4];
          ldmatrix_x4(a1, arow + mt * 16 * M_STRIDE + ks * 32);
          mma_s8(acc_u[mt], a1, b0, b1);
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

    // ---- yi[f, i] += quT[f, chunk rows] . M[chunk rows, i], two k-steps.
#pragma unroll
    for (int kk = 0; kk < CHUNK / 32; ++kk) {
      // which of the warp's four 32x8 tiles of M hold a non-zero: lane l
      // reads row kk * 32 + l of the warp's 32 columns
      const uint4* row = reinterpret_cast<const uint4*>(
          ms + (kk * 32 + lane) * M_STRIDE + warp * 32);
      const uint4 x0 = row[0], x1 = row[1];
      const unsigned nz = (__any_sync(0xffffffffu, (x0.x | x0.y) != 0) ? 1u : 0u) |
                          (__any_sync(0xffffffffu, (x0.z | x0.w) != 0) ? 2u : 0u) |
                          (__any_sync(0xffffffffu, (x1.x | x1.y) != 0) ? 4u : 0u) |
                          (__any_sync(0xffffffffu, (x1.z | x1.w) != 0) ? 8u : 0u);
      if (nz == 0) continue;
      uint32_t a2[4][4];
      const int8_t* qrow = qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * Q_STRIDE + kk * 32 +
                           (lane >> 4) * 16;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(a2[mt], qrow + mt * 16 * Q_STRIDE);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (!((nz >> nt) & 1u)) continue;  // all-zero tile: nothing to add
        const int8_t* mcol = ms + (kk * 32 + t * 4) * M_STRIDE + warp * 32 + nt * 8 + g;
        const uint32_t b0 = column4(mcol);
        const uint32_t b1 = column4(mcol + 16 * M_STRIDE);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_s8(acc_i[mt][nt], a2[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = col0 + warp * 32 + nt * 8 + 2 * t;
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

// yu [D, u_pad] and yi [D, i_pad] must be zeroed int32 buffers; on return
// they hold the float32 sums (bit-cast in place). The wrapper checks
// d == 64, i_pad % 256 == 0 and u_pad % 64 == 0.
// Returns cudaGetLastError().
int dual_int8_t(const void* m, const void* qu, const void* qi, void* yu, void* yi,
                int u_pad, int i_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      dual_int8_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dual_int8_t_kernel, THREADS,
                                                           SMEM_BYTES)) != cudaSuccess)
    return static_cast<int>(err);
  // Row splits: each split adds one flush of yi per strip (atomics), so take
  // the fewest in 4..16 whose grid best fills its last wave.
  const int strips = i_pad / STRIP, chunks = u_pad / CHUNK;
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  int splits = 1;
  double best = -1.0;
  for (int r = 4; r <= 16 && r <= chunks; ++r) {
    const long long blocks = static_cast<long long>(strips) * r;
    const double fill = static_cast<double>(blocks) / (((blocks + slots - 1) / slots) * slots);
    if (fill > best + 1e-9) { best = fill; splits = r; }
  }
  dim3 grid(strips, splits);
  dual_int8_t_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const int8_t*>(m), static_cast<const int8_t*>(qu),
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

const char* dual_int8_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
