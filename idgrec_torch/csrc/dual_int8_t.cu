// K1 dual_int8_t: both directions of the int8 adjacency product from one
// read of M, activations in the transposed [d, N] layout of the chain.
//
//   yuT[f, u] = sum_i qiT[f, i] * M[u, i]      (M  @ qi, as [d, U_pad])
//   yiT[f, i] = sum_u quT[f, u] * M[u, i]      (M^T @ qu, as [d, I_pad])
//
// Replaces idgrec_tpu/ops/fusedmm.py _tkernel_int8 (l.674, launched by
// _tdual_small_call l.758) and _tkernel_int8_panel (l.797, launched by
// _tdual_panel_call l.881); entry fused_adj_matmul_int8_t (l.923). The TPU
// needed two bodies because its yi accumulator had to fit VMEM; here one
// scan covers both.
//
// Bound on the H100: bytes. One sweep reads M once (U_pad * I_pad bytes,
// 1.22 GB at yelp2018 scale); the operations are 4 * nnz * d int8
// multiply-adds (the non-zero entries only).
//
// Design: the scan of dual_scan.cuh (K7's; its note gives the design and the
// measurements that chose it) at d = 64, with the layout turned at the two
// edges, three launches a call:
// * turn in: quT and qiT become one int8 [U_pad + I_pad, 64] scratch (users,
//   then items), through a 64 x 64 shared-memory tile so that reads and
//   writes both coalesce; the same blocks zero the int32 sums the scan adds
//   into. A warp-per-entry scan reading a column of qiT straight from
//   [d, N] would touch 64 separate 32-byte sectors per entry where the
//   [N, d] row touches 2, and so would the atomics into [d, N] sums.
// * the scan: one feature group of 64, one read of M, int32 atomics into
//   [U_pad + I_pad, 64].
// * turn out: the int32 sums are converted to float32 (once, exact while
//   every sum stays below 2^24) and written transposed into yuT and yiT
//   through a shared-memory tile, both sides in one launch. The outputs need
//   no zeroing.
// The tile kernel this replaces (mma.sync on 64 x 256 stages of M, zero-tile
// votes, byte gathers, its outputs zeroed and converted by four more
// launches) took 0.916 ms per sweep on an H100 where this takes 0.575, the
// turns 0.024 of it (PERF.md). The launcher makes no per-call attribute or
// occupancy query: the turns use static shared memory, and the scan's
// launcher reads the SM count once per process and device.

#include <cstdint>
#include <cuda_runtime.h>

#include "dual_scan.cuh"

namespace {

constexpr int D = 64;       // feature rows of the activations
constexpr int TILE = 64;    // nodes per block of the turns
constexpr int TURN_THREADS = 256;
constexpr int Q_PITCH = TILE + 4;  // bytes per feature row of the turn-in tile (skews banks)

// Block b turns 64 nodes: b < u_pad / 64 the users of quT, else the items of
// qiT. qT [64, n] -> q rows [row0, row0 + 64) of [U_pad + I_pad, 64], and the
// same rows of the int32 sums zeroed.
__global__ void __launch_bounds__(TURN_THREADS)
turn_in(const int8_t* __restrict__ quT, const int8_t* __restrict__ qiT, int8_t* __restrict__ q,
        int* __restrict__ acc, int u_pad, int i_pad) {
  __shared__ __align__(16) int8_t tile[D * Q_PITCH];
  const int t = threadIdx.x;
  const int user_blocks = u_pad / TILE;
  const bool user = static_cast<int>(blockIdx.x) < user_blocks;
  const int8_t* src = user ? quT : qiT;
  const int n_stride = user ? u_pad : i_pad;
  const int n0 = (user ? blockIdx.x : blockIdx.x - user_blocks) * TILE;
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE;
  // read: feature f, nodes c .. c + 15 (16 bytes a thread, 64 bytes a row)
  {
    const int f = t >> 2, c = (t & 3) * 16;
    const uint4 v =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(f) * n_stride + n0 + c);
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

// Block b turns 64 rows of the int32 sums back: b < u_pad / 64 into yuT
// [64, u_pad], else into yiT [64, i_pad], converted to float32 on the way.
__global__ void __launch_bounds__(TURN_THREADS)
turn_out(const int* __restrict__ acc, float* __restrict__ yuT, float* __restrict__ yiT,
         int u_pad, int i_pad) {
  __shared__ float tile[TILE][D + 1];
  const int t = threadIdx.x;
  const int user_blocks = u_pad / TILE;
  const bool user = static_cast<int>(blockIdx.x) < user_blocks;
  float* dst = user ? yuT : yiT;
  const int n_stride = user ? u_pad : i_pad;
  const int n0 = (user ? blockIdx.x : blockIdx.x - user_blocks) * TILE;
  const int4* src =
      reinterpret_cast<const int4*>(acc + static_cast<long long>(blockIdx.x) * TILE * D);
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
  // write: feature f, 64 consecutive nodes, a warp 32 of them
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int idx = t + k * TURN_THREADS;
    const int f = idx >> 6, n = idx & 63;
    dst[static_cast<size_t>(f) * n_stride + n0 + n] = tile[n][f];
  }
}

}  // namespace

extern "C" {

// m int8 [u_pad, i_pad]; quT int8 [64, u_pad]; qiT int8 [64, i_pad]. yuT
// [64, u_pad] and yiT [64, i_pad] float32 receive the sums (no zeroing
// needed). q_scratch: int8 [(u_pad + i_pad) * 64]; acc_scratch: int32
// [(u_pad + i_pad) * 64], both 16-byte aligned. The wrapper checks
// i_pad % 256 == 0 and u_pad % 64 == 0. Three launches on the stream, no
// synchronisation. Returns cudaGetLastError().
int dual_int8_t(const void* m, const void* quT, const void* qiT, void* yuT, void* yiT,
                void* q_scratch, void* acc_scratch, int u_pad, int i_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_pad <= 0 || i_pad <= 0 || u_pad % TILE != 0 || i_pad % TILE != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int8_t* q = static_cast<int8_t*>(q_scratch);
  int* acc = static_cast<int*>(acc_scratch);
  const unsigned blocks = static_cast<unsigned>((u_pad + i_pad) / TILE);
  turn_in<<<blocks, TURN_THREADS, 0, s>>>(static_cast<const int8_t*>(quT),
                                          static_cast<const int8_t*>(qiT), q, acc, u_pad, i_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int passes = 0;
  err = launch_scan<false>(static_cast<const int8_t*>(m), q, q + static_cast<size_t>(u_pad) * D,
                           acc, acc + static_cast<size_t>(u_pad) * D, u_pad, i_pad, D, &passes,
                           s);
  if (err != cudaSuccess) return static_cast<int>(err);
  turn_out<<<blocks, TURN_THREADS, 0, s>>>(acc, static_cast<float*>(yuT),
                                           static_cast<float*>(yiT), u_pad, i_pad);
  return static_cast<int>(cudaGetLastError());
}

const char* dual_int8_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
