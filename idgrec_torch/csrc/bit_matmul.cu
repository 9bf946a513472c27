// K11 bit_matmul: one direction of the bit-packed binary adjacency product,
// bf16 activations, float32 accumulation, output in natural row order.
//
//   y[r, f] = sum_c bit(r, c) * x[c, f],    bit(r, c) = (packed[r / 8, c] >> (r % 8)) & 1
//
// Replaces idgrec_tpu/ops/bitmm.py _mm_kernel (l.94), launched by _bit_matmul
// (l.114); entry bit_adj_matmul, one launch per direction (M and M^T each
// have their own packing), whose backward is the same two launches on the
// swapped cotangents. The TPU kernel wrote the row-group layout
// [8, R_pad / 8, d] so that unpacked bit-planes line up with sublanes; here
// each lane takes its own bit of a byte, so the rows come out in natural
// order and no layout pass follows.
//
// Bound on the H100: bytes. The function needs one add per set bit and
// feature, 2 * nnz * d operations, far less than reading the
// R_pad * C_pad / 8 bytes of bits takes. This design multiplies every bit,
// zeros included (as the TPU kernel does): 2 * R_pad * C_pad * d bf16
// operations, 16 * d per byte of bits (1,024 at d = 64, against the card's
// ~295), so its own work is bound by operations, above the byte bound. So
// the tensor cores do the products even in this first version: 0/1 times a
// bf16 value is exact, which is what mma.sync m16n8k16 bf16 -> f32 computes.
// Skipping all-zero tiles is what would bring it toward the byte bound.
//
// Design:
// * Block (x, y) owns 128 output rows (16 packed rows) and feature group y
//   (DF = 64 features when d % 64 == 0, else 32, 16 or 8) and walks every
//   column in chunks of 128, in one fixed order. The chunk's packed bytes
//   (2 KB) and x rows ([128, DF] bf16) go through shared memory by cp.async,
//   three stages deep.
// * Each of the 4 warps owns 32 rows: two m16 tiles, four packed rows. Per
//   16-column step, lane (g, t) loads two 16-bit words of each packed row
//   (columns 2t, 2t + 1 and 2t + 8, 2t + 9: the A fragment's k slots), takes
//   bit g of each byte and multiplies the pair into two bf16 ones or zeros.
//   Rows g and g + 8 of an m tile are bit g of two consecutive packed rows.
//   B comes from the x chunk by ldmatrix.trans, shared by both m tiles.
// * The accumulators stay in registers and each output element is written
//   once: no atomics, so two launches give the same bits.
// * Skipping all-zero tiles would cut the work; that is later speed work.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 32;   // output rows per block
constexpr int PROWS = ROWS / 8;    // packed rows per block
constexpr int KC = 128;            // columns per stage
constexpr int STAGES = 3;
constexpr int P_BYTES = PROWS * KC;

// NT n8 tiles of features per block
template <int NT>
struct Geo {
  static constexpr int DF = 8 * NT;
  // a pitch of 16 * (NT + 1) bytes: the 8 rows an ldmatrix reads fall in
  // distinct banks for NT >= 2
  static constexpr int X_PITCH = DF + 8;
  static constexpr int STAGE_BYTES = P_BYTES + KC * X_PITCH * 2;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

// Bit g of the two bytes of w (the lower byte first) as a bf16 pair of ones
// and zeros, the lower byte in the lower half. 0x3F80 is bf16 1.0.
__device__ __forceinline__ uint32_t bit_pair(uint32_t w, int g) {
  const uint32_t b = (w >> g) & 0x0101u;
  return ((b & 1u) | ((b & 0x100u) << 8)) * 0x3F80u;
}

__device__ __forceinline__ uint32_t ld16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
bit_matmul_kernel(const int8_t* __restrict__ packed, const uint16_t* __restrict__ x,
                  float* __restrict__ y, int c_pad, int d) {
  using G = Geo<NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma threadID_in_group
  const int prow0 = blockIdx.x * PROWS;
  const int f0 = blockIdx.y * G::DF;
  const int chunks = c_pad / KC;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.0f;

  auto load = [&](int stage, int chunk) {
    unsigned char* ps = smem + stage * G::STAGE_BYTES;
    uint16_t* xs = reinterpret_cast<uint16_t*>(ps + P_BYTES);
    const int c0 = chunk * KC;
    for (int p = tid; p < P_BYTES / 16; p += THREADS) {
      const int r = p / (KC / 16), c = (p % (KC / 16)) * 16;
      cp_async16(ps + r * KC + c, packed + static_cast<size_t>(prow0 + r) * c_pad + c0 + c);
    }
    for (int p = tid; p < KC * NT; p += THREADS) {
      const int r = p / NT, c = (p % NT) * 8;
      cp_async16(xs + r * G::X_PITCH + c, x + static_cast<size_t>(c0 + r) * d + f0 + c);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }

  for (int it = 0; it < chunks; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this stage landed; every warp is done with the one reloaded next
    if (it + STAGES - 1 < chunks) load((it + STAGES - 1) % STAGES, it + STAGES - 1);
    cp_async_commit();

    const unsigned char* ps = smem + (it % STAGES) * G::STAGE_BYTES;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(ps + P_BYTES);
    // this warp's packed rows: 4 * warp + {0, 1} (m tile 0), + {2, 3} (m tile 1)
    const unsigned char* prow = ps + (4 * warp) * KC + 2 * t;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t b[NT][2];
      load_b<NT>(b, xs, G::X_PITCH, ks * 16, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const unsigned char* p0 = prow + (2 * mt) * KC + ks * 16;
        const uint32_t a0 = bit_pair(ld16(p0), g);
        const uint32_t a1 = bit_pair(ld16(p0 + KC), g);
        const uint32_t a2 = bit_pair(ld16(p0 + 8), g);
        const uint32_t a3 = bit_pair(ld16(p0 + KC + 8), g);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[mt][j], a0, a1, a2, a3, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // acc[mt][j]: rows mt * 16 + g (+ 8) of the warp, features j * 8 + 2t (+ 1)
  const size_t row0 = static_cast<size_t>(blockIdx.x) * ROWS + warp * 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float* dst = y + (row0 + mt * 16 + g) * d + f0 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(dst) = make_float2(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<float2*>(dst + 8 * static_cast<size_t>(d)) =
          make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  }
}

template <int NT>
cudaError_t launch(const int8_t* packed, const uint16_t* x, float* y, int r_pad, int c_pad,
                   int d, cudaStream_t s) {
  using G = Geo<NT>;
  cudaError_t err = cudaFuncSetAttribute(bit_matmul_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(r_pad / ROWS, d / G::DF);
  bit_matmul_kernel<NT><<<grid, THREADS, G::SMEM_BYTES, s>>>(packed, x, y, c_pad, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// packed int8 [r_pad / 8, c_pad]; x bf16 [c_pad, d]; y float32 [r_pad, d]
// receives every element. The wrapper checks r_pad % 128 == 0,
// c_pad % 128 == 0, d % 8 == 0, and that the tensors are contiguous and
// 16-byte aligned. Returns cudaGetLastError().
int bit_matmul(const void* packed, const void* x, void* y, int r_pad, int c_pad, int d,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const uint16_t* xp = static_cast<const uint16_t*>(x);
  float* yp = static_cast<float*>(y);
  cudaError_t err;
  if (d % 64 == 0) err = launch<8>(p, xp, yp, r_pad, c_pad, d, s);
  else if (d % 32 == 0) err = launch<4>(p, xp, yp, r_pad, c_pad, d, s);
  else if (d % 16 == 0) err = launch<2>(p, xp, yp, r_pad, c_pad, d, s);
  else err = launch<1>(p, xp, yp, r_pad, c_pad, d, s);
  return static_cast<int>(err);
}

const char* bit_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
