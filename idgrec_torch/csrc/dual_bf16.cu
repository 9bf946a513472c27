// K6 dual_bf16: both directions of the exact-mode adjacency product from one
// read of each tile of the int8 count matrix, bf16 activations in [N, d]
// layout, float32 accumulation.
//
//   yu[u, f] = sum_i M[u, i] * zi[i, f]      (M  @ zi, [U_pad, d])
//   yi[i, f] = sum_u M[u, i] * zu[u, f]      (M^T @ zu, [I_pad, d])
//
// Replaces idgrec_tpu/ops/fusedmm.py _fused_kernel (l.98, launched by
// _fused_call l.155); entry fused_adj_matmul (l.618), whose backward is this
// same kernel on the swapped cotangents. The TPU body kept the whole
// [I_pad, d] f32 yi accumulator in VMEM across a sequential grid; Hopper
// blocks run in no order and hold 227 KB.
//
// Bound on the H100: bytes. One sweep at d <= 64 reads M once (U_pad * I_pad
// bytes) against 4 * U_pad * I_pad * d bf16 operations (128 ops per byte at
// d = 64 against the card's ~295).
//
// Design: K1's block decomposition (dual_int8_t.cu), with two differences.
// * Block (x, y, z) owns column strip x (256 columns), the y-th even share of
//   the 64-row chunks and feature group z (64 features when d % 64 == 0, else
//   32). M streams through shared memory (cp.async); each byte is converted
//   to bf16 in registers (counts are exact in bf16) and feeds both products
//   as the B operand of mma.sync m16n8k16 bf16 with f32 accumulators. The
//   activations are transposed on their way into shared memory, so inside
//   the block the features are the mma's m dimension, as in K1. The k slots
//   of a fragment are permuted (a lane owns 4 consecutive k values), which
//   turns every operand load into one 32-bit or 64-bit shared-memory access;
//   a sum does not depend on the order of its k slots within one mma.
// * The cross-block reduction must give the same bits on every launch:
//   training promises that a resumed run equals a straight one. float
//   atomicAdd is not associative, so the order in which blocks arrive would
//   show. Each block's partial sum (f32, computed in a fixed order) is
//   therefore converted to 64-bit fixed point and added with integer
//   atomicAdd, which is order-free and exact. The scale is a power of two
//   taken from the largest |activation| (amax, computed by the wrapper on the
//   device): with amax < 2^e and row and column sums of M below 2^30, every
//   sum times 2^(31 - e) stays below 2^61, and the fixed-point step is below
//   amax * 2^-30, far under one f32 ulp of any sum that is not itself tiny
//   against amax. A second kernel converts the sums to float32.
// * All-zero tiles of M are skipped by warp-uniform votes on 16-byte loads,
//   taken before any fragment is gathered: the matrix is sparse, and a zero
//   count adds nothing. Non-finite activations are not multiplied by those
//   zeros, so the second kernel writes NaN everywhere when amax is not finite.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STRIP = WARPS * 32;      // columns of M per block
constexpr int CHUNK = 64;              // rows of M per stage (four mma k-steps)
constexpr int STAGES = 2;             // two stages and 128 registers: two blocks share an SM
constexpr int M_STRIDE = STRIP + 16;   // smem row pitch of M (bytes)
// bf16 row pitches whose byte size is 32 mod 128: the 64-bit fragment loads
// of a half warp (4 feature rows x 4 lanes) then fall into distinct banks
constexpr int ZI_PITCH = STRIP + 16;   // elements: 544 bytes
constexpr int ZU_PITCH = CHUNK + 16;   // elements: 160 bytes
constexpr int M_STAGE_BYTES = CHUNK * M_STRIDE;
constexpr int YU_PITCH = 8 + 1;        // words per feature row of a warp's yu tile
constexpr int MAX_SHIFT = 120;

// MT feature m-tiles of 16 per block
template <int MT>
struct Geo {
  static constexpr int DF = 16 * MT;
  static constexpr int ZU_STAGE_BYTES = DF * ZU_PITCH * 2;
  static constexpr int STAGE_BYTES = M_STAGE_BYTES + ZU_STAGE_BYTES;
  static constexpr int ZI_BYTES = DF * ZI_PITCH * 2;
  static constexpr int YU_BYTES = WARPS * DF * YU_PITCH * 4;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + ZI_BYTES + YU_BYTES;
  // 16-byte pieces (8 bf16) of a zu chunk per thread
  static constexpr int ZU_ITEMS = CHUNK * (DF / 8) / THREADS;
};

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four bytes of one column from four consecutive smem rows, low byte first.
__device__ __forceinline__ uint32_t column4(const int8_t* p) {
  return static_cast<uint32_t>(static_cast<uint8_t>(p[0])) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[M_STRIDE])) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[2 * M_STRIDE])) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[3 * M_STRIDE])) << 24);
}

// Two signed bytes of w (byte index lo, lo + 1) as a bf16 pair, the lower
// byte in the lower half: exact, |count| <= 128 fits bf16's 8 bits.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t w, int lo) {
  const float a = static_cast<float>(static_cast<int8_t>((w >> (8 * lo)) & 0xffu));
  const float b = static_cast<float>(static_cast<int8_t>((w >> (8 * lo + 8)) & 0xffu));
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The power of two 2^shift that scales a sum of activations bounded by amax
// into 64-bit fixed point: amax < 2^e gives shift = 31 - e.
__device__ __forceinline__ int fixed_shift(float amax) {
  if (!(amax > 0.0f) || !isfinite(amax)) return 0;
  int e;
  frexpf(amax, &e);
  const int shift = 31 - e;
  return shift > MAX_SHIFT ? MAX_SHIFT : shift;
}

__device__ __forceinline__ void add_fixed(unsigned long long* dst, float v, float scale) {
  if (v != 0.0f) atomicAdd(dst, static_cast<unsigned long long>(__float2ll_rn(v * scale)));
}

// The 8 bf16 of v become 8 consecutive rows (pitch elements apart) of one
// shared-memory column: the transpose of a 16-byte piece of an activation row.
__device__ __forceinline__ void store_column8(uint16_t* col, int pitch, const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    col[(2 * j) * pitch] = static_cast<uint16_t>(w[j] & 0xffffu);
    col[(2 * j + 1) * pitch] = static_cast<uint16_t>(w[j] >> 16);
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 2)
dual_bf16_kernel(const int8_t* __restrict__ m, const uint16_t* __restrict__ zu,
                 const uint16_t* __restrict__ zi, unsigned long long* __restrict__ yu,
                 unsigned long long* __restrict__ yi, const float* __restrict__ amax,
                 int u_pad, int i_pad, int d) {
  using G = Geo<MT>;
  constexpr int DF = G::DF;
  extern __shared__ __align__(16) unsigned char smem[];
  // transposed zi of the block's strip, [DF][ZI_PITCH] bf16
  uint16_t* zis = reinterpret_cast<uint16_t*>(smem + STAGES * G::STAGE_BYTES);
  // this warp's [DF features, 8 rows] yu tile, staged so that each atomic
  // instruction covers 32 contiguous features of one row
  float* yus = reinterpret_cast<float*>(smem + STAGES * G::STAGE_BYTES + G::ZI_BYTES) +
               (threadIdx.x >> 5) * DF * YU_PITCH;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma threadID_in_group
  const int col0 = blockIdx.x * STRIP;
  const int f0 = blockIdx.z * DF;
  const int chunks = u_pad / CHUNK;
  const int c_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * chunks / gridDim.y);
  const int n_chunks =
      static_cast<int>(static_cast<long long>(blockIdx.y + 1) * chunks / gridDim.y) - c_begin;
  // yu sums zi, yi sums zu: amax = (max |zu|, max |zi|)
  const float scale_u = ldexpf(1.0f, fixed_shift(amax[1]));
  const float scale_i = ldexpf(1.0f, fixed_shift(amax[0]));

  float acc_i[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_i[mt][nt][r] = 0.0f;

  auto load_m = [&](int stage, int chunk) {
    unsigned char* ms = smem + stage * G::STAGE_BYTES;
    const int r0 = chunk * CHUNK;
#pragma unroll
    for (int k = 0; k < CHUNK * STRIP / 16 / THREADS; ++k) {
      const int p = tid + k * THREADS;
      const int r = p / (STRIP / 16);
      const int c = (p % (STRIP / 16)) * 16;
      cp_async16(ms + r * M_STRIDE + c, m + static_cast<size_t>(r0 + r) * i_pad + col0 + c);
    }
  };
  // the zu chunk of a stage: CHUNK rows x DF / 8 pieces of 8 bf16; item
  // tid + k * THREADS -> (row, piece) with the rows fastest
  auto fetch_zu = [&](int chunk, uint4 (&v)[G::ZU_ITEMS]) {
#pragma unroll
    for (int k = 0; k < G::ZU_ITEMS; ++k) {
      const int id = tid + k * THREADS;
      v[k] = __ldg(reinterpret_cast<const uint4*>(
          zu + static_cast<size_t>(chunk * CHUNK + id % CHUNK) * d + f0 + 8 * (id / CHUNK)));
    }
  };
  auto store_zu = [&](int stage, const uint4 (&v)[G::ZU_ITEMS]) {
    uint16_t* zs = reinterpret_cast<uint16_t*>(smem + stage * G::STAGE_BYTES + M_STAGE_BYTES);
#pragma unroll
    for (int k = 0; k < G::ZU_ITEMS; ++k) {
      const int id = tid + k * THREADS;
      store_column8(zs + (8 * (id / CHUNK)) * ZU_PITCH + id % CHUNK, ZU_PITCH, v[k]);
    }
  };

  // zi [STRIP, DF] of the strip into shared memory as [DF, STRIP]: thread c
  // owns column col0 + c. The first barrier of the loop publishes it.
  {
    const uint16_t* src = zi + static_cast<size_t>(col0 + tid) * d + f0;
#pragma unroll
    for (int p = 0; p < DF / 8; ++p) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + 8 * p));
      store_column8(zis + (8 * p) * ZI_PITCH + tid, ZI_PITCH, v);
    }
  }
  uint4 z_next[G::ZU_ITEMS];
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) {
      load_m(s, c_begin + s);
      fetch_zu(c_begin + s, z_next);
      store_zu(s, z_next);
    }
    cp_async_commit();
  }

  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this stage landed; every warp is done with the last
    const int next = it + STAGES - 1;
    const bool have_next = next < n_chunks;
    if (have_next) {
      load_m(next % STAGES, c_begin + next);
      fetch_zu(c_begin + next, z_next);
    }
    cp_async_commit();

    const int8_t* ms = reinterpret_cast<const int8_t*>(smem + (it % STAGES) * G::STAGE_BYTES);
    const uint16_t* zs = reinterpret_cast<const uint16_t*>(ms + M_STAGE_BYTES);
    const int r0 = (c_begin + it) * CHUNK;

    // ---- yu for this warp's 8 chunk rows (the mma's n) and all feature
    // m-tiles; k runs over the strip's columns, 16 per step. Lane (g, t)
    // holds row g's counts of columns 4 t .. 4 t + 3 of the step as B, and
    // the same four columns of zi's feature rows g and g + 8 as A.
    {
      float acc_u[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc_u[mt][r] = 0.0f;
      // which 16-column groups of the warp's rows hold a non-zero (bit ks):
      // lane l reads row warp * 8 + l / 4, columns 64 * (l % 4) .. + 63
      unsigned tiles = 0;
      {
        const uint4* row = reinterpret_cast<const uint4*>(
            ms + (warp * 8 + (lane >> 2)) * M_STRIDE + (lane & 3) * 64);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint4 v = row[j];
          const unsigned b = __ballot_sync(0xffffffffu, (v.x | v.y | v.z | v.w) != 0u);
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            if (b & (0x11111111u << qq)) tiles |= 1u << (4 * qq + j);
        }
      }
      const int8_t* mrow = ms + (warp * 8 + g) * M_STRIDE + 4 * t;
      const uint16_t* arow = zis + g * ZI_PITCH + 4 * t;
#pragma unroll
      for (int ks = 0; ks < STRIP / 16; ++ks) {
        if (!((tiles >> ks) & 1u)) continue;  // an all-zero tile adds nothing
        const uint32_t w = ld32(mrow + ks * 16);
        const uint32_t b0 = bf16_pair(w, 0), b1 = bf16_pair(w, 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint2 lo = *reinterpret_cast<const uint2*>(arow + (mt * 16) * ZI_PITCH + ks * 16);
          const uint2 hi =
              *reinterpret_cast<const uint2*>(arow + (mt * 16 + 8) * ZI_PITCH + ks * 16);
          mma_bf16(acc_u[mt], lo.x, hi.x, lo.y, hi.y, b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* row = yus + (mt * 16 + g) * YU_PITCH + 2 * t;
        row[0] = acc_u[mt][0];
        row[1] = acc_u[mt][1];
        row[8 * YU_PITCH] = acc_u[mt][2];
        row[8 * YU_PITCH + 1] = acc_u[mt][3];
      }
      __syncwarp();
#pragma unroll
      for (int uu = 0; uu < 8; ++uu) {
        unsigned long long* dst = yu + static_cast<size_t>(r0 + warp * 8 + uu) * d + f0;
#pragma unroll
        for (int k = 0; k < DF / 32; ++k) {
          const int f = lane + 32 * k;
          add_fixed(dst + f, yus[f * YU_PITCH + uu], scale_u);
        }
      }
      __syncwarp();
    }

    // ---- yi += zu[chunk rows]^T . M[chunk rows, strip]: the warp owns 32
    // columns (four n-tiles), k runs over the chunk's rows, 16 per step. Lane
    // (g, t) gathers column g's counts of rows 4 t .. 4 t + 3 of the step, for
    // the tiles that hold a non-zero.
#pragma unroll
    for (int kk = 0; kk < CHUNK / 16; ++kk) {
      // which of the warp's four 16x8 tiles of M hold a non-zero: lane l reads
      // row kk * 16 + l % 16, columns 16 * (l / 16) .. + 15 of the warp's 32
      const uint4 v = *reinterpret_cast<const uint4*>(
          ms + (kk * 16 + (lane & 15)) * M_STRIDE + warp * 32 + (lane >> 4) * 16);
      const unsigned b_lo = __ballot_sync(0xffffffffu, (v.x | v.y) != 0u);
      const unsigned b_hi = __ballot_sync(0xffffffffu, (v.z | v.w) != 0u);
      const unsigned nz = ((b_lo & 0xffffu) ? 1u : 0u) | ((b_hi & 0xffffu) ? 2u : 0u) |
                          ((b_lo >> 16) ? 4u : 0u) | ((b_hi >> 16) ? 8u : 0u);
      if (nz == 0) continue;
      uint2 lo[MT], hi[MT];
      const uint16_t* zrow = zs + g * ZU_PITCH + kk * 16 + 4 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        lo[mt] = *reinterpret_cast<const uint2*>(zrow + (mt * 16) * ZU_PITCH);
        hi[mt] = *reinterpret_cast<const uint2*>(zrow + (mt * 16 + 8) * ZU_PITCH);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (!((nz >> nt) & 1u)) continue;
        const uint32_t w = column4(ms + (kk * 16 + 4 * t) * M_STRIDE + warp * 32 + nt * 8 + g);
        const uint32_t b0 = bf16_pair(w, 0), b1 = bf16_pair(w, 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16(acc_i[mt][nt], lo[mt].x, hi[mt].x, lo[mt].y, hi[mt].y, b0, b1);
      }
    }

    // the next stage's zu chunk, transposed into its buffer: every warp left
    // that buffer before this iteration's barrier
    if (have_next) store_zu(next % STAGES, z_next);
  }
  cp_async_wait<0>();

  // acc_i[mt][nt]: features mt * 16 + g (+ 8), columns nt * 8 + 2 t (+ 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = col0 + warp * 32 + nt * 8 + 2 * t;
      unsigned long long* dst = yi + static_cast<size_t>(i) * d + f0 + mt * 16 + g;
      add_fixed(dst, acc_i[mt][nt][0], scale_i);
      add_fixed(dst + d, acc_i[mt][nt][1], scale_i);
      add_fixed(dst + 8, acc_i[mt][nt][2], scale_i);
      add_fixed(dst + d + 8, acc_i[mt][nt][3], scale_i);
    }
  }
}

// out[i] = acc[i] * 2^-shift as float32; NaN when the activations were not
// finite.
__global__ void fixed_to_float(const long long* __restrict__ acc, float* __restrict__ out,
                               long long n, const float* __restrict__ amax) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = *amax;
  out[i] = isfinite(a) ? static_cast<float>(ldexp(static_cast<double>(acc[i]), -fixed_shift(a)))
                       : nanf("");
}

template <int MT>
cudaError_t launch(const int8_t* m, const uint16_t* zu, const uint16_t* zi,
                   unsigned long long* yu, unsigned long long* yi, const float* amax,
                   int u_pad, int i_pad, int d, cudaStream_t s) {
  using G = Geo<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      dual_bf16_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dual_bf16_kernel<MT>, THREADS, G::SMEM_BYTES)) != cudaSuccess)
    return err;
  // Row splits: each split adds one flush of yi per strip (atomics), so take
  // the fewest in 4..16 whose grid best fills its last wave. The choice
  // depends on the shapes and the card alone, so it is the same on every
  // launch.
  const int groups = d / G::DF;
  const int strips = i_pad / STRIP, chunks = u_pad / CHUNK;
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  int splits = 1;
  double best = -1.0;
  for (int r = 4; r <= 16 && r <= chunks; ++r) {
    const long long blocks = static_cast<long long>(strips) * r * groups;
    const double fill = static_cast<double>(blocks) / (((blocks + slots - 1) / slots) * slots);
    if (fill > best + 1e-9) { best = fill; splits = r; }
  }
  dim3 grid(strips, splits, groups);
  dual_bf16_kernel<MT><<<grid, THREADS, G::SMEM_BYTES, s>>>(m, zu, zi, yu, yi, amax, u_pad,
                                                             i_pad, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// m int8 [u_pad, i_pad]; zu bf16 [u_pad, d]; zi bf16 [i_pad, d]; amax float32
// [2] = (max |zu|, max |zi|) on the device. acc_u [u_pad, d] and acc_i
// [i_pad, d] are zeroed int64 scratch; yu [u_pad, d] and yi [i_pad, d]
// receive the float32 sums. The wrapper checks d % 32 == 0, i_pad % 256 == 0,
// u_pad % 64 == 0 and u_pad, i_pad <= 2^23. Returns cudaGetLastError().
int dual_bf16(const void* m, const void* zu, const void* zi, const void* amax, void* acc_u,
              void* acc_i, void* yu, void* yi, int u_pad, int i_pad, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* mp = static_cast<const int8_t*>(m);
  const uint16_t* zup = static_cast<const uint16_t*>(zu);
  const uint16_t* zip = static_cast<const uint16_t*>(zi);
  const float* ap = static_cast<const float*>(amax);
  unsigned long long* au = static_cast<unsigned long long*>(acc_u);
  unsigned long long* ai = static_cast<unsigned long long*>(acc_i);
  cudaError_t err = (d % 64 == 0) ? launch<4>(mp, zup, zip, au, ai, ap, u_pad, i_pad, d, s)
                                  : launch<2>(mp, zup, zip, au, ai, ap, u_pad, i_pad, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nu = static_cast<long long>(d) * u_pad;
  const long long ni = static_cast<long long>(d) * i_pad;
  fixed_to_float<<<static_cast<unsigned>((nu + 255) / 256), 256, 0, s>>>(
      static_cast<const long long*>(acc_u), static_cast<float*>(yu), nu, ap + 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixed_to_float<<<static_cast<unsigned>((ni + 255) / 256), 256, 0, s>>>(
      static_cast<const long long*>(acc_i), static_cast<float*>(yi), ni, ap);
  return static_cast<int>(cudaGetLastError());
}

const char* dual_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
