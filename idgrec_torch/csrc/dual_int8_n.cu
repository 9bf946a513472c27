// K7 dual_int8_n: both directions of the int8 adjacency product from one
// read of each M tile, activations in the [N, d] layout of the
// per-application product.
//
//   yu[u, f] = sum_i M[u, i] * qi[i, f]      (M  @ qi, [U_pad, d])
//   yi[i, f] = sum_u M[u, i] * qu[u, f]      (M^T @ qu, [I_pad, d])
//
// Replaces idgrec_tpu/ops/fusedmm.py _fused_kernel_int8_small (l.211,
// launched by _fused_small_call l.250) and _fused_kernel_int8 (l.283,
// launched at l.345); entry fused_adj_matmul_int8 (l.320). The TPU needed a
// single-panel and a panelized body because its yi or yu accumulator had to
// fit VMEM; here one kernel covers both. Its raw sums equal K1's
// (dual_int8_t.cu) on the transposed activations bit for bit: the same
// integer products, and integer addition is associative.
//
// Bound on the H100: bytes. One sweep at d <= 64 reads M once (U_pad * I_pad
// bytes) against 4 * U_pad * I_pad * d int8 operations.
//
// Design: K1's, with the layout change done on the way through shared memory.
// * Block (x, y, z) owns column strip x (256 columns), the y-th even share of
//   the 64-row chunks and feature group z: 64 features when d % 64 == 0, else
//   32 (d % 32 == 0). A wider d reads M once per feature group.
// * Inside the block the products run in K1's orientation (features are the
//   mma's m dimension), so qi's strip and each chunk of qu are transposed
//   while they are written to shared memory: a thread reads 16 bytes of one
//   activation row and stores them as 16 bytes of one shared column. The qu
//   chunk of a later stage is fetched into registers before the current
//   chunk's products and stored after them, so its latency is hidden.
// * M streams through shared memory (cp.async, STAGES deep); both products
//   run as mma.sync m16n8k32 s8*s8->s32; all-zero tiles of M are skipped
//   (warp-uniform votes), as in K1.
// * Cross-block sums are int32 atomicAdd into the zeroed int32 outputs the
//   wrapper allocates (order-free, exact). The staged yu tile is sent with
//   the features contiguous: one atomic instruction covers 32 features of one
//   row (4 sectors).
// * A second kernel converts the int32 sums to float32 in place, once: exact
//   while every sum stays below 2^24 (degree * 127 * count; the wrapper's
//   docstring states it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STRIP = WARPS * 32;      // columns of M per block
constexpr int CHUNK = 64;              // rows of M per stage (two mma k-steps)
constexpr int STAGES = 3;
constexpr int M_STRIDE = STRIP + 16;   // smem row pitch (bytes), skews banks
constexpr int Q_STRIDE = CHUNK + 16;   // smem row pitch of the transposed qu chunk
constexpr int M_STAGE_BYTES = CHUNK * M_STRIDE;
constexpr int YU_PITCH = 8 + 1;        // words per feature row of a warp's yu tile

// MT feature m-tiles of 16 per block
template <int MT>
struct Geo {
  static constexpr int DF = 16 * MT;
  static constexpr int Q_STAGE_BYTES = DF * Q_STRIDE;
  static constexpr int STAGE_BYTES = M_STAGE_BYTES + Q_STAGE_BYTES;
  static constexpr int QI_BYTES = DF * M_STRIDE;   // transposed qi of one strip
  static constexpr int YU_BYTES = WARPS * DF * YU_PITCH * 4;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + QI_BYTES + YU_BYTES;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory: for int8 data, exactly the
// A fragment of mma m16n8k32 when lane l points at row (l & 7) + 8 * ((l >> 3) & 1)
// of the 16-row tile, byte offset 16 * (l >> 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// The 16 bytes of v become 16 consecutive rows (pitch bytes apart) of one
// shared-memory column: the transpose of a 16-byte piece of an activation row.
__device__ __forceinline__ void store_column16(int8_t* col, int pitch, const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    col[j * pitch] = static_cast<int8_t>((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 2)
dual_int8_n_kernel(const int8_t* __restrict__ m, const int8_t* __restrict__ qu,
                   const int8_t* __restrict__ qi, int* __restrict__ yu,
                   int* __restrict__ yi, int u_pad, int i_pad, int d) {
  using G = Geo<MT>;
  constexpr int DF = G::DF;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* qis = smem + STAGES * G::STAGE_BYTES;  // transposed qi of the block's strip
  // this warp's [DF features, 8 rows] yu tile, staged so that each atomic
  // instruction covers 32 contiguous features of one row
  int* yus = reinterpret_cast<int*>(qis + G::QI_BYTES) + (threadIdx.x >> 5) * DF * YU_PITCH;

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

  // the qu chunk of a stage: CHUNK rows x DF / 16 pieces of 16 bytes, at most
  // one per thread; thread -> (row, piece) with the rows fastest
  const bool q_active = tid < CHUNK * (DF / 16);
  const int q_row = tid % CHUNK;
  const int q_piece = tid / CHUNK;

  int acc_i[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_i[mt][nt][r] = 0;

  auto load_m = [&](int stage, int chunk) {
    int8_t* ms = smem + stage * G::STAGE_BYTES;
    const int r0 = chunk * CHUNK;
#pragma unroll
    for (int k = 0; k < CHUNK * STRIP / 16 / THREADS; ++k) {
      const int p = tid + k * THREADS;
      const int r = p / (STRIP / 16);
      const int c = (p % (STRIP / 16)) * 16;
      cp_async16(ms + r * M_STRIDE + c, m + static_cast<size_t>(r0 + r) * i_pad + col0 + c);
    }
  };
  auto fetch_q = [&](int chunk) {
    return __ldg(reinterpret_cast<const uint4*>(
        qu + static_cast<size_t>(chunk * CHUNK + q_row) * d + f0 + 16 * q_piece));
  };
  auto store_q = [&](int stage, const uint4& v) {
    int8_t* qs = smem + stage * G::STAGE_BYTES + M_STAGE_BYTES;
    store_column16(qs + (16 * q_piece) * Q_STRIDE + q_row, Q_STRIDE, v);
  };

  // qi [STRIP, DF] of the strip into shared memory as [DF, STRIP]: thread c
  // owns column col0 + c. The first barrier of the loop publishes it.
  {
    const int8_t* src = qi + static_cast<size_t>(col0 + tid) * d + f0;
#pragma unroll
    for (int p = 0; p < DF / 16; ++p) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + 16 * p));
      store_column16(qis + (16 * p) * M_STRIDE + tid, M_STRIDE, v);
    }
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) {
      load_m(s, c_begin + s);
      if (q_active) store_q(s, fetch_q(c_begin + s));
    }
    cp_async_commit();
  }

  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this stage landed; every warp is done with the last
    const int next = it + STAGES - 1;
    const bool have_next = next < n_chunks;
    uint4 q_next = make_uint4(0u, 0u, 0u, 0u);
    if (have_next) {
      load_m(next % STAGES, c_begin + next);
      if (q_active) q_next = fetch_q(c_begin + next);
    }
    cp_async_commit();

    const int8_t* ms = smem + (it % STAGES) * G::STAGE_BYTES;
    const int8_t* qs = ms + M_STAGE_BYTES;
    const int r0 = (c_begin + it) * CHUNK;

    // ---- yu for this warp's 8 chunk rows and all feature m-tiles: k runs
    // over the strip's columns.
    {
      int acc_u[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
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
        if (!((tiles >> ks) & 1u)) continue;  // an all-zero tile adds nothing
        const uint32_t b0 = ld32(mrow + ks * 32), b1 = ld32(mrow + ks * 32 + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a1[4];
          ldmatrix_x4(a1, arow + mt * 16 * M_STRIDE + ks * 32);
          mma_s8(acc_u[mt], a1, b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        int* row = yus + (mt * 16 + g) * YU_PITCH + 2 * t;
        row[0] = acc_u[mt][0];
        row[1] = acc_u[mt][1];
        row[8 * YU_PITCH] = acc_u[mt][2];
        row[8 * YU_PITCH + 1] = acc_u[mt][3];
      }
      __syncwarp();
#pragma unroll
      for (int uu = 0; uu < 8; ++uu) {
        int* dst = yu + static_cast<size_t>(r0 + warp * 8 + uu) * d + f0;
#pragma unroll
        for (int k = 0; k < DF / 32; ++k) {
          const int f = lane + 32 * k;
          add_nonzero(dst + f, yus[f * YU_PITCH + uu]);
        }
      }
      __syncwarp();
    }

    // ---- yi += qu[chunk rows]^T . M[chunk rows, strip], two k-steps.
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
      uint32_t a2[MT][4];
      const int8_t* qrow = qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * Q_STRIDE + kk * 32 +
                           (lane >> 4) * 16;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a2[mt], qrow + mt * 16 * Q_STRIDE);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (!((nz >> nt) & 1u)) continue;  // all-zero tile: nothing to add
        const int8_t* mcol = ms + (kk * 32 + t * 4) * M_STRIDE + warp * 32 + nt * 8 + g;
        const uint32_t b0 = column4(mcol);
        const uint32_t b1 = column4(mcol + 16 * M_STRIDE);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc_i[mt][nt], a2[mt], b0, b1);
      }
    }

    // the next stage's qu chunk, transposed into its buffer: every warp left
    // that buffer before this iteration's barrier
    if (have_next && q_active) store_q(next % STAGES, q_next);
  }
  cp_async_wait<0>();

  // acc_i[mt][nt]: features mt * 16 + g (+ 8), columns nt * 8 + 2 t (+ 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = col0 + warp * 32 + nt * 8 + 2 * t;
      int* dst = yi + static_cast<size_t>(i) * d + f0 + mt * 16 + g;
      add_nonzero(dst, acc_i[mt][nt][0]);
      add_nonzero(dst + d, acc_i[mt][nt][1]);
      add_nonzero(dst + 8, acc_i[mt][nt][2]);
      add_nonzero(dst + d + 8, acc_i[mt][nt][3]);
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

template <int MT>
cudaError_t launch(const int8_t* m, const int8_t* qu, const int8_t* qi, int* yu, int* yi,
                   int u_pad, int i_pad, int d, cudaStream_t s) {
  using G = Geo<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      dual_int8_n_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dual_int8_n_kernel<MT>, THREADS, G::SMEM_BYTES)) != cudaSuccess)
    return err;
  // Row splits: each split adds one flush of yi per strip (atomics), so take
  // the fewest in 4..16 whose grid best fills its last wave.
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
  dual_int8_n_kernel<MT><<<grid, THREADS, G::SMEM_BYTES, s>>>(m, qu, qi, yu, yi, u_pad, i_pad, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// m int8 [u_pad, i_pad]; qu int8 [u_pad, d]; qi int8 [i_pad, d]. yu [u_pad, d]
// and yi [i_pad, d] must be zeroed int32 buffers; on return they hold the
// float32 sums (bit-cast in place). The wrapper checks d % 32 == 0,
// i_pad % 256 == 0 and u_pad % 64 == 0. Returns cudaGetLastError().
int dual_int8_n(const void* m, const void* qu, const void* qi, void* yu, void* yi,
                int u_pad, int i_pad, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* mp = static_cast<const int8_t*>(m);
  const int8_t* qup = static_cast<const int8_t*>(qu);
  const int8_t* qip = static_cast<const int8_t*>(qi);
  int* yup = static_cast<int*>(yu);
  int* yip = static_cast<int*>(yi);
  cudaError_t err = (d % 64 == 0) ? launch<4>(mp, qup, qip, yup, yip, u_pad, i_pad, d, s)
                                  : launch<2>(mp, qup, qip, yup, yip, u_pad, i_pad, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nu = static_cast<long long>(d) * u_pad;
  const long long ni = static_cast<long long>(d) * i_pad;
  int32_to_float_inplace<<<static_cast<unsigned>((nu + 255) / 256), 256, 0, s>>>(yup, nu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int32_to_float_inplace<<<static_cast<unsigned>((ni + 255) / 256), 256, 0, s>>>(yip, ni);
  return static_cast<int>(cudaGetLastError());
}

const char* dual_int8_n_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
