// K8 dual_int4_n: both directions of the adjacency product from one read of
// the nibble-packed count matrix, activations int8 in the [N, d] layout of
// the per-application product.
//
//   yu[u, f] = sum_c M[u, c] * qi[c, f]      (M  @ qi, [U_pad, d])
//   yi[c, f] = sum_u M[u, c] * qu[u, f]      (M^T @ qu, [I_pad, d])
//
// M [U_pad, I_pad] holds counts 0..15 and is stored packed as m4
// [U_pad, I_pad / 2]: within each tile of 2048 logical columns, byte p
// (0..1023) of the tile holds column p in its low nibble and column 1024 + p
// in its high nibble (ops/fusedmm.py pack_nibbles).
//
// Replaces idgrec_tpu/ops/fusedmm.py _fused_kernel_int4_small (l.442,
// launched by _fused_int4_small_call l.486) and _fused_kernel_int4 (l.519,
// launched at l.578); entry fused_adj_matmul_int4 (l.561). Its raw sums equal
// K5's (dual_int4_t.cu) on the transposed activations, and K7's
// (dual_int8_n.cu) on the unpacked matrix, bit for bit.
//
// Bound on the H100: bytes. One sweep at d <= 64 reads m4 once
// (U_pad * I_pad / 2 bytes) against 4 * U_pad * I_pad * d int8 operations.
//
// Design: K5's, with K7's layout change on the way through shared memory.
// * Block (x, y, z) owns packed strip x (128 byte columns of one tile, so two
//   spans of 128 logical columns, 1024 apart), the y-th even share of the
//   64-row chunks and feature group z: 64 features when d % 64 == 0, else 32
//   (d % 32 == 0). A wider d reads m4 once per feature group.
// * The products run in K5's orientation (features are the mma's m
//   dimension): qi of both spans and each chunk of qu are transposed while
//   they are written to shared memory, 16 bytes of an activation row into 16
//   bytes of a shared column; a later stage's qu chunk is fetched into
//   registers before the current chunk's products and stored after them.
// * Each 32-bit word of packed bytes is unpacked in registers
//   (w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F, unsigned) into two s8 operands of
//   mma.sync m16n8k32: one read feeds four products. Tiles whose nibbles are
//   all zero are skipped (warp-uniform votes on low and high nibbles apart).
// * Cross-block sums are int32 atomicAdd into the zeroed outputs the wrapper
//   allocates (order-free, exact); the staged yu tile is sent with the
//   features contiguous, 32 features of one row per instruction.
// * A second kernel converts the int32 sums to float32 in place, once: exact
//   while every sum stays below 2^24.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PSTRIP = WARPS * 16;     // packed byte columns of m4 per block
constexpr int SPAN = PSTRIP;           // logical columns per nibble span
constexpr int HALF_TILE = 1024;        // packed bytes per tile = distance of the spans
constexpr int CHUNK = 64;              // rows of M per stage (two mma k-steps)
constexpr int STAGES = 4;
constexpr int M_STRIDE = PSTRIP + 16;  // smem row pitch (bytes) of a packed chunk
constexpr int Q_STRIDE = CHUNK + 16;   // smem row pitch of the transposed qu chunk
constexpr int QI_STRIDE = 2 * SPAN + 16;  // smem row pitch of the transposed qi (both spans)
constexpr int M_STAGE_BYTES = CHUNK * M_STRIDE;
constexpr int YU_PITCH = 8 + 1;        // words per feature row of a warp's yu tile
constexpr uint32_t LO = 0x0F0F0F0Fu;
constexpr uint32_t HI = 0xF0F0F0F0u;

// MT feature m-tiles of 16 per block
template <int MT>
struct Geo {
  static constexpr int DF = 16 * MT;
  static constexpr int Q_STAGE_BYTES = DF * Q_STRIDE;
  static constexpr int STAGE_BYTES = M_STAGE_BYTES + Q_STAGE_BYTES;
  static constexpr int QI_BYTES = DF * QI_STRIDE;
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
dual_int4_n_kernel(const int8_t* __restrict__ m4, const int8_t* __restrict__ qu,
                   const int8_t* __restrict__ qi, int* __restrict__ yu,
                   int* __restrict__ yi, int u_pad, int i_pad, int d) {
  using G = Geo<MT>;
  constexpr int DF = G::DF;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* qis = smem + STAGES * G::STAGE_BYTES;  // transposed qi of the block's two spans
  // this warp's [DF features, 8 rows] yu tile, staged so that each atomic
  // instruction covers 32 contiguous features of one row
  int* yus = reinterpret_cast<int*>(qis + G::QI_BYTES) + (threadIdx.x >> 5) * DF * YU_PITCH;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma threadID_in_group
  // Packed byte column pcol0 lies in tile pcol0 / 1024 at offset
  // pcol0 % 1024; its nibbles are logical columns lo0 + j and hi0 + j.
  const int m_cols = i_pad / 2;
  const int pcol0 = blockIdx.x * PSTRIP;
  const int lo0 = (pcol0 / HALF_TILE) * (2 * HALF_TILE) + pcol0 % HALF_TILE;
  const int hi0 = lo0 + HALF_TILE;
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

  // yi product role: packed byte columns [warp * 16, warp * 16 + 16) of the
  // strip; n-tile nt = 2 * pt + span covers the 8 logical columns of packed
  // tile pt (0, 1) in span 0 (low nibbles) or 1 (high nibbles).
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
    // packed chunk: CHUNK rows x PSTRIP bytes = 512 16-byte pieces.
#pragma unroll
    for (int k = 0; k < CHUNK * PSTRIP / 16 / THREADS; ++k) {
      const int p = tid + k * THREADS;
      const int r = p / (PSTRIP / 16);
      const int c = (p % (PSTRIP / 16)) * 16;
      cp_async16(ms + r * M_STRIDE + c, m4 + static_cast<size_t>(r0 + r) * m_cols + pcol0 + c);
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

  // qi of the two spans into shared memory as [DF, SPAN | SPAN]: thread c
  // owns logical column lo0 + c (c < SPAN) or hi0 + c - SPAN. The first
  // barrier of the loop publishes it.
  {
    const int col = tid < SPAN ? lo0 + tid : hi0 + (tid - SPAN);
    const int8_t* src = qi + static_cast<size_t>(col) * d + f0;
#pragma unroll
    for (int p = 0; p < DF / 16; ++p) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + 16 * p));
      store_column16(qis + (16 * p) * QI_STRIDE + tid, QI_STRIDE, v);
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
    // over the strip's two spans.
    {
      int acc_u[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
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
        if (bits == 0) continue;  // an all-zero tile adds nothing
        const uint32_t w0 = ld32(mrow + ks * 32), w1 = ld32(mrow + ks * 32 + 16);
        if (bits & 1u) {
          const uint32_t b0 = w0 & LO, b1 = w1 & LO;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a1[4];
            ldmatrix_x4(a1, arow + mt * 16 * QI_STRIDE + ks * 32);
            mma_s8(acc_u[mt], a1, b0, b1);
          }
        }
        if (bits & 2u) {
          const uint32_t b0 = (w0 >> 4) & LO, b1 = (w1 >> 4) & LO;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a1[4];
            ldmatrix_x4(a1, arow + mt * 16 * QI_STRIDE + SPAN + ks * 32);
            mma_s8(acc_u[mt], a1, b0, b1);
          }
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

    // ---- yi += qu[chunk rows]^T . M[chunk rows, both spans], two k-steps.
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
      uint32_t a2[MT][4];
      const int8_t* qrow = qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * Q_STRIDE + kk * 32 +
                           (lane >> 4) * 16;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a2[mt], qrow + mt * 16 * Q_STRIDE);
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
          for (int mt = 0; mt < MT; ++mt) mma_s8(acc_i[mt][2 * pt], a2[mt], b0, b1);
        }
        if ((nz >> (2 * pt + 1)) & 1u) {
          const uint32_t b0 = (w0 >> 4) & LO, b1 = (w1 >> 4) & LO;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_s8(acc_i[mt][2 * pt + 1], a2[mt], b0, b1);
        }
      }
    }

    // the next stage's qu chunk, transposed into its buffer: every warp left
    // that buffer before this iteration's barrier
    if (have_next && q_active) store_q(next % STAGES, q_next);
  }
  cp_async_wait<0>();

  // acc_i[mt][nt]: features mt * 16 + g (+ 8); logical columns of span nt & 1,
  // packed tile nt >> 1, offsets 2 t (+ 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = ((nt & 1) ? hi0 : lo0) + warp * 16 + (nt >> 1) * 8 + 2 * t;
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
cudaError_t launch(const int8_t* m4, const int8_t* qu, const int8_t* qi, int* yu, int* yi,
                   int u_pad, int i_pad, int d, cudaStream_t s) {
  using G = Geo<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      dual_int4_n_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dual_int4_n_kernel<MT>, THREADS, G::SMEM_BYTES)) != cudaSuccess)
    return err;
  // Row splits: each split adds one flush of yi per strip (atomics), so take
  // the fewest in 4..16 whose grid best fills its last wave.
  const int groups = d / G::DF;
  const int strips = i_pad / 2 / PSTRIP, chunks = u_pad / CHUNK;
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  int splits = 1;
  double best = -1.0;
  for (int r = 4; r <= 16 && r <= chunks; ++r) {
    const long long blocks = static_cast<long long>(strips) * r * groups;
    const double fill = static_cast<double>(blocks) / (((blocks + slots - 1) / slots) * slots);
    if (fill > best + 1e-9) { best = fill; splits = r; }
  }
  dim3 grid(strips, splits, groups);
  dual_int4_n_kernel<MT><<<grid, THREADS, G::SMEM_BYTES, s>>>(m4, qu, qi, yu, yi, u_pad, i_pad, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// m4 is the packed matrix [u_pad, i_pad / 2]; qu int8 [u_pad, d]; qi int8
// [i_pad, d]. yu [u_pad, d] and yi [i_pad, d] must be zeroed int32 buffers; on
// return they hold the float32 sums (bit-cast in place). The wrapper checks
// d % 32 == 0, i_pad % 2048 == 0 and u_pad % 64 == 0. Returns
// cudaGetLastError().
int dual_int4_n(const void* m4, const void* qu, const void* qi, void* yu, void* yi,
                int u_pad, int i_pad, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* mp = static_cast<const int8_t*>(m4);
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

const char* dual_int4_n_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
