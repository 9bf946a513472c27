// K4 scatter_add_rows: the batch row scatter behind the gradient of the
// batch-embedding gathers.
//
//   out[n_rows, d] f32 = sum_b onehot(idx[b]) * vals[b]     idx [B], vals [B, d]
//
// Rows that no idx names are zero. Duplicates of a row are added in batch
// order, ((0 + v_b0) + v_b1) + ..., the order of np.add.at on a zeroed table.
//
// Replaces idgrec_tpu/ops/scatter.py _scatter_kernel (l.40), launched by
// scatter_add_rows (l.58). The TPU kernel kept the whole table in VMEM and
// walked the batch in a sequential loop on one core; that loop is what fixed
// the order of the sums. A Hopper block holds 227 KB and blocks run in no
// order, and float atomicAdd would make the sums differ from run to run.
//
// Bound on the H100: bytes (the table written once, vals and idx read once);
// no tensor cores. A training step's tables are 8-10 MB, a few microseconds
// of HBM time, so what costs is fixed work per launch and any serial chain
// of dependent loads.
//
// Design: linear work, batch order kept, no float atomics, no memset of the
// table. One call of the C entry takes one table and issues a memset of the
// scratch's counts (4 bytes a row: on an H100 a step's two tables took
// 0.0364 ms of device time so, against 0.0401 with the link kernel's one
// block zeroing them; scripts/torch_k7_ablation.py, graph replay) and two
// kernels:
// 1. link_kernel, one block of 1024 threads (four entries a thread a round;
//    a training batch is one round, kept in registers), passes over the
//    batch separated by barriers:
//    (a) slot = atomicAdd(&cnt[row], 1): each entry's place in its row;
//    (b) the entry in slot 0 (the row's owner) reads the row's count; a
//        single entry writes its batch index to info[row]; a row with more
//        reserves a bucket of that many places and a record in the list of
//        such rows (warp-aggregated shared-memory atomics), writes {row,
//        bucket start, count} there and itself to the bucket's first
//        place;
//    (c) every later entry writes its batch index to bucket[info[row] +
//        slot].
//    Integer atomics: the same buckets, up to the order inside each,
//    whatever order the threads run in. One block, because the passes need
//    barriers between them; its work is O(B).
// 2. write_kernel writes every row once, so the table needs no memset. Its
//    first blocks give each warp 32 table rows (one coalesced load of their
//    counts and infos): no entry, zeros; one entry, 0 + its values, four
//    rows' loads in flight at once. Its other blocks give each warp one
//    record of a row with more entries, so that rows with many duplicates
//    (popular items have neighbouring ids) do not queue in one warp: the
//    warp loads the bucket (32 entries a load), puts the batch indices in
//    ascending order and adds the values in that order with __fadd_rn,
//    starting from 0 as np.add.at does on a zeroed table. Up to 32 entries
//    are ranked across the lanes (the indices are distinct); a longer
//    bucket (a hot row) is marked in a bitmap of batch positions in shared
//    memory and read back in order, 4,096 positions a window, over the
//    windows from the row's first batch position to its last: one or two
//    where the index is sorted (SGL's drop lists), up to every window of
//    the batch where a hot row's entries are spread. Values are loaded
//    eight at a time before they are added.
// Work: O(B) atomics and bucket entries, the table's bytes, and for a hot
// row O(entries x windows + span / 32) words of its bitmap, span being
// the distance from its first batch position to its last.
//
// Rows outside [0, n_rows) are never counted and never written: the wrapper
// that does not check the range relies on the caller's forward indexing to
// have faulted on them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_BLOCK = WARPS * 32;
constexpr int LINK_THREADS = 1024;
constexpr int PER_THREAD = 4;      // entries a link thread handles a round
constexpr int ROUND = LINK_THREADS * PER_THREAD;
constexpr int LOADS = 8;           // values loaded before they are added
constexpr int WINDOW_WORDS = 128;  // a hot row's bitmap: 4,096 batch positions
constexpr unsigned FULL = 0xffffffffu;

// The batch, the output, and the scratch (int32, cap = B rounded up to even:
// records int4[cap / 2] | n_records, 3 unused | cnt[n_rows] | info[n_rows] |
// slot[cap] | bucket[cap]; cnt zeroed by the launcher).
struct Table {
  const int64_t* idx;
  const float* vals;
  int size;  // B
  float* out;
  int4* records;  // rows with two or more entries: {row, bucket start, count, -}
  int* n_records;
  int* cnt;
  int* info;
  int* slot;
  int* bucket;
  int n_rows;
  int record_block;  // write_kernel's first block for the records

  __device__ __forceinline__ const float* row_vals(int b, int d) const {
    return vals + static_cast<size_t>(b) * d;
  }
};

__global__ void __launch_bounds__(LINK_THREADS, 1)
link_kernel(const Table tb) {
  __shared__ int reserved, listed;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool one_round = tb.size <= ROUND;
  if (tid == 0) reserved = listed = 0;
  int64_t row[PER_THREAD];
  int sl[PER_THREAD];
  // (a) each entry's place in its row; -1: out of range, skipped
  for (int r0 = 0; r0 < tb.size; r0 += ROUND) {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int b = r0 + k * LINK_THREADS + tid;
      row[k] = b < tb.size ? tb.idx[b] : -1;
    }
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k)
      sl[k] = (row[k] >= 0 && row[k] < tb.n_rows) ? atomicAdd(tb.cnt + row[k], 1) : -1;
    if (!one_round) {
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int b = r0 + k * LINK_THREADS + tid;
        if (b < tb.size) tb.slot[b] = sl[k];
      }
    }
  }
  __syncthreads();
  // (b) each row's owner: a single entry's index, or a reserved bucket; the
  // shuffles run in every lane (all threads take the same rounds)
  for (int r0 = 0; r0 < tb.size; r0 += ROUND) {
    if (!one_round) {
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int b = r0 + k * LINK_THREADS + tid;
        sl[k] = b < tb.size ? tb.slot[b] : -1;
        row[k] = sl[k] >= 0 ? tb.idx[b] : 0;
      }
    }
    int c[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) c[k] = sl[k] == 0 ? tb.cnt[row[k]] : 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int b = r0 + k * LINK_THREADS + tid;
      const int need = c[k] > 1 ? c[k] : 0;
      int upto = need;  // inclusive prefix over the warp
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, upto, o);
        if (lane >= o) upto += v;
      }
      const unsigned many = __ballot_sync(FULL, c[k] > 1);
      int base = 0, at = 0;
      if (lane == 31 && upto > 0) {
        base = atomicAdd(&reserved, upto);
        at = atomicAdd(&listed, __popc(many));
      }
      base = __shfl_sync(FULL, base, 31);
      at = __shfl_sync(FULL, at, 31);
      if (c[k] == 1) tb.info[row[k]] = b;
      if (c[k] > 1) {
        const int start = base + upto - need;
        tb.info[row[k]] = start;
        tb.bucket[start] = b;
        tb.records[at + __popc(many & ((1u << lane) - 1u))] =
            make_int4(static_cast<int>(row[k]), start, c[k], 0);
      }
    }
  }
  __syncthreads();
  if (tid == 0) *tb.n_records = listed;
  // (c) the later entries of rows with two or more, in no order
  for (int r0 = 0; r0 < tb.size; r0 += ROUND) {
    if (!one_round) {
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int b = r0 + k * LINK_THREADS + tid;
        sl[k] = b < tb.size ? tb.slot[b] : -1;
        row[k] = sl[k] > 0 ? tb.idx[b] : 0;
      }
    }
    int start[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) start[k] = sl[k] > 0 ? tb.info[row[k]] : 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k)
      if (sl[k] > 0) tb.bucket[start[k] + sl[k]] = r0 + k * LINK_THREADS + tid;
  }
}

// dst[f] (+)= the values of entries ordered[0 .. n) (lane k holds the k-th,
// n <= 32) in that order; resume: dst already holds the sum so far. Values
// are loaded LOADS at a time before they are added.
__device__ __forceinline__ void add_in_order(const Table& tb, int ordered, int n, float* dst,
                                             int d, bool resume, int lane) {
  for (int f0 = 0; f0 < d; f0 += 32) {
    const int f = f0 + lane;
    float acc = (resume && f < d) ? dst[f] : 0.0f;
    for (int k0 = 0; k0 < n; k0 += LOADS) {
      float v[LOADS];
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int bk = __shfl_sync(FULL, ordered, (k0 + k) & 31);
        v[k] = (k0 + k < n && f < d) ? tb.row_vals(bk, d)[f] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < LOADS; ++k)
        if (k0 + k < n) acc = __fadd_rn(acc, v[k]);
    }
    if (f < d) dst[f] = acc;
  }
}

// A row from its c >= 2 entries at list[0 .. c).
__device__ __forceinline__ void write_row(const Table& tb, const int* __restrict__ list, int c,
                                          float* dst, int d, unsigned* bits, int lane) {
  if (c <= 32) {
    // rank each lane's entry among the c, then lane k takes rank k's entry
    const int mine = lane < c ? list[lane] : 0;
    int rank = 0;
    for (int j = 0; j < c; ++j) rank += __shfl_sync(FULL, mine, j) < mine;
    int ordered = 0;
    for (int k = 0; k < c; ++k) {
      const unsigned who = __ballot_sync(FULL, lane < c && rank == k);
      const int bk = __shfl_sync(FULL, mine, __ffs(who) - 1);
      if (lane == k) ordered = bk;
    }
    add_in_order(tb, ordered, c, dst, d, false, lane);
    return;
  }
  // a hot row: its batch positions marked in a bitmap, read back in order,
  // a window at a time from its first position to its last (one or two
  // windows where the index is sorted and the row's entries are adjacent)
  int lo = 0x7fffffff, hi = -1;
  for (int k = lane; k < c; k += 32) {
    const int p = list[k];
    lo = min(lo, p);
    hi = max(hi, p);
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  bool resume = false;
  for (int w0 = lo; w0 <= hi; w0 += 32 * WINDOW_WORDS) {
    for (int i = lane; i < WINDOW_WORDS; i += 32) bits[i] = 0u;
    __syncwarp();
    for (int k = lane; k < c; k += 32) {
      const int p = list[k] - w0;
      if (p >= 0 && p < 32 * WINDOW_WORDS) atomicOr(bits + (p >> 5), 1u << (p & 31));
    }
    __syncwarp();
    int ordered = 0, n = 0;
    for (int i0 = 0; i0 < WINDOW_WORDS; i0 += 32) {
      const unsigned word = bits[i0 + lane];
      unsigned nz = __ballot_sync(FULL, word != 0u);
      while (nz) {
        const int i = __ffs(nz) - 1;
        nz &= nz - 1;
        unsigned w = __shfl_sync(FULL, word, i);
        while (w) {
          const int bit = __ffs(w) - 1;
          w &= w - 1;
          if (lane == n) ordered = w0 + 32 * (i0 + i) + bit;
          if (++n == 32) {
            add_in_order(tb, ordered, n, dst, d, resume, lane);
            resume = true;
            n = 0;
          }
        }
      }
    }
    if (n > 0) {
      add_in_order(tb, ordered, n, dst, d, resume, lane);
      resume = true;
    }
    __syncwarp();  // every lane is done with the bitmap before it is cleared
  }
}

__global__ void __launch_bounds__(THREADS)
write_kernel(const Table tb, int d) {
  __shared__ unsigned bitmaps[WARPS][WINDOW_WORDS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int block = blockIdx.x;
  // the blocks: the table's rows, then its records
  if (block >= tb.record_block) {
    const int t = (block - tb.record_block) * WARPS + warp;
    if (t >= *tb.n_records) return;  // warp-uniform
    const int4 rec = tb.records[t];  // row, bucket start, count
    write_row(tb, tb.bucket + rec.y, rec.z, tb.out + static_cast<size_t>(rec.x) * d, d,
              bitmaps[warp], lane);
    return;
  }
  const int row0 = block * ROWS_PER_BLOCK + warp * 32;
  if (row0 >= tb.n_rows) return;  // warp-uniform
  // lane l reads row row0 + l's count and info
  const int mine = row0 + lane;
  const bool in = mine < tb.n_rows;
  const int c = in ? tb.cnt[mine] : 0;
  const int inf = in ? tb.info[mine] : 0;
  float* base = tb.out + static_cast<size_t>(row0) * d;
  // rows with no entry
  unsigned rows = __ballot_sync(FULL, in && c == 0);
  while (rows) {
    const int r = __ffs(rows) - 1;
    rows &= rows - 1;
    for (int f = lane; f < d; f += 32) base[static_cast<size_t>(r) * d + f] = 0.0f;
  }
  // rows with one entry, four at a time: the loads first, then the stores
  // (rows with more are their records' warps')
  rows = __ballot_sync(FULL, c == 1);
  while (rows) {
    int r4[4], b4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r4[j] = rows ? __ffs(rows) - 1 : -1;
      if (rows) rows &= rows - 1;
      b4[j] = __shfl_sync(FULL, inf, r4[j] < 0 ? 0 : r4[j]);
    }
    for (int f0 = 0; f0 < d; f0 += 32) {
      const int f = f0 + lane;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (r4[j] >= 0 && f < d) ? tb.row_vals(b4[j], d)[f] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r4[j] >= 0 && f < d) base[static_cast<size_t>(r4[j]) * d + f] = __fadd_rn(0.0f, v[j]);
    }
  }
}

}  // namespace

extern "C" {

// idx: int64 [batch]; vals: f32 [batch, d]; out: f32 [n_rows, d],
// overwritten; scratch: int32 [4 * cap + 4 + 2 * n_rows] (cap: batch rounded
// up to even; see Table), 16-byte aligned, any contents. Entries outside
// [0, n_rows) are skipped.
// Returns the first CUDA error.
int scatter_add_rows(const void* idx, const void* vals, void* out, void* scratch, int batch,
                     int d, int n_rows, void* stream) {
  if (batch < 0 || d <= 0 || n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cap = batch + batch % 2;
  int* w = static_cast<int*>(scratch);
  int* cnt = w + 2 * cap + 4;
  cudaError_t err = cudaMemsetAsync(cnt, 0, static_cast<size_t>(n_rows) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const Table tb{static_cast<const int64_t*>(idx), static_cast<const float*>(vals), batch,
                 static_cast<float*>(out), reinterpret_cast<int4*>(w), w + 2 * cap, cnt,
                 cnt + n_rows, cnt + 2 * n_rows, cnt + 2 * n_rows + cap, n_rows, row_blocks};
  link_kernel<<<1, LINK_THREADS, 0, s>>>(tb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a row with records has two entries or more: at most half the batch
  write_kernel<<<row_blocks + (batch / 2 + WARPS - 1) / WARPS, THREADS, 0, s>>>(tb, d);
  return static_cast<int>(cudaGetLastError());
}

const char* scatter_add_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
