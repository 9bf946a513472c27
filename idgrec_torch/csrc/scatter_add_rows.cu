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
//
// The sorted-segment entry (segment_sum_rows), SGL's drop corrections: the
// list is sorted by its index and comes with its row offsets ptr, and the
// values are gathered rows of a table z,
//
//   out[r, f] = ((0 + z[c_e0, f]) + z[c_e1, f]) + ...   e in [ptr[r], ptr[r + 1])
//
// in list order with __fadd_rn: the bits of the entry above on (ptr's rows,
// z[cols]). The offsets are made on the host with the view
// (ops/propagate.py build_dropout_adjacency), so the link pass, the memset
// and the bucket ranking have nothing left to do, and the gather z[cols]
// (31.7 MB a call at SGL's 123,726 entries and d = 64) moves into the
// kernel: one launch, no scratch.
// * Work split without a plan: a row costs its entries and one store, so
//   row r starts at cost ptr[r] + r, and warp w takes the rows that start in
//   [64 w, 64 (w + 1)) for one feature slice of 32 (the slices of a window
//   side by side). The warp finds its first and last row by a 32-way
//   search of ptr (three or four probes), so light rows come ~12 to a warp
//   and a hot row (up to 2,120 entries into one item) is one warp's task
//   for each of its slices, on its own.
// * The loads: lane j copies entry j of a batch of 32 (its 128-byte slice of
//   z's row, 16-byte cp.async; 4-byte copies at widths off 4 or an
//   unaligned z, and where the ablation script reads a transposed z in
//   place: the wrapper copies a strided z first) into a ring of 4 batches in shared memory a warp, its column
//   copied the same way a ring ahead, so 128 gathered row slices are in
//   flight while the warp adds. Lane f then adds feature f down the batch
//   strictly in list order: a batch inside one row as 32 adds of values read
//   ahead, else four values at a time with each entry's row ends closed
//   before its add. A row ends where ptr says (a window of 32 row ends in the
//   lanes, a shuffle a row) and is stored once, a row without an entry as 0.
// * What the measurements chose (scripts/torch_k7_ablation.py on an H100,
//   PERF.md §6): a lane a feature, each warp loading its 32 entries one
//   after another, left one warp's serial work an entry (shuffles, address,
//   load, add) at 120-140 ns, 0.25-0.29 ms into the items (a 2,120-entry
//   row); 4-byte copies a lane and feature into a ring did not hide it
//   (0.25 ms at any depth). A lane an entry with 16-byte copies: one row of
//   2,000 entries 0.030 ms, into the items 0.037, into the users 0.035.
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

// ---------------------------------------------------------------------------
// the sorted-segment entry

constexpr int SEG_THREADS = 64;
constexpr int SEG_WARPS = SEG_THREADS / 32;
constexpr int SEG_STAGES = 4;                  // batches of 32 entries in flight a warp
constexpr int SEG_COL_SLOTS = 2 * SEG_STAGES;  // the columns run a ring ahead
constexpr int SEG_PITCH = 36;  // floats a staged entry: 16-byte rows, quarter-warp stores spread
constexpr int SEG_WINDOW = 64;                 // a warp's cost: entries and rows

// A warp's ring: lane j copies entry j of a batch (its slice of 32 features)
// into vals[stage][j] and its column into cols[slot][j]; lane f adds
// feature f down the entries.
struct SegRing {
  float vals[SEG_STAGES][32][SEG_PITCH];
  long long cols[SEG_COL_SLOTS][32];
};
constexpr int SEG_SMEM = SEG_WARPS * static_cast<int>(sizeof(SegRing));

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The offsets of a list of `total` entries in n_rows rows, as out_rows >= n_rows
// rows (the rows past n_rows are empty).
struct Segments {
  const long long* ptr;  // [n_rows + 1]
  int n_rows;
  int out_rows;
  long long total;

  __device__ __forceinline__ long long at(int r) const { return r <= n_rows ? ptr[r] : total; }
  // a row's cost offset: its entries and the rows before it
  __device__ __forceinline__ long long cost(int r) const { return at(r) + r; }
};

// The first row r in [a, b] whose cost offset is at least `target`; b
// qualifies by definition (b = out_rows: the end). Warp-uniform: 32 probes a
// round, each round cutting [a, b] 32-fold.
__device__ __forceinline__ int first_row_at(const Segments& sg, int a, int b, long long target,
                                            int lane) {
  while (b - a >= 32) {
    const int step = (b - a) / 32;
    const int p = a + lane * step;  // < b
    const unsigned ge = __ballot_sync(FULL, sg.cost(p) >= target);
    if (ge & 1u) return a;
    if (ge == 0u) {
      a += 31 * step + 1;
    } else {
      const int k = __ffs(ge) - 1;
      b = a + k * step;
      a += (k - 1) * step + 1;
    }
  }
  const int p = a + lane;
  const unsigned ge = __ballot_sync(FULL, p >= b || sg.cost(p) >= target);
  return a + __ffs(ge) - 1;
}

// V: floats a copy (4: z's rows contiguous and 16-byte aligned; 1: any strides,
// widths off 4)
template <int V>
__global__ void __launch_bounds__(SEG_THREADS)
segment_kernel(const Segments sg, const long long* __restrict__ cols,
               const float* __restrict__ z, long long z_row, long long z_feat,
               float* __restrict__ out, int d, int slices, long long tasks) {
  extern __shared__ __align__(16) unsigned char seg_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long task = static_cast<long long>(blockIdx.x) * SEG_WARPS + warp;
  if (task >= tasks) return;  // warp-uniform
  SegRing& ring = reinterpret_cast<SegRing*>(seg_smem)[warp];
  const long long lo = (task / slices) * SEG_WINDOW;
  const int f0 = static_cast<int>(task % slices) * 32;
  const int width = min(32, d - f0);  // the slice's features
  const bool feat = lane < width;
  // the window's rows [rb, re): a row's cost is at least 1, so re <= rb + SEG_WINDOW
  const int rb = first_row_at(sg, 0, sg.out_rows, lo, lane);
  const int re = first_row_at(sg, rb, min(rb + SEG_WINDOW, sg.out_rows), lo + SEG_WINDOW, lane);
  if (rb >= re) return;
  const long long e0 = sg.at(rb);
  const int n = static_cast<int>(sg.at(re) - e0);  // entries counted from e0 below
  const int batches = (n + 31) / 32;
  const float* zs = z + static_cast<long long>(f0) * z_feat;

  // the column of this lane's entry of batch k, into its slot; no commit
  const auto copy_cols = [&](int k) {
    const int j = 32 * k + lane;
    if (j < n) cp_async<8>(&ring.cols[k % SEG_COL_SLOTS][lane], cols + e0 + j);
  };
  // this lane's entry of batch k: its slice of z's row, from its column in
  // the ring (copied by this lane); commits the group
  const auto copy_vals = [&](int k) {
    if (32 * k + lane < n) {
      const float* src = zs + ring.cols[k % SEG_COL_SLOTS][lane] * z_row;
      float* dst = ring.vals[k % SEG_STAGES][lane];
      if constexpr (V == 4) {
        for (int q = 0; q < width; q += 4) cp_async<16>(dst + q, src + q);
      } else {
        for (int q = 0; q < width; ++q) cp_async<4>(dst + q, src + q * z_feat);
      }
    }
    cp_async_commit();
  };

  for (int k = 0; k < SEG_COL_SLOTS; ++k) copy_cols(k);
  cp_async_commit();
  cp_async_wait<0>();
  for (int k = 0; k < SEG_STAGES; ++k) copy_vals(k);

  // lane l holds the end of row rbase + l, counted from e0
  int r = rb, rbase = rb;
  int ends = static_cast<int>(sg.at(min(rb + 1 + lane, sg.out_rows)) - e0);
  int end = __shfl_sync(FULL, ends, 0);
  float acc = 0.0f;
  const auto close_row = [&]() {
    if (feat) out[static_cast<long long>(r) * d + f0 + lane] = acc;
    acc = 0.0f;
    if (++r - rbase == 32) {
      rbase = r;
      ends = static_cast<int>(sg.at(min(r + 1 + lane, sg.out_rows)) - e0);
    }
    end = __shfl_sync(FULL, ends, r - rbase);
  };
  // Group accounting: the prologue's S groups hold the values of batches
  // 0..S-1; iteration k's group the columns of batch k + 2S and the values
  // of batch k + S. Waiting for all but the newest S - 1 groups at iteration
  // k completes this lane's copies of batch k's values and of batch k + S's
  // column; the barrier then shows every lane's.
  for (int k = 0; k < batches; ++k) {
    cp_async_wait<SEG_STAGES - 1>();
    __syncwarp();
    const float* v = &ring.vals[k % SEG_STAGES][0][lane];  // entry j at v[SEG_PITCH * j]
    const int m = min(32, n - 32 * k);
    const int ek = 32 * k;
    if (m == 32 && end >= ek + 32) {
      // the batch lies in one row: its 32 values read, then the adds alone
      float x[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) x[j] = v[SEG_PITCH * j];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc = __fadd_rn(acc, x[j]);
    } else {
      // rows end in the batch: four values read at a time, each entry's
      // rows closed before its add
#pragma unroll 1
      for (int j0 = 0; j0 < m; j0 += 4) {
        float x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = v[SEG_PITCH * (j0 + u)];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j0 + u < m) {
            while (end <= ek + j0 + u) close_row();
            acc = __fadd_rn(acc, x[u]);
          }
        }
      }
    }
    __syncwarp();  // the stage read is refilled next
    copy_cols(k + SEG_COL_SLOTS);
    copy_vals(k + SEG_STAGES);
  }
  cp_async_wait<0>();
  while (r < re) close_row();
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

// The sorted-segment entry. ptr: int64 [n_rows + 1], the offsets of a list
// of `entries` entries sorted by row (ptr[n_rows] == entries); cols: int64
// [entries], each in [0, rows of z); z: f32, z[c, f] at z + c * z_row + f *
// z_feat; out: f32 [out_rows, d] contiguous, out_rows >= n_rows, overwritten
// (rows past n_rows are 0). One launch, no scratch. Returns the first CUDA
// error.
int segment_sum_rows(const void* ptr, const void* cols, const void* z, long long z_row,
                     long long z_feat, void* out, int n_rows, int out_rows, int d,
                     long long entries, void* stream) {
  if (n_rows < 0 || out_rows < n_rows || out_rows <= 0 || d <= 0 || entries < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (d + 31) / 32;
  const long long tasks = (entries + out_rows + SEG_WINDOW - 1) / SEG_WINDOW * slices;
  const long long blocks = (tasks + SEG_WARPS - 1) / SEG_WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies where every slice's rows are contiguous and aligned
  const bool vec = z_feat == 1 && z_row % 4 == 0 && d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(z) % 16 == 0;
  const auto kernel = vec ? segment_kernel<4> : segment_kernel<1>;
  // The rings (40,960 bytes a block) fit the default 48 KB of dynamic shared
  // memory; only a larger ring (more stages or warps, as the ablation script
  // builds them) has to raise the kernel's limit first.
  if constexpr (SEG_SMEM > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SEG_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Segments sg{static_cast<const long long*>(ptr), n_rows, out_rows, entries};
  kernel<<<static_cast<unsigned>(blocks), SEG_THREADS, SEG_SMEM,
           static_cast<cudaStream_t>(stream)>>>(
      sg, static_cast<const long long*>(cols), static_cast<const float*>(z), z_row, z_feat,
      static_cast<float*>(out), d, slices, tasks);
  return static_cast<int>(cudaGetLastError());
}

const char* scatter_add_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
