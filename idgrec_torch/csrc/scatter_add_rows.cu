// K4 scatter_add_rows: the batch row scatter behind the gradient of the
// batch-embedding gathers.
//
//   out[n_rows, d] f32 = sum_b onehot(idx[b]) * vals[b]     idx [B], vals [B, d]
//
// Rows that no idx names are zero. Duplicates of a row are added in batch
// order, ((v_b0 + v_b1) + v_b2) + ..., the order of np.add.at.
//
// Replaces idgrec_tpu/ops/scatter.py _scatter_kernel (l.40), launched by
// scatter_add_rows (l.58). The TPU kernel kept the whole table in VMEM and
// walked the batch in a sequential loop on one core; that loop is what fixed
// the order of the sums. A Hopper block holds 227 KB and blocks run in no
// order, and float atomicAdd would make the sums differ from run to run.
//
// Design: the launcher zeroes the table, then one block per batch entry b.
// The block leaves at once if an earlier entry names the same row: the
// first occurrence owns the row. The owner walks the later entries in order,
// adds every duplicate's values to its own, and writes the row once. No two
// blocks write one address, so there are no atomics and the result is
// bit-equal to the sequential sum. The index array (B <= a few thousand
// entries) is read by every block and stays in L2.
//
// Bound on the H100: bytes (the table written once, vals and idx read once);
// no tensor cores. Sums use __fadd_rn in batch order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
scatter_add_rows_kernel(const int64_t* __restrict__ idx, const float* __restrict__ vals,
                        float* __restrict__ out, int batch, int d, int n_rows) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t row = idx[b];
  if (row < 0 || row >= n_rows) return;  // the wrapper refuses these; never write outside
  // an earlier occurrence owns this row
  int earlier = 0;
  for (int j = tid; j < b; j += THREADS) earlier |= (idx[j] == row);
  if (__syncthreads_or(earlier)) return;

  float* dst = out + static_cast<size_t>(row) * d;
  for (int f = tid; f < d; f += THREADS) dst[f] = vals[static_cast<size_t>(b) * d + f];

  // later duplicates, in batch order: each warp votes on 32 entries, the
  // masks are walked from the lowest entry up
  __shared__ unsigned masks[WARPS];
  for (int j0 = b + 1; j0 < batch; j0 += THREADS) {
    const int j = j0 + tid;
    const bool match = j < batch && idx[j] == row;
    const unsigned vote = __ballot_sync(0xffffffffu, match);
    if ((tid & 31) == 0) masks[tid >> 5] = vote;
    __syncthreads();
    for (int w = 0; w < WARPS; ++w) {
      unsigned m = masks[w];
      while (m) {
        const int jj = j0 + w * 32 + (__ffs(m) - 1);
        m &= m - 1;
        // thread tid alone touches dst[f] for its f: its own reads follow its writes
        for (int f = tid; f < d; f += THREADS)
          dst[f] = __fadd_rn(dst[f], vals[static_cast<size_t>(jj) * d + f]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// idx: int64 [batch], every value in [0, n_rows); vals: f32 [batch, d];
// out: f32 [n_rows, d], overwritten. Returns the first CUDA error.
int scatter_add_rows(const void* idx, const void* vals, void* out, int batch, int d,
                     int n_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n_rows) * d * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch > 0) {
    scatter_add_rows_kernel<<<batch, THREADS, 0, s>>>(
        static_cast<const int64_t*>(idx), static_cast<const float*>(vals),
        static_cast<float*>(out), batch, d, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* scatter_add_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
