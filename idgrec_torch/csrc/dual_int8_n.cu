// K7 dual_int8_n: both directions of the int8 adjacency product from a
// walk of M's plan (dual_int8_n_plan) or, where the caller holds no plan,
// one read of M per feature group (dual_int8_n), activations in the [N, d]
// layout of the per-application product.
//
//   yu[u, f] = sum_i M[u, i] * qi[i, f]      (M  @ qi, [U_pad, d])
//   yi[i, f] = sum_u M[u, i] * qu[u, f]      (M^T @ qu, [I_pad, d])
//
// Replaces idgrec_tpu/ops/fusedmm.py _fused_kernel_int8_small (l.211,
// launched by _fused_small_call l.250) and _fused_kernel_int8 (l.283,
// launched at l.345); entry fused_adj_matmul_int8 (l.320). The TPU needed a
// single-panel and a panelized body because its yi or yu accumulator had to
// fit VMEM; here one kernel covers both. Its sums equal K1's (dual_int8_t.cu)
// on the transposed activations bit for bit: the same integer products, and
// integer addition is associative.
//
// Bound on the H100: bytes. The walk moves the plan (about 10 bytes a
// non-zero entry), the activations once and the sums once; the scan reads M
// (U_pad * I_pad int8, 1.22 GB at yelp2018 scale) once per feature group.
// The operations are 4 * nnz * d int8 multiply-adds (the non-zero entries
// only).
//
// Design: the walk of dual_walk.cuh or the scan of
// dual_scan.cuh (their notes give the designs and the measurements that
// chose them), both in the IntSums arithmetic, one launch for every feature
// slice or group of d, then one launch that converts both int32 sums to
// float32 in place. The sums are integer sums, so the two paths give the
// same bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "dual_scan.cuh"
#include "dual_walk.cuh"

extern "C" {

// m int8 [u_pad, i_pad]; qu int8 [u_pad, d]; qi int8 [i_pad, d]. yu [u_pad, d]
// and yi [i_pad, d] must be zeroed int32 buffers; on return they hold the
// float32 sums (bit-cast in place). d % 32 == 0; the wrapper also checks
// i_pad % 256 == 0 and u_pad % 64 == 0. *passes: the scans of M launched.
// Returns cudaGetLastError().
int dual_int8_n(const void* m, const void* qu, const void* qi, void* yu, void* yi,
                int u_pad, int i_pad, int d, int* passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* yup = static_cast<int*>(yu);
  int* yip = static_cast<int*>(yi);
  cudaError_t err = launch_scan<false>(static_cast<const int8_t*>(m),
                                       static_cast<const int8_t*>(qu),
                                       static_cast<const int8_t*>(qi), yup, yip, u_pad, i_pad, d,
                                       passes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(convert_sums(yup, static_cast<long long>(d) * u_pad, yip,
                                       static_cast<long long>(d) * i_pad, s));
}

// dual_int8_n from the plan of M [u_pad, i_pad] instead of M: lists the
// eight device pointers of the plan (fusedmm.DualPlan: the row list's
// offsets, columns, counts and table of runs, then the column list's), nnz
// its entries. fpl features a lane (1, 2, 3, 4, 6 or 8; d % (32 fpl) == 0),
// chunk entries a warp (a multiple of 32). yu and yi zeroed int32 buffers
// as for dual_int8_n. Two launches, no synchronisation; M is not read.
int dual_int8_n_plan(const void* const* lists, long long nnz, const void* qu, const void* qi,
                     void* yu, void* yi, int u_pad, int i_pad, int d, int fpl, int chunk,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* yup = static_cast<int*>(yu);
  int* yip = static_cast<int*>(yi);
  cudaError_t err = launch_walk<IntSums>(lists, nnz, u_pad, i_pad, true, true,
                                         static_cast<const int8_t*>(qu),
                                         static_cast<const int8_t*>(qi), yup, yip, d, fpl, chunk,
                                         nullptr, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(convert_sums(yup, static_cast<long long>(d) * u_pad, yip,
                                       static_cast<long long>(d) * i_pad, s));
}

const char* dual_int8_n_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
