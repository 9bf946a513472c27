// K8 dual_int4_n: both directions of the adjacency product from a walk of
// M's plan (dual_int4_n_plan) or, where the caller holds no plan, one read of
// the nibble-packed count matrix per feature group (dual_int4_n),
// activations int8 in the [N, d] layout of the per-application product.
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
// K7's (dual_int8_n.cu) on the unpacked matrix and K5's (dual_int4_t.cu) on
// the transposed activations, bit for bit.
//
// Bound on the H100: bytes. The walk moves the plan (about 10 bytes a
// non-zero entry, 13.2 MB at yelp2018 scale), the activations once and the
// sums once; the scan reads m4 (U_pad * I_pad / 2 bytes, 0.62 GB there) once
// per feature group. The operations are 4 * nnz * d int8 multiply-adds (the
// non-zero nibbles only).
//
// Design, with a plan: K7's walk (dual_walk.cuh, IntSums) of the plan of the
// unpacked matrix (ops/fusedmm.py dual_plan, made at build before packing):
// the same entries as K7's on the unpacked matrix, so the same integer sums,
// and m4 is not read. At d = 192 the scan read m4 three times (1.2859 ms
// against K7's walk 0.4253, PERF.md).
//
// Design, without a plan: K7's scan (dual_scan.cuh) on the packed bytes. The tile design it
// replaces (K5's mma.sync on 64-feature blocks, zero-tile votes, nibble
// unpacking into mma operands, shared-memory transposes of every activation
// chunk) read m4 once per 64 features and spent its time in the SM proving
// zeros: 1.3628 ms at d = 128, 2.07 times its d = 64 time (PERF.md). The
// scan reads m4 once per 128 features and unpacks only the non-zero bytes'
// nibbles into entries (two from a byte whose nibbles are both set), then one
// launch converts both int32 sums to float32 in place. The launcher is K7's:
// the same arguments, the scans it launched reported.

#include <cstdint>
#include <cuda_runtime.h>

#include "dual_scan.cuh"
#include "dual_walk.cuh"

extern "C" {

// m4 is the packed matrix [u_pad, i_pad / 2]; qu int8 [u_pad, d]; qi int8
// [i_pad, d]. yu [u_pad, d] and yi [i_pad, d] must be zeroed int32 buffers; on
// return they hold the float32 sums (bit-cast in place). d % 32 == 0; the
// wrapper also checks i_pad % 2048 == 0 and u_pad % 64 == 0. *passes: the
// scans of m4 launched. Returns cudaGetLastError().
int dual_int4_n(const void* m4, const void* qu, const void* qi, void* yu, void* yi,
                int u_pad, int i_pad, int d, int* passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* yup = static_cast<int*>(yu);
  int* yip = static_cast<int*>(yi);
  if (i_pad % (2 * HALF_TILE) != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_scan<true>(static_cast<const int8_t*>(m4),
                                      static_cast<const int8_t*>(qu),
                                      static_cast<const int8_t*>(qi), yup, yip, u_pad, i_pad / 2,
                                      d, passes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(convert_sums(yup, static_cast<long long>(d) * u_pad, yip,
                                       static_cast<long long>(d) * i_pad, s));
}

// dual_int4_n from the plan of the unpacked M [u_pad, i_pad] instead of m4:
// the arguments of dual_int8_n_plan. Two launches, no synchronisation; m4 is
// not read.
int dual_int4_n_plan(const void* const* lists, long long nnz, const void* qu, const void* qi,
                     void* yu, void* yi, int u_pad, int i_pad, int d, int fpl, int chunk,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* yup = static_cast<int*>(yu);
  int* yip = static_cast<int*>(yi);
  if (i_pad % (2 * HALF_TILE) != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_walk<IntSums>(lists, nnz, u_pad, i_pad, true, true,
                                         static_cast<const int8_t*>(qu),
                                         static_cast<const int8_t*>(qi), yup, yip, d, fpl, chunk,
                                         nullptr, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(convert_sums(yup, static_cast<long long>(d) * u_pad, yip,
                                       static_cast<long long>(d) * i_pad, s));
}

const char* dual_int4_n_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
