// K5 dual_int4_t: both directions of the adjacency product from one read of
// the nibble-packed count matrix, activations int8 in the transposed [d, N]
// layout of the chain.
//
//   yuT[f, u] = sum_c qiT[f, c] * M[u, c]      (M  @ qi, as [d, U_pad])
//   yiT[f, c] = sum_u quT[f, u] * M[u, c]      (M^T @ qu, as [d, I_pad])
//
// M [U_pad, I_pad] holds counts 0..15 and is stored packed as m4
// [U_pad, I_pad / 2]: within each tile of 2048 logical columns, byte p
// (0..1023) of the tile holds column p in its low nibble and column 1024 + p
// in its high nibble (ops/fusedmm.py pack_nibbles). The integer products are
// those of K1 (dual_int8_t.cu) on the unpacked matrix, bit for bit.
//
// Replaces idgrec_tpu/ops/fusedmm.py _tkernel_int4 (l.708, launched by
// _tdual_small_call l.758) and _tkernel_int4_panel (l.832, launched by
// _tdual_panel_call l.881); entry fused_adj_matmul_int4_t (l.944).
//
// Bound on the H100: bytes. One sweep reads m4 once (U_pad * I_pad / 2
// bytes, 0.62 GB at yelp2018 scale); the operations are 4 * nnz * d int8
// multiply-adds (the non-zero nibbles only).
//
// Design: K1's (dual_turns.cuh) with K8's scan of the packed bytes
// (dual_scan.cuh, PACKED: only the non-zero bytes' nibbles become entries,
// two from a byte whose nibbles are both set), three launches a call; the
// chain's sweep runs K2's, K9's or K10's epilogue in the turn-out
// (dual_int4_t_sweep). The tile kernel it replaced (mma.sync on 64-row
// chunks staged by cp.async, zero-tile votes on both nibbles, nibble-
// unpacking mma fragments, int32 atomics into zeroed outputs and a
// conversion launch; four device launches a call) spent its time in the SM
// proving zeros: 0.787 ms a sweep on an H100, 1.37 times K1's (PERF.md).

#include "dual_turns.cuh"

extern "C" {

// m4 int8 [u_pad, i_pad / 2] (packed); quT int8 [64, u_pad]; qiT int8
// [64, i_pad]. yuT [64, u_pad] and yiT [64, i_pad] float32 receive the sums
// (no zeroing needed). q_scratch: int8 [(u_pad + i_pad) * 64]; acc_scratch:
// int32 [(u_pad + i_pad) * 64], both 16-byte aligned. i_pad % 2048 == 0,
// u_pad % 64 == 0. Three launches on the stream, no synchronisation.
// Returns cudaGetLastError().
int dual_int4_t(const void* m4, const void* quT, const void* qiT, void* yuT, void* yiT,
                void* q_scratch, void* acc_scratch, int u_pad, int i_pad, void* stream) {
  return dual_t<true>(m4, quT, qiT, yuT, yiT, q_scratch, acc_scratch, u_pad, i_pad, stream);
}

// One sweep of the quantized chain on m4: each side's input the previous
// sweep's z and amax, rounded in the turn-in as K3 rounds it, a zero input,
// or int8 q and its scale; the epilogue of K2 (linear chain) or of K9 / K10
// (tanh chain) in the turn-out, each side with its own next input, or none
// of it (dual_turns.cuh dual_t_sweep gives the arguments). Three launches.
int dual_int4_t_sweep(const void* m4, const void* x_u, const void* x_i, const void* a_u,
                      const void* a_i, void* q_scratch, void* acc_scratch, void* aux,
                      const void* post_u, const void* pre_u, const void* post_i,
                      const void* pre_i, void* ext_u, void* ext_i, void* out_u, void* out_i,
                      void* hs_u, void* hs_i, int u_pad, int i_pad, int in_u, int in_i, int mode,
                      int sides, int flag, int next_u, int next_i, void* stream) {
  return dual_t_sweep<true>(m4, x_u, x_i, a_u, a_i, q_scratch, acc_scratch, aux, post_u, pre_u,
                            post_i, pre_i, ext_u, ext_i, out_u, out_i, hs_u, hs_i, u_pad, i_pad,
                            in_u, in_i, mode, sides, flag, next_u, next_i, stream);
}

// The float32 words of the sweep's aux buffer.
int dual_int4_t_sweep_aux_words(int u_pad, int i_pad) { return sweep_aux_words(u_pad, i_pad); }

const char* dual_int4_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
