// K1 dual_int8_t: both directions of the int8 adjacency product from one
// read of M, activations in the transposed [d, N] layout of the chain.
//
//   yuT[f, u] = sum_i qiT[f, i] * M[u, i]      (M  @ qi, as [d, U_pad])
//   yiT[f, i] = sum_u quT[f, u] * M[u, i]      (M^T @ qu, as [d, I_pad])
//
// Replaces idgrec_tpu/ops/fusedmm.py _tkernel_int8 (l.674, launched by
// _tdual_small_call l.758) and _tkernel_int8_panel (l.797, launched by
// _tdual_panel_call l.881); entry fused_adj_matmul_int8_t (l.923).
//
// Bound on the H100: bytes. One sweep reads M once (U_pad * I_pad bytes,
// 1.22 GB at yelp2018 scale); the operations are 4 * nnz * d int8
// multiply-adds (the non-zero entries only).
//
// Design: the scan of dual_scan.cuh (K7's; its note gives the design and the
// measurements that chose it) at d = 64 between the two layout turns of
// dual_turns.cuh, three launches a call; the chain's sweep runs K2's, K9's
// or K10's epilogue in the turn-out (dual_int8_t_sweep). The tile kernel this
// replaced (mma.sync on 64 x 256 stages of M, zero-tile votes, byte gathers,
// its outputs zeroed and converted by four more launches) took 0.916 ms per
// sweep on an H100 where the scan takes 0.575, the turns 0.024 of it
// (PERF.md).

#include "dual_turns.cuh"

extern "C" {

// m int8 [u_pad, i_pad]; quT int8 [64, u_pad]; qiT int8 [64, i_pad]. yuT
// [64, u_pad] and yiT [64, i_pad] float32 receive the sums (no zeroing
// needed). q_scratch: int8 [(u_pad + i_pad) * 64]; acc_scratch: int32
// [(u_pad + i_pad) * 64], both 16-byte aligned. The wrapper checks
// i_pad % 256 == 0 and u_pad % 64 == 0. Three launches on the stream, no
// synchronisation. Returns cudaGetLastError().
int dual_int8_t(const void* m, const void* quT, const void* qiT, void* yuT, void* yiT,
                void* q_scratch, void* acc_scratch, int u_pad, int i_pad, void* stream) {
  return dual_t<false>(m, quT, qiT, yuT, yiT, q_scratch, acc_scratch, u_pad, i_pad, stream);
}

// One sweep of the quantized chain on M: each side's input the previous
// sweep's z and amax, rounded in the turn-in as K3 rounds it, a zero input,
// or int8 q and its scale; the epilogue of K2 (linear chain) or of K9 / K10
// (tanh chain) in the turn-out, each side with its own next input, or none
// of it (dual_turns.cuh dual_t_sweep gives the arguments). Three launches.
int dual_int8_t_sweep(const void* m, const void* x_u, const void* x_i, const void* a_u,
                      const void* a_i, void* q_scratch, void* acc_scratch, void* aux,
                      const void* post_u, const void* pre_u, const void* post_i,
                      const void* pre_i, void* ext_u, void* ext_i, void* out_u, void* out_i,
                      void* hs_u, void* hs_i, int u_pad, int i_pad, int in_u, int in_i, int mode,
                      int sides, int flag, int next_u, int next_i, void* stream) {
  return dual_t_sweep<false>(m, x_u, x_i, a_u, a_i, q_scratch, acc_scratch, aux, post_u, pre_u,
                             post_i, pre_i, ext_u, ext_i, out_u, out_i, hs_u, hs_i, u_pad, i_pad,
                             in_u, in_i, mode, sides, flag, next_u, next_i, stream);
}

// The float32 words of the sweep's aux buffer.
int dual_int8_t_sweep_aux_words(int u_pad, int i_pad) { return sweep_aux_words(u_pad, i_pad); }

const char* dual_int8_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
