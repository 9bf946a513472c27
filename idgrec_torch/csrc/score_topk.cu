// score_topk: score, mask and rank a user batch without writing its scores.
//
//   out[B, k] int64 = torch.topk(masked sigmoid(U[users] @ I^T), k).indices
//
// as the card's torch.topk returns them (idgrec_torch/ops/score_topk.py):
// float32 products, the sigmoid 1 / (1 + expf(-x)), each train positive at
// -1e9, the k best; among scores tied at the k-th the lowest item indices;
// for 1 < k <= 32 the k in the order torch.topk's 32-wide bitonic sort
// leaves them, for larger k ties in ascending index.
//
// Replaces no TPU kernel: the JAX package scores with a product and ranks
// with XLA's lax.top_k. It replaces the evaluator's chain of library calls
// (SIMT SGEMM, sigmoid, pad, mask, torch.topk's radix passes), which wrote and
// re-read the [B, I] float32 block about a dozen times a batch.
//
// Bound on the H100: float32 FMA, 2 * B * I * d operations (no tensor cores:
// the scores must be the SGEMM's bits). The item table (23 MB at amazon-book
// scale) stays in L2; the user rows sit in shared memory.
//
// Pass 1, rank_split: a block takes 64 users and one of S item splits, 256
// threads. Item rows stream through shared memory in tiles of 128 items by 32
// features (cp.async, two stages). Warp w holds users 8w..8w+7, lane l items
// l, l+32, l+64, l+96 of a tile: 32 accumulators, each product a chain of
// __fmaf_rn over the features in order from 0, as the SGEMM sums. After a
// tile, the warp gathers the products that reach their user's filter, a
// bound below which the sigmoid cannot reach the user's running k-th
// (`reach`), into a list in shared memory, by user then item (ballots); takes
// the exact sigmoid of each, lane-dense, and keeps those that beat the
// user's k-th by (value descending, index ascending); then lanes 4u..4u+3,
// the group of user 8w+u, insert the user's survivors in ascending item
// order: looked up in the user's sorted train positives (in shared memory
// where they fit) by a cursor that only moves on and, masked or not, put in
// the user's list of the k best so far in shared memory in the place of its
// worst entry, the four lanes scanning a quarter each for the next worst.
// The eight groups work at once. A user's filter starts from the (k + m)-th
// largest product of the block's first tile (`first_filter`), and the S
// splits of a user share the best k-th any of them holds (a bar in global
// memory). Each user's list of the split goes to scratch, sorted.
// Pass 2, merge: one warp a user takes the k best of its S lists (their heads
// compared warp-wide, k rounds), then for 1 < k <= 32 runs torch.topk's
// bitonic network on them, laid out as torch.topk lays them out.
//
// Compiled with -fmad=true (ops/_build.py), as PyTorch's own kernels are, so
// that expf is PyTorch's; the products use __fmaf_rn explicitly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kUsers = 64;     // users a block of pass 1
constexpr int kItems = 128;    // items a tile
constexpr int kChunk = 32;     // features a stage
constexpr int kStride = kChunk + 4;
constexpr int kThreads = 256;
constexpr int kExclCap = 3072;  // train positives a block keeps in shared memory
constexpr int kCand = 128;      // candidates a warp gathers at a time
constexpr float kMask = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// PyTorch's float sigmoid on the card: one / (one + std::exp(-a))
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The least product x that may still tie or beat an entry of product xt.
// The sigmoid S above is sigma(x) (1 + eta) with |eta| < 2^-21 (expf within
// 2 ulp, then one add and one division each rounded once), so for x below
// xt - 2^-20 (1 + e^xt), S(x) < sigma(xt) (1 - 2^-21) <= S(y) for every
// y >= xt (sigma rises); the filter takes twice that margin, plus room for
// the rounding of the subtraction. Below xt = -80 expf(-x) nears overflow and
// the sigmoid underflow, where that bound fails: no filter there, nor for a
// masked entry (xt = -inf).
__device__ __forceinline__ float reach(float xt) {
  if (!(xt > -80.0f)) return -INFINITY;
  return xt - (ldexpf(1.0f + __expf(xt), -19) + ldexpf(fabsf(xt), -20));
}

// The splits of a user share a bar in global memory: the best k-th entry any
// of them holds, packed so that a larger key is a better entry (value
// descending, index ascending), and its filter. Key 0: no bar yet.
__device__ __forceinline__ unsigned order_bits(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float from_order(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ unsigned long long pack(float s, int i) {
  return (static_cast<unsigned long long>(order_bits(s)) << 32) |
         (0xffffffffu - static_cast<unsigned>(i));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Lists {  // shared-memory state of pass 1, by block-local user row
  float* s;     // [kUsers][kc + 1] lists of the best k so far: sigmoid (or kMask)
  int* i;       //   item
  float* x;     //   product (-inf where masked)
  float* cx;    // [8 warps][kCand] a warp's candidates: product
  float* cs;    //   sigmoid
  int* ci;      //   item
  int* cu;      //   user of the warp (0-7)
  int* n;       // [kUsers] entries held
  float* lo;    // [kUsers] the filter
  float* ts;    // [kUsers] the worst entry, the k-th, once n == k
  int* ti;
  int* w;       // [kUsers] its place
  int* ex_at;   // [kUsers] first train positive: in `ex` if ex_in, else in cols
  int* ex_n;    // [kUsers] its number
  int* ex_in;   // [kUsers]
  int* ex_cur;  // [kUsers] the first positive not below the items taken so far
  float* bs;    // [kUsers] the bar as last read (-inf, INT_MAX: none)
  int* bi;
  unsigned long long* bar_key;  // [B] global: the splits' shared bar
  unsigned* bar_lo;             // [B] global: its filter, order_bits
  int* ex;      // [kExclCap]
  int ls;       // a list's stride, kc + 1 (no bank conflicts between owners)
};

// Lanes 4g..4g+3 of a warp insert the survivors [a, e) of the warp's
// candidate list, all of block-local user row r = 8w + g, in ascending item
// order, into the user's list of the k best so far: unsorted, a new entry in
// the place of the worst once k are held, each of the four lanes scanning a
// quarter of it for the new worst. The eight groups step together, `rounds`
// survivors; every lane of the warp calls.
__device__ void insert_groups(const Lists& L, int r, int user, int a, int e, int rounds, int k,
                              const int64_t* gcols, int lane) {
  const int q = lane & 3;
  const int wb = (threadIdx.x >> 5) * kCand;
  int n = L.n[r];
  float ts = L.ts[r];
  int ti = L.ti[r];
  int worst = L.w[r];
  const float bs = L.bs[r];
  const int bi = L.bi[r];
  float* ls = L.s + r * L.ls;
  int* li = L.i + r * L.ls;
  float* lx = L.x + r * L.ls;
  const int at = L.ex_at[r], cnt = L.ex_n[r], in = L.ex_in[r];
  int cur = L.ex_cur[r];
  bool moved = false;
  for (int t = 0; t < rounds; ++t) {
    bool in_k = false;
    if (a + t < e) {
      float s = L.cs[wb + a + t], x = L.cx[wb + a + t];
      const int item = L.ci[wb + a + t];
      in_k = (n < k || better(s, item, ts, ti)) && better(s, item, bs, bi);
      if (in_k) {
        // items come in ascending order: the positives' cursor only moves on
        int pos = -1;
        while (cur < cnt &&
               (pos = in ? L.ex[at + cur] : static_cast<int>(gcols[at + cur])) < item)
          ++cur;
        if (cur < cnt && pos == item) {
          s = kMask;
          x = -INFINITY;
          in_k = (n < k || better(s, item, ts, ti)) && better(s, item, bs, bi);
        }
      }
      if (in_k) {
        const int f = n < k ? n++ : worst;
        if (q == 0) {
          ls[f] = s;
          li[f] = item;
          lx[f] = x;
        }
      }
    }
    const bool rescan = in_k && n == k;
    __syncwarp();
    if (__any_sync(kFull, rescan)) {
      float ws = INFINITY;  // beats every entry: the first one scanned replaces it
      int wi = -1, wp = 0;
      for (int f = q; f < k; f += 4) {
        if (f < n) {
          const float fs = ls[f];
          const int fi = li[f];
          if (better(ws, wi, fs, fi)) { ws = fs; wi = fi; wp = f; }
        }
      }
      for (int o = 1; o < 4; o <<= 1) {
        const float os = __shfl_xor_sync(kFull, ws, o);
        const int oi = __shfl_xor_sync(kFull, wi, o);
        const int op = __shfl_xor_sync(kFull, wp, o);
        if (better(ws, wi, os, oi)) { ws = os; wi = oi; wp = op; }
      }
      if (rescan) {
        ts = ws;
        ti = wi;
        worst = wp;
        moved = true;
      }
    }
  }
  if (q == 0 && a < e) {
    L.n[r] = n;
    L.ts[r] = ts;
    L.ti[r] = ti;
    L.w[r] = worst;
    L.ex_cur[r] = cur;
    if (moved) {
      const float lo = fmaxf(L.lo[r], reach(lx[worst]));
      L.lo[r] = lo;
      atomicMax(L.bar_key + user, pack(ts, ti));
      atomicMax(L.bar_lo + user, order_bits(lo));
    }
  }
}

// After a block's first tile: each user's filter from the (k + m)-th largest
// product of the tile, m the user's positives among its items; at least k
// unmasked items of the tile reach it, so an item below its `reach` cannot
// be among the k best. One user at a time, warp-wide.
__device__ __forceinline__ void first_filter(const Lists& L, const float (&acc)[8][4], int u0,
                                             int warp, int lane, int B, int k, int col,
                                             int i_end, const int64_t* gcols) {
  const int avail = min(kItems, i_end - col);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = 8 * warp + u;
    if (u0 + r >= B) continue;
    const int at = L.ex_at[r], cnt = L.ex_n[r], in = L.ex_in[r];
    int m = 0;
    for (int e0 = 0; e0 < cnt; e0 += 32) {
      const int e = e0 + lane;
      bool hit = false;
      if (e < cnt) {
        const int p = in ? L.ex[at + e] : static_cast<int>(gcols[at + e]);
        hit = p >= col && p < col + avail;
      }
      m += __popc(__ballot_sync(kFull, hit));
    }
    const int need = k + m;
    if (need > avail) continue;
    float v0 = lane < avail ? acc[u][0] : -INFINITY;
    float v1 = lane + 32 < avail ? acc[u][1] : -INFINITY;
    float v2 = lane + 64 < avail ? acc[u][2] : -INFINITY;
    float v3 = lane + 96 < avail ? acc[u][3] : -INFINITY;
    float x = -INFINITY;
    for (int round = 0; round < need; ++round) {  // take out the largest, need times
      const float mine = fmaxf(fmaxf(v0, v1), fmaxf(v2, v3));
      x = mine;
      for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
      if (lane == __ffs(__ballot_sync(kFull, mine == x)) - 1) {
        if (v0 == x) v0 = -INFINITY;
        else if (v1 == x) v1 = -INFINITY;
        else if (v2 == x) v2 = -INFINITY;
        else v3 = -INFINITY;
      }
    }
    if (lane == 0) L.lo[r] = fmaxf(L.lo[r], reach(x));
  }
  __syncwarp();
}

// users [B] int64; ut [*, d], it [n_items, d] float32 (d % 4 == 0, 16-byte
// aligned rows); ptr [B + 1] int64 offsets into cols; out_s / out_i
// [B][splits][k]; items per split a multiple of kItems.
__global__ void __launch_bounds__(kThreads, 2)
rank_split(const int64_t* __restrict__ users, const float* __restrict__ ut,
           const float* __restrict__ it, const int64_t* __restrict__ ptr,
           const int64_t* __restrict__ cols, float* __restrict__ out_s,
           int* __restrict__ out_i, unsigned long long* bar_key, unsigned* bar_lo, int B,
           int n_items, int d, int k, int splits, int per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc = (k + 31) & ~31;
  const int ustride = d + 4;
  float* us = reinterpret_cast<float*>(smem);  // [kUsers][d + 4]
  float* is = us + kUsers * ustride;           // [2][kItems][kStride]
  Lists L;
  L.ls = kc + 1;
  L.s = is + 2 * kItems * kStride;
  L.x = L.s + kUsers * L.ls;
  L.cx = L.x + kUsers * L.ls;
  L.cs = L.cx + 8 * kCand;
  L.lo = L.cs + 8 * kCand;
  L.ts = L.lo + kUsers;
  L.i = reinterpret_cast<int*>(L.ts + kUsers);
  L.ci = L.i + kUsers * L.ls;
  L.cu = L.ci + 8 * kCand;
  L.n = L.cu + 8 * kCand;
  L.ti = L.n + kUsers;
  L.w = L.ti + kUsers;
  L.ex_at = L.w + kUsers;
  L.ex_n = L.ex_at + kUsers;
  L.ex_in = L.ex_n + kUsers;
  L.ex_cur = L.ex_in + kUsers;
  L.ex = L.ex_cur + kUsers;
  L.bs = reinterpret_cast<float*>(L.ex + kExclCap);
  L.bi = reinterpret_cast<int*>(L.bs + kUsers);
  L.bar_key = bar_key;
  L.bar_lo = bar_lo;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = blockIdx.x * kUsers;
  const int split = blockIdx.y;
  const int i_begin = split * per_split;
  const int i_end = min(n_items, i_begin + per_split);
  const int64_t* gcols = cols + ptr[0];

  // the block's user rows (zeros past B), its users' state and train positives
  const int q = d / 4;
  for (int c = tid; c < kUsers * q; c += kThreads) {
    const int r = c / q, f = (c - r * q) * 4;
    const bool ok = u0 + r < B;
    const float* src = ut + (ok ? users[u0 + r] * static_cast<int64_t>(d) + f : 0);
    cp16(us + r * ustride + f, src, ok);
  }
  if (warp == 0) {
    // lists' lengths and places; the first ones that fit go to shared memory
    int base = 0;
    for (int r0 = 0; r0 < kUsers; r0 += 32) {
      const int r = r0 + lane;
      int64_t a = 0, b = 0;
      if (u0 + r < B) { a = ptr[u0 + r]; b = ptr[u0 + r + 1]; }
      const int len = static_cast<int>(b - a);
      int incl = len;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int start = base + incl - len;
      const bool in = start + len <= kExclCap;
      L.n[r] = 0;
      L.lo[r] = u0 + r < B ? -INFINITY : INFINITY;  // a row past B takes nothing
      L.ts[r] = -INFINITY;
      L.ti[r] = 0x7fffffff;
      L.w[r] = 0;
      L.ex_n[r] = len;
      L.ex_in[r] = in;
      L.ex_cur[r] = 0;
      L.bs[r] = -INFINITY;
      L.bi[r] = 0x7fffffff;
      L.ex_at[r] = in ? start : static_cast<int>(a - ptr[0]);
      base += __shfl_sync(kFull, incl, 31);
    }
  }
  __syncthreads();
  for (int r = warp; r < kUsers; r += kThreads / 32) {
    if (!L.ex_in[r] || u0 + r >= B) continue;
    const int64_t a = ptr[u0 + r];
    for (int e = lane; e < L.ex_n[r]; e += 32)
      L.ex[L.ex_at[r] + e] = static_cast<int>(cols[a + e]);
  }

  const int nchunks = (d + kChunk - 1) / kChunk;
  const int ntiles = (i_end - i_begin + kItems - 1) / kItems;
  const int total = ntiles * nchunks;
  auto load = [&](int t) {
    const int tile = t / nchunks, kc0 = (t - tile * nchunks) * kChunk;
    const int w4 = min(kChunk, d - kc0) / 4;
    float* dst = is + (t & 1) * kItems * kStride;
    const int first = i_begin + tile * kItems;
    for (int c = tid; c < kItems * w4; c += kThreads) {
      const int row = c / w4, f = (c - row * w4) * 4;
      const bool ok = first + row < i_end;
      const float* src = it + (ok ? static_cast<int64_t>(first + row) * d + kc0 + f : 0);
      cp16(dst + row * kStride + f, src, ok);
    }
  };
  if (total > 0) load(0);
  cp_commit();

  unsigned long long bar = 0;  // lane u < 8: user 8w+u's, as read at the tile's start
  unsigned bar_lo_bits = 0;
  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[u][j] = 0.f;

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) load(t + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int tile = t / nchunks, kc0 = (t - tile * nchunks) * kChunk;
    const int w = min(kChunk, d - kc0);
    // the bar, read at a tile's first stage: a stale bar is still a bound,
    // and the read is ready by the tile's selection
    if (kc0 == 0 && lane < 8 && u0 + 8 * warp + lane < B) {
      bar = __ldcg(bar_key + u0 + 8 * warp + lane);
      bar_lo_bits = __ldcg(bar_lo + u0 + 8 * warp + lane);
    }
    const float* ib = is + (t & 1) * kItems * kStride + lane * kStride;
    const float* ub = us + (8 * warp) * ustride + kc0;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      if (kk < w) {
        float4 iv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          iv[j] = *reinterpret_cast<const float4*>(ib + j * 32 * kStride + kk);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 uv = *reinterpret_cast<const float4*>(ub + u * ustride + kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[u][j] = __fmaf_rn(uv.x, iv[j].x, acc[u][j]);
            acc[u][j] = __fmaf_rn(uv.y, iv[j].y, acc[u][j]);
            acc[u][j] = __fmaf_rn(uv.z, iv[j].z, acc[u][j]);
            acc[u][j] = __fmaf_rn(uv.w, iv[j].w, acc[u][j]);
          }
        }
      }
    }
    if (kc0 + kChunk >= d) {  // the tile's products are whole: select
      const int col = i_begin + tile * kItems;
      if (lane < 8 && bar != 0) {  // the owners take in their users' bars
        const int r = 8 * warp + lane;
        const float s = from_order(static_cast<unsigned>(bar >> 32));
        const int i = static_cast<int>(0xffffffffu - static_cast<unsigned>(bar));
        if (better(s, i, L.bs[r], L.bi[r])) { L.bs[r] = s; L.bi[r] = i; }
        L.lo[r] = fmaxf(L.lo[r], from_order(bar_lo_bits));
      }
      __syncwarp();
      if (tile == 0) first_filter(L, acc, u0, warp, lane, B, k, col, i_end, gcols);
      // the filters as they stand (rows past B: +inf, nothing passes)
      float lo[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) lo[u] = L.lo[8 * warp + u];
      const unsigned below = (1u << lane) - 1;
      float* cx = L.cx + warp * kCand;
      float* cs = L.cs + warp * kCand;
      int* ci = L.ci + warp * kCand;
      int* cu = L.cu + warp * kCand;
      for (int from = 0;; from += kCand) {
        // gather the products that pass, by user then item, kCand at a time
        int total = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int item = col + 32 * j + lane;
            const bool pass = item < i_end && acc[u][j] >= lo[u];
            const unsigned m = __ballot_sync(kFull, pass);
            const int slot = total + __popc(m & below) - from;
            if (pass && slot >= 0 && slot < kCand) {
              cx[slot] = acc[u][j];
              ci[slot] = item;
              cu[slot] = u;
            }
            total += __popc(m);
          }
        }
        const int cnt = min(total - from, kCand);
        if (cnt <= 0) break;
        __syncwarp();
        // the exact sigmoid of each, lane-dense; the ones that beat their
        // user's k-th and bar stay, in order, counted by user
        int kept = 0, by_user = 0;  // lane u < 8 counts user u's
        for (int e0 = 0; e0 < cnt; e0 += 32) {
          const int e = e0 + lane;
          bool keep = false;
          float x = 0.f, sg = 0.f;
          int item = 0, u = 0;
          if (e < cnt) {
            x = cx[e];
            item = ci[e];
            u = cu[e];
            const int r = 8 * warp + u;
            sg = sigmoid(x);
            keep = (L.n[r] < k || better(sg, item, L.ts[r], L.ti[r])) &&
                   better(sg, item, L.bs[r], L.bi[r]);
          }
          const unsigned m = __ballot_sync(kFull, keep);
          __syncwarp();
          if (keep) {
            const int p = kept + __popc(m & below);
            cx[p] = x;
            cs[p] = sg;
            ci[p] = item;
            cu[p] = u;
          }
          kept += __popc(m);
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const int c = __popc(__ballot_sync(kFull, keep && u == v));
            by_user += lane == v ? c : 0;
          }
          __syncwarp();
        }
        if (kept) {
          // user g's survivors: [start, start + by_user of lane g)
          int start = by_user;
          for (int o = 1; o < 8; o <<= 1) {
            const int v = __shfl_up_sync(kFull, start, o);
            if (lane >= o) start += v;
          }
          start -= by_user;
          int rounds = by_user;
          for (int o = 4; o; o >>= 1) rounds = max(rounds, __shfl_xor_sync(kFull, rounds, o));
          rounds = __shfl_sync(kFull, rounds, 0);
          const int g = lane >> 2;
          const int a = __shfl_sync(kFull, start, g);
          const int e = a + __shfl_sync(kFull, by_user, g);
          insert_groups(L, 8 * warp + g, u0 + 8 * warp + g, a, e, rounds, k, gcols, lane);
          __syncwarp();
        }
        if (total - from <= kCand) break;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[u][j] = 0.f;
    }
    __syncthreads();
  }
  cp_wait<0>();

  // each user's list of the split, sorted by (value descending, index
  // ascending): an entry's place is the number of entries that beat it; a
  // split of fewer than k items pads with (-inf, INT_MAX), which loses to all
  for (int u = 0; u < 8; ++u) {
    const int r = 8 * warp + u;
    if (u0 + r >= B) break;
    const int n = L.n[r];
    const float* ls = L.s + r * L.ls;
    const int* li = L.i + r * L.ls;
    const int64_t o = (static_cast<int64_t>(u0 + r) * splits + split) * k;
    for (int e = lane; e < k; e += 32) {
      if (e < n) {
        const float es = ls[e];
        const int ei = li[e];
        int place = 0;
        for (int f = 0; f < n; ++f) place += better(ls[f], li[f], es, ei);
        out_s[o + place] = es;
        out_i[o + place] = ei;
      } else {
        out_s[o + e] = -INFINITY;
        out_i[o + e] = 0x7fffffff;
      }
    }
  }
}

// One warp a user: the k best of its `splits` sorted lists, in torch.topk's
// order. splits <= 64.
__global__ void __launch_bounds__(kThreads)
merge(const float* __restrict__ in_s, const int* __restrict__ in_i, int64_t* __restrict__ out,
      int B, int k, int splits) {
  __shared__ float ws[kThreads / 32][128];
  __shared__ int wi[kThreads / 32][128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (kThreads / 32) + warp;
  if (r >= B) return;
  const float* rs = in_s + static_cast<int64_t>(r) * splits * k;
  const int* ri = in_i + static_cast<int64_t>(r) * splits * k;
  // lane l holds the heads of lists l and l + 32
  int h0 = 0, h1 = 0;
  const bool has0 = lane < splits, has1 = lane + 32 < splits;
  float s0 = has0 ? rs[lane * k] : -INFINITY, s1 = has1 ? rs[(lane + 32) * k] : -INFINITY;
  int i0 = has0 ? ri[lane * k] : 0x7fffffff, i1 = has1 ? ri[(lane + 32) * k] : 0x7fffffff;
  for (int e = 0; e < k; ++e) {
    const bool first = !better(s1, i1, s0, i0);
    float bs = first ? s0 : s1;
    int bi = first ? i0 : i1;
    for (int o = 16; o; o >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
    }
    if (lane == 0) { ws[warp][e] = bs; wi[warp][e] = bi; }
    // the owner of the winner moves its head on (item indices are unique)
    if (has0 && i0 == bi && s0 == bs) {
      ++h0;
      s0 = h0 < k ? rs[lane * k + h0] : -INFINITY;
      i0 = h0 < k ? ri[lane * k + h0] : 0x7fffffff;
    } else if (has1 && i1 == bi && s1 == bs) {
      ++h1;
      s1 = h1 < k ? rs[(lane + 32) * k + h1] : -INFINITY;
      i1 = h1 < k ? ri[(lane + 32) * k + h1] : 0x7fffffff;
    }
  }
  __syncwarp();
  int64_t* o = out + static_cast<int64_t>(r) * k;
  if (k == 1 || k > 32) {
    for (int e = lane; e < k; e += 32) o[e] = wi[warp][e];
    return;
  }
  // torch.topk's layout: the entries above the k-th, then those equal to it,
  // each group in ascending index (its gather pass), then its bitonic sort
  const bool valid = lane < k;
  float s = valid ? ws[warp][lane] : -INFINITY;
  int i = valid ? wi[warp][lane] : 0x7fffffff;
  const float kth = ws[warp][k - 1];
  const int grp = s > kth ? 0 : 1;
  int at = 0;
  for (int l = 0; l < k; ++l) {
    const int og = __shfl_sync(kFull, grp, l), oi = __shfl_sync(kFull, i, l);
    at += (og < grp || (og == grp && oi < i)) ? 1 : 0;
  }
  __syncwarp();
  if (valid) { ws[warp][at] = s; wi[warp][at] = i; }
  __syncwarp();
  s = valid ? ws[warp][lane] : -INFINITY;
  i = valid ? wi[warp][lane] : 0;
  bool v = valid;
  auto step = [&](int size, int stride, bool final) {
    const float os = __shfl_xor_sync(kFull, s, stride);
    const int oi = __shfl_xor_sync(kFull, i, stride);
    const bool ov = __shfl_xor_sync(kFull, v, stride);
    const bool lead = !(lane & stride);
    const float ka = lead ? s : os, kb = lead ? os : s;
    const bool va = lead ? v : ov, vb = lead ? ov : v;
    const int p = lead ? lane : (lane ^ stride);
    const int pair = ((p >> 1) & ~(stride - 1)) | (p & (stride - 1));
    const bool dir = final ? false : (pair & (size / 2)) != 0;
    const bool swap = (ka > kb && va) || !vb;
    if (swap == dir) { s = os; i = oi; v = ov; }
  };
  for (int size = 2; size < 32; size *= 2)
    for (int stride = size / 2; stride > 0; stride /= 2) step(size, stride, false);
  for (int stride = 16; stride > 0; stride /= 2) step(32, stride, true);
  if (lane < k) o[lane] = i;
}

size_t split_smem(int d, int k) {
  const size_t kc = (k + 31) & ~31;
  return 4 * (static_cast<size_t>(kUsers) * (d + 4) + 2 * kItems * kStride)
       + 12 * kUsers * (kc + 1) + 8 * kUsers * 32 + 4 * 12 * kUsers + 4 * kExclCap;
}

}  // namespace

extern "C" {

// Shared memory of pass 1 at width d and k; above the card's per-block
// limit the op cannot run.
long long score_topk_smem(int d, int k) { return static_cast<long long>(split_smem(d, k)); }

// Item splits pass 1 uses for a batch of b users: one wave of its blocks on
// the current card, at most 64 and at most one a tile of items; 0 if the
// block does not fit.
int score_topk_splits(int b, int n_items, int d, int k) {
  const size_t smem = split_smem(d, k);
  if (cudaFuncSetAttribute(rank_split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rank_split, kThreads, smem);
  if (per_sm <= 0) return 0;
  const int tiles_u = (b + kUsers - 1) / kUsers;
  const int tiles_i = (n_items + kItems - 1) / kItems;
  int s = (sms * per_sm) / tiles_u;
  s = s < 1 ? 1 : s;
  s = s > 64 ? 64 : s;
  s = s > tiles_i ? tiles_i : s;
  // equal splits of whole tiles: the count that covers the items
  const int per = ((tiles_i + s - 1) / s) * kItems;
  return (n_items + per - 1) / per;
}

// users: int64 [b]; ut: float32 [*, d]; it: float32 [n_items, d]; ptr: int64
// [b + 1] into cols: int64, each row's items sorted; scratch: (8 * splits * k
// + 12) * b bytes (splits from score_topk_splits); out: int64 [b, k]. 1 <= k <=
// 128 and k <= n_items, d % 4 == 0, tables 16-byte aligned.
// Returns the first CUDA error.
int score_topk(const void* users, const void* ut, const void* it, const void* ptr,
               const void* cols, void* scratch, void* out, int b, int n_items, int d, int k,
               int splits, void* stream) {
  if (b <= 0 || n_items <= 0 || d <= 0 || d % 4 || k < 1 || k > 128 || k > n_items ||
      splits < 1 || splits > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = split_smem(d, k);
  cudaError_t e = cudaFuncSetAttribute(rank_split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_i = (n_items + kItems - 1) / kItems;
  const int per = ((tiles_i + splits - 1) / splits) * kItems;
  if ((n_items + per - 1) / per != splits) return static_cast<int>(cudaErrorInvalidValue);
  float* part_s = static_cast<float*>(scratch);
  int* part_i = reinterpret_cast<int*>(part_s + static_cast<int64_t>(b) * splits * k);
  auto* bar_key =
      reinterpret_cast<unsigned long long*>(part_i + static_cast<int64_t>(b) * splits * k);
  auto* bar_lo = reinterpret_cast<unsigned*>(bar_key + b);
  e = cudaMemsetAsync(bar_key, 0, 12 * static_cast<size_t>(b), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((b + kUsers - 1) / kUsers, splits);
  rank_split<<<grid, kThreads, smem, st>>>(
      static_cast<const int64_t*>(users), static_cast<const float*>(ut),
      static_cast<const float*>(it), static_cast<const int64_t*>(ptr),
      static_cast<const int64_t*>(cols), part_s, part_i, bar_key, bar_lo, b, n_items, d, k,
      splits, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge<<<(b + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      part_s, part_i, static_cast<int64_t*>(out), b, k, splits);
  return static_cast<int>(cudaGetLastError());
}

const char* score_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
