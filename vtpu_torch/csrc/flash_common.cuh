// Shared by the flash-attention sources (flash_attention_sm90.cu,
// flash_attention_tf32x3.cu): the problem description, the reference's
// keep rule, and the tile bounds that skip fully masked tiles.
#pragma once

#include "common.cuh"

namespace vtpu {
namespace flash {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHd = 128;      // the entries up to hd 128
constexpr int kMaxWideHd = 512;  // the _wide entries, above it

struct Problem {
  int g;            // query heads per kv head
  int seq_q, seq_k, hd;
  int causal, shift, window;
  float sm_scale;
};

__device__ __forceinline__ bool keep(const Problem& P, int q, int k) {
  if (q >= P.seq_q || k >= P.seq_k) return false;
  if (!P.causal) return true;
  const int qp = q + P.shift;
  return k <= qp && (P.window <= 0 || k > qp - P.window);
}

// Every (q, k) with q in [q0, q0 + nq) and k in [k0, k0 + nk) is kept:
// the tile needs no mask.
__device__ __forceinline__ bool all_kept(const Problem& P, int q0, int nq,
                                         int k0, int nk) {
  if (q0 + nq > P.seq_q || k0 + nk > P.seq_k) return false;
  if (!P.causal) return true;
  if (k0 + nk - 1 > q0 + P.shift) return false;
  return P.window <= 0 || k0 > q0 + nq - 1 + P.shift - P.window;
}

// kv tiles (bn keys each) [lo, hi) that can hold a kept key for rows
// [q0, q0 + bm): the reference's _window_lo and _causal_hi
__device__ __forceinline__ void kv_range(const Problem& P, int q0, int bm,
                                         int bn, int& lo, int& hi) {
  const int n = (P.seq_k + bn - 1) / bn;
  lo = 0;
  hi = n;
  if (!P.causal) return;
  const int last = min(q0 + bm - 1, P.seq_q - 1) + P.shift;
  hi = last < 0 ? 0 : min(n, last / bn + 1);
  if (P.window > 0) {
    const int first = q0 + P.shift - P.window + 1;
    lo = first <= 0 ? 0 : first / bn;
  }
}

// q tiles (bq rows each) [lo, hi) that can hold a kept row for keys
// [k0, k0 + bn)
__device__ __forceinline__ void q_range(const Problem& P, int k0, int bn,
                                        int bq, int& lo, int& hi) {
  const int n = (P.seq_q + bq - 1) / bq;
  lo = 0;
  hi = n;
  if (!P.causal) return;
  const int first = k0 - P.shift;
  lo = first <= 0 ? 0 : min(n, first / bq);
  if (P.window > 0) {
    const int last = min(k0 + bn - 1, P.seq_k - 1) - P.shift +
                     P.window - 1;
    hi = last < 0 ? 0 : min(n, last / bq + 1);
  }
}

inline bool make_problem(Problem& P, int n_q, int g, int seq_q, int seq_k,
                         int hd, int causal, int shift, int window,
                         float sm_scale, int max_hd = kMaxHd) {
  if (n_q <= 0 || g <= 0 || n_q % g != 0 || seq_q <= 0 || seq_k <= 0 ||
      hd <= 0 || hd > max_hd || n_q > 65535 || window < 0)
    return false;
  P.g = g;
  P.seq_q = seq_q;
  P.seq_k = seq_k;
  P.hd = hd;
  P.causal = causal;
  P.shift = shift;
  P.window = window;
  P.sm_scale = sm_scale;
  return true;
}

}  // namespace flash
}  // namespace vtpu
