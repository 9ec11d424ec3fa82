// Flash attention on Hopper's tensor cores (sm_90a), bf16 inputs with
// f32 accumulation: the forward (o and the per-row logsumexp) and both
// backward kernels (dq; dk and dv), the training path's three attention
// kernels, and the forward with f32 o that ring attention's partials
// take.  The entries and the Pallas TPU kernels of vtpu/ops/attention.py
// they replace:
//
//   vtpu_flash_fwd_bf16          flash_fwd_tc<HD, bf16>  <- _attn_kernel
//                                                           (_flash_2d)
//   vtpu_flash_fwd_bf16_f32out   flash_fwd_tc<HD, float> <- _attn_kernel
//                                (pallas_call at :409, reached from
//                                flash_attention_with_lse)
//   vtpu_flash_bwd_dq_bf16       flash_dq_tc  <- _attn_bwd_dq_kernel
//                                                (_flash_bwd_2d)
//   vtpu_flash_bwd_dkv_bf16      flash_dkv_tc <- _attn_bwd_dkv_kernel
//                                                (_flash_bwd_2d)
//   vtpu_flash_fwd_wide_bf16     flash_fwd_split_tc<256, bf16>,
//                                flash_fwd_wide_tc<512, bf16>
//   vtpu_flash_fwd_wide_bf16_f32out
//                                flash_fwd_split_tc<256, float>,
//                                flash_fwd_wide_tc<512, float>
//                                <- _attn_kernel (pallas_call at :409,
//                                reached from _flash_2d and
//                                flash_attention_with_lse)
//   vtpu_flash_bwd_dq_wide_bf16  flash_dq_split_tc, flash_dq_wide_tc
//                                <- _attn_bwd_dq_kernel (pallas_call at
//                                :441, reached from _flash_bwd_2d)
//   vtpu_flash_bwd_dkv_wide_bf16 flash_dkv_split_tc, flash_dkv_wide_tc
//                                <- _attn_bwd_dkv_kernel (pallas_call at
//                                :459, reached from _flash_bwd_2d)
//
// The _wide entries take 128 < hd <= 512: the split kernels up to hd 256,
// the chunked (_wide_tc) ones above.  The f32 entries (forward, dq and
// dk/dv) run on the tensor cores as 3xTF32 in flash_attention_tf32x3.cu,
// whose layouts, masks and numerics these kernels share: q,
// o, do [N, seq_q, hd]; k, v, dk, dv [N / g, seq_k, hd]; lse, delta
// [N, seq_q] f32; query head n reads kv head n / g; m starts at -1e30, a
// masked p is forced to 0, l is clamped at 1e-30, lse = m + log(l) in
// natural log.  Every sequence length, window, shift 0 / -1, non-causal
// and hd <= 128 runs these kernels.
//
// The f32-out forward keeps its o within 2e-5 of the plain f32 version,
// so it cannot round p to bf16 before P V as the bf16 forward does (that
// costs up to 2^-8 of the largest |v|).  It splits p instead:
// p_hi = bf16(p), p_lo = bf16(p - p_hi) (the f32 subtraction is exact),
// and issues two mma.sync per k-step into the same f32 sums.  p_hi +
// p_lo misses p by at most 2^-17 p (|p - p_hi| < 2^(e-8) for p in
// [2^e, 2^(e+1)), and p_lo rounds that at 8 bits), so o misses by at
// most 2^-17 max|v|; the errors carry random signs, and on randn inputs
// at b 2, H 32, s 4096, hd 128 they stay under 1e-5.  Q K^T of bf16
// inputs is exact per product with f32 sums, and l sums the f32 p, as in
// the bf16 forward.  The split doubles P V, half the products, so the
// forward issues half again as many mma.sync (192 against 128 a tile at
// hd 128).
//
// What bounds them on an H100: operations.  The forward does 4 * hd
// flops per kept (query, key) pair (Q K^T and P V), dq 6 * hd (Q K^T,
// dO V^T, dS K), dk/dv 8 * hd (Q K^T, dO V^T, P^T dO, dS^T Q).  Causal at
// b 2, H 32, s 4096, hd 128 that is 537,001,984 kept pairs: 2.7e11 flops
// for the forward, 0.28 ms at the 989 TFLOP/s bf16 tensor-core peak,
// 0.42 ms for dq and 0.56 ms for dk/dv; their bytes (q, k, v, o, do,
// lse, delta once each) take ~0.06 ms at 3.35 TB/s.  The f32-out
// forward does the forward's flops (0.28 ms there; its split's extra
// products are the kernel's, not the function's), but at a ring shard
// (b 1, H 32, s 1024, hd 128, causal) bytes bound it: q, k, v in bf16,
// o and lse in f32 are 42 MB, 0.0126 ms, against 8.6e9 flops, 0.0087 ms.
// What the design does about it:
//
//  - Products on the tensor cores: mma.sync m16n8k16 bf16 with f32
//    accumulators, operands brought from shared memory by ldmatrix
//    (.trans for V in P V, K in dS K, dO in P^T dO and Q in dS^T Q).
//    Tiles are staged in bf16, not widened (a 64 x 128 tile is 17 KB
//    with its padding); each row is padded by 16 bytes so the eight
//    16-byte rows of one ldmatrix fall on distinct banks.
//  - P and dS never touch shared memory: the m16n8 accumulator layout is
//    the A-operand layout of m16n8k16, so they are rounded to bf16 pairs
//    in registers and fed to the next product (FlashAttention-2's
//    register reuse).  The f32-out forward packs each k-step's p_hi and
//    p_lo fragments just before that k-step's products, not all of P
//    first, so the split adds 8 live registers, not a second P array.
//  - Online softmax on the fragments: each thread holds two rows of its
//    warp's 16-row slab, so a row max is two quad shuffles; the row sum
//    stays per thread until the end.  Scores are scaled by
//    sm_scale * log2(e), so p = exp2(s - m) is one FMA and one MUFU op,
//    and lse returns to natural log at the end.
//  - An asynchronous ring of three stages (cp.async.cg 16-byte copies,
//    one commit group a tile): tiles t + 1 and t + 2 are in flight while
//    tile t is multiplied, and one barrier a tile both publishes tile t
//    and frees the stage of tile t - 1 for the next copy.  K/V tiles for
//    the forward and dq; Q, dO, lse and delta tiles for dk/dv.  Rows past
//    the end and columns past hd arrive as zeros.  Where hd % 8 != 0 or
//    a pointer is not 16-byte aligned, the same tiles are staged by plain
//    loads instead.
//  - Masks only where needed: keep() runs on a warp's tile only when the
//    tile straddles the causal diagonal, the window edge or the ragged
//    end; tiles wholly outside the band are skipped with the reference's
//    bounds (kv_range, q_range in flash_common.cuh).
//  - Forward: one block of 8 warps per (128-row q tile, query head),
//    16 rows a warp with its Q fragments held in registers, 64-key K/V
//    tiles.  dk/dv: one block of 4 warps per (64-key tile, kv head),
//    16 keys a warp, K and V resident in shared memory, looping over the
//    g query heads of its group and their 32-row q tiles with dk and dv
//    summed in registers and written once (no atomics).  32-row q tiles
//    keep dk, dv (128 f32 a thread at hd 128) and the score fragments
//    within the register file without spills.  dq: one block of 8 warps
//    per (128-row q tile, query head), 16 rows a warp, 64-key K/V tiles
//    on the forward's ring; lse and delta of a thread's two rows read
//    once into registers; dq (64 f32 a thread at hd 128) summed in
//    registers and written once (no atomics: one block owns its rows).
//    Q and dO stay in shared memory and their A fragments are reloaded
//    each k-step, as dk/dv reloads K and V, so dq, S and dP (64 + 32 +
//    32 f32) are the only large live state: 244 registers at hd 128
//    (211 at 64), no spills.  Q, dO and the three-stage ring of 64-key K
//    and V tiles take 174,080 bytes of shared memory at hd 128, so one
//    block (8 warps) an SM.
//  - Heavy first: under causal masking the last q tiles (forward, dq)
//    and dk/dv's first k tiles do the most work; block indices map them to
//    the first blocks launched, across heads, so the grid's tail is the
//    light tiles.
//
// The wide forward and backward (128 < hd <= 512).  Their bound is the
// same: causal at b 2, 16 heads of 256 over 4 kv heads, s 4096 (the
// training widths as heads of 256) there are 268,500,992 kept pairs, so
// the forward's 4 * hd flops a pair take 0.278 ms (its bytes 0.05 ms),
// dq's 6 * hd 0.417 ms and dk/dv's 8 * hd 0.556 ms at 989 TFLOP/s.  What
// does not carry over from the kernels above is one warp holding every
// column of its rows' output: the forward's o would be hd / 2 f32 a
// thread beside Q's fragments (128 and 64 at hd 256), dq's accumulator
// hd / 2 and dk + dv's hd, beside S and dP; and the resident tiles with
// their rings would pass an SM's 232,448 bytes of shared memory (the
// forward's 128-row Q tile and three K/V stages: 270,336 at hd 256; dq's
// Q, dO and three K/V stages: 337,920).  So a warp holds kWideC = 128
// columns of o, of dq, or of dk and dv (64, 64 and 128 f32 a thread, as
// at hd 128), and the columns are split one of two ways; for the
// backward both were built and timed at that shape, in turns on one card
// (PERF.md, the wide backward's findings), and the forward follows it:
//
//  - The forward, over the warps of a block up to hd 256
//    (flash_fwd_split_tc): a slab's two warps compute S once, each for 32
//    of a tile's 64 keys, exchange their row maxima and hand p on in
//    shared memory as bf16 (two barriers of the slab's 64 threads a
//    tile); 64-row q tiles, three K/V stages with Q riding in the last
//    until its first refill: 212,480 bytes (221,696 with f32 o, p_hi and
//    p_lo both).  Above hd 256 over blocks (flash_fwd_wide_tc): a block
//    owns one 128-column chunk of o and recomputes S, (nc + 1) / 2 of the
//    forward's products (2.5x at hd 512); 128-row q tiles with Q resident,
//    three K chunk stages and two V chunk buffers: 220,160 bytes.  The
//    f32-out twins split p into p_hi + p_lo as flash_fwd_tc<HD, float>.
//
//  - Over the warps of a block (hd <= 256; flash_dq_split_tc,
//    flash_dkv_split_tc): 8 warps, 4 slabs of 16 rows (query rows for
//    dq, keys for dk/dv) by 2 column halves.  The two warps of a slab
//    compute S and dP once, each for half of the other side (dq: 32 of
//    the 64 keys of a K/V tile; dk/dv: 16 of the 32 rows of a q tile)
//    over every column, and hand P and dS on in shared memory as bf16
//    (one barrier); each warp then multiplies its slab's P and dS by its
//    column half.  Nothing is recomputed.  dq: 64-row q tiles, Q and dO
//    resident, two stages of a 64-key K and V tile (211,968 bytes of
//    shared memory, one block an SM); dk/dv: K and V resident, three
//    stages of a 32-row Q and dO tile with lse, delta (179,968 bytes).
//    2.48 and 3.35-3.38 ms at the shape above.
//  - Over blocks in 128-column chunks (256 < hd <= 512;
//    flash_dq_wide_tc<512>, flash_dkv_wide_tc<512>): a block owns one
//    chunk and recomputes S and dP over the whole head for it, with the
//    streamed operand staged through the ring one (tile, chunk) step at
//    a time (below, "head dims above 128").  At hd 512 that is 3x dq's
//    products and 2.5x dk/dv's; at hd 256 it was 1.67x and 1.5x, and
//    3.50-3.53 / 4.67 ms, so the split layout took hd <= 256.  At hd 512
//    the split layout does not fit: dq's Q and dO (64 rows) with one K
//    and V stage take 266,240 bytes, and so do dk/dv's K and V with two
//    Q and dO stages.
//  - dk/dv at the small grids (b 1, s 512: 16-64 blocks for 132 SMs):
//    a cluster of up to 8 blocks shares a cell's (query head, q tile)
//    steps, and the partial dk and dv are summed through distributed
//    shared memory in cluster-rank order, not by atomics: dq, dk and dv
//    do not depend on the order in which blocks run.
//  - P and dS are rounded to bf16 in registers before their products,
//    as above: dq, dk and dv stay within two bf16 ulps of the plain
//    versions, as at hd <= 128.  Masks only on straddling tiles, heavy
//    tiles first, the plain-load staging where hd % 8 != 0 or a pointer
//    is unaligned, k-steps and column groups wholly past hd skipped.

#include <climits>
#include <initializer_list>
#include <type_traits>

#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using vtpu::flash::all_kept;
using vtpu::flash::keep;
using vtpu::flash::kNegInf;
using vtpu::flash::kv_range;
using vtpu::flash::make_problem;
using vtpu::flash::Problem;
using vtpu::flash::q_range;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kFwdThreads = 256;  // 8 warps x 16 query rows
constexpr int kFwdM = 128;        // query rows per block
constexpr int kFwdN = 64;         // keys per K/V tile
constexpr int kDkvThreads = 128;  // 4 warps x 16 keys
constexpr int kDkvN = 64;         // keys per block
constexpr int kDkvQ = 32;         // query rows per Q/dO tile
constexpr int kDqThreads = 256;   // 8 warps x 16 query rows
constexpr int kDqM = 128;         // query rows per block
constexpr int kDqN = 64;          // keys per K/V tile
constexpr int kStages = 3;        // ring depth: two tiles in flight

// -- PTX -------------------------------------------------------------------
using vtpu::cp_async16;
using vtpu::cp_async4;
using vtpu::cp_commit;
using vtpu::cp_wait;
using vtpu::smem_u32;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row-major) * b (16 x 8, col-major): bf16, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (a, b) as two bf16 pairs whose sum is (a, b) to 2^-17 of each: hi
// rounds (a, b), lo rounds what hi missed (exact in f32)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// -- staging ---------------------------------------------------------------
// Stage rows [row0, row0 + ROWS) and columns [0, w) of a matrix whose
// rows are `ld` apart (src points at its first column) as ROWS rows of
// W columns (row stride W + 8), zero past `rows` and past w.  vec: 16-byte
// cp.async copies (w, ld and src multiples of 8 elements); else plain loads.
template <int ROWS, int W, int NTHREADS>
__device__ __forceinline__ void stage_cols(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int row0, int rows, int ld, int w,
                                           bool vec) {
  constexpr int S = W + 8;
  if (vec) {
    constexpr int CH = W / 8;  // 16-byte chunks a row
    constexpr int N = ROWS * CH;
#pragma unroll
    for (int it = 0; it < (N + NTHREADS - 1) / NTHREADS; ++it) {
      const int i = threadIdx.x + it * NTHREADS;
      if (N % NTHREADS != 0 && i >= N) break;
      const int r = i / CH, c = (i % CH) * 8;
      const int row = row0 + r;
      const bool ok = row < rows && c < w;
      cp_async16(smem_u32(dst + r * S + c),
                 ok ? src + static_cast<size_t>(row) * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * W; i += NTHREADS) {
      const int r = i / W, c = i % W;
      const int row = row0 + r;
      dst[r * S + c] = row < rows && c < w
                           ? src[static_cast<size_t>(row) * ld + c]
                           : __float2bfloat16(0.f);
    }
  }
}

// lse and delta of rows [row0, row0 + kDkvQ) into dst[0..Q) and
// dst[Q..2Q), zero past `rows`
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int row0, int rows) {
  for (int i = threadIdx.x; i < 2 * kDkvQ; i += kDkvThreads) {
    const float* src = i < kDkvQ ? lse : delta;
    const int row = row0 + i % kDkvQ;
    const bool ok = row < rows;
    cp_async4(smem_u32(dst + i), ok ? src + row : src, ok);
  }
}

// (a, b) as bf16 into columns col, col + 1 of row `row` of a [rows, hd]
// matrix, dropping what lies outside it
__device__ __forceinline__ void store_pair(bf16* __restrict__ dst, int row,
                                           int col, float a, float b,
                                           int rows, int hd) {
  if (row >= rows || col >= hd) return;
  bf16* p = dst + static_cast<size_t>(row) * hd + col;
  if (hd % 2 == 0) {  // col is even, so col + 1 < hd and p is 4-aligned
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (col + 1 < hd) p[1] = __float2bfloat16_rn(b);
  }
}

// the same for an f32 matrix
__device__ __forceinline__ void store_pair(float* __restrict__ dst, int row,
                                           int col, float a, float b,
                                           int rows, int hd) {
  if (row >= rows || col >= hd) return;
  float* p = dst + static_cast<size_t>(row) * hd + col;
  if (hd % 2 == 0) {  // col is even, so col + 1 < hd and p is 8-aligned
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (col + 1 < hd) p[1] = b;
  }
}

// -- forward ---------------------------------------------------------------
// O = bf16: p rounded to bf16 for P V.  O = float: p split into p_hi +
// p_lo, two products a k-step, o written in f32.
template <int HD, typename O>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, O* __restrict__ o,
                 float* __restrict__ lse, Problem P, int n_q, bool vec) {
  constexpr int S = HD + 8;   // staged row stride, elements
  constexpr int RB = 2 * S;   // and bytes
  constexpr int KT = HD / 16; // k-steps of Q K^T
  constexpr int NT = HD / 8;  // 8-column tiles of o
  constexpr int JT = kFwdN / 8;
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Ks = Qs + kFwdM * S;            // kStages stages of kFwdN rows
  bf16* Vs = Ks + kStages * kFwdN * S;  // kStages stages of kFwdN rows

  // heavy first: under causal masking the last q tiles see the most keys
  const int tiles = (P.seq_q + kFwdM - 1) / kFwdM;
  const int rank = blockIdx.x / n_q, n = blockIdx.x % n_q;
  const int q0 = (P.causal ? tiles - 1 - rank : rank) * kFwdM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = q0 + warp * 16;       // the warp's 16 rows
  const int r0 = w0 + lane / 4;        // this thread's rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);       // and columns c2, c2 + 1 of a tile
  const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  int lo, hi;
  kv_range(P, q0, kFwdM, kFwdN, lo, hi);
  // K/V tile t into ring stage st (nothing past hi)
  auto stage = [&](int t, int st) {
    if (t >= hi) return;
    stage_cols<kFwdN, HD, kFwdThreads>(Ks + st * kFwdN * S, kb, t * kFwdN,
                                       P.seq_k, P.hd, P.hd, vec);
    stage_cols<kFwdN, HD, kFwdThreads>(Vs + st * kFwdN * S, vb, t * kFwdN,
                                       P.seq_k, P.hd, P.hd, vec);
  };
  // one commit group per tile: Q rides with the first
  stage_cols<kFwdM, HD, kFwdThreads>(Qs, q + q_off, q0, P.seq_q, P.hd, P.hd,
                                     vec);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    stage(lo + i, i);
    cp_commit();
  }
  cp_wait<kStages - 2>();
  __syncthreads();

  uint32_t qf[KT][4];  // the warp's rows of Q as A fragments
  {
    const uint32_t a =
        smem_u32(Qs) + (warp * 16 + lane % 16) * RB + (lane / 16) * 16;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) ldsm_x4(qf[kk], a + kk * 32);
  }
  // ldmatrix row addresses: K as the col-major B of Q K^T, V transposed
  // as the B of P V (both stored keys x hd)
  const uint32_t k_lane =
      ((lane % 8) + (lane / 16) * 8) * RB + ((lane / 8) % 2) * 16;
  const uint32_t v_lane =
      ((lane % 8) + ((lane / 8) % 2) * 8) * RB + (lane / 16) * 16;
  constexpr uint32_t kStage = kFwdN * RB;
  const uint32_t ks = smem_u32(Ks) + k_lane, vs = smem_u32(Vs) + v_lane;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sc = P.sm_scale * kLog2e;

  for (int t = lo, st = 0; t < hi;
       ++t, st = st + 1 < kStages ? st + 1 : 0) {
    cp_wait<kStages - 2>();
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the next copy takes
    __syncthreads();
    stage(t + kStages - 1, st == 0 ? kStages - 1 : st - 1);
    cp_commit();

    float s[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j = 0; j < JT / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, ks + st * kStage + j * 16 * RB + kk * 32);
        mma(s[2 * j], qf[kk], b[0], b[1]);
        mma(s[2 * j + 1], qf[kk], b[2], b[3]);
      }

    const int k0 = t * kFwdN;
    const bool full = all_kept(P, w0, 16, k0, kFwdN);
    if (full) {
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sc;
    } else {
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = keep(P, r0 + (e / 2) * 8, k0 + 8 * j + c2 + e % 2)
                        ? s[j][e] * sc
                        : kNegInf;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p =
            full || x > kNegInf * 0.5f ? exp2f(x - m[e / 2]) : 0.f;
        s[j][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    if constexpr (std::is_same<O, float>::value) {
      // P V from p_hi + p_lo, each k-step's two fragments built just
      // before its products
#pragma unroll
      for (int kk = 0; kk < JT / 2; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t b[4];
          ldsm_x4_t(b, vs + st * kStage + kk * 16 * RB + j * 32);
          mma(acc[2 * j], hi, b[0], b[1]);
          mma(acc[2 * j + 1], hi, b[2], b[3]);
          mma(acc[2 * j], lo, b[0], b[1]);
          mma(acc[2 * j + 1], lo, b[2], b[3]);
        }
      }
    } else {
      // P as A fragments of P V, straight from the accumulators
      uint32_t pa[JT / 2][4];
#pragma unroll
      for (int kk = 0; kk < JT / 2; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
#pragma unroll
      for (int kk = 0; kk < JT / 2; ++kk)
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t b[4];
          ldsm_x4_t(b, vs + st * kStage + kk * 16 * RB + j * 32);
          mma(acc[2 * j], pa[kk], b[0], b[1]);
          mma(acc[2 * j + 1], pa[kk], b[2], b[3]);
        }
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float ls = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / ls;
    const int row = r0 + 8 * h;
    if (lane % 4 == 0 && row < P.seq_q)
      lse[static_cast<size_t>(n) * P.seq_q + row] =
          (m[h] <= kNegInf * 0.5f ? kNegInf : m[h] * kLn2) + logf(ls);
  }
  O* ob = o + q_off;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store_pair(ob, r0, 8 * j + c2, acc[j][0] * inv[0], acc[j][1] * inv[0],
               P.seq_q, P.hd);
    store_pair(ob, r0 + 8, 8 * j + c2, acc[j][2] * inv[1],
               acc[j][3] * inv[1], P.seq_q, P.hd);
  }
}

// -- dk / dv ---------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kDkvThreads, 2)
    flash_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, Problem P, int n_kv, bool vec) {
  constexpr int S = HD + 8;
  constexpr int RB = 2 * S;
  constexpr int KT = HD / 16;   // k-steps of K Q^T and V dO^T
  constexpr int NT = HD / 8;    // 8-column tiles of dk and dv
  constexpr int JT = kDkvQ / 8; // 8-query tiles of S^T
  extern __shared__ uint4 smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + kDkvN * S;
  bf16* Qs = Vs + kDkvN * S;             // kStages stages of kDkvQ rows
  bf16* dOs = Qs + kStages * kDkvQ * S;  // kStages stages of kDkvQ rows
  float* Rs = reinterpret_cast<float*>(dOs + kStages * kDkvQ * S);

  // heavy first: under causal masking the first keys see the most rows
  const int rank = blockIdx.x / n_kv, nk = blockIdx.x % n_kv;
  const int k0 = rank * kDkvN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = k0 + warp * 16;   // the warp's 16 keys
  const int kr = kw + lane / 4;    // this thread's keys kr, kr + 8
  const int c2 = 2 * (lane % 4);   // and query columns c2, c2 + 1
  const size_t kv_off = static_cast<size_t>(nk) * P.seq_k * P.hd;
  stage_cols<kDkvN, HD, kDkvThreads>(Ks, k + kv_off, k0, P.seq_k, P.hd, P.hd,
                                     vec);
  stage_cols<kDkvN, HD, kDkvThreads>(Vs, v + kv_off, k0, P.seq_k, P.hd, P.hd,
                                     vec);

  int lo, hi;
  q_range(P, k0, kDkvN, kDkvQ, lo, hi);
  const int nt = max(hi - lo, 0), iters = P.g * nt;
  // step i (query head nk * g + i / nt, q tile lo + i % nt) into ring
  // stage st: Q, dO, and lse, delta (nothing past the last step)
  auto stage = [&](int i, int st) {
    if (i >= iters) return;
    const int n = nk * P.g + i / nt;
    const int q0 = (lo + i % nt) * kDkvQ;
    const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
    const size_t r_off = static_cast<size_t>(n) * P.seq_q;
    stage_cols<kDkvQ, HD, kDkvThreads>(Qs + st * kDkvQ * S, q + q_off, q0,
                                       P.seq_q, P.hd, P.hd, vec);
    stage_cols<kDkvQ, HD, kDkvThreads>(dOs + st * kDkvQ * S, dout + q_off,
                                       q0, P.seq_q, P.hd, P.hd, vec);
    stage_rows(Rs + st * 2 * kDkvQ, lse + r_off, delta + r_off, q0,
               P.seq_q);
  };
  // one commit group per step: K and V ride with the first
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    stage(i, i);
    cp_commit();
  }

  // ldmatrix row addresses: K and V as A (keys x hd); Q and dO as the
  // col-major B of K Q^T and V dO^T, and transposed as the B of P^T dO
  // and dS^T Q (all stored rows x hd)
  const uint32_t a_lane = (warp * 16 + lane % 16) * RB + (lane / 16) * 16;
  const uint32_t b_lane =
      ((lane % 8) + (lane / 16) * 8) * RB + ((lane / 8) % 2) * 16;
  const uint32_t t_lane =
      ((lane % 8) + ((lane / 8) % 2) * 8) * RB + (lane / 16) * 16;
  constexpr uint32_t kStage = kDkvQ * RB;
  const uint32_t ka = smem_u32(Ks) + a_lane, va = smem_u32(Vs) + a_lane;
  const uint32_t qs0 = smem_u32(Qs), ds0 = smem_u32(dOs);

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const float sc = P.sm_scale * kLog2e;

  for (int i = 0, st = 0; i < iters;
       ++i, st = st + 1 < kStages ? st + 1 : 0) {
    cp_wait<kStages - 2>();
    // step i's tiles have landed for every thread, and every warp is
    // done with step i - 1, whose stage the next copy takes
    __syncthreads();
    stage(i + kStages - 1, st == 0 ? kStages - 1 : st - 1);
    cp_commit();

    const int q0 = (lo + i % nt) * kDkvQ;
    const uint32_t qs = qs0 + st * kStage, dos = ds0 + st * kStage;
    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x kDkvQ rows
    float s[JT][4], dp[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a, ka + kk * 32);
#pragma unroll
      for (int j = 0; j < JT / 2; ++j) {
        ldsm_x4(b, qs + b_lane + j * 16 * RB + kk * 32);
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
      }
      ldsm_x4(a, va + kk * 32);
#pragma unroll
      for (int j = 0; j < JT / 2; ++j) {
        ldsm_x4(b, dos + b_lane + j * 16 * RB + kk * 32);
        mma(dp[2 * j], a, b[0], b[1]);
        mma(dp[2 * j + 1], a, b[2], b[3]);
      }
    }

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta) sm_scale
    const float* ls = Rs + st * 2 * kDkvQ;
    const float* dl = ls + kDkvQ;
    const bool full = all_kept(P, q0, kDkvQ, kw, 16);
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + c2 + e % 2;
        float p = exp2f(s[j][e] * sc - ls[c] * kLog2e);
        if (!full && !keep(P, q0 + c, kr + (e / 2) * 8)) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl[c]) * P.sm_scale;
      }
    uint32_t pa[JT / 2][4], da[JT / 2][4];
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk)
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ldsm_x4_t(b, dos + t_lane + kk * 16 * RB + j * 32);
        mma(dva[2 * j], pa[kk], b[0], b[1]);
        mma(dva[2 * j + 1], pa[kk], b[2], b[3]);
        ldsm_x4_t(b, qs + t_lane + kk * 16 * RB + j * 32);
        mma(dka[2 * j], da[kk], b[0], b[1]);
        mma(dka[2 * j + 1], da[kk], b[2], b[3]);
      }
  }
  cp_wait<0>();  // with fewer steps than stages, copies may be in flight

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      store_pair(dk + kv_off, kr + 8 * h, 8 * j + c2, dka[j][2 * h],
                 dka[j][2 * h + 1], P.seq_k, P.hd);
      store_pair(dv + kv_off, kr + 8 * h, 8 * j + c2, dva[j][2 * h],
                 dva[j][2 * h + 1], P.seq_k, P.hd);
    }
}

// -- dq --------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                Problem P, int n_q, bool vec) {
  constexpr int S = HD + 8;
  constexpr int RB = 2 * S;
  constexpr int KT = HD / 16;   // k-steps of Q K^T and dO V^T
  constexpr int NT = HD / 8;    // 8-column tiles of dq
  constexpr int JT = kDqN / 8;  // 8-key tiles of S and dP
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* dOs = Qs + kDqM * S;
  bf16* Ks = dOs + kDqM * S;           // kStages stages of kDqN rows
  bf16* Vs = Ks + kStages * kDqN * S;  // kStages stages of kDqN rows

  // heavy first, as the forward: the last q tiles see the most keys
  const int tiles = (P.seq_q + kDqM - 1) / kDqM;
  const int rank = blockIdx.x / n_q, n = blockIdx.x % n_q;
  const int q0 = (P.causal ? tiles - 1 - rank : rank) * kDqM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = q0 + warp * 16;       // the warp's 16 rows
  const int r0 = w0 + lane / 4;        // this thread's rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);       // and columns c2, c2 + 1 of a tile
  const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  int lo, hi;
  kv_range(P, q0, kDqM, kDqN, lo, hi);
  // K/V tile t into ring stage st (nothing past hi)
  auto stage = [&](int t, int st) {
    if (t >= hi) return;
    stage_cols<kDqN, HD, kDqThreads>(Ks + st * kDqN * S, kb, t * kDqN,
                                     P.seq_k, P.hd, P.hd, vec);
    stage_cols<kDqN, HD, kDqThreads>(Vs + st * kDqN * S, vb, t * kDqN,
                                     P.seq_k, P.hd, P.hd, vec);
  };
  // one commit group per tile: Q and dO ride with the first
  stage_cols<kDqM, HD, kDqThreads>(Qs, q + q_off, q0, P.seq_q, P.hd, P.hd,
                                   vec);
  stage_cols<kDqM, HD, kDqThreads>(dOs, dout + q_off, q0, P.seq_q, P.hd, P.hd,
                                   vec);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    stage(lo + i, i);
    cp_commit();
  }

  // lse (in log2 units) and delta of rows r0 and r0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const size_t i = static_cast<size_t>(n) * P.seq_q + row;
    lse2[h] = row < P.seq_q ? lse[i] * kLog2e : 0.f;
    dl[h] = row < P.seq_q ? delta[i] : 0.f;
  }
  // ldmatrix row addresses: Q and dO as A (rows x hd, reloaded each
  // k-step, as dk/dv reloads K and V); K and V as the col-major B of
  // Q K^T and dO V^T; K transposed as the B of dS K (as V in the
  // forward's P V)
  const uint32_t a_lane = (warp * 16 + lane % 16) * RB + (lane / 16) * 16;
  const uint32_t b_lane =
      ((lane % 8) + (lane / 16) * 8) * RB + ((lane / 8) % 2) * 16;
  const uint32_t t_lane =
      ((lane % 8) + ((lane / 8) % 2) * 8) * RB + (lane / 16) * 16;
  constexpr uint32_t kStage = kDqN * RB;
  const uint32_t qa = smem_u32(Qs) + a_lane, da = smem_u32(dOs) + a_lane;
  const uint32_t ks0 = smem_u32(Ks), vs0 = smem_u32(Vs);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float sc = P.sm_scale * kLog2e;

  for (int t = lo, st = 0; t < hi;
       ++t, st = st + 1 < kStages ? st + 1 : 0) {
    cp_wait<kStages - 2>();
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the next copy takes
    __syncthreads();
    stage(t + kStages - 1, st == 0 ? kStages - 1 : st - 1);
    cp_commit();

    const uint32_t ks = ks0 + st * kStage, vs = vs0 + st * kStage;
    // S = Q K^T and dP = dO V^T: the warp's 16 rows x kDqN keys
    float s[JT][4], dp[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a, qa + kk * 32);
#pragma unroll
      for (int j = 0; j < JT / 2; ++j) {
        ldsm_x4(b, ks + b_lane + j * 16 * RB + kk * 32);
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
      }
      ldsm_x4(a, da + kk * 32);
#pragma unroll
      for (int j = 0; j < JT / 2; ++j) {
        ldsm_x4(b, vs + b_lane + j * 16 * RB + kk * 32);
        mma(dp[2 * j], a, b[0], b[1]);
        mma(dp[2 * j + 1], a, b[2], b[3]);
      }
    }

    // P = exp(S - lse), dS = P (dP - delta) sm_scale; a masked p is set
    // to 0 after the exp2, which overflows where lse is ~-1e30
    const int k0 = t * kDqN;
    const bool full = all_kept(P, w0, 16, k0, kDqN);
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        float p = exp2f(s[j][e] * sc - lse2[h]);
        if (!full && !keep(P, r0 + 8 * h, k0 + 8 * j + c2 + e % 2)) p = 0.f;
        dp[j][e] = p * (dp[j][e] - dl[h]) * P.sm_scale;
      }
    // dS as A fragments of dS K, straight from the accumulators
    uint32_t dsa[JT / 2][4];
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk) {
      dsa[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      dsa[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      dsa[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      dsa[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    // dq += dS K
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk)
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ldsm_x4_t(b, ks + t_lane + kk * 16 * RB + j * 32);
        mma(acc[2 * j], dsa[kk], b[0], b[1]);
        mma(acc[2 * j + 1], dsa[kk], b[2], b[3]);
      }
  }
  cp_wait<0>();  // with fewer tiles than stages, copies may be in flight

  // one block owns its rows: dq is written once, no atomics
  bf16* out = dq + q_off;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store_pair(out, r0, 8 * j + c2, acc[j][0], acc[j][1], P.seq_q, P.hd);
    store_pair(out, r0 + 8, 8 * j + c2, acc[j][2], acc[j][3], P.seq_q,
               P.hd);
  }
}

// -- head dims above 128 ---------------------------------------------------
// Two layouts, each with dq, dk and dv held kWideC columns at a time:
// up to hd 256 the output columns are split over the warps of a block
// (flash_*_split_tc, below); above, over blocks, in chunks (the
// flash_*_wide_tc kernels here): a block owns one chunk of dq (or of dk
// and dv), sums S and dP over every chunk of the head dim, and
// multiplies dS by its own chunk only.  Operands that are streamed (K/V
// for dq; Q/dO for dk/dv) come through the ring one (tile, column
// chunk) step at a time, and each tile's chunks are taken in the order
// co + 1, ..., co (mod nc), so the chunk that dS multiplies is the last
// one staged and is still in the ring when dS is ready.
constexpr int kWideC = 128;  // columns a warp or block holds of an output

// dq at 256 < hd <= HD (512, the resident Q / dO width): Q and dO of 128
// rows would not fit beside the ring, so 64-row q tiles (4 warps); two
// stages of one 64-key x 128-column K and V chunk each.
template <int HD>
struct DqWide {
  static constexpr int M = 64;             // query rows per block
  static constexpr int kThreads = 2 * M;   // M / 16 warps
  static constexpr int kStages = 2;
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * M * (HD + 8) + kStages * 2 * kDqN * (kWideC + 8));
};

// dk/dv at 256 < hd <= HD: K and V resident over every column; the ring
// holds one 32-row x 128-column Q and dO chunk a stage, and lse, delta
// with each tile's last chunk; three stages, one block an SM.  Here and
// in the split kernel, where the grid would not fill the card, a cluster
// of up to kMaxParts blocks shares a block's (query head, q tile) steps
// and sums its partial dk, dv through distributed shared memory, in rank
// order.
constexpr int kMaxParts = 8;  // the portable cluster size

template <int HD>
struct DkvWide {
  static constexpr int kStages = 3;
  static constexpr int kBlocksPerSm = 1;
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * kDkvN * (HD + 8) +
                      kStages * 2 * kDkvQ * (kWideC + 8)) +
      sizeof(float) * kStages * 2 * kDkvQ;
};

// a cluster's partial dk, dv (2 x kDkvN x W f32) fit in a block's bytes
static_assert(sizeof(float) * 2 * kDkvN * kWideC <= DkvWide<512>::kSmem,
              "the chunked dk/dv's partials outgrow its shared memory");

// chunk taken at position j of a tile's nc chunks: co + 1 + j (mod nc)
__device__ __forceinline__ int wide_chunk(int co, int j, int nc) {
  const int c = co + 1 + j;
  return c >= nc ? c - nc : c;
}

// The end of a dk/dv block: a thread's fragments (key rows r, r + 8 of
// the tile at k0; columns cb + 8 j + c2, c2 + 1) go straight to dk and dv
// when the block owns its cell (parts == 1).  Else the cluster of `parts`
// blocks sums its partials: each block's into red[2][kDkvN][W] f32 in its
// own shared memory (columns c0 .. c0 + W, the ring's and K, V's bytes),
// then part p sums rows [p, p + 1) * kDkvN / parts of every block's in
// rank order and writes them once.  No atomics: the sum does not depend
// on the order in which blocks run.
template <int NT, int W, int NTHREADS>
__device__ __forceinline__ void finish_dkv(const float (&dka)[NT][4],
                                           const float (&dva)[NT][4], int r,
                                           int c2, int cb, int c0, int k0,
                                           int parts, int part, bf16* dk,
                                           bf16* dv, const Problem& P,
                                           float* red) {
  if (parts == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        store_pair(dk, k0 + r + 8 * h, cb + 8 * j + c2, dka[j][2 * h],
                   dka[j][2 * h + 1], P.seq_k, P.hd);
        store_pair(dv, k0 + r + 8 * h, cb + 8 * j + c2, dva[j][2 * h],
                   dva[j][2 * h + 1], P.seq_k, P.hd);
      }
    return;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // every warp is done with K, V and the ring
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (r + 8 * h) * W + cb - c0 + 8 * j + c2;
      *reinterpret_cast<float2*>(red + at) =
          make_float2(dka[j][2 * h], dka[j][2 * h + 1]);
      *reinterpret_cast<float2*>(red + kDkvN * W + at) =
          make_float2(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  cluster.sync();  // every block's partials are in its shared memory
  const int rows = kDkvN / parts;
  constexpr int Q4 = W / 4;
  for (int x = threadIdx.x; x < 2 * rows * Q4; x += NTHREADS) {
    const int m = x / (rows * Q4), y = x % (rows * Q4);
    const int row = part * rows + y / Q4, c = (y % Q4) * 4;
    const int at = m * kDkvN * W + row * W + c;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < parts; ++b) {
      const float4 z =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red + at,
                                                                   b));
      sum.x += z.x;
      sum.y += z.y;
      sum.z += z.z;
      sum.w += z.w;
    }
    bf16* out = m == 0 ? dk : dv;
    store_pair(out, k0 + row, c0 + c, sum.x, sum.y, P.seq_k, P.hd);
    store_pair(out, k0 + row, c0 + c + 2, sum.z, sum.w, P.seq_k, P.hd);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <int HD>
__global__ void __launch_bounds__(DqWide<HD>::kThreads, 1)
    flash_dq_wide_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     Problem P, int n_q, int nc, bool vec) {
  constexpr int M = DqWide<HD>::M, NTH = DqWide<HD>::kThreads;
  constexpr int ST = DqWide<HD>::kStages;
  constexpr int S = HD + 8, RB = 2 * S;          // Q, dO: every column
  constexpr int SC = kWideC + 8, RC = 2 * SC;    // K, V: one chunk
  constexpr int KT = kWideC / 16;  // k-steps of a chunk
  constexpr int NT = kWideC / 8;   // 8-column tiles of the dq chunk
  constexpr int JT = kDqN / 8;     // 8-key tiles of S and dP
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* dOs = Qs + M * S;
  bf16* Ks = dOs + M * S;          // ST stages of kDqN rows x kWideC
  bf16* Vs = Ks + ST * kDqN * SC;  // ST stages of kDqN rows x kWideC

  // heavy first, across heads and chunks: the last q tiles see the most
  // keys
  const int tiles = (P.seq_q + M - 1) / M;
  const int per = n_q * nc;
  const int rank = blockIdx.x / per;
  const int n = (blockIdx.x % per) / nc, co = blockIdx.x % nc;
  const int q0 = (P.causal ? tiles - 1 - rank : rank) * M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = q0 + warp * 16;       // the warp's 16 rows
  const int r0 = w0 + lane / 4;        // this thread's rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);       // and columns c2, c2 + 1 of a tile
  const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  int lo, hi;
  kv_range(P, q0, M, kDqN, lo, hi);
  const int steps = max(hi - lo, 0) * nc;
  // step i (K/V tile lo + i / nc, its chunk at position i % nc) into ring
  // stage st (nothing past the last step)
  auto stage = [&](int i, int st) {
    if (i >= steps) return;
    const int row0 = (lo + i / nc) * kDqN;
    const int c0 = wide_chunk(co, i % nc, nc) * kWideC;
    stage_cols<kDqN, kWideC, NTH>(Ks + st * kDqN * SC, kb + c0, row0,
                                  P.seq_k, P.hd, P.hd - c0, vec);
    stage_cols<kDqN, kWideC, NTH>(Vs + st * kDqN * SC, vb + c0, row0,
                                  P.seq_k, P.hd, P.hd - c0, vec);
  };
  // one commit group per step: Q and dO ride with the first
  stage_cols<M, HD, NTH>(Qs, q + q_off, q0, P.seq_q, P.hd, P.hd, vec);
  stage_cols<M, HD, NTH>(dOs, dout + q_off, q0, P.seq_q, P.hd, P.hd, vec);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    stage(i, i);
    cp_commit();
  }

  // lse (in log2 units) and delta of rows r0 and r0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const size_t i = static_cast<size_t>(n) * P.seq_q + row;
    lse2[h] = row < P.seq_q ? lse[i] * kLog2e : 0.f;
    dl[h] = row < P.seq_q ? delta[i] : 0.f;
  }
  // ldmatrix row addresses, as flash_dq_tc's: Q and dO as A; a K or V
  // chunk as the col-major B of Q K^T and dO V^T, K's transposed as the
  // B of dS K
  const uint32_t a_lane = (warp * 16 + lane % 16) * RB + (lane / 16) * 16;
  const uint32_t b_lane =
      ((lane % 8) + (lane / 16) * 8) * RC + ((lane / 8) % 2) * 16;
  const uint32_t t_lane =
      ((lane % 8) + ((lane / 8) % 2) * 8) * RC + (lane / 16) * 16;
  constexpr uint32_t kStage = kDqN * RC;
  const uint32_t qa = smem_u32(Qs) + a_lane, da = smem_u32(dOs) + a_lane;
  const uint32_t ks0 = smem_u32(Ks), vs0 = smem_u32(Vs);
  // 16-column groups of the dq chunk that hold columns below hd
  const int ng = min(NT / 2, (P.hd - co * kWideC + 15) / 16);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float sc = P.sm_scale * kLog2e;

  int i = 0, st = 0;
  for (int t = lo; t < hi; ++t) {
    // S = Q K^T and dP = dO V^T over every chunk: the warp's 16 rows x
    // kDqN keys
    float s[JT][4], dp[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    uint32_t ks = ks0;
    for (int j = 0; j < nc; ++j, ++i) {
      cp_wait<ST - 2>();
      // step i has landed for every thread, and every warp is done with
      // step i - 1, whose stage the next copy takes
      __syncthreads();
      stage(i + ST - 1, st == 0 ? ST - 1 : st - 1);
      cp_commit();
      ks = ks0 + st * kStage;
      const uint32_t vs = vs0 + st * kStage;
      const int c0 = wide_chunk(co, j, nc) * kWideC;
      // k-steps that hold columns below hd (the rest are zeros)
      const int kt = min(KT, (P.hd - c0 + 15) / 16);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (kk >= kt) break;
        uint32_t a[4], b[4];
        ldsm_x4(a, qa + c0 * 2 + kk * 32);
#pragma unroll
        for (int jj = 0; jj < JT / 2; ++jj) {
          ldsm_x4(b, ks + b_lane + jj * 16 * RC + kk * 32);
          mma(s[2 * jj], a, b[0], b[1]);
          mma(s[2 * jj + 1], a, b[2], b[3]);
        }
        ldsm_x4(a, da + c0 * 2 + kk * 32);
#pragma unroll
        for (int jj = 0; jj < JT / 2; ++jj) {
          ldsm_x4(b, vs + b_lane + jj * 16 * RC + kk * 32);
          mma(dp[2 * jj], a, b[0], b[1]);
          mma(dp[2 * jj + 1], a, b[2], b[3]);
        }
      }
      st = st + 1 < ST ? st + 1 : 0;
    }

    // P = exp(S - lse), dS = P (dP - delta) sm_scale; a masked p is set
    // to 0 after the exp2, which overflows where lse is ~-1e30
    const int k0 = t * kDqN;
    const bool full = all_kept(P, w0, 16, k0, kDqN);
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        float p = exp2f(s[j][e] * sc - lse2[h]);
        if (!full && !keep(P, r0 + 8 * h, k0 + 8 * j + c2 + e % 2)) p = 0.f;
        dp[j][e] = p * (dp[j][e] - dl[h]) * P.sm_scale;
      }
    uint32_t dsa[JT / 2][4];
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk) {
      dsa[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      dsa[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      dsa[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      dsa[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    // dq += dS K[:, chunk co]: the last step's stage holds that chunk
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk)
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (j >= ng) break;
        uint32_t b[4];
        ldsm_x4_t(b, ks + t_lane + kk * 16 * RC + j * 32);
        mma(acc[2 * j], dsa[kk], b[0], b[1]);
        mma(acc[2 * j + 1], dsa[kk], b[2], b[3]);
      }
  }
  cp_wait<0>();  // with fewer steps than stages, copies may be in flight

  // one block owns its rows and chunk: dq is written once, no atomics
  bf16* out = dq + q_off;
  const int cb = co * kWideC;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store_pair(out, r0, cb + 8 * j + c2, acc[j][0], acc[j][1], P.seq_q,
               P.hd);
    store_pair(out, r0 + 8, cb + 8 * j + c2, acc[j][2], acc[j][3],
               P.seq_q, P.hd);
  }
}

template <int HD>
__global__ void __launch_bounds__(kDkvThreads, DkvWide<HD>::kBlocksPerSm)
    flash_dkv_wide_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, Problem P, int n_kv, int nc,
                      int parts, bool vec) {
  constexpr int ST = DkvWide<HD>::kStages;
  constexpr int S = HD + 8, RB = 2 * S;        // K, V: every column
  constexpr int SC = kWideC + 8, RC = 2 * SC;  // Q, dO: one chunk
  constexpr int KT = kWideC / 16;  // k-steps of a chunk
  constexpr int NT = kWideC / 8;   // 8-column tiles of the dk, dv chunk
  constexpr int JT = kDkvQ / 8;    // 8-query tiles of S^T
  extern __shared__ uint4 smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + kDkvN * S;
  bf16* Qs = Vs + kDkvN * S;           // ST stages of kDkvQ rows x kWideC
  bf16* dOs = Qs + ST * kDkvQ * SC;    // ST stages of kDkvQ rows x kWideC
  float* Rs = reinterpret_cast<float*>(dOs + ST * kDkvQ * SC);

  // heavy first, across kv heads and chunks: the first keys see the most
  // rows; a block is part `part` of the `parts` (a cluster) that share
  // one (key tile, kv head, chunk)
  const int part = blockIdx.x % parts, cell = blockIdx.x / parts;
  const int per = n_kv * nc;
  const int rank = cell / per;
  const int nk = (cell % per) / nc, co = cell % nc;
  const int k0 = rank * kDkvN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = k0 + warp * 16;   // the warp's 16 keys
  const int kr = kw + lane / 4;    // this thread's keys kr, kr + 8
  const int c2 = 2 * (lane % 4);   // and query columns c2, c2 + 1
  const size_t kv_off = static_cast<size_t>(nk) * P.seq_k * P.hd;
  stage_cols<kDkvN, HD, kDkvThreads>(Ks, k + kv_off, k0, P.seq_k, P.hd,
                                     P.hd, vec);
  stage_cols<kDkvN, HD, kDkvThreads>(Vs, v + kv_off, k0, P.seq_k, P.hd,
                                     P.hd, vec);

  int lo, hi;
  q_range(P, k0, kDkvN, kDkvQ, lo, hi);
  const int nt = max(hi - lo, 0), tiles = P.g * nt;
  // this part's tiles u = part, part + parts, ...
  const int mine = tiles > part ? (tiles - part + parts - 1) / parts : 0;
  const int steps = mine * nc;
  // step i (tile u = part + (i / nc) * parts: query head nk * g + u / nt,
  // q tile lo + u % nt; its chunk at position i % nc) into ring stage st:
  // the Q and dO chunk, and lse, delta with the tile's last chunk
  auto stage = [&](int i, int st) {
    if (i >= steps) return;
    const int u = part + (i / nc) * parts, j = i % nc;
    const int n = nk * P.g + u / nt;
    const int q0 = (lo + u % nt) * kDkvQ;
    const int c0 = wide_chunk(co, j, nc) * kWideC;
    const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd + c0;
    stage_cols<kDkvQ, kWideC, kDkvThreads>(Qs + st * kDkvQ * SC, q + q_off,
                                           q0, P.seq_q, P.hd, P.hd - c0,
                                           vec);
    stage_cols<kDkvQ, kWideC, kDkvThreads>(dOs + st * kDkvQ * SC,
                                           dout + q_off, q0, P.seq_q, P.hd,
                                           P.hd - c0, vec);
    if (j == nc - 1) {
      const size_t r_off = static_cast<size_t>(n) * P.seq_q;
      stage_rows(Rs + st * 2 * kDkvQ, lse + r_off, delta + r_off, q0,
                 P.seq_q);
    }
  };
  // one commit group per step: K and V ride with the first
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    stage(i, i);
    cp_commit();
  }

  // ldmatrix row addresses, as flash_dkv_tc's: K and V as A; a Q or dO
  // chunk as the col-major B of K Q^T and V dO^T, and transposed as the
  // B of P^T dO and dS^T Q
  const uint32_t a_lane = (warp * 16 + lane % 16) * RB + (lane / 16) * 16;
  const uint32_t b_lane =
      ((lane % 8) + (lane / 16) * 8) * RC + ((lane / 8) % 2) * 16;
  const uint32_t t_lane =
      ((lane % 8) + ((lane / 8) % 2) * 8) * RC + (lane / 16) * 16;
  constexpr uint32_t kStage = kDkvQ * RC;
  const uint32_t ka = smem_u32(Ks) + a_lane, va = smem_u32(Vs) + a_lane;
  const uint32_t qs0 = smem_u32(Qs), ds0 = smem_u32(dOs);
  // 16-column groups of the dk, dv chunk that hold columns below hd
  const int ng = min(NT / 2, (P.hd - co * kWideC + 15) / 16);

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const float sc = P.sm_scale * kLog2e;

  int i = 0, st = 0;
  for (int t = 0; t < mine; ++t) {
    const int u = part + t * parts;
    // S^T = K Q^T and dP^T = V dO^T over every chunk: the warp's 16 keys
    // x kDkvQ rows
    float s[JT][4], dp[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    uint32_t qs = qs0, dos = ds0;
    int last = 0;
    for (int j = 0; j < nc; ++j, ++i) {
      cp_wait<ST - 2>();
      // step i has landed for every thread, and every warp is done with
      // step i - 1, whose stage the next copy takes
      __syncthreads();
      stage(i + ST - 1, st == 0 ? ST - 1 : st - 1);
      cp_commit();
      qs = qs0 + st * kStage;
      dos = ds0 + st * kStage;
      last = st;
      const int c0 = wide_chunk(co, j, nc) * kWideC;
      // k-steps that hold columns below hd (the rest are zeros)
      const int kt = min(KT, (P.hd - c0 + 15) / 16);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (kk >= kt) break;
        uint32_t a[4], b[4];
        ldsm_x4(a, ka + c0 * 2 + kk * 32);
#pragma unroll
        for (int jj = 0; jj < JT / 2; ++jj) {
          ldsm_x4(b, qs + b_lane + jj * 16 * RC + kk * 32);
          mma(s[2 * jj], a, b[0], b[1]);
          mma(s[2 * jj + 1], a, b[2], b[3]);
        }
        ldsm_x4(a, va + c0 * 2 + kk * 32);
#pragma unroll
        for (int jj = 0; jj < JT / 2; ++jj) {
          ldsm_x4(b, dos + b_lane + jj * 16 * RC + kk * 32);
          mma(dp[2 * jj], a, b[0], b[1]);
          mma(dp[2 * jj + 1], a, b[2], b[3]);
        }
      }
      st = st + 1 < ST ? st + 1 : 0;
    }

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta) sm_scale
    const int q0 = (lo + u % nt) * kDkvQ;
    const float* ls = Rs + last * 2 * kDkvQ;
    const float* dl = ls + kDkvQ;
    const bool full = all_kept(P, q0, kDkvQ, kw, 16);
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + c2 + e % 2;
        float p = exp2f(s[j][e] * sc - ls[c] * kLog2e);
        if (!full && !keep(P, q0 + c, kr + (e / 2) * 8)) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl[c]) * P.sm_scale;
      }
    uint32_t pa[JT / 2][4], da[JT / 2][4];
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    // dV += P^T dO[:, chunk co], dK += dS^T Q[:, chunk co]: the last
    // step's stage holds that chunk
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk)
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (j >= ng) break;
        uint32_t b[4];
        ldsm_x4_t(b, dos + t_lane + kk * 16 * RC + j * 32);
        mma(dva[2 * j], pa[kk], b[0], b[1]);
        mma(dva[2 * j + 1], pa[kk], b[2], b[3]);
        ldsm_x4_t(b, qs + t_lane + kk * 16 * RC + j * 32);
        mma(dka[2 * j], da[kk], b[0], b[1]);
        mma(dka[2 * j + 1], da[kk], b[2], b[3]);
      }
  }
  cp_wait<0>();  // with fewer steps than stages, copies may be in flight

  const int cb = co * kWideC;
  finish_dkv<NT, kWideC, kDkvThreads>(dka, dva, warp * 16 + lane / 4, c2,
                                      cb, cb, k0, parts, part, dk + kv_off,
                                      dv + kv_off, P,
                                      reinterpret_cast<float*>(smem_tc));
}

// -- 128 < hd <= 256: the output columns split over the warps --------------
// A block of 8 warps, 4 slabs of 16 rows (dq: query rows; dk/dv: keys) by
// 2 column halves of 128.  The warps of a slab compute S and dP once, each
// for half of the other side (dq: 32 of the tile's 64 keys; dk/dv: 16 of
// the q tile's 32 rows) over every column, and hand P and dS on through
// shared memory in bf16 (a barrier); each warp then multiplies its slab's
// whole dS (and P) by its own column half.  No product is recomputed.
constexpr int kSplitHd = 256;      // resident width: hd <= 256
constexpr int kSplitThreads = 256;
constexpr int kSplitM = 64;        // dq: query rows per block

struct DqSplit {
  static constexpr int kStages = 2;
  static constexpr size_t kSmem =
      sizeof(bf16) * ((2 * kSplitM + kStages * 2 * kDqN) * (kSplitHd + 8) +
                      kSplitM * (kDqN + 8));
};

struct DkvSplit {
  static constexpr int kStages = 3;
  static constexpr size_t kSmem =
      sizeof(bf16) * ((2 * kDkvN + kStages * 2 * kDkvQ) * (kSplitHd + 8) +
                      2 * kDkvN * (kDkvQ + 8)) +
      sizeof(float) * kStages * 2 * kDkvQ;
};

static_assert(sizeof(float) * 2 * kDkvN * kSplitHd <= DkvSplit::kSmem,
              "the split dk/dv's partials outgrow its shared memory");

template <int HD>
__global__ void __launch_bounds__(kSplitThreads, 1)
    flash_dq_split_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      Problem P, int n_q, bool vec) {
  constexpr int M = kSplitM, NTH = kSplitThreads;
  constexpr int ST = DqSplit::kStages;
  constexpr int S = HD + 8, RB = 2 * S;
  constexpr int DS = kDqN + 8, DB = 2 * DS;  // dS: M rows x kDqN keys
  constexpr int KT = HD / 16;          // k-steps of S and dP
  constexpr int NT = kWideC / 8;       // 8-column tiles of a dq half
  constexpr int JT = kDqN / 2 / 8;     // 8-key tiles of a warp's S, dP
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* dOs = Qs + M * S;
  bf16* Ks = dOs + M * S;             // ST stages of kDqN rows
  bf16* Vs = Ks + ST * kDqN * S;      // ST stages of kDqN rows
  bf16* dSs = Vs + ST * kDqN * S;

  // heavy first, as flash_dq_tc
  const int tiles = (P.seq_q + M - 1) / M;
  const int rank = blockIdx.x / n_q, n = blockIdx.x % n_q;
  const int q0 = (P.causal ? tiles - 1 - rank : rank) * M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sl = warp % 4, hf = warp / 4;  // row slab, column half
  const int w0 = q0 + sl * 16;         // the slab's 16 rows
  const int r0 = w0 + lane / 4;        // this thread's rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);       // and columns c2, c2 + 1 of a tile
  const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  int lo, hi;
  kv_range(P, q0, M, kDqN, lo, hi);
  auto stage = [&](int t, int st) {
    if (t >= hi) return;
    stage_cols<kDqN, HD, NTH>(Ks + st * kDqN * S, kb, t * kDqN, P.seq_k,
                              P.hd, P.hd, vec);
    stage_cols<kDqN, HD, NTH>(Vs + st * kDqN * S, vb, t * kDqN, P.seq_k,
                              P.hd, P.hd, vec);
  };
  // one commit group per tile: Q and dO ride with the first
  stage_cols<M, HD, NTH>(Qs, q + q_off, q0, P.seq_q, P.hd, P.hd, vec);
  stage_cols<M, HD, NTH>(dOs, dout + q_off, q0, P.seq_q, P.hd, P.hd, vec);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    stage(lo + i, i);
    cp_commit();
  }

  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const size_t i = static_cast<size_t>(n) * P.seq_q + row;
    lse2[h] = row < P.seq_q ? lse[i] * kLog2e : 0.f;
    dl[h] = row < P.seq_q ? delta[i] : 0.f;
  }
  // ldmatrix row addresses: Q, dO and dS as A (the slab's rows); K and V
  // as the col-major B of Q K^T and dO V^T (the warp's 32 keys), K
  // transposed as the B of dS K (the warp's column half)
  const uint32_t a_lane = (sl * 16 + lane % 16) * RB + (lane / 16) * 16;
  const uint32_t b_lane = ((lane % 8) + (lane / 16) * 8) * RB +
                          ((lane / 8) % 2) * 16 + hf * 32 * RB;
  const uint32_t t_lane = ((lane % 8) + ((lane / 8) % 2) * 8) * RB +
                          (lane / 16) * 16 + hf * kWideC * 2;
  constexpr uint32_t kStage = kDqN * RB;
  const uint32_t qa = smem_u32(Qs) + a_lane, da = smem_u32(dOs) + a_lane;
  const uint32_t ks0 = smem_u32(Ks), vs0 = smem_u32(Vs);
  const uint32_t dsa0 =
      smem_u32(dSs) + (sl * 16 + lane % 16) * DB + (lane / 16) * 16;
  const int kt = min(KT, (P.hd + 15) / 16);
  const int ng = min(NT / 2, (P.hd - hf * kWideC + 15) / 16);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float sc = P.sm_scale * kLog2e;

  for (int t = lo, st = 0; t < hi;
       ++t, st = st + 1 < ST ? st + 1 : 0) {
    cp_wait<ST - 2>();
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1 (its stage and dS)
    __syncthreads();
    stage(t + ST - 1, st == 0 ? ST - 1 : st - 1);
    cp_commit();

    const uint32_t ks = ks0 + st * kStage, vs = vs0 + st * kStage;
    // S = Q K^T and dP = dO V^T: the slab's 16 rows x the warp's 32 keys
    float s[JT][4], dp[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk >= kt) break;
      uint32_t a[4], b[4];
      ldsm_x4(a, qa + kk * 32);
#pragma unroll
      for (int j = 0; j < JT / 2; ++j) {
        ldsm_x4(b, ks + b_lane + j * 16 * RB + kk * 32);
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
      }
      ldsm_x4(a, da + kk * 32);
#pragma unroll
      for (int j = 0; j < JT / 2; ++j) {
        ldsm_x4(b, vs + b_lane + j * 16 * RB + kk * 32);
        mma(dp[2 * j], a, b[0], b[1]);
        mma(dp[2 * j + 1], a, b[2], b[3]);
      }
    }

    // dS = P (dP - delta) sm_scale, into shared memory as bf16
    const int k0 = t * kDqN + hf * 32;
    const bool full = all_kept(P, w0, 16, k0, 32);
    bf16* dsr = dSs + (sl * 16 + lane / 4) * DS + hf * 32 + c2;
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 2 * h + x;
          float p = exp2f(s[j][e] * sc - lse2[h]);
          if (!full && !keep(P, r0 + 8 * h, k0 + 8 * j + c2 + x)) p = 0.f;
          d[x] = p * (dp[j][e] - dl[h]) * P.sm_scale;
        }
        *reinterpret_cast<uint32_t*>(dsr + 8 * h * DS + 8 * j) =
            pack_bf16(d[0], d[1]);
      }
    __syncthreads();  // the slab's dS, both halves, is in shared memory

    // dq[slab, half] += dS[slab, every key] K[every key, half]
#pragma unroll
    for (int kk = 0; kk < kDqN / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, dsa0 + kk * 32);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (j >= ng) break;
        uint32_t b[4];
        ldsm_x4_t(b, ks + t_lane + kk * 16 * RB + j * 32);
        mma(acc[2 * j], a, b[0], b[1]);
        mma(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
  cp_wait<0>();  // with fewer tiles than stages, copies may be in flight

  // one block owns its rows: dq is written once, no atomics
  bf16* out = dq + q_off;
  const int cb = hf * kWideC;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store_pair(out, r0, cb + 8 * j + c2, acc[j][0], acc[j][1], P.seq_q,
               P.hd);
    store_pair(out, r0 + 8, cb + 8 * j + c2, acc[j][2], acc[j][3],
               P.seq_q, P.hd);
  }
}

template <int HD>
__global__ void __launch_bounds__(kSplitThreads, 1)
    flash_dkv_split_tc(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       Problem P, int n_kv, int parts, bool vec) {
  constexpr int NTH = kSplitThreads;
  constexpr int ST = DkvSplit::kStages;
  constexpr int S = HD + 8, RB = 2 * S;
  constexpr int PS = kDkvQ + 8, PB = 2 * PS;  // P^T, dS^T: keys x rows
  constexpr int KT = HD / 16;        // k-steps of S^T and dP^T
  constexpr int NT = kWideC / 8;     // 8-column tiles of a dk, dv half
  constexpr int JT = kDkvQ / 2 / 8;  // 8-row tiles of a warp's S^T
  extern __shared__ uint4 smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + kDkvN * S;
  bf16* Qs = Vs + kDkvN * S;            // ST stages of kDkvQ rows
  bf16* dOs = Qs + ST * kDkvQ * S;      // ST stages of kDkvQ rows
  bf16* Pt = dOs + ST * kDkvQ * S;
  bf16* dSt = Pt + kDkvN * PS;
  float* Rs = reinterpret_cast<float*>(dSt + kDkvN * PS);

  // heavy first, as flash_dkv_wide_tc, and the same split into parts
  const int part = blockIdx.x % parts, cell = blockIdx.x / parts;
  const int rank = cell / n_kv, nk = cell % n_kv;
  const int k0 = rank * kDkvN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sl = warp % 4, hf = warp / 4;  // key slab, column half
  const int kw = k0 + sl * 16;     // the slab's 16 keys
  const int kr = kw + lane / 4;    // this thread's keys kr, kr + 8
  const int c2 = 2 * (lane % 4);   // and query columns c2, c2 + 1
  const size_t kv_off = static_cast<size_t>(nk) * P.seq_k * P.hd;
  stage_cols<kDkvN, HD, NTH>(Ks, k + kv_off, k0, P.seq_k, P.hd, P.hd, vec);
  stage_cols<kDkvN, HD, NTH>(Vs, v + kv_off, k0, P.seq_k, P.hd, P.hd, vec);

  int lo, hi;
  q_range(P, k0, kDkvN, kDkvQ, lo, hi);
  const int nt = max(hi - lo, 0), tiles = P.g * nt;
  const int mine = tiles > part ? (tiles - part + parts - 1) / parts : 0;
  // this part's tile i (u = part + i * parts: query head nk * g + u / nt,
  // q tile lo + u % nt) into ring stage st
  auto stage = [&](int i, int st) {
    if (i >= mine) return;
    const int u = part + i * parts;
    const int n = nk * P.g + u / nt;
    const int q0 = (lo + u % nt) * kDkvQ;
    const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
    const size_t r_off = static_cast<size_t>(n) * P.seq_q;
    stage_cols<kDkvQ, HD, NTH>(Qs + st * kDkvQ * S, q + q_off, q0, P.seq_q,
                               P.hd, P.hd, vec);
    stage_cols<kDkvQ, HD, NTH>(dOs + st * kDkvQ * S, dout + q_off, q0,
                               P.seq_q, P.hd, P.hd, vec);
    stage_rows(Rs + st * 2 * kDkvQ, lse + r_off, delta + r_off, q0,
               P.seq_q);
  };
  // one commit group per tile: K and V ride with the first
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    stage(i, i);
    cp_commit();
  }

  // ldmatrix row addresses: K, V, P^T and dS^T as A (the slab's keys); Q
  // and dO as the col-major B of K Q^T and V dO^T (the warp's 16 rows),
  // and transposed as the B of P^T dO and dS^T Q (the warp's half)
  const uint32_t a_lane = (sl * 16 + lane % 16) * RB + (lane / 16) * 16;
  const uint32_t b_lane = ((lane % 8) + (lane / 16) * 8) * RB +
                          ((lane / 8) % 2) * 16 + hf * 16 * RB;
  const uint32_t t_lane = ((lane % 8) + ((lane / 8) % 2) * 8) * RB +
                          (lane / 16) * 16 + hf * kWideC * 2;
  const uint32_t p_lane = (sl * 16 + lane % 16) * PB + (lane / 16) * 16;
  constexpr uint32_t kStage = kDkvQ * RB;
  const uint32_t ka = smem_u32(Ks) + a_lane, va = smem_u32(Vs) + a_lane;
  const uint32_t qs0 = smem_u32(Qs), ds0 = smem_u32(dOs);
  const uint32_t pa0 = smem_u32(Pt) + p_lane, dsa0 = smem_u32(dSt) + p_lane;
  const int kt = min(KT, (P.hd + 15) / 16);
  const int ng = min(NT / 2, (P.hd - hf * kWideC + 15) / 16);

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const float sc = P.sm_scale * kLog2e;

  for (int i = 0, st = 0; i < mine;
       ++i, st = st + 1 < ST ? st + 1 : 0) {
    cp_wait<ST - 2>();
    // tile i has landed for every thread, and every warp is done with
    // tile i - 1 (its stage, P^T and dS^T)
    __syncthreads();
    stage(i + ST - 1, st == 0 ? ST - 1 : st - 1);
    cp_commit();

    const int u = part + i * parts;
    const int q0 = (lo + u % nt) * kDkvQ;
    const uint32_t qs = qs0 + st * kStage, dos = ds0 + st * kStage;
    // S^T = K Q^T and dP^T = V dO^T: the slab's 16 keys x the warp's 16
    // rows
    float s[JT][4], dp[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk >= kt) break;
      uint32_t a[4], b[4];
      ldsm_x4(a, ka + kk * 32);
      ldsm_x4(b, qs + b_lane + kk * 32);
      mma(s[0], a, b[0], b[1]);
      mma(s[1], a, b[2], b[3]);
      ldsm_x4(a, va + kk * 32);
      ldsm_x4(b, dos + b_lane + kk * 32);
      mma(dp[0], a, b[0], b[1]);
      mma(dp[1], a, b[2], b[3]);
    }

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta) sm_scale, into
    // shared memory as bf16
    const float* ls = Rs + st * 2 * kDkvQ;
    const float* dl = ls + kDkvQ;
    const bool full = all_kept(P, q0 + hf * 16, 16, kw, 16);
    const int off = (sl * 16 + lane / 4) * PS + hf * 16 + c2;
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pp[2], d[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int c = hf * 16 + 8 * j + c2 + x;
          float p = exp2f(s[j][2 * h + x] * sc - ls[c] * kLog2e);
          if (!full && !keep(P, q0 + c, kr + 8 * h)) p = 0.f;
          pp[x] = p;
          d[x] = p * (dp[j][2 * h + x] - dl[c]) * P.sm_scale;
        }
        const int at = off + 8 * h * PS + 8 * j;
        *reinterpret_cast<uint32_t*>(Pt + at) = pack_bf16(pp[0], pp[1]);
        *reinterpret_cast<uint32_t*>(dSt + at) = pack_bf16(d[0], d[1]);
      }
    __syncthreads();  // the slab's P^T and dS^T, every row, are in place

    // dV[slab, half] += P^T dO[:, half], dK[slab, half] += dS^T Q[:, half]
#pragma unroll
    for (int kk = 0; kk < kDkvQ / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      ldsm_x4(pa, pa0 + kk * 32);
      ldsm_x4(dsa, dsa0 + kk * 32);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (j >= ng) break;
        uint32_t b[4];
        ldsm_x4_t(b, dos + t_lane + kk * 16 * RB + j * 32);
        mma(dva[2 * j], pa, b[0], b[1]);
        mma(dva[2 * j + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, qs + t_lane + kk * 16 * RB + j * 32);
        mma(dka[2 * j], dsa, b[0], b[1]);
        mma(dka[2 * j + 1], dsa, b[2], b[3]);
      }
    }
  }
  cp_wait<0>();  // with fewer tiles than stages, copies may be in flight

  finish_dkv<NT, HD, NTH>(dka, dva, sl * 16 + lane / 4, c2, hf * kWideC, 0,
                          k0, parts, part, dk + kv_off, dv + kv_off, P,
                          reinterpret_cast<float*>(smem_tc));
}

// -- the wide forward (128 < hd <= 512) ------------------------------------
// Up to hd 256 the output columns are split over the warps of a block, as
// in the backward above: 8 warps, 4 slabs of 16 query rows by 2 column
// halves of o.  The two warps of a slab compute S once, each for 32 of a
// K/V tile's 64 keys over every column of the head (Q's fragments held in
// registers); they exchange their row maxima through shared memory (a
// barrier of the slab's two warps), so both keep one m, and hand p on in
// shared memory as bf16 (a second such barrier); each warp then
// multiplies the slab's whole P by its column half of V.  Each warp sums l
// over its own keys, and the two halves add up at the end.  Nothing is
// recomputed.  64-row q tiles; three stages of a 64-key K and V tile; Q
// rides in the last stage's V until tile lo + 2 takes it.  The f32-out
// entry hands on p_hi and p_lo both and issues two products a k-step.
constexpr int kFwdSplitM = 64;  // query rows per block

template <typename O>
struct FwdSplit {
  static constexpr int kStages = 3;
  static constexpr int kP = std::is_same<O, float>::value ? 2 : 1;
  static constexpr size_t kSmem =
      sizeof(bf16) * (kStages * 2 * kFwdN * (kSplitHd + 8) +
                      kP * kFwdSplitM * (kFwdN + 8)) +
      sizeof(float) * 2 * kFwdSplitM;  // row maxima, then sums, a half
};

static_assert(kFwdSplitM == kFwdN, "Q rides in one V stage");

// the two warps of slab `slab` (64 threads) meet at named barrier 1 + slab
__device__ __forceinline__ void slab_sync(int slab) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(slab + 1) : "memory");
}

template <int HD, typename O>
__global__ void __launch_bounds__(kSplitThreads, 1)
    flash_fwd_split_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, O* __restrict__ o,
                       float* __restrict__ lse, Problem P, int n_q,
                       bool vec) {
  constexpr bool kF32 = std::is_same<O, float>::value;
  constexpr int M = kFwdSplitM, NTH = kSplitThreads;
  constexpr int ST = FwdSplit<O>::kStages;
  constexpr int S = HD + 8, RB = 2 * S;
  constexpr int PS = kFwdN + 8, PB = 2 * PS;  // P: M rows x kFwdN keys
  constexpr int KT = HD / 16;         // k-steps of Q K^T
  constexpr int NT = kWideC / 8;      // 8-column tiles of an o half
  constexpr int JT = kFwdN / 2 / 8;   // 8-key tiles of a warp's S
  extern __shared__ uint4 smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);  // ST stages of kFwdN rows
  bf16* Vs = Ks + ST * kFwdN * S;               // ST stages of kFwdN rows
  bf16* Ps = Vs + ST * kFwdN * S;               // p (p_hi), then p_lo
  float* Xs = reinterpret_cast<float*>(Ps + FwdSplit<O>::kP * M * PS);
  bf16* Qs = Vs + (ST - 1) * kFwdN * S;

  // heavy first, as flash_fwd_tc
  const int tiles = (P.seq_q + M - 1) / M;
  const int rank = blockIdx.x / n_q, n = blockIdx.x % n_q;
  const int q0 = (P.causal ? tiles - 1 - rank : rank) * M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sl = warp % 4, hf = warp / 4;  // row slab, column half
  const int w0 = q0 + sl * 16;             // the slab's 16 rows
  const int r0 = w0 + lane / 4;            // this thread's rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);           // and columns c2, c2 + 1
  const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  int lo, hi;
  kv_range(P, q0, M, kFwdN, lo, hi);
  auto stage = [&](int t, int st) {
    if (t >= hi) return;
    stage_cols<kFwdN, HD, NTH>(Ks + st * kFwdN * S, kb, t * kFwdN, P.seq_k,
                               P.hd, P.hd, vec);
    stage_cols<kFwdN, HD, NTH>(Vs + st * kFwdN * S, vb, t * kFwdN, P.seq_k,
                               P.hd, P.hd, vec);
  };
  // one commit group per tile: Q rides with the first
  stage_cols<M, HD, NTH>(Qs, q + q_off, q0, P.seq_q, P.hd, P.hd, vec);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    stage(lo + i, i);
    cp_commit();
  }
  cp_wait<ST - 2>();
  __syncthreads();

  // k-steps that hold columns below hd (the rest are zeros)
  const int kt = min(KT, (P.hd + 15) / 16);
  uint32_t qf[KT][4];  // the slab's rows of Q as A fragments
  {
    const uint32_t a =
        smem_u32(Qs) + (sl * 16 + lane % 16) * RB + (lane / 16) * 16;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk >= kt) break;
      ldsm_x4(qf[kk], a + kk * 32);
    }
  }
  // ldmatrix row addresses: K as the col-major B of Q K^T (the warp's 32
  // keys), V transposed as the B of P V (the warp's column half), P as A
  // (the slab's rows, every key)
  const uint32_t k_lane = ((lane % 8) + (lane / 16) * 8) * RB +
                          ((lane / 8) % 2) * 16 + hf * 32 * RB;
  const uint32_t v_lane = ((lane % 8) + ((lane / 8) % 2) * 8) * RB +
                          (lane / 16) * 16 + hf * kWideC * 2;
  constexpr uint32_t kStage = kFwdN * RB;
  const uint32_t ks0 = smem_u32(Ks) + k_lane, vs0 = smem_u32(Vs) + v_lane;
  const uint32_t pa0 =
      smem_u32(Ps) + (sl * 16 + lane % 16) * PB + (lane / 16) * 16;
  // 16-column groups of the o half that hold columns below hd
  const int ng = min(NT / 2, (P.hd - hf * kWideC + 15) / 16);
  // this warp's and the other half's row maxima (then sums) of the slab
  float* xm = Xs + (sl * 2 + hf) * 16 + lane / 4;
  const float* xo = Xs + (sl * 2 + 1 - hf) * 16 + lane / 4;
  bf16* pr = Ps + (sl * 16 + lane / 4) * PS + hf * 32 + c2;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sc = P.sm_scale * kLog2e;

  for (int t = lo, st = 0; t < hi; ++t, st = st + 1 < ST ? st + 1 : 0) {
    cp_wait<ST - 2>();
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the next copy takes (Q's, the first time)
    __syncthreads();
    stage(t + ST - 1, st == 0 ? ST - 1 : st - 1);
    cp_commit();

    const uint32_t ks = ks0 + st * kStage, vs = vs0 + st * kStage;
    // S = Q K^T: the slab's 16 rows x the warp's 32 keys
    float s[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk >= kt) break;
#pragma unroll
      for (int j = 0; j < JT / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, ks + j * 16 * RB + kk * 32);
        mma(s[2 * j], qf[kk], b[0], b[1]);
        mma(s[2 * j + 1], qf[kk], b[2], b[3]);
      }
    }

    const int k0 = t * kFwdN + hf * 32;
    const bool full = all_kept(P, w0, 16, k0, 32);
    if (full) {
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sc;
    } else {
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = keep(P, r0 + (e / 2) * 8, k0 + 8 * j + c2 + e % 2)
                        ? s[j][e] * sc
                        : kNegInf;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (lane % 4 == 0) xm[8 * h] = mx[h];
    }
    // the other half's maxima are in: both warps take the same m
    slab_sync(sl);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], xo[8 * h]);
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float y = s[j][2 * h + x];
          p[x] = full || y > kNegInf * 0.5f ? exp2f(y - m[h]) : 0.f;
          rs[h] += p[x];
        }
        if constexpr (kF32) {
          uint32_t phi, plo;
          split_bf16(p[0], p[1], phi, plo);
          *reinterpret_cast<uint32_t*>(pr + 8 * h * PS + 8 * j) = phi;
          *reinterpret_cast<uint32_t*>(pr + M * PS + 8 * h * PS + 8 * j) =
              plo;
        } else {
          *reinterpret_cast<uint32_t*>(pr + 8 * h * PS + 8 * j) =
              pack_bf16(p[0], p[1]);
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    slab_sync(sl);  // the slab's P, both halves of its keys, is in place

    // o[slab, half] += P[slab, every key] V[every key, half]
#pragma unroll
    for (int kk = 0; kk < kFwdN / 16; ++kk) {
      uint32_t pa[4], pl[4];
      ldsm_x4(pa, pa0 + kk * 32);
      if constexpr (kF32) ldsm_x4(pl, pa0 + M * PB + kk * 32);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (j >= ng) break;
        uint32_t b[4];
        ldsm_x4_t(b, vs + kk * 16 * RB + j * 32);
        mma(acc[2 * j], pa, b[0], b[1]);
        mma(acc[2 * j + 1], pa, b[2], b[3]);
        if constexpr (kF32) {
          mma(acc[2 * j], pl, b[0], b[1]);
          mma(acc[2 * j + 1], pl, b[2], b[3]);
        }
      }
    }
  }

  // each warp summed l over its own keys: the two halves add up (in
  // either order the same f32 sum, so both warps divide by one l)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (lane % 4 == 0) xm[8 * h] = l[h];
  }
  slab_sync(sl);
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float ls = fmaxf(l[h] + xo[8 * h], 1e-30f);
    inv[h] = 1.f / ls;
    const int row = r0 + 8 * h;
    if (hf == 0 && lane % 4 == 0 && row < P.seq_q)
      lse[static_cast<size_t>(n) * P.seq_q + row] =
          (m[h] <= kNegInf * 0.5f ? kNegInf : m[h] * kLn2) + logf(ls);
  }
  O* ob = o + q_off;
  const int cb = hf * kWideC;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store_pair(ob, r0, cb + 8 * j + c2, acc[j][0] * inv[0],
               acc[j][1] * inv[0], P.seq_q, P.hd);
    store_pair(ob, r0 + 8, cb + 8 * j + c2, acc[j][2] * inv[1],
               acc[j][3] * inv[1], P.seq_q, P.hd);
  }
}

// Above hd 256, over blocks in 128-column chunks: a block of 8 warps (16
// query rows each, 128-row q tiles) owns one chunk of o and computes S
// over every chunk of the head for it, Q resident in shared memory (its
// A fragments reloaded each k-step), K streamed through a three-stage ring
// one (tile, chunk) step at a time; V's chunk of the block rides with a
// tile's last K chunk into one of two buffers (tile parity), so the
// block's own chunk of P V needs no wait of its own.  P stays in
// registers, as in flash_fwd_tc.  S is computed nc = ceil(hd / 128) times
// over: (nc + 1) / 2 of the forward's products (2x at hd 384, 2.5x at 512).
// nc >= 2 (here 3 or 4): with one chunk a V buffer would be refilled
// while still read.
template <int HD>
struct FwdWide {
  static constexpr int kStages = 3;
  static constexpr size_t kSmem =
      sizeof(bf16) * (kFwdM * (HD + 8) + (kStages + 2) * kFwdN * (kWideC + 8));
};

template <int HD, typename O>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_wide_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, O* __restrict__ o,
                      float* __restrict__ lse, Problem P, int n_q, int nc,
                      bool vec) {
  constexpr int M = kFwdM, NTH = kFwdThreads;
  constexpr int ST = FwdWide<HD>::kStages;
  constexpr int S = HD + 8, RB = 2 * S;          // Q: every column
  constexpr int SC = kWideC + 8, RC = 2 * SC;    // K, V: one chunk
  constexpr int KT = kWideC / 16;  // k-steps of a chunk
  constexpr int NT = kWideC / 8;   // 8-column tiles of the o chunk
  constexpr int JT = kFwdN / 8;    // 8-key tiles of S
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Ks = Qs + M * S;           // ST stages of kFwdN rows x kWideC
  bf16* Vs = Ks + ST * kFwdN * SC;  // 2 buffers of kFwdN rows x kWideC

  // heavy first, across heads and chunks
  const int tiles = (P.seq_q + M - 1) / M;
  const int per = n_q * nc;
  const int rank = blockIdx.x / per;
  const int n = (blockIdx.x % per) / nc, co = blockIdx.x % nc;
  const int q0 = (P.causal ? tiles - 1 - rank : rank) * M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = q0 + warp * 16;       // the warp's 16 rows
  const int r0 = w0 + lane / 4;        // this thread's rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);       // and columns c2, c2 + 1 of a tile
  const int cv = co * kWideC;          // the block's columns of o and V
  const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  int lo, hi;
  kv_range(P, q0, M, kFwdN, lo, hi);
  const int steps = max(hi - lo, 0) * nc;
  // step i (K/V tile lo + i / nc, K's chunk i % nc; with the last, V's
  // chunk co) into ring stage st (nothing past the last step)
  auto stage = [&](int i, int st) {
    if (i >= steps) return;
    const int u = i / nc, j = i % nc;
    const int row0 = (lo + u) * kFwdN;
    const int c0 = j * kWideC;
    stage_cols<kFwdN, kWideC, NTH>(Ks + st * kFwdN * SC, kb + c0, row0,
                                   P.seq_k, P.hd, P.hd - c0, vec);
    if (j == nc - 1)
      stage_cols<kFwdN, kWideC, NTH>(Vs + (u % 2) * kFwdN * SC, vb + cv,
                                     row0, P.seq_k, P.hd, P.hd - cv, vec);
  };
  // one commit group per step: Q rides with the first
  stage_cols<M, HD, NTH>(Qs, q + q_off, q0, P.seq_q, P.hd, P.hd, vec);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    stage(i, i);
    cp_commit();
  }

  // ldmatrix row addresses: Q as A (every column, reloaded each k-step);
  // a K chunk as the col-major B of Q K^T; V's chunk transposed as the B
  // of P V
  const uint32_t a_lane = (warp * 16 + lane % 16) * RB + (lane / 16) * 16;
  const uint32_t b_lane =
      ((lane % 8) + (lane / 16) * 8) * RC + ((lane / 8) % 2) * 16;
  const uint32_t t_lane =
      ((lane % 8) + ((lane / 8) % 2) * 8) * RC + (lane / 16) * 16;
  constexpr uint32_t kStage = kFwdN * RC;
  const uint32_t qa = smem_u32(Qs) + a_lane;
  const uint32_t ks0 = smem_u32(Ks) + b_lane, vs0 = smem_u32(Vs) + t_lane;
  // 16-column groups of the o chunk that hold columns below hd
  const int ng = min(NT / 2, (P.hd - cv + 15) / 16);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sc = P.sm_scale * kLog2e;

  int i = 0, st = 0;
  for (int t = lo, u = 0; t < hi; ++t, ++u) {
    // S = Q K^T over every chunk: the warp's 16 rows x kFwdN keys
    float s[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int j = 0; j < nc; ++j, ++i) {
      cp_wait<ST - 2>();
      // step i has landed for every thread, and every warp is done with
      // step i - 1, whose stage the next copy takes
      __syncthreads();
      stage(i + ST - 1, st == 0 ? ST - 1 : st - 1);
      cp_commit();
      const uint32_t ks = ks0 + st * kStage;
      const int c0 = j * kWideC;
      // k-steps that hold columns below hd (the rest are zeros)
      const int kt = min(KT, (P.hd - c0 + 15) / 16);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (kk >= kt) break;
        uint32_t a[4];
        ldsm_x4(a, qa + c0 * 2 + kk * 32);
#pragma unroll
        for (int jj = 0; jj < JT / 2; ++jj) {
          uint32_t b[4];
          ldsm_x4(b, ks + jj * 16 * RC + kk * 32);
          mma(s[2 * jj], a, b[0], b[1]);
          mma(s[2 * jj + 1], a, b[2], b[3]);
        }
      }
      st = st + 1 < ST ? st + 1 : 0;
    }

    const int k0 = t * kFwdN;
    const bool full = all_kept(P, w0, 16, k0, kFwdN);
    if (full) {
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sc;
    } else {
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = keep(P, r0 + (e / 2) * 8, k0 + 8 * j + c2 + e % 2)
                        ? s[j][e] * sc
                        : kNegInf;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p =
            full || x > kNegInf * 0.5f ? exp2f(x - m[e / 2]) : 0.f;
        s[j][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // o[:, chunk co] += P V[:, chunk co]: V's buffer of tile parity u
    const uint32_t vs = vs0 + (u % 2) * kStage;
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk) {
      uint32_t pa[4], pl[4];
      if constexpr (std::is_same<O, float>::value) {
        split_bf16(s[2 * kk][0], s[2 * kk][1], pa[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], pa[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pl[3]);
      } else {
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (j >= ng) break;
        uint32_t b[4];
        ldsm_x4_t(b, vs + kk * 16 * RC + j * 32);
        mma(acc[2 * j], pa, b[0], b[1]);
        mma(acc[2 * j + 1], pa, b[2], b[3]);
        if constexpr (std::is_same<O, float>::value) {
          mma(acc[2 * j], pl, b[0], b[1]);
          mma(acc[2 * j + 1], pl, b[2], b[3]);
        }
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float ls = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / ls;
    const int row = r0 + 8 * h;
    if (co == 0 && lane % 4 == 0 && row < P.seq_q)
      lse[static_cast<size_t>(n) * P.seq_q + row] =
          (m[h] <= kNegInf * 0.5f ? kNegInf : m[h] * kLn2) + logf(ls);
  }
  O* ob = o + q_off;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store_pair(ob, r0, cv + 8 * j + c2, acc[j][0] * inv[0],
               acc[j][1] * inv[0], P.seq_q, P.hd);
    store_pair(ob, r0 + 8, cv + 8 * j + c2, acc[j][2] * inv[1],
               acc[j][3] * inv[1], P.seq_q, P.hd);
  }
}

// -- launch ----------------------------------------------------------------
bool tc_vec(int hd, std::initializer_list<const void*> ptrs) {
  if (hd % 8 != 0) return false;
  for (const void* p : ptrs)
    if (!vtpu::aligned16(p)) return false;
  return true;
}

template <int HD, typename O>
int fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
           int n_q, const Problem& P, bool vec, cudaStream_t st) {
  auto kernel = flash_fwd_tc<HD, O>;
  const size_t smem =
      sizeof(bf16) * (HD + 8) * (kFwdM + 2 * kStages * kFwdN);
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks =
      static_cast<long long>((P.seq_q + kFwdM - 1) / kFwdM) * n_q;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kFwdThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<O*>(o),
      static_cast<float*>(lse), P, n_q, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dkv_tc(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv,
           int n_kv, const Problem& P, bool vec, cudaStream_t st) {
  auto kernel = flash_dkv_tc<HD>;
  const size_t smem =
      sizeof(bf16) * (HD + 8) * (2 * kDkvN + 2 * kStages * kDkvQ) +
      sizeof(float) * 2 * kStages * kDkvQ;
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks =
      static_cast<long long>((P.seq_k + kDkvN - 1) / kDkvN) * n_kv;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kDkvThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), P, n_kv, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dq_tc(const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, void* dq, int n_q,
          const Problem& P, bool vec, cudaStream_t st) {
  auto kernel = flash_dq_tc<HD>;
  const size_t smem =
      sizeof(bf16) * (HD + 8) * (2 * kDqM + 2 * kStages * kDqN);
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks =
      static_cast<long long>((P.seq_q + kDqM - 1) / kDqM) * n_q;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kDqThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), P, n_q, vec);
  return static_cast<int>(cudaGetLastError());
}

// dk/dv's cells (key tile, kv head[, chunk]) are split over clusters of
// `parts` blocks, parts doubled up to kMaxParts until the grid fills the
// card once (blocks_per_sm: a block's resident count)
cudaError_t cluster_parts(long long cells, int blocks_per_sm, int& parts) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  parts = 1;
  while (parts < kMaxParts &&
         cells * parts < static_cast<long long>(sms) * blocks_per_sm)
    parts *= 2;
  if (e == cudaSuccess && cells * parts > INT_MAX)
    e = cudaErrorInvalidValue;
  return e;
}

// the launch configuration of `blocks` blocks in clusters of `parts`
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster;
  ClusterLaunch(long long blocks, int threads, size_t smem, cudaStream_t st,
                int parts) {
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = parts;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = parts > 1 ? 1 : 0;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

template <int HD>
int dq_wide_tc(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, int n_q,
               const Problem& P, bool vec, cudaStream_t st) {
  using W = DqWide<HD>;
  auto kernel = flash_dq_wide_tc<HD>;
  cudaError_t e = vtpu::allow_smem(kernel, W::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = (P.hd + kWideC - 1) / kWideC;
  const long long blocks =
      static_cast<long long>((P.seq_q + W::M - 1) / W::M) * n_q * nc;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), W::kThreads, W::kSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), P, n_q, nc, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dkv_wide_tc(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int n_kv, const Problem& P, bool vec,
                cudaStream_t st) {
  using W = DkvWide<HD>;
  auto kernel = flash_dkv_wide_tc<HD>;
  cudaError_t e = vtpu::allow_smem(kernel, W::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = (P.hd + kWideC - 1) / kWideC;
  const long long cells =
      static_cast<long long>((P.seq_k + kDkvN - 1) / kDkvN) * n_kv * nc;
  int parts = 1;
  e = cluster_parts(cells, W::kBlocksPerSm, parts);
  if (e != cudaSuccess) return static_cast<int>(e);
  ClusterLaunch L(cells * parts, kDkvThreads, W::kSmem, st, parts);
  e = cudaLaunchKernelEx(
      &L.cfg, kernel, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), P, n_kv, nc, parts, vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int dq_split_tc(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int n_q, const Problem& P, bool vec,
                cudaStream_t st) {
  auto kernel = flash_dq_split_tc<kSplitHd>;
  cudaError_t e = vtpu::allow_smem(kernel, DqSplit::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks =
      static_cast<long long>((P.seq_q + kSplitM - 1) / kSplitM) * n_q;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kSplitThreads, DqSplit::kSmem,
           st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), P, n_q, vec);
  return static_cast<int>(cudaGetLastError());
}

int dkv_split_tc(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int n_kv, const Problem& P, bool vec,
                 cudaStream_t st) {
  auto kernel = flash_dkv_split_tc<kSplitHd>;
  cudaError_t e = vtpu::allow_smem(kernel, DkvSplit::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long cells =
      static_cast<long long>((P.seq_k + kDkvN - 1) / kDkvN) * n_kv;
  int parts = 1;
  e = cluster_parts(cells, 1, parts);
  if (e != cudaSuccess) return static_cast<int>(e);
  ClusterLaunch L(cells * parts, kSplitThreads, DkvSplit::kSmem, st, parts);
  e = cudaLaunchKernelEx(
      &L.cfg, kernel, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), P, n_kv, parts, vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int fwd_split_tc(const void* q, const void* k, const void* v, void* o,
                 void* lse, int n_q, const Problem& P, bool vec,
                 cudaStream_t st) {
  auto kernel = flash_fwd_split_tc<kSplitHd, O>;
  const size_t smem = FwdSplit<O>::kSmem;
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks =
      static_cast<long long>((P.seq_q + kFwdSplitM - 1) / kFwdSplitM) * n_q;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kSplitThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<O*>(o),
      static_cast<float*>(lse), P, n_q, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename O>
int fwd_wide_tc(const void* q, const void* k, const void* v, void* o,
                void* lse, int n_q, const Problem& P, bool vec,
                cudaStream_t st) {
  auto kernel = flash_fwd_wide_tc<HD, O>;
  const size_t smem = FwdWide<HD>::kSmem;
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = (P.hd + kWideC - 1) / kWideC;
  const long long blocks =
      static_cast<long long>((P.seq_q + kFwdM - 1) / kFwdM) * n_q * nc;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kFwdThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<O*>(o),
      static_cast<float*>(lse), P, n_q, nc, vec);
  return static_cast<int>(cudaGetLastError());
}

// 128 < hd <= 512 (any hd <= 512 runs): split over warps up to hd 256,
// chunked over blocks above
template <typename O>
int launch_fwd_wide_tc(const void* q, const void* k, const void* v, void* o,
                       void* lse, int n_q, int g, int seq_q, int seq_k,
                       int hd, int causal, int shift, int window,
                       float sm_scale, void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale, vtpu::flash::kMaxWideHd))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = tc_vec(hd, {q, k, v});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= kSplitHd
             ? fwd_split_tc<O>(q, k, v, o, lse, n_q, P, vec, st)
             : fwd_wide_tc<512, O>(q, k, v, o, lse, n_q, P, vec, st);
}

template <typename O>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  void* lse, int n_q, int g, int seq_q, int seq_k, int hd,
                  int causal, int shift, int window, float sm_scale,
                  void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = tc_vec(hd, {q, k, v});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 64 ? fwd_tc<64, O>(q, k, v, o, lse, n_q, P, vec, st)
                  : fwd_tc<128, O>(q, k, v, o, lse, n_q, P, vec, st);
}

}  // namespace

extern "C" int vtpu_flash_fwd_bf16(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int n_q, int g, int seq_q, int seq_k,
                                   int hd, int causal, int shift,
                                   int window, float sm_scale,
                                   void* stream) {
  return launch_fwd_tc<bf16>(q, k, v, o, lse, n_q, g, seq_q, seq_k, hd,
                             causal, shift, window, sm_scale, stream);
}

// o in f32 (ring attention's partials): p split into two bf16 halves
extern "C" int vtpu_flash_fwd_bf16_f32out(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int n_q, int g, int seq_q,
                                          int seq_k, int hd, int causal,
                                          int shift, int window,
                                          float sm_scale, void* stream) {
  return launch_fwd_tc<float>(q, k, v, o, lse, n_q, g, seq_q, seq_k, hd,
                              causal, shift, window, sm_scale, stream);
}

// 128 < hd <= 512: flash_fwd_split_tc up to hd 256, flash_fwd_wide_tc above
extern "C" int vtpu_flash_fwd_wide_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int n_q, int g, int seq_q, int seq_k,
                                        int hd, int causal, int shift,
                                        int window, float sm_scale,
                                        void* stream) {
  return launch_fwd_wide_tc<bf16>(q, k, v, o, lse, n_q, g, seq_q, seq_k, hd,
                                  causal, shift, window, sm_scale, stream);
}

// the same with o in f32 (ring attention's partials at hd > 128)
extern "C" int vtpu_flash_fwd_wide_bf16_f32out(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int n_q, int g, int seq_q, int seq_k, int hd, int causal, int shift,
    int window, float sm_scale, void* stream) {
  return launch_fwd_wide_tc<float>(q, k, v, o, lse, n_q, g, seq_q, seq_k,
                                   hd, causal, shift, window, sm_scale,
                                   stream);
}

extern "C" int vtpu_flash_bwd_dkv_bf16(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int n_q, int g,
                                       int seq_q, int seq_k, int hd,
                                       int causal, int shift, int window,
                                       float sm_scale, void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = tc_vec(hd, {q, k, v, dout});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_kv = n_q / g;
  return hd <= 64 ? dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, n_kv, P,
                               vec, st)
                  : dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, n_kv, P,
                                vec, st);
}

extern "C" int vtpu_flash_bwd_dq_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int n_q, int g, int seq_q,
                                      int seq_k, int hd, int causal,
                                      int shift, int window, float sm_scale,
                                      void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = tc_vec(hd, {q, k, v, dout});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 64
             ? dq_tc<64>(q, k, v, dout, lse, delta, dq, n_q, P, vec, st)
             : dq_tc<128>(q, k, v, dout, lse, delta, dq, n_q, P, vec, st);
}

// 128 < hd <= 512 (any hd <= 512 runs): the head dim in 128-column chunks
extern "C" int vtpu_flash_bwd_dkv_wide_bf16(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int n_q, int g,
                                            int seq_q, int seq_k, int hd,
                                            int causal, int shift,
                                            int window, float sm_scale,
                                            void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale, vtpu::flash::kMaxWideHd))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = tc_vec(hd, {q, k, v, dout});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_kv = n_q / g;
  return hd <= kSplitHd ? dkv_split_tc(q, k, v, dout, lse, delta, dk, dv,
                                        n_kv, P, vec, st)
                        : dkv_wide_tc<512>(q, k, v, dout, lse, delta, dk,
                                           dv, n_kv, P, vec, st);
}

extern "C" int vtpu_flash_bwd_dq_wide_bf16(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse,
                                           const void* delta, void* dq,
                                           int n_q, int g, int seq_q,
                                           int seq_k, int hd, int causal,
                                           int shift, int window,
                                           float sm_scale, void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale, vtpu::flash::kMaxWideHd))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = tc_vec(hd, {q, k, v, dout});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= kSplitHd ? dq_split_tc(q, k, v, dout, lse, delta, dq, n_q,
                                       P, vec, st)
                        : dq_wide_tc<512>(q, k, v, dout, lse, delta, dq, n_q,
                                          P, vec, st);
}
