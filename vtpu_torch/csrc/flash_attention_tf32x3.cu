// Flash attention's f32 kernels on Hopper's tensor cores (sm_90a), as
// error-compensated 3xTF32: the forward (o and the per-row logsumexp),
// dq, and dk with dv, at every hd <= 512.  The entries and the Pallas TPU
// kernels of vtpu/ops/attention.py they replace:
//
//   vtpu_flash_fwd_f32           flash_fwd_tf32x3<64|128>        (hd <= 128)
//   vtpu_flash_fwd_wide_f32      flash_fwd_tf32x3<256|512>       (128 < hd)
//                                <- _attn_kernel (pallas_call at :409,
//                                reached from _flash_2d)
//   vtpu_flash_bwd_dq_f32        flash_dq_tf32x3<64|128>         (hd <= 128)
//   vtpu_flash_bwd_dq_wide_f32   flash_dq_split_tf32x3<256|512>  (128 < hd)
//                                <- _attn_bwd_dq_kernel (pallas_call at :441,
//                                reached from _flash_bwd_2d)
//   vtpu_flash_bwd_dkv_f32       flash_dkv_tf32x3<64|128>        (hd <= 128)
//   vtpu_flash_bwd_dkv_wide_f32  flash_dkv_split_tf32x3<256|512> (128 < hd)
//                                <- _attn_bwd_dkv_kernel (pallas_call at :459,
//                                reached from _flash_bwd_2d)
//
// The forward computes what flash_attention_reference in ops/attention.py
// computes: S = Q K^T sm_scale, an online softmax with m from -1e30 and
// p = 0 on every masked entry, l clamped at 1e-30, o = acc / l and
// lse = m + log(l) (a row with no kept key, the first row under
// shift = -1, writes o = 0 and lse ~ -1e30).  The backward computes what
// flash_bwd_dq_reference and flash_bwd_dkv_reference compute: p =
// exp(s * sm_scale - lse) with p = 0 on every masked entry (so a row
// whose lse is ~-1e30 gives no gradient), dS = p (dP - delta) sm_scale,
// dq = dS K, dk = dS^T Q and dv = P^T dO.  Query head n reads kv head
// n / g (grouped-query attention written into the index: k and v are
// never repeated), and the causal, shift and window bounds are those of
// flash_common.cuh.  Layouts: q, o, do, dq [N, seq_q, hd]; k, v, dk, dv
// [N / g, seq_k, hd]; lse, delta [N, seq_q] f32, N flattening every
// leading dim of the public [..., s, hd] tensors.  Every length and every
// hd <= 512 runs here: tiles past seq_q, seq_k or hd are zero-filled on
// the way in and never written (the TPU wrapper sends a length that is
// not a multiple of 128 to the XLA reference instead).
//
// Why 3xTF32.  One TF32 product keeps 11 bits of each operand, about
// 5e-4 relative error a product, and the f32 checks (o within 2e-5 and
// lse within 2e-5 relative; dq, dk, dv within 1e-4 of their largest
// value; a train step's gradients within 1e-4) would fail: emulated at
// hd 64-512 against the Pallas kernels, one TF32 product misses o by
// 3.0e-4 to 1.8e-3 (tests/test_torch_f32_forward.py).  So each operand x
// is split as hi + lo (split() below: hi rounded to TF32 as
// cvt.rna.tf32.f32 rounds, lo = x - hi read by the tensor core as TF32
// rounded toward zero; hi + lo misses x by less than 2^-21 |x|), and a
// product takes three m16n8k8 TF32 mma.sync into one f32 accumulator,
// the two small ones first: a_lo b_hi, a_hi b_lo, a_hi b_hi.  What is
// dropped (a_lo b_lo, lo's rounding) is about 2^-20 of a product.
//
// What bounds them on an H100: operations.  The forward does 4 * hd flops
// per kept (query, key) pair (Q K^T, P V), dq 6 * hd (Q K^T, dO V^T,
// dS K), dk/dv 8 * hd (Q K^T, dO V^T, P^T dO, dS^T Q).  Causal at b 2,
// H 32, kv 8, s 4096, hd 128 that is 2.749e11, 4.124e11 and 5.499e11
// flops, and the same at the full-width hd 256 shape (b 2, H 16, kv 4,
// s 4096: H * hd is 4096 in both).  Three TF32 products at the 495
// TFLOP/s TF32 peak do 165 TFLOP/s of f32 work: 1.6663, 2.4995 and
// 3.3327 ms, against 4.1037, 6.1555 and 8.2073 ms at the 67 TFLOP/s of
// the CUDA cores; the bytes (q, k, v, do, lse, delta once, o, dq or dk
// and dv once) take ~0.1 ms at 3.35 TB/s.  mma.sync reaches about half
// that peak on this card, and three of them a product leave few issue
// slots for anything else, so the design keeps the instructions beside
// each mma few:
//
//  - The split is three integer and float instructions (cvt.rna itself
//    compiles to four), and no element is split twice where several
//    warps read it: a tile that every warp of a block reads as the B of
//    its products (K and V for the forward and dq; Q and dO for dk/dv)
//    is split once, by the whole block, into hi and lo planes in shared
//    memory, and its fragments load from there.  What only one warp
//    reads as an A (its own rows of Q for the forward, of Q and dO for
//    dq, its own keys of K or V for dk/dv) stays f32 and is split at
//    fragment load, in registers.
//  - No ldmatrix: its .trans moves 16-bit halves and cannot transpose
//    32-bit values, so fragments load by 32-bit shared loads.  The planes'
//    rows are padded by 4 floats (stride hd + 4, 4 mod 32 banks), which
//    keeps both read patterns free of bank conflicts: along a stored row
//    (thread (g, t) reads row g, column t) and across stored rows (rows 2t
//    and 2t + 1, column g: V in P V, K in dS K, dO in P^T dO, Q in
//    dS^T Q).  The A
//    tiles are not padded (shared memory is full) but swizzled: column c
//    of row r lies at c ^ 4 (r % 8), which spreads 8 rows over the banks.
//  - P and dS go from the accumulators straight into A fragments.  An
//    m16n8 accumulator holds columns (2t, 2t + 1) and a k8 TF32 A fragment
//    columns (t, t + 4), so the k index of the next product is paired: k t
//    is column 2t and k t + 4 column 2t + 1 of the 8-column tile, which
//    makes the A fragment {c0, c2, c1, c3} of the accumulator, and the B
//    fragment reads rows 2t and 2t + 1 (above).  No shuffle.
//  - The forward (flash_fwd_tf32x3): one block of 8 warps per (q tile,
//    query head); a slab of 16 query rows has one warp a group of
//    min(hd, 128) columns of o, so up to hd 128 a warp owns its 16 rows
//    (128-row q tiles, 32-key K/V tiles), and above it the slab's warps
//    split o's columns as the _split_ kernels below do (<256>: 4 slabs of
//    2 groups, 64 rows, 16-key tiles; <512>: 2 slabs of 4, 32 rows, 8
//    keys): each warp forms its group's share of S over its 128 columns,
//    and every warp of the slab adds the shares in group order after a
//    named barrier of the slab, so each holds the same S, m and l.  Q
//    stays resident; each K/V tile lands as f32 by cp.async while the tile
//    before is multiplied and is split into the planes between two
//    barriers.  The row max takes two shuffles within a quad (a row lies
//    on the 4 threads of a quad in an m16n8 fragment); l stays per thread
//    until the end.  P goes from the S accumulators into A fragments
//    (above), and each 8-column tile of a key tile's P V is summed from
//    zero in the tensor core and added to o in f32 as o alpha + P V (the
//    TPU kernel's acc * alpha + p @ v): no chain of truncating sums is
//    longer than a key tile's, so o needs no flush, and the FMA takes the
//    place of the rescaling multiply.  Shared memory: 165,888 bytes at
//    hd 128, 173,056 at <256>, 168,448 at <512>.
//  - dq: one block of 8 warps per (128-row q tile, query head), 16 rows a
//    warp; Q and dO resident; 32-key K/V tiles land as f32 by cp.async
//    while the tile before is multiplied, and are split into the planes
//    between two barriers (K; V's split for the next tile runs beside
//    dS K, which reads only K); dq (hd / 2 f32 a thread) summed in
//    registers and written once by the block that owns the rows.  Shared
//    memory: 231,424 bytes at hd 128.
//  - dk/dv: one block of 12 warps per (96-key tile, kv head), K and V
//    resident, 6 pairs of warps with 16 keys each: the first warp of a
//    pair computes S^T = K Q^T and P^T and sums dV = P^T dO, the second
//    dP^T = V dO^T, takes P^T from the first through shared memory (a
//    named barrier of the pair's 64 threads), forms dS^T and sums
//    dK = dS^T Q.  So a warp holds one output (hd / 2 f32 a thread) and
//    does one of each kind of product, and 12 warps fit the register
//    file.  The block walks the g query heads of its group and their
//    32-row q tiles; each tile's Q, dO, lse and delta land by cp.async
//    while the tile before is multiplied.  The tensor core truncates its
//    f32 sums, so a long chain of mma.sync into one accumulator drifts
//    toward zero (past the 1e-4 limit for dk and dv at the shape above):
//    a warp sums kFlush steps, adds them to its output rows in
//    f32 and starts again from zero.  A warp owns its output rows, so no
//    atomics: two calls give the same bits.  Shared memory: 211,456
//    bytes at hd 128.
//  - Above hd 128 (the _split_ kernels, instances <256> for hd <= 256 and
//    <512> above): a warp still holds kWideC = 128 columns of an output
//    (64 f32 a thread), so the output columns are split into HD / 128
//    groups over the warps of a slab of 16 rows (dq: query rows; dk/dv:
//    keys), and S and dP are formed once a block, not once a group: each
//    warp of a slab computes its group's share of the products that sum
//    over the head dim (S = Q K^T, dP = dO V^T; for dk/dv S^T = K Q^T or
//    dP^T = V dO^T) over its 128 columns only, the shares meet in shared
//    memory after a barrier, and every warp of the slab adds them in group
//    order (so all get the same bits).  Nothing is recomputed, and no
//    warp splits more of its A rows than its own group's columns.  The
//    k-loops hold no branch (one that left them early, for columns past
//    hd, kept ptxas from moving loads across k-steps and cost about a
//    fifth of both kernels' time at hd 256; PERF.md, PR 23), so a group
//    that lies wholly or partly past hd multiplies the zero fill: the
//    <256> instance does hd 256's work at hd 192, the <512> one hd 512's
//    at hd 320.
//  - dq above 128: 8 warps, 4 slabs of 16 rows by 2 groups (64 rows) at
//    <256>, 2 slabs by 4 groups (32 rows) at <512>; Q and dO resident
//    (swizzled, 131,072 bytes), K/V tiles of 16 (8) keys as planes.  A
//    raw K/V tile does not fit beside them, so the next tile's K and V
//    come into registers (4 float4 each a thread) while a tile is
//    multiplied and are split into the planes from there: K between two
//    barriers, V beside dS K, which reads only K.  214,016 / 205,312 bytes.
//  - dk/dv above 128: a slab of 16 keys holds 2 * hd / 128 warps, dV's
//    groups then dK's; a dV warp computes its group's share of S^T, a dK
//    warp its share of dP^T; after a named barrier of the slab each warp
//    forms P^T (a dK warp also dS^T) from the summed shares and sums its
//    group of dV = P^T dO or dK = dS^T Q.  12 warps, 3 slabs (48 keys) at
//    <256>, 8 warps, 1 slab (16 keys) at <512>; Q/dO tiles of 16 (8) rows
//    land raw by cp.async while the step before is multiplied and are
//    split into planes between two barriers.  210,176 / 168,576 bytes.
//  - Above hd 128 every accumulator that sums over the sequence, dq's
//    too, is flushed into its output every kFlushK k-steps of 8 keys or
//    rows; at hd <= 128 only dk/dv's are (dq sums its seq_k / 8 k-steps
//    in one chain there, 3.2e-6 of its largest value at the main shape).
//  - Fully masked tiles are skipped with the reference's bounds
//    (kv_range, q_range), keep() runs only on tiles that straddle the
//    diagonal, the window edge or a ragged end, and the heavy tiles of a
//    causal grid (the last q tiles for the forward and dq, the first k
//    tiles for dk/dv) are launched first.  Where hd % 4 != 0 or a pointer is not 16-byte
//    aligned, the tiles are staged by plain loads instead of cp.async.

#include <initializer_list>

#include "flash_common.cuh"

namespace {

using vtpu::cp_async16;
using vtpu::cp_async4;
using vtpu::cp_commit;
using vtpu::cp_wait;
using vtpu::smem_u32;
using vtpu::flash::all_kept;
using vtpu::flash::keep;
using vtpu::flash::kNegInf;
using vtpu::flash::kv_range;
using vtpu::flash::make_problem;
using vtpu::flash::Problem;
using vtpu::flash::q_range;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kDqThreads = 256;   // dq: 8 warps
constexpr int kDqM = 128;         // dq: query rows a block, 16 a warp
constexpr int kDqN = 32;          // dq: keys a K/V tile
constexpr int kDkvThreads = 384;  // dk/dv: 6 pairs of warps
constexpr int kDkvN = 96;         // dk/dv: keys a block, 16 a pair
constexpr int kDkvQ = 32;         // dk/dv: query rows a Q/dO tile
constexpr int kPad = 4;           // floats of padding a row of a plane
constexpr int kFlushK = 128;      // k-steps a warp sums before a flush
constexpr int kFlush = kFlushK / (kDkvQ / 8);  // dk/dv: steps a flush
constexpr int kWideC = 128;       // hd > 128: columns a warp holds of an output

// -- 3xTF32 ------------------------------------------------------------------
// x as hi + lo.  hi is x rounded to TF32 to nearest, ties away from zero
// (cvt.rna.tf32.f32's rounding, as integer arithmetic: half a TF32 ulp
// added to the magnitude's bits, which carries into the exponent where it
// must, and the 13 low bits cleared; cvt.rna itself compiles to four
// instructions on sm_90a).  lo = x - hi is exact in f32 and goes to the
// tensor core as it is: the mma reads its top 19 bits, so lo is rounded
// toward zero to TF32 there.  hi + lo misses x by less than 2^-21 |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x to 2^-22 of the result (flushing a result below 2^-126 to zero)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// c += a (16 x 8, row-major) * b (8 x 8, col-major): TF32, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b to about 2^-20 of each product: the small products first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(c, al, bh[0], bh[1]);
  mma(c, ah, bl[0], bl[1]);
  mma(c, ah, bh[0], bh[1]);
}

// -- fragments (thread (g, t) = (lane / 4, lane % 4)) ------------------------
// A of rows [r, r + 16) (r % 8 == 0), columns [c, c + 8) of a swizzled
// tile (below): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), split in
// registers
template <int HD>
__device__ __forceinline__ void load_a(const float* X, int r, int c, int g,
                                       int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = X + (r + g) * HD;
  const int c0 = (c + t) ^ (g << 2), c1 = (c + t + 4) ^ (g << 2);
  split(p[c0], hi[0], lo[0]);
  split(p[8 * HD + c0], hi[1], lo[1]);
  split(p[c1], hi[2], lo[2]);
  split(p[8 * HD + c1], hi[3], lo[3]);
}

// B of X Y^T from Y's hi and lo planes (row stride S): rows [n, n + 8) of
// Y as its columns, Y's columns [c, c + 8) as k: (k t, n g) =
// Y[n + g][c + t], (t + 4, g) = Y[n + g][c + t + 4]
template <int S>
__device__ __forceinline__ void load_bt(const float* H, const float* L,
                                        int n, int c, int g, int t,
                                        uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  const int at = (n + g) * S + c + t;
  hi[0] = __float_as_uint(H[at]);
  hi[1] = __float_as_uint(H[at + 4]);
  lo[0] = __float_as_uint(L[at]);
  lo[1] = __float_as_uint(L[at + 4]);
}

// B of X Y from Y's planes with the k index paired (to meet acc_as_a):
// rows [r, r + 8) of Y as k, its columns [c, c + 8) as n: (k t, n g) =
// Y[r + 2t][c + g], (t + 4, g) = Y[r + 2t + 1][c + g]
template <int S>
__device__ __forceinline__ void load_b_paired(const float* H, const float* L,
                                              int r, int c, int g, int t,
                                              uint32_t (&hi)[2],
                                              uint32_t (&lo)[2]) {
  const int at = (r + 2 * t) * S + c + g;
  hi[0] = __float_as_uint(H[at]);
  hi[1] = __float_as_uint(H[at + S]);
  lo[0] = __float_as_uint(L[at]);
  lo[1] = __float_as_uint(L[at + S]);
}

// An m16n8 accumulator (rows g, g + 8; columns 2t, 2t + 1) as the A of
// the next product, k paired: k t is column 2t, k t + 4 column 2t + 1
__device__ __forceinline__ void acc_as_a(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// -- staging -----------------------------------------------------------------
// Rows [row0, row0 + ROWS) and columns [0, w) of a [rows, ld] matrix as
// ROWS rows of HD floats, zero past `rows` and past w.  SWZ: element
// (r, c) at column c ^ 4 (r % 8), so that the A fragments of 8 rows fall
// on distinct banks without padding; else row-major.  vec: 16-byte
// cp.async copies (w, ld multiples of 4, src 16-byte aligned); else plain
// loads.
template <int ROWS, int HD, bool SWZ, int NT>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int row0, int rows, int ld, int w,
                                      bool vec) {
  if (vec) {
    constexpr int CH = HD / 4;  // 16-byte chunks a row
    constexpr int N = ROWS * CH;
#pragma unroll
    for (int it = 0; it < (N + NT - 1) / NT; ++it) {
      const int i = threadIdx.x + it * NT;
      if (N % NT != 0 && i >= N) break;
      const int r = i / CH, c = (i % CH) * 4;
      const int row = row0 + r;
      const bool ok = row < rows && c < w;
      cp_async16(smem_u32(dst + r * HD + (SWZ ? c ^ ((r & 7) << 2) : c)),
                 ok ? src + static_cast<size_t>(row) * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HD; i += NT) {
      const int r = i / HD, c = i % HD;
      const int row = row0 + r;
      dst[r * HD + (SWZ ? c ^ ((r & 7) << 2) : c)] =
          row < rows && c < w ? src[static_cast<size_t>(row) * ld + c] : 0.f;
    }
  }
}

// x split into hi and lo, stored at ah[at .. at + 4) and al[at .. at + 4)
__device__ __forceinline__ void put_split(float4 x, float* ah, float* al,
                                          int at) {
  uint4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(ah + at) = h;
  *reinterpret_cast<uint4*>(al + at) = l;
}

// The hi and lo planes (row stride HD + kPad) of a staged row-major
// [ROWS, HD] tile, split once for every warp that reads them
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void split_plane(const float* a, float* ah,
                                            float* al) {
  constexpr int S = HD + kPad;
  constexpr int CH = HD / 4;
  constexpr int N = ROWS * CH;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int k = threadIdx.x + it * NT;
    if (N % NT != 0 && k >= N) break;
    const int r = k / CH, c = (k % CH) * 4;
    put_split(*reinterpret_cast<const float4*>(a + r * HD + c), ah, al,
              r * S + c);
  }
}

// Columns [c, c + 4) of row `row` of a [rows, ld] matrix, zero past
// `rows` and past w; vec: one 16-byte load (as stage's cp.async)
__device__ __forceinline__ float4 fetch4(const float* __restrict__ src,
                                         int row, int c, int rows, int ld,
                                         int w, bool vec) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows || c >= w) return x;
  const float* p = src + static_cast<size_t>(row) * ld + c;
  if (vec) return *reinterpret_cast<const float4*>(p);
  x.x = p[0];
  if (c + 1 < w) x.y = p[1];
  if (c + 2 < w) x.z = p[2];
  if (c + 3 < w) x.w = p[3];
  return x;
}

// Rows [row0, row0 + ROWS) and columns [0, w) of a [rows, ld] matrix into
// a thread's registers: x[i] is 16-byte chunk threadIdx.x + i NT of the
// row-major [ROWS, HD] tile (for a plane where a raw tile does not fit)
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void fetch_tile(float4 (&x)[ROWS * HD / 4 / NT],
                                           const float* __restrict__ src,
                                           int row0, int rows, int ld, int w,
                                           bool vec) {
  constexpr int CH = HD / 4;
  static_assert(ROWS * CH % NT == 0, "a tile is whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int k = threadIdx.x + i * NT;
    x[i] = fetch4(src, row0 + k / CH, (k % CH) * 4, rows, ld, w, vec);
  }
}

// fetch_tile's registers into the hi and lo planes (row stride HD + kPad)
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void stash_tile(
    const float4 (&x)[ROWS * HD / 4 / NT], float* ah, float* al) {
  constexpr int CH = HD / 4;
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int k = threadIdx.x + i * NT;
    put_split(x[i], ah, al, (k / CH) * (HD + kPad) + (k % CH) * 4);
  }
}

// lse and delta of rows [row0, row0 + Q) into dst[0..Q) and dst[Q..2Q),
// zero past `rows`
template <int Q, int NT>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int row0, int rows) {
  for (int i = threadIdx.x; i < 2 * Q; i += NT) {
    const float* src = i < Q ? lse : delta;
    const int row = row0 + i % Q;
    const bool ok = row < rows;
    cp_async4(smem_u32(dst + i), ok ? src + row : src, ok);
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// (a, b) into columns col, col + 1 of row `row` of a [rows, hd] f32
// matrix, dropping what lies outside it
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

// Rows r and r + 8 of a matrix with rows `ld` apart (dst points at a
// column of its first row), columns 8c + 2t and 8c + 2t + 1 for every c,
// += a (or = a where `first`), dropping rows past `rows` and columns past
// w; a row's loads go out together, before its stores
template <int KT>
__device__ __forceinline__ void add_rows(float* __restrict__ dst,
                                         const float (&a)[KT][4], int r,
                                         int t, int rows, int w, int ld,
                                         bool first) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= rows) continue;
    float* p = dst + static_cast<size_t>(row) * ld + 2 * t;
    if (ld % 2 == 0) {  // every column pair is 8-aligned and whole
#pragma unroll
      for (int c0 = 0; c0 < KT; c0 += 8) {  // 8 loads in flight
        float2 o[8];
#pragma unroll
        for (int c = c0; c < c0 + 8 && c < KT; ++c)
          o[c - c0] = first || 8 * c + 2 * t >= w
                          ? make_float2(0.f, 0.f)
                          : *reinterpret_cast<const float2*>(p + 8 * c);
#pragma unroll
        for (int c = c0; c < c0 + 8 && c < KT; ++c)
          if (8 * c + 2 * t < w)
            *reinterpret_cast<float2*>(p + 8 * c) = make_float2(
                o[c - c0].x + a[c][2 * h], o[c - c0].y + a[c][2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < KT; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * c + 2 * t + e < w)
            p[8 * c + e] = (first ? 0.f : p[8 * c + e]) + a[c][2 * h + e];
    }
  }
}

// -- dq ----------------------------------------------------------------------
template <int HD>
constexpr size_t dq_smem() {  // Q, dO; K, V planes; the raw K, V tile
  return sizeof(float) *
         (2 * kDqM * HD + 4 * kDqN * (HD + kPad) + 2 * kDqN * HD);
}

template <int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Problem P, int n_q, bool vec) {
  constexpr int S = HD + kPad;
  constexpr int KT = HD / 8;    // k-steps of Q K^T, dO V^T; tiles of dq
  constexpr int JT = kDqN / 8;  // 8-key tiles of S and dP; k-steps of dS K
  extern __shared__ float4 smem_t3[];
  float* Qs = reinterpret_cast<float*>(smem_t3);  // swizzled
  float* dOs = Qs + kDqM * HD;                    // swizzled
  float* Kh = dOs + kDqM * HD;                    // planes, stride S
  float* Kl = Kh + kDqN * S;
  float* Vh = Kl + kDqN * S;
  float* Vl = Vh + kDqN * S;
  float* Kr = Vl + kDqN * S;                      // the raw tile, row-major
  float* Vr = Kr + kDqN * HD;

  // heavy first: under causal masking the last q tiles see the most keys
  const int tiles = (P.seq_q + kDqM - 1) / kDqM;
  const int rank = blockIdx.x / n_q, n = blockIdx.x % n_q;
  const int q0 = (P.causal ? tiles - 1 - rank : rank) * kDqM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;      // the warp's 16 rows of the tile
  const int r0 = q0 + wr + g;    // this thread's rows r0, r0 + 8
  const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  int lo, hi;
  kv_range(P, q0, kDqM, kDqN, lo, hi);
  // the raw K/V tile tt (nothing past hi)
  constexpr int NT = kDqThreads;
  auto stage_kv = [&](int tt) {
    if (tt >= hi) return;
    stage<kDqN, HD, false, NT>(Kr, kb, tt * kDqN, P.seq_k, P.hd, P.hd, vec);
    stage<kDqN, HD, false, NT>(Vr, vb, tt * kDqN, P.seq_k, P.hd, P.hd, vec);
  };
  stage<kDqM, HD, true, NT>(Qs, q + q_off, q0, P.seq_q, P.hd, P.hd, vec);
  stage<kDqM, HD, true, NT>(dOs, dout + q_off, q0, P.seq_q, P.hd, P.hd, vec);
  stage_kv(lo);
  cp_commit();

  float ls[2], dl[2];  // lse (in log2 units) and delta of rows r0, r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const size_t i = static_cast<size_t>(n) * P.seq_q + row;
    ls[h] = row < P.seq_q ? lse[i] * kLog2e : 0.f;
    dl[h] = row < P.seq_q ? delta[i] : 0.f;
  }
  const float sc = P.sm_scale * kLog2e;
  float acc[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int tt = lo; tt < hi; ++tt) {
    cp_wait<0>();
    // the raw tile tt has landed, and every warp is done with the K planes
    // of tile tt - 1 (tile tt's V planes were split halfway through it)
    __syncthreads();
    split_plane<kDqN, HD, NT>(Kr, Kh, Kl);
    if (tt == lo) split_plane<kDqN, HD, NT>(Vr, Vh, Vl);
    // the planes of tt are visible, and the raw tile is free again
    __syncthreads();
    stage_kv(tt + 1);  // lands while tile tt is multiplied
    cp_commit();

    // S = Q K^T and dP = dO V^T: the warp's 16 rows x kDqN keys
    float s[JT][4], dp[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      load_a<HD>(Qs, wr, 8 * kk, g, t, ah, al);
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        load_bt<S>(Kh, Kl, 8 * j, 8 * kk, g, t, bh, bl);
        mma3(s[j], ah, al, bh, bl);
      }
      load_a<HD>(dOs, wr, 8 * kk, g, t, ah, al);
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        load_bt<S>(Vh, Vl, 8 * j, 8 * kk, g, t, bh, bl);
        mma3(dp[j], ah, al, bh, bl);
      }
    }

    // P = exp(S sm_scale - lse), 0 where masked (after the exp, which
    // overflows where lse is ~-1e30); dS = P (dP - delta) sm_scale
    const int k0 = tt * kDqN;
    const bool full = all_kept(P, q0 + wr, 16, k0, kDqN);
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        float p = ex2(fmaf(s[j][e], sc, -ls[h]));
        if (!full && !keep(P, r0 + 8 * h, k0 + 8 * j + 2 * t + e % 2))
          p = 0.f;
        dp[j][e] = p * (dp[j][e] - dl[h]) * P.sm_scale;
      }

    // every warp is done with the V planes: tile tt + 1's are split now,
    // beside dS K, which reads only the K planes
    cp_wait<0>();
    __syncthreads();
    if (tt + 1 < hi) split_plane<kDqN, HD, NT>(Vr, Vh, Vl);

    // dq += dS K: dS from the accumulators, K read across its rows
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      uint32_t ah[4], al[4];
      acc_as_a(dp[j], ah, al);
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        uint32_t bh[2], bl[2];
        load_b_paired<S>(Kh, Kl, 8 * j, 8 * c, g, t, bh, bl);
        mma3(acc[c], ah, al, bh, bl);
      }
    }
  }
  cp_wait<0>();  // with no K/V tile, Q and dO may still be in flight

  // one block owns its rows: dq is written once, no atomics
  float* out = dq + q_off;
#pragma unroll
  for (int c = 0; c < KT; ++c) {
    store_pair(out, r0, 8 * c + 2 * t, acc[c][0], acc[c][1], P.seq_q, P.hd);
    store_pair(out, r0 + 8, 8 * c + 2 * t, acc[c][2], acc[c][3], P.seq_q,
               P.hd);
  }
}

// -- dk / dv -----------------------------------------------------------------
template <int HD>
constexpr size_t dkv_smem() {  // K, V; Q, dO planes; the raw Q, dO tile;
                               // raw and current lse, delta; P^T's hand-on
  return sizeof(float) *
         (2 * kDkvN * HD + 4 * kDkvQ * (HD + kPad) + 2 * kDkvQ * HD +
          4 * kDkvQ + kDkvThreads / 2 * 4 * (kDkvQ / 8));
}

template <int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_dkv_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Problem P, int n_kv, bool vec) {
  constexpr int S = HD + kPad;
  constexpr int KT = HD / 8;     // k-steps of K Q^T, V dO^T; dk, dv tiles
  constexpr int JT = kDkvQ / 8;  // 8-row tiles of S^T; k-steps of P^T dO
  constexpr int NT = kDkvThreads;
  extern __shared__ float4 smem_t3[];
  float* Ks = reinterpret_cast<float*>(smem_t3);  // swizzled
  float* Vs = Ks + kDkvN * HD;                    // swizzled
  float* Qh = Vs + kDkvN * HD;                    // planes, stride S
  float* Ql = Qh + kDkvQ * S;
  float* dOh = Ql + kDkvQ * S;
  float* dOl = dOh + kDkvQ * S;
  float* Qr = dOl + kDkvQ * S;                    // the raw tile, row-major
  float* dOr = Qr + kDkvQ * HD;
  float* Rr = dOr + kDkvQ * HD;                   // its lse, delta
  float* Rs = Rr + 2 * kDkvQ;                     // lse (log2 units), delta
  float4* Ps = reinterpret_cast<float4*>(Rs + 2 * kDkvQ);  // P^T, a pair

  // heavy first: under causal masking the first keys see the most rows
  const int rank = blockIdx.x / n_kv, nk = blockIdx.x % n_kv;
  const int k0 = rank * kDkvN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // a pair of warps shares 16 keys: the first computes S^T and P^T and
  // sums dV, the second dP^T and dS^T (from the first's P^T) and sums dK
  const int pair = warp / 2;
  const bool second = warp % 2;
  const int kw = pair * 16;        // the pair's 16 keys of the block
  const int kr = k0 + kw + g;      // this thread's keys kr, kr + 8
  const size_t kv_off = static_cast<size_t>(nk) * P.seq_k * P.hd;
  stage<kDkvN, HD, true, NT>(Ks, k + kv_off, k0, P.seq_k, P.hd, P.hd, vec);
  stage<kDkvN, HD, true, NT>(Vs, v + kv_off, k0, P.seq_k, P.hd, P.hd, vec);
  // the first warp: K, Q^T, dO; the second: V, dO^T, Q
  const float* As = second ? Vs : Ks;
  const float* Bh = second ? dOh : Qh;
  const float* Bl = second ? dOl : Ql;
  const float* Ch = second ? Qh : dOh;
  const float* Cl = second ? Ql : dOl;
  float* out = (second ? dk : dv) + kv_off;

  int lo, hi;
  q_range(P, k0, kDkvN, kDkvQ, lo, hi);
  const int nt = max(hi - lo, 0), iters = P.g * nt;
  // the raw step i (query head nk * g + i / nt, q tile lo + i % nt): Q,
  // dO, lse, delta (nothing past the last step)
  auto stage_q = [&](int i) {
    if (i >= iters) return;
    const int n = nk * P.g + i / nt;
    const int q0 = (lo + i % nt) * kDkvQ;
    const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
    const size_t r_off = static_cast<size_t>(n) * P.seq_q;
    stage<kDkvQ, HD, false, NT>(Qr, q + q_off, q0, P.seq_q, P.hd, P.hd, vec);
    stage<kDkvQ, HD, false, NT>(dOr, dout + q_off, q0, P.seq_q, P.hd, P.hd,
                                vec);
    stage_rows<kDkvQ, NT>(Rr, lse + r_off, delta + r_off, q0, P.seq_q);
  };
  stage_q(0);
  cp_commit();

  const float sc = P.sm_scale * kLog2e;
  float acc[KT][4];  // dV (first warp) or dK (second)
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // A long chain of mma.sync sums loses bits toward zero (the tensor core
  // truncates its f32 sums), so a warp sums at most kFlush steps in its
  // registers, then adds them to dv or dk in f32 and starts again from
  // zero.  The warp owns its keys' rows of its output: no other thread
  // writes them (no atomics), and the first period stores.
  for (int i0 = 0; i0 < max(iters, 1); i0 += kFlush) {
    for (int i = i0; i < min(i0 + kFlush, iters); ++i) {
      cp_wait<0>();
      // the raw step i has landed, and every warp is done with the planes
      // and the hand-on of step i - 1
      __syncthreads();
      split_plane<kDkvQ, HD, NT>(Qr, Qh, Ql);
      split_plane<kDkvQ, HD, NT>(dOr, dOh, dOl);
      if (threadIdx.x < 2 * kDkvQ)
        Rs[threadIdx.x] = threadIdx.x < kDkvQ ? Rr[threadIdx.x] * kLog2e
                                              : Rr[threadIdx.x];
      // the planes of step i are visible, and the raw step is free again
      __syncthreads();
      stage_q(i + 1);  // lands while step i is multiplied
      cp_commit();
      const int q0 = (lo + i % nt) * kDkvQ;

      // S^T = K Q^T (first warp) or dP^T = V dO^T (second): the pair's
      // 16 keys x kDkvQ rows
      float s[JT][4];
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        load_a<HD>(As, kw, 8 * kk, g, t, ah, al);
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          load_bt<S>(Bh, Bl, 8 * j, 8 * kk, g, t, bh, bl);
          mma3(s[j], ah, al, bh, bl);
        }
      }

      // P^T = exp(S^T sm_scale - lse), 0 where masked (rows are keys,
      // columns queries), handed on to the second warp, which forms
      // dS^T = P^T (dP^T - delta) sm_scale
      const int bar = 1 + pair;  // a named barrier of the pair's 64 threads
      if (!second) {
        const bool full = all_kept(P, q0, kDkvQ, k0 + kw, 16);
#pragma unroll
        for (int j = 0; j < JT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + e % 2;  // query row of the tile
            float p = ex2(fmaf(s[j][e], sc, -Rs[c]));
            if (!full && !keep(P, q0 + c, kr + 8 * (e / 2))) p = 0.f;
            s[j][e] = p;
          }
          Ps[(pair * JT + j) * 32 + lane] =
              make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
        }
        asm volatile("bar.arrive %0, 64;\n" ::"r"(bar) : "memory");
      } else {
        asm volatile("bar.sync %0, 64;\n" ::"r"(bar) : "memory");
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          const float4 p = Ps[(pair * JT + j) * 32 + lane];
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + e % 2;
            s[j][e] = pv[e] * (s[j][e] - Rs[kDkvQ + c]) * P.sm_scale;
          }
        }
      }

      // dV += P^T dO (first warp) or dK += dS^T Q (second): P^T or dS^T
      // from the accumulators, dO or Q read across their rows
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        uint32_t ah[4], al[4];
        acc_as_a(s[j], ah, al);
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          uint32_t bh[2], bl[2];
          load_b_paired<S>(Ch, Cl, 8 * j, 8 * c, g, t, bh, bl);
          mma3(acc[c], ah, al, bh, bl);
        }
      }
    }
    add_rows<KT>(out, acc, kr, t, P.seq_k, P.hd, P.hd, i0 == 0);
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  }
  cp_wait<0>();  // with no step, K and V may still be in flight
}

// -- 128 < hd <= HD (256 or 512): the output columns split over the warps --
// A slab of 16 rows (dq: query rows; dk/dv: keys) has one warp a group of
// kWideC output columns (two groups of dk and dv's: dV's, then dK's).
// Each warp computes its group's share of the products that sum over the
// head dim, over its own kWideC columns of it, and puts it in shared
// memory; after a barrier every warp of the slab adds the shares in group
// order, so each holds the same S and dP (S^T and dP^T) bit for bit.

// dq: 8 warps; query rows a block (64 at HD 256, 32 at 512) and keys a
// K/V tile (16, 8) such that Q and dO stay resident beside the K and V
// planes and the shares; the next tile waits in registers (4 float4 of K
// and of V a thread).
template <int HD>
struct WideDq {
  static constexpr int kGroups = HD / kWideC;  // warps a slab
  static constexpr int kThreads = 256;
  static constexpr int M = 16 * kThreads / 32 / kGroups;
  static constexpr int N = 4096 / HD;
  static constexpr int kFlush = kFlushK / (N / 8);  // tiles a flush
  // Q, dO; K, V planes; S and dP shares (2 x N / 8 float4 a lane a warp)
  static constexpr size_t kSmem =
      sizeof(float) * (2 * M * HD + 4 * N * (HD + kPad) + kThreads * N);
};

// dk/dv: a slab of 16 keys is 2 kGroups warps; 3 slabs (48 keys, 12
// warps) at HD 256, 1 (16 keys, 8 warps) at 512; Q/dO tiles of 16 (8)
// rows, raw by cp.async, then planes
template <int HD>
struct WideDkv {
  static constexpr int kGroups = HD / kWideC;
  static constexpr int kSlabWarps = 2 * kGroups;  // dV's groups, dK's
  static constexpr int kThreads = HD <= 256 ? 384 : 256;
  static constexpr int N = 16 * kThreads / 32 / kSlabWarps;
  static constexpr int Q = 4096 / HD;
  static constexpr int kFlush = kFlushK / (Q / 8);  // steps a flush
  // K, V; Q, dO planes; the raw Q, dO tile; raw and current lse, delta;
  // S^T or dP^T shares (Q / 8 float4 a lane a warp)
  static constexpr size_t kSmem =
      sizeof(float) * (2 * N * HD + 4 * Q * (HD + kPad) + 2 * Q * HD +
                       4 * Q + kThreads * Q / 2);
};

template <int HD>
__global__ void __launch_bounds__(WideDq<HD>::kThreads, 1)
    flash_dq_split_tf32x3(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, Problem P, int n_q,
                          bool vec) {
  using W = WideDq<HD>;
  constexpr int NT = W::kThreads, NG = W::kGroups, M = W::M, N = W::N;
  constexpr int S = HD + kPad;
  constexpr int KT = kWideC / 8;  // k-steps of a share; 8-column tiles of dq
  constexpr int JT = N / 8;       // 8-key tiles of S and dP; k-steps of dS K
  constexpr int F = N * HD / 4 / NT;  // float4 a thread of a K or V tile
  extern __shared__ float4 smem_t3[];
  float* Qs = reinterpret_cast<float*>(smem_t3);  // swizzled
  float* dOs = Qs + M * HD;                       // swizzled
  float* Kh = dOs + M * HD;                       // planes, stride S
  float* Kl = Kh + N * S;
  float* Vh = Kl + N * S;
  float* Vl = Vh + N * S;
  float4* X = reinterpret_cast<float4*>(Vl + N * S);  // [warp][2][JT][lane]

  // heavy first: under causal masking the last q tiles see the most keys
  const int tiles = (P.seq_q + M - 1) / M;
  const int rank = blockIdx.x / n_q, n = blockIdx.x % n_q;
  const int q0 = (P.causal ? tiles - 1 - rank : rank) * M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int sl = warp / NG, c0 = (warp % NG) * kWideC;  // slab, group
  const int wr = sl * 16;       // the slab's 16 rows of the tile
  const int r0 = q0 + wr + g;   // this thread's rows r0, r0 + 8
  const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  int lo, hi;
  kv_range(P, q0, M, N, lo, hi);
  const int nt = max(hi - lo, 0);
  stage<M, HD, true, NT>(Qs, q + q_off, q0, P.seq_q, P.hd, P.hd, vec);
  stage<M, HD, true, NT>(dOs, dout + q_off, q0, P.seq_q, P.hd, P.hd, vec);
  cp_commit();
  float4 kx[F], vx[F];  // the next K and V tile
  if (nt > 0) {
    fetch_tile<N, HD, NT>(kx, kb, lo * N, P.seq_k, P.hd, P.hd, vec);
    fetch_tile<N, HD, NT>(vx, vb, lo * N, P.seq_k, P.hd, P.hd, vec);
  }

  float ls[2], dl[2];  // lse (in log2 units) and delta of rows r0, r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const size_t i = static_cast<size_t>(n) * P.seq_q + row;
    ls[h] = row < P.seq_q ? lse[i] * kLog2e : 0.f;
    dl[h] = row < P.seq_q ? delta[i] : 0.f;
  }
  const float sc = P.sm_scale * kLog2e;
  float acc[KT][4];
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  cp_wait<0>();  // Q and dO, visible after the first barrier
  float* out = dq + q_off + c0;

  // a warp sums kFlush tiles, adds them to its rows and columns of dq,
  // which only it writes (no atomics; the first period stores)
  for (int i0 = 0; i0 < max(nt, 1); i0 += W::kFlush) {
    for (int i = i0; i < min(i0 + W::kFlush, nt); ++i) {
      const int tt = lo + i;
      // every warp is done with the K planes of tile tt - 1 (its V planes
      // were replaced halfway through it)
      __syncthreads();
      stash_tile<N, HD, NT>(kx, Kh, Kl);
      if (i == 0) stash_tile<N, HD, NT>(vx, Vh, Vl);
      __syncthreads();  // the planes of tile tt are visible
      if (i + 1 < nt) {  // tile tt + 1 comes in while tt is multiplied
        fetch_tile<N, HD, NT>(kx, kb, (tt + 1) * N, P.seq_k, P.hd, P.hd, vec);
        fetch_tile<N, HD, NT>(vx, vb, (tt + 1) * N, P.seq_k, P.hd, P.hd, vec);
      }

      // the group's share of S = Q K^T and dP = dO V^T: the slab's 16 rows
      // x N keys over the group's columns of the head
      float s[JT][4], dp[JT][4];
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        load_a<HD>(Qs, wr, c0 + 8 * kk, g, t, ah, al);
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          load_bt<S>(Kh, Kl, 8 * j, c0 + 8 * kk, g, t, bh, bl);
          mma3(s[j], ah, al, bh, bl);
        }
        load_a<HD>(dOs, wr, c0 + 8 * kk, g, t, ah, al);
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          load_bt<S>(Vh, Vl, 8 * j, c0 + 8 * kk, g, t, bh, bl);
          mma3(dp[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        X[((2 * warp) * JT + j) * 32 + lane] =
            make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
        X[((2 * warp + 1) * JT + j) * 32 + lane] =
            make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
      }
      // every share is in place, and every warp is done with the V planes:
      // tile tt + 1's are split now, beside dS K, which reads only K
      __syncthreads();
      if (i + 1 < nt) stash_tile<N, HD, NT>(vx, Vh, Vl);

      // S and dP: the slab's shares added in group order; P = exp(S
      // sm_scale - lse), 0 where masked (after the exp, which overflows
      // where lse is ~-1e30); dS = P (dP - delta) sm_scale
      const int k0 = tt * N;
      const bool full = all_kept(P, q0 + wr, 16, k0, N);
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const float4* xs = X + (2 * sl * NG * JT + j) * 32 + lane;
        float4 a = xs[0], b = xs[JT * 32];
#pragma unroll
        for (int w = 1; w < NG; ++w) {
          a = add4(a, xs[2 * w * JT * 32]);
          b = add4(b, xs[(2 * w + 1) * JT * 32]);
        }
        const float sv[4] = {a.x, a.y, a.z, a.w};
        const float dv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          float p = ex2(fmaf(sv[e], sc, -ls[h]));
          if (!full && !keep(P, r0 + 8 * h, k0 + 8 * j + 2 * t + e % 2))
            p = 0.f;
          dp[j][e] = p * (dv[e] - dl[h]) * P.sm_scale;
        }
      }

      // dq[slab, group] += dS K[:, group]: dS from the accumulators, K read
      // across its rows
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        uint32_t ah[4], al[4];
        acc_as_a(dp[j], ah, al);
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          uint32_t bh[2], bl[2];
          load_b_paired<S>(Kh, Kl, 8 * j, c0 + 8 * c, g, t, bh, bl);
          mma3(acc[c], ah, al, bh, bl);
        }
      }
    }
    add_rows<KT>(out, acc, r0, t, P.seq_q, P.hd - c0, P.hd, i0 == 0);
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(WideDkv<HD>::kThreads, 1)
    flash_dkv_split_tf32x3(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           Problem P, int n_kv, bool vec) {
  using W = WideDkv<HD>;
  constexpr int NT = W::kThreads, NG = W::kGroups, KN = W::N, Q = W::Q;
  constexpr int S = HD + kPad;
  constexpr int KT = kWideC / 8;  // k-steps of a share; tiles of its output
  constexpr int JT = Q / 8;       // 8-row tiles of S^T; k-steps of P^T dO
  extern __shared__ float4 smem_t3[];
  float* Ks = reinterpret_cast<float*>(smem_t3);  // swizzled
  float* Vs = Ks + KN * HD;                       // swizzled
  float* Qh = Vs + KN * HD;                       // planes, stride S
  float* Ql = Qh + Q * S;
  float* dOh = Ql + Q * S;
  float* dOl = dOh + Q * S;
  float* Qr = dOl + Q * S;                        // the raw tile, row-major
  float* dOr = Qr + Q * HD;
  float* Rr = dOr + Q * HD;                       // its lse, delta
  float* Rs = Rr + 2 * Q;                         // lse (log2 units), delta
  float4* X = reinterpret_cast<float4*>(Rs + 2 * Q);  // [warp][JT][lane]

  // heavy first: under causal masking the first keys see the most rows
  const int rank = blockIdx.x / n_kv, nk = blockIdx.x % n_kv;
  const int k0 = rank * KN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // a slab's warps: its groups of dV (each with its share of S^T), then
  // of dK (each with its share of dP^T)
  const int sl = warp / W::kSlabWarps, role = warp % W::kSlabWarps;
  const bool second = role >= NG;
  const int c0 = (role % NG) * kWideC;
  const int kw = sl * 16;          // the slab's 16 keys of the block
  const int kr = k0 + kw + g;      // this thread's keys kr, kr + 8
  const size_t kv_off = static_cast<size_t>(nk) * P.seq_k * P.hd;
  stage<KN, HD, true, NT>(Ks, k + kv_off, k0, P.seq_k, P.hd, P.hd, vec);
  stage<KN, HD, true, NT>(Vs, v + kv_off, k0, P.seq_k, P.hd, P.hd, vec);
  // dV's warps: K, Q^T, dO; dK's: V, dO^T, Q
  const float* As = second ? Vs : Ks;
  const float* Bh = second ? dOh : Qh;
  const float* Bl = second ? dOl : Ql;
  const float* Ch = second ? Qh : dOh;
  const float* Cl = second ? Ql : dOl;
  float* out = (second ? dk : dv) + kv_off + c0;

  int lo, hi;
  q_range(P, k0, KN, Q, lo, hi);
  const int nt = max(hi - lo, 0), iters = P.g * nt;
  // the raw step i (query head nk * g + i / nt, q tile lo + i % nt): Q,
  // dO, lse, delta (nothing past the last step)
  auto stage_q = [&](int i) {
    if (i >= iters) return;
    const int n = nk * P.g + i / nt;
    const int q0 = (lo + i % nt) * Q;
    const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
    const size_t r_off = static_cast<size_t>(n) * P.seq_q;
    stage<Q, HD, false, NT>(Qr, q + q_off, q0, P.seq_q, P.hd, P.hd, vec);
    stage<Q, HD, false, NT>(dOr, dout + q_off, q0, P.seq_q, P.hd, P.hd,
                            vec);
    stage_rows<Q, NT>(Rr, lse + r_off, delta + r_off, q0, P.seq_q);
  };
  stage_q(0);
  cp_commit();

  const float sc = P.sm_scale * kLog2e;
  float acc[KT][4];  // the group's dV (dV's warps) or dK (dK's)
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  // a warp sums kFlush steps, adds them to its keys' rows and its group's
  // columns of dv or dk, which only it writes (no atomics; the first
  // period stores)
  for (int i0 = 0; i0 < max(iters, 1); i0 += W::kFlush) {
    for (int i = i0; i < min(i0 + W::kFlush, iters); ++i) {
      cp_wait<0>();
      // the raw step i has landed, and every warp is done with the planes,
      // the rows and the shares of step i - 1
      __syncthreads();
      split_plane<Q, HD, NT>(Qr, Qh, Ql);
      split_plane<Q, HD, NT>(dOr, dOh, dOl);
      if (threadIdx.x < 2 * Q)
        Rs[threadIdx.x] = threadIdx.x < Q ? Rr[threadIdx.x] * kLog2e
                                          : Rr[threadIdx.x];
      // the planes of step i are visible, and the raw step is free again
      __syncthreads();
      stage_q(i + 1);  // lands while step i is multiplied
      cp_commit();
      const int q0 = (lo + i % nt) * Q;

      // the group's share of S^T = K Q^T (dV's warps) or dP^T = V dO^T
      // (dK's): the slab's 16 keys x Q rows over the group's columns
      float s[JT][4];
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        load_a<HD>(As, kw, c0 + 8 * kk, g, t, ah, al);
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          load_bt<S>(Bh, Bl, 8 * j, c0 + 8 * kk, g, t, bh, bl);
          mma3(s[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < JT; ++j)
        X[(warp * JT + j) * 32 + lane] =
            make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      // every share of the slab is in place: a named barrier of its warps
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + sl),
                   "r"(32 * W::kSlabWarps)
                   : "memory");

      // S^T (and dP^T) from the shares in group order; P^T = exp(S^T
      // sm_scale - lse), 0 where masked (rows are keys, columns queries);
      // dK's warps form dS^T = P^T (dP^T - delta) sm_scale
      const bool full = all_kept(P, q0, Q, k0 + kw, 16);
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const float4* xs = X + (sl * W::kSlabWarps * JT + j) * 32 + lane;
        float4 a = xs[0], b = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 1; w < NG; ++w) a = add4(a, xs[w * JT * 32]);
        if (second) {
          b = xs[NG * JT * 32];
#pragma unroll
          for (int w = 1; w < NG; ++w) b = add4(b, xs[(NG + w) * JT * 32]);
        }
        const float sv[4] = {a.x, a.y, a.z, a.w};
        const float dpv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + e % 2;  // query row of the tile
          float p = ex2(fmaf(sv[e], sc, -Rs[c]));
          if (!full && !keep(P, q0 + c, kr + 8 * (e / 2))) p = 0.f;
          s[j][e] = second ? p * (dpv[e] - Rs[Q + c]) * P.sm_scale : p;
        }
      }

      // dV[slab, group] += P^T dO[:, group] or dK[slab, group] +=
      // dS^T Q[:, group]: P^T or dS^T from the accumulators, dO or Q read
      // across their rows
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        uint32_t ah[4], al[4];
        acc_as_a(s[j], ah, al);
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          uint32_t bh[2], bl[2];
          load_b_paired<S>(Ch, Cl, 8 * j, c0 + 8 * c, g, t, bh, bl);
          mma3(acc[c], ah, al, bh, bl);
        }
      }
    }
    add_rows<KT>(out, acc, kr, t, P.seq_k, P.hd - c0, P.hd, i0 == 0);
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  }
  cp_wait<0>();  // with no step, K and V may still be in flight
}

// -- the forward -------------------------------------------------------------
// 8 warps; a slab of 16 query rows has one warp a group of kC = min(HD,
// kWideC) columns of o (so one warp a slab up to hd 128), query rows a
// block (128 up to HD 128, 64 at 256, 32 at 512) and keys a K/V tile (32,
// 16, 8) such that Q stays resident beside the K and V planes, the raw
// tile and the shares of S.
template <int HD>
struct Fwd {
  static constexpr int kC = HD < kWideC ? HD : kWideC;
  static constexpr int kGroups = HD / kC;  // warps a slab
  static constexpr int kThreads = 256;
  static constexpr int M = 16 * kThreads / 32 / kGroups;
  static constexpr int N = HD <= kWideC ? 32 : 4096 / HD;
  // Q; K, V planes; the raw K, V tile; S shares (N / 8 float4 a lane a
  // warp, above hd 128 only)
  static constexpr size_t kSmem =
      sizeof(float) * (M * HD + 4 * N * (HD + kPad) + 2 * N * HD +
                       (kGroups > 1 ? kThreads * N / 2 : 0));
};

template <int HD>
__global__ void __launch_bounds__(Fwd<HD>::kThreads, 1)
    flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Problem P, int n_q, bool vec) {
  using W = Fwd<HD>;
  constexpr int NT = W::kThreads, NG = W::kGroups, M = W::M, N = W::N;
  constexpr int S = HD + kPad;
  constexpr int KT = W::kC / 8;  // k-steps of a share of S; tiles of o
  constexpr int JT = N / 8;      // 8-key tiles of S; k-steps of P V
  extern __shared__ float4 smem_t3[];
  float* Qs = reinterpret_cast<float*>(smem_t3);  // swizzled
  float* Kh = Qs + M * HD;                        // planes, stride S
  float* Kl = Kh + N * S;
  float* Vh = Kl + N * S;
  float* Vl = Vh + N * S;
  float* Kr = Vl + N * S;                         // the raw tile, row-major
  float* Vr = Kr + N * HD;
  float4* X = reinterpret_cast<float4*>(Vr + N * HD);  // [warp][JT][lane]

  // heavy first: under causal masking the last q tiles see the most keys
  const int tiles = (P.seq_q + M - 1) / M;
  const int rank = blockIdx.x / n_q, n = blockIdx.x % n_q;
  const int q0 = (P.causal ? tiles - 1 - rank : rank) * M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int sl = warp / NG, c0 = (warp % NG) * W::kC;  // slab, group
  const int wr = sl * 16;       // the slab's 16 rows of the tile
  const int r0 = q0 + wr + g;   // this thread's rows r0, r0 + 8
  const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  int lo, hi;
  kv_range(P, q0, M, N, lo, hi);
  // the raw K/V tile tt (nothing past hi)
  auto stage_kv = [&](int tt) {
    if (tt >= hi) return;
    stage<N, HD, false, NT>(Kr, kb, tt * N, P.seq_k, P.hd, P.hd, vec);
    stage<N, HD, false, NT>(Vr, vb, tt * N, P.seq_k, P.hd, P.hd, vec);
  };
  stage<M, HD, true, NT>(Qs, q + q_off, q0, P.seq_q, P.hd, P.hd, vec);
  stage_kv(lo);
  cp_commit();

  float acc[KT][4];
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sc = P.sm_scale * kLog2e;

  for (int tt = lo; tt < hi; ++tt) {
    cp_wait<0>();
    // the raw tile tt has landed, and every warp is done with the planes
    // of tile tt - 1
    __syncthreads();
    split_plane<N, HD, NT>(Kr, Kh, Kl);
    split_plane<N, HD, NT>(Vr, Vh, Vl);
    // the planes of tt are visible, and the raw tile is free again
    __syncthreads();
    stage_kv(tt + 1);  // lands while tile tt is multiplied
    cp_commit();

    // S = Q K^T (above hd 128 the group's share of it, over its columns):
    // the slab's 16 rows x N keys
    float s[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      load_a<HD>(Qs, wr, c0 + 8 * kk, g, t, ah, al);
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        load_bt<S>(Kh, Kl, 8 * j, c0 + 8 * kk, g, t, bh, bl);
        mma3(s[j], ah, al, bh, bl);
      }
    }
    if constexpr (NG > 1) {
      // the shares meet: every warp of the slab adds them in group order,
      // so each holds the same S, m and l bit for bit
#pragma unroll
      for (int j = 0; j < JT; ++j)
        X[(warp * JT + j) * 32 + lane] =
            make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + sl), "r"(32 * NG)
                   : "memory");
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const float4* xs = X + (sl * NG * JT + j) * 32 + lane;
        float4 a = xs[0];
#pragma unroll
        for (int w = 1; w < NG; ++w) a = add4(a, xs[w * JT * 32]);
        s[j][0] = a.x;
        s[j][1] = a.y;
        s[j][2] = a.z;
        s[j][3] = a.w;
      }
    }

    // the online softmax in log2 units: masked scores -1e30 and their p 0
    const int k0 = tt * N;
    const bool full = all_kept(P, q0 + wr, 16, k0, N);
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = full || keep(P, r0 + 8 * (e / 2), k0 + 8 * j + 2 * t + e % 2)
                      ? s[j][e] * sc
                      : kNegInf;
    float mx[2] = {m[0], m[1]}, alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a row lies on the 4 threads of a quad
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = ex2(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = full || x > kNegInf * 0.5f ? ex2(x - m[e / 2]) : 0.f;
        s[j][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];

    // o = o alpha + P V[:, group]: P from the accumulators, V read across
    // its rows.  Each 8-column tile of the tile's P V is summed from zero
    // (JT k-steps) and added to o in f32, as the TPU kernel's acc * alpha
    // + p @ v: no chain of mma.sync longer than a tile's.
    uint32_t ph[JT][4], pl[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j) acc_as_a(s[j], ph[j], pl[j]);
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        uint32_t bh[2], bl[2];
        load_b_paired<S>(Vh, Vl, 8 * j, c0 + 8 * c, g, t, bh, bl);
        mma3(pv, ph[j], pl[j], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[c][e] = fmaf(acc[c][e], alpha[e / 2], pv[e]);
    }
  }
  cp_wait<0>();  // with no K/V tile, Q may still be in flight

  // l over the quad's keys; a row with no kept key (m still -1e30) writes
  // o = 0 and lse ~ -1e30
  float* out = o + q_off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float ls = fmaxf(l[h], 1e-30f);
    const float inv = 1.f / ls;
    const int row = r0 + 8 * h;
    if (c0 == 0 && t == 0 && row < P.seq_q)
      lse[static_cast<size_t>(n) * P.seq_q + row] =
          (m[h] <= kNegInf * 0.5f ? kNegInf : m[h] * kLn2) + logf(ls);
#pragma unroll
    for (int c = 0; c < KT; ++c)
      store_pair(out, row, c0 + 8 * c + 2 * t, acc[c][2 * h] * inv,
                 acc[c][2 * h + 1] * inv, P.seq_q, P.hd);
  }
}

// -- launchers ---------------------------------------------------------------
bool can_vec(int hd, std::initializer_list<const void*> ptrs) {
  if (hd % 4 != 0) return false;
  for (const void* p : ptrs)
    if (!vtpu::aligned16(p)) return false;
  return true;
}

template <int HD>
int dq_tf32x3(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int n_q,
              const Problem& P, bool vec, cudaStream_t st) {
  auto kernel = flash_dq_tf32x3<HD>;
  const size_t smem = dq_smem<HD>();
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (P.seq_q + kDqM - 1) / kDqM;
  kernel<<<tiles * n_q, kDqThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), P, n_q, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dkv_tf32x3(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int n_kv, const Problem& P, bool vec, cudaStream_t st) {
  auto kernel = flash_dkv_tf32x3<HD>;
  const size_t smem = dkv_smem<HD>();
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (P.seq_k + kDkvN - 1) / kDkvN;
  kernel<<<tiles * n_kv, kDkvThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), P, n_kv, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dq_split_tf32x3(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int n_q, const Problem& P, bool vec,
                    cudaStream_t st) {
  using W = WideDq<HD>;
  auto kernel = flash_dq_split_tf32x3<HD>;
  cudaError_t e = vtpu::allow_smem(kernel, W::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (P.seq_q + W::M - 1) / W::M;
  kernel<<<tiles * n_q, W::kThreads, W::kSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), P, n_q, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dkv_split_tf32x3(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int n_kv, const Problem& P,
                     bool vec, cudaStream_t st) {
  using W = WideDkv<HD>;
  auto kernel = flash_dkv_split_tf32x3<HD>;
  cudaError_t e = vtpu::allow_smem(kernel, W::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (P.seq_k + W::N - 1) / W::N;
  kernel<<<tiles * n_kv, W::kThreads, W::kSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), P, n_kv, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int fwd_tf32x3(const void* q, const void* k, const void* v, void* o,
               void* lse, int n_q, const Problem& P, bool vec,
               cudaStream_t st) {
  using W = Fwd<HD>;
  auto kernel = flash_fwd_tf32x3<HD>;
  cudaError_t e = vtpu::allow_smem(kernel, W::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (P.seq_q + W::M - 1) / W::M;
  kernel<<<tiles * n_q, W::kThreads, W::kSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), P, n_q, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vtpu_flash_fwd_f32(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int n_q,
                                  int g, int seq_q, int seq_k, int hd,
                                  int causal, int shift, int window,
                                  float sm_scale, void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = can_vec(hd, {q, k, v});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 64 ? fwd_tf32x3<64>(q, k, v, o, lse, n_q, P, vec, st)
                  : fwd_tf32x3<128>(q, k, v, o, lse, n_q, P, vec, st);
}

// 128 < hd <= 512: the <256> instance up to hd 256, the <512> one above
extern "C" int vtpu_flash_fwd_wide_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int n_q, int g, int seq_q, int seq_k,
                                       int hd, int causal, int shift,
                                       int window, float sm_scale,
                                       void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale, vtpu::flash::kMaxWideHd))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = can_vec(hd, {q, k, v});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 256 ? fwd_tf32x3<256>(q, k, v, o, lse, n_q, P, vec, st)
                   : fwd_tf32x3<512>(q, k, v, o, lse, n_q, P, vec, st);
}

extern "C" int vtpu_flash_bwd_dq_f32(const void* q, const void* k,
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
  const bool vec = can_vec(hd, {q, k, v, dout});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 64
             ? dq_tf32x3<64>(q, k, v, dout, lse, delta, dq, n_q, P, vec, st)
             : dq_tf32x3<128>(q, k, v, dout, lse, delta, dq, n_q, P, vec, st);
}

extern "C" int vtpu_flash_bwd_dkv_f32(const void* q, const void* k,
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
  const bool vec = can_vec(hd, {q, k, v, dout});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_kv = n_q / g;
  return hd <= 64 ? dkv_tf32x3<64>(q, k, v, dout, lse, delta, dk, dv, n_kv,
                                   P, vec, st)
                  : dkv_tf32x3<128>(q, k, v, dout, lse, delta, dk, dv, n_kv,
                                    P, vec, st);
}

// 128 < hd <= 512: the <256> instances up to hd 256, the <512> ones above
extern "C" int vtpu_flash_bwd_dq_wide_f32(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dq, int n_q, int g,
                                          int seq_q, int seq_k, int hd,
                                          int causal, int shift, int window,
                                          float sm_scale, void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale, vtpu::flash::kMaxWideHd))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = can_vec(hd, {q, k, v, dout});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 256 ? dq_split_tf32x3<256>(q, k, v, dout, lse, delta, dq,
                                          n_q, P, vec, st)
                   : dq_split_tf32x3<512>(q, k, v, dout, lse, delta, dq,
                                          n_q, P, vec, st);
}

extern "C" int vtpu_flash_bwd_dkv_wide_f32(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse,
                                           const void* delta, void* dk,
                                           void* dv, int n_q, int g,
                                           int seq_q, int seq_k, int hd,
                                           int causal, int shift, int window,
                                           float sm_scale, void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale, vtpu::flash::kMaxWideHd))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = can_vec(hd, {q, k, v, dout});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_kv = n_q / g;
  return hd <= 256 ? dkv_split_tf32x3<256>(q, k, v, dout, lse, delta, dk,
                                           dv, n_kv, P, vec, st)
                   : dkv_split_tf32x3<512>(q, k, v, dout, lse, delta, dk,
                                           dv, n_kv, P, vec, st);
}
