// Paged single-token decode attention through a block table, for Hopper
// (sm_90a), over native (f32, bf16) or int8 K/V pools.
//
// Replaces the Pallas TPU kernels vtpu/ops/paged_attention.py::_kernel
// (native pools) and ::_kernel_q8 (int8 pools with per-token f32
// scales), both reached from paged_attention_decode.  Layouts are the
// reference's: q [b, H, hd]; pools [P, n_kv, bs, hd]; scales
// [P, n_kv, bs, 1] f32; block_tables [b, nb_max] int32; lengths [b] int32,
// the current query position of each row (key slot t*bs + j is valid iff
// it is <= lengths[i]); out [b, H, hd] in q's dtype.
//
// What bounds it on an H100: bytes.  Each row must read its valid K/V
// (2 * (lengths[i] + 1) * n_kv * hd * element size, plus the scales for
// int8); the flops are ~4 * H * hd per key, far below the card's rate,
// so the design keeps as many bytes in flight as the SM can hold and
// spends few instructions on each key:
//
//  1. paged_partial: the work is split along the sequence as well
//     (split-K, as in flash-decoding) so that a decode batch fills the
//     card.  A split covers kSplitTokens consecutive key slots; a work
//     item is one (row, split, kv head) that holds a valid key.  The grid
//     is persistent, as many blocks of 4 warps as the card holds at once,
//     and each block walks the items from its index in steps of the grid,
//     so no block is spent on the splits past a row's end, which would
//     hold an SM's shared memory only to exit.  For an item the block
//     reads the split's physical block ids from the table once into
//     shared memory (Hopper has no scalar prefetch).  K and V tiles of
//     kTileTokens keys
//     (whole logical blocks; each (block, kv head) is one contiguous run
//     of bs * hd elements) are copied into shared memory in the pool's
//     own type by 16-byte cp.async, int8 scales by 4-byte cp.async beside
//     them.  The split's tiles (two on the serving path) go through a
//     ring of two stages, each tile its own cp.async group, so the next
//     tile is in flight while one is scored and the only block barrier a
//     tile is the one that publishes it.  Where two stages do not fit in
//     shared memory (f32 at hd 256) the tiles take turns in one stage.
//     Where hd is no whole number of 16-byte vectors or a pool is not
//     16-byte aligned, the stages are filled by plain loads.
//  2. Warps that run alone.  Each warp takes groups of 32 / G keys of
//     the tile (G: the g = H / n_kv query heads of the kv head, padded to
//     a power of two from 4 to 32, or a head group of them; 2 at hd > 256)
//     and keeps its own f32 online softmax (m, l) and accumulator
//     in registers.  A lane owns D = hd / 32 dims of q (pre-scaled by
//     hd^-0.5 * log2 e, so p = exp2(s - m)) and of the accumulator for
//     all G heads, and reads each K and V element of its keys from shared
//     memory once.  A group's G x (32 / G) partial dot products are
//     summed across the warp by a shuffle reduce-scatter (31 shuffles
//     leave lane l with the score of (head l / (32 / G), key l % (32 /
//     G))), so the softmax of a group costs one exp2 a lane; the
//     probabilities reach all lanes through a per-warp slot in shared
//     memory.  The warps' (m, l, acc) merge once, at the end of the split,
//     through shared memory; the split's partial goes to a scratch buffer.
//  3. int8 pools are never dequantized into a tile: K and V stay int8 in
//     shared memory (four bytes become four floats with one byte_perm and
//     one add each), the key scale multiplies the score,
//     s = (q . k_int8) * k_scale * hd^-0.5, and the value scale the
//     probability, acc += (p * v_scale) * v_int8.  This differs from the
//     reference's dequantize-then-dot only by f32 rounding.
//  4. paged_combine: one block per (kv head, row) reads each split's (m, l)
//     for its g heads once, computes each split's weight exp2(m_s - max m)
//     once into shared memory, and makes one coalesced pass over the
//     splits' acc; a row with one split skips the rescale.
//
// Early exit: the TPU kernel walks all nb_max logical blocks; this one
// stops after block lengths[i] / bs, the last that holds a valid key.
// The result is the same: in a block whose keys are all masked the TPU
// kernel's update is exp(-1e30 - m) == 0 for every p and alpha == 1, so
// m, l and acc do not change.  Masked keys inside the last tile are
// skipped the same way (p = 0 exactly).  Lengths must be >= 0, so the
// row's first split always holds a valid key; later splits start at a
// valid key by construction.  The logical block walk never passes
// nb_max - 1, so a row whose position overshoots the table reads every
// block it owns, as the reference's clamped gather does.
//
// The split (128 keys), tile (64 keys) and block (4 warps) were chosen on
// an H100 from 128 / 256 / 512, 32 / 64 and 4 / 8 by the kernel's times at
// the serving path's lengths (PERF.md, PR 5).
//
// Supported: every hd <= 512 and every g.  A lane holds 2 * G * D floats
// of q and acc (D = ceil(hd / 32)); the instances keep G * D <= 32, since
// ptxas spills at G * D = 64.  At D 16 (hd > 256) the unrolled key loops
// let ptxas hoist enough shared-memory loads to spill even at G 1, so
// there a compiler fence closes each key's iteration and P . V reads each
// p from its slot (a broadcast) instead of holding the group's 32 in
// registers (201-222 registers at G 2).  Where g does not fit one instance's
// G, the g query heads of a kv head are cut into head groups of G, and
// each head group is a work item of its own (it reads the split's K and V
// again, from L2 when its neighbours in the walk have just read them).
// Where a split's tile of K and V does not fit in shared memory (f32 at hd
// 512, or large blocks), the tile shrinks: fewer whole blocks, then a part
// of one block.

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileTokens = 64;    // keys a tile (whole blocks)
constexpr int kSplitTokens = 128;  // keys a split (one or two tiles)
constexpr int kCombineThreads = 256;
constexpr int kMaxHeadDim = 512;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Geometry {
  int g, hd, bs, nb_max, n_kv, n_heads;
  int tile_blocks;   // logical blocks per tile
  int sub;           // tiles per block (> 1 only where tile_blocks == 1)
  int split_blocks;  // logical blocks per split
  int n_splits;      // splits of a full row
  int hgroups;       // head groups per kv head (work items per split)
};

inline Geometry geometry(int n_heads, int n_kv, int hd, int bs, int nb_max) {
  Geometry G;
  G.g = n_heads / n_kv;
  G.hd = hd;
  G.bs = bs;
  G.nb_max = nb_max;
  G.n_kv = n_kv;
  G.n_heads = n_heads;
  G.tile_blocks = bs >= kTileTokens ? 1 : kTileTokens / bs;
  const int tiles = kSplitTokens / (G.tile_blocks * bs);
  G.split_blocks = (tiles < 1 ? 1 : tiles > 2 ? 2 : tiles) * G.tile_blocks;
  G.n_splits = (nb_max + G.split_blocks - 1) / G.split_blocks;
  G.sub = 1;
  G.hgroups = 1;
  return G;
}

// Byte offsets of one stage and of the block's shared memory:
// [stages (or, after the loop, the warps' partials)][block ids][p slots]
// [rows' lengths and first splits]
struct Layout {
  int kv;      // one K or V tile, [tk, hd] in the pool's type
  int sc;      // one scale tile, [tk] f32 (int8 pools), else 0
  int stage;   // K, V, then the K and V scales
  int stages;  // tiles in flight: the split's tiles (1 or 2) if they fit
  int region;  // max(stages, the warps' partials)
  int ids;     // split_blocks block ids
  int rows;    // offset of the rows' lengths and first splits
  int total;
};

inline int round16(int n) { return (n + 15) & ~15; }

inline int tile_keys(const Geometry& G) {
  return G.sub > 1 ? G.bs / G.sub : G.tile_blocks * G.bs;
}

inline int split_tiles(const Geometry& G) {
  return G.sub > 1 ? G.sub * G.split_blocks
                   : (G.split_blocks + G.tile_blocks - 1) / G.tile_blocks;
}

// A smaller tile: fewer whole blocks, then the next divisor of bs keys of
// one block.  False when a tile is one key.
inline bool shrink_tile(Geometry& G) {
  if (G.tile_blocks > 1) {
    G.tile_blocks = (G.tile_blocks + 1) / 2;
    return true;
  }
  int s = G.sub + 1;
  while (s <= G.bs && G.bs % s != 0) ++s;
  if (s > G.bs) return false;
  G.sub = s;
  return true;
}

// The shared-memory layout of the largest tile that fits, with as many
// stages (the split's tiles, at most two) as fit; shrinks G's tile where
// even one stage does not fit.  total > kMaxSmem when nothing fits.
inline Layout layout(Geometry& G, int b, int elt, bool q8, int heads,
                     int d) {
  Layout L;
  const int partials = 4 * kWarps * heads * (32 * d + 2);
  L.ids = round16(4 * G.split_blocks);
  // 2 b + 1 ints, sized for b rounded up to 64 rows so that the layout,
  // and the occupancy cached for it, changes only every 64 rows
  const int rows_bytes = 4 * (2 * ((b + 63) / 64 * 64) + 1);
  for (;;) {
    const int tk = tile_keys(G);
    L.kv = round16(tk * G.hd * elt);
    L.sc = q8 ? round16(tk * 4) : 0;
    L.stage = 2 * L.kv + 2 * L.sc;
    const int tiles = split_tiles(G);
    for (L.stages = tiles < 2 ? tiles : 2;; --L.stages) {
      const int ring = L.stage * L.stages;
      L.region = round16(ring > partials ? ring : partials);
      L.rows = L.region + L.ids + 4 * kWarps * 64;
      L.total = L.rows + rows_bytes;
      if (L.stages == 1 || L.total <= static_cast<int>(vtpu::kMaxSmem)) break;
    }
    if (L.total <= static_cast<int>(vtpu::kMaxSmem) || !shrink_tile(G))
      return L;
  }
}

__device__ __forceinline__ int valid_blocks(int len, const Geometry& G) {
  if (len < 0) return 0;
  const int n = len / G.bs + 1;
  return n < G.nb_max ? n : G.nb_max;
}

// -- staging -----------------------------------------------------------------
// A tile: logical blocks [lb0, lb0 + nb) of the split, keys [off, off +
// kpb) of each (kpb == bs but where a tile is part of one block)
struct Tile {
  int lb0, nb, off, kpb;
};

__device__ __forceinline__ Tile tile_of(const Geometry& G, int t, int nsb) {
  if (G.sub == 1) {
    const int lb0 = t * G.tile_blocks;
    return {lb0, min(G.tile_blocks, nsb - lb0), 0, G.bs};
  }
  const int tk = G.bs / G.sub;
  return {t / G.sub, 1, (t % G.sub) * tk, tk};
}

// The tile's blocks ids[0 .. nb) of kv head kvh of one pool into dst as
// [nb * kpb, hd] in the pool's type: 16-byte cp.async copies (vec), else
// plain loads.
template <typename ELT>
__device__ __forceinline__ void stage_pool(ELT* dst,
                                           const ELT* __restrict__ pool,
                                           const int* ids, const Tile& tl,
                                           int kvh, const Geometry& G,
                                           bool vec) {
  const int per_block = tl.kpb * G.hd;
  for (int blk = 0; blk < tl.nb; ++blk) {
    const ELT* src =
        pool +
        ((static_cast<size_t>(ids[blk]) * G.n_kv + kvh) * G.bs + tl.off) *
            G.hd;
    ELT* d = dst + blk * per_block;
    if (vec) {
      constexpr int EPV = 16 / sizeof(ELT);
      for (int c = threadIdx.x * EPV; c < per_block; c += kThreads * EPV)
        vtpu::cp_async16(vtpu::smem_u32(d + c), src + c, true);
    } else {
      for (int c = threadIdx.x; c < per_block; c += kThreads) d[c] = src[c];
    }
  }
}

// The per-token scales of the same keys, [nb * kpb] f32
__device__ __forceinline__ void stage_scales(float* dst,
                                             const float* __restrict__ sc,
                                             const int* ids, const Tile& tl,
                                             int kvh, const Geometry& G) {
  for (int i = threadIdx.x; i < tl.nb * tl.kpb; i += kThreads) {
    const int blk = i / tl.kpb, t = i - blk * tl.kpb;
    const size_t src =
        (static_cast<size_t>(ids[blk]) * G.n_kv + kvh) * G.bs + tl.off;
    vtpu::cp_async4(vtpu::smem_u32(dst + i), sc + src + t, true);
  }
}

// -- one lane's dims of a key row -------------------------------------------
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&w)[W], const void* p) {
  if constexpr (W == 1) {
    w[0] = *static_cast<const uint32_t*>(p);
  } else if constexpr (W == 2) {
    const uint2 u = *static_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
    static_assert(W % 4 == 0, "whole 16-byte vectors");
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 u = static_cast<const uint4*>(p)[i];
      w[4 * i] = u.x, w[4 * i + 1] = u.y, w[4 * i + 2] = u.z,
      w[4 * i + 3] = u.w;
    }
  }
}

// f[d] = row[d0 + d] as f32 for d < D; zero past hd or when !ok.  Where
// hd == 32 * D the lane's D elements are one aligned vector: bf16 pairs
// widen by a shift and a mask, int8 quads by a byte_perm into the
// mantissa of 2^23 and one subtraction (exact for -128..127).
template <typename ELT, int D>
__device__ __forceinline__ void load_dims(float (&f)[D],
                                          const ELT* __restrict__ row,
                                          int d0, int hd, bool ok) {
  constexpr int B = D * static_cast<int>(sizeof(ELT));
  if constexpr (B >= 4) {
    if (ok && hd == 32 * D) {
      uint32_t w[B / 4];
      load_words<B / 4>(w, row + d0);
      if constexpr (std::is_same_v<ELT, float>) {
#pragma unroll
        for (int d = 0; d < D; ++d) f[d] = __uint_as_float(w[d]);
      } else if constexpr (std::is_same_v<ELT, __nv_bfloat16>) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          f[2 * i] = __uint_as_float(w[i] << 16);
          f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      } else {
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
          const uint32_t u = w[i] ^ 0x80808080u;  // b + 128 in each byte
#pragma unroll
          for (int j = 0; j < 4; ++j)
            f[4 * i + j] =
                __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) -
                8388736.f;  // 2^23 + 128
        }
      }
      return;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d)
    f[d] = ok && d0 + d < hd ? vtpu::to_f32(row[d0 + d]) : 0.f;
}

// Reduce-scatter across the warp: on entry each lane holds 32 partial
// sums v[0..32); on return v[0] of lane l is the warp's sum of slot l.
template <int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
  const bool hi = lane & N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = hi ? v[i] : v[i + N];
    const float keep = hi ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
  if constexpr (N > 1) reduce_scatter<N / 2>(v, lane);
}

// max / sum over the KG lanes of a lane's segment (aligned, KG a power of 2)
template <int KG>
__device__ __forceinline__ float seg_max(float x) {
#pragma unroll
  for (int o = KG / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int KG>
__device__ __forceinline__ float seg_sum(float x) {
#pragma unroll
  for (int o = KG / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// -- the split's partial -----------------------------------------------------
// G: query heads an item, the head group hg's heads [hg * G, hg * G + gs)
// of the kv head (padded: heads past gs hold q = 0 and are never written);
// D: dims a lane (hd <= 32 * D).
template <typename T, typename ELT, bool Q8, int G, int D>
__device__ __forceinline__ void split_partial(
    unsigned char* smem, const T* __restrict__ q, const ELT* __restrict__ kp,
    const ELT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tables,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    const Geometry& Gm, const Layout& L, float sm_scale, bool vec, int row,
    int kvh, int hg, int split, int len) {
  constexpr int KG = 32 / G;  // keys of a group: G * KG = 32 score slots
  constexpr bool kWide = D >= 16;  // one key's loads in flight (see above)
  const int lb_begin = split * Gm.split_blocks;
  const int nsb = min(Gm.split_blocks, valid_blocks(len, Gm) - lb_begin);
  int ntiles = (nsb + Gm.tile_blocks - 1) / Gm.tile_blocks;
  if (Gm.sub > 1) {  // tiles of part of a block: those holding a valid key
    const int tk = Gm.bs / Gm.sub;
    const int keys = min(nsb * Gm.bs, len - lb_begin * Gm.bs + 1);
    ntiles = (keys + tk - 1) / tk;
  }
  const int g = Gm.g, hd = Gm.hd;
  const int h0 = hg * G, gs = min(G, g - h0);  // the group's heads
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * D;

  int* ids = reinterpret_cast<int*>(smem + L.region);
  float* slots = reinterpret_cast<float*>(smem + L.region + L.ids) +
                 warp * 64;  // [32] p (times v_scale), [32] alpha
  const int* trow = tables + static_cast<size_t>(row) * Gm.nb_max + lb_begin;
  __syncthreads();  // the block's previous split is done with its memory
  for (int i = threadIdx.x; i < nsb; i += kThreads) ids[i] = trow[i];

  float qr[G][D], acc[G][D];
  const T* qrow =
      q + (static_cast<size_t>(row) * Gm.n_heads + kvh * g + h0) * hd;
  const float qscale = sm_scale * kLog2e;
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[h][d] = h < gs && d0 + d < hd
                     ? vtpu::to_f32(qrow[h * hd + d0 + d]) * qscale
                     : 0.f;
      acc[h][d] = 0.f;
    }
  float m = kNegInf, l = 0.f;  // of head lane / KG, in log2 units
  __syncthreads();             // ids

  auto issue = [&](int t) {  // tile t into its stage, as one cp.async group
    unsigned char* st = smem + (t % L.stages) * L.stage;
    const Tile tl = tile_of(Gm, t, nsb);
    stage_pool(reinterpret_cast<ELT*>(st), kp, ids + tl.lb0, tl, kvh, Gm,
               vec);
    stage_pool(reinterpret_cast<ELT*>(st + L.kv), vp, ids + tl.lb0, tl, kvh,
               Gm, vec);
    if constexpr (Q8) {
      stage_scales(reinterpret_cast<float*>(st + 2 * L.kv), ks, ids + tl.lb0,
                   tl, kvh, Gm);
      stage_scales(reinterpret_cast<float*>(st + 2 * L.kv + L.sc), vs,
                   ids + tl.lb0, tl, kvh, Gm);
    }
    vtpu::cp_commit();
  };
  // With two stages the next tile is in flight while this one is scored
  // (a split of two tiles has both in flight from the start); with one,
  // the tiles take turns.
  const bool ring = L.stages == 2;
  issue(0);
  if (ring && ntiles > 1) issue(1);

  for (int t = 0; t < ntiles; ++t) {
    if (t > 0 && !ring) {
      __syncthreads();  // every warp is done with the one stage
      issue(t);
    }
    if (ring && t + 1 < ntiles) vtpu::cp_wait<1>();  // this thread's tile t
    else vtpu::cp_wait<0>();
    __syncthreads();  // everyone's copies of tile t have landed

    const unsigned char* st = smem + (t % L.stages) * L.stage;
    const ELT* k_s = reinterpret_cast<const ELT*>(st);
    const ELT* v_s = reinterpret_cast<const ELT*>(st + L.kv);
    const float* ks_s = reinterpret_cast<const float*>(st + 2 * L.kv);
    const float* vs_s = reinterpret_cast<const float*>(st + 2 * L.kv + L.sc);
    const Tile tl = tile_of(Gm, t, nsb);
    const int key0 = (lb_begin + tl.lb0) * Gm.bs + tl.off;
    // keys [0, last) of the tile are valid
    const int last = min(tl.nb * tl.kpb, len - key0 + 1);
    for (int j0 = warp * KG; j0 < last; j0 += kWarps * KG) {
      float v[32];
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        float kf[D];
        load_dims<ELT, D>(kf, k_s + (j0 + kk) * hd, d0, hd, j0 + kk < last);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) s = fmaf(qr[h][d], kf[d], s);
          v[h * KG + kk] = s;
        }
        if constexpr (kWide) asm volatile("" ::: "memory");
      }
      reduce_scatter<16>(v, lane);
      const int j = j0 + lane % KG;  // this lane's key; head lane / KG
      const bool ok = j < last;
      float s = v[0];
      if constexpr (Q8) s *= ok ? ks_s[j] : 0.f;
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m, seg_max<KG>(s));
      const float p = ok ? exp2f(s - m_new) : 0.f;
      const float alpha = exp2f(m - m_new);
      l = l * alpha + seg_sum<KG>(p);
      m = m_new;
      __syncwarp();  // the previous group's slots are read
      slots[lane] = Q8 && ok ? p * vs_s[j] : p;
      slots[32 + lane] = alpha;
      __syncwarp();
      if constexpr (!kWide) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // every slot's p, as broadcast reads
          const float4 x = reinterpret_cast<const float4*>(slots)[i];
          v[4 * i] = x.x, v[4 * i + 1] = x.y, v[4 * i + 2] = x.z,
          v[4 * i + 3] = x.w;
        }
      }
      if (__any_sync(0xffffffffu, alpha != 1.f)) {  // a head's max rose
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float a = slots[32 + h * KG];
#pragma unroll
          for (int d = 0; d < D; ++d) acc[h][d] *= a;
        }
      }
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {  // p = 0 and v = 0 past `last`
        float vf[D];
        load_dims<ELT, D>(vf, v_s + (j0 + kk) * hd, d0, hd, j0 + kk < last);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float p = kWide ? slots[h * KG + kk] : v[h * KG + kk];
#pragma unroll
          for (int d = 0; d < D; ++d) acc[h][d] = fmaf(p, vf[d], acc[h][d]);
        }
        if constexpr (kWide) asm volatile("" ::: "memory");
      }
    }
    if (ring && t + 2 < ntiles) {
      __syncthreads();  // every warp is done with tile t's stage
      issue(t + 2);
    }
  }

  // merge the warps' (m, l, acc) through the stages' memory
  __syncthreads();  // every warp is done with the stages
  float* red_acc = reinterpret_cast<float*>(smem);  // [kWarps, G, 32 * D]
  float* red_m = red_acc + kWarps * G * 32 * D;     // [kWarps, G]
  float* red_l = red_m + kWarps * G;                // [kWarps, G]
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int d = 0; d < D; ++d)
      red_acc[(warp * G + h) * 32 * D + d0 + d] = acc[h][d];
  if (lane % KG == 0) {
    red_m[warp * G + lane / KG] = m;
    red_l[warp * G + lane / KG] = l;
  }
  __syncthreads();
  const size_t part =
      (static_cast<size_t>(row) * Gm.n_kv + kvh) * Gm.n_splits + split;
  if (threadIdx.x < gs) {  // weights of the warps, in place of their m
    const int h = threadIdx.x;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * G + h]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(red_m[w * G + h] - mx);
      red_m[w * G + h] = wt;
      sum += red_l[w * G + h] * wt;
    }
    part_ml[(part * g + h0 + h) * 2] = mx;
    part_ml[(part * g + h0 + h) * 2 + 1] = sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gs * hd; e += kThreads) {
    const int h = e / hd, c = e - h * hd;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a += red_acc[(w * G + h) * 32 * D + c] * red_m[w * G + h];
    part_acc[(part * g + h0) * hd + e] = a;
  }
}

// One block of kThreads per resident slot of the card (a persistent
// grid): every block reads the rows' lengths, counts each row's splits
// (splits past a row's last valid key are no work) and walks the work
// items (row, split, kv head, head group), head group fastest, from
// blockIdx.x in steps of gridDim.x.  Items are equal in size but for a
// row's last split.
template <typename T, typename ELT, bool Q8, int G, int D>
__global__ void __launch_bounds__(kThreads, 1)
    paged_partial(const T* __restrict__ q, const ELT* __restrict__ kp,
                  const ELT* __restrict__ vp, const float* __restrict__ ks,
                  const float* __restrict__ vs,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  Geometry Gm, Layout L, int b, float sm_scale, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lens = reinterpret_cast<int*>(smem + L.rows);  // [b]
  int* first = lens + b;  // [b + 1]: the row's first split in the walk
  if (threadIdx.x < 32) {  // one warp scans the rows' split counts
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < b; base += 32) {
      const int i = base + lane;
      const int len = i < b ? lengths[i] : -1;
      int n = (valid_blocks(len, Gm) + Gm.split_blocks - 1) / Gm.split_blocks;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, n, o);
        if (lane >= o) n += up;
      }
      if (i < b) {
        lens[i] = len;
        first[i + 1] = carry + n;
      }
      carry += __shfl_sync(0xffffffffu, n, 31);
    }
    if (lane == 0) first[0] = 0;
  }
  __syncthreads();
  const int items = first[b] * Gm.n_kv * Gm.hgroups;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int hg = 0, r = it;
    if (Gm.hgroups > 1) hg = it % Gm.hgroups, r = it / Gm.hgroups;
    const int kvh = r % Gm.n_kv, s = r / Gm.n_kv;
    int lo = 0, hi = b;  // the row: the last with first[row] <= s
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (first[mid] <= s) lo = mid;
      else hi = mid;
    }
    split_partial<T, ELT, Q8, G, D>(smem, q, kp, vp, ks, vs, tables,
                                    part_acc, part_ml, Gm, L, sm_scale, vec,
                                    lo, kvh, hg, s - first[lo], lens[lo]);
  }
}

// -- the splits' merge -------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    paged_combine(const float* __restrict__ part_acc,
                  const float* __restrict__ part_ml,
                  const int* __restrict__ lengths, T* __restrict__ out,
                  Geometry G) {
  const int kvh = blockIdx.x, row = blockIdx.y;
  const int g = G.g, hd = G.hd;
  const int nblk = valid_blocks(lengths[row], G);
  const int ns = (nblk + G.split_blocks - 1) / G.split_blocks;
  const size_t part0 =
      (static_cast<size_t>(row) * G.n_kv + kvh) * G.n_splits;
  const float* acc = part_acc + part0 * g * hd;
  const float* ml = part_ml + part0 * g * 2;
  T* orow = out + (static_cast<size_t>(row) * G.n_heads + kvh * g) * hd;
  if (ns == 1) {  // the one split's partial is the row's whole sum
    for (int e = threadIdx.x; e < g * hd; e += kCombineThreads)
      orow[e] = vtpu::from_f32<T>(acc[e] / fmaxf(ml[(e / hd) * 2 + 1],
                                                 1e-30f));
    return;
  }
  extern __shared__ float w_s[];  // [ns, g] weights, then [g] l
  float* l_s = w_s + ns * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = warp; h < g; h += kCombineThreads / 32) {
    float mx = kNegInf;
    for (int s = lane; s < ns; s += 32) mx = fmaxf(mx, ml[(s * g + h) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int s = lane; s < ns; s += 32) {
      const float w = exp2f(ml[(s * g + h) * 2] - mx);
      w_s[s * g + h] = w;
      sum += ml[(s * g + h) * 2 + 1] * w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) l_s[h] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g * hd; e += kCombineThreads) {
    const int h = e / hd;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < ns; ++s) a += acc[s * g * hd + e] * w_s[s * g + h];
    orow[e] = vtpu::from_f32<T>(a / l_s[h]);
  }
}

// Blocks of `kernel` the card holds at once with `smem` bytes each: the
// grid of a persistent kernel
template <typename K>
int resident_blocks(K kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return sms * per_sm;
}

template <typename T, typename ELT, bool Q8, int G, int D>
int run(const void* q, const void* kp, const void* vp, const void* ks,
        const void* vs, const void* tables, const void* lengths, void* out,
        void* scratch, int b, Geometry Gm, float sm_scale, cudaStream_t st) {
  constexpr int EPV = 16 / sizeof(ELT);
  const bool vec =
      Gm.hd % EPV == 0 && vtpu::aligned16(kp) && vtpu::aligned16(vp);
  Gm.hgroups = (Gm.g + G - 1) / G;
  const Layout L = layout(Gm, b, sizeof(ELT), Q8, G, D);
  auto partial = paged_partial<T, ELT, Q8, G, D>;
  cudaError_t e = vtpu::allow_smem(partial, L.total);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t combine_smem =
      sizeof(float) * (static_cast<size_t>(Gm.n_splits) + 1) * Gm.g;
  e = vtpu::allow_smem(paged_combine<T>, combine_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long most =
      static_cast<long long>(b) * Gm.n_kv * Gm.n_splits * Gm.hgroups;
  // (shared memory bytes << 32) | resident blocks, of the last layout
  // seen: one word, so a concurrent caller reads a matching pair (a count
  // left from another device costs time, not results)
  static std::atomic<unsigned long long> cache{0};
  unsigned long long c = cache.load(std::memory_order_relaxed);
  if (c >> 32 != static_cast<unsigned long long>(L.total)) {
    const int n = resident_blocks(partial, kThreads, L.total);
    c = static_cast<unsigned long long>(L.total) << 32 |
        static_cast<unsigned>(n > 0 ? n : 0);
    cache.store(c, std::memory_order_relaxed);
  }
  const int resident = static_cast<int>(c & 0xffffffffu);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = most < resident ? static_cast<int>(most) : resident;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + static_cast<size_t>(b) * Gm.n_kv *
                                  Gm.n_splits * Gm.g * Gm.hd;
  partial<<<grid, kThreads, L.total, st>>>(
      static_cast<const T*>(q), static_cast<const ELT*>(kp),
      static_cast<const ELT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), part_acc, part_ml, Gm, L, b,
      sm_scale, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_combine<T><<<dim3(Gm.n_kv, b), kCombineThreads, combine_smem, st>>>(
      part_acc, part_ml, static_cast<const int*>(lengths),
      static_cast<T*>(out), Gm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename ELT, bool Q8>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* lengths,
           void* out, void* scratch, int b, int n_heads, int n_kv, int hd,
           int bs, int nb_max, float sm_scale, void* stream) {
  if (b <= 0 || n_kv <= 0 || n_heads % n_kv != 0 || hd <= 0 || bs <= 0 ||
      nb_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry G = geometry(n_heads, n_kv, hd, bs, nb_max);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VTPU_PAGED_RUN(GG, DD)                                            \
  return run<T, ELT, Q8, GG, DD>(q, kp, vp, ks, vs, tables, lengths, out, \
                                 scratch, b, G, sm_scale, st)
  // The instance: D from hd, then the smallest G >= g with G * D <= 32, or
  // the largest such G and head groups of G.
  if (hd <= 32) {
    if (G.g <= 4) VTPU_PAGED_RUN(4, 1);
    if (G.g <= 8) VTPU_PAGED_RUN(8, 1);
    if (G.g <= 16) VTPU_PAGED_RUN(16, 1);
    VTPU_PAGED_RUN(32, 1);
  }
  if (hd <= 64) {
    if (G.g <= 4) VTPU_PAGED_RUN(4, 2);
    if (G.g <= 8) VTPU_PAGED_RUN(8, 2);
    VTPU_PAGED_RUN(16, 2);
  }
  if (hd <= 128) {
    if (G.g <= 4) VTPU_PAGED_RUN(4, 4);
    VTPU_PAGED_RUN(8, 4);
  }
  if (hd <= 256) VTPU_PAGED_RUN(4, 8);
  if (hd <= kMaxHeadDim) VTPU_PAGED_RUN(2, 16);
#undef VTPU_PAGED_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Floats of scratch the wrapper must allocate for one call.
extern "C" long long vtpu_paged_decode_scratch(int b, int n_heads, int n_kv,
                                               int hd, int bs, int nb_max) {
  if (b <= 0 || n_kv <= 0 || n_heads % n_kv != 0 || bs <= 0 || nb_max <= 0)
    return 0;
  const Geometry G = geometry(n_heads, n_kv, hd, bs, nb_max);
  return static_cast<long long>(b) * n_kv * G.n_splits * G.g * (hd + 2);
}

#define VTPU_PAGED_ENTRY(NAME, T, ELT, Q8)                                  \
  extern "C" int NAME(const void* q, const void* kp, const void* vp,         \
                      const void* ks, const void* vs, const void* tables,    \
                      const void* lengths, void* out, void* scratch, int b,  \
                      int n_heads, int n_kv, int hd, int bs, int nb_max,     \
                      float sm_scale, void* stream) {                        \
    return launch<T, ELT, Q8>(q, kp, vp, ks, vs, tables, lengths, out,       \
                              scratch, b, n_heads, n_kv, hd, bs, nb_max,     \
                              sm_scale, stream);                             \
  }

VTPU_PAGED_ENTRY(vtpu_paged_decode_f32, float, float, false)
VTPU_PAGED_ENTRY(vtpu_paged_decode_bf16, __nv_bfloat16, __nv_bfloat16, false)
VTPU_PAGED_ENTRY(vtpu_paged_decode_q8_f32, float, int8_t, true)
VTPU_PAGED_ENTRY(vtpu_paged_decode_q8_bf16, __nv_bfloat16, int8_t, true)
