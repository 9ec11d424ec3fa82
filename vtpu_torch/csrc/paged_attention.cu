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
// int8); the flops are ~4 * H * hd per key, far below the card's rate.
// At decode batch sizes a block per (row, kv head) would leave most of
// the 132 SMs idle and walk a long row's blocks one after another, so
// the work is split along the sequence as well (split-K, as in
// flash-decoding):
//
//  1. paged_partial: one thread block per (split, kv head, row).  A split
//     covers kSplitTokens consecutive key slots of the row.  The block
//     reads the row's physical block ids from the table itself (Hopper
//     has no scalar prefetch), stages tiles of up to 64 keys (whole
//     logical blocks) of K and V in shared memory as f32 (int8 tiles are
//     dequantized by their per-token scales on the way in), and the
//     g = H / n_kv query heads of the kv head all score against each
//     tile: one thread per (head, key) dot product, K rows padded by one
//     float so those reads hit distinct banks.  Softmax is the
//     reference's f32 online softmax with the -1e30 mask and scale
//     hd^-0.5; the split's (m, l, acc) go to a scratch buffer.
//  2. paged_combine: one block per (kv head, row) rescales the splits'
//     partials by exp(m_s - max m) and writes acc / max(l, 1e-30).
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

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;     // keys staged per tile (whole blocks)
constexpr int kSplitTokens = 128;   // keys per split (whole tiles)
constexpr int kMaxAcc = 4;          // g * hd <= kMaxAcc * kThreads
constexpr float kNegInf = -1e30f;

struct Geometry {
  int g, hd, bs, nb_max, n_kv, n_heads;
  int tile_blocks;   // logical blocks per tile
  int split_blocks;  // logical blocks per split (a multiple of tile_blocks)
  int n_splits;      // splits of a full row
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
  const int tiles = (kSplitTokens / (G.tile_blocks * bs)) > 0
                        ? kSplitTokens / (G.tile_blocks * bs)
                        : 1;
  G.split_blocks = tiles * G.tile_blocks;
  G.n_splits = (nb_max + G.split_blocks - 1) / G.split_blocks;
  return G;
}

__device__ __forceinline__ int valid_blocks(int len, const Geometry& G) {
  if (len < 0) return 0;
  const int n = len / G.bs + 1;
  return n < G.nb_max ? n : G.nb_max;
}

// Stage logical blocks [lb0, lb0 + nblk) of one kv head of a pool as f32
// rows of `stride` floats (token t of the tile at dst[t * stride]).
// SCALE multiplies each token by its scale (int8 pools).
template <typename ELT, bool SCALE>
__device__ __forceinline__ void load_tile(
    float* dst, int stride, const ELT* __restrict__ pool,
    const float* __restrict__ scale, const int* __restrict__ table_row,
    int lb0, int nblk, int kvh, const Geometry& G, bool vec) {
  constexpr int EPV = 16 / sizeof(ELT);  // elements per 16-byte vector
  const int per_block = G.bs * G.hd;
  const int n = nblk * per_block;
  if (vec) {
    for (int i = threadIdx.x; i < n / EPV; i += kThreads) {
      const int c0 = i * EPV;
      const int blk = c0 / per_block, r = c0 % per_block;
      const size_t phys = static_cast<size_t>(table_row[lb0 + blk]);
      const size_t base = (phys * G.n_kv + kvh) * per_block;
      uint4 u = *reinterpret_cast<const uint4*>(pool + base + r);
      const ELT* e = reinterpret_cast<const ELT*>(&u);
      const int tok = blk * G.bs + r / G.hd;
      const int dim = r % G.hd;  // hd % EPV == 0: one token per vector
      const float s =
          SCALE ? scale[(phys * G.n_kv + kvh) * G.bs + r / G.hd] : 1.f;
#pragma unroll
      for (int j = 0; j < EPV; ++j) {
        float f = vtpu::to_f32(e[j]);
        if (SCALE) f *= s;
        dst[tok * stride + dim + j] = f;
      }
    }
  } else {
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const int blk = c / per_block, r = c % per_block;
      const size_t phys = static_cast<size_t>(table_row[lb0 + blk]);
      const size_t base = (phys * G.n_kv + kvh) * per_block;
      float f = vtpu::to_f32(pool[base + r]);
      if (SCALE) f *= scale[(phys * G.n_kv + kvh) * G.bs + r / G.hd];
      dst[(blk * G.bs + r / G.hd) * stride + r % G.hd] = f;
    }
  }
}

template <typename T, typename ELT, bool Q8>
__global__ void __launch_bounds__(kThreads)
    paged_partial(const T* __restrict__ q, const ELT* __restrict__ kp,
                  const ELT* __restrict__ vp, const float* __restrict__ ks,
                  const float* __restrict__ vs,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  Geometry G, float sm_scale, bool vec) {
  const int split = blockIdx.x, kvh = blockIdx.y, row = blockIdx.z;
  const int len = lengths[row];
  const int nblk = valid_blocks(len, G);
  const int lb_begin = split * G.split_blocks;
  if (lb_begin >= nblk) return;  // nothing valid in this split
  const int lb_end = min(lb_begin + G.split_blocks, nblk);
  const int g = G.g, hd = G.hd;
  const int tk = G.tile_blocks * G.bs;  // keys per full tile
  const int kstride = hd + 1;           // padded K rows: conflict-free dots

  extern __shared__ float smem[];
  float* q_s = smem;                 // [g, hd]
  float* k_s = q_s + g * hd;         // [tk, hd + 1]
  float* v_s = k_s + tk * kstride;   // [tk, hd]
  float* p_s = v_s + tk * hd;        // [g, tk] scores, then probabilities
  float* m_s = p_s + g * tk;         // [g]
  float* l_s = m_s + g;              // [g]
  float* a_s = l_s + g;              // [g] rescale of the current tile

  const T* qr = q + (static_cast<size_t>(row) * G.n_heads + kvh * g) * hd;
  for (int e = threadIdx.x; e < g * hd; e += kThreads)
    q_s[e] = vtpu::to_f32(qr[e]);
  if (threadIdx.x < g) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const int* table_row = tables + static_cast<size_t>(row) * G.nb_max;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* ks_h = Q8 ? ks : nullptr;
  const float* vs_h = Q8 ? vs : nullptr;

  for (int lb0 = lb_begin; lb0 < lb_end; lb0 += G.tile_blocks) {
    const int nb = min(G.tile_blocks, lb_end - lb0);
    const int key0 = lb0 * G.bs;
    __syncthreads();  // the previous tile is consumed (and q_s is set)
    load_tile<ELT, Q8>(k_s, kstride, kp, ks_h, table_row, lb0, nb, kvh, G,
                       vec);
    load_tile<ELT, Q8>(v_s, hd, vp, vs_h, table_row, lb0, nb, kvh, G, vec);
    __syncthreads();

    // scores: one thread per (head, key)
    for (int pi = threadIdx.x; pi < g * tk; pi += kThreads) {
      const int h = pi / tk, j = pi % tk;
      float s = kNegInf;
      if (j < nb * G.bs && key0 + j <= len) {
        const float* qh = q_s + h * hd;
        const float* kj = k_s + j * kstride;
        float d = 0.f;
        for (int c = 0; c < hd; ++c) d += qh[c] * kj[c];
        s = d * sm_scale;
      }
      p_s[pi] = s;
    }
    __syncthreads();

    // online softmax bookkeeping: one warp per query head
    for (int h = warp; h < g; h += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < tk; j += 32) mx = fmaxf(mx, p_s[h * tk + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < tk; j += 32) {
        const bool ok = j < nb * G.bs && key0 + j <= len;
        const float p = ok ? expf(p_s[h * tk + j] - m_new) : 0.f;
        p_s[h * tk + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
        a_s[h] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V; thread owns (head, dim) slots
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < g * hd) {
        const int h = e / hd, c = e % hd;
        float a = acc[i] * a_s[h];
        const float* ph = p_s + h * tk;
        const int nk = nb * G.bs;
        for (int j = 0; j < nk; ++j) {
          const float p = ph[j];
          if (p != 0.f) a += p * v_s[j * hd + c];
        }
        acc[i] = a;
      }
    }
  }

  const size_t part =
      ((static_cast<size_t>(row) * G.n_kv + kvh) * G.n_splits + split);
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < g * hd) part_acc[part * g * hd + e] = acc[i];
  }
  __syncthreads();  // l_s / m_s final
  if (threadIdx.x < g) {
    part_ml[(part * g + threadIdx.x) * 2] = m_s[threadIdx.x];
    part_ml[(part * g + threadIdx.x) * 2 + 1] = l_s[threadIdx.x];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
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
  T* orow = out + (static_cast<size_t>(row) * G.n_heads + kvh * g) * hd;
  for (int e = threadIdx.x; e < g * hd; e += kThreads) {
    const int h = e / hd;
    float m = kNegInf;
    for (int s = 0; s < ns; ++s)
      m = fmaxf(m, part_ml[((part0 + s) * g + h) * 2]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = expf(part_ml[((part0 + s) * g + h) * 2] - m);
      l += part_ml[((part0 + s) * g + h) * 2 + 1] * w;
      a += part_acc[(part0 + s) * g * hd + e] * w;
    }
    orow[e] = vtpu::from_f32<T>(a / fmaxf(l, 1e-30f));
  }
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
  if (G.g * hd > kMaxAcc * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int EPV = 16 / sizeof(ELT);
  const bool vec = hd % EPV == 0 && vtpu::aligned16(kp) &&
                   vtpu::aligned16(vp);
  const size_t tk = static_cast<size_t>(G.tile_blocks) * bs;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(G.g) * hd + tk * (hd + 1) +
                       tk * hd + G.g * tk + 3 * G.g);
  auto partial = paged_partial<T, ELT, Q8>;
  cudaError_t e = vtpu::allow_smem(partial, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml =
      part_acc + static_cast<size_t>(b) * n_kv * G.n_splits * G.g * hd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  partial<<<dim3(G.n_splits, n_kv, b), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const ELT*>(kp),
      static_cast<const ELT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), part_acc, part_ml, G, sm_scale, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_combine<T><<<dim3(n_kv, b), kThreads, 0, st>>>(
      part_acc, part_ml, static_cast<const int*>(lengths),
      static_cast<T*>(out), G);
  return static_cast<int>(cudaGetLastError());
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
