// Flash attention's f32 forward on the CUDA cores (sm_90a), f32
// arithmetic throughout: o and the per-row logsumexp at every head dim.
// The entries this source serves:
//
//   vtpu_flash_fwd_f32        flash_fwd       (hd <= 128)
//   vtpu_flash_fwd_wide_f32   flash_fwd_wide  (128 < hd <= 512, the head
//                                              dim in 128-column chunks)
//
// Every other flash entry runs on the tensor cores: the f32 backward
// (dq; dk and dv) at every hd as error-compensated 3xTF32 in
// flash_attention_tf32x3.cu, every bf16 entry in flash_attention_sm90.cu.
// The forward stays on f32 products because one TF32 product per pair
// would miss the f32 exactness checks (3xTF32 is the way onto the tensor
// cores for it too).
//
// Replaces the Pallas TPU kernel of vtpu/ops/attention.py:
//   flash_fwd, flash_fwd_wide      <- _attn_kernel         (_flash_2d)
//
// Layouts: q, o [N, seq_q, hd]; k, v [N / g, seq_k, hd]; lse [N, seq_q]
// f32.  N flattens every leading dim of the public [..., s, hd] tensors
// (batch and heads), and query head n reads kv head n / g, which is
// grouped-query attention written into the index: k and v are never
// repeated per query head.  Scores are (q . k) * sm_scale in f32.  With
// `causal`, key k is kept for query q iff k <= q + shift and, with
// window > 0, k > q + shift - window (the reference's _causal_mask).
//
// Numerics are the TPU kernel's: online softmax with m starting at
// -1e30, l clamped at 1e-30 (a row with no kept key writes o = 0 and
// lse ~ -1e30), lse = m + log(l), and p = 0 on every masked entry.
// Unlike the TPU wrapper, which sends a length that is not a multiple of
// 128 to the XLA reference, these kernels take every length: tiles past
// seq_q or seq_k are zero-filled on the way in, their entries masked, and
// their rows never written.
//
// What bounds them on an H100: operations.  Causal at b 2, H 32,
// s 4096, hd 128 the forward does about 2*b*H*s^2*hd = 2.7e11 flops
// (QK^T and PV over the kept half).  The bytes (q, k, v, o once) are
// ~0.2 GB, 0.06 ms at 3.35 TB/s.  These kernels multiply on the CUDA
// cores in f32, so their own ceiling is the f32 rate (67 TFLOP/s, ~4.1 ms
// for the forward).  What the design does:
//
//  - Tiles of 64 query rows by 64 keys staged in shared memory as f32
//    (rows padded by 4 floats so the 16-byte reads of 8 neighbouring
//    threads hit distinct banks); 256 threads as 16 x 16, each thread
//    owning a 4 x 4 block of the score tile (rows ty + 16 i, columns
//    tx + 16 j) and reading both operands as float4 along hd: 8 shared
//    loads for 64 FMAs.  Each output row is spread over 16 threads of a
//    half-warp, so row max and row sum are four shuffles.
//  - The TPU grid walked q blocks in order with all of K/V resident in
//    VMEM.  Here blocks run in any order on 132 SMs: one block per (q
//    tile, query head) and, in the chunked kernel, output chunk, each
//    streaming its K/V tiles from device memory (L2 holds the 2-16 MB of
//    a head).
//  - Fully masked tiles are skipped with the reference's bounds
//    (_causal_hi, _window_lo), so causal work is the kept half.
//  - Staging (K + V + Q + P tiles, f32) is 116 KB at a 128-column chunk,
//    above the 48 KB default: vtpu::allow_smem opts each kernel in.

#include <initializer_list>

#include "flash_common.cuh"

namespace {

using vtpu::flash::kNegInf;
using vtpu::flash::Problem;
using vtpu::flash::keep;
using vtpu::flash::kv_range;
using vtpu::flash::make_problem;

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kPS = kTile + 4; // row stride of the staged P tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stage rows [row0, row0 + kTile) of a [rows, ld] matrix, columns
// [0, hd), as f32 rows of `stride` floats, HD columns, zero past rows and
// past hd.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          int row0, int rows, int ld, int hd,
                                          bool vec) {
  constexpr int kGroups = HD / 4;
  for (int i = threadIdx.x; i < kTile * kGroups; i += kThreads) {
    const int r = i / kGroups, d = (i % kGroups) * 4;
    const int row = row0 + r;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows && d < hd) {
      const T* p = src + static_cast<size_t>(row) * ld + d;
      if (vec) {
        f = load4(p);
      } else {
        f.x = vtpu::to_f32(p[0]);
        f.y = d + 1 < hd ? vtpu::to_f32(p[1]) : 0.f;
        f.z = d + 2 < hd ? vtpu::to_f32(p[2]) : 0.f;
        f.w = d + 3 < hd ? vtpu::to_f32(p[3]) : 0.f;
      }
    }
    *reinterpret_cast<float4*>(dst + r * stride + d) = f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

__device__ __forceinline__ void axpy4(float4& o, float p, float4 v) {
  o.x = fmaf(p, v.x, o.x);
  o.y = fmaf(p, v.y, o.y);
  o.z = fmaf(p, v.z, o.z);
  o.w = fmaf(p, v.w, o.w);
}

// c[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over HD columns.
template <int HD>
__device__ __forceinline__ void tile_dot_add(float (&c)[4][4],
                                             const float* A, const float* B,
                                             int stride, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * stride + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * stride + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = dot4(a[i], b[j], c[i][j]);
  }
}

// c[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over HD columns.
template <int HD>
__device__ __forceinline__ void tile_dot(float (&c)[4][4],
                                         const float* A, const float* B,
                                         int stride, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  tile_dot_add<HD>(c, A, B, stride, ty, tx);
}

// acc[i][u] += sum_c W[ty + 16 i][c] * M[c][4 tx + 64 u .. + 3]: a
// [64 x 64] weight tile (row stride kPS) times a staged [64 x HD] tile.
template <int HD>
__device__ __forceinline__ void tile_accum(float4 (&acc)[4][HD / 64],
                                           const float* W, const float* M,
                                           int stride, int ty, int tx) {
  constexpr int NU = HD / 64;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const float4*>(W + (ty + 16 * i) * kPS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 m = *reinterpret_cast<const float4*>(
            M + (c + cc) * stride + 4 * tx + 64 * u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wi = cc == 0 ? w[i].x : cc == 1 ? w[i].y
                         : cc == 2 ? w[i].z : w[i].w;
          axpy4(acc[i][u], wi, m);
        }
      }
    }
  }
}

// Max and sum over the 16 threads (tx) of a half-warp that share a row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Write acc[i][u] (rows row0 + ty + 16 i, columns 4 tx + 64 u) times
// scale[i] into columns [0, hd) of a [rows, ld] matrix.
template <typename O, int HD>
__device__ __forceinline__ void store_tile(O* __restrict__ dst,
                                           const float4 (&acc)[4][HD / 64],
                                           const float (&scale)[4],
                                           int row0, int rows, int ld, int hd,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= rows) continue;
    O* out = dst + static_cast<size_t>(row) * ld;
#pragma unroll
    for (int u = 0; u < HD / 64; ++u) {
      const int d = 4 * tx + 64 * u;
      const float v[4] = {acc[i][u].x, acc[i][u].y, acc[i][u].z,
                          acc[i][u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < hd) out[d + e] = vtpu::from_f32<O>(v[e] * scale[i]);
    }
  }
}

// One score tile into the online softmax: masks s, raises the rows' max
// m, rescales l and acc, and writes the tile's p into Ps.
template <int NU>
__device__ __forceinline__ void online_softmax(float (&s)[4][4],
                                               float (&m)[4], float (&l)[4],
                                               float4 (&acc)[4][NU],
                                               float* Ps, const Problem& P,
                                               int q0, int k0, int ty,
                                               int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = keep(P, row, k0 + tx + 16 * j) ? s[i][j] * P.sm_scale
                                               : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
    const float m_new = fmaxf(m[i], row_max(mx));
    const float alpha = expf(m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p =
          s[i][j] <= kNegInf * 0.5f ? 0.f : expf(s[i][j] - m_new);
      Ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
      rs += p;
    }
    l[i] = l[i] * alpha + row_sum(rs);
    m[i] = m_new;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      acc[i][u].x *= alpha;
      acc[i][u].y *= alpha;
      acc[i][u].z *= alpha;
      acc[i][u].w *= alpha;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, Problem P, bool vec) {
  constexpr int S = HD + 4;
  constexpr int NU = HD / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * S;
  float* Vs = Ks + kTile * S;
  float* Ps = Vs + kTile * S;
  const int n = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;
  const size_t q_off = static_cast<size_t>(n) * P.seq_q * P.hd;
  load_tile<T, HD>(Qs, S, q + q_off, q0, P.seq_q, P.hd, P.hd, vec);

  float m[4], l[4];
  float4 acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int lo, hi;
  kv_range(P, q0, kTile, kTile, lo, hi);
  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, HD>(Ks, S, k + kv_off, k0, P.seq_k, P.hd, P.hd, vec);
    load_tile<T, HD>(Vs, S, v + kv_off, k0, P.seq_k, P.hd, P.hd, vec);
    __syncthreads();
    float s[4][4];
    tile_dot<HD>(s, Qs, Ks, S, ty, tx);
    online_softmax<NU>(s, m, l, acc, Ps, P, q0, k0, ty, tx);
    __syncthreads();
    tile_accum<HD>(acc, Ps, Vs, S, ty, tx);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ls = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / ls;
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < P.seq_q)
      lse[static_cast<size_t>(n) * P.seq_q + row] = m[i] + logf(ls);
  }
  store_tile<T, HD>(o + q_off, acc, inv, q0, P.seq_q, P.hd, P.hd, ty, tx);
}

// -- head dims above 128: the head dim in chunks of kChunk ------------------
// One block per (tile, head, output chunk): the scores Q K^T sum over
// every chunk of the head dim, staged chunk by chunk through the HD =
// kChunk tiles above, and the block accumulates only its own kChunk
// columns of o in registers.  So the staging and the registers are those
// of the hd 128 kernel, at the price of computing the scores once per
// output chunk (ceil(hd / 128) times).
constexpr int kChunk = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o,
                   float* __restrict__ lse, Problem P, bool vec) {
  constexpr int S = kChunk + 4;
  constexpr int NU = kChunk / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * S;
  float* Vs = Ks + kTile * S;
  float* Ps = Vs + kTile * S;
  const int n = blockIdx.y, q0 = blockIdx.x * kTile;
  const int c_out = blockIdx.z * kChunk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = q + static_cast<size_t>(n) * P.seq_q * P.hd;
  const size_t kv_off = static_cast<size_t>(n / P.g) * P.seq_k * P.hd;

  float m[4], l[4];
  float4 acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int lo, hi;
  kv_range(P, q0, kTile, kTile, lo, hi);
  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kTile;
    float s[4][4] = {};
    for (int c = 0; c < P.hd; c += kChunk) {
      const int w = min(kChunk, P.hd - c);
      __syncthreads();  // the previous chunk's Q and K are consumed
      load_tile<T, kChunk>(Qs, S, qb + c, q0, P.seq_q, P.hd, w, vec);
      load_tile<T, kChunk>(Ks, S, k + kv_off + c, k0, P.seq_k, P.hd, w, vec);
      __syncthreads();
      tile_dot_add<kChunk>(s, Qs, Ks, S, ty, tx);
    }
    // the previous tile's V and P were consumed before the chunks' barriers
    load_tile<T, kChunk>(Vs, S, v + kv_off + c_out, k0, P.seq_k, P.hd,
                         min(kChunk, P.hd - c_out), vec);
    online_softmax<NU>(s, m, l, acc, Ps, P, q0, k0, ty, tx);
    __syncthreads();
    tile_accum<kChunk>(acc, Ps, Vs, S, ty, tx);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ls = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / ls;
    const int row = q0 + ty + 16 * i;
    if (blockIdx.z == 0 && tx == 0 && row < P.seq_q)
      lse[static_cast<size_t>(n) * P.seq_q + row] = m[i] + logf(ls);
  }
  store_tile<T, kChunk>(o + static_cast<size_t>(n) * P.seq_q * P.hd + c_out,
                        acc, inv, q0, P.seq_q, P.hd,
                        min(kChunk, P.hd - c_out), ty, tx);
}

template <int HD>
constexpr size_t smem_fwd() {
  return sizeof(float) * (3 * kTile * (HD + 4) + kTile * kPS);
}

template <typename T>
bool can_vec(int hd, std::initializer_list<const void*> ptrs) {
  if (hd % 4 != 0) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) != 0) return false;
  }
  return true;
}

template <typename T, int HD>
int fwd_hd(const void* q, const void* k, const void* v, void* o, void* lse,
           int n_q, const Problem& P, bool vec, cudaStream_t st) {
  auto kernel = flash_fwd<T, HD>;
  const size_t smem = smem_fwd<HD>();
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((P.seq_q + kTile - 1) / kTile, n_q);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), P, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int n_q, int g, int seq_q, int seq_k, int hd,
               int causal, int shift, int window, float sm_scale,
               void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = can_vec<T>(hd, {q, k, v});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 64 ? fwd_hd<T, 64>(q, k, v, o, lse, n_q, P, vec, st)
                  : fwd_hd<T, 128>(q, k, v, o, lse, n_q, P, vec, st);
}

// The chunked kernel, for 128 < hd <= kMaxWideHd: one launch, grid
// (tiles, heads, output chunks), the hd 128 kernel's shared memory.
template <typename T>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* o,
                    void* lse, int n_q, int g, int seq_q, int seq_k, int hd,
                    int causal, int shift, int window, float sm_scale,
                    void* stream) {
  Problem P;
  if (!make_problem(P, n_q, g, seq_q, seq_k, hd, causal, shift, window,
                    sm_scale, vtpu::flash::kMaxWideHd))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_wide<T>;
  const size_t smem = smem_fwd<kChunk>();
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((seq_q + kTile - 1) / kTile, n_q,
                  (hd + kChunk - 1) / kChunk);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), P, can_vec<T>(hd, {q, k, v}));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define VTPU_FLASH_FWD_ENTRY(NAME, LAUNCH)                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      void* lse, int n_q, int g, int seq_q, int seq_k,      \
                      int hd, int causal, int shift, int window,            \
                      float sm_scale, void* stream) {                       \
    return LAUNCH(q, k, v, o, lse, n_q, g, seq_q, seq_k, hd, causal, shift, \
                  window, sm_scale, stream);                                \
  }

VTPU_FLASH_FWD_ENTRY(vtpu_flash_fwd_f32, launch_fwd<float>)
VTPU_FLASH_FWD_ENTRY(vtpu_flash_fwd_wide_f32, launch_fwd_wide<float>)
