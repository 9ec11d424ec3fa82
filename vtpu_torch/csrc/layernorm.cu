// Fused LayerNorm forward over the last dim, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vtpu/ops/layernorm.py::_ln_kernel
// (reached from _fused_layernorm_impl / fused_layernorm).  Numerics
// follow it: f32 mean, f32 biased variance mean((x - mean)^2) taken in a
// second pass over the row, (x - mean) * rsqrt(var + eps) * gamma + beta,
// cast back to x's dtype.  Unlike the TPU wrapper, which sends a row
// count that is not a multiple of its 256-row block to plain XLA, these
// kernels take every row count.
//
// What bounds it on an H100: bytes.  It reads each row once and writes
// it once (2 * rows * d * sizeof(x), plus gamma/beta which stay in
// cache); its ~8 flops per element are far below the card's f32 rate.
// Two kernels, chosen by shape:
//
//  - ln_regs, where d % (16 / sizeof(x)) == 0, every pointer is 16-byte
//    aligned and the row fits in registers: up to kMaxChunks 16-byte
//    chunks a thread and kRowThreads threads a row, so d <= 8192 in bf16
//    and 4096 in f32.  Each thread holds its chunks of the row as loaded,
//    so both statistics come from registers and the row is read from
//    device memory once and never staged; gamma and beta are 16-byte
//    loads into registers, once per block.  A bytes-bound kernel needs
//    bytes in flight, and registers bound how many blocks an SM holds, so
//    each block keeps about 16 KB of loads in flight: a row under 16 KB
//    (bf16 at d 4096 is 8 KB) makes the block walk rows (blockIdx.x,
//    + gridDim.x, ..., as many blocks as the card holds at once, gamma
//    and beta loaded once for all of them) with the next row's loads
//    issued before this row's reductions; a 16 KB row (f32 at d 4096)
//    takes one block.  Each reduction is warp shuffles, one barrier and
//    the warps' partials added in one fixed order, so the output is
//    deterministic; the two reductions of a row have their own buffers,
//    so a row costs two barriers.
//  - ln_smem otherwise (d not a whole number of chunks, unaligned
//    pointers, wider rows): one block of kThreads a row stages it in
//    shared memory as f32 and takes both statistics from there.
//
// Why CUDA C++ and not Triton: the kernel is a row reduction plus an
// elementwise pass and would fit Triton, but one nvcc-built library for
// all of the port's kernels keeps one build path and no Triton
// dependency on the serving path.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // ln_smem: threads a row
constexpr int kWarps = kThreads / 32;
constexpr int kRowThreads = 128;  // ln_regs: most threads a row
constexpr int kMaxChunks = 8;     // ln_regs: most 16-byte chunks a thread

// Sum over the block's nw warps; every thread gets the same value (a
// warp's lanes by shuffles, then the warps' partials in one fixed order).
// `red` must not be read by another reduction still in flight.
__device__ __forceinline__ float block_total(float v, float* red, int nw) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < nw; ++w) t += red[w];
  return t;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
    f[j] = vtpu::to_f32(e[j]);
}

// Row r's chunks of this thread (zero past the row's nv chunks; nv 0
// loads nothing).
template <int CH>
__device__ __forceinline__ void load_row(uint4 (&u)[CH],
                                         const uint4* __restrict__ x,
                                         size_t r, int nv) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    u[c] = i < nv ? x[r * nv + i] : make_uint4(0, 0, 0, 0);
  }
}

// Rows blockIdx.x, + gridDim.x, ...; CH 16-byte chunks a thread.  Below
// kMaxChunks chunks (a row under 16 KB at kRowThreads) the block walks
// several rows and loads the next row while it reduces this one, so that
// each block keeps about 16 KB in flight; at kMaxChunks a row is that
// much alone, and the launch gives each row its own block.
template <typename T, int CH>
__global__ void __launch_bounds__(kRowThreads)
    ln_regs(const T* __restrict__ x, const T* __restrict__ gamma,
            const T* __restrict__ beta, T* __restrict__ y, int rows, int d,
            float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr bool kPrefetch = CH < kMaxChunks;
  __shared__ float red[2][kRowThreads / 32];
  const int nv = d / VEC, nw = blockDim.x / 32;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* y4 = reinterpret_cast<uint4*>(y);
  // gamma, beta and this thread's chunks of the row, as loaded
  uint4 g[CH], b[CH], cur[CH];
  load_row<CH>(g, reinterpret_cast<const uint4*>(gamma), 0, nv);
  load_row<CH>(b, reinterpret_cast<const uint4*>(beta), 0, nv);
  load_row<CH>(cur, x4, blockIdx.x, nv);  // the grid is at most rows

  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int rn = r + gridDim.x;
    const int nv_next = rn < rows ? nv : 0;
    uint4 nxt[CH];
    if constexpr (kPrefetch) load_row<CH>(nxt, x4, rn, nv_next);
    float f[VEC];  // one chunk widened to f32, again in each pass
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      unpack<T>(cur[c], f);  // zero past the row
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += f[j];
    }
    const float mean = block_total(s, red[0], nw) / static_cast<float>(d);
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (static_cast<int>(threadIdx.x + c * blockDim.x) >= nv) continue;
      unpack<T>(cur[c], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t = f[j] - mean;
        ss += t * t;
      }
    }
    const float var = block_total(ss, red[1], nw) / static_cast<float>(d);
    const float rstd = rsqrtf(var + eps);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = threadIdx.x + c * blockDim.x;
      if (i >= nv) continue;
      float gf[VEC], bf[VEC];
      unpack<T>(g[c], gf);
      unpack<T>(b[c], bf);
      unpack<T>(cur[c], f);
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        e[j] = vtpu::from_f32<T>((f[j] - mean) * rstd * gf[j] + bf[j]);
      y4[static_cast<size_t>(r) * nv + i] = u;
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int c = 0; c < CH; ++c) cur[c] = nxt[c];
    } else {
      load_row<CH>(cur, x4, rn, nv_next);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ln_smem(const T* __restrict__ x, const T* __restrict__ gamma,
            const T* __restrict__ beta, T* __restrict__ y, int d,
            float eps) {
  extern __shared__ float row[];  // [d] f32 copy of this row
  __shared__ float red[2][kWarps];
  const size_t r = blockIdx.x;
  const T* xr = x + r * d;
  T* yr = y + r * d;

  float s = 0.f;
  if (VEC > 1) {
    const int nv = d / VEC;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 u = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = vtpu::to_f32(e[j]);
        row[i * VEC + j] = f;
        s += f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = vtpu::to_f32(xr[i]);
      row[i] = f;
      s += f;
    }
  }
  // the reductions' barriers also publish row[] to the other threads
  const float mean = block_total(s, red[0], kWarps) / static_cast<float>(d);
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float c = row[i] - mean;
    ss += c * c;
  }
  const float var = block_total(ss, red[1], kWarps) / static_cast<float>(d);
  const float rstd = rsqrtf(var + eps);

  if (VEC > 1) {
    const int nv = d / VEC;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c = i * VEC + j;
        const float n = (row[c] - mean) * rstd;
        e[j] = vtpu::from_f32<T>(n * vtpu::to_f32(gamma[c]) +
                                 vtpu::to_f32(beta[c]));
      }
      reinterpret_cast<uint4*>(yr)[i] = u;
    }
  } else {
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float n = (row[c] - mean) * rstd;
      yr[c] = vtpu::from_f32<T>(n * vtpu::to_f32(gamma[c]) +
                                vtpu::to_f32(beta[c]));
    }
  }
}

// ln_regs with CH chunks a thread and ceil(nv / CH) threads (a multiple
// of 32) a row: as many blocks as fit on the card at once where a block
// walks rows, else one a row.
template <typename T, int CH>
int launch_regs(const T* x, const T* gamma, const T* beta, T* y, int rows,
                int d, float eps, cudaStream_t st) {
  const int nv = d / (16 / static_cast<int>(sizeof(T)));
  const int threads = ((nv + CH - 1) / CH + 31) / 32 * 32;
  auto kernel = ln_regs<T, CH>;
  int grid = rows;
  if (CH < kMaxChunks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                          sms;
    if (fit < rows) grid = static_cast<int>(fit);
  }
  kernel<<<grid, threads, 0, st>>>(x, gamma, beta, y, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xv, const void* gv, const void* bv, void* yv,
           int rows, int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(xv);
  const T* gamma = static_cast<const T*>(gv);
  const T* beta = static_cast<const T*>(bv);
  T* y = static_cast<T*>(yv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = d % VEC == 0 && vtpu::aligned16(x) && vtpu::aligned16(y);
  const int nv = d / VEC;
  if (vec && vtpu::aligned16(gamma) && vtpu::aligned16(beta) &&
      nv <= kMaxChunks * kRowThreads) {
    if (nv <= kRowThreads)
      return launch_regs<T, 1>(x, gamma, beta, y, rows, d, eps, st);
    if (nv <= 2 * kRowThreads)
      return launch_regs<T, 2>(x, gamma, beta, y, rows, d, eps, st);
    if (nv <= 4 * kRowThreads)
      return launch_regs<T, 4>(x, gamma, beta, y, rows, d, eps, st);
    return launch_regs<T, kMaxChunks>(x, gamma, beta, y, rows, d, eps, st);
  }
  auto kernel = vec ? ln_smem<T, VEC> : ln_smem<T, 1>;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<rows, kThreads, smem, st>>>(x, gamma, beta, y, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define VTPU_LN_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta, \
                      void* y, int rows, int d, float eps, void* stream) { \
    return launch<T>(x, gamma, beta, y, rows, d, eps, stream);            \
  }

VTPU_LN_ENTRY(vtpu_layernorm_f32_f32, float)
VTPU_LN_ENTRY(vtpu_layernorm_bf16_bf16, __nv_bfloat16)

extern "C" const char* vtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
