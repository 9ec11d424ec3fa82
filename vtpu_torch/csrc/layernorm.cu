// Fused LayerNorm forward over the last dim, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vtpu/ops/layernorm.py::_ln_kernel
// (reached from _fused_layernorm_impl / fused_layernorm).  Numerics
// follow it: f32 mean, f32 biased variance mean((x - mean)^2),
// (x - mean) * rsqrt(var + eps) * gamma + beta, cast back to x's dtype.
// Unlike the TPU wrapper, which sends a row count that is not a multiple
// of its 256-row block to plain XLA, this kernel takes every row count:
// one thread block per row, so there is no ragged edge.
//
// What bounds it on an H100: bytes.  It reads each row once and writes
// it once (2 * rows * d * sizeof(x), plus gamma/beta which stay in L2);
// its ~8 flops per element are far below the card's f32 rate.  So the
// design reads the row from device memory exactly once, with 16-byte
// vector loads where d and the pointers allow, stages it in shared
// memory as f32, takes both statistics from there (warp-shuffle
// reductions, f32), and writes the output with 16-byte stores.
//
// Why CUDA C++ and not Triton: the kernel is a row reduction plus an
// elementwise pass and would fit Triton, but one nvcc-built library for
// all of the port's kernels keeps one build path and no Triton
// dependency on the serving path.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sum over the block; every thread gets the same value (the warps'
// partials are added in one fixed order).
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

template <typename T, typename G, int VEC>
__global__ void __launch_bounds__(kThreads)
    ln_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
              const G* __restrict__ beta, T* __restrict__ y, int d,
              float eps) {
  extern __shared__ float row[];  // [d] f32 copy of this row
  __shared__ float red[kWarps];
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
  const float mean = block_sum(s, red) / static_cast<float>(d);
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float c = row[i] - mean;
    ss += c * c;
  }
  const float var = block_sum(ss, red) / static_cast<float>(d);
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

template <typename T, typename G>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           int rows, int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = d % VEC == 0 && vtpu::aligned16(x) && vtpu::aligned16(y);
  auto kernel = vec ? ln_kernel<T, G, VEC> : ln_kernel<T, G, 1>;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t e = vtpu::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma),
      static_cast<const G*>(beta), static_cast<T*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define VTPU_LN_ENTRY(NAME, T, G)                                        \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta, \
                      void* y, int rows, int d, float eps, void* stream) { \
    return launch<T, G>(x, gamma, beta, y, rows, d, eps, stream);         \
  }

VTPU_LN_ENTRY(vtpu_layernorm_f32_f32, float, float)
VTPU_LN_ENTRY(vtpu_layernorm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

extern "C" const char* vtpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
