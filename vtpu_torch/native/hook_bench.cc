/* vgpu_hook_bench — what the interposer adds to the two calls its hot
 * loop wraps (SURVEY.md §3.3: every allocation and every launch).
 *
 *   vgpu_hook_bench <launches> <alloc_pairs> <alloc_bytes>
 *
 * Resolves the driver the way CUDA's runtime does (dlopen libcuda.so.1,
 * dlsym cuGetProcAddress_v2, then every entry point through it), so that
 * under LD_PRELOAD of the interposer each call goes through its
 * wrapper, and without it straight to the driver.  Times, on the host
 * clock: the issue of <launches> launches of an empty kernel (loaded
 * from PTX) on the legacy stream, and <alloc_pairs> cuMemAlloc_v2 +
 * cuMemFree_v2 pairs of <alloc_bytes> (what cudaMalloc / cudaFree reach).
 * Prints one JSON line; exits non-zero on any driver error. */
#include <dlfcn.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

#include "cuda_min.h"

typedef struct CUmod_st* CUmodule;
typedef CUresult (*PFN_cuModuleLoadData)(CUmodule*, const void*);
typedef CUresult (*PFN_cuModuleGetFunction)(CUfunction*, CUmodule,
                                            const char*);
typedef CUresult (*PFN_cuCtxSynchronize)(void);

static const char kPtx[] =
    ".version 7.0\n"
    ".target sm_50\n"
    ".address_size 64\n"
    ".visible .entry vgpu_empty()\n"
    "{\n"
    "  ret;\n"
    "}\n";

static PFN_cuGetProcAddress_v2 g_gpa;

static void* resolve(const char* name) {
  void* fn = nullptr;
  CUdriverProcAddressQueryResult status;
  if (g_gpa(name, &fn, 12000, CU_GET_PROC_ADDRESS_DEFAULT, &status) !=
          CUDA_SUCCESS ||
      !fn) {
    fprintf(stderr, "vgpu_hook_bench: cannot resolve %s\n", name);
    exit(2);
  }
  return fn;
}

static void ok(CUresult rc, const char* what) {
  if (rc != CUDA_SUCCESS) {
    fprintf(stderr, "vgpu_hook_bench: %s failed (%d)\n", what, rc);
    exit(3);
  }
}

static double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

int main(int argc, char** argv) {
  if (argc != 4) {
    fprintf(stderr, "usage: %s <launches> <alloc_pairs> <alloc_bytes>\n",
            argv[0]);
    return 1;
  }
  long launches = atol(argv[1]), pairs = atol(argv[2]);
  size_t bytes = (size_t)atoll(argv[3]);
  void* h = dlopen("libcuda.so.1", RTLD_NOW);
  if (!h) {
    fprintf(stderr, "vgpu_hook_bench: %s\n", dlerror());
    return 2;
  }
  g_gpa = (PFN_cuGetProcAddress_v2)dlsym(h, "cuGetProcAddress_v2");
  if (!g_gpa) {
    fprintf(stderr, "vgpu_hook_bench: no cuGetProcAddress_v2\n");
    return 2;
  }
  PFN_cuInit init = (PFN_cuInit)resolve("cuInit");
  PFN_cuDeviceGet device_get = (PFN_cuDeviceGet)resolve("cuDeviceGet");
  PFN_cuDevicePrimaryCtxRetain retain =
      (PFN_cuDevicePrimaryCtxRetain)resolve("cuDevicePrimaryCtxRetain");
  PFN_cuCtxSetCurrent set_current =
      (PFN_cuCtxSetCurrent)resolve("cuCtxSetCurrent");
  PFN_cuModuleLoadData load = (PFN_cuModuleLoadData)resolve("cuModuleLoadData");
  PFN_cuModuleGetFunction get_fn =
      (PFN_cuModuleGetFunction)resolve("cuModuleGetFunction");
  PFN_cuLaunchKernel launch = (PFN_cuLaunchKernel)resolve("cuLaunchKernel");
  PFN_cuCtxSynchronize sync = (PFN_cuCtxSynchronize)resolve("cuCtxSynchronize");
  PFN_cuMemAlloc alloc = (PFN_cuMemAlloc)resolve("cuMemAlloc");
  PFN_cuMemFree release = (PFN_cuMemFree)resolve("cuMemFree");

  CUdevice dev;
  CUcontext ctx;
  CUmodule mod;
  CUfunction fn;
  ok(init(0), "cuInit");
  ok(device_get(&dev, 0), "cuDeviceGet");
  ok(retain(&ctx, dev), "cuDevicePrimaryCtxRetain");
  ok(set_current(ctx), "cuCtxSetCurrent");
  ok(load(&mod, kPtx), "cuModuleLoadData");
  ok(get_fn(&fn, mod, "vgpu_empty"), "cuModuleGetFunction");

  for (int i = 0; i < 1000; i++)
    ok(launch(fn, 1, 1, 1, 1, 1, 1, 0, nullptr, nullptr, nullptr),
       "cuLaunchKernel");
  ok(sync(), "cuCtxSynchronize");
  double t0 = now_s();
  for (long i = 0; i < launches; i++)
    ok(launch(fn, 1, 1, 1, 1, 1, 1, 0, nullptr, nullptr, nullptr),
       "cuLaunchKernel");
  double t1 = now_s();
  ok(sync(), "cuCtxSynchronize");
  double t2 = now_s();

  CUdeviceptr p;
  for (int i = 0; i < 10; i++) {
    ok(alloc(&p, bytes), "cuMemAlloc");
    ok(release(p), "cuMemFree");
  }
  double t3 = now_s();
  for (long i = 0; i < pairs; i++) {
    ok(alloc(&p, bytes), "cuMemAlloc");
    ok(release(p), "cuMemFree");
  }
  double t4 = now_s();
  printf("{\"launches\": %ld, \"launch_issue_us\": %.4f, "
         "\"launch_with_sync_us\": %.4f, \"alloc_free_pairs\": %ld, "
         "\"alloc_bytes\": %zu, \"alloc_free_us\": %.4f}\n",
         launches, launches ? (t1 - t0) * 1e6 / launches : 0.0,
         launches ? (t2 - t0) * 1e6 / launches : 0.0, pairs, bytes,
         pairs ? (t4 - t3) * 1e6 / pairs : 0.0);
  return 0;
}
