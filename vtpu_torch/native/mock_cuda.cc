/* A mock libcuda.so.1 for the interposer's CPU tests: the driver-API
 * entry points the interposer hooks or calls (and the few more vgpu_hook_bench
 * makes), over simulated cards read
 * from the JSON fixture named by VTPU_MOCK_CUDA_JSON (mock_fixture.h):
 *
 *   {"ctx_mb": 300, "kernel_us": 10, "graph_us": 1000,
 *    "devices": [{"uuid": "GPU-<8>-<4>-<4>-<4>-<12>", "total_mb": 81559}]}
 *
 * Allocations fail with CUDA_ERROR_OUT_OF_MEMORY past a card's memory,
 * a primary context takes ctx_mb of it, and every launch occupies the
 * card's simulated timeline for kernel_us (graph_us for a graph), which
 * decides when an event recorded behind it completes.  cuGetProcAddress
 * resolves (name, version, flags) to the variant the driver would (_v2
 * ABIs from version 3020, cuGetProcAddress_v2 from 12000, _ptsz under
 * the per-thread-stream flag).  vtpu_mock_cuda_calls(name) counts the
 * calls each variant took (an event recorded while a capture is in
 * progress counts as "cuEventRecord_captured"); vtpu_mock_cuda_used(uuid)
 * is a card's used
 * bytes (the mock NVML adds them to its own); vtpu_mock_cuda_error(where,
 * code) makes every launch, or every completed event's query, fail with
 * a driver error from then on. */
#include <pthread.h>
#include <string.h>
#include <time.h>

#include <map>
#include <string>
#include <vector>

#include "cuda_min.h"
#include "mock_fixture.h"

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

struct Card {
  std::string uuid;
  uint64_t total = 0;
  uint64_t used = 0;
  bool ctx = false;
  double free_at = 0; /* the simulated timeline */
};

struct Ctx {
  int dev;
};

struct Event {
  double done_at = 0;
};

pthread_mutex_t g_mu = PTHREAD_MUTEX_INITIALIZER;
bool g_inited = false;
std::vector<Card> g_cards;
Ctx g_ctx[16];
uint64_t g_ctx_bytes = 0;
double g_kernel_s = 10e-6, g_graph_s = 1e-3;
std::map<CUdeviceptr, std::pair<uint64_t, int>> g_ptrs;
std::map<CUmemGenericAllocationHandle, std::pair<uint64_t, int>> g_handles;
std::map<std::string, unsigned long long> g_calls;
CUdeviceptr g_next_ptr = 0x100000000ull;
CUmemGenericAllocationHandle g_next_handle = 1;
thread_local int t_current = -1; /* device of the current context */
int g_capturing = 0; /* a capture in progress on every stream */
/* what every launch, and every completed event's query, returns from
 * vtpu_mock_cuda_error on (a card's failure, or a tenant's fault) */
CUresult g_launch_error = CUDA_SUCCESS, g_event_error = CUDA_SUCCESS;

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

struct Lock {
  Lock() { pthread_mutex_lock(&g_mu); }
  ~Lock() { pthread_mutex_unlock(&g_mu); }
};

void count(const char* name) { g_calls[name]++; }

int hexval(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

CUresult alloc(int dev, uint64_t bytes, CUdeviceptr* out) {
  if (dev < 0 || dev >= (int)g_cards.size()) return CUDA_ERROR_INVALID_CONTEXT;
  Card& c = g_cards[dev];
  if (c.used + bytes > c.total) return CUDA_ERROR_OUT_OF_MEMORY;
  c.used += bytes;
  *out = g_next_ptr;
  g_next_ptr += (bytes + 0xfffff) & ~0xfffffull;
  g_ptrs[*out] = {bytes, dev};
  return CUDA_SUCCESS;
}

CUresult release(CUdeviceptr p) {
  auto it = g_ptrs.find(p);
  if (it == g_ptrs.end()) return CUDA_ERROR_INVALID_VALUE;
  g_cards[it->second.second].used -= it->second.first;
  g_ptrs.erase(it);
  return CUDA_SUCCESS;
}

void occupy(double seconds) {
  if (t_current < 0) return;
  Card& c = g_cards[t_current];
  double t = now_s();
  c.free_at = (c.free_at > t ? c.free_at : t) + seconds;
}

}  // namespace

EXPORT CUresult cuInit(unsigned int) {
  Lock l;
  if (g_inited) return CUDA_SUCCESS;
  mock::Fixture f = mock::load("VTPU_MOCK_CUDA_JSON");
  if (!f.ok || f.devices.empty()) return 100; /* CUDA_ERROR_NO_DEVICE */
  for (auto& d : f.devices) {
    Card c;
    c.uuid = f.str(d, "uuid");
    c.total = (uint64_t)f.num(d, "total_mb", 81559) << 20;
    g_cards.push_back(c);
  }
  g_ctx_bytes = (uint64_t)f.num(f.top, "ctx_mb", 300) << 20;
  g_kernel_s = f.num(f.top, "kernel_us", 10) * 1e-6;
  g_graph_s = f.num(f.top, "graph_us", 1000) * 1e-6;
  g_inited = true;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuDriverGetVersion(int* v) {
  *v = 12040;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuDeviceGetCount(int* n) {
  Lock l;
  if (!g_inited) return CUDA_ERROR_NOT_INITIALIZED;
  *n = (int)g_cards.size();
  return CUDA_SUCCESS;
}

EXPORT CUresult cuDeviceGet(CUdevice* d, int ordinal) {
  Lock l;
  if (!g_inited) return CUDA_ERROR_NOT_INITIALIZED;
  if (ordinal < 0 || ordinal >= (int)g_cards.size())
    return CUDA_ERROR_INVALID_DEVICE;
  *d = ordinal;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuDeviceGetUuid(CUuuid* u, CUdevice d) {
  Lock l;
  if (d < 0 || d >= (int)g_cards.size()) return CUDA_ERROR_INVALID_DEVICE;
  const std::string& s = g_cards[d].uuid;
  int k = 0;
  for (size_t i = 4; i + 1 < s.size() && k < 16;) { /* skip "GPU-" */
    if (s[i] == '-') {
      i++;
      continue;
    }
    u->bytes[k++] = (char)(hexval(s[i]) * 16 + hexval(s[i + 1]));
    i += 2;
  }
  return CUDA_SUCCESS;
}

EXPORT CUresult cuDeviceGetUuid_v2(CUuuid* u, CUdevice d) {
  return cuDeviceGetUuid(u, d);
}

EXPORT CUresult cuDevicePrimaryCtxRetain(CUcontext* pctx, CUdevice d) {
  Lock l;
  count("cuDevicePrimaryCtxRetain");
  if (d < 0 || d >= (int)g_cards.size()) return CUDA_ERROR_INVALID_DEVICE;
  if (!g_cards[d].ctx) {
    if (g_cards[d].used + g_ctx_bytes > g_cards[d].total)
      return CUDA_ERROR_OUT_OF_MEMORY;
    g_cards[d].used += g_ctx_bytes;
    g_cards[d].ctx = true;
  }
  g_ctx[d].dev = d;
  *pctx = (CUcontext)&g_ctx[d];
  return CUDA_SUCCESS;
}

EXPORT CUresult cuCtxSetCurrent(CUcontext ctx) {
  t_current = ctx ? ((Ctx*)ctx)->dev : -1;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuCtxGetCurrent(CUcontext* ctx) {
  *ctx = t_current < 0 ? nullptr : (CUcontext)&g_ctx[t_current];
  return CUDA_SUCCESS;
}

EXPORT CUresult cuCtxGetDevice(CUdevice* d) {
  if (t_current < 0) return CUDA_ERROR_INVALID_CONTEXT;
  *d = t_current;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuMemAlloc_v2(CUdeviceptr* p, size_t bytes) {
  Lock l;
  count("cuMemAlloc_v2");
  return alloc(t_current, bytes, p);
}

EXPORT CUresult cuMemAllocPitch_v2(CUdeviceptr* p, size_t* pitch,
                                   size_t width, size_t height,
                                   unsigned int) {
  Lock l;
  count("cuMemAllocPitch_v2");
  *pitch = (width + 511) & ~(size_t)511;
  return alloc(t_current, (uint64_t)*pitch * height, p);
}

EXPORT CUresult cuMemAllocManaged(CUdeviceptr* p, size_t bytes,
                                  unsigned int) {
  Lock l;
  count("cuMemAllocManaged");
  return alloc(t_current, bytes, p);
}

#define MOCK_ALLOC_ASYNC(name)                                        \
  EXPORT CUresult name(CUdeviceptr* p, size_t bytes, CUstream) {      \
    Lock l;                                                           \
    count(#name);                                                     \
    return alloc(t_current, bytes, p);                                \
  }
MOCK_ALLOC_ASYNC(cuMemAllocAsync)
MOCK_ALLOC_ASYNC(cuMemAllocAsync_ptsz)

#define MOCK_ALLOC_POOL(name)                                               \
  EXPORT CUresult name(CUdeviceptr* p, size_t bytes, CUmemoryPool, CUstream) { \
    Lock l;                                                                 \
    count(#name);                                                           \
    return alloc(t_current, bytes, p);                                      \
  }
MOCK_ALLOC_POOL(cuMemAllocFromPoolAsync)
MOCK_ALLOC_POOL(cuMemAllocFromPoolAsync_ptsz)

EXPORT CUresult cuMemCreate(CUmemGenericAllocationHandle* h, size_t bytes,
                            const CUmemAllocationProp* prop,
                            unsigned long long) {
  Lock l;
  count("cuMemCreate");
  int dev = prop->location.id;
  if (dev < 0 || dev >= (int)g_cards.size()) return CUDA_ERROR_INVALID_DEVICE;
  if (g_cards[dev].used + bytes > g_cards[dev].total)
    return CUDA_ERROR_OUT_OF_MEMORY;
  g_cards[dev].used += bytes;
  *h = g_next_handle++;
  g_handles[*h] = {bytes, dev};
  return CUDA_SUCCESS;
}

EXPORT CUresult cuMemRelease(CUmemGenericAllocationHandle h) {
  Lock l;
  count("cuMemRelease");
  auto it = g_handles.find(h);
  if (it == g_handles.end()) return CUDA_ERROR_INVALID_VALUE;
  g_cards[it->second.second].used -= it->second.first;
  g_handles.erase(it);
  return CUDA_SUCCESS;
}

EXPORT CUresult cuMemFree_v2(CUdeviceptr p) {
  Lock l;
  count("cuMemFree_v2");
  return release(p);
}

#define MOCK_FREE_ASYNC(name)                        \
  EXPORT CUresult name(CUdeviceptr p, CUstream) {    \
    Lock l;                                          \
    count(#name);                                    \
    return release(p);                               \
  }
MOCK_FREE_ASYNC(cuMemFreeAsync)
MOCK_FREE_ASYNC(cuMemFreeAsync_ptsz)

EXPORT CUresult cuMemGetInfo_v2(size_t* free_b, size_t* total_b) {
  Lock l;
  count("cuMemGetInfo_v2");
  if (t_current < 0) return CUDA_ERROR_INVALID_CONTEXT;
  const Card& c = g_cards[t_current];
  *free_b = c.total - c.used;
  *total_b = c.total;
  return CUDA_SUCCESS;
}

#define MOCK_LAUNCH(name)                                                \
  EXPORT CUresult name(CUfunction, unsigned int, unsigned int,          \
                       unsigned int, unsigned int, unsigned int,         \
                       unsigned int, unsigned int, CUstream, void**,     \
                       void**) {                                         \
    Lock l;                                                              \
    count(#name);                                                        \
    if (g_launch_error) return g_launch_error;                           \
    occupy(g_kernel_s);                                                  \
    return CUDA_SUCCESS;                                                 \
  }
MOCK_LAUNCH(cuLaunchKernel)
MOCK_LAUNCH(cuLaunchKernel_ptsz)

#define MOCK_LAUNCH_EX(name)                                                 \
  EXPORT CUresult name(const CUlaunchConfig*, CUfunction, void**, void**) { \
    Lock l;                                                                  \
    count(#name);                                                            \
    if (g_launch_error) return g_launch_error;                               \
    occupy(g_kernel_s);                                                      \
    return CUDA_SUCCESS;                                                     \
  }
MOCK_LAUNCH_EX(cuLaunchKernelEx)
MOCK_LAUNCH_EX(cuLaunchKernelEx_ptsz)

#define MOCK_LAUNCH_COOP(name)                                           \
  EXPORT CUresult name(CUfunction, unsigned int, unsigned int,          \
                       unsigned int, unsigned int, unsigned int,         \
                       unsigned int, unsigned int, CUstream, void**) {   \
    Lock l;                                                              \
    count(#name);                                                        \
    if (g_launch_error) return g_launch_error;                           \
    occupy(g_kernel_s);                                                  \
    return CUDA_SUCCESS;                                                 \
  }
MOCK_LAUNCH_COOP(cuLaunchCooperativeKernel)
MOCK_LAUNCH_COOP(cuLaunchCooperativeKernel_ptsz)

#define MOCK_GRAPH(name)                                \
  EXPORT CUresult name(CUgraphExec, CUstream) {         \
    Lock l;                                             \
    count(#name);                                       \
    if (g_launch_error) return g_launch_error;          \
    occupy(g_graph_s);                                  \
    return CUDA_SUCCESS;                                \
  }
MOCK_GRAPH(cuGraphLaunch)
MOCK_GRAPH(cuGraphLaunch_ptsz)

typedef struct CUmod_st* CUmodule;
char g_module;

EXPORT CUresult cuModuleLoadData(CUmodule* mod, const void*) {
  *mod = (CUmodule)&g_module;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuModuleGetFunction(CUfunction* fn, CUmodule, const char*) {
  *fn = (CUfunction)&g_module;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuCtxSynchronize(void) {
  for (;;) {
    double until;
    {
      Lock l;
      until = t_current < 0 ? 0 : g_cards[t_current].free_at;
    }
    if (now_s() >= until) return CUDA_SUCCESS;
    struct timespec ts = {0, 100000};
    nanosleep(&ts, nullptr);
  }
}

EXPORT void vtpu_mock_cuda_capture(int on) { g_capturing = on; }

/* from now on, launches (where "launch") or completed events' queries
 * (where "event") return `code` (0: success again) */
EXPORT void vtpu_mock_cuda_error(const char* where, int code) {
  Lock l;
  (strcmp(where, "launch") == 0 ? g_launch_error : g_event_error) =
      (CUresult)code;
}

EXPORT CUresult cuStreamIsCapturing(CUstream, int* status) {
  *status = g_capturing;
  return CUDA_SUCCESS;
}

#define MOCK_BEGIN_CAPTURE(name, params)  \
  EXPORT CUresult name params {           \
    Lock l;                               \
    count(#name);                         \
    g_capturing = 1;                      \
    return CUDA_SUCCESS;                  \
  }
MOCK_BEGIN_CAPTURE(cuStreamBeginCapture, (CUstream))
MOCK_BEGIN_CAPTURE(cuStreamBeginCapture_ptsz, (CUstream))
MOCK_BEGIN_CAPTURE(cuStreamBeginCapture_v2, (CUstream, int))
MOCK_BEGIN_CAPTURE(cuStreamBeginCapture_v2_ptsz, (CUstream, int))

EXPORT CUresult cuStreamEndCapture(CUstream, void** graph) {
  Lock l;
  g_capturing = 0;
  *graph = nullptr;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuThreadExchangeStreamCaptureMode(int* mode) {
  Lock l;
  count("cuThreadExchangeStreamCaptureMode");
  *mode = 0;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuEventCreate(CUevent* ev, unsigned int) {
  *ev = (CUevent) new Event();
  return CUDA_SUCCESS;
}

EXPORT CUresult cuEventRecord(CUevent ev, CUstream) {
  Lock l;
  count(g_capturing ? "cuEventRecord_captured" : "cuEventRecord");
  double t = now_s();
  double busy_until = t_current < 0 ? t : g_cards[t_current].free_at;
  ((Event*)ev)->done_at = busy_until > t ? busy_until : t;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuEventRecord_ptsz(CUevent ev, CUstream s) {
  return cuEventRecord(ev, s);
}

EXPORT CUresult cuEventQuery(CUevent ev) {
  return now_s() >= ((Event*)ev)->done_at ? g_event_error
                                          : CUDA_ERROR_NOT_READY;
}

EXPORT CUresult cuEventDestroy_v2(CUevent ev) {
  {
    Lock l;
    count("cuEventDestroy_v2");
  }
  delete (Event*)ev;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuGetProcAddress_v2(const char* symbol, void** pfn,
                                    int version, cuuint64_t flags,
                                    CUdriverProcAddressQueryResult* status);

namespace {
struct Entry {
  const char* name;
  void* fn;
};
#define E(n) {#n, (void*)&n}
const Entry kEntries[] = {
    E(cuInit), E(cuDriverGetVersion), E(cuDeviceGetCount), E(cuDeviceGet),
    E(cuDeviceGetUuid), E(cuDeviceGetUuid_v2), E(cuDevicePrimaryCtxRetain),
    E(cuCtxSetCurrent), E(cuCtxGetCurrent), E(cuCtxGetDevice),
    E(cuMemAlloc_v2), E(cuMemAllocPitch_v2), E(cuMemAllocManaged),
    E(cuMemAllocAsync), E(cuMemAllocAsync_ptsz), E(cuMemAllocFromPoolAsync),
    E(cuMemAllocFromPoolAsync_ptsz), E(cuMemCreate), E(cuMemRelease),
    E(cuMemFree_v2), E(cuMemFreeAsync), E(cuMemFreeAsync_ptsz),
    E(cuMemGetInfo_v2), E(cuLaunchKernel), E(cuLaunchKernel_ptsz),
    E(cuLaunchKernelEx), E(cuLaunchKernelEx_ptsz),
    E(cuLaunchCooperativeKernel), E(cuLaunchCooperativeKernel_ptsz),
    E(cuGraphLaunch), E(cuGraphLaunch_ptsz), E(cuEventCreate),
    E(cuEventRecord), E(cuEventRecord_ptsz), E(cuEventQuery),
    E(cuEventDestroy_v2), E(cuGetProcAddress_v2), E(cuModuleLoadData),
    E(cuModuleGetFunction), E(cuCtxSynchronize), E(cuStreamIsCapturing),
    E(cuThreadExchangeStreamCaptureMode), E(cuStreamBeginCapture),
    E(cuStreamBeginCapture_ptsz), E(cuStreamBeginCapture_v2),
    E(cuStreamBeginCapture_v2_ptsz), E(cuStreamEndCapture),
};
#undef E

const char* const kV2[] = {"cuMemAlloc", "cuMemAllocPitch", "cuMemFree",
                           "cuMemGetInfo", "cuEventDestroy",
                           "cuStreamBeginCapture"};
const char* const kPtsz[] = {"cuMemAllocAsync", "cuMemAllocFromPoolAsync",
                             "cuMemFreeAsync", "cuLaunchKernel",
                             "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
                             "cuGraphLaunch", "cuEventRecord",
                             "cuStreamBeginCapture"};
}  // namespace

EXPORT CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                                 cuuint64_t flags);

EXPORT CUresult cuGetProcAddress_v2(const char* symbol, void** pfn,
                                    int version, cuuint64_t flags,
                                    CUdriverProcAddressQueryResult* status) {
  {
    Lock l;
    count("cuGetProcAddress_v2");
  }
  std::string name = symbol;
  for (const char* v2 : kV2)
    if (name == v2 && version >= 3020) name += "_v2";
  if (name == "cuGetProcAddress" && version >= 12000) name += "_v2";
  if (flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM)
    for (const char* p : kPtsz)
      if (std::string(symbol) == p) name += "_ptsz";
  if (name == "cuGetProcAddress") {
    *pfn = (void*)&cuGetProcAddress;
  } else {
    *pfn = nullptr;
    for (const Entry& e : kEntries)
      if (name == e.name) *pfn = e.fn;
  }
  if (status)
    *status = *pfn ? CU_GET_PROC_ADDRESS_SUCCESS
                   : CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND;
  return *pfn ? CUDA_SUCCESS : CUDA_ERROR_NOT_FOUND;
}

EXPORT CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                                 cuuint64_t flags) {
  return cuGetProcAddress_v2(symbol, pfn, version, flags, nullptr);
}

EXPORT unsigned long long vtpu_mock_cuda_calls(const char* name) {
  Lock l;
  auto it = g_calls.find(name);
  return it == g_calls.end() ? 0 : it->second;
}

EXPORT unsigned long long vtpu_mock_cuda_used(const char* uuid) {
  Lock l;
  for (const Card& c : g_cards)
    if (c.uuid == uuid) return c.used;
  return 0;
}
