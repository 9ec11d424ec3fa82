/* libvgpu_interpose.so — CUDA driver-API interposer that enforces a
 * tenant's device-memory and core quotas on an unmodified PyTorch (or any
 * CUDA) program, the role of the reference's LD_PRELOAD libvgpu.so
 * (SURVEY.md §2.5) and the CUDA twin of cpp/vtpu_shim.cc.
 *
 *   LD_PRELOAD=.../libvgpu_interpose.so python tenant.py
 *
 * Reaching the calls.  CUDA 12's runtime dlopens libcuda.so.1, takes
 * cuGetProcAddress_v2 from it with dlsym, and resolves every other entry
 * point through that, so a symbol only exported by a preload is never
 * called.  This library therefore exports dlsym itself (the real one is
 * taken with dlvsym(RTLD_NEXT, "dlsym", ...)): a lookup of a hooked name
 * hands back the wrapper, and the wrapped cuGetProcAddress(_v2) hands
 * back wrappers for every entry point it resolves.  Each (name, version,
 * flags) resolves to one ABI variant (the _v2 sizes, the _ptsz
 * per-thread-stream launches), and each variant has its own wrapper that
 * calls exactly that variant.  The hooked names are also exported, for
 * programs linked against libcuda directly.
 *
 * Config, read at the first driver call that needs it (the env ABI the
 * device plugin writes at Allocate, vtpu/plugin/server.py):
 *   family     VTPU_SHIM_FAMILY=tpu|pjrt, else TPU if
 *              TPU_DEVICE_MEMORY_LIMIT_0 is set, else PJRT (<P> below)
 *   <P>_DEVICE_MEMORY_LIMIT_<i>     quota of the i-th visible card, MiB
 *   <P>_DEVICE_CORES_LIMIT          percent of the card's time
 *   <P>_DEVICE_MEMORY_SHARED_CACHE  the shared-region file
 *   <P>_CORE_UTILIZATION_POLICY     default | force | disable
 *   <P>_TASK_PRIORITY               0 high / 1 low
 *   VTPU_PJRT_VISIBLE_UUIDS / VTPU_VISIBLE_UUIDS  the cards handed over;
 *              limit i belongs to the i-th UUID, matched against
 *              cuDeviceGetUuid, never by ordinal (ordinals renumber
 *              inside a container)
 *   VTPU_OVERSUBSCRIBE=true         admit past the quota
 *   VTPU_ACTIVE_OOM_KILLER=true     exit 137 instead of refusing
 *   VTPU_LOCK_DIR                   the node's lock directory (default
 *                                   /tmp/vtpulock, which the plugin
 *                                   mounts into every container)
 *
 * Memory.  Every allocation (cuMemAlloc_v2, cuMemAllocPitch_v2,
 * cuMemAllocManaged, cuMemAllocAsync, cuMemAllocFromPoolAsync, and
 * cuMemCreate, which PyTorch's expandable segments use) is checked and
 * accounted in this process's region slot under the region's lock, which
 * is held across the driver's own allocation: two processes racing for
 * the last bytes cannot both pass.  Past the quota the call returns
 * CUDA_ERROR_OUT_OF_MEMORY, which PyTorch's caching allocator raises as
 * torch.OutOfMemoryError.  Frees return the bytes.  cuMemGetInfo_v2
 * reports (quota - used, quota), and so do NVML's memory queries for the
 * tenant's cards (nvmlDeviceGetMemoryInfo and _v2, exported and handed
 * out by dlsym).  The primary context's own memory is
 * charged once per card, as program bytes, at cuDevicePrimaryCtxRetain
 * (the reference's contextSize): NVML's count for this process
 * (context_charge), contexts being created one at a time on the node.  A stream-ordered pool keeps freed
 * memory cached inside the driver; that cache is not charged, so a
 * tenant should keep PyTorch's native allocator (PYTORCH_CUDA_ALLOC_CONF
 * without backend:cudaMallocAsync).
 *
 * Compute.  cuLaunchKernel, cuLaunchKernelEx, cuLaunchCooperativeKernel
 * and cuGraphLaunch (each with its _ptsz variant) are paced towards the
 * core quota by the rule of pace.h: the tenant's device-resident share
 * of the wall clock, from completion events, not the reference's sleep
 * before each launch.  A disable-timing event closes a batch of launches
 * on one stream every kEventEvery launches and after every graph launch;
 * one watcher thread polls the events, publishes each batch's busy time
 * and launches to the region, and closes a batch whose stream has been
 * quiet for kStaleS, so that a host pause never counts as device time.
 * The region's utilization_switch suspends or squeezes the quota as it
 * does for the native shim.  A launch into a stream that is being
 * captured into a CUDA graph runs later, inside the graph: it is neither
 * paced nor followed by an event.  A stream's open batch is closed
 * before it begins a capture, and the watcher runs in the relaxed capture
 * mode, so it never records into a capture nor invalidates one.
 *
 * Health.  Each launch's return code and each batch's event outcome feed
 * the region's error streak (vtpu_region_exec_result), the XID-analog
 * stream the device plugin's health check reads: a success clears it,
 * a device-side failure (device_side_error) extends it, and a tenant's
 * own fault (an illegal address, a device-side assert) leaves it alone.
 *
 * Lifetime.  Everything initialises lazily at the first driver call;
 * a child after fork() starts afresh (its own slot, at its own first
 * call); a clean exit frees the slot, and a killed tenant's slot is
 * reclaimed by the next tenant's init (reap of dead pids, as the
 * reference's clear_proc_slot_nolock does). */
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <strings.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <deque>
#include <unordered_map>
#include <vector>

#include "cuda_min.h"
#include "pace.h"
#include "shared_region.h"

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

/* ------------------------------------------------------------------ */
/* the hooked entry points                                             */
/* ------------------------------------------------------------------ */
#define VGPU_HOOKS(X)                                                      \
  X(cuDevicePrimaryCtxRetain) X(cuMemAlloc_v2) X(cuMemAllocPitch_v2)       \
  X(cuMemAllocManaged) X(cuMemAllocAsync) X(cuMemAllocAsync_ptsz)          \
  X(cuMemAllocFromPoolAsync) X(cuMemAllocFromPoolAsync_ptsz) X(cuMemCreate) \
  X(cuMemFree_v2) X(cuMemFreeAsync) X(cuMemFreeAsync_ptsz) X(cuMemRelease) \
  X(cuMemGetInfo_v2) X(cuLaunchKernel) X(cuLaunchKernel_ptsz)              \
  X(cuLaunchKernelEx) X(cuLaunchKernelEx_ptsz) X(cuLaunchCooperativeKernel) \
  X(cuLaunchCooperativeKernel_ptsz) X(cuGraphLaunch) X(cuGraphLaunch_ptsz) \
  X(cuStreamBeginCapture) X(cuStreamBeginCapture_ptsz)                     \
  X(cuStreamBeginCapture_v2) X(cuStreamBeginCapture_v2_ptsz)               \
  X(cuGetProcAddress) X(cuGetProcAddress_v2)

enum HookId {
#define X(n) H_##n,
  VGPU_HOOKS(X)
#undef X
  H_COUNT
};

const char* const kHookNames[H_COUNT] = {
#define X(n) #n,
    VGPU_HOOKS(X)
#undef X
};

/* names that take a _v2 ABI, and the cudaVersion it starts at */
const struct {
  const char* name;
  int since;
} kV2[] = {{"cuMemAlloc", 3020},      {"cuMemAllocPitch", 3020},
           {"cuMemFree", 3020},       {"cuMemGetInfo", 3020},
           {"cuStreamBeginCapture", 10010}, {"cuGetProcAddress", 12000}};
/* names with a per-thread default-stream variant */
const char* const kPtsz[] = {"cuMemAllocAsync", "cuMemAllocFromPoolAsync",
                             "cuMemFreeAsync",  "cuLaunchKernel",
                             "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
                             "cuGraphLaunch",   "cuStreamBeginCapture"};

void* g_real[H_COUNT];   /* libcuda's implementation of each variant */
void* g_wrap[H_COUNT];   /* our wrapper of each variant */

/* the driver calls the interposer makes itself */
struct Driver {
  PFN_cuDeviceGetCount DeviceGetCount;
  PFN_cuDeviceGet DeviceGet;
  PFN_cuDeviceGetUuid DeviceGetUuid;
  PFN_cuCtxGetCurrent CtxGetCurrent;
  PFN_cuCtxSetCurrent CtxSetCurrent;
  PFN_cuCtxGetDevice CtxGetDevice;
  PFN_cuEventCreate EventCreate;
  PFN_cuEventRecord EventRecord;
  PFN_cuEventQuery EventQuery;
  PFN_cuEventDestroy EventDestroy;
  PFN_cuStreamIsCapturing StreamIsCapturing;
  PFN_cuThreadExchangeStreamCaptureMode ExchangeCaptureMode;
} g_drv;

typedef void* (*dlsym_fn)(void*, const char*);
std::atomic<dlsym_fn> g_real_dlsym{nullptr};

dlsym_fn real_dlsym() {
  dlsym_fn f = g_real_dlsym.load(std::memory_order_acquire);
  if (f) return f;
  /* glibc >= 2.34 keeps dlsym in libc under GLIBC_2.34; older ones in
   * libdl under GLIBC_2.2.5.  dlvsym is not hooked, so this cannot
   * recurse into our own dlsym. */
  void* p = dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.34");
  if (!p) p = dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.2.5");
  if (!p) {
    fprintf(stderr, "vgpu_interpose: cannot find the real dlsym\n");
    abort();
  }
  f = (dlsym_fn)p;
  g_real_dlsym.store(f, std::memory_order_release);
  return f;
}

int hook_index(const char* name) {
  for (int k = 0; k < H_COUNT; k++)
    if (strcmp(name, kHookNames[k]) == 0) return k;
  return -1;
}

pthread_once_t g_table_once = PTHREAD_ONCE_INIT;
void* g_cuda = nullptr;
/* the handle a dlsym of a hooked name was made on: the driver library,
 * if it was loaded under another name than libcuda.so.1 */
void* g_hint = nullptr;

void fill_wrappers(); /* after the wrappers, at the end */

void load_table() {
  fill_wrappers();
  g_cuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
  if (!g_cuda && g_hint != RTLD_DEFAULT && g_hint != RTLD_NEXT)
    g_cuda = g_hint;
  if (!g_cuda) g_cuda = dlopen("libcuda.so.1", RTLD_NOW);
  if (!g_cuda) {
    fprintf(stderr, "vgpu_interpose: cannot load libcuda.so.1: %s\n",
            dlerror());
    return;
  }
  dlsym_fn sym = real_dlsym();
  for (int k = 0; k < H_COUNT; k++) g_real[k] = sym(g_cuda, kHookNames[k]);
#define D(field, name) g_drv.field = (decltype(g_drv.field))sym(g_cuda, name)
  D(DeviceGetCount, "cuDeviceGetCount");
  D(DeviceGet, "cuDeviceGet");
  D(DeviceGetUuid, "cuDeviceGetUuid");
  D(CtxGetCurrent, "cuCtxGetCurrent");
  D(CtxSetCurrent, "cuCtxSetCurrent");
  D(CtxGetDevice, "cuCtxGetDevice");
  D(EventCreate, "cuEventCreate");
  D(EventRecord, "cuEventRecord");
  D(EventQuery, "cuEventQuery");
  D(EventDestroy, "cuEventDestroy_v2");
  D(StreamIsCapturing, "cuStreamIsCapturing");
  D(ExchangeCaptureMode, "cuThreadExchangeStreamCaptureMode");
#undef D
}

void ensure_table() { pthread_once(&g_table_once, load_table); }

#define REAL(name) ((PFN_##name##_t)g_real[H_##name])

/* the variant of `symbol` that cuGetProcAddress resolves for (version,
 * flags), as the driver picks it; -1 when it is not a hooked one */
int variant_of(const char* symbol, int version, cuuint64_t flags) {
  char name[96];
  snprintf(name, sizeof(name), "%s", symbol);
  for (const auto& v2 : kV2)
    if (strcmp(symbol, v2.name) == 0 && version >= v2.since)
      snprintf(name, sizeof(name), "%s_v2", symbol);
  /* the 32-bit memory ABIs before 3.2 are not hooked */
  if (version < 3020 && strncmp(symbol, "cuMem", 5) == 0) return -1;
  if (flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM)
    for (const char* p : kPtsz)
      if (strcmp(symbol, p) == 0) {
        size_t len = strlen(name);
        snprintf(name + len, sizeof(name) - len, "_ptsz");
      }
  return hook_index(name);
}

/* a pointer cuGetProcAddress resolved for `symbol`: our wrapper of its
 * variant, keeping the driver's pointer as that variant's real one */
void* wrap_resolved(const char* symbol, int version, cuuint64_t flags,
                    void* p) {
  if (!p || !symbol) return p;
  int k = variant_of(symbol, version, flags);
  if (k < 0) {
    for (int j = 0; j < H_COUNT; j++)
      if (g_real[j] == p) return g_wrap[j];
    return p;
  }
  if (g_real[k] == nullptr) g_real[k] = p;
  return g_wrap[k];
}

/* ------------------------------------------------------------------ */
/* config and tenant state                                             */
/* ------------------------------------------------------------------ */
struct Config {
  uint64_t limit_bytes[VTPU_MAX_DEVICES];
  int core_limit;
  int policy; /* 0 default, 1 force, 2 disable */
  int priority;
  int oversubscribe;
  int oom_killer;
  char prefix[8];
  char region_path[512];
  int n_visible;
  char visible[VTPU_MAX_DEVICES][VTPU_UUID_LEN];
};

Config g_cfg;
vtpu_shared_region* g_region = nullptr;
int g_slot = -1;
std::atomic<int> g_ready{0};
pthread_mutex_t g_init_mu = PTHREAD_MUTEX_INITIALIZER;
const int kMaxOrdinals = 64;
int g_dev_index[kMaxOrdinals]; /* CUdevice ordinal -> region index, -1 */
int g_n_ordinals = 0;
int g_ctx_charged[VTPU_MAX_DEVICES];

const char* env(const char* prefix, const char* suffix, char* key,
                size_t n) {
  snprintf(key, n, "%s%s", prefix, suffix);
  return getenv(key);
}

void load_config() {
  memset(&g_cfg, 0, sizeof(g_cfg));
  const char* fam = getenv("VTPU_SHIM_FAMILY");
  const char* pfx;
  if (fam && strcasecmp(fam, "pjrt") == 0)
    pfx = "PJRT";
  else if (fam && strcasecmp(fam, "tpu") == 0)
    pfx = "TPU";
  else
    pfx = getenv("TPU_DEVICE_MEMORY_LIMIT_0") ? "TPU" : "PJRT";
  snprintf(g_cfg.prefix, sizeof(g_cfg.prefix), "%s", pfx);
  char key[96];
  for (int i = 0; i < VTPU_MAX_DEVICES; i++) {
    char suffix[48];
    snprintf(suffix, sizeof(suffix), "_DEVICE_MEMORY_LIMIT_%d", i);
    const char* v = env(pfx, suffix, key, sizeof(key));
    if (v) g_cfg.limit_bytes[i] = strtoull(v, nullptr, 10) << 20;
  }
  const char* c = env(pfx, "_DEVICE_CORES_LIMIT", key, sizeof(key));
  g_cfg.core_limit = c ? atoi(c) : 100;
  const char* pol = env(pfx, "_CORE_UTILIZATION_POLICY", key, sizeof(key));
  g_cfg.policy = (pol && strcmp(pol, "force") == 0)     ? 1
                 : (pol && strcmp(pol, "disable") == 0) ? 2
                                                        : 0;
  const char* pr = env(pfx, "_TASK_PRIORITY", key, sizeof(key));
  g_cfg.priority = pr ? atoi(pr) : 0;
  const char* o = getenv("VTPU_OVERSUBSCRIBE");
  g_cfg.oversubscribe = o && strcmp(o, "true") == 0;
  const char* k = getenv("VTPU_ACTIVE_OOM_KILLER");
  g_cfg.oom_killer = k && strcmp(k, "true") == 0;
  const char* path = env(pfx, "_DEVICE_MEMORY_SHARED_CACHE", key, sizeof(key));
  snprintf(g_cfg.region_path, sizeof(g_cfg.region_path), "%s",
           path ? path : "/tmp/vtpu/vtpu.cache");
  /* family-scoped lookup order, as cpp/vtpu_shim.cc has it */
  int pjrt = strcmp(pfx, "PJRT") == 0;
  const char* vis = getenv(pjrt ? "VTPU_PJRT_VISIBLE_UUIDS"
                                : "VTPU_VISIBLE_UUIDS");
  if (!vis)
    vis = getenv(pjrt ? "VTPU_VISIBLE_UUIDS" : "VTPU_PJRT_VISIBLE_UUIDS");
  if (vis) {
    char tmp[VTPU_MAX_DEVICES * VTPU_UUID_LEN];
    snprintf(tmp, sizeof(tmp), "%s", vis);
    char* save = nullptr;
    for (char* tok = strtok_r(tmp, ",", &save);
         tok && g_cfg.n_visible < VTPU_MAX_DEVICES;
         tok = strtok_r(nullptr, ",", &save))
      snprintf(g_cfg.visible[g_cfg.n_visible++], VTPU_UUID_LEN, "%s", tok);
  }
}

/* the region file of the config, its directory made if missing (a
 * missing mount must not turn enforcement off) */
vtpu_shared_region* open_region_file() {
  char dir[512];
  snprintf(dir, sizeof(dir), "%s", g_cfg.region_path);
  char* slash = strrchr(dir, '/');
  if (slash && slash != dir) {
    *slash = 0;
    mkdir(dir, 0777);
  }
  return vtpu_region_open(g_cfg.region_path);
}

/* the node's context lock: a file in VTPU_LOCK_DIR (default the
 * /tmp/vtpulock directory the device plugin mounts into every
 * container); -1 where it cannot be opened, and contexts are then
 * created unserialised */
int open_node_lock() {
  const char* dir = getenv("VTPU_LOCK_DIR");
  if (!dir || !*dir) dir = "/tmp/vtpulock";
  mkdir(dir, 0777);
  char path[512];
  snprintf(path, sizeof(path), "%s/context.lock", dir);
  return open(path, O_RDWR | O_CREAT | O_CLOEXEC, 0666);
}

/* NVML's spelling of a card's UUID */
void format_uuid(const CUuuid& u, char* out, size_t n) {
  const unsigned char* b = (const unsigned char*)u.bytes;
  snprintf(out, n,
           "GPU-%02x%02x%02x%02x-%02x%02x-%02x%02x-%02x%02x-"
           "%02x%02x%02x%02x%02x%02x",
           b[0], b[1], b[2], b[3], b[4], b[5], b[6], b[7], b[8], b[9], b[10],
           b[11], b[12], b[13], b[14], b[15]);
}

char g_ordinal_uuid[kMaxOrdinals][VTPU_UUID_LEN];

void atfork_child();

/* the tenant's region slot and card map; false when the driver is not
 * initialised yet (the caller forwards and we try again later) */
bool init_tenant() {
  if (g_ready.load(std::memory_order_acquire)) return true;
  pthread_mutex_lock(&g_init_mu);
  if (g_ready.load(std::memory_order_relaxed)) {
    pthread_mutex_unlock(&g_init_mu);
    return true;
  }
  ensure_table();
  int count = 0;
  if (!g_drv.DeviceGetCount || g_drv.DeviceGetCount(&count) != CUDA_SUCCESS) {
    pthread_mutex_unlock(&g_init_mu);
    return false;
  }
  load_config();
  g_n_ordinals = count < kMaxOrdinals ? count : kMaxOrdinals;
  char uuids[VTPU_MAX_DEVICES][VTPU_UUID_LEN];
  memset(uuids, 0, sizeof(uuids));
  int n = g_cfg.n_visible;
  for (int i = 0; i < n; i++)
    snprintf(uuids[i], VTPU_UUID_LEN, "%s", g_cfg.visible[i]);
  for (int d = 0; d < g_n_ordinals; d++) {
    g_dev_index[d] = -1;
    CUdevice dev;
    CUuuid u;
    if (g_drv.DeviceGet(&dev, d) != CUDA_SUCCESS ||
        g_drv.DeviceGetUuid(&u, dev) != CUDA_SUCCESS)
      continue;
    format_uuid(u, g_ordinal_uuid[d], VTPU_UUID_LEN);
    if (g_cfg.n_visible == 0) {
      /* nothing handed over by name: the cards in ordinal order */
      if (d < VTPU_MAX_DEVICES) {
        g_dev_index[d] = d;
        memcpy(uuids[d], g_ordinal_uuid[d], VTPU_UUID_LEN);
        n = d + 1;
      }
      continue;
    }
    for (int i = 0; i < g_cfg.n_visible; i++)
      if (strcmp(g_cfg.visible[i], g_ordinal_uuid[d]) == 0)
        g_dev_index[d] = i;
  }
  g_region = open_region_file();
  if (!g_region) {
    fprintf(stderr,
            "vgpu_interpose: cannot open the shared region %s: every "
            "allocation is refused\n",
            g_cfg.region_path);
  } else {
    int32_t cores[VTPU_MAX_DEVICES];
    for (int i = 0; i < VTPU_MAX_DEVICES; i++) cores[i] = g_cfg.core_limit;
    if (vtpu_region_set_devices(g_region, n, uuids, g_cfg.limit_bytes,
                                cores) != 0)
      fprintf(stderr, "vgpu_interpose: region %s holds another card count\n",
              g_cfg.region_path);
    /* a dead predecessor whose pid was recycled to us must not hand us
     * its usage; then free the slots of tenants that died */
    g_slot = vtpu_region_register_proc_fresh(g_region, (int32_t)getpid(),
                                             g_cfg.priority);
    vtpu_region_reap_dead(g_region);
    if (g_slot < 0)
      fprintf(stderr, "vgpu_interpose: no free slot in %s\n",
              g_cfg.region_path);
  }
  static bool atfork_registered = false;
  if (!atfork_registered) {
    pthread_atfork(nullptr, nullptr, atfork_child);
    atfork_registered = true;
  }
  g_ready.store(1, std::memory_order_release);
  pthread_mutex_unlock(&g_init_mu);
  return true;
}

bool governed() { return g_region != nullptr && g_slot >= 0; }

int index_of_ordinal(int ordinal) {
  if (ordinal < 0 || ordinal >= g_n_ordinals) return -1;
  return g_dev_index[ordinal];
}

/* the region index of the current context's card; -1 when the card was
 * not handed to this tenant, -2 without a current context */
int current_index() {
  CUdevice d;
  if (!g_drv.CtxGetDevice || g_drv.CtxGetDevice(&d) != CUDA_SUCCESS)
    return -2;
  return index_of_ordinal(d);
}

/* ------------------------------------------------------------------ */
/* memory                                                              */
/* ------------------------------------------------------------------ */
struct Rec {
  uint64_t bytes;
  int index;
};
std::unordered_map<CUdeviceptr, Rec>* g_ptrs = nullptr;
std::unordered_map<CUmemGenericAllocationHandle, Rec>* g_handles = nullptr;
pthread_mutex_t g_map_mu = PTHREAD_MUTEX_INITIALIZER;
CUresult quota_reject(int index, uint64_t want) {
  if (g_cfg.oom_killer) {
    fprintf(stderr,
            "vgpu_interpose: ACTIVE_OOM_KILLER: card %d quota %llu B "
            "exceeded (want %llu B), exiting 137\n",
            index, (unsigned long long)g_cfg.limit_bytes[index],
            (unsigned long long)want);
    fflush(stderr);
    _exit(137);
  }
  return CUDA_ERROR_OUT_OF_MEMORY;
}

/* Check, allocate, account, under the region lock.  `call(&rc)` runs the
 * driver's allocation and returns the bytes it really took (a pitched
 * allocation learns them from the driver); `undo()` frees it again when
 * those bytes turn out to pass the quota. */
template <class F, class U>
CUresult guarded_alloc(int index, uint64_t want, F&& call, U&& undo,
                       uint64_t* taken_out) {
  *taken_out = 0;
  if (!governed()) return CUDA_ERROR_NOT_INITIALIZED;
  if (index < 0) return CUDA_ERROR_INVALID_DEVICE;
  vtpu_region_lock(g_region);
  uint64_t limit = g_cfg.limit_bytes[index];
  bool check = limit > 0 && !g_cfg.oversubscribe;
  if (check && vtpu_region_device_usage_nolock(g_region, index) + want >
                   limit) {
    vtpu_region_unlock(g_region);
    return quota_reject(index, want);
  }
  CUresult rc = CUDA_SUCCESS;
  uint64_t taken = call(&rc);
  if (rc == CUDA_SUCCESS && taken > want && check &&
      vtpu_region_device_usage_nolock(g_region, index) + taken > limit) {
    undo();
    vtpu_region_unlock(g_region);
    return quota_reject(index, taken);
  }
  if (rc == CUDA_SUCCESS)
    vtpu_region_add_nolock(g_region, g_slot, index, 0, taken);
  vtpu_region_unlock(g_region);
  if (rc == CUDA_SUCCESS) *taken_out = taken;
  return rc;
}

void remember_ptr(CUdeviceptr p, uint64_t bytes, int index) {
  pthread_mutex_lock(&g_map_mu);
  if (!g_ptrs) g_ptrs = new std::unordered_map<CUdeviceptr, Rec>();
  (*g_ptrs)[p] = Rec{bytes, index};
  pthread_mutex_unlock(&g_map_mu);
}

void forget_ptr(CUdeviceptr p) {
  Rec r{0, -1};
  pthread_mutex_lock(&g_map_mu);
  if (g_ptrs) {
    auto it = g_ptrs->find(p);
    if (it != g_ptrs->end()) {
      r = it->second;
      g_ptrs->erase(it);
    }
  }
  pthread_mutex_unlock(&g_map_mu);
  if (r.index >= 0 && governed())
    vtpu_region_sub(g_region, (int32_t)getpid(), r.index, 0, r.bytes);
}

void no_undo() {}

/* an allocation that returns a device pointer, on the current context */
template <class F, class U>
CUresult alloc_ptr(CUdeviceptr* dptr, uint64_t want, F&& call, U&& undo) {
  if (!init_tenant()) return CUDA_ERROR_NOT_INITIALIZED;
  int index = current_index();
  if (index == -2) return CUDA_ERROR_INVALID_CONTEXT;
  uint64_t taken = 0;
  CUresult rc = guarded_alloc(index, want, call, undo, &taken);
  if (rc == CUDA_SUCCESS)
    remember_ptr(*dptr, taken, index);
  return rc;
}

/* NVML, for the context charge: the card's used bytes and its
 * processes' (nvmlProcessInfo_t, as nvmlDeviceGetComputeRunningProcesses_v3
 * fills it) */
struct NvmlProc {
  unsigned int pid;
  unsigned long long used;
  unsigned int gpu_instance, compute_instance;
};
const unsigned kMaxNvmlProcs = 256;

/* nvmlMemory_v2_t */
struct NvmlMemoryV2 {
  unsigned int version;
  unsigned long long total, reserved, free, used;
};

struct Nvml {
  int (*Init)(void);
  int (*GetHandleByUUID)(const char*, void**);
  int (*GetUUID)(void*, char*, unsigned int);
  int (*GetMemoryInfo)(void*, unsigned long long*);
  int (*GetMemoryInfoV2)(void*, NvmlMemoryV2*);
  int (*GetProcs)(void*, unsigned int*, NvmlProc*);
  bool ok;
} g_nvml;
pthread_once_t g_nvml_once = PTHREAD_ONCE_INIT;

void load_nvml() {
  void* h = dlopen("libnvidia-ml.so.1", RTLD_NOW);
  dlsym_fn sym = real_dlsym();
  if (h) {
    g_nvml.Init = (int (*)(void))sym(h, "nvmlInit_v2");
    g_nvml.GetHandleByUUID =
        (int (*)(const char*, void**))sym(h, "nvmlDeviceGetHandleByUUID");
    g_nvml.GetUUID =
        (int (*)(void*, char*, unsigned int))sym(h, "nvmlDeviceGetUUID");
    g_nvml.GetMemoryInfo = (int (*)(void*, unsigned long long*))sym(
        h, "nvmlDeviceGetMemoryInfo");
    g_nvml.GetMemoryInfoV2 = (int (*)(void*, NvmlMemoryV2*))sym(
        h, "nvmlDeviceGetMemoryInfo_v2");
    g_nvml.GetProcs = (int (*)(void*, unsigned int*, NvmlProc*))sym(
        h, "nvmlDeviceGetComputeRunningProcesses_v3");
  }
  g_nvml.ok = h && g_nvml.Init && g_nvml.GetHandleByUUID &&
              g_nvml.GetMemoryInfo && g_nvml.Init() == 0;
  if (!g_nvml.ok)
    fprintf(stderr,
            "vgpu_interpose: NVML unavailable: the contexts' memory is not "
            "charged\n");
}

/* NVML's memory queries answered with the quota (the reference does the
 * same, so that nvidia-smi in the container shows it): a card handed to
 * this tenant by UUID, with a quota, reports (quota, what the region
 * holds on it, the difference).  It needs no CUDA: nvidia-smi makes no
 * driver call, so the config and the region are read here if the
 * tenant has not initialised them yet. */
vtpu_shared_region* g_view_region = nullptr;
pthread_once_t g_view_once = PTHREAD_ONCE_INIT;

void open_view() {
  pthread_mutex_lock(&g_init_mu);
  if (!g_ready.load()) load_config();
  pthread_mutex_unlock(&g_init_mu);
  if (g_cfg.n_visible > 0) g_view_region = open_region_file();
}

bool quota_view(void* dev, uint64_t* total, uint64_t* used) {
  char uuid[96];
  if (!g_nvml.GetUUID || g_nvml.GetUUID(dev, uuid, sizeof(uuid)) != 0)
    return false;
  pthread_once(&g_view_once, open_view);
  vtpu_shared_region* r = g_region ? g_region : g_view_region;
  for (int i = 0; r && i < g_cfg.n_visible; i++)
    if (strcmp(g_cfg.visible[i], uuid) == 0 && g_cfg.limit_bytes[i]) {
      *total = g_cfg.limit_bytes[i];
      *used = vtpu_region_device_usage(r, i);
      if (*used > *total) *used = *total;
      return true;
    }
  return false;
}

/* what NVML shows of one card: its used bytes, and the processes on it
 * with their used bytes (n = -1 where NVML lists none) */
struct CardView {
  bool ok;
  uint64_t used;
  int n;
  NvmlProc procs[kMaxNvmlProcs];
};

void nvml_view(const char* uuid, CardView* v) {
  v->ok = false;
  v->n = -1;
  pthread_once(&g_nvml_once, load_nvml);
  void* h = nullptr;
  unsigned long long mem[3]; /* nvmlMemory_t: total, free, used */
  if (!g_nvml.ok || g_nvml.GetHandleByUUID(uuid, &h) != 0 ||
      g_nvml.GetMemoryInfo(h, mem) != 0)
    return;
  v->ok = true;
  v->used = mem[2];
  unsigned int n = kMaxNvmlProcs;
  if (g_nvml.GetProcs && g_nvml.GetProcs(h, &n, v->procs) == 0)
    v->n = (int)n;
}

/* The memory a context just created on a card took: NVML's own count
 * for this process (its growth across the creation), found by its pid,
 * or, where a pid namespace hides
 * the pid, as the one process that appeared on the card across the
 * creation (contexts are created one at a time on the node, see
 * cuDevicePrimaryCtxRetain).  Where NVML lists no processes, the card's
 * used bytes after less before, which also holds whatever other
 * processes allocated meanwhile. */
uint64_t context_charge(const CardView& before, const CardView& after,
                        unsigned int pid) {
  if (before.n >= 0 && after.n >= 0) {
    for (int i = 0; i < after.n; i++) {
      if (after.procs[i].pid != pid) continue;
      unsigned long long had = 0; /* what this process held before */
      for (int j = 0; j < before.n; j++)
        if (before.procs[j].pid == pid) had = before.procs[j].used;
      return after.procs[i].used > had ? after.procs[i].used - had : 0;
    }
    const NvmlProc* fresh = nullptr;
    int appeared = 0;
    for (int i = 0; i < after.n; i++) {
      bool seen = false;
      for (int j = 0; j < before.n && !seen; j++)
        seen = before.procs[j].pid == after.procs[i].pid;
      if (!seen) {
        fresh = &after.procs[i];
        appeared++;
      }
    }
    if (appeared == 1) return fresh->used;
  }
  if (before.ok && after.ok && after.used > before.used)
    return after.used - before.used;
  return 0;
}

/* ------------------------------------------------------------------ */
/* compute: pacing and the completion watcher                          */
/* ------------------------------------------------------------------ */
const uint32_t kEventEvery = 32; /* launches between two events */
const double kPollS = 100e-6;    /* the watcher's poll interval */
/* a batch whose stream saw no launch for this long is closed by the
 * watcher: a host pause (setup, a synchronize, idle time) must not be
 * counted as device-resident time of the batch it interrupts */
const double kStaleS = 1e-3;

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

void sleep_s(double s) {
  struct timespec ts;
  ts.tv_sec = (time_t)s;
  ts.tv_nsec = (long)((s - (double)ts.tv_sec) * 1e9);
  while (nanosleep(&ts, &ts) != 0 && errno == EINTR) {
  }
}

struct Pending {
  CUevent ev;
  CUcontext ctx;
  double t_submit;
  int index;
  uint32_t launches;
};
struct Batch {
  CUstream stream;
  CUcontext ctx;
  int index;
  uint32_t n;
  double t_first, t_last;
};

pthread_mutex_t g_ev_mu = PTHREAD_MUTEX_INITIALIZER;
pthread_cond_t g_ev_cv = PTHREAD_COND_INITIALIZER;
std::deque<Pending>* g_pending = nullptr;
std::vector<Batch>* g_batches = nullptr;
std::vector<std::pair<CUcontext, CUevent>>* g_free_events = nullptr;
pthread_t g_watcher;
bool g_watcher_running = false;
bool g_stop = false;
vgpu_pace g_pace = {0, 0, 0};
pthread_mutex_t g_pace_mu = PTHREAD_MUTEX_INITIALIZER;

int pace_quota() {
  int sw = g_region ? g_region->utilization_switch : 0;
  return vgpu_pace_quota_inline(g_cfg.core_limit, g_cfg.policy, sw);
}

/* whether a driver error is the card's, not the tenant's program's (the
 * table of vtpu_torch/shim/runtime.py): only these feed the region's
 * error streak, which the device plugin's health check reads, as the
 * reference's health feed skips a tenant's own faults (XID 13, 31, 43) */
bool device_side_error(CUresult rc) {
  switch (rc) {
    case CUDA_ERROR_DEVICE_UNAVAILABLE:
    case CUDA_ERROR_NO_DEVICE:
    case CUDA_ERROR_ECC_UNCORRECTABLE:
    case CUDA_ERROR_NVLINK_UNCORRECTABLE:
    case CUDA_ERROR_LAUNCH_TIMEOUT:
    case CUDA_ERROR_HARDWARE_STACK_ERROR:
    case CUDA_ERROR_UNKNOWN:
      return true;
    default:
      return false;
  }
}

/* feed a launch's or a batch's outcome into the region's error streak:
 * a success clears it (taking the cache line only when there is a streak
 * to clear), a device-side failure extends it */
void note_result(CUresult rc) {
  if (!g_region) return;
  if (rc == CUDA_SUCCESS) {
    if (__atomic_load_n(&g_region->error_streak, __ATOMIC_RELAXED) != 0)
      vtpu_region_exec_result(g_region, 1);
  } else if (device_side_error(rc)) {
    vtpu_region_exec_result(g_region, 0);
  }
}

/* an event of context ctx from the free list, or a new one (g_ev_mu
 * held, ctx current) */
CUevent take_event(CUcontext ctx) {
  for (size_t i = 0; i < g_free_events->size(); i++)
    if ((*g_free_events)[i].first == ctx) {
      CUevent ev = (*g_free_events)[i].second;
      (*g_free_events)[i] = g_free_events->back();
      g_free_events->pop_back();
      return ev;
    }
  CUevent ev = nullptr;
  if (g_drv.EventCreate(&ev, CU_EVENT_DISABLE_TIMING) != CUDA_SUCCESS)
    return nullptr;
  return ev;
}

/* close batch `b` with an event recorded on its stream now (g_ev_mu
 * held, b's context current) */
void close_batch(Batch* b) {
  CUevent ev = take_event(b->ctx);
  if (ev && g_drv.EventRecord(ev, b->stream) == CUDA_SUCCESS) {
    g_pending->push_back(Pending{ev, b->ctx, b->t_first, b->index, b->n});
    pthread_cond_signal(&g_ev_cv);
  } else if (ev) {
    g_free_events->push_back({b->ctx, ev});
  }
  b->n = 0;
}

bool capturing(CUstream stream, bool ptsz);

/* close every batch left open kStaleS after its last launch (g_ev_mu
 * held, on the watcher); returns how long until the next open batch
 * turns stale, 0 when none is open.  A per-thread default stream is
 * only the launching thread's to name, so its batches wait for their
 * own kEventEvery launches. */
double close_stale(CUcontext* current) {
  double now = now_s(), next = 0;
  for (auto& b : *g_batches) {
    if (b.n == 0 || b.stream == CU_STREAM_PER_THREAD) continue;
    double left = b.t_last + kStaleS - now;
    if (left <= 0 && b.ctx != *current) {
      g_drv.CtxSetCurrent(b.ctx);
      *current = b.ctx;
    }
    if (left <= 0 && !capturing(b.stream, false)) {
      close_batch(&b);
      continue;
    }
    if (left <= 0) left = kStaleS; /* being captured: look again later */
    if (next == 0 || left < next) next = left;
  }
  return next;
}

/* one thread polls the oldest pending event (only it pops the queue),
 * outside the lock the launching threads take, and closes stale
 * batches while it has nothing to poll */
void* watcher(void*) {
  CUcontext current = nullptr;
  /* this thread's queries must never count against a CUDA graph capture
   * that another thread of the process runs in global mode */
  int mode = CU_STREAM_CAPTURE_MODE_RELAXED;
  if (g_drv.ExchangeCaptureMode) g_drv.ExchangeCaptureMode(&mode);
  for (;;) {
    pthread_mutex_lock(&g_ev_mu);
    while (g_pending->empty() && !g_stop) {
      double next = close_stale(&current);
      if (!g_pending->empty()) break;
      if (next == 0) {
        pthread_cond_wait(&g_ev_cv, &g_ev_mu);
      } else {
        pthread_mutex_unlock(&g_ev_mu);
        sleep_s(next);
        pthread_mutex_lock(&g_ev_mu);
      }
    }
    if (g_stop) {
      pthread_mutex_unlock(&g_ev_mu);
      return nullptr;
    }
    Pending p = g_pending->front();
    pthread_mutex_unlock(&g_ev_mu);
    if (p.ctx != current) {
      g_drv.CtxSetCurrent(p.ctx);
      current = p.ctx;
    }
    CUresult rc = g_drv.EventQuery(p.ev);
    if (rc == CUDA_ERROR_NOT_READY) {
      sleep_s(kPollS);
      continue;
    }
    double t = now_s();
    note_result(rc);
    pthread_mutex_lock(&g_ev_mu);
    g_pending->pop_front();
    if (rc == CUDA_SUCCESS) g_free_events->push_back({p.ctx, p.ev});
    pthread_mutex_unlock(&g_ev_mu);
    if (rc != CUDA_SUCCESS) {
      g_drv.EventDestroy(p.ev); /* a failed context: drop the event */
      continue;
    }
    pthread_mutex_lock(&g_pace_mu);
    double busy =
        vgpu_pace_observe_inline(&g_pace, p.t_submit, t, pace_quota());
    pthread_mutex_unlock(&g_pace_mu);
    if (governed() && p.index >= 0)
      vtpu_region_record_launch(g_region, (int32_t)getpid(), p.index,
                                (uint64_t)(busy * 1e9), p.launches);
  }
}

/* whether a launch on `stream` is being captured into a CUDA graph:
 * then it is not run now, so it is neither paced nor followed by an
 * event (recording one into the capture would become a node of the
 * graph, and querying it would invalidate the capture).  An error of the
 * query counts as capturing. */
bool capturing(CUstream stream, bool ptsz) {
  if (!g_drv.StreamIsCapturing) return false;
  if (ptsz && stream == nullptr) stream = CU_STREAM_PER_THREAD;
  int status = 0;
  return g_drv.StreamIsCapturing(stream, &status) != CUDA_SUCCESS ||
         status != 0;
}

/* the launch gate: wait until the pacing deadline has passed and the
 * backlog of unobserved batches is short */
void pace_gate() {
  int q = pace_quota();
  if (q <= 0) return;
  for (;;) {
    pthread_mutex_lock(&g_ev_mu);
    int in_flight = g_pending ? (int)g_pending->size() : 0;
    pthread_mutex_unlock(&g_ev_mu);
    pthread_mutex_lock(&g_pace_mu);
    double w = vgpu_pace_wait_inline(&g_pace, now_s(), in_flight, q);
    pthread_mutex_unlock(&g_pace_mu);
    if (w <= 0) return;
    sleep_s(w < 0.01 ? w : 0.01); /* re-read: observations move it */
  }
}


/* after a launch that succeeded: count it in its stream's batch, and
 * close the batch with an event every kEventEvery launches and after
 * every graph launch (the watcher closes a batch left open) */
void note_launch(CUstream stream, bool ptsz, bool graph, double t0) {
  if (ptsz && stream == nullptr) stream = CU_STREAM_PER_THREAD;
  CUcontext ctx = nullptr;
  if (g_drv.CtxGetCurrent(&ctx) != CUDA_SUCCESS || ctx == nullptr) return;
  int index = current_index();
  pthread_mutex_lock(&g_ev_mu);
  if (!g_pending) {
    g_pending = new std::deque<Pending>();
    g_batches = new std::vector<Batch>();
    g_free_events = new std::vector<std::pair<CUcontext, CUevent>>();
  }
  if (!g_watcher_running) {
    g_stop = false;
    g_watcher_running =
        pthread_create(&g_watcher, nullptr, watcher, nullptr) == 0;
  }
  Batch* b = nullptr;
  for (auto& x : *g_batches)
    if (x.stream == stream && x.ctx == ctx) b = &x;
  if (!b) {
    g_batches->push_back(Batch{stream, ctx, index, 0, 0, 0});
    b = &g_batches->back();
  }
  if (b->n == 0) b->t_first = t0;
  b->t_last = t0;
  b->index = index;
  b->n++;
  if (b->n >= kEventEvery || graph) close_batch(b);
  else if (b->n == 1) pthread_cond_signal(&g_ev_cv); /* a batch opened */
  pthread_mutex_unlock(&g_ev_mu);
}

/* ------------------------------------------------------------------ */
/* lifetime                                                            */
/* ------------------------------------------------------------------ */
void atfork_child() {
  /* the child has none of the parent's threads, and its CUDA state is
   * not usable: start afresh at its own first driver call */
  pthread_mutex_t m = PTHREAD_MUTEX_INITIALIZER;
  g_init_mu = m;
  g_map_mu = m;
  g_ev_mu = m;
  g_pace_mu = m;
  pthread_cond_t cv = PTHREAD_COND_INITIALIZER;
  g_ev_cv = cv;
  vtpu_region_atfork_child();
  g_region = nullptr;
  g_slot = -1;
  g_ptrs = nullptr;    /* leaked: the parent's records */
  g_handles = nullptr;
  g_pending = nullptr;
  g_batches = nullptr;
  g_free_events = nullptr;
  g_watcher_running = false;
  g_stop = false;
  g_pace = vgpu_pace{0, 0, 0};
  memset(g_ctx_charged, 0, sizeof(g_ctx_charged));
  g_ready.store(0);
}

__attribute__((destructor)) void on_exit_free_slot() {
  pthread_mutex_lock(&g_ev_mu);
  bool running = g_watcher_running;
  g_stop = true;
  pthread_cond_signal(&g_ev_cv);
  pthread_mutex_unlock(&g_ev_mu);
  if (running) pthread_join(g_watcher, nullptr);
  if (g_ready.load() && g_region)
    vtpu_region_unregister_proc(g_region, (int32_t)getpid());
}

}  // namespace

/* ------------------------------------------------------------------ */
/* wrappers                                                            */
/* ------------------------------------------------------------------ */
typedef PFN_cuDevicePrimaryCtxRetain PFN_cuDevicePrimaryCtxRetain_t;
typedef PFN_cuMemAlloc PFN_cuMemAlloc_v2_t;
typedef PFN_cuMemAllocPitch PFN_cuMemAllocPitch_v2_t;
typedef PFN_cuMemAllocManaged PFN_cuMemAllocManaged_t;
typedef PFN_cuMemAllocAsync PFN_cuMemAllocAsync_t;
typedef PFN_cuMemAllocAsync PFN_cuMemAllocAsync_ptsz_t;
typedef PFN_cuMemAllocFromPoolAsync PFN_cuMemAllocFromPoolAsync_t;
typedef PFN_cuMemAllocFromPoolAsync PFN_cuMemAllocFromPoolAsync_ptsz_t;
typedef PFN_cuMemCreate PFN_cuMemCreate_t;
typedef PFN_cuMemFree PFN_cuMemFree_v2_t;
typedef PFN_cuMemFreeAsync PFN_cuMemFreeAsync_t;
typedef PFN_cuMemFreeAsync PFN_cuMemFreeAsync_ptsz_t;
typedef PFN_cuMemRelease PFN_cuMemRelease_t;
typedef PFN_cuMemGetInfo PFN_cuMemGetInfo_v2_t;
typedef PFN_cuLaunchKernel PFN_cuLaunchKernel_t;
typedef PFN_cuLaunchKernel PFN_cuLaunchKernel_ptsz_t;
typedef PFN_cuLaunchKernelEx PFN_cuLaunchKernelEx_t;
typedef PFN_cuLaunchKernelEx PFN_cuLaunchKernelEx_ptsz_t;
typedef PFN_cuLaunchCooperativeKernel PFN_cuLaunchCooperativeKernel_t;
typedef PFN_cuLaunchCooperativeKernel PFN_cuLaunchCooperativeKernel_ptsz_t;
typedef PFN_cuGraphLaunch PFN_cuGraphLaunch_t;
typedef PFN_cuGraphLaunch PFN_cuGraphLaunch_ptsz_t;
typedef PFN_cuStreamBeginCapture PFN_cuStreamBeginCapture_t;
typedef PFN_cuStreamBeginCapture PFN_cuStreamBeginCapture_ptsz_t;
typedef PFN_cuStreamBeginCapture_v2 PFN_cuStreamBeginCapture_v2_t;
typedef PFN_cuStreamBeginCapture_v2 PFN_cuStreamBeginCapture_v2_ptsz_t;
typedef PFN_cuGetProcAddress PFN_cuGetProcAddress_t;
typedef PFN_cuGetProcAddress_v2 PFN_cuGetProcAddress_v2_t;

#define ENSURE(name)                                           \
  ensure_table();                                              \
  if (!g_real[H_##name]) return CUDA_ERROR_NOT_INITIALIZED

EXPORT CUresult cuDevicePrimaryCtxRetain(CUcontext* pctx, CUdevice dev) {
  ENSURE(cuDevicePrimaryCtxRetain);
  if (!init_tenant() || !governed())
    return REAL(cuDevicePrimaryCtxRetain)(pctx, dev);
  int index = index_of_ordinal(dev);
  if (index < 0 || g_ctx_charged[index])
    return REAL(cuDevicePrimaryCtxRetain)(pctx, dev);
  /* the context's own memory, charged once (context_charge), under the
   * lock every tenant of this region takes to allocate and under the
   * node's context lock, which every tenant on the node takes to create
   * its contexts, one at a time */
  static CardView before, after; /* large: not on the caller's stack */
  int node_lock = open_node_lock();
  if (node_lock >= 0) flock(node_lock, LOCK_EX);
  vtpu_region_lock(g_region);
  nvml_view(g_ordinal_uuid[dev], &before);
  CUresult rc = REAL(cuDevicePrimaryCtxRetain)(pctx, dev);
  if (rc == CUDA_SUCCESS && !g_ctx_charged[index]) {
    nvml_view(g_ordinal_uuid[dev], &after);
    uint64_t charge = context_charge(before, after, (unsigned int)getpid());
    if (charge) vtpu_region_add_nolock(g_region, g_slot, index, 1, charge);
    g_ctx_charged[index] = 1;
  }
  vtpu_region_unlock(g_region);
  if (node_lock >= 0) close(node_lock); /* drops the flock */
  return rc;
}

EXPORT CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  ENSURE(cuMemAlloc_v2);
  return alloc_ptr(dptr, bytes, [&](CUresult* rc) -> uint64_t {
    *rc = REAL(cuMemAlloc_v2)(dptr, bytes);
    return *rc == CUDA_SUCCESS ? bytes : 0;
  }, no_undo);
}

EXPORT CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch,
                                   size_t width, size_t height,
                                   unsigned int elem) {
  ENSURE(cuMemAllocPitch_v2);
  return alloc_ptr(
      dptr, (uint64_t)width * height,
      [&](CUresult* r) -> uint64_t {
        *r = REAL(cuMemAllocPitch_v2)(dptr, pitch, width, height, elem);
        return *r == CUDA_SUCCESS ? (uint64_t)*pitch * height : 0;
      },
      [&]() { REAL(cuMemFree_v2)(*dptr); }); /* over the quota once pitched */
}

EXPORT CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytes,
                                  unsigned int flags) {
  ENSURE(cuMemAllocManaged);
  return alloc_ptr(dptr, bytes, [&](CUresult* rc) -> uint64_t {
    *rc = REAL(cuMemAllocManaged)(dptr, bytes, flags);
    return *rc == CUDA_SUCCESS ? bytes : 0;
  }, no_undo);
}

#define ALLOC_ASYNC(name)                                                 \
  EXPORT CUresult name(CUdeviceptr* dptr, size_t bytes, CUstream s) {     \
    ENSURE(name);                                                         \
    return alloc_ptr(dptr, bytes, [&](CUresult* rc) -> uint64_t {         \
      *rc = REAL(name)(dptr, bytes, s);                                   \
      return *rc == CUDA_SUCCESS ? bytes : 0;                             \
    }, no_undo);                                                          \
  }
ALLOC_ASYNC(cuMemAllocAsync)
ALLOC_ASYNC(cuMemAllocAsync_ptsz)

#define ALLOC_POOL(name)                                                    \
  EXPORT CUresult name(CUdeviceptr* dptr, size_t bytes, CUmemoryPool pool, \
                       CUstream s) {                                        \
    ENSURE(name);                                                           \
    return alloc_ptr(dptr, bytes, [&](CUresult* rc) -> uint64_t {           \
      *rc = REAL(name)(dptr, bytes, pool, s);                               \
      return *rc == CUDA_SUCCESS ? bytes : 0;                               \
    }, no_undo);                                                            \
  }
ALLOC_POOL(cuMemAllocFromPoolAsync)
ALLOC_POOL(cuMemAllocFromPoolAsync_ptsz)

EXPORT CUresult cuMemCreate(CUmemGenericAllocationHandle* handle,
                            size_t bytes, const CUmemAllocationProp* prop,
                            unsigned long long flags) {
  ENSURE(cuMemCreate);
  if (!init_tenant()) return CUDA_ERROR_NOT_INITIALIZED;
  int index = prop && prop->location.type == 1
                  ? index_of_ordinal(prop->location.id)
                  : current_index();
  uint64_t taken = 0;
  CUresult rc = guarded_alloc(index, bytes,
                              [&](CUresult* r) -> uint64_t {
                                *r = REAL(cuMemCreate)(handle, bytes, prop,
                                                       flags);
                                return *r == CUDA_SUCCESS ? bytes : 0;
                              },
                              no_undo, &taken);
  if (rc == CUDA_SUCCESS) {
    pthread_mutex_lock(&g_map_mu);
    if (!g_handles)
      g_handles = new std::unordered_map<CUmemGenericAllocationHandle, Rec>();
    (*g_handles)[*handle] = Rec{taken, index};
    pthread_mutex_unlock(&g_map_mu);
  }
  return rc;
}

EXPORT CUresult cuMemFree_v2(CUdeviceptr p) {
  ENSURE(cuMemFree_v2);
  CUresult rc = REAL(cuMemFree_v2)(p);
  if (rc == CUDA_SUCCESS) forget_ptr(p);
  return rc;
}

#define FREE_ASYNC(name)                                \
  EXPORT CUresult name(CUdeviceptr p, CUstream s) {     \
    ENSURE(name);                                       \
    CUresult rc = REAL(name)(p, s);                     \
    if (rc == CUDA_SUCCESS) forget_ptr(p);              \
    return rc;                                          \
  }
FREE_ASYNC(cuMemFreeAsync)
FREE_ASYNC(cuMemFreeAsync_ptsz)

EXPORT CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  ENSURE(cuMemRelease);
  CUresult rc = REAL(cuMemRelease)(handle);
  if (rc != CUDA_SUCCESS) return rc;
  Rec r{0, -1};
  pthread_mutex_lock(&g_map_mu);
  if (g_handles) {
    auto it = g_handles->find(handle);
    if (it != g_handles->end()) {
      r = it->second;
      g_handles->erase(it);
    }
  }
  pthread_mutex_unlock(&g_map_mu);
  if (r.index >= 0 && governed())
    vtpu_region_sub(g_region, (int32_t)getpid(), r.index, 0, r.bytes);
  return rc;
}

EXPORT CUresult cuMemGetInfo_v2(size_t* free_b, size_t* total_b) {
  ENSURE(cuMemGetInfo_v2);
  CUresult rc = REAL(cuMemGetInfo_v2)(free_b, total_b);
  if (rc != CUDA_SUCCESS || !init_tenant() || !governed()) return rc;
  int index = current_index();
  if (index < 0 || g_cfg.limit_bytes[index] == 0) return rc;
  uint64_t limit = g_cfg.limit_bytes[index];
  uint64_t used = vtpu_region_device_usage(g_region, index);
  uint64_t left = used < limit ? limit - used : 0;
  if (free_b && *free_b > left) *free_b = left;
  if (total_b) *total_b = limit;
  return rc;
}

#define LAUNCH_BODY(name, stream, ptsz, graph, call)               \
  ENSURE(name);                                                    \
  init_tenant();                                                   \
  bool captured = capturing(stream, ptsz);                         \
  if (!captured) pace_gate();                                      \
  double t0 = now_s();                                             \
  CUresult rc = call;                                              \
  if (rc == CUDA_SUCCESS && !captured) note_launch(stream, ptsz, graph, t0); \
  if (rc != CUDA_SUCCESS) note_result(rc);                         \
  return rc

#define LAUNCH_KERNEL(name, ptsz)                                            \
  EXPORT CUresult name(CUfunction f, unsigned int gx, unsigned int gy,      \
                       unsigned int gz, unsigned int bx, unsigned int by,    \
                       unsigned int bz, unsigned int shmem, CUstream s,      \
                       void** params, void** extra) {                        \
    LAUNCH_BODY(name, s, ptsz, false,                                        \
                REAL(name)(f, gx, gy, gz, bx, by, bz, shmem, s, params,      \
                           extra));                                          \
  }
LAUNCH_KERNEL(cuLaunchKernel, false)
LAUNCH_KERNEL(cuLaunchKernel_ptsz, true)

#define LAUNCH_EX(name, ptsz)                                                \
  EXPORT CUresult name(const CUlaunchConfig* cfg, CUfunction f,             \
                       void** params, void** extra) {                        \
    LAUNCH_BODY(name, cfg ? cfg->hStream : nullptr, ptsz, false,             \
                REAL(name)(cfg, f, params, extra));                          \
  }
LAUNCH_EX(cuLaunchKernelEx, false)
LAUNCH_EX(cuLaunchKernelEx_ptsz, true)

#define LAUNCH_COOP(name, ptsz)                                              \
  EXPORT CUresult name(CUfunction f, unsigned int gx, unsigned int gy,      \
                       unsigned int gz, unsigned int bx, unsigned int by,    \
                       unsigned int bz, unsigned int shmem, CUstream s,      \
                       void** params) {                                      \
    LAUNCH_BODY(name, s, ptsz, false,                                        \
                REAL(name)(f, gx, gy, gz, bx, by, bz, shmem, s, params));    \
  }
LAUNCH_COOP(cuLaunchCooperativeKernel, false)
LAUNCH_COOP(cuLaunchCooperativeKernel_ptsz, true)

#define LAUNCH_GRAPH(name, ptsz)                                 \
  EXPORT CUresult name(CUgraphExec g, CUstream s) {              \
    LAUNCH_BODY(name, s, ptsz, true, REAL(name)(g, s));          \
  }
LAUNCH_GRAPH(cuGraphLaunch, false)
LAUNCH_GRAPH(cuGraphLaunch_ptsz, true)

/* A capture is about to begin on `stream`: close the stream's open batch
 * now, in this thread, so the watcher never records into the capture;
 * the lock keeps it out until the capture has begun. */
#define BEGIN_CAPTURE(name, ptsz, params, args)                          \
  EXPORT CUresult name params {                                         \
    ENSURE(name);                                                       \
    CUcontext ctx = nullptr;                                            \
    if (g_drv.CtxGetCurrent) g_drv.CtxGetCurrent(&ctx);                 \
    pthread_mutex_lock(&g_ev_mu);                                       \
    CUstream key = (ptsz && s == nullptr) ? CU_STREAM_PER_THREAD : s;   \
    if (g_batches)                                                      \
      for (auto& b : *g_batches)                                        \
        if (b.stream == key && b.ctx == ctx && b.n > 0) close_batch(&b); \
    CUresult rc = REAL(name) args;                                      \
    pthread_mutex_unlock(&g_ev_mu);                                     \
    return rc;                                                          \
  }
BEGIN_CAPTURE(cuStreamBeginCapture, false, (CUstream s), (s))
BEGIN_CAPTURE(cuStreamBeginCapture_ptsz, true, (CUstream s), (s))
BEGIN_CAPTURE(cuStreamBeginCapture_v2, false, (CUstream s, int mode),
              (s, mode))
BEGIN_CAPTURE(cuStreamBeginCapture_v2_ptsz, true, (CUstream s, int mode),
              (s, mode))

EXPORT CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                                 cuuint64_t flags) {
  ENSURE(cuGetProcAddress);
  CUresult rc = REAL(cuGetProcAddress)(symbol, pfn, version, flags);
  if (rc == CUDA_SUCCESS && pfn)
    *pfn = wrap_resolved(symbol, version, flags, *pfn);
  return rc;
}

EXPORT CUresult cuGetProcAddress_v2(const char* symbol, void** pfn,
                                    int version, cuuint64_t flags,
                                    CUdriverProcAddressQueryResult* status) {
  ENSURE(cuGetProcAddress_v2);
  CUresult rc =
      REAL(cuGetProcAddress_v2)(symbol, pfn, version, flags, status);
  if (rc == CUDA_SUCCESS && pfn)
    *pfn = wrap_resolved(symbol, version, flags, *pfn);
  return rc;
}

EXPORT int nvmlDeviceGetMemoryInfo(void* dev, unsigned long long* mem) {
  pthread_once(&g_nvml_once, load_nvml);
  if (!g_nvml.GetMemoryInfo) return 9; /* NVML_ERROR_DRIVER_NOT_LOADED */
  int rc = g_nvml.GetMemoryInfo(dev, mem);
  uint64_t total, used;
  if (rc == 0 && quota_view(dev, &total, &used)) {
    mem[0] = total; /* nvmlMemory_t: total, free, used */
    mem[1] = total - used;
    mem[2] = used;
  }
  return rc;
}

EXPORT int nvmlDeviceGetMemoryInfo_v2(void* dev, NvmlMemoryV2* mem) {
  pthread_once(&g_nvml_once, load_nvml);
  if (!g_nvml.GetMemoryInfoV2) return 9;
  int rc = g_nvml.GetMemoryInfoV2(dev, mem);
  uint64_t total, used;
  if (rc == 0 && quota_view(dev, &total, &used)) {
    mem->total = total;
    mem->reserved = 0;
    mem->free = total - used;
    mem->used = used;
  }
  return rc;
}

/* the dlsym every library of the process reaches (see the top) */
EXPORT void* dlsym(void* handle, const char* name) {
  void* p = real_dlsym()(handle, name);
  if (p && strcmp(name, "nvmlDeviceGetMemoryInfo") == 0)
    return (void*)&::nvmlDeviceGetMemoryInfo;
  if (p && strcmp(name, "nvmlDeviceGetMemoryInfo_v2") == 0)
    return (void*)&::nvmlDeviceGetMemoryInfo_v2;
  if (p && name[0] == 'c' && name[1] == 'u') {
    int k = hook_index(name);
    if (k >= 0) {
      if (!g_hint) g_hint = handle;
      ensure_table();
      if (p == g_real[k]) return g_wrap[k];
    }
  }
  return p;
}

/* ------------------------------------------------------------------ */
/* the pacing arithmetic, for the tests                                */
/* ------------------------------------------------------------------ */
EXPORT double vgpu_pace_observe(vgpu_pace* p, double t_submit,
                                double t_complete, int q) {
  return vgpu_pace_observe_inline(p, t_submit, t_complete, q);
}

EXPORT double vgpu_pace_wait(const vgpu_pace* p, double now, int in_flight,
                             int q) {
  return vgpu_pace_wait_inline(p, now, in_flight, q);
}

EXPORT int vgpu_pace_quota(int core_limit, int policy, int utilization_switch) {
  return vgpu_pace_quota_inline(core_limit, policy, utilization_switch);
}

namespace {
void fill_wrappers() {
#define X(n) g_wrap[H_##n] = (void*)&::n;
  VGPU_HOOKS(X)
#undef X
}
}  // namespace
