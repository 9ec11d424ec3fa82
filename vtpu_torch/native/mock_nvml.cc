/* A mock libnvidia-ml.so.1 for the CPU tests of NvmlProvider and of the
 * interposer's context charge: the NVML calls they make, over the cards
 * of the JSON fixture named by VTPU_MOCK_NVML_JSON (mock_fixture.h),
 * read afresh at every call so that a test flips a card's health by
 * rewriting the file:
 *
 *   {"devices": [{"uuid": "GPU-...", "name": "NVIDIA H100 80GB HBM3",
 *                 "total_mb": 81559, "used_mb": 0, "minor": 0,
 *                 "healthy": true, "hang": false}]}
 *
 * A card with "healthy": false answers memory queries with
 * NVML_ERROR_GPU_IS_LOST; one with "hang": true holds them until the
 * fixture clears it (at most 60 s).  Where the mock libcuda is loaded in
 * the same process, its used bytes add to the card's, and the process
 * is listed on the card (pid and those bytes) once it has used any;
 * "noise_mb" adds that much more used memory at every memory query (other
 * processes filling the card), and "procs": false makes the process list
 * unsupported. */
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>
#include <unistd.h>

#include <string>

#include "mock_fixture.h"

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

const int kOk = 0, kInvalidArgument = 2, kNotSupported = 3, kNotFound = 6,
          kInsufficientSize = 7, kDriverNotLoaded = 9, kGpuIsLost = 15;

struct ProcessInfo {
  unsigned int pid;
  unsigned long long used;
  unsigned int gpu_instance, compute_instance;
};

unsigned long long g_memory_queries = 0;

struct Memory {
  unsigned long long total, free, used;
};

mock::Fixture fixture() { return mock::load("VTPU_MOCK_NVML_JSON"); }

/* the index a handle stands for (handles are index + 1) */
int index_of(void* h) { return (int)(uintptr_t)h - 1; }

bool device(const mock::Fixture& f, void* h, mock::Object* out) {
  int i = index_of(h);
  if (!f.ok || i < 0 || i >= (int)f.devices.size()) return false;
  *out = f.devices[i];
  return true;
}

int copy_text(const std::string& s, char* buf, unsigned int len) {
  if (s.size() + 1 > len) return kInsufficientSize;
  memcpy(buf, s.c_str(), s.size() + 1);
  return kOk;
}

unsigned long long cuda_used(const std::string& uuid) {
  typedef unsigned long long (*Fn)(const char*);
  Fn fn = (Fn)dlsym(RTLD_DEFAULT, "vtpu_mock_cuda_used");
  return fn ? fn(uuid.c_str()) : 0;
}

}  // namespace

EXPORT int nvmlInit_v2(void) {
  return fixture().ok ? kOk : kDriverNotLoaded;
}

EXPORT int nvmlShutdown(void) { return kOk; }

EXPORT int nvmlDeviceGetCount_v2(unsigned int* n) {
  mock::Fixture f = fixture();
  if (!f.ok) return kDriverNotLoaded;
  *n = (unsigned int)f.devices.size();
  return kOk;
}

EXPORT int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void** h) {
  mock::Fixture f = fixture();
  if (!f.ok) return kDriverNotLoaded;
  if (i >= f.devices.size()) return kInvalidArgument;
  *h = (void*)(uintptr_t)(i + 1);
  return kOk;
}

EXPORT int nvmlDeviceGetHandleByUUID(const char* uuid, void** h) {
  mock::Fixture f = fixture();
  if (!f.ok) return kDriverNotLoaded;
  for (size_t i = 0; i < f.devices.size(); i++)
    if (f.str(f.devices[i], "uuid") == uuid) {
      *h = (void*)(uintptr_t)(i + 1);
      return kOk;
    }
  return kNotFound;
}

EXPORT int nvmlDeviceGetUUID(void* h, char* buf, unsigned int len) {
  mock::Fixture f = fixture();
  mock::Object d;
  if (!device(f, h, &d)) return kInvalidArgument;
  return copy_text(f.str(d, "uuid"), buf, len);
}

EXPORT int nvmlDeviceGetName(void* h, char* buf, unsigned int len) {
  mock::Fixture f = fixture();
  mock::Object d;
  if (!device(f, h, &d)) return kInvalidArgument;
  return copy_text(f.str(d, "name", "NVIDIA H100 80GB HBM3"), buf, len);
}

EXPORT int nvmlDeviceGetMinorNumber(void* h, unsigned int* minor) {
  mock::Fixture f = fixture();
  mock::Object d;
  if (!device(f, h, &d)) return kInvalidArgument;
  *minor = (unsigned int)f.num(d, "minor", index_of(h));
  return kOk;
}

EXPORT int nvmlDeviceGetMemoryInfo(void* h, Memory* m) {
  for (int waited_ms = 0;; waited_ms += 10) {
    mock::Fixture f = fixture();
    mock::Object d;
    if (!device(f, h, &d)) return kInvalidArgument;
    if (f.flag(d, "hang", false) && waited_ms < 60000) {
      usleep(10000);
      continue;
    }
    if (!f.flag(d, "healthy", true)) return kGpuIsLost;
    m->total = (unsigned long long)f.num(d, "total_mb", 81559) << 20;
    g_memory_queries++;
    m->used = ((unsigned long long)f.num(d, "used_mb", 0) << 20) +
              cuda_used(f.str(d, "uuid")) +
              g_memory_queries * ((unsigned long long)f.num(d, "noise_mb", 0)
                                  << 20);
    m->free = m->used < m->total ? m->total - m->used : 0;
    return kOk;
  }
}

struct MemoryV2 {
  unsigned int version;
  unsigned long long total, reserved, free, used;
};

EXPORT int nvmlDeviceGetMemoryInfo_v2(void* h, MemoryV2* m) {
  Memory v1;
  int rc = nvmlDeviceGetMemoryInfo(h, &v1);
  if (rc == kOk) {
    m->total = v1.total;
    m->reserved = 0;
    m->free = v1.free;
    m->used = v1.used;
  }
  return rc;
}

EXPORT int nvmlDeviceGetComputeRunningProcesses_v3(void* h, unsigned int* n,
                                                   ProcessInfo* infos) {
  mock::Fixture f = fixture();
  mock::Object d;
  if (!device(f, h, &d)) return kInvalidArgument;
  if (!f.flag(d, "procs", true)) return kNotSupported;
  unsigned long long used = cuda_used(f.str(d, "uuid"));
  unsigned int count = used ? 1 : 0;
  if (*n < count) {
    *n = count;
    return kInsufficientSize;
  }
  *n = count;
  if (count) infos[0] = ProcessInfo{(unsigned int)getpid(), used, 0, 0};
  return kOk;
}

EXPORT const char* nvmlErrorString(int rc) {
  switch (rc) {
    case kOk: return "Success";
    case kInvalidArgument: return "Invalid Argument";
    case kNotSupported: return "Not Supported";
    case kNotFound: return "Not Found";
    case kInsufficientSize: return "Insufficient Size";
    case kDriverNotLoaded: return "Driver Not Loaded";
    case kGpuIsLost: return "GPU is lost";
    default: return "Unknown Error";
  }
}
