/* Shared-region implementation: the port's copy of cpp/shared_region.cc
 * with the no-lock accounting calls and the fork hook of
 * shared_region.h added at the end.
 *
 * Concurrency model (ref libvgpu.so's semaphore + file lock +
 * fix_lock_shrreg dead-owner recovery, SURVEY.md §5 race detection):
 * every mutation holds flock(fd) on the region file itself.  flock gives
 * (a) cross-LANGUAGE exclusion — the Python writer (vtpu_torch.monitor.
 * shared_region) locks the same file, and (b) dead-owner recovery for
 * free: the kernel drops the lock when the holder dies, which the
 * reference needed fix_lock_shrreg + owner-pid probing for.  The CAS
 * fast-path guards re-entry within one process; owner_pid is kept for
 * observability.
 */
#include "shared_region.h"

#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <pthread.h>

/* per-process region→fd registry so lock/unlock can flock the file the
 * region was mapped from (fds are per-process; they cannot live in the
 * shared mapping itself) */
#define VTPU_MAX_OPEN 32
static struct {
  vtpu_shared_region* r;
  int fd;
} g_open[VTPU_MAX_OPEN];

/* flock serialises PROCESSES but not threads: on one open file
 * description a second LOCK_EX from another thread of the same process
 * succeeds immediately (flock is per-ofd, conversion semantics).  The
 * process-local mutex closes that hole — JAX dispatches PJRT calls from
 * several threads, so two try_adds in one tenant would otherwise race
 * the slot fields.  Lock order: local mutex, then flock. */
static pthread_mutex_t g_local_mu = PTHREAD_MUTEX_INITIALIZER;

static int fd_for(vtpu_shared_region* r) {
  for (int i = 0; i < VTPU_MAX_OPEN; i++)
    if (g_open[i].r == r) return g_open[i].fd;
  return -1;
}

vtpu_shared_region* vtpu_region_open(const char* path) {
  int fd = open(path, O_RDWR | O_CREAT, 0666);
  if (fd < 0) return NULL;
  /* file lock serialises first-time init across processes */
  if (flock(fd, LOCK_EX) != 0) {
    close(fd);
    return NULL;
  }
  struct stat st;
  if (fstat(fd, &st) != 0) {
    flock(fd, LOCK_UN);
    close(fd);
    return NULL;
  }
  int fresh = st.st_size < (off_t)sizeof(vtpu_shared_region);
  if (fresh && st.st_size >= (off_t)(2 * sizeof(uint32_t))) {
    /* the v4 struct GREW: an old-version region written by a pre-v4
     * shim is smaller than sizeof(vtpu_shared_region) but is NOT fresh —
     * truncate+memset would wipe live tenants' quota state out from
     * under them.  Peek the header and refuse it like any other
     * version mismatch (the Python monitor keeps the read path). */
    uint32_t hdr[2] = {0, 0};
    if (pread(fd, hdr, sizeof(hdr), 0) == (ssize_t)sizeof(hdr) &&
        hdr[0] == VTPU_REGION_MAGIC && hdr[1] != VTPU_REGION_VERSION) {
      flock(fd, LOCK_UN);
      close(fd);
      return NULL;
    }
  }
  if (fresh && ftruncate(fd, sizeof(vtpu_shared_region)) != 0) {
    flock(fd, LOCK_UN);
    close(fd);
    return NULL;
  }
  void* p = mmap(NULL, sizeof(vtpu_shared_region), PROT_READ | PROT_WRITE,
                 MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) {
    flock(fd, LOCK_UN);
    close(fd);
    return NULL;
  }
  vtpu_shared_region* r = (vtpu_shared_region*)p;
  if (fresh || r->magic != VTPU_REGION_MAGIC) {
    memset(r, 0, sizeof(*r));
    r->magic = VTPU_REGION_MAGIC;
    r->version = VTPU_REGION_VERSION;
    r->initialized = 1;
  } else if (r->version != VTPU_REGION_VERSION) {
    munmap(p, sizeof(vtpu_shared_region));
    flock(fd, LOCK_UN);
    close(fd);
    return NULL;
  }
  flock(fd, LOCK_UN);
  /* keep fd open: it carries the steady-state flock */
  for (int i = 0; i < VTPU_MAX_OPEN; i++) {
    if (g_open[i].r == NULL) {
      g_open[i].r = r;
      g_open[i].fd = fd;
      return r;
    }
  }
  close(fd);
  munmap(p, sizeof(vtpu_shared_region));
  return NULL; /* too many open regions in one process */
}

int vtpu_region_close(vtpu_shared_region* r) {
  if (!r) return 0;
  for (int i = 0; i < VTPU_MAX_OPEN; i++) {
    if (g_open[i].r == r) {
      close(g_open[i].fd);
      g_open[i].r = NULL;
      g_open[i].fd = -1;
    }
  }
  return munmap(r, sizeof(vtpu_shared_region));
}

int vtpu_region_set_devices(vtpu_shared_region* r, int n,
                            const char uuids[][VTPU_UUID_LEN],
                            const uint64_t* limit_bytes,
                            const int32_t* core_limit) {
  if (!r || n < 0 || n > VTPU_MAX_DEVICES) return -1;
  vtpu_region_lock(r);
  if (r->num_devices == 0) {
    r->num_devices = n;
    for (int i = 0; i < n; i++) {
      strncpy(r->uuids[i], uuids[i], VTPU_UUID_LEN - 1);
      r->limit_bytes[i] = limit_bytes[i];
      r->core_limit[i] = core_limit[i];
    }
  } else if (r->num_devices != n) {
    vtpu_region_unlock(r);
    return -1;
  }
  vtpu_region_unlock(r);
  return 0;
}

static int pid_alive(int32_t pid) {
  if (pid <= 0) return 0;
  return kill(pid, 0) == 0 || errno == EPERM;
}

void vtpu_region_lock(vtpu_shared_region* r) {
  pthread_mutex_lock(&g_local_mu); /* thread exclusion within the process */
  int fd = fd_for(r);
  if (fd >= 0) flock(fd, LOCK_EX); /* released by the kernel if we die */
  r->lock = 1; /* observability only; mutex+flock are the real exclusion */
  r->owner_pid = (int32_t)getpid();
  __sync_synchronize();
}

void vtpu_region_unlock(vtpu_shared_region* r) {
  r->owner_pid = 0;
  __sync_synchronize();
  r->lock = 0;
  int fd = fd_for(r);
  if (fd >= 0) flock(fd, LOCK_UN);
  pthread_mutex_unlock(&g_local_mu);
}

static int register_proc_impl(vtpu_shared_region* r, int32_t pid,
                              int32_t priority, int fresh) {
  vtpu_region_lock(r);
  int free_slot = -1;
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    if (r->procs[i].status == 1 && r->procs[i].pid == pid) {
      if (fresh) {
        /* pid recycled from a dead predecessor (fresh caller cannot
         * have accounted anything yet): drop its phantom usage */
        memset(r->procs[i].used, 0, sizeof(r->procs[i].used));
        r->procs[i].exec_calls = 0;
        r->procs[i].exec_shim_ns = 0;
        r->procs[i].hostpid = 0;
        r->procs[i].priority = priority;
      }
      vtpu_region_unlock(r);
      return i;
    }
    if (free_slot < 0 && r->procs[i].status == 0) free_slot = i;
  }
  if (free_slot < 0) {
    /* all slots busy: reap the dead and retry once */
    for (int i = 0; i < VTPU_MAX_PROCS; i++) {
      if (r->procs[i].status == 1 && !pid_alive(r->procs[i].pid)) {
        memset(&r->procs[i], 0, sizeof(r->procs[i]));
        if (free_slot < 0) free_slot = i;
      }
    }
  }
  if (free_slot >= 0) {
    memset(&r->procs[free_slot], 0, sizeof(r->procs[free_slot]));
    r->procs[free_slot].pid = pid;
    r->procs[free_slot].status = 1;
    r->procs[free_slot].priority = priority;
    r->proc_num++;
  }
  vtpu_region_unlock(r);
  return free_slot;
}

int vtpu_region_register_proc(vtpu_shared_region* r, int32_t pid,
                              int32_t priority) {
  return register_proc_impl(r, pid, priority, 0);
}

int vtpu_region_register_proc_fresh(vtpu_shared_region* r, int32_t pid,
                                    int32_t priority) {
  return register_proc_impl(r, pid, priority, 1);
}

void vtpu_region_unregister_proc(vtpu_shared_region* r, int32_t pid) {
  vtpu_region_lock(r);
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    if (r->procs[i].status == 1 && r->procs[i].pid == pid) {
      memset(&r->procs[i], 0, sizeof(r->procs[i]));
      if (r->proc_num > 0) r->proc_num--;
    }
  }
  vtpu_region_unlock(r);
}

void vtpu_region_reap_dead(vtpu_shared_region* r) {
  vtpu_region_lock(r);
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    if (r->procs[i].status == 1 && !pid_alive(r->procs[i].pid)) {
      memset(&r->procs[i], 0, sizeof(r->procs[i]));
      if (r->proc_num > 0) r->proc_num--;
    }
  }
  vtpu_region_unlock(r);
}

static uint64_t device_usage_nolock(vtpu_shared_region* r, int dev) {
  uint64_t total = 0;
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    if (r->procs[i].status == 1) total += r->procs[i].used[dev].total_bytes;
  }
  return total;
}

uint64_t vtpu_region_device_usage(vtpu_shared_region* r, int dev) {
  if (dev < 0 || dev >= VTPU_MAX_DEVICES) return 0;
  vtpu_region_lock(r);
  uint64_t v = device_usage_nolock(r, dev);
  vtpu_region_unlock(r);
  return v;
}

void vtpu_region_exec_result(vtpu_shared_region* r, int ok) {
  if (!r) return;
  if (ok) {
    /* atomic clear — a plain store could lose against concurrent
     * failure increments from other dispatch threads */
    __sync_fetch_and_and(&r->error_streak, 0);
  } else {
    __sync_fetch_and_add(&r->error_streak, 1);
    __sync_fetch_and_add(&r->exec_errors, 1);
  }
}

void vtpu_region_record_launch(vtpu_shared_region* r, int32_t pid, int dev,
                               uint64_t busy_ns, uint32_t launches) {
  if (!r || dev < 0 || dev >= VTPU_MAX_DEVICES) return;
  vtpu_region_lock(r);
  r->recent_kernel += (int32_t)launches;
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    if (r->procs[i].status == 1 && r->procs[i].pid == pid) {
      r->procs[i].used[dev].busy_ns += busy_ns;
      r->procs[i].used[dev].launches += launches;
      break;
    }
  }
  vtpu_region_unlock(r);
}

int vtpu_region_try_add(vtpu_shared_region* r, int32_t pid, int dev, int kind,
                        uint64_t bytes, int oversubscribe) {
  if (dev < 0 || dev >= VTPU_MAX_DEVICES) return -1;
  int slot = vtpu_region_register_proc(r, pid, 0);
  if (slot < 0) return -1;
  vtpu_region_lock(r);
  uint64_t limit = r->limit_bytes[dev];
  if (kind != 2 && !oversubscribe && limit > 0 &&
      device_usage_nolock(r, dev) + bytes > limit) {
    vtpu_region_unlock(r); /* check_oom: reject (ref add_gpu_device_memory_usage) */
    return -1;
  }
  vtpu_device_usage* u = &r->procs[slot].used[dev];
  if (kind == 1)
    u->program_bytes += bytes;
  else if (kind == 2)
    u->swap_bytes += bytes; /* host tier: unlimited by the device quota */
  else
    u->buffer_bytes += bytes;
  u->total_bytes = u->program_bytes + u->buffer_bytes;
  if (u->total_bytes > u->hbm_peak_bytes) /* v4 high-watermark ratchet */
    u->hbm_peak_bytes = u->total_bytes;
  vtpu_region_unlock(r);
  return 0;
}

void vtpu_region_sub(vtpu_shared_region* r, int32_t pid, int dev, int kind,
                     uint64_t bytes) {
  if (dev < 0 || dev >= VTPU_MAX_DEVICES) return;
  vtpu_region_lock(r);
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    if (r->procs[i].status == 1 && r->procs[i].pid == pid) {
      vtpu_device_usage* u = &r->procs[i].used[dev];
      uint64_t* field = (kind == 1)   ? &u->program_bytes
                        : (kind == 2) ? &u->swap_bytes
                                      : &u->buffer_bytes;
      *field = (*field >= bytes) ? *field - bytes : 0;
      u->total_bytes = u->program_bytes + u->buffer_bytes;
      break;
    }
  }
  vtpu_region_unlock(r);
}

uint64_t vtpu_region_device_usage_nolock(vtpu_shared_region* r, int dev) {
  if (dev < 0 || dev >= VTPU_MAX_DEVICES) return 0;
  return device_usage_nolock(r, dev);
}

static uint64_t* usage_field(vtpu_device_usage* u, int kind) {
  return (kind == 1) ? &u->program_bytes
         : (kind == 2) ? &u->swap_bytes
                       : &u->buffer_bytes;
}

void vtpu_region_add_nolock(vtpu_shared_region* r, int slot, int dev,
                            int kind, uint64_t bytes) {
  if (slot < 0 || slot >= VTPU_MAX_PROCS || dev < 0 ||
      dev >= VTPU_MAX_DEVICES)
    return;
  vtpu_device_usage* u = &r->procs[slot].used[dev];
  *usage_field(u, kind) += bytes;
  u->total_bytes = u->program_bytes + u->buffer_bytes;
  if (u->total_bytes > u->hbm_peak_bytes) u->hbm_peak_bytes = u->total_bytes;
}

void vtpu_region_sub_nolock(vtpu_shared_region* r, int slot, int dev,
                            int kind, uint64_t bytes) {
  if (slot < 0 || slot >= VTPU_MAX_PROCS || dev < 0 ||
      dev >= VTPU_MAX_DEVICES)
    return;
  vtpu_device_usage* u = &r->procs[slot].used[dev];
  uint64_t* field = usage_field(u, kind);
  *field = (*field >= bytes) ? *field - bytes : 0;
  u->total_bytes = u->program_bytes + u->buffer_bytes;
}

void vtpu_region_atfork_child(void) {
  for (int i = 0; i < VTPU_MAX_OPEN; i++) {
    if (g_open[i].r != NULL) {
      munmap(g_open[i].r, sizeof(vtpu_shared_region));
      close(g_open[i].fd);
      g_open[i].r = NULL;
      g_open[i].fd = -1;
    }
  }
  pthread_mutex_t fresh = PTHREAD_MUTEX_INITIALIZER;
  g_local_mu = fresh;
}
