/* vtpu shared region — the cross-process accounting fabric.
 *
 * The port's own copy of cpp/shared_region.h (the CUDA interposer is
 * built from vtpu_torch/native alone), with calls the interposer needs
 * added at the end: accounting under a lock the caller holds, and a
 * fork hook.  The layout, magic, version and flock protocol are
 * unchanged: the unchanged native shim, vtpu/monitor/shared_region.py
 * and vtpu_torch/monitor/shared_region.py read and write the same file.
 *
 * A rebuild of the reference's mmap'd shared region
 * (cmd/vGPUmonitor/cudevshr.go:15-72 mirrors the C layout of
 * libvgpu.so's multiprocess_memory_limit.c).  One file per container
 * (mounted at /tmp/vtpu/vtpu.cache inside, host path
 * /usr/local/vtpu/containers/<podUID>_<n>/vtpu.cache), written by the
 * in-container enforcement shim, read by the node monitor.
 *
 * Layout is fixed and mirrored byte-for-byte by
 * vtpu_torch/monitor/shared_region.py (ctypes); bump VTPU_REGION_VERSION on any
 * change.  All multi-byte fields are native-endian (region files never
 * cross hosts).
 */
#ifndef VTPU_SHARED_REGION_H_
#define VTPU_SHARED_REGION_H_

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define VTPU_REGION_MAGIC 0x76545055u /* "vTPU" */
#define VTPU_REGION_VERSION 4
#define VTPU_MAX_DEVICES 16
#define VTPU_MAX_PROCS 64
#define VTPU_UUID_LEN 64

/* per-process, per-device usage breakdown (ref sharedRegionT.procs[].used:
 * contextSize/moduleSize/bufferSize → program/buffer on TPU) */
typedef struct vtpu_device_usage {
  uint64_t program_bytes; /* compiled executables resident in HBM */
  uint64_t buffer_bytes;  /* live device buffers */
  uint64_t total_bytes;   /* program + buffer (denormalised for readers) */
  uint64_t swap_bytes;    /* buffers offloaded to the HOST tier past quota
                             (oversubscribe — ref CUDA_OVERSUBSCRIBE's
                             host-RAM swap, README.md:236-240); NOT part
                             of total_bytes: swap never counts against the
                             device HBM quota */
  /* utilization profiling (v4): monotonic counters the monitor's
   * UtilizationSampler diffs into duty-cycle ratios.  Written by the
   * owning process only (atomic adds from its dispatch threads); the
   * monitor reads without the lock and tolerates cross-field skew. */
  uint64_t busy_ns;        /* cumulative device-busy nanoseconds */
  uint64_t launches;       /* cumulative kernel/execute launches */
  uint64_t hbm_peak_bytes; /* high-watermark of total_bytes (ratchets up
                              on add, never down on sub) */
} vtpu_device_usage;

typedef struct vtpu_proc_slot {
  int32_t pid;     /* in-container pid */
  int32_t hostpid; /* host pid (filled by monitor feedback, ref setHostPid) */
  int32_t status;  /* 0 free, 1 live */
  int32_t priority; /* TPU_TASK_PRIORITY of this proc (0 high, 1 low) */
  /* interposer telemetry published for the monitor (v3): execute count
   * and wrapper-ADDED nanoseconds (excludes forwarded-call and pacing
   * time).  Written only by the owning process but by SEVERAL of its
   * dispatch threads — atomic adds; the monitor reads without the lock
   * and tolerates cross-field skew. */
  uint64_t exec_calls;
  uint64_t exec_shim_ns;
  vtpu_device_usage used[VTPU_MAX_DEVICES];
} vtpu_proc_slot;

typedef struct vtpu_shared_region {
  uint32_t magic;
  uint32_t version;
  int32_t initialized; /* 1 once init completed (ref initializedFlag) */
  int32_t owner_pid;   /* current holder, observability (real exclusion and
                          dead-owner recovery come from flock on the region
                          file — ref fix_lock_shrreg / CHANGELOG v2.2.7) */
  int32_t lock;        /* 0 free, 1 held — observational mirror of flock */
  int32_t num_devices;
  int32_t utilization_switch; /* monitor-written: 0 enforce core limits,
                                 1 suspend (priority arbitration,
                                 ref feedback.go CheckPriority) */
  int32_t recent_kernel; /* decayed activity counter (ref Observe) */
  /* device-error telemetry written by the shim's execute path — the
   * TPU-native analog of the XID critical-event stream
   * (nvidia.go:173-244): consecutive device-side execute failures with
   * no intervening success.  The device plugin's health probe flips a
   * chip Unhealthy when any tenant's streak crosses its threshold and
   * recovers when a success resets it. */
  int32_t error_streak; /* consecutive execute errors (0 on success) */
  int32_t exec_errors;  /* cumulative execute errors (observability) */
  char uuids[VTPU_MAX_DEVICES][VTPU_UUID_LEN];
  uint64_t limit_bytes[VTPU_MAX_DEVICES];   /* HBM quota per device */
  int32_t core_limit[VTPU_MAX_DEVICES];     /* percent per device */
  int32_t proc_num;
  int32_t _pad;
  uint64_t reserved[8];
  vtpu_proc_slot procs[VTPU_MAX_PROCS];
} vtpu_shared_region;

/* ---- lifecycle ---- */

/* mmap (creating + initialising if needed) the region at `path`.
 * Registration of devices happens on first init from the limit arrays.
 * Returns NULL on failure. */
vtpu_shared_region* vtpu_region_open(const char* path);
int vtpu_region_close(vtpu_shared_region* r);

/* initialise device table (first process wins; later calls validate). */
int vtpu_region_set_devices(vtpu_shared_region* r, int n,
                            const char uuids[][VTPU_UUID_LEN],
                            const uint64_t* limit_bytes,
                            const int32_t* core_limit);

/* ---- locking (cross-process; dead-owner safe) ---- */
void vtpu_region_lock(vtpu_shared_region* r);
void vtpu_region_unlock(vtpu_shared_region* r);

/* ---- process slots ---- */
/* find-or-create the slot for `pid`; returns slot index or -1. */
int vtpu_region_register_proc(vtpu_shared_region* r, int32_t pid,
                              int32_t priority);
/* like register_proc, but for a process KNOWN to be newly started (first
 * client create): a pid-matching slot left by a dead predecessor whose
 * container pid was recycled to us gets its usage/telemetry cleared
 * instead of inherited (phantom quota).  Ordinary register_proc keeps
 * the accounting (the caller may be a later call of the same process). */
int vtpu_region_register_proc_fresh(vtpu_shared_region* r, int32_t pid,
                                    int32_t priority);
void vtpu_region_unregister_proc(vtpu_shared_region* r, int32_t pid);
/* reap slots whose pid is gone (ref clear_proc_slot_nolock). */
void vtpu_region_reap_dead(vtpu_shared_region* r);

/* ---- accounting ---- */
/* attempt to add `bytes` of `kind` (0=buffer, 1=program, 2=host-swap) for
 * pid on device dev; returns 0 on success, -1 if it would exceed
 * limit_bytes[dev] (the check_oom analog). Oversubscribe mode skips the
 * reject; kind 2 is the host tier and never checks the device quota. */
int vtpu_region_try_add(vtpu_shared_region* r, int32_t pid, int dev, int kind,
                        uint64_t bytes, int oversubscribe);
void vtpu_region_sub(vtpu_shared_region* r, int32_t pid, int dev, int kind,
                     uint64_t bytes);
/* total usage across procs for device dev (ref get_gpu_memory_usage). */
uint64_t vtpu_region_device_usage(vtpu_shared_region* r, int dev);

/* record an execute outcome: ok=1 resets the error streak, ok=0 bumps
 * streak + cumulative count (the XID-analog health feed). */
void vtpu_region_exec_result(vtpu_shared_region* r, int ok);

/* utilization profiling (v4): bump the launch count and cumulative
 * device-busy estimate for pid's slot on device dev, plus the shared
 * recent_kernel activity counter, under one lock acquisition. */
void vtpu_region_record_launch(vtpu_shared_region* r, int32_t pid, int dev,
                               uint64_t busy_ns, uint32_t launches);

/* ---- under a lock the caller holds (vtpu_region_lock) ----
 * The interposer keeps the lock across the check, the driver's own
 * allocation and the add, so that two processes racing for the last
 * bytes cannot both pass the check and the device's real usage never
 * runs ahead of the region's. */
uint64_t vtpu_region_device_usage_nolock(vtpu_shared_region* r, int dev);
/* add `bytes` of `kind` to slot `slot`'s usage on dev (no check) */
void vtpu_region_add_nolock(vtpu_shared_region* r, int slot, int dev,
                            int kind, uint64_t bytes);
void vtpu_region_sub_nolock(vtpu_shared_region* r, int slot, int dev,
                            int kind, uint64_t bytes);

/* in a child after fork(): forget the parent's open regions (their fds
 * share the parent's open file description, so the parent's flock would
 * not exclude the child) and reset the process-local mutex. */
void vtpu_region_atfork_child(void);

#ifdef __cplusplus
}
#endif

#endif /* VTPU_SHARED_REGION_H_ */
