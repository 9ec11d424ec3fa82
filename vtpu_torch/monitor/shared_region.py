"""ctypes mirror of the shared region (cpp/shared_region.h), v4, with
the v3 read path.

The port's own copy of ``vtpu/monitor/shared_region.py`` (it imports
nothing of vtpu).  The layout must match that module and
``cpp/shared_region.h`` byte for byte: the unchanged node monitor
(``vtpu/monitor/sampler.py``) and the native shim read and write the
same file.  ``tests/test_torch_region.py`` holds the two mirrors to the
same struct sizes and reads each one's writes with the other.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import mmap
import os
import struct
from typing import Dict, List, Optional

VTPU_REGION_MAGIC = 0x76545055
VTPU_REGION_VERSION = 4
MAX_DEVICES = 16
MAX_PROCS = 64
UUID_LEN = 64

# utilization_switch throttle ladder (layout-compatible extension of the
# original binary switch — same int32 field, new value range):
#   0           enforce the configured core quota (the original default)
#   1           suspend throttling (priority arbitration, the original 1)
#   2..MAX      graduated SQUEEZE: the effective core quota halves per
#               level (level 2 = 1/2, 3 = 1/4, 4 = 1/8) — the monitor's
#               contention arbiter walks best-effort tenants down this
#               ladder before asking for eviction.  Shims that predate
#               the ladder read any value != 1 as "enforce", so a mixed
#               fleet degrades to plain enforcement, never to suspend.
THROTTLE_LEVEL_MIN = 2
THROTTLE_LEVEL_MAX = 4


def effective_core_limit(core_limit: int, switch: int) -> int:
    """Resolve the core quota a pacing path must enforce under the
    throttle ladder.  ``switch`` values below the ladder leave the quota
    alone (0 = enforce, 1 = suspend is the CALLER's branch — suspension
    must stay policy-aware).  An unthrottled tenant (quota 0 or 100)
    squeezes from a whole-chip baseline: the ladder imposes a quota on
    tenants that never had one."""
    if switch < THROTTLE_LEVEL_MIN:
        return core_limit
    level = min(switch, THROTTLE_LEVEL_MAX)
    base = core_limit if 0 < core_limit < 100 else 100
    return max(1, base >> (level - 1))


class DeviceUsage(ctypes.Structure):
    _fields_ = [
        ("program_bytes", ctypes.c_uint64),
        ("buffer_bytes", ctypes.c_uint64),
        ("total_bytes", ctypes.c_uint64),
        # host-tier bytes past quota (oversubscribe); not part of total
        ("swap_bytes", ctypes.c_uint64),
        # utilization profiling (v4): monotonic counters the monitor's
        # UtilizationSampler diffs into duty-cycle ratios, plus the
        # HBM high-watermark (ratchets up on add, never down on sub)
        ("busy_ns", ctypes.c_uint64),
        ("launches", ctypes.c_uint64),
        ("hbm_peak_bytes", ctypes.c_uint64),
    ]


class ProcSlot(ctypes.Structure):
    _fields_ = [
        ("pid", ctypes.c_int32),
        ("hostpid", ctypes.c_int32),
        ("status", ctypes.c_int32),
        ("priority", ctypes.c_int32),
        # interposer telemetry (v3): execute count + wrapper-added ns,
        # written lock-free by the owning tenant process
        ("exec_calls", ctypes.c_uint64),
        ("exec_shim_ns", ctypes.c_uint64),
        ("used", DeviceUsage * MAX_DEVICES),
    ]


class SharedRegion(ctypes.Structure):
    _fields_ = [
        ("magic", ctypes.c_uint32),
        ("version", ctypes.c_uint32),
        ("initialized", ctypes.c_int32),
        ("owner_pid", ctypes.c_int32),
        ("lock", ctypes.c_int32),
        ("num_devices", ctypes.c_int32),
        ("utilization_switch", ctypes.c_int32),
        ("recent_kernel", ctypes.c_int32),
        # device-error telemetry (XID-analog): consecutive execute errors
        # + cumulative count, written by the shim's execute path
        ("error_streak", ctypes.c_int32),
        ("exec_errors", ctypes.c_int32),
        ("uuids", (ctypes.c_char * UUID_LEN) * MAX_DEVICES),
        ("limit_bytes", ctypes.c_uint64 * MAX_DEVICES),
        ("core_limit", ctypes.c_int32 * MAX_DEVICES),
        ("proc_num", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
        ("reserved", ctypes.c_uint64 * 8),
        ("procs", ProcSlot * MAX_PROCS),
    ]


REGION_SIZE = ctypes.sizeof(SharedRegion)


# -- legacy v3 layout (read path for regions written by pre-v4 shims; a
# long-running tenant keeps its region across a monitor upgrade, so the
# monitor must keep reading it — the new counters read as 0 there) -------

class _DeviceUsageV3(ctypes.Structure):
    _fields_ = DeviceUsage._fields_[:4]


class _ProcSlotV3(ctypes.Structure):
    _fields_ = ProcSlot._fields_[:6] + [("used", _DeviceUsageV3 * MAX_DEVICES)]


class _SharedRegionV3(ctypes.Structure):
    _fields_ = SharedRegion._fields_[:16] + [("procs", _ProcSlotV3 * MAX_PROCS)]


REGION_SIZE_V3 = ctypes.sizeof(_SharedRegionV3)


class RegionFile:
    """mmap a region file read-write (ref mmapcachefile cudevshr.go:112-127).
    The monitor only mutates utilization_switch / hostpid fields."""

    def __init__(self, path: str, create: bool = False) -> None:
        self.path = path
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        fd = os.open(path, flags, 0o666)
        try:
            size = os.fstat(fd).st_size
            # sniff magic+version BEFORE sizing: a v3 region written by a
            # pre-v4 shim is smaller than the current layout and must be
            # mapped with the legacy struct, not grown and misread
            header = os.pread(fd, 8, 0) if size >= 8 else b""
            magic0, version0 = (
                struct.unpack("=II", header) if len(header) == 8 else (0, 0)
            )
            self._legacy = magic0 == VTPU_REGION_MAGIC and version0 == 3
            layout = _SharedRegionV3 if self._legacy else SharedRegion
            region_size = ctypes.sizeof(layout)
            if size < region_size:
                if not create or self._legacy:
                    raise ValueError(f"{path}: too small for a vtpu region")
                os.ftruncate(fd, region_size)
            self._mm = mmap.mmap(fd, region_size)
        except BaseException:
            os.close(fd)
            raise
        # fd stays open: it carries the cross-process flock that both this
        # mirror and the C library (cpp/shared_region.cc) take around every
        # mutation — same file, same lock, released by the kernel on death
        self._fd = fd
        self.region = layout.from_buffer(self._mm)
        if create and self.region.magic == 0:
            self.region.magic = VTPU_REGION_MAGIC
            self.region.version = VTPU_REGION_VERSION
            self.region.initialized = 1
        magic, version = self.region.magic, self.region.version
        if magic != VTPU_REGION_MAGIC:
            self.close()
            raise ValueError(f"{path}: bad magic {magic:#x}")
        if version != (3 if self._legacy else VTPU_REGION_VERSION):
            self.close()
            raise ValueError(f"{path}: region version {version}")
        self.version = version

    @contextlib.contextmanager
    def _locked(self):
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(self._fd, fcntl.LOCK_UN)

    # -- read side -------------------------------------------------------
    def device_uuids(self) -> List[str]:
        r = self.region
        return [r.uuids[i].value.decode() for i in range(r.num_devices)]

    def limits(self) -> List[int]:
        r = self.region
        return [r.limit_bytes[i] for i in range(r.num_devices)]

    def core_limits(self) -> List[int]:
        r = self.region
        return [r.core_limit[i] for i in range(r.num_devices)]

    def usage(self) -> List[Dict[str, int]]:
        """Per-device totals across live procs (ref getvGPUMemoryInfo)."""
        with self._locked():
            return self._usage_nolock()

    def _usage_nolock(self) -> List[Dict[str, int]]:
        r = self.region
        legacy = self._legacy
        out = []
        for d in range(r.num_devices):
            buf = prog = swap = busy = launches = peak = 0
            for p in range(MAX_PROCS):
                if r.procs[p].status == 1:
                    u = r.procs[p].used[d]
                    buf += u.buffer_bytes
                    prog += u.program_bytes
                    swap += u.swap_bytes
                    if not legacy:
                        busy += u.busy_ns
                        launches += u.launches
                        # summed per-proc peaks: an upper bound on the
                        # container's true simultaneous peak (procs may
                        # peak at different times), monotone like them
                        peak += u.hbm_peak_bytes
            out.append(
                {"buffer": buf, "program": prog, "total": buf + prog,
                 "swap": swap, "busy_ns": busy, "launches": launches,
                 "hbm_peak": peak}
            )
        return out

    def live_procs(self) -> List[Dict[str, int]]:
        r = self.region
        out = []
        legacy = self._legacy
        for p in range(MAX_PROCS):
            slot = r.procs[p]
            if slot.status == 1:
                out.append(
                    {
                        "pid": slot.pid,
                        "hostpid": slot.hostpid,
                        "priority": slot.priority,
                        "exec_calls": slot.exec_calls,
                        "exec_shim_ns": slot.exec_shim_ns,
                        "total_bytes": sum(
                            slot.used[d].total_bytes for d in range(r.num_devices)
                        ),
                        "busy_ns": 0 if legacy else sum(
                            slot.used[d].busy_ns for d in range(r.num_devices)
                        ),
                        "launches": 0 if legacy else sum(
                            slot.used[d].launches for d in range(r.num_devices)
                        ),
                    }
                )
        return out

    # -- monitor write side ---------------------------------------------
    def set_utilization_switch(self, value: int) -> None:
        self.region.utilization_switch = value

    def set_hostpid(self, pid: int, hostpid: int) -> None:
        with self._locked():
            self._set_hostpid_nolock(pid, hostpid)

    def _set_hostpid_nolock(self, pid: int, hostpid: int) -> None:
        r = self.region
        for p in range(MAX_PROCS):
            if r.procs[p].status == 1 and r.procs[p].pid == pid:
                r.procs[p].hostpid = hostpid

    def incr_recent_kernel(self, n: int = 1) -> None:
        """Locked kernel-launch count (shim dispatch path): the counter is
        contended by every tenant's dispatch AND the monitor's decay, so a
        bare += would lose increments."""
        with self._locked():
            self.region.recent_kernel += n

    def record_launch(self, pid: int, dev: int, busy_ns: int, n: int = 1) -> None:
        """One dispatch's utilization record under a single flock: the
        shared ``recent_kernel`` activity counter (what incr_recent_kernel
        bumps) plus the v4 per-proc per-device monotonic launch count and
        device-busy estimate the monitor's UtilizationSampler diffs.  On a
        legacy v3 region only the activity counter moves."""
        with self._locked():
            r = self.region
            r.recent_kernel += n
            if self._legacy or not (0 <= dev < MAX_DEVICES):
                return
            for p in range(MAX_PROCS):
                if r.procs[p].status == 1 and r.procs[p].pid == pid:
                    r.procs[p].used[dev].busy_ns += max(0, int(busy_ns))
                    r.procs[p].used[dev].launches += n
                    return

    def record_exec_result(self, ok: bool) -> None:
        """Execute outcome feed (the XID-analog health stream): a success
        resets the consecutive-error streak, a failure bumps it plus the
        cumulative error count."""
        with self._locked():
            if ok:
                self.region.error_streak = 0
            else:
                self.region.error_streak += 1
                self.region.exec_errors += 1

    def decay_recent_kernel(self) -> int:
        """ref Observe (feedback.go): halve the activity counter, return the
        pre-decay value."""
        with self._locked():
            v = self.region.recent_kernel
            self.region.recent_kernel = v // 2
            return v

    # -- writer side (used by the cooperative Python shim) ----------------
    def set_devices(self, uuids: List[str], limits: List[int], cores: List[int]) -> None:
        with self._locked():
            self._set_devices_nolock(uuids, limits, cores)

    def _set_devices_nolock(self, uuids: List[str], limits: List[int], cores: List[int]) -> None:
        r = self.region
        if r.num_devices == 0:
            n = min(len(uuids), MAX_DEVICES)
            r.num_devices = n
            for i in range(n):
                r.uuids[i].value = uuids[i].encode()[: UUID_LEN - 1]
                r.limit_bytes[i] = limits[i]
                r.core_limit[i] = cores[i]

    def register_proc(self, pid: int, priority: int = 0,
                      fresh: bool = False) -> int:
        """``fresh=True`` is for a process KNOWN to be newly started: a
        pid-matching slot left by a dead predecessor (container pid
        recycled) gets its usage/telemetry cleared instead of inherited
        (mirrors vtpu_region_register_proc_fresh)."""
        with self._locked():
            return self._register_proc_nolock(pid, priority, fresh)

    def _register_proc_nolock(self, pid: int, priority: int = 0,
                              fresh: bool = False) -> int:
        r = self.region
        for p in range(MAX_PROCS):
            if r.procs[p].status == 1 and r.procs[p].pid == pid:
                if fresh:
                    ctypes.memset(
                        ctypes.byref(r.procs[p].used), 0,
                        ctypes.sizeof(r.procs[p].used),
                    )
                    r.procs[p].exec_calls = 0
                    r.procs[p].exec_shim_ns = 0
                    r.procs[p].hostpid = 0
                    r.procs[p].priority = priority
                return p
        for p in range(MAX_PROCS):
            if r.procs[p].status == 0:
                ctypes.memset(ctypes.byref(r.procs[p]), 0, ctypes.sizeof(ProcSlot))
                r.procs[p].pid = pid
                r.procs[p].status = 1
                r.procs[p].priority = priority
                r.proc_num += 1
                return p
        return -1

    def reap_dead(self, alive) -> int:
        """Free slots whose process is gone (ref clear_proc_slot_nolock /
        fix_lock_shrreg cleanup): a crashed tenant must not pin its quota
        bytes forever.  ``alive(slot_dict)`` returns True (keep), False
        (reap), or None (unknown — keep; e.g. the monitor cannot verify
        an in-container pid whose hostpid is unresolved).  Returns the
        number of slots freed."""
        freed = 0
        with self._locked():
            r = self.region
            for p in range(MAX_PROCS):
                if r.procs[p].status != 1:
                    continue
                verdict = alive(
                    {"pid": r.procs[p].pid, "hostpid": r.procs[p].hostpid}
                )
                if verdict is False:
                    ctypes.memset(
                        ctypes.byref(r.procs[p]), 0, ctypes.sizeof(ProcSlot)
                    )
                    if r.proc_num > 0:
                        r.proc_num -= 1
                    freed += 1
        return freed

    def try_add(self, pid: int, dev: int, bytes_: int, kind: str = "buffer",
                limit: int = 0, oversubscribe: bool = False) -> bool:
        """Atomic check-and-add under one flock (the check_oom analog,
        mirroring vtpu_region_try_add): returns False when adding would
        exceed ``limit`` (0 = unlimited)."""
        with self._locked():
            self._register_proc_nolock(pid)
            if limit and not oversubscribe:
                used = sum(d["total"] for d in self._usage_nolock()[dev:dev + 1])
                if used + bytes_ > limit:
                    return False
            self._add_usage_nolock(pid, dev, bytes_, kind)
            return True

    def add_usage(self, pid: int, dev: int, bytes_: int, kind: str = "buffer") -> None:
        with self._locked():
            self._add_usage_nolock(pid, dev, bytes_, kind)

    def _add_usage_nolock(self, pid: int, dev: int, bytes_: int, kind: str = "buffer") -> None:
        r = self.region
        for p in range(MAX_PROCS):
            if r.procs[p].status == 1 and r.procs[p].pid == pid:
                u = r.procs[p].used[dev]
                if kind == "program":
                    u.program_bytes += bytes_
                elif kind == "swap":
                    u.swap_bytes += bytes_
                else:
                    u.buffer_bytes += bytes_
                u.total_bytes = u.program_bytes + u.buffer_bytes
                if not self._legacy and u.total_bytes > u.hbm_peak_bytes:
                    u.hbm_peak_bytes = u.total_bytes  # v4 watermark ratchet
                return

    def sub_usage(self, pid: int, dev: int, bytes_: int, kind: str = "buffer") -> None:
        with self._locked():
            self._sub_usage_nolock(pid, dev, bytes_, kind)

    def _sub_usage_nolock(self, pid: int, dev: int, bytes_: int, kind: str = "buffer") -> None:
        r = self.region
        for p in range(MAX_PROCS):
            if r.procs[p].status == 1 and r.procs[p].pid == pid:
                u = r.procs[p].used[dev]
                if kind == "program":
                    u.program_bytes = max(0, u.program_bytes - bytes_)
                elif kind == "swap":
                    u.swap_bytes = max(0, u.swap_bytes - bytes_)
                else:
                    u.buffer_bytes = max(0, u.buffer_bytes - bytes_)
                u.total_bytes = u.program_bytes + u.buffer_bytes
                return

    def close(self) -> None:
        # release the ctypes view before unmapping
        self.region = None  # type: ignore[assignment]
        self._mm.close()
        os.close(self._fd)


def open_region(path: str, create: bool = False) -> Optional[RegionFile]:
    try:
        return RegionFile(path, create=create)
    except (OSError, ValueError):
        return None
