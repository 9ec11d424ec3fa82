"""Cooperative enforcement runtime for PyTorch tenants.

``vtpu/shim/runtime.py`` for the port: per-device HBM accounting against
the env-ABI quota with reject-on-exceed, a pinned host tier when
oversubscribed, core-percentage pacing of launches, and the
shared-region write path the node monitor reads.  ``vtpu_torch.bench.
share`` builds its four-tenant run on this class.

It reads the env names the unchanged device plugin writes at Allocate
(``vtpu/plugin/strategy.py``): ``TPU_DEVICE_MEMORY_LIMIT_<i>`` (MiB),
``TPU_DEVICE_CORES_LIMIT``, ``TPU_DEVICE_MEMORY_SHARED_CACHE``,
``TPU_TASK_PRIORITY``, ``TPU_CORE_UTILIZATION_POLICY``,
``VTPU_VISIBLE_UUIDS``, ``VTPU_OVERSUBSCRIBE``, ``VTPU_ACTIVE_OOM_KILLER``,
``VTPU_PACE_SYNC_EVERY`` and ``VTPU_PACE_SYNC_MAX``.

Completion.  A CUDA launch returns before the card has done the work, as
a JAX dispatch does.  Where the runtime must know that a step is done
(warm-up, calibration, the drain, ``throttled``) it records an event on
the tenant's own stream after the step and waits on that event -- never
``torch.cuda.synchronize()``, which would also wait for the other
tenants' work and fold it into this tenant's step time.

Pacing.  ``dispatch`` keeps the reference's warmup -> calibrate -> run
machine and its adaptive drain cadence.  In the run state it paces to a
deadline: the next launch starts no earlier than T * 100 / q after the
previous one started, T being the calibrated step.  When ``fn`` blocks
for its step (every test of the reference) that is the reference's sleep
of T * (100 - q) / q after the step; when ``fn`` only enqueues (an eager
PyTorch forward issues its kernels in a fraction of T) the reference's
sleep would let the duty climb to min(1, q / (100 - q)), the deadline
holds it at q %.  That is a fault of the reference which the port
repairs; ``vtpu_torch.bench.share.ReferencePacing`` keeps the
reference's rule, so that the share bench can measure both.

Device errors.  Only device-side failures feed the region's error
streak (the XID-analog health stream); a tenant's own faults never mark
the card unhealthy, as the reference skips XIDs 31, 43 and 45:

=====================================================  =================  ======
CUDA error (message part)                               XLA status it is   counts
=====================================================  =================  ======
uncorrectable ECC error (214; XID 48, 94, 95)           DATA_LOSS          yes
uncorrectable NVLink error (220; XID 74)                DATA_LOSS          yes
device(s) busy or unavailable (46), no CUDA-capable     UNAVAILABLE        yes
device (100; XID 79, fallen off the bus)
launch timed out (702)                                  DEADLINE_EXCEEDED  yes
hardware stack error (714), unknown error (999)         INTERNAL           yes
illegal memory access (700; XID 31)                     tenant's program   no
unspecified launch failure (719), device-side assert    tenant's program   no
(710; XID 13, 43), misaligned address, illegal
instruction, invalid argument or configuration
``torch.cuda.OutOfMemoryError``, ``QuotaExceeded``      RESOURCE_EXHAUSTED no
=====================================================  =================  ======

XLA's ABORTED has no CUDA counterpart: a context does not abort on its
own.

Observability, at the reference's sites: the ``shim`` registry's
``vtpu_shim_pace_sleep_seconds`` (every pacing sleep, ``dispatch`` and
``throttled``) and ``vtpu_shim_quota_check_seconds`` (every region
check-and-add, and every local quota check); the ``shim.init`` span,
joined to the pod's trace through ``VTPU_TRACE_CONTEXT``, and the span
push to ``VTPU_SPAN_SINK`` at start and at ``close``.
"""

from __future__ import annotations

import functools
import logging
import os
import time
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vtpu_torch import obs
from vtpu_torch.device import resolve_device
from vtpu_torch.monitor.shared_region import (
    RegionFile,
    effective_core_limit,
    open_region,
)
from vtpu_torch.utils import trace
from vtpu_torch.utils.envs import env_int, env_str
from vtpu_torch.utils.offload import to_device, to_host_tier

log = logging.getLogger(__name__)

_SHIM_REG = obs.registry("shim")
_PACE_HIST = _SHIM_REG.histogram(
    "vtpu_shim_pace_sleep_seconds",
    "Core-percentage pacing sleeps injected per dispatch",
)
_QUOTA_HIST = _SHIM_REG.histogram(
    "vtpu_shim_quota_check_seconds",
    "HBM-quota check-and-add latency (region flock + accounting)",
)

# message parts of the CUDA errors that are the device's, not the
# tenant's (the table in the module docstring)
_DEVICE_ERRORS = (
    "uncorrectable ECC error",
    "uncorrectable NVLink error",
    "busy or unavailable",
    "no CUDA-capable device",
    "launch timed out",
    "hardware stack error",
    "CUDA error: unknown error",
)


class QuotaExceeded(MemoryError):
    """HBM quota exhausted (the check_oom reject, ref libvgpu.so)."""


def stream_to_device(tree, device="cuda"):
    """Bring host-tier tensors back to the card: the explicit stream-in
    of the host-offload pattern, a ``non_blocking`` copy that overlaps
    the compute queued after it.  Tensors already there are returned as
    they are."""
    return to_device(tree, resolve_device(device))


def _oom_reject(runtime: "ShimRuntime", msg: str) -> "QuotaExceeded":
    """Build the quota-reject outcome: normally an exception, but with
    ACTIVE_OOM_KILLER the tenant process is terminated -- SIGKILL, like
    the reference -- so a tenant that ignores the reject cannot spin
    forever."""
    if runtime.active_oom_killer:
        import signal

        log.error("ACTIVE_OOM_KILLER: %s -- killing pid %d", msg, os.getpid())
        logging.shutdown()
        os.kill(os.getpid(), signal.SIGKILL)
    return QuotaExceeded(msg)


def _nbytes_of(x) -> int:
    """Byte size of a tensor or array-like without copying it: a tensor
    is numel x element size, an array its ``nbytes`` or shape x dtype;
    only an object with neither (a nested list, a scalar) is converted."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    nb = getattr(x, "nbytes", None)
    if nb is not None:
        return int(nb)
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        size = 1
        for d in shape:
            size *= int(d)
        return size * int(np.dtype(dtype).itemsize)
    return int(np.asarray(x).nbytes)


def _env_limits() -> List[int]:
    out = []
    i = 0
    while True:
        v = os.environ.get(f"TPU_DEVICE_MEMORY_LIMIT_{i}")
        if v is None:
            break
        out.append(int(v) * 1024 * 1024)
        i += 1
    return out


class ShimRuntime:
    """One tenant's view of a shared card.

    Parameters mirror the env ABI; explicit args override env (tests and
    the share bench run several tenants in one process).  ``device`` is
    where ``device_put`` places tensors (``"cuda"`` unless the caller
    asks for the CPU); ``stream`` is the tenant's own CUDA stream, under
    which ``dispatch`` and ``throttled`` run ``fn`` (None: the caller's
    current stream)."""

    def __init__(
        self,
        limits_bytes: Optional[List[int]] = None,
        core_limit: Optional[int] = None,
        region_path: Optional[str] = None,
        uuids: Optional[List[str]] = None,
        pid: Optional[int] = None,
        priority: Optional[int] = None,
        oversubscribe: Optional[bool] = None,
        clock=None,
        *,
        device="cuda",
        stream: Optional["torch.cuda.Stream"] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.stream = stream
        # injectable time source for pacing + duty accounting: anything
        # with .monotonic() and .sleep() (default: the time module)
        self._clock = clock if clock is not None else time
        self.limits = limits_bytes if limits_bytes is not None else _env_limits()
        self.core_limit = (
            core_limit
            if core_limit is not None
            else int(os.environ.get("TPU_DEVICE_CORES_LIMIT", "100") or 100)
        )
        # TPU_CORE_UTILIZATION_POLICY: default -> throttle, the monitor's
        # arbiter may suspend; force -> throttle even when
        # utilization_switch suspends; disable -> never throttle
        policy = os.environ.get("TPU_CORE_UTILIZATION_POLICY", "default")
        self.core_policy = policy if policy in ("force", "disable") else "default"
        if self.core_policy == "disable":
            self.core_limit = 100
        self.oversubscribe = (
            oversubscribe
            if oversubscribe is not None
            else env_str("VTPU_OVERSUBSCRIBE") == "true"
        )
        # kill the tenant on quota reject instead of raising an error it
        # may swallow and retry forever (ref ACTIVE_OOM_KILLER)
        self.active_oom_killer = env_str("VTPU_ACTIVE_OOM_KILLER") == "true"
        self.priority = (
            priority
            if priority is not None
            else int(os.environ.get("TPU_TASK_PRIORITY", "0") or 0)
        )
        self.pid = pid if pid is not None else os.getpid()
        path = region_path or os.environ.get(
            "TPU_DEVICE_MEMORY_SHARED_CACHE", "/tmp/vtpu/vtpu.cache"
        )
        # the last leg of the pod-lifecycle trace: the plugin's Allocate
        # forwards its span context through the env ABI
        with trace.span("shim.init",
                        ctx=env_str("VTPU_TRACE_CONTEXT") or None,
                        tenant_pid=self.pid):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.region: Optional[RegionFile] = open_region(path,
                                                            create=True)
            if self.region is not None:
                names = uuids or env_str("VTPU_VISIBLE_UUIDS",
                                         "tpu-0").split(",")
                self.region.set_devices(
                    names,
                    (self.limits + [0] * len(names))[: len(names)],
                    [self.core_limit] * len(names),
                )
                # fresh: this runtime is starting up -- a dead
                # predecessor's recycled pid must not hand it phantom usage
                self.region.register_proc(self.pid, self.priority,
                                          fresh=True)
        # the span feed out of the container (VTPU_SPAN_SINK comes with the
        # trace context from Allocate)
        self._span_sink = env_str("VTPU_SPAN_SINK")
        self._push_spans()
        # local (per-tenant) accounting mirrors the region
        self._local: Dict[int, int] = {}
        # bytes placed in the host tier past quota (oversubscribe)
        self._swapped: Dict[int, int] = {}
        # id(tensor) -> stack of (dev, nbytes, tier) for release()
        self._placements: Dict[int, list] = {}
        # pacing estimate for dispatch() (seconds per step), and when the
        # last paced or calibrated launch started (the deadline's origin)
        self._last_step_s = 0.0
        self._launch_t = 0.0
        # closed-loop calibration: every N dispatches, drain the stream
        # and time ONE synchronous step -- the true device step time
        # (a launch returns at once, so its host time says nothing)
        self._sync_base = max(1, env_int("VTPU_PACE_SYNC_EVERY", 8))
        # adaptive interval: each calibration within 20% of the previous
        # one doubles it (up to VTPU_PACE_SYNC_MAX, default 8x base); any
        # shift in the measured step time resets it to base
        self._sync_max = max(
            self._sync_base,
            env_int("VTPU_PACE_SYNC_MAX", 8 * self._sync_base),
        )
        self._sync_every = self._sync_base
        self._since_sync = 0
        self._pace_state = "warmup"  # warmup -> calibrate -> run

    # ------------------------------------------------------------------
    def limit_for(self, dev: int) -> int:
        if dev < len(self.limits):
            return self.limits[dev]
        return 0

    def device_usage(self, dev: int) -> int:
        if self.region is not None:
            return self.region.usage()[dev]["total"] if dev < self.region.region.num_devices else 0
        return self._local.get(dev, 0)

    def try_alloc(self, nbytes: int, dev: int = 0, kind: str = "buffer") -> None:
        """Account an allocation; raise QuotaExceeded when over quota
        (unless oversubscribe).  Check-and-add is atomic under the
        region's cross-process flock -- two tenants racing for the last
        bytes cannot both be admitted."""
        limit = self.limit_for(dev)
        t0 = time.perf_counter()
        if self.region is not None:
            ok = self.region.try_add(
                self.pid, dev, nbytes, kind, limit=limit,
                oversubscribe=self.oversubscribe,
            )
            _QUOTA_HIST.observe(time.perf_counter() - t0)
            if not ok:
                raise _oom_reject(
                    self,
                    f"vtpu: device {dev} quota {limit} B exceeded "
                    f"(in use {self.device_usage(dev)}, want {nbytes})",
                )
        elif limit and not self.oversubscribe:
            over = self._local.get(dev, 0) + nbytes > limit
            _QUOTA_HIST.observe(time.perf_counter() - t0)
            if over:
                raise _oom_reject(
                    self, f"vtpu: device {dev} quota {limit} B exceeded"
                )
        self._local[dev] = self._local.get(dev, 0) + nbytes

    def free(self, nbytes: int, dev: int = 0, kind: str = "buffer") -> None:
        if self.region is not None:
            self.region.sub_usage(self.pid, dev, nbytes, kind)
        self._local[dev] = max(0, self._local.get(dev, 0) - nbytes)

    # ------------------------------------------------------------------
    def _try_alloc_device_tier(self, nbytes: int, dev: int) -> bool:
        """Strict check-and-add into the device tier (no oversubscribe
        bypass) -- atomic under the region flock."""
        limit = self.limit_for(dev)
        if self.region is not None:
            t0 = time.perf_counter()
            ok = self.region.try_add(
                self.pid, dev, nbytes, "buffer", limit=limit, oversubscribe=False
            )
            _QUOTA_HIST.observe(time.perf_counter() - t0)
            if ok:
                self._local[dev] = self._local.get(dev, 0) + nbytes
            return ok
        if limit and self._local.get(dev, 0) + nbytes > limit:
            return False
        self._local[dev] = self._local.get(dev, 0) + nbytes
        return True

    def _device_of(self, dev: int) -> torch.device:
        if self.device.type == "cuda":
            return torch.device("cuda", dev)
        return self.device

    def device_put(self, x, dev: int = 0) -> torch.Tensor:
        """``x`` (a tensor or array-like) on device ``dev``, through the
        quota (accounts its bytes).

        Over quota with oversubscribe on, the tensor lands in pinned HOST
        memory instead (the virtual-device-memory tier, ref
        CUDA_OVERSUBSCRIBE's host-RAM swap); the tenant streams it back
        with :func:`stream_to_device`.  The tier decision is atomic
        against other tenants, recorded per tensor and undone by
        ``release(t)`` -- pair device_put with release, not raw ``free``,
        or the tiers' accounting drifts.  A put of a tensor already on
        the device returns the same object and charges it again."""
        nbytes = _nbytes_of(x)
        if self._try_alloc_device_tier(nbytes, dev):
            out = torch.as_tensor(x, device=self._device_of(dev))
            self._record_placement(out, dev, nbytes, "device")
            return out
        if not self.oversubscribe:
            raise _oom_reject(
                self,
                f"vtpu: device {dev} quota {self.limit_for(dev)} B exceeded "
                f"(in use {self.device_usage(dev)}, want {nbytes})",
            )
        out = to_host_tier(x)
        self._swapped[dev] = self._swapped.get(dev, 0) + nbytes
        if self.region is not None:
            # publish the host tier so the monitor's breakdown shows it
            # (kind 2/"swap" in the region -- same as the native shim)
            self.region.add_usage(self.pid, dev, nbytes, "swap")
        self._record_placement(out, dev, nbytes, "host")
        return out

    def _record_placement(self, out, dev: int, nbytes: int, tier: str) -> None:
        """Track a put for release().  Records stack per object id (a
        re-put returns the SAME tensor, so one id can owe several
        charges), and a weakref finalizer releases whatever is still owed
        when the tensor is collected."""
        key = id(out)
        stack = self._placements.setdefault(key, [])
        stack.append((dev, nbytes, tier))
        if len(stack) == 1:
            weakref.finalize(out, self._release_all_for, key)

    def _release_one(self, key: int) -> bool:
        stack = self._placements.get(key)
        if not stack:
            return False
        dev, nbytes, tier = stack.pop()
        if not stack:
            self._placements.pop(key, None)
        if tier == "device":
            self.free(nbytes, dev)
        else:
            self._swapped[dev] = max(0, self._swapped.get(dev, 0) - nbytes)
            if self.region is not None:
                self.region.sub_usage(self.pid, dev, nbytes, "swap")
        return True

    def _release_all_for(self, key: int) -> None:
        while self._release_one(key):
            pass

    def release(self, t) -> None:
        """Undo a device_put: frees the device tier or shrinks the swap
        counter, whichever tier the tensor landed in (LIFO when the same
        object was put more than once)."""
        self._release_one(id(t))

    # ------------------------------------------------------------------
    def dispatch(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` through the shim WITHOUT waiting for its work -- the
        pipelined variant of :meth:`throttled`.  Records the launch in
        the shared region (the utilization-watcher counter the monitor's
        arbiter decays) and applies core-percentage pacing.

        The pacing estimate is closed-loop: while a core limit is
        active, the loop periodically drains the tenant's stream, and
        the step after the drain runs synchronously against an empty
        queue -- its wall time is the true step time T.  Each later
        launch starts no earlier than T x 100 / q after the previous
        one, which holds the duty at q % however deep the caller
        pipelines and however long ``fn`` takes to enqueue.

        The drain cadence is adaptive: every ``VTPU_PACE_SYNC_EVERY``-th
        step (default 8), doubling after each calibration within 20 % of
        the previous one, up to ``VTPU_PACE_SYNC_MAX`` (default 8x base);
        any shift in the step time resets it.  Every dispatch publishes
        a launch and a device-busy estimate into the region (v4), which
        the monitor's UtilizationSampler diffs into a duty ratio."""
        q, suspended = self._effective_quota()
        if not (0 < q < 100) or suspended:
            if self._last_step_s > 0:
                self._note_launch(self._last_step_s)
                return self._run_fn(fn, args, kwargs)
            # no calibrated estimate (pacing never active): the host-side
            # call duration, the open-loop floor the native shim uses too,
            # so an unthrottled tenant never reads duty 0
            t0 = self._clock.monotonic()
            out = self._run_fn(fn, args, kwargs)
            self._note_launch(self._clock.monotonic() - t0)
            return out
        if self._pace_state == "warmup":
            # first paced step: retire it but DISCARD the timing (it holds
            # the kernels' build and cuDNN's first plans), calibrate next
            self._note_launch(0.0)
            out = self._run_fn(fn, args, kwargs)
            self._retire(out)
            self._pace_state = "calibrate"
            return out
        if self._pace_state == "calibrate":
            # the queue is empty (the previous step was retired): one
            # synchronous step = enqueue + device + wait, the real T
            t0 = self._clock.monotonic()
            self._launch_t = t0
            out = self._run_fn(fn, args, kwargs)
            self._retire(out)
            measured = self._clock.monotonic() - t0
            self._note_launch(measured)
            prev = self._last_step_s
            self._last_step_s = measured
            if prev > 0 and abs(measured - prev) <= 0.2 * prev:
                self._sync_every = min(self._sync_max, self._sync_every * 2)
            else:
                self._sync_every = self._sync_base
            self._pace_state = "run"
            self._since_sync = 0
            return out
        self._note_launch(self._last_step_s)
        if self._last_step_s > 0:
            self._pace(q)
        self._launch_t = self._clock.monotonic()
        out = self._run_fn(fn, args, kwargs)
        self._since_sync += 1
        if self._since_sync >= self._sync_every:
            # drain so the next step can re-calibrate against an idle queue
            self._retire(out)
            self._pace_state = "calibrate"
        return out

    def _pace(self, q: int) -> None:
        """The run state's wait: until T x 100 / q after the previous
        launch started."""
        pause = (self._launch_t + self._last_step_s * 100 / q
                 - self._clock.monotonic())
        if pause > 0:
            self._clock.sleep(pause)
            _PACE_HIST.observe(pause)

    def _effective_quota(self) -> tuple:
        """``(core quota %, suspended)`` for this dispatch from the core
        limit, the policy and the region's utilization_switch:

        - switch 1 SUSPENDS throttling (priority arbitration) unless the
          policy is ``force``;
        - switch >= THROTTLE_LEVEL_MIN is the arbiter's graduated
          SQUEEZE: the quota halves per level (effective_core_limit),
          imposed even on tenants with no quota of their own; only
          policy ``disable`` opts out."""
        if self.region is None:
            return self.core_limit, False
        switch = self.region.region.utilization_switch
        if switch == 1:
            return self.core_limit, self.core_policy != "force"
        q = self.core_limit
        if self.core_policy != "disable":
            q = effective_core_limit(q, switch)
        return q, False

    def _note_launch(self, busy_s: float, dev: int = 0) -> None:
        """Publish one launch + busy-ns estimate to the region (one
        flock, shared with the recent_kernel activity bump)."""
        if self.region is not None:
            self.region.record_launch(self.pid, dev, int(busy_s * 1e9))

    @staticmethod
    def _is_device_error(e: BaseException) -> bool:
        """True for the device's own failures (the table in the module
        docstring); a tenant's program faults, its OOM and quota rejects
        are False."""
        if isinstance(e, MemoryError):  # QuotaExceeded, host OOM
            return False
        text = f"{type(e).__name__}: {e}"
        return any(tag in text for tag in _DEVICE_ERRORS)

    def _on_stream(self, fn, args, kwargs):
        if self.stream is None:
            return fn(*args, **kwargs)
        with torch.cuda.stream(self.stream):
            return fn(*args, **kwargs)

    def _run_fn(self, fn, args, kwargs):
        """Run one launch on the tenant's stream, feeding the outcome into
        the region's device-error telemetry.  Success takes the region
        lock only when it must clear a streak."""
        try:
            out = self._on_stream(fn, args, kwargs)
        except Exception as e:
            if self.region is not None and self._is_device_error(e):
                self.region.record_exec_result(False)
            raise
        if self.region is not None and self.region.region.error_streak != 0:
            self.region.record_exec_result(True)
        return out

    def _retire(self, out) -> None:
        """Wait until the tenant's work so far is done.  An ``out`` with
        its own ``synchronize`` (a CUDA event, or a test's fake result)
        is waited on; otherwise, on a CUDA runtime, an event is recorded
        on the tenant's stream and waited on (work on a CPU runtime is
        already done).  Completion errors are suppressed -- they are not
        pacing errors, the caller sees them when it reads the value --
        but device-side failures still feed the health streak."""
        try:
            sync = getattr(out, "synchronize", None)
            if callable(sync):
                sync()
            elif self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(self.stream if self.stream is not None
                          else torch.cuda.current_stream(self.device))
                ev.synchronize()
        except Exception as e:  # noqa: BLE001 -- completion != pacing errors
            if self.region is not None and self._is_device_error(e):
                self.region.record_exec_result(False)

    def observe_step(self, seconds: float) -> None:
        """Feed a measured per-step device time back into dispatch()'s
        pacing estimate."""
        if seconds > 0:
            self._last_step_s = seconds

    def throttled(self, fn: Callable) -> Callable:
        """Wrap a callable with core-percentage pacing -- the
        utilization-watcher analog: after each call (waited for on the
        tenant's stream), sleep (100-q)/q x call time, keeping the duty
        at q %.  The monitor's utilization_switch suspends it."""

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = self._clock.monotonic()
            out = self._on_stream(fn, args, kwargs)
            self._retire(out)
            dt = self._clock.monotonic() - t0
            if self.region is not None:
                # synchronous path: the waited call time IS the busy time
                self._note_launch(dt)
            q, suspended = self._effective_quota()
            if 0 < q < 100 and not suspended:
                pause = dt * (100 - q) / q
                self._clock.sleep(pause)
                _PACE_HIST.observe(pause)
            return out

        return wrapper

    def memory_stats(self, dev: int = 0) -> Dict[str, int]:
        """Quota-aware stats (the nvidia-smi-equivalence surface)."""
        return {
            "bytes_limit": self.limit_for(dev),
            "bytes_in_use": self.device_usage(dev),
            "bytes_host_swapped": self._swapped.get(dev, 0),
        }

    def _push_spans(self) -> None:
        """Best-effort ring push to the collector; a missing or down
        collector never affects the tenant."""
        if self._span_sink and trace.tracing():
            try:
                trace.push_spans(self._span_sink, timeout=2.0)
            except Exception:  # noqa: BLE001 -- telemetry must not break tenants
                log.debug("span push to %s failed", self._span_sink,
                          exc_info=True)

    def close(self) -> None:
        self._push_spans()
        if self.region is not None:
            self.region.close()
            self.region = None
