"""GPU device provider over NVML: the GPU twin of ``vtpu/device/pjrt.py``.

``NvmlProvider`` enumerates the node's NVIDIA cards through NVML
(``libnvidia-ml.so.1``, bound with ``ctypes`` and loaded at first use)
and answers ``enumerate()``, ``topology()`` and ``health_check()`` by
duck typing, so the unchanged device plugin (``vtpu/plugin``) registers
and serves its cards and the unchanged scheduler places pods on them.

The cards are served as the plugin's second family
(``PluginConfig(device_family="pjrt")``: resource ``vtpu.io/pjrt``,
annotation ``vtpu.io/node-pjrt-register``, env prefix ``PJRT_``), the
role ``PjrtProvider`` plays for GPUs in the reference.

- ``uuid`` is NVML's ``GPU-...`` UUID, ``hbm_mb`` the card's memory in
  MiB, ``devpath`` ``/dev/nvidia<minor>``.  ``model`` is
  ``"PJRT-NVIDIA-<name>"``: the reference's Type (``"NVIDIA-<name>"``)
  behind the family's vendor prefix, which the unchanged scheduler
  requires of every device a ``vtpu.io/pjrt`` request may take
  (``vtpu/scheduler/score.py``, ``_type_allowed``).
- Topology: ``(n, 1, 1)`` with no wrap and no per-chip coordinates, as
  ``PjrtProvider`` has it; an NVSwitch makes every pair of a node's
  cards equal.
- Health: each poll re-probes every card with an NVML memory query under
  a deadline, at most one probe thread per card (a wedged driver hangs
  rather than errors), and adds the tenants' region error streaks
  (``vtpu_torch.device.health``).  A card recovers when its probe
  succeeds again and no region holds a streak for it.
- Without NVML the provider lists no card and logs why.  It never falls
  back to ``torch.cuda``: a daemon holding a CUDA context holds memory
  on the card it hands out, and the fallback would hide a broken NVML.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import threading
from typing import Dict, List, Optional

from vtpu_torch.device.chip import Chip
from vtpu_torch.device.health import region_unhealthy_uuids
from vtpu_torch.device.topology import Topology
from vtpu_torch.utils.envs import env_float

log = logging.getLogger(__name__)

NVML_LIBRARY = "libnvidia-ml.so.1"
# the pjrt family's vendor prefix, then the reference's "NVIDIA-<name>"
MODEL_PREFIX = "PJRT-NVIDIA-"
ENV_PROBE_TIMEOUT = "VTPU_PROBE_TIMEOUT_S"
_UUID_LEN = 96   # NVML_DEVICE_UUID_V2_BUFFER_SIZE
_NAME_LEN = 96   # NVML_DEVICE_NAME_V2_BUFFER_SIZE


class NvmlError(RuntimeError):
    """An NVML call returned an error code."""


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class Nvml:
    """The few NVML calls the provider makes, on one loaded library.
    Raises ``OSError`` when the library does not load and
    :class:`NvmlError` when ``nvmlInit_v2`` fails."""

    def __init__(self, library: str = NVML_LIBRARY) -> None:
        lib = ctypes.CDLL(library)
        H = ctypes.c_void_p
        for name, args in (
            ("nvmlInit_v2", ()),
            ("nvmlDeviceGetCount_v2", (ctypes.POINTER(ctypes.c_uint),)),
            ("nvmlDeviceGetHandleByIndex_v2",
             (ctypes.c_uint, ctypes.POINTER(H))),
            ("nvmlDeviceGetUUID", (H, ctypes.c_char_p, ctypes.c_uint)),
            ("nvmlDeviceGetName", (H, ctypes.c_char_p, ctypes.c_uint)),
            ("nvmlDeviceGetMemoryInfo", (H, ctypes.POINTER(_Memory))),
            ("nvmlDeviceGetMinorNumber", (H, ctypes.POINTER(ctypes.c_uint))),
        ):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(args), ctypes.c_int
        lib.nvmlErrorString.argtypes = [ctypes.c_int]
        lib.nvmlErrorString.restype = ctypes.c_char_p
        self._lib = lib
        self._call("nvmlInit_v2")

    def _call(self, name: str, *args) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc != 0:
            msg = self._lib.nvmlErrorString(rc) or b"?"
            raise NvmlError(f"{name}: {msg.decode()} ({rc})")

    def count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def handle(self, index: int) -> ctypes.c_void_p:
        h = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(h))
        return h

    def _text(self, name: str, h, size: int) -> str:
        buf = ctypes.create_string_buffer(size)
        self._call(name, h, buf, size)
        return buf.value.decode()

    def uuid(self, h) -> str:
        return self._text("nvmlDeviceGetUUID", h, _UUID_LEN)

    def name(self, h) -> str:
        return self._text("nvmlDeviceGetName", h, _NAME_LEN)

    def memory(self, h) -> Dict[str, int]:
        """``{"total", "free", "used"}`` in bytes."""
        m = _Memory()
        self._call("nvmlDeviceGetMemoryInfo", h, ctypes.byref(m))
        return {"total": m.total, "free": m.free, "used": m.used}

    def minor(self, h) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetMinorNumber", h, ctypes.byref(n))
        return n.value


class NvmlProvider:
    """``DeviceProvider`` over NVML (see the module docstring).

    ``library`` names the NVML library to load (tests load a mock of it);
    ``containers_root`` is the host root of the tenants' region dirs
    (``vtpu_torch.device.health``; default ``VTPU_CONTAINERS_ROOT``)."""

    def __init__(self, library: str = NVML_LIBRARY,
                 containers_root: Optional[str] = None) -> None:
        self._library = library
        self._root = containers_root
        self._nvml: Optional[Nvml] = None
        self._chips: Optional[List[Chip]] = None
        self._handles: Dict[str, ctypes.c_void_p] = {}
        # uuid -> in-flight probe thread: a wedged driver parks its probe
        # forever, and the next poll must not stack another one on it
        self._probes: Dict[str, threading.Thread] = {}

    def _discover(self) -> List[Chip]:
        try:
            self._nvml = Nvml(self._library)
            chips = []
            for i in range(self._nvml.count()):
                h = self._nvml.handle(i)
                uuid = self._nvml.uuid(h)
                self._handles[uuid] = h
                chips.append(Chip(
                    index=i, uuid=uuid, model=f"{MODEL_PREFIX}{self._nvml.name(h)}",
                    hbm_mb=self._nvml.memory(h)["total"] // 2**20,
                    devpath=f"/dev/nvidia{self._nvml.minor(h)}",
                    tensorcores=1))
        except (OSError, NvmlError) as e:
            log.warning("NVML unavailable (%s): no GPU is served", e)
            self._nvml = None
            return []
        return chips

    def _probe_alive(self, uuid: str, timeout_s: Optional[float] = None
                     ) -> bool:
        """Liveness through an NVML memory query on the card, under a
        deadline: a probe that times out counts as unhealthy, and while
        it is still parked later polls report unhealthy at once instead
        of stacking threads (the parked thread ends when the driver
        answers, and the next poll probes afresh)."""
        if timeout_s is None:
            timeout_s = env_float(ENV_PROBE_TIMEOUT, 5.0)
        prev = self._probes.get(uuid)
        if prev is not None and prev.is_alive():
            return False
        verdict: list = []

        def probe() -> None:
            try:
                self._nvml.memory(self._handles[uuid])
                verdict.append(True)
            except NvmlError:
                verdict.append(False)

        t = threading.Thread(target=probe, name=f"nvml-probe-{uuid}",
                             daemon=True)
        t.start()
        t.join(timeout_s)
        self._probes[uuid] = t
        return bool(verdict) and verdict[0]

    # -- DeviceProvider ----------------------------------------------------
    def enumerate(self) -> List[Chip]:
        if self._chips is None:
            self._chips = self._discover()
        return list(self._chips)

    def topology(self) -> Topology:
        n = len(self.enumerate())
        return Topology((max(n, 1), 1, 1), wrap=(False, False, False))

    def health_check(self) -> List[Chip]:
        """Re-probe each card every poll (the device set stays as first
        enumerated: kubelet identity must not change)."""
        base = self.enumerate()
        sick = region_unhealthy_uuids(self._root) if base else set()
        out = []
        for c in base:
            alive = self._probe_alive(c.uuid) and c.uuid not in sick
            out.append(c if alive == c.healthy
                       else dataclasses.replace(c, healthy=alive))
        self._chips = out
        return list(out)
