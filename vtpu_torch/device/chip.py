"""Chip model and the provider interface.

The port's own copy of ``vtpu/device/chip.py`` (the port imports nothing
of vtpu).  A provider is what a node agent can ask about local silicon;
it knows nothing about Kubernetes.  The unchanged device plugin
(``vtpu/plugin``) reads these fields by name: ``index``, ``uuid``,
``model``, ``hbm_mb``, ``cores``, ``coords``, ``devpath``, ``healthy``
and ``tensorcores``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Tuple


@dataclasses.dataclass
class Chip:
    """One physical accelerator on this host."""

    index: int                   # local ordinal (device plugin ID basis)
    uuid: str                    # stable ID; NVML's "GPU-<uuid>" on a GPU
    model: str                   # e.g. "NVIDIA-<name>" (the reference's Type)
    hbm_mb: int                  # physical device memory, MiB
    cores: int = 100             # compute capacity in percent units
    coords: Optional[Tuple[int, ...]] = None  # position in a local mesh
    devpath: Optional[str] = None             # e.g. "/dev/nvidia0"
    healthy: bool = True
    # partitionable compute units (TPU TensorCores); a GPU counts as one
    tensorcores: int = 1


class DeviceProvider(Protocol):
    """What the plugin and the monitor need from the device layer."""

    def enumerate(self) -> List[Chip]:
        """All local chips (healthy or not)."""
        ...

    def topology(self) -> "object":
        """The local topology (``vtpu_torch.device.topology.Topology``)."""
        ...

    def health_check(self) -> List[Chip]:
        """Re-query health; returns the refreshed chip list (a chip that
        failed recovers when its probe succeeds again)."""
        ...
