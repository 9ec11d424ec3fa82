"""The local topology, as much of ``vtpu/device/topology.py`` as the
unchanged device plugin asks of a provider's ``topology()``.

``vtpu/plugin/register.py`` reads ``dims``; ``vtpu/plugin/server.py``
hands the object to ``vtpu.device.allocator.IciAllocator`` in
``GetPreferredAllocation``, which hashes it (its rectangle search is
memoized on the topology) and walks it only for chips that carry
coordinates.  A GPU node's chips carry none (every pair of cards on an
NVSwitch is equal), so the allocator takes its first-N path, as it does
for the reference's PJRT family.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Topology:
    """A mesh of the given chip-grid dims, with optional wraparound per
    dim."""

    dims: Tuple[int, int, int]
    wrap: Tuple[bool, bool, bool] = (False, False, False)
