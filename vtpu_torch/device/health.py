"""Device-error health feed: region error streaks -> unhealthy chips.

The port's copy of ``vtpu/device/health.py``.  The enforcement path
records each launch outcome in its shared region (``error_streak``); the
device plugin's health probe reads every tenant region under the
containers root here.  A tenant with ``VTPU_HEALTH_ERROR_STREAK``
consecutive device-side failures flips its chips unhealthy; one success
resets the streak and the chip recovers.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Set

from vtpu_torch.monitor.shared_region import open_region
from vtpu_torch.utils.envs import env_int, env_str

log = logging.getLogger(__name__)

ENV_CONTAINERS_ROOT = "VTPU_CONTAINERS_ROOT"
ENV_ERROR_STREAK = "VTPU_HEALTH_ERROR_STREAK"
DEFAULT_CONTAINERS_ROOT = "/usr/local/vtpu/containers"
DEFAULT_ERROR_STREAK = 3
REGION_FILENAME = "vtpu.cache"


def region_unhealthy_uuids(
    root: Optional[str] = None, threshold: Optional[int] = None
) -> Set[str]:
    """Chip uuids whose tenant regions show a device-error streak at or
    past the threshold.  A missing root or an unreadable region is
    normal (no tenants yet) and yields nothing."""
    root = root or env_str(ENV_CONTAINERS_ROOT, DEFAULT_CONTAINERS_ROOT)
    if threshold is None:
        threshold = env_int(ENV_ERROR_STREAK, DEFAULT_ERROR_STREAK)
    out: Set[str] = set()
    if not root or not os.path.isdir(root):
        return out
    for entry in sorted(os.listdir(root)):
        rf = open_region(os.path.join(root, entry, REGION_FILENAME))
        if rf is None:
            continue
        try:
            if rf.region.error_streak >= threshold:
                uuids = rf.device_uuids()
                log.warning(
                    "region %s: error streak %d (>=%d): marking %s unhealthy",
                    entry, rf.region.error_streak, threshold, uuids)
                out.update(uuids)
        finally:
            rf.close()
    return out
