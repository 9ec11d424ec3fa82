"""vtpu_torch.obs: the port's observability layer.

The port's copy of ``vtpu/obs/__init__.py`` (the port imports nothing of
vtpu), exporting the same names:

- :mod:`vtpu_torch.obs.registry`: counters, gauges and histograms with
  the one Prometheus text renderer;
- :mod:`vtpu_torch.obs.events`: the typed, bounded event journal;
- :mod:`vtpu_torch.obs.jsonl`: the rotating JSONL sink the journals
  mirror to.

Trace spans live in :mod:`vtpu_torch.utils.trace`.  The JAX package's
``ready``, ``http``, ``flight``, ``slo``, ``incident``, ``outcomes`` and
``dataset`` modules have no copy here yet.
"""

from vtpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS,
    Registry,
    all_registries,
    escape_label,
    lint_names,
    registry,
    render_family,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "Registry",
    "all_registries",
    "escape_label",
    "lint_names",
    "registry",
    "render_family",
]
