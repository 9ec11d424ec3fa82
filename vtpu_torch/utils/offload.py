"""The pinned host tier of the tenant runtime (what the runtime needs of
``vtpu/utils/offload.py``).

Over quota with oversubscribe on, ``ShimRuntime.device_put`` parks a
tensor in page-locked host memory (the virtual-device-memory tier); the
tenant streams it back with :func:`to_device`, a ``non_blocking`` copy
that overlaps the compute queued on the same stream.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested tuple / list / dict."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def to_host_tier(x) -> torch.Tensor:
    """A host copy of ``x`` (tensor or array-like): page-locked when a
    card is present, so the copy back is a DMA; plain CPU memory on a
    machine without one."""
    t = torch.as_tensor(x).detach().to("cpu", copy=True)
    return t.pin_memory() if torch.cuda.is_available() else t


def to_device(tree, device):
    """Every tensor of ``tree`` on ``device`` (asynchronous from pinned
    memory); tensors already there are returned as they are."""
    dev = torch.device(device)
    return tree_map(lambda t: t.to(dev, non_blocking=True), tree)
