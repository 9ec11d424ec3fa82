"""The pinned host tier: ``vtpu/utils/offload.py`` for PyTorch.

Over quota with oversubscribe on, ``ShimRuntime.device_put`` parks a
tensor in page-locked host memory (the virtual-device-memory tier); the
tenant streams it back with :func:`to_device`, a ``non_blocking`` copy
that overlaps the compute queued on the same stream.  The cooperative
form parks cold training state there on purpose: :func:`offload_to_host`
for a tree, :func:`optimizer_state_to` for an optimizer's moments
between steps.  Without a card there is no second tier, and the
offloads return their input as it is.
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


def host_sharding(dev_index: int = 0):
    """The pinned host tier of card ``dev_index`` as a placement
    (``torch.device("cpu")``, to which :func:`offload_to_host` copies
    page-locked), or None on a machine without a card, where there is no
    second tier (the reference's answer on the CPU platform)."""
    if not torch.cuda.is_available() or \
            dev_index >= torch.cuda.device_count():
        return None
    return torch.device("cpu")


def offload_to_host(tree, dev_index: int = 0):
    """Every tensor of ``tree`` in the pinned host tier; the tree as it
    is where there is no such tier."""
    if host_sharding(dev_index) is None:
        return tree
    return tree_map(to_host_tier, tree)


def host_out_shardings(tree, dev_index: int = 0):
    """The host-tier placement for every leaf of ``tree`` (what keeps a
    step's updated optimizer state host-resident), or None where there
    is no host tier."""
    sh = host_sharding(dev_index)
    if sh is None:
        return None
    return tree_map(lambda _: sh, tree)


def optimizer_state_to(optimizer: torch.optim.Optimizer, where) -> None:
    """Move every tensor of ``optimizer``'s state (momenta, moments) to
    ``where`` in place: :func:`host_sharding` parks it in the pinned
    tier between steps, the parameters' device streams it back before
    ``step()``."""
    dev = torch.device(where)
    for state in optimizer.state.values():
        for k, v in state.items():
            if isinstance(v, torch.Tensor):
                state[k] = (to_host_tier(v) if dev.type == "cpu"
                            else v.to(dev, non_blocking=True))
