"""A true completion barrier for the port's benchmarks.

A CUDA launch returns before the card has done the work, so a host clock
around launches alone measures the enqueue.  Copying one element of the
output to the host cannot finish before the work that made it has.
``Tensor.item`` waits on the current stream only, so a tenant that runs
on its own stream waits for its own work, not for its neighbours'.
"""

from __future__ import annotations

import torch


def leaves(tree):
    """The tensors of a nested tuple / list / dict, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in leaves(sub)]
    return []


def hard_sync(out):
    """Block until ``out``'s work has completed; returns a host scalar
    taken from its first tensor (None when it holds no tensor)."""
    ts = leaves(out)
    if not ts:
        return None
    return ts[0].reshape(-1)[0].item()
