"""Pipeline parallelism over a mesh axis: ``vtpu/parallel/pipeline.py``
for PyTorch.

The GPipe schedule of the reference: each rank of ``pp`` holds one
stage's weights, and microbatches stream through in ``n_micro +
n_stages - 1`` steps.  Every step stage 0 injects the next microbatch,
each stage computes, the last stage emits the microbatch that entered
``n_stages - 1`` steps before, and the activations move one hop to the
next stage (a permute).  At the end the last stage's outputs go to every
rank.  Differentiable end to end: the hops' backward runs the ring the
other way.
"""

from __future__ import annotations

import torch

from vtpu_torch.parallel import comm
from vtpu_torch.parallel.mesh import axis_group, axis_index, axis_size
from vtpu_torch.utils.offload import tree_map


def pipeline_apply(stage_fn, params, xs: torch.Tensor, mesh,
                   axis: str = "pp") -> torch.Tensor:
    """Run ``xs`` ``[n_micro, micro, d]`` (the same on every rank)
    through the pipeline; returns the last stage's outputs ``[n_micro,
    micro, d]`` in microbatch order, on every rank.

    ``stage_fn(stage_params, x) -> y`` is one stage.  ``params`` is this
    rank's shard of a tree whose leaves have a leading stage dim: each
    leaf keeps that dim, of size 1, as ``shard_map`` hands it, and
    ``stage_fn`` sees it squeezed.  A leaf sharded over further mesh
    axes (expert weights ``P("pp", "ep")`` on a pp x ep mesh) is this
    rank's block of those too; ``vtpu_torch.parallel.sharding.
    local_shard`` cuts it from the global tree."""
    n_stages = axis_size(mesh, axis)
    n_micro = xs.shape[0]
    if n_micro < n_stages:
        raise ValueError(
            f"need at least {n_stages} microbatches to fill the pipeline, "
            f"got {n_micro}")
    sidx = axis_index(mesh, axis)
    group = axis_group(mesh, axis)
    stage_params = tree_map(lambda p: p.squeeze(0), params)
    # every rank builds the same graph (the reference's where-selects,
    # not Python branches on the stage), so each hop's backward runs on
    # every rank of the ring and the exchanges pair up
    first = torch.tensor(sidx == 0, device=xs.device)
    last = torch.tensor(sidx == n_stages - 1, device=xs.device)
    acts = torch.zeros_like(xs[0])
    outs = []
    for t in range(n_micro + n_stages - 1):
        acts = torch.where(first, xs[t if t < n_micro else 0], acts)
        y = stage_fn(stage_params, acts)
        if t >= n_stages - 1:
            outs.append(y)
        acts = comm.permute(y, group)
    outs = torch.stack(outs)
    outs = torch.where(last, outs, torch.zeros_like(outs))
    return comm.broadcast_replicated(outs, group, n_stages - 1)
