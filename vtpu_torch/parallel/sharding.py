"""Sharded train steps (dp x tp over a gang mesh):
``vtpu/parallel/sharding.py`` for PyTorch.

The batch rides ``dp``: each rank of a dp group holds its block of the
batch, the gradients are summed over the group, and BatchNorm takes its
statistics over the whole batch (its per-channel sums all-reduced), so
every number is the one ``jax.jit`` computes for the global batch.  Wide
parameters shard their output features over ``tp``: each rank stores its
block, and a forward gathers the full tensor from the tp group (the
weight all-gather XLA inserts for such a layout), whose backward keeps
this rank's block of the gradient.  The compute inside a tp group is
replicated.

A spec is a tuple with one entry a dim, ``None`` or a mesh axis name
(``()`` is replicated), as a ``PartitionSpec``.  The reference's rule
shards the trailing dim of a flax kernel; in the port's ``nn.Linear``
and convolution weights the output features are dim 0 (the flax kernel
transposed), and leaves kept in the flax layout (embeddings, the MoE
experts) keep them last.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from vtpu_torch.models import layers
from vtpu_torch.parallel import comm
from vtpu_torch.parallel.mesh import (axis_group, axis_index, axis_size,
                                      mesh_shape)

Spec = Tuple[Optional[str], ...]

# modules whose ``weight`` is the flax kernel transposed (out features
# first)
_OUT_FIRST = (nn.Linear, nn.Conv2d, layers.Conv, layers.Dense)


def _out_dim(module: nn.Module, leaf: str, x: torch.Tensor) -> int:
    return 0 if leaf == "weight" and isinstance(module, _OUT_FIRST) \
        else x.dim() - 1


def param_spec(path: str, x: torch.Tensor, mesh, tp_axis: str = "tp",
               out_dim: Optional[int] = None) -> Spec:
    """The feature-dim rule: shard the output-feature dim (``out_dim``,
    default the last) of a tensor of two or more dims over ``tp`` when
    it divides evenly and is at least 128 wide; replicate the rest."""
    tp = mesh_shape(mesh).get(tp_axis, 1)
    dim = x.dim() - 1 if out_dim is None else out_dim
    if tp > 1 and x.dim() >= 2 and x.shape[dim] % tp == 0 \
            and x.shape[dim] >= 128:
        spec = [None] * x.dim()
        spec[dim] = tp_axis
        return tuple(spec)
    return ()


def _block(size: int, mesh, axes) -> Tuple[int, int]:
    """(start, length) of this rank's block of a dim sharded over
    ``axes`` (one axis name or a tuple, outer first)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    idx, n = 0, 1
    for a in axes:
        idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
        n *= axis_size(mesh, a)
    if size % n:
        raise ValueError(f"dim of {size} does not divide over {axes} ({n})")
    return idx * (size // n), size // n


def local_shard(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec``, a view (the
    SPMD counterpart of placing ``x`` with a ``NamedSharding``)."""
    for dim, axes in enumerate(spec):
        if axes is not None:
            start, n = _block(x.shape[dim], mesh, axes)
            x = x.narrow(dim, start, n)
    return x


def place_global(x, mesh, spec: Spec) -> torch.Tensor:
    """This rank's block of host data ``x`` (the same values on every
    rank)."""
    return local_shard(torch.as_tensor(np.asarray(x)), mesh, spec)


class ShardedParams:
    """This rank's blocks of a model's parameters, as leaf tensors that
    take gradients, with their specs.  :meth:`full` gathers the full
    tensors for a forward."""

    def __init__(self, model: nn.Module, mesh, specs: Dict[str, Spec]):
        self.mesh, self.specs = mesh, specs
        self.local = {
            name: local_shard(p.detach(), mesh, specs[name]).clone()
            .requires_grad_(True)
            for name, p in model.named_parameters()}

    def full(self) -> Dict[str, torch.Tensor]:
        out = {}
        for name, t in self.local.items():
            for dim, axis in enumerate(self.specs[name]):
                if axis is not None:
                    t = comm.gather_replicated(t, axis_group(self.mesh, axis),
                                               dim)
            out[name] = t
        return out

    def leaves(self):
        return list(self.local.values())

    def sum_grads(self, group) -> None:
        """Sum every gradient over ``group`` (the dp ranks)."""
        for t in self.local.values():
            if t.grad is not None and comm.group_size(group) > 1:
                torch.distributed.all_reduce(t.grad, group=group)


def shard_params(model: nn.Module, mesh, tp_axis: str = "tp",
                 spec_of: Optional[Callable[[str, torch.Tensor], Spec]] = None
                 ) -> ShardedParams:
    """This rank's shards of ``model``'s parameters: ``spec_of(name,
    tensor)`` for each (default :func:`param_spec` on the tensor's
    output-feature dim)."""
    modules = dict(model.named_modules())
    specs = {}
    for name, p in model.named_parameters():
        if spec_of is not None:
            specs[name] = tuple(spec_of(name, p))
            continue
        owner, _, leaf = name.rpartition(".")
        specs[name] = param_spec(name, p, mesh, tp_axis,
                                 _out_dim(modules[owner], leaf, p))
    return ShardedParams(model, mesh, specs)


# every rank draws the same weights from the seed, so the multi-host
# form is the same function
shard_params_global = shard_params


def _bn_sync(model: nn.Module, group) -> None:
    for m in model.modules():
        if isinstance(m, layers.BatchNorm):
            m.sync_group = group if comm.group_size(group) > 1 else None


class TrainStep:
    """One sharded SGD step of a classifier with BatchNorm state (the
    port's ai-benchmark models): ``step(images, labels)`` with this
    rank's block of the batch returns the global mean cross-entropy
    before the update, and writes the global running statistics into
    the model's buffers."""

    def __init__(self, model: nn.Module, mesh, optimizer=None,
                 dp_axis: str = "dp", tp_axis: str = "tp"):
        self.model, self.mesh = model, mesh
        self.params = shard_params(model, mesh, tp_axis)
        self.optimizer = optimizer or torch.optim.SGD(
            self.params.leaves(), lr=1e-3, momentum=0.9)
        self.dp_group = axis_group(mesh, dp_axis)
        self.n_dp = axis_size(mesh, dp_axis)
        _bn_sync(model, self.dp_group)

    def __call__(self, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        logits, new_stats = functional_call(self.model, self.params.full(),
                                            (images,))
        # this rank's share of the global mean over the dp groups' batch
        loss = F.cross_entropy(logits, labels.long()) / self.n_dp
        loss.backward()
        self.params.sum_grads(self.dp_group)
        self.optimizer.step()
        layers.load_batch_stats(self.model, new_stats)
        return comm.all_reduce_sum(loss.detach(), self.dp_group)


def make_train_step(model: nn.Module, mesh, optimizer=None,
                    dp_axis: str = "dp", tp_axis: str = "tp"):
    """A :class:`TrainStep` for ``model`` over ``mesh`` and its optimizer
    (default ``SGD(lr=1e-3, momentum=0.9)``, the update
    ``optax.sgd(1e-3, momentum=0.9)`` makes)."""
    step = TrainStep(model, mesh, optimizer, dp_axis, tp_axis)
    return step, step.optimizer


def init_sharded(model: nn.Module, mesh, tp_axis: str = "tp"):
    """(this rank's parameter shards, the model's running statistics)."""
    return shard_params(model, mesh, tp_axis), dict(model.named_buffers())


def lm_value_and_grad(model: nn.Module, params: ShardedParams,
                      tokens: torch.Tensor, mesh,
                      dp_axis: str = "dp") -> torch.Tensor:
    """``jax.value_and_grad`` of ``lm_loss(model(tokens), tokens)`` over a
    sharded tree: ``tokens`` is this rank's block of a batch sharded over
    ``dp``, the parameters are gathered per their specs, and the
    gradients land in the shards' ``.grad``.  Returns the global loss."""
    from vtpu_torch.models.transformer import lm_loss

    group = axis_group(mesh, dp_axis)
    n = axis_size(mesh, dp_axis)
    for t in params.leaves():
        t.grad = None
    logits = functional_call(model, params.full(), (tokens,),
                             {"decode": False})
    loss = lm_loss(logits, tokens) / n
    loss.backward()
    params.sum_grads(group)
    return comm.all_reduce_sum(loss.detach(), group)
