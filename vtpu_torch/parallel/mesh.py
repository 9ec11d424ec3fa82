"""Mesh construction from gang rectangles: ``vtpu/parallel/mesh.py`` for
PyTorch, over ``torch.distributed.device_mesh.DeviceMesh``.

A mesh lays a world's ranks (one device a rank) along named axes.  The
axis names and shapes are the JAX package's: the squarest ``dp`` x ``tp``
by default, an outer ``dcn`` axis across hosts for the hybrid form, and
a gang rectangle's non-trivial dims (largest first) for
:func:`mesh_from_rectangle`, whose host-split form puts ``dp`` across
the hosts.  ``devices`` is a list of ranks (default: every rank of the
world, in order).  Building a mesh is collective: every rank of the
world builds the same meshes in the same order.

The helpers at the end read a mesh the way ``shard_map`` code reads its
axes: :func:`axis_size` (``mesh.shape[axis]``), :func:`axis_index`
(``jax.lax.axis_index``) and :func:`axis_group` (the process group the
axis's collectives run over).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vtpu_torch.parallel.distributed import local_device_count


def _ranks(devices) -> List[int]:
    if devices is not None:
        return [int(d) for d in devices]
    n = dist.get_world_size() if dist.is_initialized() else 1
    return list(range(n))


def _device_type() -> str:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def _mesh(ranks: Sequence[int], shape, names) -> DeviceMesh:
    arr = torch.tensor(list(ranks), dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(_device_type(), arr, mesh_dim_names=tuple(names))


def make_mesh(axis_names: Sequence[str] = ("dp", "tp"),
              shape: Optional[Tuple[int, ...]] = None,
              devices=None) -> DeviceMesh:
    """General mesh over the world's ranks.  Default: dp x tp, the
    squarest two-way factorization, tp innermost."""
    ranks = _ranks(devices)
    n = len(ranks)
    if shape is None:
        tp = 1
        for f in range(int(n ** 0.5), 0, -1):
            if n % f == 0:
                tp = f
                break
        shape = (n // tp, tp)
    return _mesh(ranks, shape, axis_names)


def host_of(rank: int) -> int:
    """The host a rank lives on: ranks are laid out host by host,
    ``VTPU_LOCAL_WORLD_SIZE`` a host."""
    return rank // max(1, local_device_count())


def make_hybrid_mesh(ici_shape: Tuple[int, ...],
                     ici_axis_names: Sequence[str] = ("dp", "tp"),
                     dcn_axis_name: str = "dcn",
                     num_slices: Optional[int] = None,
                     devices=None) -> DeviceMesh:
    """Two-tier mesh: ``dcn`` is the outermost axis (the host, the slow
    link), the inner axes lie within one host.  Ranks are grouped by
    host, and every inner group must sit on one host, or its collectives
    would cross the slow link."""
    ranks = sorted(_ranks(devices), key=lambda r: (host_of(r), r))
    per_slice = int(np.prod(ici_shape))
    if num_slices is None:
        num_slices = len(ranks) // per_slice
    want = per_slice * num_slices
    if len(ranks) < want or want == 0:
        raise ValueError(
            f"hybrid mesh {ici_shape}×{num_slices} slices needs {want} "
            f"devices, have {len(ranks)}")
    picked = ranks[:want]
    if len({host_of(r) for r in picked}) > 1:
        for s in range(num_slices):
            hosts = {host_of(r)
                     for r in picked[s * per_slice:(s + 1) * per_slice]}
            if len(hosts) > 1:
                raise ValueError(
                    f"ici group {s} spans hosts {sorted(hosts)}; ici_shape "
                    f"{ici_shape} exceeds one host's ranks")
    return _mesh(picked, (num_slices,) + tuple(ici_shape),
                 (dcn_axis_name,) + tuple(ici_axis_names))


def mesh_axes_for(shape: Tuple[int, int, int]) -> List[int]:
    """Non-trivial dims of a rectangle, largest first (the port's copy of
    ``vtpu/device/topology.py::mesh_axes_for``)."""
    return sorted([d for d in shape if d > 1], reverse=True)


def mesh_from_rectangle(shape, axis_names: Optional[Sequence[str]] = None,
                        devices=None) -> DeviceMesh:
    """Mesh whose axes mirror a gang rectangle's non-trivial dims,
    largest first.

    ``shape`` may also be a HOST-SPLIT rectangle, one per-host
    sub-rectangle a member (``[(2, 2, 1)] * 4``).  The mesh is then
    hybrid: the outer axis runs across hosts and the inner axes lie in
    one host's sub-rectangle.  Default axis names are ``("dp", "tp")``
    when the sub-rectangle is effectively 1-D, else ``("dp", "ici0",
    ...)``.  All sub-rectangles must be congruent."""
    if shape and isinstance(shape[0], (tuple, list)):
        subs = [tuple(s) for s in shape]
        if any(s != subs[0] for s in subs):
            raise ValueError(
                f"host-split rectangle must be homogeneous, got {subs}")
        inner = mesh_axes_for(subs[0]) or [1]
        dims = [len(subs)] + inner
        if axis_names is None:
            axis_names = (
                ("dp", "tp") if len(inner) == 1
                else ("dp", *[f"ici{i}" for i in range(len(inner))]))
        if len(axis_names) != len(dims):
            raise ValueError(
                f"host-split mesh {dims} needs {len(dims)} axis names, "
                f"got {list(axis_names)}")
    else:
        dims = mesh_axes_for(shape) or [1]
        if axis_names is None:
            axis_names = [f"ici{i}" for i in range(len(dims))]
    ranks = _ranks(devices)
    want = int(np.prod(dims))
    if len(ranks) < want:
        raise ValueError(
            f"rectangle {shape} needs {want} devices, have {len(ranks)}")
    return _mesh(ranks[:want], dims, axis_names)


# -- reading a mesh ------------------------------------------------------
def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{axis name: size}``, as a JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no {axis!r}")
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)
