"""Ulysses-style all-to-all sequence parallelism:
``vtpu/parallel/ulysses.py`` for PyTorch.

Each rank trades its sequence shard for a head shard with one
all-to-all over ``sp``, runs full-sequence attention for its heads
(``flash_attention``: the flash kernels on the card, their plain
versions on the CPU), then trades back.  Two all-to-alls an attention.

Layout: in each rank q, k, v ``[batch, heads, seq/n, d]``; heads must
divide by the axis size.
"""

from __future__ import annotations

from typing import Optional

import torch

from vtpu_torch.ops.attention import flash_attention
from vtpu_torch.parallel import comm
from vtpu_torch.parallel.mesh import axis_group, axis_size


def _seq_to_heads(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """``[b, H, s/n, d]`` -> ``[b, H/n, s, d]``: head chunk j goes to
    rank j, and the sequence shards come back in rank order."""
    b, h, sl, d = x.shape
    send = x.reshape(b, n, h // n, sl, d).transpose(0, 1)
    recv = comm.all_to_all(send, group)        # [n (source), b, H/n, s/n, d]
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * sl, d)


def _heads_to_seq(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """Inverse of :func:`_seq_to_heads`."""
    b, hl, s, d = x.shape
    send = x.reshape(b, hl, n, s // n, d).permute(2, 0, 1, 3, 4)
    recv = comm.all_to_all(send, group)        # [n (head chunk), b, ...]
    return recv.transpose(0, 1).reshape(b, n * hl, s // n, d)


def ulysses_attention(q, k, v, mesh, axis: str = "sp",
                      causal: bool = False, *,
                      batch_axis: Optional[str] = None) -> torch.Tensor:
    """In each rank: this rank's sequence shards of q, k, v; returns its
    shard of the output.

    ``batch_axis`` names the mesh axis the caller sharded the batch over
    (dp x sp): each dp replica runs its own exchange on its batch shard,
    and no collective runs on that axis."""
    n = axis_size(mesh, axis)
    if batch_axis is not None and batch_axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no "
                         f"{batch_axis!r}")
    if q.shape[1] % n:
        raise ValueError(
            f"heads ({q.shape[1]}) must divide by mesh axis {axis!r} ({n})")
    group = axis_group(mesh, axis)
    qh, kh, vh = (_seq_to_heads(t, n, group) for t in (q, k, v))
    return _heads_to_seq(flash_attention(qh, kh, vh, causal=causal), n,
                         group)
