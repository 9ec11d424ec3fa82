"""Ring attention, sequence parallelism over a ring of ranks:
``vtpu/parallel/ring.py`` for PyTorch.

Each rank holds one Q/K/V shard of the sequence, attends to the KV shard
it holds, then passes that KV shard one hop around the ring (a P2P
permute over the ``sp`` group).  After n hops every Q shard has seen the
whole sequence, and the partials merge by online softmax; no rank holds
the full sequence.  The partial of a shard comes from
``vtpu_torch.ops.attention.flash_attention_with_lse``: on a CUDA tensor
the flash forward kernel (f32 o from bf16 or f32 inputs), on a CPU
tensor its plain version.  Differentiable: the hops' backward permutes
the gradients the other way.

Every rank computes every hop, as the reference does: under the
contiguous causal layout a hop whose KV shard lies wholly after this
rank's queries is gated out of the merge (m = -inf, l = 0).  A rank
that skipped it would leave that hop's permute without a gradient, and
its peers' backward exchanges would wait for it.
"""

from __future__ import annotations

from typing import Optional

import torch

from vtpu_torch.ops.attention import (NEG_INF, apply_causal_mask,
                                      flash_attention_with_lse)
from vtpu_torch.parallel import comm
from vtpu_torch.parallel.mesh import axis_group, axis_index, axis_size


def _partial_attention(q, k, v, sm_scale, use_kernel: Optional[bool] = None,
                       causal_local: bool = False, shift: int = 0):
    """Blockwise partials for one KV shard: (acc, m, l) in f32.

    By default from the flash forward: its normalized o and its lse form
    the online-softmax triple (o, lse, 1), which the merge weighs by
    exp(lse - m_max).  ``use_kernel=False`` takes the plain einsum
    formulation (unnormalized acc, row max, row sum), as the reference
    does off the TPU."""
    default_scale = q.shape[-1] ** -0.5
    if use_kernel is not False and abs(sm_scale - default_scale) < 1e-12:
        o, lse = flash_attention_with_lse(q, k, v, causal_local, shift)
        return o, lse, torch.ones_like(lse)
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * sm_scale
    if causal_local:
        s = apply_causal_mask(s, shift)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("...qk,...kd->...qd", p, v.float())
    return acc, m, l


def _merge(acc1, m1, l1, acc2, m2, l2):
    """Online-softmax merge of two partial attention results."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return acc1 * a1 + acc2 * a2, m, l1 * a1 + l2 * a2


def stripe_sequence(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Contiguous -> STRIPED layout on dim -2: shard r of the striped
    sequence holds global tokens r, r+n, r+2n, ..."""
    *lead, s, d = x.shape
    ell = s // n_shards
    return x.reshape(*lead, ell, n_shards, d).transpose(-3, -2).reshape(
        *lead, s, d)


def unstripe_sequence(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Inverse of :func:`stripe_sequence`."""
    *lead, s, d = x.shape
    ell = s // n_shards
    return x.reshape(*lead, n_shards, ell, d).transpose(-3, -2).reshape(
        *lead, s, d)


def ring_attention(q, k, v, mesh, axis: str = "sp", *, causal: bool = False,
                   layout: str = "contiguous",
                   head_axis: Optional[str] = None,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """In each rank: q, k, v ``[batch, heads, seq/n, d]``, this rank's
    shard of a sequence sharded over mesh axis ``axis``; returns this
    rank's shard of the output, in q's dtype.

    ``head_axis`` names the mesh axis the caller sharded the heads over
    (sp x tp): heads are independent, so no collective runs on it and
    each (sp, tp) rank rings its own heads over ``axis``.

    ``layout``: ``"contiguous"`` (rank r holds tokens [rL, (r+1)L): the
    diagonal hop is masked locally, earlier shards attend fully, later
    ones not at all) or ``"striped"`` (inputs laid out by
    :func:`stripe_sequence`: hop (r, s) takes the causal mask when
    s <= r and the strict one, ``shift=-1``, when s > r, so every hop
    does the same work; the output comes back striped)."""
    if layout not in ("contiguous", "striped"):
        raise ValueError(f"unknown layout {layout!r}")
    if head_axis is not None and head_axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no "
                         f"{head_axis!r}")
    n = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    return _ring_rank(q, k, v, n, axis_index(mesh, axis),
                      lambda h, kc, vc: (comm.permute(kc, group),
                                         comm.permute(vc, group)),
                      causal=causal, striped=layout == "striped",
                      use_kernel=use_kernel)


def _ring_rank(q, k, v, n: int, r: int, hop, *, causal: bool,
               striped: bool, use_kernel=None) -> torch.Tensor:
    """Rank r's ring schedule; ``hop(h, k, v)`` gives the KV shard held
    at hop h, moved one hop from the one held at h - 1 (rank i's to rank
    i + 1)."""
    striped = striped and causal  # non-causal striping is a no-op
    sm_scale = q.shape[-1] ** -0.5
    # hop 0 is the diagonal block (r, r): the causal mask, both layouts
    acc, m, l = _partial_attention(q, k, v, sm_scale, use_kernel,
                                   causal_local=causal)
    k_c, v_c = k, v
    for h in range(1, n):
        k_c, v_c = hop(h, k_c, v_c)
        s_idx = (r - h) % n  # the shard this KV came from
        if striped:
            part = _partial_attention(q, k_c, v_c, sm_scale, use_kernel,
                                      causal_local=True,
                                      shift=-1 if s_idx > r else 0)
        else:
            part = _partial_attention(q, k_c, v_c, sm_scale, use_kernel)
            if causal and s_idx > r:  # wholly in the future: weight 0
                a, mm, ll = part
                part = (a * 0, mm * 0 + NEG_INF, ll * 0)
        acc, m, l = _merge(acc, m, l, *part)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def ring_attention_shards(q, k, v, n_shards: int, *, causal: bool = False,
                          layout: str = "contiguous",
                          use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Every rank's ring schedule in turn on one device: q, k, v ``[b, h,
    s, d]`` whole (striped already for ``layout="striped"``), cut into
    ``n_shards`` sequence shards; returns the whole output.  The same
    partials and merges as :func:`ring_attention` over ``n_shards``
    ranks, with the hops as plain indexing: how the merge is measured on
    one card."""
    if layout not in ("contiguous", "striped"):
        raise ValueError(f"unknown layout {layout!r}")
    ks, vs = k.chunk(n_shards, dim=-2), v.chunk(n_shards, dim=-2)
    outs = []
    for r, q_r in enumerate(q.chunk(n_shards, dim=-2)):
        def hop(h, _k, _v, r=r):
            return ks[(r - h) % n_shards], vs[(r - h) % n_shards]

        outs.append(_ring_rank(q_r, ks[r], vs[r], n_shards, r, hop,
                               causal=causal, striped=layout == "striped",
                               use_kernel=use_kernel))
    return torch.cat(outs, dim=-2)
