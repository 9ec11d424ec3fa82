"""Expert parallelism: ``vtpu/parallel/moe.py`` for PyTorch.

A mixture-of-experts FFN: a router scores tokens, the top-k experts of
each token get a slot in a static-capacity send buffer, the expert FFNs
run as batched matmuls over ``[experts, capacity, d]``, and each token
sums its slots' outputs weighted by their gates.  Overflow slots fall
through with a zero update.  :func:`moe_ffn_local` runs it on one
device; :func:`moe_ffn` shards the experts over a mesh axis and moves
the slots with two all-to-alls.

Shapes stay static and nothing reads a value back to the host, so the
local form runs inside a captured CUDA graph (the decode windows of
``PagedBatcher``): dropped slots are written to slot (0, 0) with a zero
value by an accumulating ``index_put``, as the reference's ``.at[].add``
does, never by a mask-indexed (data-shaped) gather.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vtpu_torch.parallel import comm
from vtpu_torch.parallel.mesh import axis_group, axis_size


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot`` without its bounds check, which reads the ids back
    to the host (a sync a captured graph cannot hold)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def _route(x, router_w, top_k: int, renormalize: bool):
    """Top-k routing: (slot expert ids ``[t*k]``, gates ``[t, k]``).  Ties
    go to the lower expert index, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` promises no order, so this is a stable sort)."""
    logits = x @ router_w
    probs = torch.softmax(logits, dim=-1)
    expert = torch.sort(logits, dim=-1, descending=True,
                        stable=True).indices[:, :top_k]
    gate = torch.gather(probs, 1, expert)
    if renormalize:
        gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return expert.reshape(-1), gate


def _dispatch(x, ef, n_exp: int, capacity: int, top_k: int):
    """Scatter token slots into the per-expert send buffer.  Returns
    (send ``[n_exp, capacity, d]``, idx_e, idx_p, keep)."""
    onehot = _one_hot(ef, n_exp)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = pos < capacity
    idx_e = torch.where(keep, ef, 0)
    idx_p = torch.where(keep, pos, 0)
    xk = x.repeat_interleave(top_k, dim=0)
    vals = torch.where(keep[:, None], xk, torch.zeros_like(xk))
    send = x.new_zeros((n_exp, capacity, x.shape[-1]))
    # accumulate: every dropped slot adds its zero at (0, 0), which a
    # plain scatter would let overwrite expert 0's first real slot
    send = send.index_put((idx_e, idx_p), vals, accumulate=True)
    return send, idx_e, idx_p, keep


def _combine(back, idx_e, idx_p, keep, gate, t: int, top_k: int, d: int):
    """Gather each slot's expert output, gate it, sum a token's k slots."""
    slots = back[idx_e, idx_p]
    slots = torch.where(keep[:, None], slots, torch.zeros_like(slots))
    slots = slots * gate.reshape(-1)[:, None]
    return slots.reshape(t, top_k, d).sum(dim=1)


def load_balance_loss(router_logits, expert_ids, n_exp: int):
    """Switch-style auxiliary loss: n_exp x sum_e f_e * P_e, where f_e
    is the share of slot assignments to expert e and P_e the mean router
    probability; minimal for uniform routing."""
    probs = torch.softmax(router_logits, dim=-1)
    p_mean = probs.mean(dim=0)
    assign = _one_hot(expert_ids, n_exp).to(p_mean.dtype).mean(dim=0)
    if assign.dim() > 1:
        assign = assign.mean(dim=0)
    return n_exp * (assign * p_mean).sum()


def _check_moe_args(router_w, n_exp: int, top_k: int) -> None:
    if router_w.shape[-1] != n_exp:
        raise ValueError(
            f"router_w maps to {router_w.shape[-1]} experts, "
            f"weights have {n_exp}")
    if not 1 <= top_k <= n_exp:
        raise ValueError(f"top_k={top_k} out of range for {n_exp} experts")


def _ffn(send, w_in, w_out, act):
    """The expert FFNs over the send buffer: ``einsum("etd,edh->eth")``,
    the activation, ``einsum("eth,ehd->etd")``, as batched matmuls."""
    return torch.matmul(act(torch.matmul(send, w_in)), w_out)


def moe_ffn_local(x, router_w, w_in, w_out, capacity: int = 0,
                  top_k: int = 1, renormalize: bool = False, act=F.relu,
                  return_aux: bool = False):
    """Single-device MoE FFN.  x ``[t, d]``, router_w ``[d, E]``, w_in
    ``[E, d, h]``, w_out ``[E, h, d]``.  ``capacity`` <= 0 is LOSSLESS
    (t * top_k slots an expert: a token's output does not depend on the
    rest of the batch).  With ``return_aux`` also returns (router
    logits, slot expert ids), the routing used, for the aux loss."""
    t, d = x.shape
    n_exp = w_in.shape[0]
    _check_moe_args(router_w, n_exp, top_k)
    if capacity <= 0:
        capacity = t * top_k
    ef, gate = _route(x, router_w, top_k, renormalize)
    send, idx_e, idx_p, keep = _dispatch(x, ef, n_exp, capacity, top_k)
    back = _ffn(send, w_in, w_out, act)
    out = _combine(back, idx_e, idx_p, keep, gate, t, top_k, d)
    if return_aux:
        return out, (x @ router_w, ef)
    return out


def moe_ffn(x, router_w, w_in, w_out, mesh, axis: str = "ep",
            capacity: int = 0, top_k: int = 1, renormalize: bool = False,
            act=F.relu):
    """The expert-parallel MoE FFN over mesh axis ``axis``, in each rank:
    x ``[t, d]`` is this rank's token shard, router_w ``[d, E]`` is
    replicated, and w_in ``[E/n, d, h]`` / w_out ``[E/n, h, d]`` are this
    rank's contiguous block of experts (rank s owns ``[s*E/n,
    (s+1)*E/n)``).  Returns this rank's outputs ``[t, d]``.

    ``capacity`` <= 0 is ``max(1, ceil(2 * top_k * t / E))`` slots an
    expert a source shard: t, the rank's tokens, is the reference's
    global count over the shards."""
    n_shards = axis_size(mesh, axis)
    n_exp = router_w.shape[-1]
    if n_exp % n_shards != 0:
        raise ValueError(
            f"n_experts={n_exp} not divisible by mesh axis "
            f"'{axis}' size {n_shards}")
    e_local = n_exp // n_shards
    if w_in.shape[0] != e_local or w_out.shape[0] != e_local:
        raise ValueError(
            f"this rank's expert block is {w_in.shape[0]} / "
            f"{w_out.shape[0]} experts, want {e_local}")
    _check_moe_args(router_w, n_exp, top_k)
    t, d = x.shape
    if capacity <= 0:
        capacity = max(1, -(-2 * top_k * max(1, t) // n_exp))
    group = axis_group(mesh, axis)
    ef, gate = _route(x, router_w, top_k, renormalize)
    send, idx_e, idx_p, keep = _dispatch(x, ef, n_exp, capacity, top_k)
    # dim 0 = destination shard (its e_local experts); after the
    # exchange dim 0 = source shard
    recv = comm.all_to_all(send.reshape(n_shards, e_local * capacity, d),
                           group)
    recv = recv.reshape(n_shards, e_local, capacity, d).transpose(0, 1)
    y = _ffn(recv.reshape(e_local, n_shards * capacity, d), w_in, w_out, act)
    y = y.reshape(e_local, n_shards, capacity, d).transpose(0, 1)
    back = comm.all_to_all(y.reshape(n_shards, e_local * capacity, d), group)
    return _combine(back.reshape(n_exp, capacity, d), idx_e, idx_p, keep,
                    gate, t, top_k, d)
