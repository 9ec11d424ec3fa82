"""Decoder-only transformer LM: ``vtpu/models/transformer.py`` in
PyTorch, its full forward (training) and its decode path over either
cache layout.

What is here: MHA or GQA, learned ``wpe`` or half-split ``rope``,
sliding-window attention, the dense MLP with tanh-approximate GELU, the
fused LayerNorm kernel; weight-only int8 storage
(:meth:`TransformerLM.quantize_weights`, :meth:`TransformerLM.load_quantized`,
:class:`QuantLinear`); the full forward ``model(tokens, decode=False)``
through the flash-attention kernels, differentiable, with
:func:`lm_loss`; the decode path over a dense cache
(``kv_cache_layout="dense"``, the reference's default) or over a K/V pool
behind a block table (``"paged"``, with the paged decode kernel), each
native or int8; greedy or sampled :func:`generate`,
:func:`generate_beam` and :func:`generate_speculative`; and MoE blocks
(``mlp="moe"``: top-k routed expert FFNs, :class:`MoeMlp`), whose Switch
load-balance losses a forward hands back through ``aux``.

The cache is an explicit dict of tensors that every forward updates in
place, the position counter included (the JAX model returns a new cache;
writing in place saves a copy of the whole cache per step, and keeps
every tensor at the address a captured CUDA graph reads)::

    dense: {"pos": [b] int32,           # the ONE per-row position counter
            "layers": [{"k", "v"[, "k_scale", "v_scale"]}]}
    paged: {"pos": [b] int32,
            "block_table": [b, nb_max] int32,  # logical -> pool block
            "layers": [{"k_pool", "v_pool"[, "k_pool_scale",
                                            "v_pool_scale"]}]}

Dense K/V are ``[b, n_kv, max_seq, hd]`` and pools ``[P, n_kv, bs,
hd]``, in the model's dtype; with ``kv_cache_dtype="int8"`` they are
int8, with f32 scales of the same shape but a last dim of 1.  Dense
weights are ``nn.Linear`` (``weight`` is the flax kernel transposed, see
``vtpu_torch.models.convert``).

Int8 weights (the reference's engines serve a ``quantize_tree`` tree and
call ``dequantize_tree(params)``, bf16, inside each jitted program): the
projections that ``vtpu_torch.ops.quant.quantize_tree`` selects hold
int8 levels and f32 per-output-channel scales, and each forward
dequantizes a weight where it is used, to bf16 in one pass, then casts
it to the activations' dtype (an f32 model computes with bf16-rounded
weights, as flax promotes them).  No f32 copy of a weight is built, and
nothing syncs with the host, so a captured decode window holds it.
"""

from __future__ import annotations

import copy
import itertools

import torch
import torch.nn.functional as F
from torch import nn

from vtpu_torch.device import resolve_device
from vtpu_torch.ops.attention import (flash_attention, flash_attention_gqa,
                                      reference_attention)
from vtpu_torch.ops.layernorm import _reference_ln, fused_layernorm
from vtpu_torch.ops.paged_attention import paged_attention_decode
from vtpu_torch.ops.quant import (QuantizedTensor, dequantize_weight,
                                  is_quantized, quantize_int8, quantize_tree)
from vtpu_torch.parallel.moe import gelu, load_balance_loss, moe_ffn_local

NEG_INF = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on the head dim of x ``[..., s, d]``: the dim is
    split into halves (not interleaved) and rotated by per-position
    angles.  ``positions`` are absolute, ``[s]`` or per-row ``[b, s]``."""
    assert x.shape[-1] % 2 == 0, "RoPE needs an even head dim"
    half = x.shape[-1] // 2
    freqs = base ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs
    if ang.dim() == 3:
        # per-row positions [b, s, half] against x [b, ..., s, d]
        ang = ang.reshape(ang.shape[0], *([1] * (x.dim() - 3)),
                          ang.shape[1], ang.shape[2])
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm (eps 1e-6) through the fused kernel; ``kernel=False``
    runs its plain version on any device."""

    def __init__(self, d: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x, kernel: bool = True):
        if kernel:
            return fused_layernorm(x, self.scale, self.bias, 1e-6)
        return _reference_ln(x, self.scale, self.bias, 1e-6)


class QuantLinear(nn.Module):
    """An ``nn.Linear`` whose weight rests as int8 levels ``q`` ``[out,
    in]`` and f32 scales ``scale`` ``[out, 1]`` (buffers), dequantized at
    each call by ``dequantize_weight`` to bf16 and then to the input's
    dtype.  ``bias`` is the float bias, or None."""

    def __init__(self, qt: QuantizedTensor, bias=None):
        super().__init__()
        if qt.q.dim() != 2 or qt.axis != 1:
            raise ValueError(f"an nn.Linear weight reduces axis 1 of "
                             f"[out, in]; got {tuple(qt.q.shape)}, axis "
                             f"{qt.axis}")
        self.register_buffer("q", qt.q)
        self.register_buffer("scale", qt.scale)
        self.bias = bias

    def forward(self, x):
        return F.linear(x, dequantize_weight(self.q, self.scale, x.dtype),
                        self.bias)


class Attention(nn.Module):
    def __init__(self, d: int, num_heads: int, num_kv_heads: int,
                 use_rope: bool, *, device=None, dtype=None):
        super().__init__()
        assert d % num_heads == 0, "num_heads must divide d_model"
        self.num_heads = num_heads
        self.hd = d // num_heads
        self.n_kv = num_kv_heads or num_heads
        assert num_heads % self.n_kv == 0, "kv heads must divide q heads"
        self.use_rope = use_rope
        kw = dict(bias=False, device=device, dtype=dtype)
        if self.n_kv == num_heads:
            self.qkv = nn.Linear(d, 3 * d, **kw)
        else:
            # GQA: q keeps every head, k/v project to the smaller count
            self.q = nn.Linear(d, d, **kw)
            self.kv = nn.Linear(d, 2 * self.n_kv * self.hd, **kw)
        self.out = nn.Linear(d, d, **kw)

    def _heads(self, x):
        b, s, d = x.shape
        hd, n_kv, nh = self.hd, self.n_kv, self.num_heads
        if n_kv == nh:
            q, k, v = self.qkv(x).split(d, dim=-1)
        else:
            q = self.q(x)
            k, v = self.kv(x).split(n_kv * hd, dim=-1)
        q = q.reshape(b, s, nh, hd).transpose(1, 2)    # [b, H, s, hd]
        k = k.reshape(b, s, n_kv, hd).transpose(1, 2)  # [b, n_kv, s, hd]
        v = v.reshape(b, s, n_kv, hd).transpose(1, 2)
        return q, k, v

    def forward(self, x, layer: dict | None = None, pos0=None, table=None,
                *, window: int = 0, flash: bool = True, block_size: int = 0,
                max_seq: int = 0, use_kernel: bool = False):
        """Full causal forward when ``layer`` is None (the flash kernels,
        or with ``flash=False`` the plain attention), else one decode
        step against the cache ``layer``."""
        if layer is None:
            return self._full(x, window, flash)
        return self._decode(x, layer, pos0, table, window=window,
                            block_size=block_size, max_seq=max_seq,
                            use_kernel=use_kernel)

    def _full(self, x, window: int, flash: bool):
        b, s, d = x.shape
        q, k, v = self._heads(x)
        if self.use_rope:
            pos = torch.arange(s, device=x.device)
            q, k = rope(q, pos), rope(k, pos)
        if self.n_kv != self.num_heads:
            o = flash_attention_gqa(q, k, v, causal=True, window=window,
                                    use_kernel=None if flash else False)
        elif flash:
            o = flash_attention(q, k, v, causal=True, window=window)
        else:
            o = reference_attention(q, k, v, causal=True, window=window)
        return self.out(o.transpose(1, 2).reshape(b, s, d))

    def _decode(self, x, layer: dict, pos0, table, *, window: int,
                block_size: int, max_seq: int, use_kernel: bool):
        b, s, d = x.shape
        q, k, v = self._heads(x)
        steps = torch.arange(s, device=x.device)
        qpos = pos0.long()[:, None] + steps[None]      # [b, s]
        if self.use_rope:
            # absolute positions: the cache holds rotated keys
            q, k = rope(q, qpos), rope(k, qpos)
        if table is None:
            k_read, v_read = _dense_rw(layer, k, v, pos0, max_seq)
        else:
            _paged_write(layer, k, v, qpos, table, block_size)
            if s == 1 and window == 0 and use_kernel:
                o = paged_attention_decode(
                    q[:, :, 0], layer["k_pool"], layer["v_pool"], table,
                    pos0, layer.get("k_pool_scale"),
                    layer.get("v_pool_scale"))
                return self.out(o.reshape(b, 1, d))
            k_read, v_read = _paged_read(layer, table, b, max_seq)
        return self.out(_masked_attention(q, k_read, v_read, qpos, window))


def _store_kv(layer: dict, names, k, v, put) -> None:
    """Write this step's K and V (``[b, n_kv, s, w]``) by ``put(tensor,
    values)`` into the cache tensors ``names`` (``("k", "v")`` or
    ``("k_pool", "v_pool")``); as int8 levels beside their
    ``<name>_scale`` tensors when the cache holds those."""
    kn, vn = names
    if kn + "_scale" in layer:
        kq, vq = quantize_int8(k, axis=-1), quantize_int8(v, axis=-1)
        put(layer[kn], kq.q)
        put(layer[vn], vq.q)
        put(layer[kn + "_scale"], kq.scale)
        put(layer[vn + "_scale"], vq.scale)
    else:
        put(layer[kn], k)
        put(layer[vn], v)


def _load_kv(layer: dict, names, view):
    """K and V of the whole cache through ``view``, in the reference's
    dtypes: K in the cache's dtype and V in f32, or both in f32 after
    the int8 dequantize (so paged equals dense bit for bit)."""
    kn, vn = names
    if kn + "_scale" in layer:
        return (view(layer[kn]).float() * view(layer[kn + "_scale"]),
                view(layer[vn]).float() * view(layer[vn + "_scale"]))
    return view(layer[kn]), view(layer[vn]).float()


def _dense_rw(layer: dict, k, v, pos0, max_seq: int):
    """Dense ``[b, n_kv, max_seq, hd]`` cache: write the s new tokens of
    each row at its position, read every position.

    The start of a row's s-token write is clamped to ``[0, max_seq - s]``
    as a whole, as ``jax.lax.dynamic_update_slice`` clamps it: a write
    that would pass max_seq lands earlier, over real K/V (the batcher
    caps its chunk pad for this reason), and a finished row that decodes
    past max_seq writes into its own last position."""
    b, n_kv, s, _hd = k.shape
    start = pos0.long().clamp(0, max_seq - s)
    cols = (start[:, None] + torch.arange(s, device=k.device)).reshape(-1)
    rows = torch.arange(b, device=k.device).repeat_interleave(s)

    def put(t, val):  # t[row, :, col] = val
        t[rows, :, cols] = val.transpose(1, 2).reshape(
            b * s, n_kv, -1).to(t.dtype)

    _store_kv(layer, ("k", "v"), k, v, put)
    return _load_kv(layer, ("k", "v"), lambda t: t)


def _paged_write(layer: dict, k, v, qpos, table, block_size: int) -> None:
    """Write each (row, token) at its physical (block, :, offset) of the
    pools.  The logical block index is clamped to the table token by
    token, as the reference's gather clamps it: a finished row that
    decodes past max_seq writes into its last table entry."""
    b, n_kv, s, _hd = k.shape
    nb_max = table.shape[1]
    flat = qpos.reshape(-1)
    rows = torch.arange(b, device=k.device).repeat_interleave(s)
    bidx = table[rows, (flat // block_size).clamp_(max=nb_max - 1)].long()
    off = flat % block_size

    def put(t, val):  # t[block, :, offset] = val
        t[bidx, :, off] = val.transpose(1, 2).reshape(
            b * s, n_kv, -1).to(t.dtype)

    _store_kv(layer, ("k_pool", "v_pool"), k, v, put)


def _paged_read(layer: dict, table, b: int, max_seq: int):
    """The gather path: each row's pages back into ``[b, n_kv, max_seq,
    hd]``."""
    tl = table.long()

    def page_read(pool):
        return pool[tl].transpose(1, 2).reshape(b, pool.shape[1], max_seq,
                                                -1)

    return _load_kv(layer, ("k_pool", "v_pool"), page_read)


def _masked_attention(q, k_read, v_read, qpos, window: int):
    """The decode path's attention over a whole ``[b, n_kv, L, hd]``
    cache, one copy for both layouts (the reference's masked tail, plain
    XLA there): a key is kept iff its position is <= the query's (and
    > the query's - window); grouped heads, f32 scores and softmax.
    Returns ``[b, s, H * hd]``."""
    b, nh, s, hd = q.shape
    n_kv, length = k_read.shape[1], k_read.shape[2]
    kpos = torch.arange(length, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]  # [b, s, L]
    if window > 0:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    g = nh // n_kv
    ct = torch.promote_types(q.dtype, k_read.dtype)
    qg = q.reshape(b, n_kv, g, s, hd).to(ct)
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k_read.to(ct))
    scores = scores.float().mul_(hd ** -0.5)
    scores.masked_fill_(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bngqk,bnkd->bngqd", probs, v_read).to(q.dtype)
    return o.reshape(b, nh, s, hd).transpose(1, 2).reshape(b, s, nh * hd)


class MoeMlp(nn.Module):
    """Mixture-of-experts FFN block: top-k routed with static capacity,
    ``vtpu_torch.parallel.moe.moe_ffn_local`` with tanh-GELU experts.
    Parameters in the flax layout (no transpose on the way in): ``router``
    ``[d, E]``, ``w_in`` ``[E, d, h]``, ``w_out`` ``[E, h, d]``.
    ``capacity`` 0 is lossless (t * top_k slots an expert, so a row's
    output does not depend on its batch)."""

    def __init__(self, d: int, n_experts: int, top_k: int = 2,
                 mlp_ratio: int = 4, capacity: int = 0, *, device=None,
                 dtype=None):
        super().__init__()
        self.n_experts, self.top_k, self.capacity = n_experts, top_k, capacity
        h = mlp_ratio * d
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Parameter(torch.empty(d, n_experts, **kw))
        self.w_in = nn.Parameter(torch.empty(n_experts, d, h, **kw))
        self.w_out = nn.Parameter(torch.empty(n_experts, h, d, **kw))

    def weight(self, name: str, dtype) -> torch.Tensor:
        """``router``, ``w_in`` or ``w_out``: the parameter, or its int8
        levels (buffers ``<name>_q``, ``<name>_scale``) dequantized to
        ``dtype`` through bf16."""
        q = self._buffers.get(name + "_q")
        if q is None:
            return getattr(self, name)
        return dequantize_weight(q, self._buffers[name + "_scale"], dtype)

    def forward(self, x, aux: list | None = None):
        b, s, d = x.shape
        out, (logits, ef) = moe_ffn_local(
            x.reshape(b * s, d), self.weight("router", x.dtype),
            self.weight("w_in", x.dtype), self.weight("w_out", x.dtype),
            capacity=self.capacity, top_k=self.top_k, act=gelu,
            return_aux=True)
        if aux is not None:  # what flax sows into "intermediates"
            aux.append(load_balance_loss(logits, ef, self.n_experts))
        return out.reshape(b, s, d)


class Block(nn.Module):
    def __init__(self, d: int, num_heads: int, num_kv_heads: int,
                 use_rope: bool, mlp_ratio: int = 4, *, mlp: str = "dense",
                 n_experts: int = 8, moe_top_k: int = 2,
                 moe_capacity: int = 0, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(d, **kw)
        self.attn = Attention(d, num_heads, num_kv_heads, use_rope, **kw)
        self.ln2 = LayerNorm(d, **kw)
        if mlp == "moe":
            self.moe = MoeMlp(d, n_experts, moe_top_k, mlp_ratio,
                              moe_capacity, **kw)
        else:
            self.mlp_in = nn.Linear(d, mlp_ratio * d, **kw)
            self.mlp_out = nn.Linear(mlp_ratio * d, d, **kw)

    def forward(self, x, layer=None, pos0=None, table=None, *,
                ln_kernel: bool, aux: list | None = None, **attn_kw):
        x = x + self.attn(self.ln1(x, ln_kernel), layer, pos0, table,
                          **attn_kw)
        if hasattr(self, "moe"):
            return x + self.moe(self.ln2(x, ln_kernel), aux)
        h = self.mlp_in(self.ln2(x, ln_kernel))
        # flax nn.gelu defaults to the tanh approximation
        return x + self.mlp_out(gelu(h))


# knobs a clone may change: none of them shapes a weight
_CLONE_KNOBS = ("kv_cache_dtype", "kv_cache_layout", "kv_block_size",
                "kv_pool_blocks", "paged_kernel", "ln_kernel", "flash_kernel")


class TransformerLM(nn.Module):
    """GPT-style causal LM.  ``forward(tokens [b, s], cache)`` returns
    logits ``[b, s, vocab]`` in f32 and advances ``cache`` in place;
    ``forward(tokens, decode=False)`` is the full causal forward, with
    autograd (the training path).

    ``paged_kernel``: "auto" (the kernel on CUDA, the gather path on the
    CPU), "on" (the kernel's wrapper everywhere; on a CPU tensor that is
    its plain version) or "off" (the gather path).  ``ln_kernel``:
    "auto" (the fused LayerNorm wrapper) or "off" (its plain version on
    every device, for comparisons on the card).  ``flash_kernel``:
    "auto" (the flash-attention wrappers in the full forward) or "off"
    (the plain attention on every device).

    Weights are drawn from ``generator`` (default: seed 0 on ``device``):
    N(0, 1/fan_in) for dense kernels, N(0, 1/d_model) for embeddings,
    ones/zeros for LayerNorm and biases.
    """

    def __init__(self, vocab: int = 32000, d_model: int = 512,
                 depth: int = 8, num_heads: int = 8, max_seq: int = 2048,
                 num_kv_heads: int = 0, pos_embedding: str = "learned",
                 attn_window: int = 0, mlp: str = "dense",
                 n_experts: int = 8, moe_top_k: int = 2,
                 moe_capacity: int = 0, kv_cache_dtype: str = "native",
                 kv_cache_layout: str = "paged", kv_block_size: int = 16,
                 kv_pool_blocks: int = 0, paged_kernel: str = "auto",
                 ln_kernel: str = "auto", flash_kernel: str = "auto", *,
                 device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.vocab, self.d_model, self.depth = vocab, d_model, depth
        self.num_heads, self.max_seq = num_heads, max_seq
        self.num_kv_heads = num_kv_heads
        self.pos_embedding, self.attn_window, self.mlp = (
            pos_embedding, attn_window, mlp)
        self.n_experts, self.moe_top_k, self.moe_capacity = (
            n_experts, moe_top_k, moe_capacity)
        self.kv_cache_dtype, self.kv_cache_layout = (
            kv_cache_dtype, kv_cache_layout)
        self.kv_block_size, self.kv_pool_blocks = kv_block_size, kv_pool_blocks
        self.paged_kernel, self.ln_kernel = paged_kernel, ln_kernel
        self.flash_kernel = flash_kernel
        self._validate()
        dev = resolve_device(device)
        self.dtype = dtype
        meta = dict(device="meta", dtype=dtype)
        self.wte = nn.Embedding(vocab, d_model, **meta)
        if pos_embedding == "learned":
            self.wpe = nn.Embedding(max_seq, d_model, **meta)
        use_rope = pos_embedding == "rope"
        self.h = nn.ModuleList(
            Block(d_model, num_heads, num_kv_heads, use_rope, mlp=mlp,
                  n_experts=n_experts, moe_top_k=moe_top_k,
                  moe_capacity=moe_capacity, **meta)
            for _ in range(depth)
        )
        self.ln_f = LayerNorm(d_model, **meta)
        self.lm_head = nn.Linear(d_model, vocab, bias=False, **meta)
        self.to_empty(device=dev)
        self.reset_parameters(generator)

    # -- configuration --------------------------------------------------
    def _validate(self) -> None:
        """The reference's ValueErrors for bad knobs (checked at
        construction here, at apply time there)."""
        if self.pos_embedding not in ("learned", "rope"):
            raise ValueError(
                f"pos_embedding must be 'learned' or 'rope', "
                f"got {self.pos_embedding!r}"
            )
        if self.mlp not in ("dense", "moe"):
            raise ValueError(f"mlp must be 'dense' or 'moe', got {self.mlp!r}")
        if self.kv_cache_dtype not in ("native", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'native' or 'int8', "
                f"got {self.kv_cache_dtype!r}"
            )
        if self.kv_cache_layout not in ("dense", "paged"):
            raise ValueError(
                f"kv_cache_layout must be 'dense' or 'paged', "
                f"got {self.kv_cache_layout!r}"
            )
        if self.paged_kernel not in ("auto", "on", "off"):
            raise ValueError(
                f"paged_kernel must be 'auto', 'on' or 'off', "
                f"got {self.paged_kernel!r}"
            )
        if self.ln_kernel not in ("auto", "off"):
            raise ValueError(
                f"ln_kernel must be 'auto' or 'off', got {self.ln_kernel!r}")
        if self.flash_kernel not in ("auto", "off"):
            raise ValueError(
                f"flash_kernel must be 'auto' or 'off', "
                f"got {self.flash_kernel!r}")
        if self.kv_cache_layout == "paged":
            if self.paged_kernel == "on" and self.attn_window > 0:
                raise ValueError(
                    "the paged decode kernel does not implement "
                    "sliding-window masking; attn_window needs "
                    "paged_kernel='off' (the gather path)"
                )
            if self.max_seq % self.kv_block_size != 0:
                raise ValueError(
                    f"kv_block_size {self.kv_block_size} must divide "
                    f"max_seq {self.max_seq}"
                )

    def clone(self, **updates) -> "TransformerLM":
        """A model that shares this one's weights with some cache or
        kernel knobs changed (flax's ``Module.clone`` counterpart)."""
        bad = set(updates) - set(_CLONE_KNOBS)
        if bad:
            raise TypeError(f"clone cannot change {sorted(bad)}; "
                            f"only {list(_CLONE_KNOBS)}")
        new = copy.copy(self)  # new __dict__; parameters stay shared
        for k, v in updates.items():
            object.__setattr__(new, k, v)
        new._validate()
        return new

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    # -- int8 weights ---------------------------------------------------
    def quantize_weights(self, min_elems: int = 16384) -> "TransformerLM":
        """A model with this one's knobs whose projections that
        ``quantize_tree(state dict, min_elems)`` selects hold int8 levels
        (quantized where the weights are); it shares every other tensor
        with this one, which is left as it is."""
        keep = {id(t): t for t in itertools.chain(self.parameters(),
                                                   self.buffers())}
        new = copy.deepcopy(self, keep)  # a new module tree, same tensors
        with torch.no_grad():
            qtree = quantize_tree(dict(self.named_parameters()), min_elems)
        for name, qt in qtree.items():
            if is_quantized(qt):
                new._install_quantized(name, qt)
        return new

    def load_quantized(self, state_dict) -> "TransformerLM":
        """Load a state dict in which some entries are ``QuantizedTensor``
        (``params_from_flax`` of a quantized flax tree, or
        ``quantize_tree`` of a state dict): each becomes the int8 storage
        of its weight, and the rest load as ``load_state_dict`` loads
        them, strictly.  In place; returns the model."""
        plain, installed = {}, set()
        for name, v in state_dict.items():
            if not is_quantized(v):
                plain[name] = v
                continue
            installed |= self._install_quantized(name, QuantizedTensor(
                v.q.to(self.device), v.scale.to(self.device), v.axis))
        missing, unexpected = self.load_state_dict(plain, strict=False)
        if unexpected or set(missing) - installed:
            raise RuntimeError(
                f"load_quantized: missing {sorted(set(missing) - installed)}"
                f", unexpected {sorted(unexpected)}")
        return self

    def _install_quantized(self, name: str, qt: QuantizedTensor) -> set:
        """Swap the weight ``name`` (an ``nn.Linear`` weight or an MoE
        leaf) for int8 levels ``qt`` of its shape; returns the names of
        the new state-dict entries."""
        path, leaf = name.rsplit(".", 1)
        mod = self.get_submodule(path)
        want = getattr(mod, leaf, None)
        if want is None or tuple(want.shape) != tuple(qt.q.shape):
            raise ValueError(f"{name}: no weight of shape "
                             f"{tuple(qt.q.shape)} to quantize")
        if isinstance(mod, nn.Linear) and leaf == "weight":
            parent, attr = path.rsplit(".", 1) if "." in path else ("", path)
            setattr(self.get_submodule(parent), attr,
                    QuantLinear(qt, mod.bias))
            return {f"{path}.q", f"{path}.scale"}
        if isinstance(mod, MoeMlp) and qt.axis == qt.q.dim() - 2:
            delattr(mod, leaf)
            mod.register_buffer(leaf + "_q", qt.q)
            mod.register_buffer(leaf + "_scale", qt.scale)
            return {f"{name}_q", f"{name}_scale"}
        raise ValueError(f"{name} cannot hold int8 levels reduced over "
                         f"axis {qt.axis}")

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        for name, p in self.named_parameters():
            if name.endswith(("ln1.scale", "ln2.scale", "ln_f.scale")):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name in ("wte.weight", "wpe.weight"):
                p.normal_(0.0, self.d_model ** -0.5, generator=gen)
            elif name.endswith("moe.router"):  # [d, E], fan-in d
                p.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
            else:  # nn.Linear [out, in]; the experts' [E, in, out]
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)

    # -- cache ----------------------------------------------------------
    def init_cache(self, batch: int) -> dict:
        """Pristine (zero) decode cache for ``batch`` rows.  Paged: the
        block table is the identity map (row i owns blocks [i*nb,
        (i+1)*nb)) when ``kv_pool_blocks == 0``, all zeros (the garbage
        block) when a serving engine allocates a real pool."""
        dev = self.device
        n_kv = self.num_kv_heads or self.num_heads
        hd = self.d_model // self.num_heads
        quant = self.kv_cache_dtype == "int8"
        store = torch.int8 if quant else self.dtype
        pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        if self.kv_cache_layout == "dense":
            shape = (batch, n_kv, self.max_seq, hd)
            layers = []
            for _ in range(self.depth):
                layer = {"k": torch.zeros(shape, dtype=store, device=dev),
                         "v": torch.zeros(shape, dtype=store, device=dev)}
                if quant:
                    sc = (*shape[:3], 1)
                    layer["k_scale"] = torch.zeros(sc, device=dev)
                    layer["v_scale"] = torch.zeros(sc, device=dev)
                layers.append(layer)
            return {"pos": pos, "layers": layers}
        nb_max = self.max_seq // self.kv_block_size
        pool = self.kv_pool_blocks or batch * nb_max
        if self.kv_pool_blocks == 0:
            table = (torch.arange(batch, device=dev)[:, None] * nb_max
                     + torch.arange(nb_max, device=dev)[None, :])
        else:
            table = torch.zeros((batch, nb_max), dtype=torch.int32, device=dev)
        shape = (pool, n_kv, self.kv_block_size, hd)
        layers = []
        for _ in range(self.depth):
            layer = {"k_pool": torch.zeros(shape, dtype=store, device=dev),
                     "v_pool": torch.zeros(shape, dtype=store, device=dev)}
            if quant:
                sc = (*shape[:3], 1)
                layer["k_pool_scale"] = torch.zeros(sc, device=dev)
                layer["v_pool_scale"] = torch.zeros(sc, device=dev)
            layers.append(layer)
        return {"pos": pos, "block_table": table.to(torch.int32),
                "layers": layers}

    # -- forward --------------------------------------------------------
    def forward(self, tokens: torch.Tensor, cache: dict | None = None,
                decode: bool = True, *, aux: list | None = None
                ) -> torch.Tensor:
        """``aux``: a list to which each MoE block appends its Switch
        load-balance loss (flax sows it into ``intermediates``)."""
        if not decode:
            return self._full(tokens, aux)
        if cache is None:
            raise ValueError("decode=True needs a cache (model.init_cache); "
                             "pass decode=False for a full forward")
        with torch.no_grad():
            return self._decode(tokens, cache, aux)

    def _full(self, tokens: torch.Tensor, aux=None) -> torch.Tensor:
        """Full causal forward over positions arange(s), with autograd."""
        b, s = tokens.shape
        if s > self.max_seq:
            raise ValueError(f"seq {s} > max_seq {self.max_seq}")
        x = self.wte(tokens.long())
        if self.pos_embedding == "learned":
            x = x + self.wpe(torch.arange(s, device=tokens.device)[None])
        ln_kernel = self.ln_kernel == "auto"
        flash = self.flash_kernel == "auto"
        for blk in self.h:
            x = blk(x, ln_kernel=ln_kernel, aux=aux,
                    window=self.attn_window, flash=flash)
        x = self.ln_f(x, ln_kernel)
        return self.lm_head(x).float()

    def _decode(self, tokens: torch.Tensor, cache: dict,
                aux=None) -> torch.Tensor:
        b, s = tokens.shape
        assert s <= self.max_seq, f"seq {s} > max_seq {self.max_seq}"
        pos0 = cache["pos"]  # the one position counter, advanced below
        table = cache.get("block_table")  # None: the dense layout
        x = self.wte(tokens.long())
        if self.pos_embedding == "learned":
            # a finished row may decode past max_seq; its logits are
            # dropped, so clamp the lookup instead of raising
            pos_ids = pos0.long()[:, None] + torch.arange(
                s, device=tokens.device)[None]
            x = x + self.wpe(pos_ids.clamp(max=self.max_seq - 1))
        # the paged kernel serves one-token steps without a window (the
        # reference's condition); the rest takes the masked tail
        use_kernel = (self.paged_kernel == "on"
                      or (self.paged_kernel == "auto"
                          and self.device.type == "cuda"))
        ln_kernel = self.ln_kernel == "auto"
        for blk, layer in zip(self.h, cache["layers"]):
            x = blk(x, layer, pos0, table, ln_kernel=ln_kernel, aux=aux,
                    window=self.attn_window, block_size=self.kv_block_size,
                    max_seq=self.max_seq, use_kernel=use_kernel)
        # in place, after every layer has read pos0 (stream order on the
        # card): a captured decode window reads and writes this tensor
        pos0.add_(s)
        x = self.ln_f(x, ln_kernel)
        return self.lm_head(x).float()


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (shifted): the mean over b * (s - 1) of
    -log_softmax(logits[:, :-1])[tokens[:, 1:]], in f32."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long().to(logits.device)
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()


def tp_param_specs(axis: str = "tp"):
    """Spec hints for tensor parallelism, by state-dict name: ``qkv``,
    ``q``, ``kv`` and ``mlp_in`` split their output features, ``out`` and
    ``mlp_out`` their input features (the Megatron column/row split of
    the reference's ``tp_param_specs``).  In the port's ``[out, in]``
    weights the output features are dim 0, so a column split is
    ``(axis, None)`` and a row split ``(None, axis)``; the rest is
    replicated."""

    def match(name: str, _tensor=None):
        if name.endswith(("qkv.weight", "q.weight", "kv.weight",
                          "mlp_in.weight")):
            return (axis, None)
        if name.endswith("out.weight"):
            return (None, axis)
        return ()

    return match


def bucket_length(n: int, max_seq: int) -> int:
    """Smallest power of two >= ``n``, clamped to ``max_seq``: the
    prefill padding buckets.  Right-padding a prompt is exact under the
    decode path (real positions never attend to the padding, and the
    padding's K/V sit at positions >= the rewound counter)."""
    return min(1 << (max(1, int(n)) - 1).bit_length(), max_seq)


def set_cache_pos(cache: dict, pos) -> dict:
    """Set the model's single position counter to ``pos`` in place (the
    rewind half of the bucketed-prefill contract) and return the cache."""
    cache["pos"].fill_(pos)
    return cache


def _model_device(model: TransformerLM, device, who: str) -> torch.device:
    if model.device.type != resolve_device(device).type:
        raise ValueError(f"the model lives on {model.device}, {who}() "
                         f"was asked for {device}")
    return model.device


def _check_generate(model: TransformerLM, s: int, num_new: int,
                    temperature: float, generator) -> None:
    if num_new < 1:
        raise ValueError(f"num_new must be >= 1, got {num_new}")
    if model.kv_cache_layout == "paged" and model.kv_pool_blocks > 0:
        raise ValueError(
            "a paged model with an explicit pool needs a serving "
            "engine (vtpu_torch.serving.paged.PagedBatcher) to allocate "
            "its block table; generate() supports the dense-equivalent "
            "pool only (kv_pool_blocks=0)"
        )
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs an rng")
    if s + num_new > model.max_seq:
        raise ValueError(
            f"prompt ({s}) + num_new ({num_new}) exceeds "
            f"max_seq ({model.max_seq}) — the cache would silently clamp"
        )


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0,
                  top_k: int = 0, generator=None) -> torch.Tensor:
    """The next token of each row of ``logits`` ``[b, V]``, int32: the
    argmax at temperature 0, else one draw from softmax(logits /
    temperature) with ``generator``, over the ``top_k`` largest scaled
    logits when ``top_k > 0`` (every logit >= the k-th stays in, ties
    included, as the reference's ``scaled >= kth``)."""
    if temperature <= 0:
        return logits.argmax(dim=-1).to(torch.int32)
    scaled = logits / temperature
    if top_k > 0:
        kk = min(top_k, scaled.shape[-1])
        kth = torch.topk(scaled, kk, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def generate(model: TransformerLM, prompt, num_new: int,
             temperature: float = 0.0, prefill_chunk: int = 0,
             eos_id: int | None = None, *, top_k: int = 0, generator=None,
             device="cuda") -> torch.Tensor:
    """Prefill the cache with ``prompt`` [b, s] (in chunks of
    ``prefill_chunk`` when set), then ``num_new`` one-token steps.
    Greedy at ``temperature`` 0; otherwise each token is drawn by
    :func:`sample_tokens` with ``generator`` (a ``torch.Generator`` on
    the model's device, where the reference takes a JAX key), restricted
    to the ``top_k`` largest logits when set.  ``eos_id`` freezes a row
    once it emits it.  ``device`` must be the model's.  Returns
    [b, num_new] int32."""
    dev = _model_device(model, device, "generate")
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, s = prompt.shape
    _check_generate(model, s, num_new, temperature, generator)

    def pick(logits_last):
        return sample_tokens(logits_last, temperature, top_k, generator)

    cache = model.init_cache(b)
    step = prefill_chunk if prefill_chunk > 0 else s
    for lo in range(0, s, step):
        logits = model(prompt[:, lo:lo + step], cache)
    tok = pick(logits[:, -1])
    done = (tok == eos_id) if eos_id is not None else None
    out = [tok]
    for _ in range(num_new - 1):
        nxt = pick(model(tok[:, None], cache)[:, -1])
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def _top(x: torch.Tensor, k: int):
    """The k largest of each row of ``x`` and their indices, ties toward
    the lower index, as ``jax.lax.top_k`` breaks them.  ``torch.topk``
    promises no order among equal values, so this is a stable sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


@torch.no_grad()
def generate_beam(model: TransformerLM, prompt, num_new: int,
                  beam: int = 4, *, device="cuda") -> torch.Tensor:
    """Beam search with the KV cache: beams ride the batch dim ([b·beam]
    rows) and each step gathers every cache tensor along it, in place,
    to follow the parent hypotheses.  Pure log-prob objective, no length
    penalty.  Dense layout only.  Returns the best beam per batch row,
    [b, num_new] int32."""
    dev = _model_device(model, device, "generate_beam")
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, s0 = prompt.shape
    if num_new < 1:
        raise ValueError(f"num_new must be >= 1, got {num_new}")
    if model.kv_cache_layout == "paged":
        raise ValueError(
            "beam search tiles and gathers the cache along the batch "
            "dim, which has no meaning for a pool-indexed paged cache — "
            "use the dense layout for beam decoding"
        )
    if s0 + num_new > model.max_seq:
        raise ValueError(
            f"prompt ({s0}) + num_new ({num_new}) exceeds max_seq "
            f"({model.max_seq})"
        )
    vocab = model.vocab
    cache = model.init_cache(b)
    logits = model(prompt, cache)
    scores, toks0 = _top(torch.log_softmax(logits[:, -1], dim=-1), beam)
    # a fixed [b, beam, num_new] history, written at step t
    hist = torch.zeros((b, beam, num_new), dtype=torch.int32, device=dev)
    hist[:, :, 0] = toks0
    # each row's cache tiled to its beam copies: [b, ...] -> [b·beam, ...]
    cache = {"pos": cache["pos"].repeat_interleave(beam, dim=0),
             "layers": [{n: t.repeat_interleave(beam, dim=0)
                         for n, t in layer.items()}
                        for layer in cache["layers"]]}
    tensors = [cache["pos"]] + [t for layer in cache["layers"]
                                for t in layer.values()]
    tok = toks0.reshape(b * beam).to(torch.int32)
    base = torch.arange(b, device=dev)[:, None] * beam
    for t in range(1, num_new):
        logits = model(tok[:, None], cache)
        logp = torch.log_softmax(logits[:, -1], dim=-1).reshape(
            b, beam, vocab)
        total = scores[:, :, None] + logp
        scores, idx = _top(total.reshape(b, beam * vocab), beam)
        parent = idx // vocab
        ntok = (idx % vocab).to(torch.int32)
        sel = (base + parent).reshape(-1)
        for x in tensors:
            x.copy_(x.index_select(0, sel))
        hist = torch.gather(hist, 1,
                            parent[:, :, None].expand(-1, -1, num_new))
        hist[:, :, t] = ntok
        tok = ntok.reshape(b * beam)
    best = scores.argmax(dim=1)  # the first of equal scores, as jnp's
    return hist[torch.arange(b, device=dev), best]


@torch.no_grad()
def generate_speculative(model: TransformerLM, draft_model: TransformerLM,
                         prompt, num_new: int, k: int = 4,
                         return_stats: bool = False, *, device="cuda"):
    """Speculative greedy decoding: ``draft_model`` proposes ``k`` tokens
    a round, the target verifies them in one (k+1)-token forward, and the
    longest matching prefix plus the target's own next token are
    accepted (the batch's minimum, in lockstep).  The tokens are exactly
    the target's greedy decode.  A rejected draft is rewound by
    :func:`set_cache_pos` alone: K/V past the counter are never read and
    are overwritten on the next advance.  With ``return_stats`` also
    returns ``{"verify_forwards": n}``."""
    dev = _model_device(model, device, "generate_speculative")
    _model_device(draft_model, device, "generate_speculative")
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, s0 = prompt.shape
    for m, who in ((model, "target"), (draft_model, "draft")):
        if m.kv_cache_layout == "paged" and m.kv_pool_blocks > 0:
            raise ValueError(
                f"the {who} model's explicit paged pool needs a serving "
                "engine to allocate its block table (kv_pool_blocks=0 "
                "is the dense-equivalent form speculative decode supports)"
            )
        if s0 + num_new + k + 1 > m.max_seq:
            raise ValueError(
                f"prompt ({s0}) + num_new ({num_new}) + draft window "
                f"({k + 1}) exceeds the {who} model's max_seq ({m.max_seq})"
            )

    def argmax(logits):
        return logits.argmax(dim=-1).to(torch.int32)

    # prefill both; the prompt's last position gives the first token
    t_cache = model.init_cache(b)
    pending = argmax(model(prompt, t_cache)[:, -1])
    d_cache = draft_model.init_cache(b)
    draft_model(prompt, d_cache)
    out = [pending]
    n_done, pos, verify_forwards = 1, s0, 0
    while n_done < num_new:
        verify_forwards += 1
        # k drafts from the pending token, plus one step that feeds the
        # last draft so its K/V lands in the draft cache (without it a
        # fully accepted round leaves a hole the next round reads)
        set_cache_pos(d_cache, pos)
        drafts, tok = [], pending
        for _ in range(k + 1):
            tok = argmax(draft_model(tok[:, None], d_cache)[:, -1])
            drafts.append(tok)
        d_stack = torch.stack(drafts[:k], dim=1)           # [b, k]
        set_cache_pos(t_cache, pos)
        block = torch.cat([pending[:, None], d_stack], dim=1)
        greedy = argmax(model(block, t_cache))             # [b, k+1]
        match = (d_stack == greedy[:, :-1]).to(torch.int32)
        n_min = int(match.cumprod(dim=1).sum(dim=1).min())  # host sync
        out.extend(d_stack[:, i] for i in range(n_min))
        pending = greedy[:, n_min]
        out.append(pending)
        n_done += n_min + 1
        pos += n_min + 1
    toks = torch.stack(out[:num_new], dim=1)
    if return_stats:
        return toks, {"verify_forwards": verify_forwards}
    return toks
