"""Paged single-token decode attention: the wrapper of
``csrc/paged_attention.cu`` and its plain PyTorch version.

Counterpart of ``vtpu/ops/paged_attention.py``, with its layouts: q
``[b, n_heads, hd]``; pools ``[P, n_kv, bs, hd]`` (native f32/bf16, or
int8 with f32 scale pools ``[P, n_kv, bs, 1]``); ``block_tables``
``[b, nb_max]`` int32; ``lengths`` ``[b]`` int32, the current query
position of each row (key slot ``t*bs + j`` is valid iff it is
``<= lengths[i]``).  Returns ``[b, n_heads, hd]`` in q's dtype.

On a CUDA tensor the wrapper launches the kernel (native or int8 entry),
which takes every head dim up to ``MAX_HD`` and any number of query heads
a kv head; on a CPU tensor it runs :func:`paged_attention_reference`.
"""

from __future__ import annotations

import torch

from vtpu_torch.ops import _build

NEG_INF = -1e30
MAX_HD = 512  # the largest head dim the kernel takes

_ENTRY = {
    (torch.float32, False): "vtpu_paged_decode_f32",
    (torch.bfloat16, False): "vtpu_paged_decode_bf16",
    (torch.float32, True): "vtpu_paged_decode_q8_f32",
    (torch.bfloat16, True): "vtpu_paged_decode_q8_bf16",
}


def paged_attention_reference(q, k_pool, v_pool, block_tables, lengths,
                              k_scale=None, v_scale=None):
    """The gather-based oracle: each row's pages gathered into
    ``[b, n_kv, L, hd]`` (int8 pages dequantized by their scales, as the
    model's gather path does), f32 scores and softmax, -1e30 mask."""
    b, n_heads, hd = q.shape
    _p, n_kv, bs, _ = k_pool.shape
    nb_max = block_tables.shape[1]
    L = nb_max * bs
    g = n_heads // n_kv
    tables = block_tables.long()

    def gather(pool):
        return pool[tables].transpose(1, 2).reshape(b, n_kv, L, -1)

    k, v = gather(k_pool).float(), gather(v_pool).float()
    if k_scale is not None:
        k = k * gather(k_scale)
        v = v * gather(v_scale)
    qg = q.reshape(b, n_kv, g, hd).float()
    s = torch.einsum("bngd,bnkd->bngk", qg, k) * (hd ** -0.5)
    kpos = torch.arange(L, device=q.device)
    valid = kpos[None, :] <= lengths.to(q.device).long()[:, None]  # [b, L]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngk,bnkd->bngd", p, v)
    return o.reshape(b, n_heads, hd).to(q.dtype)


def _check(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale):
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged_attention_decode: q must be [b, H, hd] and pools "
            f"[P, n_kv, bs, hd]; got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}"
        )
    b, n_heads, hd = q.shape
    _p, n_kv, bs, phd = k_pool.shape
    if phd != hd or n_heads % n_kv != 0:
        raise ValueError(
            f"paged_attention_decode: head dims {hd}/{phd} differ or "
            f"{n_heads} heads are not a multiple of {n_kv} kv heads"
        )
    if hd > MAX_HD:
        raise ValueError(f"paged_attention_decode: head dim {hd} is above "
                         f"{MAX_HD}, the largest the kernel takes")
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != b):
        raise ValueError("paged_attention_decode: block_tables must be "
                         "int32 [b, nb_max]")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError("paged_attention_decode: lengths must be int32 [b]")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("paged_attention_decode: pass both scales or none")
    if quant:
        want = (*k_pool.shape[:3], 1)
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or tuple(sc.shape) != want:
                raise ValueError(
                    f"paged_attention_decode: scales must be f32 {want}")
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError("paged_attention_decode: scaled pools must be int8")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged_attention_decode: native pools must have q's dtype "
            f"{q.dtype}, got {k_pool.dtype}/{v_pool.dtype}"
        )
    tensors = [q, k_pool, v_pool, block_tables, lengths]
    tensors += [k_scale, v_scale] if quant else []
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention_decode: all operands must share "
                         "q's device")


def paged_attention_decode(q, k_pool, v_pool, block_tables, lengths,
                           k_scale=None, v_scale=None):
    """Decode attention for one query token per row through the block
    table.  Each physical block id must lie in ``[0, P)`` and each
    length must be ``>= 0``."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: unsupported device "
                         f"{q.device}")
    _check(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale)
    quant = k_scale is not None
    entry = _ENTRY.get((q.dtype, quant))
    if entry is None:
        raise TypeError(f"paged_attention_decode: no kernel for q {q.dtype}")
    b, n_heads, hd = q.shape
    _p, n_kv, bs, _ = k_pool.shape
    nb_max = block_tables.shape[1]
    qc, kc, vc = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    tc, lc = block_tables.contiguous(), lengths.contiguous()
    ks = k_scale.contiguous() if quant else None
    vs = v_scale.contiguous() if quant else None
    out = torch.empty_like(qc)
    lib = _build.lib()
    # split-K partials (m, l, acc per split), written before they are read
    scratch = torch.empty(
        (lib.vtpu_paged_decode_scratch(b, n_heads, n_kv, hd, bs, nb_max),),
        dtype=torch.float32, device=q.device)
    err = getattr(lib, entry)(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
        tc.data_ptr(), lc.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        b, n_heads, n_kv, hd, bs, nb_max, float(hd ** -0.5),
        _build.stream_ptr(qc))
    _build.check(err, "paged decode kernel")
    paged_attention_decode.launches["int8" if quant else "native"] += 1
    return out


paged_attention_decode.launches = {"native": 0, "int8": 0}
