"""Flash attention: the wrappers of the flash kernels (forward, dq,
dk/dv; bf16 -> bf16 and the bf16 -> f32-out forward on the tensor cores
in ``csrc/flash_attention_sm90.cu``; the f32 forward and backward on the
tensor cores as 3xTF32 in ``csrc/flash_attention_tf32x3.cu``), the
autograd functions built on them, and their plain PyTorch versions.

The wrappers pick the kernel by head dim, before any launch: up to
``MAX_TILED_HD`` (128) the kernels above; up to ``MAX_HD`` (512) the
``_wide`` entries, which hold the head dim 128 columns at a time (the
f32 forward and backward as 3xTF32 in ``csrc/flash_attention_tf32x3.cu``,
the bf16 forward, its f32-out twin and the bf16 backward on the tensor
cores in ``csrc/flash_attention_sm90.cu``); above that they raise
``ValueError``.

Counterpart of ``vtpu/ops/attention.py``, with its layouts: q, k, v
``[b, h, s, d]`` or ``[s, d]`` (any leading dims), lse ``[..., s, 1]`` in
f32.  ``flash_attention`` and ``flash_attention_gqa`` differentiate
through the two backward kernels, which rematerialize p from the saved
lse; ``flash_attention_with_lse`` differentiates the reference
formulation for both of its outputs, as the JAX package does.

On a CUDA tensor each kernel wrapper (:func:`flash_forward`,
:func:`flash_bwd_dq`, :func:`flash_bwd_dkv`) launches its kernel or
raises; on a CPU tensor it runs its plain version
(:func:`flash_attention_reference`, :func:`flash_bwd_dq_reference`,
:func:`flash_bwd_dkv_reference`).  There is no other path.

Two differences from the TPU wrappers, both in what the kernels take:
every sequence length runs the kernels (the TPU sends a length that is
not a multiple of 128 to the XLA reference, whose lse is 0), and a row
with no kept key (the first row under ``shift=-1``) gets o = 0 where the
TPU kernel writes the mean of its first block's v; its lse is ~-1e30 on
both, so its weight in any merge of partials is 0.
"""

from __future__ import annotations

import torch

from vtpu_torch.ops import _build

NEG_INF = -1e30

_FWD_ENTRY = {
    (torch.float32, torch.float32): "f32",
    (torch.bfloat16, torch.bfloat16): "bf16",
    (torch.bfloat16, torch.float32): "bf16_f32out",
}
_BWD_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_TILED_HD = 128  # the tensor-core and register-tiled kernels
MAX_HD = 512        # the kernels that walk the head dim in chunks


# -- the reference formulations (plain; autograd differentiates them) ----
def apply_causal_mask(s: torch.Tensor, shift: int = 0,
                      window: int = 0) -> torch.Tensor:
    """Triangular mask on a ``[..., q, k]`` score tensor: keeps
    k <= q + shift and, with ``window`` > 0, k > q - window.  Masked
    scores become NEG_INF."""
    nq, nk = s.shape[-2:]
    ones = torch.ones((nq, nk), dtype=torch.bool, device=s.device)
    mask = ones.tril(shift)
    if window > 0:
        mask = mask & ones.triu(-(window - 1))
    return s.masked_fill(~mask, NEG_INF)


def reference_attention(q, k, v, causal: bool = False, *, shift: int = 0,
                        window: int = 0) -> torch.Tensor:
    """Plain attention: the einsums in the input dtype, scores and
    softmax in f32, the result in q's dtype."""
    if window > 0 and not causal:
        raise ValueError("window > 0 requires causal=True")
    sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * sm_scale
    if causal:
        s = apply_causal_mask(s, shift, window)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p, v.float()).to(q.dtype)


def _ref_with_lse(q, k, v, causal: bool = False, shift: int = 0):
    """Reference (o, lse): the backward formulation of
    :func:`flash_attention_with_lse` (both cotangents)."""
    sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * sm_scale
    if causal:
        s = apply_causal_mask(s, shift)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("...qk,...kd->...qd", p, v.float()) / l
    return o, m + torch.log(l)


# -- the kernels' plain versions -----------------------------------------
def _grouped(q, k):
    """(Nk, g): the kv heads of k ``[..., sk, d]`` flattened over every
    leading dim, and the query heads of q per kv head; flattened query
    head n reads kv head n // g."""
    n_q, n_kv = q.shape[:-2].numel(), k.shape[:-2].numel()
    if n_kv == 0 or n_q % n_kv:
        raise ValueError(
            f"q heads ({n_q}) must divide by kv heads ({n_kv})")
    return n_kv, n_q // n_kv


def _keep(sq, sk, causal, shift, window, device):
    """[sq, sk] bool: which (query, key) pairs the kernels keep."""
    qpos = torch.arange(sq, device=device)[:, None] + shift
    kpos = torch.arange(sk, device=device)[None, :]
    if not causal:
        return torch.ones((sq, sk), dtype=torch.bool, device=device)
    keep = kpos <= qpos
    if window > 0:
        keep = keep & (kpos > qpos - window)
    return keep


def _scores(q, k, causal, shift, window):
    """f32 scores ``[Nk, g, sq, sk]`` and the keep mask."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    n_kv, g = _grouped(q, k)
    qf = q.reshape(n_kv, g, sq, d).float()
    kf = k.reshape(n_kv, sk, d).float()
    s = torch.einsum("ngqd,nkd->ngqk", qf, kf) * (d ** -0.5)
    keep = _keep(sq, sk, causal, shift, window, q.device)
    return s.masked_fill(~keep, NEG_INF), keep, qf


def flash_attention_reference(q, k, v, causal: bool = False, shift: int = 0,
                              window: int = 0, out_dtype=None):
    """The forward kernel's arithmetic: (o, lse) with f32 softmax, masked
    p forced to 0, l clamped at 1e-30, lse = m + log(l).  o comes in
    ``out_dtype`` (default q's dtype), lse ``[..., sq, 1]`` f32."""
    s, keep, _ = _scores(q, k, causal, shift, window)
    n_kv, g, sq, sk = s.shape
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~keep, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    vf = v.reshape(n_kv, sk, v.shape[-1]).float()
    o = torch.einsum("ngqk,nkd->ngqd", p, vf) / l
    lse = m + torch.log(l)
    return (o.to(out_dtype or q.dtype).reshape(q.shape),
            lse.reshape(*q.shape[:-1], 1))


def _probs(q, k, v, do, lse, delta, causal, shift, window):
    """p = exp(s - lse) with masked entries 0, and
    ds = p * (do . v - delta) * scale, both ``[Nk, g, sq, sk]`` f32."""
    s, keep, qf = _scores(q, k, causal, shift, window)
    n_kv, g, sq, sk = s.shape
    lse4 = lse.reshape(n_kv, g, sq, 1).float()
    delta4 = delta.reshape(n_kv, g, sq, 1).float()
    p = torch.exp(s - lse4).masked_fill(~keep, 0.0)
    dof = do.reshape(n_kv, g, sq, do.shape[-1]).float()
    vf = v.reshape(n_kv, sk, v.shape[-1]).float()
    dp = torch.einsum("ngqd,nkd->ngqk", dof, vf)
    ds = p * (dp - delta4) * (q.shape[-1] ** -0.5)
    return p, ds, qf, dof


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool = False,
                           shift: int = 0, window: int = 0):
    """dq = ds . k, in q's dtype."""
    _p, ds, _qf, _dof = _probs(q, k, v, do, lse, delta, causal, shift,
                               window)
    kf = k.reshape(ds.shape[0], k.shape[-2], k.shape[-1]).float()
    return torch.einsum("ngqk,nkd->ngqd", ds, kf).to(q.dtype).reshape(
        q.shape)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = False,
                            shift: int = 0, window: int = 0):
    """(dk, dv) = (ds^T . q, p^T . do), summed over the g query heads of
    each kv head, in k's and v's dtypes."""
    p, ds, qf, dof = _probs(q, k, v, do, lse, delta, causal, shift, window)
    dv = torch.einsum("ngqk,ngqd->nkd", p, dof)
    dk = torch.einsum("ngqk,ngqd->nkd", ds, qf)
    return dk.to(k.dtype).reshape(k.shape), dv.to(v.dtype).reshape(v.shape)


# -- the kernel wrappers ---------------------------------------------------
def _check(name, tensors):
    """Validate (q, k, v[, do, lse, delta]) for a kernel; returns
    (query heads, query heads per kv head)."""
    q, k, v = tensors[:3]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all operands must share q's device")
    if q.dtype not in _BWD_SUFFIX or any(
            t.dtype != q.dtype for t in tensors[:4]):
        raise TypeError(f"{name}: no kernel for "
                        f"{[str(t.dtype) for t in tensors]}")
    # the kernels flatten every leading dim: all but the head dim agree
    if (q.dim() < 2 or k.dim() != q.dim() or v.shape != k.shape
            or q.shape[-1] != k.shape[-1] or q.shape[:-3] != k.shape[:-3]):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} must be [..., h, s, d] "
                         f"alike")
    if len(tensors) > 3:
        do, lse, delta = tensors[3:]
        rows = q.shape[:-1].numel()
        if do.shape != q.shape or lse.numel() != rows or (
                delta.numel() != rows):
            raise ValueError(f"{name}: do must be q's shape and lse, delta "
                             f"[..., s, 1]")
    n_kv, g = _grouped(q, k)
    return n_kv * g, g


def _entry(base: str, hd: int, suffix: str) -> str:
    """The C entry for this head dim: ``vtpu_<base>_<suffix>``, or its
    chunked ``_wide_`` twin above ``MAX_TILED_HD``; a head dim above
    ``MAX_HD`` raises."""
    if hd > MAX_HD:
        raise ValueError(f"vtpu_{base}: head dim {hd} is above {MAX_HD}, "
                         f"the largest the kernels take")
    wide = "wide_" if hd > MAX_TILED_HD else ""
    return f"vtpu_{base}_{wide}{suffix}"


def _dims(q, k, causal, shift, window):
    return (q.shape[-2], k.shape[-2], q.shape[-1], int(bool(causal)),
            int(shift), int(window), float(q.shape[-1] ** -0.5))


def flash_forward(q, k, v, causal: bool = False, shift: int = 0,
                  window: int = 0, out_dtype=None):
    """(o, lse) through the forward kernel; see
    :func:`flash_attention_reference` for what it computes."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, shift, window,
                                         out_dtype)
    n_q, g = _check("flash_forward", [q, k, v])
    out_dtype = out_dtype or q.dtype
    suffix = _FWD_ENTRY.get((q.dtype, out_dtype))
    if suffix is None:
        raise TypeError(f"flash_forward: no kernel for q {q.dtype} with "
                        f"o {out_dtype}")
    entry = _entry("flash_fwd", q.shape[-1], suffix)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((*q.shape[:-1], 1), dtype=torch.float32,
                      device=q.device)
    if o.numel() == 0:
        return o, lse
    err = getattr(_build.lib(), entry)(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), o.data_ptr(),
        lse.data_ptr(), n_q, g, *_dims(q, k, causal, shift, window),
        _build.stream_ptr(qc))
    _build.check(err, "flash forward kernel")
    flash_forward.launches += 1
    if suffix == "bf16_f32out":  # ring attention's partials
        flash_forward.f32out_launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                 shift: int = 0, window: int = 0):
    """dq through the dq kernel (see :func:`flash_bwd_dq_reference`)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                      shift, window)
    n_q, g = _check("flash_bwd_dq", [q, k, v, do, lse, delta])
    args = [t.contiguous() for t in (q, k, v, do)]
    args += [lse.float().contiguous(), delta.float().contiguous()]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    entry = _entry("flash_bwd_dq", q.shape[-1], _BWD_SUFFIX[q.dtype])
    err = getattr(_build.lib(), entry)(
        *[t.data_ptr() for t in args], dq.data_ptr(), n_q, g,
        *_dims(q, k, causal, shift, window), _build.stream_ptr(q))
    _build.check(err, "flash dq kernel")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                  shift: int = 0, window: int = 0):
    """(dk, dv) through the dk/dv kernel (see
    :func:`flash_bwd_dkv_reference`)."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                       shift, window)
    n_q, g = _check("flash_bwd_dkv", [q, k, v, do, lse, delta])
    args = [t.contiguous() for t in (q, k, v, do)]
    args += [lse.float().contiguous(), delta.float().contiguous()]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    entry = _entry("flash_bwd_dkv", q.shape[-1], _BWD_SUFFIX[q.dtype])
    err = getattr(_build.lib(), entry)(
        *[t.data_ptr() for t in args], dk.data_ptr(), dv.data_ptr(), n_q, g,
        *_dims(q, k, causal, shift, window), _build.stream_ptr(q))
    _build.check(err, "flash dk/dv kernel")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_forward.f32out_launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# -- the differentiable entry points -------------------------------------
class _Flash(torch.autograd.Function):
    """o = attention(q, k, v); backward: delta = sum(do * o) in f32,
    then the dq kernel, then the dk/dv kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, shift, window):
        o, lse = flash_forward(q, k, v, causal, shift, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, shift, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, *ctx.cfg)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ctx.cfg)
        return dq, dk, dv, None, None, None


class _FlashWithLse(torch.autograd.Function):
    """(o f32, lse) from the forward kernel; backward through
    :func:`_ref_with_lse`, for both cotangents."""

    @staticmethod
    def forward(ctx, q, k, v, causal, shift):
        o, lse = flash_forward(q, k, v, causal, shift, 0,
                               out_dtype=torch.float32)
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (causal, shift)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            a, b, c = (t.detach().requires_grad_() for t in (q, k, v))
            o, lse = _ref_with_lse(a, b, c, *ctx.cfg)
            dq, dk, dv = torch.autograd.grad((o, lse), (a, b, c),
                                             (do, dlse))
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128,
                    block_k: int = 128, window: int = 0) -> torch.Tensor:
    """q, k, v ``[b, h, s, d]`` (or ``[s, d]``), differentiable.

    ``window`` > 0 (requires ``causal``) is sliding-window attention:
    each position attends its last ``window`` keys.  ``block_q`` and
    ``block_k`` are the TPU kernel's block sizes, kept for the
    signature: the Hopper kernels tile by 64."""
    del block_q, block_k
    if window > 0 and not causal:
        raise ValueError("window > 0 requires causal=True")
    return _Flash.apply(q, k, v, causal, 0, window)


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             shift: int = 0):
    """(o in f32, lse ``[..., s, 1]``): the per-shard inner op of ring
    attention.  ``shift=-1`` is the strict mask (k < q).  Every length
    returns a real lse."""
    return _FlashWithLse.apply(q, k, v, causal, shift)


def flash_attention_gqa(q, k, v, causal: bool = False,
                        use_kernel: bool | None = None,
                        window: int = 0) -> torch.Tensor:
    """Grouped-query attention: q ``[b, Hq, s, d]`` with k/v
    ``[b, Hkv, s, d]``, Hkv dividing Hq.  ``use_kernel`` None or True
    runs the flash kernels (their plain versions on a CPU tensor), with
    query head h reading kv head h // (Hq / Hkv) inside the kernel;
    False runs the grouped plain reference."""
    b, hq, s, d = q.shape
    hk = k.shape[1]
    if window > 0 and not causal:
        raise ValueError("window > 0 requires causal=True")
    if hq == hk:
        return flash_attention(q, k, v, causal=causal, window=window)
    if hq % hk:
        raise ValueError(f"q heads ({hq}) must divide by kv heads ({hk})")
    if use_kernel is False:
        g = hq // hk
        qg = q.reshape(b, hk, g, s, d)
        sc = torch.einsum("bngqd,bnkd->bngqk", qg, k).float() * d ** -0.5
        if causal:
            sc = apply_causal_mask(sc, 0, window)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bngqk,bnkd->bngqd", p, v.float())
        return o.to(q.dtype).reshape(b, hq, s, d)
    return _Flash.apply(q, k, v, causal, 0, window)
