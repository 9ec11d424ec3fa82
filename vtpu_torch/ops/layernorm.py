"""Fused LayerNorm: the wrapper of ``csrc/layernorm.cu`` and its plain
PyTorch version.

Counterpart of ``vtpu/ops/layernorm.py``.  ``fused_layernorm`` is
differentiable: its forward launches the kernel on a CUDA tensor, for
every row count, and runs ``_reference_ln`` on a CPU tensor; its
backward is the exact gradient of ``_reference_ln``, taken from the
reference by autograd as the JAX package's ``_ln_bwd`` takes its VJP
(plain PyTorch: that backward is XLA there, not a Pallas kernel).
"""

from __future__ import annotations

import torch

from vtpu_torch.ops import _build

_ENTRY = {
    (torch.float32, torch.float32): "vtpu_layernorm_f32_f32",
    (torch.bfloat16, torch.bfloat16): "vtpu_layernorm_bf16_bf16",
}


def _reference_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 statistics (biased
    variance ``mean((x - mean)^2)``), result cast to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def _layernorm_forward(x, gamma, beta, eps):
    if x.device.type == "cpu":
        return _reference_ln(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm: unsupported device {x.device}")
    d = x.shape[-1]
    entry = _ENTRY.get((x.dtype, gamma.dtype))
    if entry is None or beta.dtype != gamma.dtype:
        raise TypeError(
            f"fused_layernorm: no kernel for x {x.dtype}, gamma "
            f"{gamma.dtype}, beta {beta.dtype}"
        )
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(
            f"fused_layernorm: gamma/beta must be [{d}], got "
            f"{tuple(gamma.shape)} and {tuple(beta.shape)}"
        )
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("fused_layernorm: x, gamma and beta must share a device")
    x2 = x.contiguous()
    y = torch.empty_like(x2)
    rows = x2.numel() // d if d else 0
    if rows == 0:
        return y
    g, b = gamma.contiguous(), beta.contiguous()
    fn = getattr(_build.lib(), entry)
    err = fn(x2.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
             rows, d, float(eps), _build.stream_ptr(x2))
    _build.check(err, "layernorm kernel")
    fused_layernorm.launches += 1
    return y


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return _layernorm_forward(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        with torch.enable_grad():
            a, g, b = (t.detach().requires_grad_() for t in (x, gamma, beta))
            y = _reference_ln(a, g, b, ctx.eps)
            dx, dg, db = torch.autograd.grad(y, (a, g, b), dy)
        return dx, dg, db, None


def fused_layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis.  x: [..., d]; gamma/beta: [d]."""
    return _LayerNorm.apply(x, gamma, beta, eps)


fused_layernorm.launches = 0
