"""Symmetric int8 quantization: the codec of the int8 paged K/V pool.

Only what the int8 pool needs is here: ``quantize_int8`` (absmax/127 per
vector, reconstruction-nearest rounding) and ``dequantize``.  Bytes and
scales are bit-identical to ``vtpu.ops.quant.quantize_int8`` run eagerly
on the same input (tests/test_torch_ops.py).  Under ``jax.jit`` XLA folds
the ``/ 127`` into a multiply by its reciprocal, so a jitted JAX caller
can differ from both by one ulp in a scale.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QuantizedTensor:
    """int8 payload + f32 scale with ``axis`` reduced to 1."""

    q: torch.Tensor
    scale: torch.Tensor
    axis: int


def _nearest_int(xf: torch.Tensor, scale: torch.Tensor,
                 max_q: int = 127) -> torch.Tensor:
    """The integer level whose f32 reconstruction ``q * scale`` is
    nearest to ``xf`` (not ``round(xf / scale)``: the division can land a
    just-below-half ratio on an exact .5 tie).  Ties keep the lower
    level, as the reference does."""
    lo = torch.floor(xf / scale)
    hi = lo + 1.0
    q = torch.where((hi * scale - xf).abs() < (lo * scale - xf).abs(),
                    hi, lo)
    return q.clamp(-max_q, max_q)


def quantize_int8(w: torch.Tensor, axis: int = 0) -> QuantizedTensor:
    """Absmax over ``axis`` (kept as size 1), scale = absmax/127, or 1.0
    where the absmax is 0.  Reconstruction error <= scale/2."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = _nearest_int(wf, scale)
    return QuantizedTensor(q.to(torch.int8), scale, axis % w.dim())


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (qt.q.float() * qt.scale).to(dtype)
