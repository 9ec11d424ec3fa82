"""Symmetric quantization: the codec of the int8 paged K/V pool, the
device halves of the K/V wire codecs, and weight-only int8 trees.

- ``quantize_int8`` (absmax/127 per vector, reconstruction-nearest
  rounding) and ``dequantize``: the int8 K/V cache of both layouts.
  Bytes and scales are bit-identical to ``vtpu.ops.quant.quantize_int8``
  run eagerly on the same input (tests/test_torch_ops.py), on the CPU
  and on the card alike: the divisor is a tensor, as in the wire codec
  below.  Under ``jax.jit`` XLA folds the ``/ 127`` into a multiply by
  its reciprocal, so a jitted JAX caller can differ from both by one ulp
  in a scale.
- the blockwise codecs of the wire (one f32 scale per leading-axis
  block): ``quantize_blockwise`` / ``dequantize_blockwise`` (int8),
  ``quantize_blockwise_int4`` with ``pack_int4``, and
  ``quantize_blockwise_fp8`` / ``dequantize_blockwise_fp8`` (e4m3fn in
  integer and bitcast arithmetic, never a float8 cast).  Their bytes
  equal the numpy twins of ``vtpu_torch/serving/wirecodec.py`` on the
  CPU and on the card (tests/test_torch_wire_codecs.py).  The int8 scale
  divides by 127 in IEEE arithmetic on both: on CUDA PyTorch turns a
  division by a Python scalar into a multiply by its reciprocal, so the
  divisor is a tensor.  The int4 and fp8 scales multiply by an explicit
  f32 reciprocal, as their twins do.
- weight-only int8 over a state dict (``vtpu/ops/quant.py``'s
  ``quantize_tree``, ``dequantize_tree``, ``tree_bytes``,
  ``is_quantized``): the same leaves are quantized, with the same levels
  and scales.  A ``weight`` leaf is an ``nn.Linear`` weight ``[out, in]``
  (the flax kernel transposed) and is reduced over its last axis; every
  other leaf keeps the flax layout (``kernel`` ``[in, out]``, the MoE
  ``router`` ``[d, E]``, ``w_in`` ``[E, d, h]``, ``w_out`` ``[E, h, d]``)
  and is reduced over ``ndim - 2``: one scale per output channel either
  way.  :func:`dequantize_weight` is what a quantized model's forward
  runs at each use of a weight: one elementwise pass that reads the int8
  levels and writes bf16, with no f32 copy of the weight.

These are plain PyTorch: the JAX package runs them as XLA inside its
jitted gathers, scatters and matmuls, with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class QuantizedTensor:
    """int8 payload + f32 scale with ``axis`` reduced to 1."""

    q: torch.Tensor
    scale: torch.Tensor
    axis: int

    @property
    def nbytes(self) -> int:
        return self.q.numel() + 4 * self.scale.numel()


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedTensor)


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
    # a tensor divisor: IEEE division on every device (module doc)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = _nearest_int(wf, scale)
    return QuantizedTensor(q.to(torch.int8), scale, axis % w.dim())


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (qt.q.float() * qt.scale).to(dtype)


# -- weight-only int8 trees -------------------------------------------------

def _is_embedding(name: str) -> bool:
    """The reference's rule, on a dotted name: the leaf is ``embedding``
    or ``embeddings``, any component is ``wte`` or ``wpe``, or a
    ``weight``/``w`` leaf sits under a module whose name holds
    ``embedding`` or has ``embed`` as a ``_``-separated word."""
    parts = name.lower().split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    return (leaf in ("embedding", "embeddings")
            or any(p in ("wte", "wpe") for p in parts)
            or (leaf in ("weight", "w")
                and ("embedding" in parent or "embed" in parent.split("_"))))


def _weight_axis(name: str, ndim: int) -> int:
    """The reduced (input) axis of a weight: the last one of an
    ``nn.Linear`` ``weight`` ``[out, in]``, ``ndim - 2`` of a leaf in the
    flax layout."""
    return ndim - 1 if name.rsplit(".", 1)[-1] == "weight" else ndim - 2


def quantize_tree(params: Mapping[str, torch.Tensor],
                  min_elems: int = 16384) -> Dict[str, object]:
    """Every float leaf with ndim >= 2 and at least ``min_elems`` elements
    as a :class:`QuantizedTensor` (one scale per output channel, see
    :func:`_weight_axis`); embedding tables, norms, biases and small
    leaves as they are.  ``params`` maps dotted names to tensors (a state
    dict); the result has the same keys."""
    out: Dict[str, object] = {}
    for name, leaf in params.items():
        if (not _is_embedding(name) and leaf.dim() >= 2
                and leaf.numel() >= min_elems and leaf.is_floating_point()):
            axis = _weight_axis(name, leaf.dim())
            out[name] = quantize_int8(leaf, axis=axis)
        else:
            out[name] = leaf
    return out


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """``q * scale`` rounded to bf16 in one elementwise pass (the product
    is taken in f32 and rounded as it is stored, which is
    ``(q.float() * scale).to(torch.bfloat16)`` bit for bit, without its
    f32 copy of the weight); then cast to ``dtype`` if that is not bf16.
    Allocates its output and syncs nothing with the host, so a captured
    CUDA graph can hold it."""
    w = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    torch.mul(q, scale, out=w)
    return w if dtype == torch.bfloat16 else w.to(dtype)


def dequantize_tree(params: Mapping[str, object],
                    dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_tree` (bf16 by default, as the
    reference's engines call it); the other leaves as they are."""
    return {name: dequantize(x, dtype) if is_quantized(x) else x
            for name, x in params.items()}


def tree_bytes(params: Mapping[str, object]) -> int:
    """At-rest bytes: a level is one byte and a scale four."""
    return sum(x.nbytes if is_quantized(x) else x.numel() * x.element_size()
               for x in params.values())


# -- the wire codecs' device halves ----------------------------------------

def _block_amax(xf: torch.Tensor) -> torch.Tensor:
    """|x| max over every axis but the first, kept as size-1 axes (the
    element itself for a 1-d input, as the twins do)."""
    if xf.dim() < 2:
        return xf.abs()
    return xf.abs().amax(dim=tuple(range(1, xf.dim())), keepdim=True)


def _recip_scale(amax: torch.Tensor, recip: float) -> torch.Tensor:
    """``amax * f32(recip)``, floored to 1.0 below the smallest f32
    normal (a subnormal scale would be flushed on some backends)."""
    s0 = amax * float(torch.tensor(recip, dtype=torch.float32))
    return torch.where(s0 >= 2.0 ** -126, s0, torch.ones_like(s0))


def quantize_blockwise(x: torch.Tensor):
    """Symmetric per-block int8: ``(q int8 [b, ...], scale f32 [b, 1, ..,
    1])``, scale = absmax/127 per leading-axis block (1.0 where it is 0).
    Error <= scale/2 per element."""
    xf = x.float()
    amax = _block_amax(xf)
    # a tensor divisor: IEEE division on every device (see the module doc)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    return _nearest_int(xf, scale).to(torch.int8), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_blockwise_int4(x: torch.Tensor):
    """Per-block symmetric int4 (``q in [-7, 7]``, unpacked int8), one f32
    scale per block (absmax times the f32 reciprocal of 7).  Error <=
    scale/2."""
    xf = x.float()
    scale = _recip_scale(_block_amax(xf), 1.0 / 7.0)
    return _nearest_int(xf, scale, max_q=7).to(torch.int8), scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4-valued int8 ``[b, ...]`` -> uint8 ``[b, ceil(n/2)]``, the low
    nibble the even flat index."""
    flat = q.reshape(q.shape[0], -1)
    if flat.shape[1] % 2:
        flat = F.pad(flat, (0, 1))
    u = (flat & 0x0F).to(torch.uint8)
    return u[:, 0::2] | (u[:, 1::2] << 4)


_E4M3_MAX = 448.0          # largest finite e4m3fn magnitude
_E4M3_MAX_BYTE = 0x7E      # its encoding (exp field 15, mantissa 6)


def _f32_to_e4m3(y: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even f32 -> e4m3fn byte (sign-magnitude uint8),
    in int32 arithmetic on the f32 bits.  ``y`` is already clipped to
    [-448, 448]; a rounding overflow saturates to ±448."""
    u = y.float().contiguous().view(torch.int32)
    sign = torch.where(u < 0, 0x80, 0).to(torch.int32)
    a = u & 0x7FFFFFFF
    exp = a >> 23
    man = a & 0x7FFFFF
    # normal range (|y| >= 2^-6): the 23-bit mantissa to 3 bits, RN-even,
    # carrying into the exponent
    keep = man >> 20
    rest = man & 0xFFFFF
    carry = ((rest > 0x80000)
             | ((rest == 0x80000) & ((keep & 1) == 1))).to(torch.int32)
    m = keep + carry
    exp2 = torch.where(m == 8, exp + 1, exp)
    m2 = torch.where(m == 8, 0, m)
    norm = ((exp2 - 120) << 3) | m2
    norm = torch.where((exp2 > 135) | ((exp2 == 135) & (m2 == 7)),
                       _E4M3_MAX_BYTE, norm)
    # subnormal range: RN-even onto the 2^-9 grid (shift clamped at 5)
    k = 20 + (121 - exp).clamp(0, 5)
    sig = man | (1 << 23)
    rem = sig & ((1 << k) - 1)
    half = 1 << (k - 1)
    keep_s = sig >> k
    sub = keep_s + ((rem > half)
                    | ((rem == half) & ((keep_s & 1) == 1))).to(torch.int32)
    byte = torch.where(a == 0, 0, torch.where(exp < 121, sub, norm))
    return (sign | byte).to(torch.uint8)


def _e4m3_to_f32(b: torch.Tensor) -> torch.Tensor:
    """Exact e4m3fn byte -> f32 (bit construction, no rounding)."""
    bi = b.to(torch.int32)
    s = bi >> 7
    f = (bi >> 3) & 0xF
    m = bi & 7
    norm = (((f + 120) << 23) | (m << 20)).view(torch.float32)
    sub = m.float() * 2.0 ** -9
    mag = torch.where(f == 0, sub, norm)
    return torch.where(s == 1, -mag, mag)


def quantize_blockwise_fp8(x: torch.Tensor):
    """Per-block e4m3fn: ``(q uint8 [b, ...], scale f32 [b, 1, ..])``,
    scale = absmax times the f32 reciprocal of 448; each byte the one of
    the encoded byte and its two neighbours whose reconstruction is
    nearest.  Error <= scale·16."""
    xf = x.float()
    scale = _recip_scale(_block_amax(xf), 1.0 / _E4M3_MAX)
    y = (xf / scale).clamp(-_E4M3_MAX, _E4M3_MAX)
    q0 = _f32_to_e4m3(y).to(torch.int32)
    sign = q0 & 0x80
    mag = q0 & 0x7F
    lo = (mag - 1).clamp(min=0)
    hi = (mag + 1).clamp(max=_E4M3_MAX_BYTE)

    def err(m):
        return (_e4m3_to_f32((sign | m).to(torch.uint8)) * scale - xf).abs()

    e_mid, e_lo, e_hi = err(mag), err(lo), err(hi)
    best = torch.where(e_lo < e_mid, lo, mag)
    best = torch.where(e_hi < torch.minimum(e_lo, e_mid), hi, best)
    return (sign | best).to(torch.uint8), scale


def dequantize_blockwise_fp8(q: torch.Tensor, scale: torch.Tensor,
                             dtype=torch.bfloat16) -> torch.Tensor:
    return (_e4m3_to_f32(q) * scale).to(dtype)
