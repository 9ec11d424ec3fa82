"""Wire-chunk codecs for the K/V transport: the port's copy of
``vtpu/serving/wirecodec.py`` (the port imports nothing of vtpu), with
the same bytes for the same input.

- ``fp32`` (``KIND_DATA``): the blocks' raw bytes per cache leaf, in the
  pool's leaf order -- token-exact by construction.  The default
  (``VTPU_KV_WIRE_CODEC=fp32``).
- ``int8`` (``KIND_DATA_QUANT``): per-block symmetric int8, one f32
  scale per (block, leaf); payload per leaf ``f32-LE scales [nblocks] ‖
  int8 [nblocks × n_elem]``.  Error <= ``scale/2``.
- ``fp8`` (``KIND_DATA_FP8``): per-block-scaled e4m3fn (``scale =
  absmax/448``), each element the byte whose reconstruction is nearest,
  in integer arithmetic; payload ``scales ‖ u8 e4m3``.  Error <=
  ``scale·16``.
- ``int4`` (``KIND_DATA_INT4``): per-block ±7 grid, two elements a byte
  (low nibble = even index, odd counts padded); payload ``scales ‖
  packed nibbles [nblocks × ceil(n_elem/2)]``.  Error <= ``scale/2``.

The sender advertises a codec in the OPEN meta and the receiver answers
with the one it accepted (:func:`negotiate`: the advertised codec if its
sink supports it, else ``fp32``); the codec is fixed for the stream.
The device halves are ``vtpu_torch/ops/quant.py``'s blockwise codecs,
behind ``PrefillEngine.start_extract(codec=...)`` and the decode
engine's dequantizing scatter (``vtpu_torch/serving/disagg.py``); this
module is numpy only.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from vtpu_torch.utils.envs import env_str

CODEC_FP32 = "fp32"
CODEC_INT8 = "int8"
CODEC_FP8 = "fp8"
CODEC_INT4 = "int4"
SUPPORTED = (CODEC_FP32, CODEC_INT8, CODEC_FP8, CODEC_INT4)
# the codecs whose chunks carry per-(block, leaf) scales + quantized
# payload (everything but raw fp32)
QUANT_CODECS = (CODEC_INT8, CODEC_FP8, CODEC_INT4)

# the sender-side default advertisement (fp32 stays the token-exact
# default; int8 opts into the quantized chunk kind)
DEFAULT_CODEC = env_str("VTPU_KV_WIRE_CODEC", CODEC_FP32)

_SCALE_DTYPE = np.dtype("<f4")


def negotiate(advertised: str, supported: Sequence[str]) -> str:
    """The receiver's half of the OPEN handshake: accept the advertised
    codec when the sink supports it, else fall back to fp32 (always
    supported — the original wire format)."""
    if advertised in supported and advertised in SUPPORTED:
        return advertised
    return CODEC_FP32


def fp32_block_bytes(per_leaf: Sequence[Tuple[int, tuple, np.dtype]]) -> int:
    """Raw-payload bytes of ONE block: per-leaf element count × leaf
    itemsize (``per_leaf`` rows are ``(n_elem, shape, dtype)``)."""
    return sum(n * np.dtype(dt).itemsize for n, _sh, dt in per_leaf)


def quant_block_bytes(per_leaf: Sequence[Tuple[int, tuple, np.dtype]]) -> int:
    """int8-payload bytes of ONE block: one int8 per element plus one
    f32 scale per (block, leaf)."""
    return sum(n + _SCALE_DTYPE.itemsize for n, _sh, _dt in per_leaf)


def block_bytes(per_leaf: Sequence[Tuple[int, tuple, np.dtype]],
                codec: str) -> int:
    """Payload bytes of ONE block under ``codec``: fp32 = raw leaf
    bytes; int8/fp8 = one byte per element; int4 = one nibble per
    element (odd leaf counts pad one nibble); each quantized codec adds
    one f32 scale per (block, leaf)."""
    if codec == CODEC_FP32:
        return fp32_block_bytes(per_leaf)
    if codec in (CODEC_INT8, CODEC_FP8):
        return quant_block_bytes(per_leaf)
    if codec == CODEC_INT4:
        return sum((n + 1) // 2 + _SCALE_DTYPE.itemsize
                   for n, _sh, _dt in per_leaf)
    raise ValueError(f"unknown codec {codec!r}")


def split_quant_payload(
    buf, per_leaf: Sequence[Tuple[int, tuple, np.dtype]], nblocks: int
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Parse one ``KIND_DATA_QUANT`` chunk payload into per-leaf
    ``(scales f32 [nblocks], q int8 [nblocks, *leaf shape])`` pairs.

    Validation is exact and typed: a payload whose total length
    mismatches — including a truncated *scale* segment — raises
    ``ValueError`` naming the segment, which the receiver hub maps to
    the stream-aborting ``TruncatedChunkError``."""
    buf = memoryview(buf)
    expect = nblocks * quant_block_bytes(per_leaf)
    if len(buf) != expect:
        raise ValueError(
            f"quant chunk payload {len(buf)} bytes != expected {expect} "
            f"(truncated scale or data segment)"
        )
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    off = 0
    for n_elem, shape, _dt in per_leaf:
        sb = nblocks * _SCALE_DTYPE.itemsize
        if off + sb > len(buf):
            raise ValueError("truncated scale segment in quant chunk")
        scales = np.frombuffer(buf[off:off + sb], dtype=_SCALE_DTYPE)
        off += sb
        qb = nblocks * n_elem
        q = np.frombuffer(buf[off:off + qb], dtype=np.int8)
        q = q.reshape((nblocks,) + tuple(shape))
        off += qb
        out.append((scales, q))
    return out


def split_payload(
    buf, per_leaf: Sequence[Tuple[int, tuple, np.dtype]], nblocks: int,
    codec: str,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Parse one quantized chunk payload under any of ``QUANT_CODECS``
    into per-leaf ``(scales f32 [nblocks], q [nblocks, *leaf shape])``
    pairs — ``q`` is int8 for int8/int4 (nibbles sign-extended back to
    the ±7 grid) and the raw e4m3 uint8 bytes for fp8.  Same exact,
    typed length validation as :func:`split_quant_payload`."""
    if codec == CODEC_INT8:
        return split_quant_payload(buf, per_leaf, nblocks)
    if codec not in (CODEC_FP8, CODEC_INT4):
        raise ValueError(f"codec {codec!r} has no quantized payload")
    buf = memoryview(buf)
    expect = nblocks * block_bytes(per_leaf, codec)
    if len(buf) != expect:
        raise ValueError(
            f"{codec} chunk payload {len(buf)} bytes != expected {expect} "
            f"(truncated scale or data segment)"
        )
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    off = 0
    for n_elem, shape, _dt in per_leaf:
        sb = nblocks * _SCALE_DTYPE.itemsize
        if off + sb > len(buf):
            raise ValueError(f"truncated scale segment in {codec} chunk")
        scales = np.frombuffer(buf[off:off + sb], dtype=_SCALE_DTYPE)
        off += sb
        if codec == CODEC_FP8:
            qb = nblocks * n_elem
            q = np.frombuffer(buf[off:off + qb], dtype=np.uint8)
            q = q.reshape((nblocks,) + tuple(shape))
        else:
            qb = nblocks * ((n_elem + 1) // 2)
            packed = np.frombuffer(buf[off:off + qb], dtype=np.uint8)
            q = unpack_int4_np(
                packed.reshape(nblocks, (n_elem + 1) // 2), n_elem
            ).reshape((nblocks,) + tuple(shape))
        off += qb
        out.append((scales, q))
    return out


def pack_int4_np(q: np.ndarray) -> np.ndarray:
    """Numpy twin of ``vtpu_torch.ops.quant.pack_int4``: int4-valued int8
    ``[b, ...]`` → nibble-packed uint8 ``[b, ceil(n/2)]`` (low nibble =
    even flat index), bit-identical to the device half."""
    b = q.shape[0]
    flat = q.reshape(b, -1)
    n = flat.shape[1]
    if n % 2:
        flat = np.pad(flat, ((0, 0), (0, 1)))
    u = (flat & 0x0F).astype(np.uint8)
    return u[:, 0::2] | (u[:, 1::2] << 4)


def unpack_int4_np(packed: np.ndarray, n_elem: int) -> np.ndarray:
    """Inverse of :func:`pack_int4_np`: uint8 ``[b, ceil(n/2)]`` →
    sign-extended int8 ``[b, n_elem]`` on the ±7 grid."""
    lo = packed & 0x0F
    hi = packed >> 4
    u = np.stack([lo, hi], axis=-1).reshape(packed.shape[0], -1)[:, :n_elem]
    q = u.astype(np.int8)
    return np.where(q > 7, q - 16, q).astype(np.int8)


def quantize_blocks_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side twin of ``vtpu_torch.ops.quant.quantize_blockwise`` (numpy,
    for fakes/tests and host-resident extracts): one f32 scale per
    leading-axis slice, absmax over the rest."""
    xf = x.astype(np.float32)
    axes = tuple(range(1, x.ndim))
    amax = np.max(np.abs(xf), axis=axes) if axes else np.abs(xf)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    bshape = (x.shape[0],) + (1,) * (x.ndim - 1)
    s = scale.reshape(bshape)
    # nearest-RECONSTRUCTION level, bit-identical to the device twin
    # (vtpu_torch.ops.quant._nearest_int): round(xf/s) can land on a
    # division-rounded .5 tie and breach the scale/2 bound by an ulp
    lo = np.floor(xf / s)
    hi = lo + 1.0
    q = np.clip(np.where(np.abs(hi * s - xf) < np.abs(lo * s - xf),
                         hi, lo), -127, 127)
    return q.astype(np.int8), scale


def dequantize_blocks_np(q: np.ndarray, scale: np.ndarray,
                         dtype) -> np.ndarray:
    bshape = (q.shape[0],) + (1,) * (q.ndim - 1)
    return (q.astype(np.float32)
            * scale.reshape(bshape).astype(np.float32)).astype(dtype)


def quantize_blocks_int4_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side twin of ``vtpu_torch.ops.quant.quantize_blockwise_int4``:
    per-block symmetric int4 (``q in [-7, 7]``, UNPACKED int8), one f32
    scale per block, reconstruction-nearest — bit-identical to the device
    half."""
    xf = x.astype(np.float32)
    axes = tuple(range(1, x.ndim))
    amax = np.max(np.abs(xf), axis=axes) if axes else np.abs(xf)
    # reciprocal-multiply + product-side zero guard, op-identical to
    # the device half (XLA's constant-divisor fold is a reciprocal
    # multiply that can sit one ulp off IEEE division)
    s0 = (amax.astype(np.float32) * np.float32(1.0 / 7.0)).astype(np.float32)
    scale = np.where(s0 >= np.float32(2.0 ** -126), s0,
                     np.float32(1.0)).astype(np.float32)
    s = scale.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    lo = np.floor(xf / s)
    hi = lo + 1.0
    q = np.clip(np.where(np.abs(hi * s - xf) < np.abs(lo * s - xf),
                         hi, lo), -7, 7)
    return q.astype(np.int8), scale


_E4M3_MAX = 448.0
_E4M3_MAX_BYTE = 0x7E


def _f32_to_e4m3_np(y: np.ndarray) -> np.ndarray:
    """Numpy twin of ``vtpu_torch.ops.quant._f32_to_e4m3`` — the same
    integer/bitcast arithmetic op for op, so the halves are
    bit-identical on every backend (XLA's native f8 convert
    double-rounds through f16 on some backends and cannot be)."""
    u = y.astype(np.float32).view(np.int32)
    sign = np.where(u < 0, np.int32(0x80), np.int32(0))
    a = u & 0x7FFFFFFF
    exp = a >> 23
    man = a & 0x7FFFFF
    keep = man >> 20
    rest = man & 0xFFFFF
    carry = ((rest > 0x80000)
             | ((rest == 0x80000) & ((keep & 1) == 1))).astype(np.int32)
    m = keep + carry
    exp2 = np.where(m == 8, exp + 1, exp)
    m2 = np.where(m == 8, 0, m)
    norm = ((exp2 - 120) << 3) | m2
    norm = np.where((exp2 > 135) | ((exp2 == 135) & (m2 == 7)),
                    _E4M3_MAX_BYTE, norm)
    shift = np.clip(121 - exp, 0, 5)
    k = 20 + shift
    sig = man | (1 << 23)
    rem = sig & ((1 << k) - 1)
    half = 1 << (k - 1)
    keep_s = sig >> k
    sub = keep_s + ((rem > half)
                    | ((rem == half) & ((keep_s & 1) == 1))).astype(np.int32)
    byte = np.where(a == 0, 0, np.where(exp < 121, sub, norm))
    return (sign | byte).astype(np.uint8)


def _e4m3_to_f32_np(b: np.ndarray) -> np.ndarray:
    bi = b.astype(np.int32)
    s = bi >> 7
    f = (bi >> 3) & 0xF
    m = bi & 7
    norm = (((f + 120) << 23) | (m << 20)).astype(np.int32).view(np.float32)
    sub = m.astype(np.float32) * np.float32(2.0 ** -9)
    mag = np.where(f == 0, sub, norm)
    return np.where(s == 1, -mag, mag).astype(np.float32)


def quantize_blocks_fp8_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side twin of ``vtpu_torch.ops.quant.quantize_blockwise_fp8``:
    per-block e4m3fn bytes (``scale = absmax/448``),
    reconstruction-nearest over the encoded byte and its two monotone
    neighbours — bit-identical to the device half."""
    xf = x.astype(np.float32)
    axes = tuple(range(1, x.ndim))
    amax = np.max(np.abs(xf), axis=axes) if axes else np.abs(xf)
    # reciprocal-multiply + product-side zero guard, op-identical to
    # the device half (see quantize_blocks_int4_np)
    s0 = (amax.astype(np.float32)
          * np.float32(1.0 / _E4M3_MAX)).astype(np.float32)
    scale = np.where(s0 >= np.float32(2.0 ** -126), s0,
                     np.float32(1.0)).astype(np.float32)
    s = scale.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    y = np.clip(xf / s, -_E4M3_MAX, _E4M3_MAX)
    q0 = _f32_to_e4m3_np(y).astype(np.int32)
    sign = q0 & 0x80
    mag = q0 & 0x7F
    lo = np.maximum(mag - 1, 0)
    hi = np.minimum(mag + 1, _E4M3_MAX_BYTE)
    err = np.abs(_e4m3_to_f32_np((sign | mag).astype(np.uint8)) * s - xf)
    e_lo = np.abs(_e4m3_to_f32_np((sign | lo).astype(np.uint8)) * s - xf)
    e_hi = np.abs(_e4m3_to_f32_np((sign | hi).astype(np.uint8)) * s - xf)
    best = np.where(e_lo < err, lo, mag)
    berr = np.minimum(e_lo, err)
    best = np.where(e_hi < berr, hi, best)
    return (sign | best).astype(np.uint8), scale


def dequantize_blocks_fp8_np(q: np.ndarray, scale: np.ndarray,
                             dtype) -> np.ndarray:
    bshape = (q.shape[0],) + (1,) * (q.ndim - 1)
    return (_e4m3_to_f32_np(q)
            * scale.reshape(bshape).astype(np.float32)).astype(dtype)


def quantize_blocks_for(x: np.ndarray, codec: str):
    """Dispatch the numpy quantize twin for ``codec``."""
    if codec == CODEC_INT8:
        return quantize_blocks_np(x)
    if codec == CODEC_INT4:
        return quantize_blocks_int4_np(x)
    if codec == CODEC_FP8:
        return quantize_blocks_fp8_np(x)
    raise ValueError(f"codec {codec!r} has no quantize twin")


def dequantize_blocks_for(q: np.ndarray, scale: np.ndarray, dtype,
                          codec: str) -> np.ndarray:
    """Dispatch the numpy dequantize twin for ``codec`` (int4 arrives
    here already unpacked to the int8 ±7 grid — see
    :func:`split_payload`)."""
    if codec in (CODEC_INT8, CODEC_INT4):
        return dequantize_blocks_np(q, scale, dtype)
    if codec == CODEC_FP8:
        return dequantize_blocks_fp8_np(q, scale, dtype)
    raise ValueError(f"codec {codec!r} has no dequantize twin")


def error_bound(max_scale: float, codec: str = CODEC_INT8) -> float:
    """The documented per-element reconstruction bound for a stream's
    largest applied block scale — the receiver tracks the running max
    (``DecodeEngine.wire_quant_max_scale``) and the chip smoke reports
    this of it.  int8/int4: ``scale/2`` (uniform grid, reconstruction-
    nearest).  fp8: ``scale * 16`` — half the widest e4m3 level gap
    (32, in the top binade [256, 448]); relative error is far tighter
    for small elements, which is the codec's point."""
    if codec == CODEC_FP8:
        return float(max_scale) * 16.0
    return float(max_scale) / 2.0
