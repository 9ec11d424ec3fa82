"""The K/V wire codecs of the port against the JAX package's.

- the device halves of the blockwise codecs (``vtpu_torch.ops.quant``:
  int8, int4 with its nibble packing, fp8 e4m3fn) give the same bytes
  and scales as the numpy twins of ``vtpu/serving/wirecodec.py`` and as
  ``vtpu.ops.quant``'s eager functions, over zeros, denormals (the
  1e-45 that tests/test_codec_props.py once drew), values at ±448, e4m3
  ties, an odd element count and f32, bf16 and int8 leaves;
- the port's copy of ``wirecodec`` gives the original's bytes;
- the port's copy of the transport's frame codec gives the original's
  frames, and decodes them, in both directions; refusals keep their
  class names;
- under ``jax.jit`` the JAX int8 scale is within one ulp of the port's
  (XLA folds ``/ 127`` into a reciprocal multiply);
- ``cuda``-marked: the card gives the CPU's bytes
  (``python -m pytest tests/test_torch_wire_codecs.py -m cuda
  --noconftest``).

Byte equality throughout: no tolerance.
"""

import numpy as np
import pytest
import torch

from vtpu.serving import transport as jtp
from vtpu.serving import wirecodec as jwc
from vtpu_torch.ops import quant as tq
from vtpu_torch.serving import transport as ttp
from vtpu_torch.serving import wirecodec as twc

CODECS = ("int8", "int4", "fp8")


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """f32 values that bf16 represents exactly."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _cases():
    rng = np.random.default_rng(0)
    ties = np.array([[0.5, 1.5, 2.5, 3.5, 17.0, 19.0, 240.0, 448.0]],
                    np.float32)  # e4m3 and grid midpoints
    sub = (2.0 ** -9) * np.array([[0.5, 1.5, 2.5, -0.5, 3.25, 448.0]],
                                 np.float32)
    return {
        "random_f32": ("float32", (rng.standard_normal((6, 4, 8, 8))
                                   * 3).astype(np.float32)),
        "zeros": ("float32", np.zeros((3, 2, 4, 4), np.float32)),
        "denormal_1e-45": ("float32", np.full((2, 3), 1e-45, np.float32)),
        "denormals_mixed": ("float32", np.array(
            [[1e-45, 0.0, -1e-45, 3e-40], [1e-38, -2e-39, 0.0, 5e-44]],
            np.float32)),
        "at_448": ("float32", np.array([[448.0, -448.0, 0.5, -0.0],
                                        [447.0, 449.0, -1e-3, 1.0]],
                                       np.float32)),
        "e4m3_ties": ("float32", np.concatenate([ties, -ties])),
        "e4m3_subnormal_ties": ("float32", sub),
        "odd_count": ("float32", (rng.standard_normal((5, 3, 7))
                                  * 10).astype(np.float32)),
        "wide_range": ("float32", (rng.standard_normal((4, 33))
                                   * np.logspace(-30, 30, 33)
                                   ).astype(np.float32)),
        "bf16_leaf": ("bfloat16", _bf16_values(
            (rng.standard_normal((5, 2, 8, 8)) * 4).astype(np.float32))),
        "int8_leaf": ("int8", rng.integers(-128, 128, (4, 2, 8, 8)
                                           ).astype(np.int8)),
        "int8_scale_leaf": ("float32", (rng.random((4, 2, 8, 1)) / 127
                                        ).astype(np.float32)),
    }


CASES = _cases()


def _torch_leaf(dtype: str, x: np.ndarray, device="cpu") -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    return t.to(device)


def _port(codec: str, t: torch.Tensor):
    """(wire bytes of q, scale f32 [b]) of the port's device half."""
    if codec == "int8":
        q, s = tq.quantize_blockwise(t)
    elif codec == "int4":
        q, s = tq.quantize_blockwise_int4(t)
        q = tq.pack_int4(q)
    else:
        q, s = tq.quantize_blockwise_fp8(t)
    return q.cpu().numpy(), s.reshape(-1).float().cpu().numpy()


def _twin(codec: str, x: np.ndarray):
    q, s = jwc.quantize_blocks_for(x.astype(np.float32)
                                   if x.dtype == np.int8 else x, codec)
    if codec == "int4":
        q = jwc.pack_int4_np(q)
    return q, np.asarray(s, np.float32).reshape(-1)


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_half_equals_numpy_twin(case, codec):
    dtype, x = CASES[case]
    with np.errstate(all="ignore"):
        q, s = _port(codec, _torch_leaf(dtype, x))
        qn, sn = _twin(codec, x)
    assert _same_bits(q, qn)
    assert _same_bits(s, sn)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dequantize_equals_numpy_twin(case, codec):
    """The receiver's half: dequantized f32 bit for bit."""
    dtype, x = CASES[case]
    t = _torch_leaf(dtype, x)
    with np.errstate(all="ignore"):
        if codec == "fp8":
            q, s = tq.quantize_blockwise_fp8(t)
            got = tq.dequantize_blockwise_fp8(q, s, torch.float32)
            qn, sn = jwc.quantize_blocks_fp8_np(x.astype(np.float32))
        elif codec == "int4":
            q, s = tq.quantize_blockwise_int4(t)
            got = tq.dequantize_blockwise(q, s, torch.float32)
            qn, sn = jwc.quantize_blocks_int4_np(x.astype(np.float32))
        else:
            q, s = tq.quantize_blockwise(t)
            got = tq.dequantize_blockwise(q, s, torch.float32)
            qn, sn = jwc.quantize_blocks_np(x.astype(np.float32))
        want = jwc.dequantize_blocks_for(qn, sn, np.float32, codec)
    assert _same_bits(got.numpy(), want)


@pytest.fixture(scope="module")
def jq():
    """The JAX package's quant module (imported by the CPU tests only)."""
    from vtpu.ops import quant

    return quant


def _jax(jq, codec: str, dtype: str, x: np.ndarray):
    import jax.numpy as jnp

    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        jx = jx.astype(jnp.bfloat16)
    fn = {"int8": jq.quantize_blockwise, "int4": jq.quantize_blockwise_int4,
          "fp8": jq.quantize_blockwise_fp8}[codec]
    q, s = fn(jx)
    if codec == "int4":
        q = jq.pack_int4(q)
    return np.asarray(q), np.asarray(s, np.float32).reshape(-1)


def _flush_subnormals(x: np.ndarray) -> np.ndarray:
    """What XLA's CPU backend reads for ``x``: subnormal f32
    inputs as signed zeros."""
    if x.dtype != np.float32:
        return x
    return np.where(np.abs(x) < np.float32(2.0 ** -126),
                    np.copysign(np.float32(0), x), x).astype(np.float32)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_half_equals_eager_jax(jq, case, codec):
    """XLA flushes subnormal inputs to zero, the numpy twin does not: the
    eager JAX function equals the port on the flushed input (which is the
    input itself in every case without subnormals)."""
    dtype, x = CASES[case]
    qj, sj = _jax(jq, codec, dtype, x)
    with np.errstate(all="ignore"):
        q, s = _port(codec, _torch_leaf(dtype, _flush_subnormals(x)))
    assert _same_bits(q, qj)
    assert _same_bits(s, sj)


@pytest.mark.parametrize("case", ["denormal_1e-45", "denormals_mixed"])
def test_subnormal_blocks_follow_the_numpy_twin_not_xla(jq, case):
    """The int8 codec on a block whose absmax is subnormal: absmax / 127
    underflows to a zero scale in IEEE arithmetic, so the twin (and the
    port, byte for byte) saturate the block at ±127, while XLA reads the
    block as zeros (scale 1, levels 0).  The wire's bytes are the
    twin's; the int4 and fp8 scales floor at 2^-126 and agree."""
    dtype, x = CASES[case]
    with np.errstate(all="ignore"):
        q, s = _port("int8", _torch_leaf(dtype, x))
        qn, sn = _twin("int8", x)
    qj, sj = _jax(jq, "int8", dtype, x)
    assert _same_bits(q, qn) and _same_bits(s, sn)
    assert not _same_bits(s, sj)
    for codec in ("int4", "fp8"):
        with np.errstate(all="ignore"):
            assert _same_bits(_port(codec, _torch_leaf(dtype, x))[1],
                              _jax(jq, codec, dtype, x)[1])


def test_e4m3_decode_every_byte(jq):
    b = np.arange(256, dtype=np.uint8)
    got = tq._e4m3_to_f32(torch.from_numpy(b)).numpy()
    assert _same_bits(got, jwc._e4m3_to_f32_np(b))
    assert _same_bits(got, np.asarray(jq._e4m3_to_f32(b), np.float32))


def test_e4m3_encode_sweep_and_ties():
    """Every e4m3 level, the midpoints between neighbours (ties to even)
    and a log sweep, in [-448, 448]."""
    levels = jwc._e4m3_to_f32_np(np.arange(0x7F, dtype=np.uint8))
    mids = (levels[:-1] + levels[1:]) / 2
    sweep = np.logspace(-12, np.log10(448), 4001).astype(np.float32)
    y = np.concatenate([levels, mids, sweep]).astype(np.float32)
    y = np.clip(np.concatenate([y, -y]), -448, 448)
    got = tq._f32_to_e4m3(torch.from_numpy(y)).numpy()
    assert _same_bits(got, jwc._f32_to_e4m3_np(y))


def test_pack_int4_odd_count_round_trips():
    rng = np.random.default_rng(1)
    q = rng.integers(-7, 8, (3, 5, 3)).astype(np.int8)  # 15 a row: odd
    packed = tq.pack_int4(torch.from_numpy(q)).numpy()
    assert _same_bits(packed, jwc.pack_int4_np(q))
    assert packed.shape == (3, 8)
    assert _same_bits(twc.unpack_int4_np(packed, 15), q.reshape(3, 15))


def test_jitted_jax_int8_scale_within_one_ulp(jq):
    """The JAX sender quantizes inside ``jax.jit``, where XLA folds the
    ``/ 127`` into a reciprocal multiply: its scales sit within one ulp
    of the port's IEEE division (which equals the eager JAX function and
    the numpy twin), and its levels within one of the port's."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4096, 64)) * rng.uniform(
        0.01, 100, (4096, 1))).astype(np.float32)
    qj, sj = jax.jit(jq.quantize_blockwise)(jnp.asarray(x))
    q, s = tq.quantize_blockwise(torch.from_numpy(x))
    sj = np.asarray(sj).reshape(-1)
    sp = s.numpy().reshape(-1)
    ulps = np.abs(sj.view(np.int32).astype(np.int64)
                  - sp.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert np.abs(np.asarray(qj, np.int32) - q.numpy().astype(np.int32)
                  ).max() <= 1
    qe, se = jq.quantize_blockwise(jnp.asarray(x))  # eager: exact
    assert _same_bits(np.asarray(se).reshape(-1), sp)


@pytest.mark.parametrize("codec", ("fp32",) + CODECS)
def test_extract_payload_is_the_wire_layout(codec):
    """The extract (gather, codec, pack) over leaves of three shapes and
    dtypes (the groups the quantized gathers stack) gives the wirecodec
    chunk layout of the numpy twins, for any block range."""
    from vtpu_torch.serving import disagg

    rng = np.random.default_rng(9)
    leaves = [torch.from_numpy((rng.standard_normal((9, 2, 4, 8)) * 5
                                ).astype(np.float32)),
              torch.from_numpy(rng.integers(-127, 128, (9, 2, 4, 8)
                                            ).astype(np.int8)),
              torch.from_numpy(rng.random((9, 2, 4, 1), np.float32)),
              torch.from_numpy((rng.standard_normal((9, 2, 4, 8)) * 0.1
                                ).astype(np.float32)),
              torch.from_numpy(rng.random((9, 2, 4, 1), np.float32) * 3)]
    blocks = [4, 1, 7, 8, 2]
    ex = disagg._extract_blocks(leaves, blocks, codec,
                                disagg._make_wire_gathers())
    assert ex.ready_blocks() == 5
    for lo, hi in ((0, 5), (1, 3), (4, 5)):
        want = []
        for t in leaves:
            rows = t.numpy()[blocks[lo:hi]]
            if codec == "fp32":
                want.append(rows.tobytes())
                continue
            q, sc = jwc.quantize_blocks_for(rows.astype(np.float32), codec)
            if codec == "int4":
                q = jwc.pack_int4_np(q)
            want.append(np.asarray(sc, "<f4").tobytes() + q.tobytes())
        assert ex.payload(lo, hi) == b"".join(want)


# -- the wirecodec copy -------------------------------------------------------
PER_LEAF = [(2 * 8 * 8, (2, 8, 8), np.dtype(np.float32)),
            (2 * 8 * 1, (2, 8, 1), np.dtype(np.float32)),
            (3 * 5, (3, 5), np.dtype(np.int8))]


def _quant_payload(codec: str, nblocks: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    for n, shape, _dt in PER_LEAF:
        x = rng.standard_normal((nblocks,) + shape).astype(np.float32)
        q, s = jwc.quantize_blocks_for(x, codec)
        if codec == "int4":
            q = jwc.pack_int4_np(q)
        parts.append(np.asarray(s, "<f4").tobytes() + q.tobytes())
    return b"".join(parts)


@pytest.mark.parametrize("codec", CODECS)
def test_wirecodec_copy_parses_like_the_original(codec):
    payload = _quant_payload(codec, 3, seed=len(codec))
    a = jwc.split_payload(payload, PER_LEAF, 3, codec)
    b = twc.split_payload(payload, PER_LEAF, 3, codec)
    assert len(a) == len(b)
    for (sa, qa), (sb, qb) in zip(a, b):
        assert _same_bits(sa, sb) and _same_bits(qa, qb)
    assert (twc.block_bytes(PER_LEAF, codec)
            == jwc.block_bytes(PER_LEAF, codec))
    with pytest.raises(ValueError):
        twc.split_payload(payload[:-1], PER_LEAF, 3, codec)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wirecodec_copy_quantizers_equal_the_original(case):
    _dtype, x = CASES[case]
    xf = x.astype(np.float32)
    with np.errstate(all="ignore"):
        for codec in CODECS:
            qa, sa = jwc.quantize_blocks_for(xf, codec)
            qb, sb = twc.quantize_blocks_for(xf, codec)
            assert _same_bits(qa, qb) and _same_bits(sa, sb)
            da = jwc.dequantize_blocks_for(qa, sa, np.float32, codec)
            db = twc.dequantize_blocks_for(qb, sb, np.float32, codec)
            assert _same_bits(da, db)


def test_wirecodec_copy_constants_and_helpers():
    for name in ("CODEC_FP32", "CODEC_INT8", "CODEC_FP8", "CODEC_INT4",
                 "SUPPORTED", "QUANT_CODECS", "_E4M3_MAX", "_E4M3_MAX_BYTE"):
        assert getattr(twc, name) == getattr(jwc, name), name
    for adv in ("fp32", "int8", "fp8", "int4", "bogus"):
        for sup in (("fp32",), jwc.SUPPORTED, ("fp32", "int8")):
            assert twc.negotiate(adv, sup) == jwc.negotiate(adv, sup)
    for codec in ("fp32",) + CODECS:
        assert (twc.block_bytes(PER_LEAF, codec)
                == jwc.block_bytes(PER_LEAF, codec))
        assert twc.error_bound(0.25, codec) == jwc.error_bound(0.25, codec)
    assert (twc.fp32_block_bytes(PER_LEAF) == jwc.fp32_block_bytes(PER_LEAF)
            and twc.quant_block_bytes(PER_LEAF)
            == jwc.quant_block_bytes(PER_LEAF))


def test_wire_codec_env_read_through_the_port(monkeypatch):
    import importlib

    monkeypatch.setenv("VTPU_KV_WIRE_CODEC", "int4")
    try:
        assert importlib.reload(twc).DEFAULT_CODEC == "int4"
    finally:
        monkeypatch.delenv("VTPU_KV_WIRE_CODEC")
        importlib.reload(twc)
    assert twc.DEFAULT_CODEC == "fp32"


# -- the transport copy's frames ---------------------------------------------
SID = bytes(range(16))
FRAMES = {
    "open": dict(kind=0, seq=0, nchunks=3,
                 meta={"rid": "r0", "handle": {"pool": "p", "blocks": [1, 2],
                                               "seq_len": 9, "stamp": 4},
                       "layout": [{"shape": [2, 8, 8],
                                   "dtype": "bfloat16"}],
                       "chunk_blocks": 2, "codec": "int8"}),
    "data": dict(kind=0, seq=1, nchunks=3, block_off=0, nblocks=2,
                 payload=bytes(range(200))),
    "quant_fin": dict(kind=5, seq=3, nchunks=3, block_off=4, nblocks=1,
                      flags=1, payload=b"\x01\x02" * 33),
    "fp8": dict(kind=6, seq=2, nchunks=3, block_off=2, nblocks=2,
                payload=b"\xfe" * 17),
    "int4": dict(kind=7, seq=2, nchunks=4, block_off=2, nblocks=2,
                 payload=b"\x7f" * 9),
    "resume": dict(kind=1),
    "abort": dict(kind=2),
    "stats": dict(kind=3),
    "ping": dict(kind=4),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_byte_identical_both_directions(name):
    kw = dict(FRAMES[name])
    kind = kw.pop("kind")
    a = jtp.encode_frame(kind, SID, **kw)
    b = ttp.encode_frame(kind, SID, **kw)
    assert a == b
    for data, decode in ((a, ttp.decode_frame), (b, jtp.decode_frame)):
        fr = decode(data)
        assert (fr.kind, fr.sid, fr.seq, fr.nchunks, fr.block_off,
                fr.nblocks, fr.flags) == (
            kind, SID, kw.get("seq", 0), kw.get("nchunks", 0),
            kw.get("block_off", 0), kw.get("nblocks", 0),
            kw.get("flags", 0))
        assert fr.meta == kw.get("meta") and fr.payload == kw.get(
            "payload", b"")


def test_frame_constants_match():
    for name in ("MAGIC", "VERSION", "KIND_DATA", "KIND_RESUME",
                 "KIND_ABORT", "KIND_STATS", "KIND_PING", "KIND_DATA_QUANT",
                 "KIND_DATA_FP8", "KIND_DATA_INT4", "FLAG_FIN",
                 "KIND_FOR_CODEC", "DEFAULT_CHUNK_BLOCKS"):
        assert getattr(ttp, name) == getattr(jtp, name), name
    assert ttp._HDR.format == jtp._HDR.format


@pytest.mark.parametrize("damage", ["truncated", "crc", "version", "magic"])
def test_damaged_frames_refused_by_the_same_class_name(damage):
    good = ttp.encode_frame(0, SID, seq=1, nchunks=1, nblocks=1,
                            payload=b"abcd")
    bad = {"truncated": good[:-1],
           "crc": good[:-1] + b"x",
           "version": good[:4] + b"\x09\x00" + good[6:],
           "magic": b"XXXX" + good[4:]}[damage]
    names = []
    for decode in (ttp.decode_frame, jtp.decode_frame):
        with pytest.raises(Exception) as ei:
            decode(bad)
        names.append(type(ei.value).__name__)
    assert names[0] == names[1] != "Exception"


def test_error_types_by_name_round_trip():
    """The wire's error names are the JAX package's; the port's table
    adds the session mover's (vtpu_torch/serving/migrate.py), which the
    JAX table does not carry."""
    from vtpu_torch.serving import migrate

    moves = {"MigrationError", "SessionGoneError", "NoMigrationTargetError",
             "MigrationAmbiguousError"}
    assert sorted(set(ttp._ERROR_TYPES) - moves) == sorted(jtp._ERROR_TYPES)
    for name in jtp._ERROR_TYPES:
        doc = {"status": "error", "error": name, "detail": "x"}
        caught = []
        for mod in (ttp, jtp):
            with pytest.raises(Exception) as ei:
                mod.raise_wire_error(doc)
            caught.append(type(ei.value).__name__)
        assert caught == [name, name]
    for name in moves:
        with pytest.raises(migrate.MigrationError) as ei:
            ttp.raise_wire_error({"status": "error", "error": name,
                                  "detail": "x"})
        assert type(ei.value).__name__ == name


# -- on the card -------------------------------------------------------------
@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_bytes_equal_cpu_bytes(cuda_card, case, codec):
    dtype, x = CASES[case]
    q_cpu, s_cpu = _port(codec, _torch_leaf(dtype, x))
    q_gpu, s_gpu = _port(codec, _torch_leaf(dtype, x, cuda_card))
    assert _same_bits(q_gpu, q_cpu) and _same_bits(s_gpu, s_cpu)
