"""The f32 flash backward, which runs on the tensor cores as
error-compensated 3xTF32 (``flash_dq_tf32x3`` and ``flash_dkv_tf32x3`` at
hd <= 128, ``flash_dq_split_tf32x3`` and ``flash_dkv_split_tf32x3``
above, in ``csrc/flash_attention_tf32x3.cu``), held on the CPU.

(a) ``cvt.rna.tf32.f32`` emulated in torch: round to nearest with ties
away from zero, to 10 mantissa bits, on hand-picked bit patterns (a tie,
a carry into the exponent, a subnormal, +-inf, NaN); the kernels round
hi this way (with integer arithmetic that gives the same bits), and the
split x = hi + lo rebuilds every operand to 2^-21.

(b) The kernels' products emulated: every one of Q K^T, dO V^T, dS K,
P^T dO and dS^T Q as lo_a hi_b + hi_a lo_b + hi_a hi_b, with hi the
cvt.rna rounding of (a) and lo = x - hi read by the tensor core as
TF32 rounded toward zero, each sum in f32;
p and dS formed in f32 between them.  Above hd 128 as the wide kernels
take it: S and dP (S^T and dP^T) as one share a 128-column group of the
head dim, the shares added in group order, and dq, dk and dv summed a
flush period at a time (1024 keys for dq; 1024 rows of the group's query
heads, one head after another, for dk and dv), each period's product
added to the output in f32.  At these sizes a block's sums fit in one
period (the card test crosses periods at s 1100).  dq, dk and dv must lie within 1e-4
of each output's largest value (the limit the card holds the kernels
to) of the JAX package's Pallas backward, which runs in interpret mode
(``jat.flash_attention`` through ``jax.vjp`` at s 128 and 256, a
multiple of its 128-row blocks; shift -1 through ``_flash_2d`` and
``_flash_bwd_2d``, which the public function does not expose; g 4
through ``flash_attention_gqa(use_kernel=True)``).  lse and delta for
the emulation come from the port's plain forward.

(c) One TF32 product (both operands rounded once) misses that limit at
the same seeds: the record of why the kernels take three.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.ops import attention as jat
from vtpu_torch.ops import _build
from vtpu_torch.ops import attention as tat

TOL = 1e-4  # of each output's largest |value|


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- (a) the rounding -------------------------------------------------------
def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of an f32 tensor: the low 13 mantissa bits
    rounded off, ties away from zero (adding half an ulp to the
    magnitude's bits carries into the exponent where it must); NaN stays
    NaN."""
    bits = x.view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def tf32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """The kernels' split: hi = tf32(x); lo = x - hi (exact in f32), which
    the tensor core reads as tf32 rounded toward zero."""
    hi = tf32(x)
    return hi, tf32_toward_zero(x - hi)


def _f32(bits: int) -> torch.Tensor:
    return torch.from_numpy(np.array([bits], np.uint32).view(np.float32))


def _bits(x: torch.Tensor) -> int:
    return int(x.numpy().view(np.uint32)[0])


@pytest.mark.parametrize("x, want", [
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero
    (0xBF801000, 0xBF802000),  # the same tie below zero
    (0x3F800FFF, 0x3F800000),  # just below the tie: down
    (0x3F803000, 0x3F804000),  # a tie from an odd last bit: still up
    (0x3FFFF000, 0x40000000),  # 2 - 2^-11, a tie that carries into 2^1
    (0x00001000, 0x00002000),  # a subnormal tie: kept, rounded up
    (0x00000FFF, 0x00000000),  # a subnormal below half an ulp: 0
    (0x7F800000, 0x7F800000),  # +inf
    (0xFF800000, 0xFF800000),  # -inf
], ids=["tie", "neg-tie", "below-tie", "odd-tie", "carry", "subnormal-tie",
        "subnormal-down", "inf", "neg-inf"])
def test_tf32_rounding_of_hand_picked_bit_patterns(x, want):
    assert _bits(tf32(_f32(x))) == want


@pytest.mark.parametrize("x", [0x7FC00000, 0x7F800001, 0xFFFFFFFF],
                         ids=["quiet", "low-payload", "all-ones"])
def test_tf32_rounding_keeps_nan(x):
    """A NaN whose payload lies in the rounded-off bits would become inf
    under the bit arithmetic alone."""
    assert torch.isnan(tf32(_f32(x))).all()


def test_the_split_rebuilds_each_operand_to_two_to_the_minus_21():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-30, 30, 4096))
                         .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):  # both are TF32 values: 13 low bits zero
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    # x - hi is exact in f32 and at most half a TF32 ulp of x; lo keeps
    # its top 11 bits
    assert torch.equal((x - hi).double(), x.double() - hi.double())
    assert bool(((x - hi).double().abs()
                 <= 2.0 ** -11 * x.double().abs()).all())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err < 2.0 ** -21 * x.double().abs()).all())


# -- (b) the products, against the JAX package's Pallas backward ----------
def mm3(a, b):
    """a @ b as the kernels take it: lo_a hi_b + hi_a lo_b + hi_a hi_b."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b as one TF32 product: both operands rounded once."""
    return tf32(a) @ tf32(b)


WIDE_C = 128   # columns of a group above hd 128 (the kernels' kWideC)
FLUSH = 1024   # keys (dq) or rows (dk, dv) the wide kernels sum a period


def by_groups(mm, a, b):
    """a b^T as the wide kernels form S and dP: a share a 128-column group
    of the head dim (past hd the zero fill adds exact zeros), added in
    group order."""
    out = mm(a[..., :WIDE_C], b[..., :WIDE_C].transpose(-1, -2))
    for c in range(WIDE_C, a.shape[-1], WIDE_C):
        out = out + mm(a[..., c:c + WIDE_C],
                       b[..., c:c + WIDE_C].transpose(-1, -2))
    return out


def by_periods(mm, a, b):
    """a b as the wide kernels sum dq, dk and dv: FLUSH of the summed
    index at a time, each period's product added in f32."""
    out = mm(a[..., :FLUSH], b[..., :FLUSH, :])
    for c in range(FLUSH, a.shape[-1], FLUSH):
        out = out + mm(a[..., c:c + FLUSH], b[..., c:c + FLUSH, :])
    return out


def emulated_wide_backward(q, k, v, do, lse, delta, causal, shift, window,
                           mm):
    """dq, dk, dv as the wide kernels (hd > 128) compute them: S and dP by
    column groups, dq, dk and dv by flush periods, dk and dv summing the
    group's query heads one after another along the period.  Shapes as
    :func:`emulated_backward`."""
    scale = q.shape[-1] ** -0.5
    kg, vg = k[:, None], v[:, None]
    keep = tat._keep(q.shape[-2], k.shape[-2], causal, shift, window,
                     q.device)
    p = torch.exp(by_groups(mm, q, kg) * scale - lse)
    p = p.masked_fill(~keep, 0.0)
    ds = p * (by_groups(mm, do, vg) - delta) * scale
    dq = by_periods(mm, ds, kg)
    s_k, hd = k.shape[-2:]

    def heads_in_turn(x):  # [.., g, s_q, s_k] -> [.., s_k, g s_q]
        return x.transpose(-1, -2).transpose(-3, -2).reshape(
            *x.shape[:-3], s_k, -1)

    rows_q = q.reshape(*q.shape[:-3], -1, hd)
    rows_do = do.reshape(*do.shape[:-3], -1, hd)
    dk = by_periods(mm, heads_in_turn(ds), rows_q)
    dv = by_periods(mm, heads_in_turn(p), rows_do)
    return dq, dk, dv


def emulated_backward(q, k, v, do, lse, delta, causal, shift, window, mm):
    """dq, dk, dv as the kernels compute them, every product through
    ``mm``: S = Q K^T, P = exp(S scale - lse) (0 where masked), dP =
    dO V^T, dS = P (dP - delta) scale, dq = dS K, dk = dS^T Q and dv =
    P^T dO summed over the group.  q, do [n_kv, g, s, hd]; k, v
    [n_kv, s, hd]."""
    scale = q.shape[-1] ** -0.5
    kg, vg = k[:, None], v[:, None]
    keep = tat._keep(q.shape[-2], k.shape[-2], causal, shift, window,
                     q.device)
    p = torch.exp(mm(q, kg.transpose(-1, -2)) * scale - lse)
    p = p.masked_fill(~keep, 0.0)
    ds = p * (mm(do, vg.transpose(-1, -2)) - delta) * scale
    dq = mm(ds, kg)
    dk = mm(ds.transpose(-1, -2), q).sum(1)
    dv = mm(p.transpose(-1, -2), do).sum(1)
    return dq, dk, dv


# id: (s, query heads a kv head, causal, shift, window)
CASES = {"causal": (128, 1, True, 0, 0),
         "window": (256, 1, True, 0, 100),
         "shift-1": (256, 1, True, -1, 0),
         "full": (128, 1, False, 0, 0),
         "gqa4": (128, 4, True, 0, 0)}


@functools.lru_cache(maxsize=None)
def case(name: str, hd: int):
    """numpy-seeded q, k, v, do (one batch, one kv head) and the JAX
    Pallas backward's dq, dk, dv for them."""
    s, g, causal, shift, window = CASES[name]
    rng = np.random.default_rng(100 * hd + list(CASES).index(name))
    q, do = (rng.standard_normal((1, g, s, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 1, s, hd)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    if shift:
        # the public function has no shift: the kernels' own entry points
        a, b, c, dd = (x[0, 0] for x in (jq, jk, jv, jdo))
        o, lse = jat._flash_2d(a, b, c, causal, 128, 128, None, shift,
                               window)
        grads = jat._flash_bwd_2d(a, b, c, o, lse, dd, causal, 128, 128,
                                  shift, window)
        grads = [np.asarray(x)[None, None] for x in grads]
    else:
        if g > 1:
            fn = functools.partial(jat.flash_attention_gqa, causal=causal,
                                   use_kernel=True, window=window)
        else:
            fn = functools.partial(jat.flash_attention, causal=causal,
                                   window=window)
        _o, vjp = jax.vjp(fn, jq, jk, jv)
        grads = [np.asarray(x) for x in vjp(jdo)]
    return (q, k, v, do), grads


def _emulate(name, hd, mm):
    (q, k, v, do), want = case(name, hd)
    _s, _g, causal, shift, window = CASES[name]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tat.flash_attention_reference(tq, tk, tv, causal, shift,
                                           window)
    delta = (tdo * o).sum(-1, keepdim=True)
    emulate = emulated_wide_backward if hd > 128 else emulated_backward
    got = emulate(tq[0], tk[0], tv[0], tdo[0], lse[0], delta[0], causal,
                  shift, window, mm)
    # dq [1, g, s, hd]; dk, dv [1, 1, s, hd] as the JAX grads
    got = [got[0][None].numpy(), got[1][None].numpy(), got[2][None].numpy()]
    return [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(got, want)]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("hd", [64, 128, 192, 256, 512])
def test_three_tf32_products_match_the_jax_pallas_backward(hd, name):
    rel = _emulate(name, hd, mm3)
    assert max(rel) <= TOL, dict(zip(("dq", "dk", "dv"), rel))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("hd", [64, 128, 192, 256, 512])
def test_one_tf32_product_misses_the_limit(hd, name):
    """Why three: at the same seeds one rounding of each operand puts
    the worst of dq, dk and dv above 1e-4 of its largest value."""
    rel = _emulate(name, hd, mm1)
    assert max(rel) > TOL, dict(zip(("dq", "dk", "dv"), rel))


def test_the_wrappers_on_the_cpu_stay_the_plain_versions(monkeypatch):
    """On CPU tensors the dq and dk/dv wrappers run their plain versions
    bit for bit and never load the kernel library."""
    def no_library():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(_build, "lib", no_library)
    (q, k, v, do), _ = case("gqa4", 64)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tat.flash_attention_reference(tq, tk, tv, True)
    delta = (tdo * o).sum(-1, keepdim=True)
    n_dq, n_dkv = tat.flash_bwd_dq.launches, tat.flash_bwd_dkv.launches
    dq = tat.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, True)
    dk, dv = tat.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, True)
    assert torch.equal(dq, tat.flash_bwd_dq_reference(tq, tk, tv, tdo, lse,
                                                      delta, True))
    want_dk, want_dv = tat.flash_bwd_dkv_reference(tq, tk, tv, tdo, lse,
                                                   delta, True)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
    assert (tat.flash_bwd_dq.launches, tat.flash_bwd_dkv.launches) == (
        n_dq, n_dkv)
