"""The f32 flash forward, which runs on the tensor cores as
error-compensated 3xTF32 (``flash_fwd_tf32x3`` in
``csrc/flash_attention_tf32x3.cu``: <64> and <128> up to hd 128, <256>
and <512> above), held on the CPU.

(a) The kernel's arithmetic emulated in torch, with the rounding of
``tests/test_torch_f32_backward.py``: S = Q K^T and each key tile's P V as
lo_a hi_b + hi_a lo_b + hi_a hi_b (hi the ``cvt.rna.tf32.f32`` rounding,
lo = x - hi read by the tensor core as TF32 rounded toward zero), each
sum in f32.  Above hd 128 S is formed as the kernel forms it: one share a
128-column group of the head dim, the shares added in group order.  The
online softmax walks the kernel's key tiles (32 keys up to hd 128, 16 at
256, 8 at 512) in log2 units, m from -1e30, masked p 0; each tile's P V
is summed from zero and added to o as o alpha + P V, so no chain of
tensor-core sums is longer than a tile's.  o must lie within 2e-5 and lse
within 2e-5 relative (the limits the card holds the kernel to) of the
JAX package's Pallas forward, ``_attn_kernel`` in interpret mode
(``jat.flash_attention`` at s 128 and 256, a multiple of its 128-row
blocks, with its lse from the same ``_flash_impl``; shift -1 through
``_flash_impl``, which the public function does not expose; g 4 through
``flash_attention_gqa(use_kernel=True)``), at hd 64, 128, 192, 256 and
512.  Under shift -1 the first row keeps no key: the kernel writes o = 0
there where the TPU kernel writes the mean of its first block's v (a
deliberate divergence), so that row's o is held to 0 instead.

(b) One TF32 product (both operands rounded once) misses that limit at
the same seeds: the record of why the kernel takes three.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_f32_backward import by_groups, mm1, mm3
from vtpu.ops import attention as jat
from vtpu_torch.ops import _build
from vtpu_torch.ops import attention as tat

TOL = 2e-5  # o absolute; lse relative to max(|lse|, 1)
NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def key_tile(hd: int) -> int:
    """Keys a K/V tile of the kernel's instance for this head dim."""
    return 32 if hd <= 128 else 4096 // (256 if hd <= 256 else 512)


def emulated_forward(q, k, v, causal, shift, window, mm):
    """(o, lse) as the kernel computes them, every product through ``mm``:
    q [g, s, hd], k and v [s_k, hd]; lse [g, s, 1]."""
    s_q, hd = q.shape[-2:]
    s_k = k.shape[-2]
    sc = hd ** -0.5 * LOG2E
    keep = tat._keep(s_q, s_k, causal, shift, window, q.device)
    m = torch.full((*q.shape[:-1], 1), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    n = key_tile(hd)
    for k0 in range(0, s_k, n):
        kt, vt = k[k0:k0 + n], v[k0:k0 + n]
        s = torch.where(keep[:, k0:k0 + n], by_groups(mm, q, kt) * sc,
                        torch.tensor(NEG_INF))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mx)
        p = torch.where(s > NEG_INF / 2, torch.exp2(s - mx),
                        torch.tensor(0.0))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vt)
        m = mx
    ls = l.clamp_min(1e-30)
    lse = torch.where(m <= NEG_INF / 2, torch.tensor(NEG_INF),
                      m * LN2) + torch.log(ls)
    return acc / ls, lse


# id: (s, query heads a kv head, causal, shift, window)
CASES = {"causal": (128, 1, True, 0, 0),
         "window": (256, 1, True, 0, 100),
         "shift-1": (256, 1, True, -1, 0),
         "full": (128, 1, False, 0, 0),
         "gqa4": (128, 4, True, 0, 0)}


@functools.lru_cache(maxsize=None)
def case(name: str, hd: int):
    """numpy-seeded q, k, v (one batch, one kv head) and the JAX Pallas
    forward's o and lse for them."""
    s, g, causal, shift, window = CASES[name]
    rng = np.random.default_rng(200 * hd + list(CASES).index(name))
    q = rng.standard_normal((1, g, s, hd)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1, s, hd)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    # lse from the kernel's own entry (the public functions return o only)
    _o, lse = jat._flash_impl(jq, jnp.repeat(jk, g, axis=1),
                              jnp.repeat(jv, g, axis=1), causal, 128, 128,
                              None, shift, window)
    if shift:
        o = _o
    elif g > 1:
        o = jat.flash_attention_gqa(jq, jk, jv, causal=causal,
                                    use_kernel=True, window=window)
    else:
        o = jat.flash_attention(jq, jk, jv, causal=causal, window=window)
    return (q, k, v), (np.asarray(o), np.asarray(lse))


def _errors(name, hd, mm):
    (q, k, v), (want_o, want_lse) = case(name, hd)
    _s, _g, causal, shift, window = CASES[name]
    o, lse = emulated_forward(torch.from_numpy(q[0]),
                              torch.from_numpy(k[0, 0]),
                              torch.from_numpy(v[0, 0]), causal, shift,
                              window, mm)
    o, lse = o[None].numpy(), lse[None].numpy()
    if shift == -1:  # row 0 keeps no key: o = 0 here (deliberate)
        assert not o[..., 0, :].any()
        want_o = want_o.copy()
        want_o[..., 0, :] = 0.0
    o_err = float(np.abs(o - want_o).max())
    lse_err = float((np.abs(lse - want_lse)
                     / np.maximum(np.abs(want_lse), 1.0)).max())
    return o_err, lse_err


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("hd", [64, 128, 192, 256, 512])
def test_three_tf32_products_match_the_jax_pallas_forward(hd, name):
    o_err, lse_err = _errors(name, hd, mm3)
    assert o_err <= TOL and lse_err <= TOL, (o_err, lse_err)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("hd", [64, 128, 192, 256, 512])
def test_one_tf32_product_misses_the_limit(hd, name):
    """Why three: at the same seeds one rounding of each operand puts o
    more than 2e-5 off."""
    o_err, _lse_err = _errors(name, hd, mm1)
    assert o_err > TOL, o_err


@pytest.mark.parametrize("hd", [64, 256])
def test_the_wrapper_on_the_cpu_stays_the_plain_version(monkeypatch, hd):
    """On CPU tensors the forward wrapper runs its plain version bit for
    bit, never loads the kernel library and counts no launch."""
    def no_library():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(_build, "lib", no_library)
    (q, k, v), _ = case("gqa4", hd)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    n = tat.flash_forward.launches
    o, lse = tat.flash_forward(tq, tk, tv, True)
    want_o, want_lse = tat.flash_attention_reference(tq, tk, tv, True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert tat.flash_forward.launches == n
