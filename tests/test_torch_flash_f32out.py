"""The bf16 -> f32-out flash forward (ring attention's partials) on the
CPU: the arithmetic of its tensor-core kernel, and the port's
``flash_attention_with_lse`` on bf16 inputs against the JAX package's.

The kernel (``flash_fwd_tc<HD, float>`` in
``vtpu_torch/csrc/flash_attention_sm90.cu``) cannot run here, so (a)
emulates its P V in torch: 64-key tiles in the kernel's order, scores in
log2 units, p = exp2(s - m) in f32, then p split into p_hi = bf16(p) and
p_lo = bf16(p - p_hi), each multiplied by bf16 V with f32 sums.  Its o
must stay within 2e-5 of the plain f32 o (the tolerance ``chip_smoke.py``
holds the kernel to), the split within its proven 2^-17 max|v|, while a
single bf16 rounding of p (the bf16 forward's) misses 2e-5.  (b) runs
the JAX side's Pallas kernel in interpret mode on the same bf16 arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.ops import attention as jat
from vtpu_torch.ops import attention as tat

TOL_F32 = 2e-5       # the f32-out forward's tolerance on the card
SPLIT_REL = 2.0 ** -17  # |p - p_hi - p_lo| <= 2^-17 p
TILE = 64            # keys per K/V tile of the kernel
LOG2E = 1.4426950408889634


def _bf16_inputs(seed, shape):
    """Seeded numpy draws rounded to bf16, as torch bf16 tensors."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16) for _ in range(3)]


def _split(p):
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return hi, lo


def _emulate(q, k, v, causal, shift, mode):
    """o of the kernel's online softmax over 64-key tiles, f32.  ``mode``
    is how P meets V: "split" (p_hi V + p_lo V), "single" (bf16(p) V) or
    "f32" (p V unrounded).  Also returns the worst |p - p_hi - p_lo| / p
    seen."""
    sq, hd = q.shape[-2:]
    sk = k.shape[-2]
    sc = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = torch.arange(sq)[:, None] + shift
    acc = torch.zeros(*q.shape[:-1], hd)
    m = torch.full((*q.shape[:-1], 1), tat.NEG_INF)
    l = torch.zeros((*q.shape[:-1], 1))
    worst = 0.0
    for k0 in range(0, sk, TILE):
        cols = torch.arange(k0, min(k0 + TILE, sk))[None, :]
        keep = cols <= rows if causal else torch.ones_like(cols <= rows)
        s = (qf @ kf[..., k0:k0 + TILE, :].transpose(-1, -2)) * sc
        s = s.masked_fill(~keep, tat.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).masked_fill(~keep, 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = vf[..., k0:k0 + TILE, :]
        if mode == "split":
            hi, lo = _split(p)
            kept = p > 0
            if kept.any():
                rel = ((p - hi - lo).abs() / p.clamp_min(1e-38))[kept]
                worst = max(worst, float(rel.max()))
            pv = hi @ vt + lo @ vt
        elif mode == "single":
            pv = p.to(torch.bfloat16).float() @ vt
        else:
            pv = p @ vt
        acc = acc * alpha + pv
        m = m_new
    return acc / l.clamp_min(1e-30), worst


CASES = [(True, 0), (True, -1), (False, 0)]
IDS = ["causal", "strict", "full"]


@pytest.mark.parametrize("causal, shift", CASES, ids=IDS)
def test_split_p_keeps_f32_o_within_2e5(causal, shift):
    """A ring shard's statistics with fewer heads (b 1, H 4, s 1024, hd
    128, randn bf16): the split's o is within 2e-5 of the plain f32 o;
    what the split alone moves (against unrounded p in the same order)
    is within 2^-17 max|v|; each p misses p_hi + p_lo by at most
    2^-17 p; and rounding p once to bf16 misses 2e-5."""
    q, k, v = _bf16_inputs(17, (1, 4, 1024, 128))
    want, _ = tat.flash_attention_reference(q, k, v, causal, shift,
                                            out_dtype=torch.float32)
    split, worst = _emulate(q, k, v, causal, shift, "split")
    exact, _ = _emulate(q, k, v, causal, shift, "f32")
    single, _ = _emulate(q, k, v, causal, shift, "single")
    vmax = float(v.float().abs().max())

    err = float((split - want).abs().max())
    assert err <= TOL_F32, err
    assert float((split - exact).abs().max()) <= SPLIT_REL * vmax
    assert 0.0 < worst <= SPLIT_REL
    assert float((single - want).abs().max()) > TOL_F32


def test_split_bound_is_tight():
    """2^-17 p is the split's worst case: over p in (0, 1] it is
    approached, so no smaller bound holds."""
    p = torch.rand(1 << 20, generator=torch.Generator().manual_seed(3))
    p = p[p > 0]
    hi, lo = _split(p)
    rel = float(((p - hi - lo).abs() / p).max())
    assert SPLIT_REL / 2 < rel <= SPLIT_REL


@pytest.mark.parametrize("shift", [0, -1], ids=["diag", "strict"])
def test_bf16_with_lse_matches_jax_kernel(shift):
    """bf16 q, k, v at s 256: the port's ``flash_attention_with_lse``
    (its plain version on the CPU) against the JAX package's (its Pallas
    kernel in interpret mode).  o in f32 within 2e-5, lse within 2e-5
    relative.  Under shift=-1 the first row has no key: lse ~-1e30 on
    both, o = 0 in the port (the TPU kernel writes its first block's
    mean of v, whose merge weight is 0 all the same)."""
    q, k, v = _bf16_inputs(23, (1, 4, 256, 128))
    o, lse = tat.flash_attention_with_lse(q, k, v, causal=True, shift=shift)
    jo, jlse = jat.flash_attention_with_lse(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (q, k, v)), True, shift)
    got = [o.numpy(), lse.numpy()]
    want = [np.asarray(jo), np.asarray(jlse)]
    assert got[0].dtype == np.float32 and want[0].dtype == np.float32
    assert got[1].shape == want[1].shape == (1, 4, 256, 1)
    if shift == -1:
        assert np.all(got[1][..., 0, 0] < -1e29)
        assert np.all(want[1][..., 0, 0] < -1e29)
        np.testing.assert_array_equal(got[0][..., 0, :], 0.0)
        got = [x[..., 1:, :] for x in got]
        want = [x[..., 1:, :] for x in want]
    np.testing.assert_allclose(got[0], want[0], atol=TOL_F32, rtol=0)
    rel = np.abs(got[1] - want[1]) / np.maximum(np.abs(want[1]), 1.0)
    assert float(rel.max()) <= TOL_F32
