"""The bf16 flash forward at head dims above 128, which runs on the tensor
cores (``flash_fwd_split_tc`` up to hd 256, ``flash_fwd_wide_tc`` above,
in ``csrc/flash_attention_sm90.cu``), held on the CPU.

(a) The module against the JAX package: numpy-seeded bf16 q, k and v
(4 heads, s 256, a multiple of the 128-row blocks, so the JAX side takes
its Pallas kernel in interpret mode and not its reference) through both
packages' ``flash_attention_with_lse``; the port runs its wrapper's plain
version.  o in f32 within 2e-5 and lse within 2e-5 relative, the
tolerances of tests/test_torch_flash_f32out.py at hd 128.

(b) The new kernels' rounding, emulated in torch with that file's
tile-by-tile online softmax: the bf16 entry rounds p to bf16 before
P V with every sum in f32, and its o must lie within two bf16 ulps (at
the plain output's scale) of ``flash_attention_reference``, the bound the
card tests hold the kernels to; the f32-out entry splits p into p_hi +
p_lo, and its o must lie within 2e-5 of the plain f32 o, which a single
bf16 rounding of p misses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_f32out import TOL_F32, _bf16_inputs, _emulate
from vtpu.ops import attention as jat
from vtpu_torch.ops import attention as tat

CASES = [(True, 0), (True, -1), (False, 0)]
IDS = ["causal", "strict", "full"]


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("causal, shift", CASES, ids=IDS)
@pytest.mark.parametrize("hd", [192, 256, 512])
def test_wide_forward_with_lse_matches_jax_kernel(hd, causal, shift):
    """Under shift=-1 the first row has no key: lse ~-1e30 on both, o = 0
    in the port (the TPU kernel writes its first block's mean of v, whose
    merge weight is 0 all the same), so that row is held apart."""
    q, k, v = _bf16_inputs(hd + 3 * shift + causal, (1, 4, 256, hd))
    assert tat._entry("flash_fwd", hd, "bf16_f32out") == \
        "vtpu_flash_fwd_wide_bf16_f32out"
    o, lse = tat.flash_attention_with_lse(q, k, v, causal=causal,
                                          shift=shift)
    jo, jlse = jat.flash_attention_with_lse(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (q, k, v)), causal, shift)
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


def _ulps(got, want):
    """max |got - want| in bf16 ulps at want's scale (the card tests'
    measure)."""
    want = want.float()
    ulp = 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    return (got.float() - want).abs().max().item() / ulp


@pytest.mark.parametrize("causal, shift", CASES, ids=IDS)
@pytest.mark.parametrize("hd", [192, 256, 512])
def test_bf16_rounding_of_p_stays_within_two_ulps(hd, causal, shift):
    """b 1, 4 heads, s 256, randn bf16: the emulated kernel's bf16 o
    against the plain version's."""
    q, k, v = _bf16_inputs(7 * hd + shift, (1, 4, 256, hd))
    got, _ = _emulate(q, k, v, causal, shift, "single")
    got = got.to(torch.bfloat16)
    want, _ = tat.flash_attention_reference(q, k, v, causal, shift)
    assert want.dtype == torch.bfloat16 and got.shape == want.shape
    assert _ulps(got, want) <= 2, (hd, causal, shift, _ulps(got, want))
    # the rounding is real: the emulation is not the plain version
    assert not torch.equal(got, want)


@pytest.mark.parametrize("causal, shift", CASES, ids=IDS)
def test_split_p_keeps_wide_f32_o_within_2e5(causal, shift):
    """hd 256 (b 1, 4 heads, s 512, randn bf16): p_hi + p_lo keeps o
    within 2e-5 of the plain f32 o; one bf16 rounding of p misses it."""
    q, k, v = _bf16_inputs(29 + shift, (1, 4, 512, 256))
    want, _ = tat.flash_attention_reference(q, k, v, causal, shift,
                                            out_dtype=torch.float32)
    split, worst = _emulate(q, k, v, causal, shift, "split")
    single, _ = _emulate(q, k, v, causal, shift, "single")
    assert float((split - want).abs().max()) <= TOL_F32
    assert 0.0 < worst <= 2.0 ** -17
    assert float((single - want).abs().max()) > TOL_F32
