"""Head dims above 128: the port's flash attention and paged decode
attention against the JAX package's, and the kernels that take them.

On the CPU the JAX side runs its Pallas kernels in interpret mode (the
flash forward, dq and dk/dv through its custom VJP; the paged decode
kernel with ``interpret=True``), which check no head dim; the port runs
its kernels' plain versions.  Inputs are numpy-seeded and shared.
Tolerances: flash 1e-4 abs on o, dq, dk and dv in f32 (the two sides sum
in different orders over up to 512 dims); paged 2e-5 abs and relative,
as tests/test_torch_ops.py holds the narrower heads.

The ``cuda``-marked tests hold the kernels at these head dims against
their plain versions on the card (``python -m pytest
tests/test_torch_wide_heads.py -m cuda --noconftest``).
"""

import types

import numpy as np
import pytest
import torch

from vtpu_torch.ops import _build
from vtpu_torch.ops import attention as tat
from vtpu_torch.ops import paged_attention as tpa

FLASH_TOL = 1e-4
PAGED_TOL = 2e-5


@pytest.fixture
def ref():
    """The JAX package, imported by the CPU tests only (the machine with
    the card runs the cuda-marked tests below without JAX)."""
    import jax
    import jax.numpy as jnp

    from vtpu.ops import attention as jat
    from vtpu.ops import paged_attention as jpa

    return types.SimpleNamespace(jax=jax, jnp=jnp, jat=jat, jpa=jpa)


def _flash_inputs(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    q, ct = (rng.standard_normal(q_shape).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal(kv_shape).astype(np.float32)
            for _ in range(2))
    return q, k, v, ct


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("hd", [192, 256, 512])
def test_flash_attention_and_grads_match_jax_at_wide_heads(ref, hd, causal):
    """GQA (4 query heads over 2 kv heads), s 128: the JAX side vmaps its
    Pallas kernels over the group; o and the gradients by autograd."""
    q, k, v, ct = _flash_inputs(hd + causal, (1, 4, 128, hd),
                                (1, 2, 128, hd))
    jnp = ref.jnp

    def jfn(a, b, c):
        return ref.jat.flash_attention_gqa(a, b, c, causal=causal,
                                           use_kernel=True)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = [np.asarray(jfn(jq, jk, jv))]
    want += [np.asarray(g) for g in ref.jax.grad(
        lambda a, b, c: jnp.sum(jfn(a, b, c) * ct), argnums=(0, 1, 2))(
            jq, jk, jv)]
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tat.flash_attention_gqa(*ts, causal=causal)
    (o * torch.from_numpy(ct)).sum().backward()
    got = [o.detach().numpy()] + [t.grad.numpy() for t in ts]
    for g, w, name in zip(got, want, "o dq dk dv".split()):
        np.testing.assert_allclose(g, w, atol=FLASH_TOL, rtol=0,
                                   err_msg=f"{name} hd {hd}")


@pytest.mark.parametrize("hd,entry", [
    (64, "vtpu_flash_fwd_f32"), (128, "vtpu_flash_fwd_bf16"),
    (129, "vtpu_flash_fwd_wide_bf16"), (192, "vtpu_flash_fwd_wide_f32"),
    (512, "vtpu_flash_fwd_wide_bf16_f32out")])
def test_flash_entry_is_chosen_by_head_dim(hd, entry):
    suffix = entry.rsplit("fwd_", 1)[1].replace("wide_", "")
    assert tat._entry("flash_fwd", hd, suffix) == entry
    assert entry in _build.SIGNATURES
    for base, sfx in (("flash_bwd_dq", "f32"), ("flash_bwd_dkv", "bf16")):
        assert tat._entry(base, hd, sfx) in _build.SIGNATURES


def test_flash_head_dim_above_the_limit_raises():
    with pytest.raises(ValueError, match="head dim 513 is above 512"):
        tat._entry("flash_bwd_dkv", 513, "f32")


def _paged_inputs(seed, g, hd, quant):
    rng = np.random.default_rng(seed)
    b, n_kv, bs, nb_max = 3, 2, 8, 4
    P = 1 + b * nb_max
    q = rng.standard_normal((b, n_kv * g, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, P)).astype(np.int32).reshape(
        b, nb_max)
    # a block edge, inside a block, and a row that overshoots the table
    lengths = np.array([bs, 2 * bs + 3, nb_max * bs + 2], np.int32)
    kv = {}
    for n in ("k", "v"):
        if quant:
            kv[n] = rng.integers(-127, 128, (P, n_kv, bs, hd)).astype(
                np.int8)
            kv[n + "s"] = rng.uniform(0.001, 0.05, (P, n_kv, bs, 1)).astype(
                np.float32)
        else:
            kv[n] = rng.standard_normal((P, n_kv, bs, hd)).astype(np.float32)
    return q, tables, lengths, kv


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("g,hd", [(8, 256), (4, 512)])
def test_paged_attention_matches_pallas_at_wide_heads(ref, g, hd, quant):
    q, tables, lengths, kv = _paged_inputs(g + hd + quant, g, hd, quant)
    scales = ("ks", "vs") if quant else ()
    jnp = ref.jnp
    want = np.asarray(ref.jpa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kv["k"]), jnp.asarray(kv["v"]),
        jnp.asarray(tables), jnp.asarray(lengths),
        *[jnp.asarray(kv[n]) for n in scales], interpret=True))
    got = tpa.paged_attention_decode(
        torch.from_numpy(q), torch.from_numpy(kv["k"]),
        torch.from_numpy(kv["v"]), torch.from_numpy(tables),
        torch.from_numpy(lengths),
        *[torch.from_numpy(kv[n]) for n in scales]).numpy()
    np.testing.assert_allclose(got, want, atol=PAGED_TOL, rtol=PAGED_TOL)


def test_paged_head_dim_above_the_limit_raises():
    q = torch.zeros(1, 2, 513)
    pool = torch.zeros(2, 1, 4, 513)
    with pytest.raises(ValueError, match="head dim 513 is above 512"):
        tpa._check(q, pool, pool, torch.zeros(1, 1, dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int32), None, None)


# -- on the card -----------------------------------------------------------
@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++)")
    from vtpu_torch.device import reference_numerics

    reference_numerics()
    return torch.device("cuda")


def _bf16_ulps(got, want):
    """max |got - want| in bf16 ulps at want's scale (chip_smoke.py's
    tolerance)."""
    want = want.float()
    scale = want.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale else 1.0
    return (got.float() - want).abs().max().item() / ulp


def _within(got, want, dtype, tol_f32):
    if dtype == torch.bfloat16:
        return _bf16_ulps(got, want) <= 2
    return (got.float() - want.float()).abs().max().item() <= tol_f32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [192, 256, 512, 129, 201, 320, 300])
def test_wide_flash_kernels_match_plain_on_the_card(cuda_card, hd, dtype):
    """Forward, dq and dk/dv at hd 192, 256 and 512, at hd 320 (three
    128-column chunks, the last one half full), and at hd 129, 201 and
    300 (hd % 8 != 0: the plain-load staging) against their plain versions:
    f32 o at 2e-5, dq / dk / dv at 1e-4 of their largest value, bf16 at 2
    ulps; causal with GQA (g 2, 4 and 8), a window, shift -1 with an f32
    o, non-causal with an f32 o, and a ragged length; two forward and two
    backward calls give the same bits (no atomics: the sums do not depend
    on the order blocks run in)."""
    gen = torch.Generator(device=cuda_card).manual_seed(hd)
    cases = [((1, 4, 256, hd), 2, (True, 0, 0), None),
             ((1, 2, 200, hd), 2, (True, 0, 70), None),
             ((1, 2, 130, hd), 1, (True, -1, 0), torch.float32),
             ((2, 2, 77, hd), 2, (False, 0, 0), None),
             ((1, 8, 300, hd), 2, (True, 0, 0), None),
             ((1, 8, 300, hd), 1, (True, 0, 0), None),
             ((1, 8, 260, hd), 2, (True, -1, 0), None),
             ((2, 4, 190, hd), 2, (False, 0, 0), torch.float32)]
    for q_shape, n_kv, cfg, out in cases:
        kv_shape = (q_shape[0], n_kv, *q_shape[2:])
        q, do = (torch.randn(q_shape, device=cuda_card,
                             generator=gen).to(dtype) for _ in range(2))
        k, v = (torch.randn(kv_shape, device=cuda_card,
                            generator=gen).to(dtype) for _ in range(2))
        what = (q_shape, n_kv, cfg, out, dtype)
        o, lse = tat.flash_forward(q, k, v, *cfg, out_dtype=out)
        ro, rlse = tat.flash_attention_reference(q, k, v, *cfg,
                                                 out_dtype=out)
        assert _within(o, ro, o.dtype, 2e-5), what
        assert ((lse - rlse).abs() / rlse.abs().clamp_min(1)).max() <= 2e-5
        o2, lse2 = tat.flash_forward(q, k, v, *cfg, out_dtype=out)
        assert torch.equal(o, o2) and torch.equal(lse, lse2), what
        delta = (do.float() * ro.float()).sum(-1, keepdim=True)
        dq = tat.flash_bwd_dq(q, k, v, do, rlse, delta, *cfg)
        rdq = tat.flash_bwd_dq_reference(q, k, v, do, rlse, delta, *cfg)
        assert _within(dq, rdq, dtype, 1e-4 * rdq.abs().max().item()), what
        dk, dv = tat.flash_bwd_dkv(q, k, v, do, rlse, delta, *cfg)
        rdk, rdv = tat.flash_bwd_dkv_reference(q, k, v, do, rlse, delta,
                                               *cfg)
        assert _within(dk, rdk, dtype, 1e-4 * rdk.abs().max().item()), what
        assert _within(dv, rdv, dtype, 1e-4 * rdv.abs().max().item()), what
        assert torch.equal(dq, tat.flash_bwd_dq(q, k, v, do, rlse, delta,
                                                *cfg)), what
        again = tat.flash_bwd_dkv(q, k, v, do, rlse, delta, *cfg)
        assert torch.equal(dk, again[0]) and torch.equal(dv, again[1]), what
    q = torch.zeros(1, 1, 64, 520, device=cuda_card, dtype=dtype)
    with pytest.raises(ValueError, match="above 512"):
        tat.flash_forward(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_paged_kernels_match_plain_on_the_card(cuda_card, dtype, quant):
    """The paged kernel at (g 8, hd 256), (g 4, hd 512), (g 1, hd 512) and
    (g 32, hd 128), at hd 320 (no whole vector a lane) with blocks of 64
    keys, and at hd 512 with blocks of 128 keys (tiles that are part of a
    block): f32 q at 2e-5 abs, bf16 at 2 ulps; two calls give the same
    bits."""
    from vtpu_torch.ops.quant import quantize_int8

    gen = torch.Generator(device=cuda_card).manual_seed(7)
    for b, g, n_kv, hd, bs, nb, lengths in [
            (3, 8, 2, 256, 16, 40, [0, 300, 40 * 16 + 9]),
            (3, 4, 2, 512, 16, 40, [17, 639, 128]),
            (2, 1, 4, 512, 16, 40, [500, 64]),
            (3, 32, 2, 128, 16, 40, [5, 639, 200]),
            (2, 4, 2, 320, 64, 10, [639, 70]),
            (2, 2, 2, 512, 128, 5, [639, 130])]:
        P = 1 + b * nb
        q = torch.randn(b, g * n_kv, hd, device=cuda_card,
                        generator=gen).to(dtype)
        k = torch.randn(P, n_kv, bs, hd, device=cuda_card, generator=gen)
        v = torch.randn(P, n_kv, bs, hd, device=cuda_card, generator=gen)
        tables = (torch.randperm(P - 1, device=cuda_card, generator=gen)
                  + 1).to(torch.int32).reshape(b, nb)
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_card)
        if quant:
            kq, vq = quantize_int8(k, axis=-1), quantize_int8(v, axis=-1)
            args = (q, kq.q, vq.q, tables, lens, kq.scale, vq.scale)
        else:
            args = (q, k.to(dtype), v.to(dtype), tables, lens)
        what = (b, g, n_kv, hd, bs, nb, dtype, quant)
        got = tpa.paged_attention_decode(*args)
        want = tpa.paged_attention_reference(*args)
        assert _within(got, want, dtype, PAGED_TOL), what
        assert torch.equal(got, tpa.paged_attention_decode(*args)), what
