"""The f32 flash forward on the tensor cores (3xTF32) at every hd <= 512:
which C entries the wrapper calls and which kernels they launch (on the
CPU), and the kernels against their plain versions, o within 2e-5 and
lse within 2e-5 relative (on the card: ``python -m pytest
tests/test_torch_f32_forward_card.py -m cuda --noconftest``).  No JAX
here: the card test runs where JAX is not."""

import re

import pytest
import torch

from vtpu_torch.ops import _build
from vtpu_torch.ops import attention as tat

TOL = 2e-5  # o absolute; lse relative (to max(|lse|, 1))


def _code(path) -> str:
    text = open(path).read()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


def _sources() -> dict:
    return {p.rsplit("/", 1)[-1]: _code(p) for p in _build._sources()
            if p.endswith(".cu")}


@pytest.mark.parametrize("hd, wide", [(33, False), (64, False),
                                      (100, False), (128, False),
                                      (129, True), (256, True), (512, True)])
def test_f32_forward_entry_by_head_dim(hd, wide):
    """Up to hd 128 the narrow entry, above it the wide one (both 3xTF32,
    in the same source)."""
    want = f"vtpu_flash_fwd_{'wide_' if wide else ''}f32"
    assert tat._entry("flash_fwd", hd, tat._FWD_ENTRY[(torch.float32,
                                                       torch.float32)]) == want


@pytest.mark.parametrize("entry, sizes", [
    ("vtpu_flash_fwd_f32", (64, 128)),
    ("vtpu_flash_fwd_wide_f32", (256, 512))])
def test_f32_forward_entries_run_the_tf32x3_kernel(entry, sizes):
    """Each f32 forward entry is defined in the 3xTF32 source and launches
    ``flash_fwd_tf32x3`` at both of its sizes (64 and 128; 256 and 512),
    whose products are TF32 ``mma.sync`` with hi rounded as
    ``cvt.rna.tf32.f32`` rounds."""
    t3 = _sources()["flash_attention_tf32x3.cu"]
    m = re.search(r'extern\s+"C"\s+int\s+' + entry +
                  r'\s*\([^)]*\)\s*\{(.*?)\n\}', t3, flags=re.S)
    assert m, entry
    assert re.search(r"\bfwd_tf32x3<%d>.*\bfwd_tf32x3<%d>" % sizes,
                     m.group(1), flags=re.S), entry
    assert re.search(r"auto\s+kernel\s*=\s*flash_fwd_tf32x3<HD>", t3)
    body = re.search(r"flash_fwd_tf32x3\s*\((.*?)\n\}", t3, flags=re.S)
    assert body and "mma3(" in body.group(1)
    assert "m16n8k8.row.col.f32.tf32.tf32.f32" in t3
    assert "+ 0x1000u) & 0xffffe000u" in t3


def test_no_source_keeps_the_cuda_core_forward():
    """The CUDA-core source is gone, and no source defines its kernels
    (``flash_fwd``, ``flash_fwd_wide``) or another f32 forward entry."""
    code = _sources()
    assert "flash_attention.cu" not in code
    for name, text in code.items():
        for gone in (r"\bflash_fwd\s*[(<]", r"\bflash_fwd_wide\s*[(<]",
                     r"\blaunch_fwd\s*<", r"\blaunch_fwd_wide\s*<"):
            assert not re.search(gone, text), (name, gone)
        if name != "flash_attention_tf32x3.cu":
            for entry in ("vtpu_flash_fwd_f32", "vtpu_flash_fwd_wide_f32"):
                assert not re.search(r"\b" + entry + r"\b", text), (name,
                                                                    entry)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++)")
    from vtpu_torch.device import reference_numerics

    reference_numerics()
    return torch.device("cuda")


def _inputs(gen, b, heads, n_kv, s, hd):
    def rnd(h):
        return torch.randn(b, h, s, hd, device="cuda", generator=gen)

    return rnd(heads), rnd(n_kv), rnd(n_kv)


def _check(q, k, v, cfg, what):
    o, lse = tat.flash_forward(q, k, v, *cfg)
    ro, rlse = tat.flash_attention_reference(q, k, v, *cfg)
    assert o.dtype == torch.float32 and o.shape == ro.shape, what
    err = (o - ro).abs().max().item()
    lse_err = ((lse - rlse).abs() / rlse.abs().clamp_min(1)).max().item()
    assert err <= TOL, (what, err)
    assert lse_err <= TOL, (what, lse_err)
    return o, lse


@pytest.mark.cuda
def test_f32_forward_matches_plain_on_the_card(cuda_card, monkeypatch):
    """hd 33, 64, 128 (the narrow entry) and 192, 256, 512 (the wide one);
    causal, a window of 256, shift -1 (row 0 keeps no key: o = 0, lse
    ~ -1e30) and non-causal; ragged s 1000 and s 4096 (a P V sum over 512
    k-steps of 8 keys); 1 and 4 query heads a kv head; then an unaligned
    q, which takes the plain-load staging.  Every call goes to the f32
    entries and adds one to the wrapper's count."""
    real = _build.lib()
    called = []

    class Spy:
        def __getattr__(self, name):
            if name.startswith("vtpu_flash_fwd"):
                called.append(name)
            return getattr(real, name)

    monkeypatch.setattr(_build, "lib", lambda: Spy())
    gen = torch.Generator(device=cuda_card).manual_seed(5)
    cfgs = ((True, 0, 0), (True, 0, 256), (True, -1, 0), (False, 0, 0))
    cases, i = [], 0
    for hd in (33, 64, 128, 192, 256, 512):
        for s in (1000, 4096):
            for cfg in cfgs:
                g = (1, 4)[i % 2]
                i += 1
                heads = 4 if s == 4096 else 8
                cases.append((_inputs(gen, 1, heads, heads // g, s, hd), cfg))
    q, k, v = _inputs(gen, 1, 2, 1, 300, 128)
    q_off = torch.empty(q.numel() + 1, device=cuda_card)[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 != 0
    cases.append(((q_off, k, v), (True, 0, 0)))
    n = tat.flash_forward.launches
    want = []
    for j, ((q, k, v), cfg) in enumerate(cases):
        o, lse = _check(q, k, v, cfg, (tuple(q.shape), tuple(k.shape), cfg))
        if cfg[1] == -1:
            assert bool((o[..., 0, :] == 0).all())
            assert bool((lse[..., 0, :] < -1e29).all())
        assert tat.flash_forward.launches == n + j + 1
        want.append("vtpu_flash_fwd_wide_f32" if q.shape[-1] > 128
                    else "vtpu_flash_fwd_f32")
    assert called == want


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 256, 512])
def test_two_f32_forward_calls_give_the_same_bits(cuda_card, hd):
    """No atomics, and above hd 128 every warp of a slab adds the column
    groups' shares of S in one order: o and lse of two calls are equal
    bit for bit (8 query heads over 2 kv heads, s 1024, causal)."""
    gen = torch.Generator(device=cuda_card).manual_seed(6)
    q, k, v = _inputs(gen, 1, 8, 2, 1024, hd)
    first = tat.flash_forward(q, k, v, True)
    second = tat.flash_forward(q, k, v, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
