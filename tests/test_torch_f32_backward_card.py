"""The f32 flash backward on the tensor cores (3xTF32) at every hd <= 512:
which C entries the wrappers call and where they are defined (on the
CPU), and the kernels against their plain versions within 1e-4 of each
output's largest value (on the card: ``python -m pytest
tests/test_torch_f32_backward_card.py -m cuda --noconftest``).  No JAX
here: the card test runs where JAX is not."""

import re

import pytest
import torch

from vtpu_torch.ops import _build
from vtpu_torch.ops import attention as tat

TOL = 1e-4  # of each output's largest |value|


def _code(path) -> str:
    text = open(path).read()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


@pytest.mark.parametrize("hd, wide", [(33, False), (64, False),
                                      (100, False), (128, False),
                                      (129, True), (256, True)])
def test_f32_backward_entry_by_head_dim(hd, wide):
    """Up to hd 128 the hd <= 128 entries, above it the wide ones (both
    3xTF32, in the same source)."""
    for base in ("flash_bwd_dq", "flash_bwd_dkv"):
        want = f"vtpu_{base}_{'wide_' if wide else ''}f32"
        assert tat._entry(base, hd, tat._BWD_SUFFIX[torch.float32]) == want


def test_f32_backward_entries_run_the_tf32x3_kernels():
    """``vtpu_flash_bwd_dq_f32`` and ``vtpu_flash_bwd_dkv_f32`` are
    defined in the 3xTF32 source and launch ``flash_dq_tf32x3`` /
    ``flash_dkv_tf32x3`` at hd 64 and 128, and the wide entries
    ``vtpu_flash_bwd_dq_wide_f32`` and ``vtpu_flash_bwd_dkv_wide_f32``
    launch ``flash_dq_split_tf32x3`` / ``flash_dkv_split_tf32x3`` at 256
    and 512, beside the f32 forward's entries, which launch
    ``flash_fwd_tf32x3`` there too; no source defines the old CUDA-core
    kernels."""
    code = {p.rsplit("/", 1)[-1]: _code(p) for p in _build._sources()
            if p.endswith(".cu")}
    t3 = code["flash_attention_tf32x3.cu"]
    for entry, launch, kernel, sizes in (
            ("vtpu_flash_bwd_dq_f32", "dq_tf32x3", "flash_dq_tf32x3",
             (64, 128)),
            ("vtpu_flash_bwd_dkv_f32", "dkv_tf32x3", "flash_dkv_tf32x3",
             (64, 128)),
            ("vtpu_flash_bwd_dq_wide_f32", "dq_split_tf32x3",
             "flash_dq_split_tf32x3", (256, 512)),
            ("vtpu_flash_bwd_dkv_wide_f32", "dkv_split_tf32x3",
             "flash_dkv_split_tf32x3", (256, 512))):
        m = re.search(r'extern\s+"C"\s+int\s+' + entry +
                      r'\s*\([^)]*\)\s*\{(.*?)\n\}', t3, flags=re.S)
        assert m, entry
        assert re.search(r"\b%s<%d>.*\b%s<%d>" % (launch, sizes[0], launch,
                                                 sizes[1]),
                         m.group(1), flags=re.S), entry
        assert re.search(r"auto\s+kernel\s*=\s*" + kernel + r"<HD>", t3)
    assert "m16n8k8.row.col.f32.tf32.tf32.f32" in t3
    # hi: cvt.rna.tf32.f32's rounding as integer arithmetic
    assert "+ 0x1000u) & 0xffffe000u" in t3
    for entry, sizes in (("vtpu_flash_fwd_f32", (64, 128)),
                         ("vtpu_flash_fwd_wide_f32", (256, 512))):
        m = re.search(r'extern\s+"C"\s+int\s+' + entry +
                      r'\s*\([^)]*\)\s*\{(.*?)\n\}', t3, flags=re.S)
        assert m and re.search(r"\bfwd_tf32x3<%d>.*\bfwd_tf32x3<%d>" % sizes,
                               m.group(1), flags=re.S), entry
    assert "flash_attention.cu" not in code
    for name, cc in code.items():
        for gone in ("flash_bwd_dq(", "flash_bwd_dkv(", "launch_dq(",
                     "launch_dkv(", "flash_bwd_dq_wide(",
                     "flash_bwd_dkv_wide(", "launch_dq_wide(",
                     "launch_dkv_wide(", "flash_fwd(", "flash_fwd_wide(",
                     "launch_fwd(", "launch_fwd_wide("):
            assert not re.search(r"\b" + re.escape(gone), cc), (name, gone)


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

    return rnd(heads), rnd(n_kv), rnd(n_kv), rnd(heads)


def _grads(q, k, v, do, cfg):
    """(kernel dq, dk, dv), (plain dq, dk, dv) from the kernel forward's
    o and lse."""
    o, lse = tat.flash_forward(q, k, v, *cfg)
    delta = (do * o).sum(-1, keepdim=True)
    got = (tat.flash_bwd_dq(q, k, v, do, lse, delta, *cfg),
           *tat.flash_bwd_dkv(q, k, v, do, lse, delta, *cfg))
    want = (tat.flash_bwd_dq_reference(q, k, v, do, lse, delta, *cfg),
            *tat.flash_bwd_dkv_reference(q, k, v, do, lse, delta, *cfg))
    return got, want


def _check(q, k, v, do, cfg, what):
    got, want = _grads(q, k, v, do, cfg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, (what, name)
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        assert err <= TOL * scale, (what, name, err, scale)


@pytest.mark.cuda
def test_f32_backward_matches_plain_on_the_card(cuda_card, monkeypatch):
    """hd 40, 64, 72, 100 and 128; causal, a window, shift -1 and
    non-causal; ragged s 130, 190 and 1000; 1, 2, 4 and 8 query heads a
    kv head, each (hd, s) meeting every mask; then hd 33 and an unaligned
    q, which take the plain-load staging.  Every call goes to the 3xTF32
    entries and adds one to each wrapper's count."""
    real = _build.lib()
    called = []

    class Spy:
        def __getattr__(self, name):
            if name.startswith("vtpu_flash_bwd"):
                called.append(name)
            return getattr(real, name)

    monkeypatch.setattr(_build, "lib", lambda: Spy())
    gen = torch.Generator(device=cuda_card).manual_seed(0)
    cfgs = ((True, 0, 0), (True, 0, 64), (True, -1, 0), (False, 0, 0))
    cases, i = [], 0
    for hd in (40, 64, 72, 100, 128):
        for s in (130, 190, 1000):
            for cfg in cfgs:
                g = (1, 2, 4, 8)[i % 4]
                i += 1
                cases.append((_inputs(gen, 1, 8, 8 // g, s, hd), cfg))
    cases.append((_inputs(gen, 2, 4, 2, 150, 33), (True, -1, 0)))
    q, k, v, do = _inputs(gen, 1, 2, 1, 256, 64)
    q_off = torch.empty(q.numel() + 1, device=cuda_card)[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 != 0
    cases.append(((q_off, k, v, do), (True, 0, 0)))
    n_dq, n_dkv = tat.flash_bwd_dq.launches, tat.flash_bwd_dkv.launches
    for j, ((q, k, v, do), cfg) in enumerate(cases):
        _check(q, k, v, do, cfg, (tuple(q.shape), tuple(k.shape), cfg))
        assert tat.flash_bwd_dq.launches == n_dq + j + 1
        assert tat.flash_bwd_dkv.launches == n_dkv + j + 1
    assert called == ["vtpu_flash_bwd_dq_f32",
                      "vtpu_flash_bwd_dkv_f32"] * len(cases)


@pytest.mark.cuda
def test_two_calls_give_the_same_bits(cuda_card):
    """No atomics: dq, dk and dv of two calls are equal bit for bit (8
    query heads over 2 kv heads, s 1024, hd 128, causal)."""
    gen = torch.Generator(device=cuda_card).manual_seed(1)
    q, k, v, do = _inputs(gen, 1, 8, 2, 1024, 128)
    o, lse = tat.flash_forward(q, k, v, True)
    delta = (do * o).sum(-1, keepdim=True)
    first = (tat.flash_bwd_dq(q, k, v, do, lse, delta, True),
             *tat.flash_bwd_dkv(q, k, v, do, lse, delta, True))
    second = (tat.flash_bwd_dq(q, k, v, do, lse, delta, True),
              *tat.flash_bwd_dkv(q, k, v, do, lse, delta, True))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wide_f32_backward_matches_plain_on_the_card(cuda_card, monkeypatch):
    """128 < hd <= 512: hd 132, 192, 256, 320 and 512 (both instances,
    and groups of columns past hd); causal, a window, shift -1 and
    non-causal; ragged s 130 and 400, and s 1100, where dq and dk/dv
    flush their sums; 1, 4 and 8 query heads a kv head, each (hd, s)
    meeting every mask; then hd 201, which takes the plain-load staging,
    and an unaligned q.  Every call goes to the wide 3xTF32 entries and
    adds one to each wrapper's count."""
    real = _build.lib()
    called = []

    class Spy:
        def __getattr__(self, name):
            if name.startswith("vtpu_flash_bwd"):
                called.append(name)
            return getattr(real, name)

    monkeypatch.setattr(_build, "lib", lambda: Spy())
    gen = torch.Generator(device=cuda_card).manual_seed(3)
    cfgs = ((True, 0, 0), (True, 0, 64), (True, -1, 0), (False, 0, 0))
    cases, i = [], 0
    for hd in (132, 192, 256, 320, 512):
        for s in (130, 400):
            for cfg in cfgs:
                g = (1, 4, 8)[i % 3]
                i += 1
                cases.append((_inputs(gen, 1, 8, 8 // g, s, hd), cfg))
    for hd in (256, 512):  # past a flush: s / 8 > 128 k-steps of keys
        cases.append((_inputs(gen, 1, 4, 1, 1100, hd), (True, 0, 0)))
    cases.append((_inputs(gen, 2, 4, 2, 150, 201), (True, -1, 0)))
    q, k, v, do = _inputs(gen, 1, 2, 1, 256, 192)
    q_off = torch.empty(q.numel() + 1, device=cuda_card)[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 != 0
    cases.append(((q_off, k, v, do), (True, 0, 0)))
    n_dq, n_dkv = tat.flash_bwd_dq.launches, tat.flash_bwd_dkv.launches
    for j, ((q, k, v, do), cfg) in enumerate(cases):
        _check(q, k, v, do, cfg, (tuple(q.shape), tuple(k.shape), cfg))
        assert tat.flash_bwd_dq.launches == n_dq + j + 1
        assert tat.flash_bwd_dkv.launches == n_dkv + j + 1
    assert called == ["vtpu_flash_bwd_dq_wide_f32",
                      "vtpu_flash_bwd_dkv_wide_f32"] * len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [256, 512])
def test_two_wide_calls_give_the_same_bits(cuda_card, hd):
    """No atomics above hd 128 either, and every warp of a slab adds the
    column groups' shares in one order: dq, dk and dv of two calls are
    equal bit for bit (8 query heads over 2 kv heads, s 1024, causal)."""
    gen = torch.Generator(device=cuda_card).manual_seed(4)
    q, k, v, do = _inputs(gen, 1, 8, 2, 1024, hd)
    o, lse = tat.flash_forward(q, k, v, True)
    delta = (do * o).sum(-1, keepdim=True)
    first = (tat.flash_bwd_dq(q, k, v, do, lse, delta, True),
             *tat.flash_bwd_dkv(q, k, v, do, lse, delta, True))
    second = (tat.flash_bwd_dq(q, k, v, do, lse, delta, True),
              *tat.flash_bwd_dkv(q, k, v, do, lse, delta, True))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_the_wrappers_raise_on_a_dtype_mix(cuda_card):
    gen = torch.Generator(device=cuda_card).manual_seed(2)
    q, k, v, do = _inputs(gen, 1, 2, 2, 128, 64)
    o, lse = tat.flash_forward(q, k, v, True)
    delta = (do * o).sum(-1, keepdim=True)
    with pytest.raises(TypeError):
        tat.flash_bwd_dq(q, k.bfloat16(), v, do, lse, delta, True)
    with pytest.raises(TypeError):
        tat.flash_bwd_dkv(q, k, v, do.bfloat16(), lse, delta, True)
