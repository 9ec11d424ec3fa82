"""The bf16 -> f32-out flash forward, ring attention's partials, on the
tensor cores: which C entry the wrapper calls and where that entry is
defined (on the CPU), and the kernel against its plain version at 2e-5
(on the card: ``python -m pytest tests/test_torch_flash_f32out_card.py
-m cuda``).  No JAX here: the card test runs where JAX is not."""

import re

import pytest
import torch

from vtpu_torch.ops import _build
from vtpu_torch.ops import attention as tat

TOL_F32 = 2e-5


def _code(path) -> str:
    text = open(path).read()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


@pytest.mark.parametrize("hd, entry", [
    (36, "vtpu_flash_fwd_bf16_f32out"),
    (64, "vtpu_flash_fwd_bf16_f32out"),
    (128, "vtpu_flash_fwd_bf16_f32out"),
    (192, "vtpu_flash_fwd_wide_bf16_f32out"),
    (512, "vtpu_flash_fwd_wide_bf16_f32out"),
])
def test_f32out_entry_by_head_dim(hd, entry):
    """Up to hd 128 the tensor-core entry, above it the chunked one."""
    suffix = tat._FWD_ENTRY[(torch.bfloat16, torch.float32)]
    assert tat._entry("flash_fwd", hd, suffix) == entry


def test_f32out_entry_runs_the_tensor_core_forward():
    """``vtpu_flash_fwd_bf16_f32out`` is defined in the tensor-core
    source and launches ``flash_fwd_tc`` with f32 o; so is the wide
    f32-out entry, which launches ``flash_fwd_split_tc`` (hd <= 256) and
    ``flash_fwd_wide_tc`` (above) with f32 o.  No other source defines
    the f32-out entries or the bf16 wide forward."""
    code = {p.rsplit("/", 1)[-1]: _code(p) for p in _build._sources()
            if p.endswith(".cu")}
    tc = code["flash_attention_sm90.cu"]

    def body(entry):
        m = re.search(r'extern\s+"C"\s+int\s+' + entry +
                      r'\s*\([^)]*\)\s*\{(.*?)\n\}', tc, flags=re.S)
        assert m, entry
        return m.group(1)

    assert "launch_fwd_tc<float>" in body("vtpu_flash_fwd_bf16_f32out")
    assert re.search(r"fwd_tc<64,\s*O>.*fwd_tc<128,\s*O>", tc, flags=re.S)
    assert "launch_fwd_wide_tc<float>" in body(
        "vtpu_flash_fwd_wide_bf16_f32out")
    assert "launch_fwd_wide_tc<bf16>" in body("vtpu_flash_fwd_wide_bf16")
    launch = re.search(r"int\s+launch_fwd_wide_tc\s*\([^)]*\)\s*\{(.*?)"
                       r"\n\}", tc, flags=re.S)
    assert launch and re.search(r"fwd_split_tc<O>.*fwd_wide_tc<512,\s*O>",
                                launch.group(1), flags=re.S)
    for kernel in ("fwd_split_tc", "fwd_wide_tc"):
        assert re.search(r"flash_" + kernel + r"<\w+,\s*O>", tc), kernel
    for name, cc in code.items():
        if name == "flash_attention_sm90.cu":
            continue
        for entry in ("vtpu_flash_fwd_bf16_f32out", "vtpu_flash_fwd_wide_bf16",
                      "vtpu_flash_fwd_wide_bf16_f32out"):
            assert not re.search(r"\b" + entry + r"\b", cc), (name, entry)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++)")
    from vtpu_torch.device import reference_numerics

    reference_numerics()
    return torch.device("cuda")


def _inputs(gen, b, heads, n_kv, s, hd, s_k=None):
    def rnd(h, n):
        return torch.randn(b, h, n, hd, device="cuda",
                           generator=gen).bfloat16()

    return rnd(heads, s), rnd(n_kv, s_k or s), rnd(n_kv, s_k or s)


def _check(q, k, v, cfg, what):
    o, lse = tat.flash_forward(q, k, v, *cfg, out_dtype=torch.float32)
    ro, rlse = tat.flash_attention_reference(q, k, v, *cfg,
                                             out_dtype=torch.float32)
    assert o.dtype == torch.float32 and o.shape == q.shape, what
    err = (o - ro).abs().max().item()
    assert err <= TOL_F32, (what, err)
    rel = ((lse - rlse).abs() / rlse.abs().clamp_min(1)).max().item()
    assert rel <= TOL_F32, (what, rel)


@pytest.mark.cuda
def test_f32out_forward_matches_plain_on_the_card(cuda_card, monkeypatch):
    """o within 2e-5 and lse within 2e-5 relative of the plain version
    at hd 64, 96 and 128; causal (shift 0 and -1) and non-causal; s 1024
    and 1000; 1 and 4 query heads a kv head; then a window, fewer
    queries than keys, head dims that take the plain-load staging (36,
    33) and an unaligned q.  Each call adds one to
    ``flash_forward.f32out_launches`` and calls the tensor-core entry;
    hd 192 still reaches the wide entry."""
    real = _build.lib()
    called = []

    class Spy:
        def __getattr__(self, name):
            called.append(name)
            return getattr(real, name)

    monkeypatch.setattr(_build, "lib", lambda: Spy())
    gen = torch.Generator(device=cuda_card).manual_seed(0)
    cases = []
    for hd in (64, 96, 128):
        for s in (1024, 1000):
            for g in (1, 4):
                for cfg in ((True, 0, 0), (True, -1, 0), (False, 0, 0)):
                    cases.append((_inputs(gen, 1, 8, 8 // g, s, hd), cfg))
    cases += [(_inputs(gen, 2, 8, 2, 333, 128), (True, -1, 100)),
              (_inputs(gen, 1, 4, 2, 100, 64, s_k=300), (False, 0, 0)),
              (_inputs(gen, 1, 2, 1, 150, 36), (True, 0, 0)),
              (_inputs(gen, 1, 2, 2, 77, 33), (True, -1, 0))]
    q, k, v = _inputs(gen, 1, 2, 1, 256, 64)
    q_off = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_card)[1:]
    q_off = q_off.view(q.shape).copy_(q)
    assert q_off.data_ptr() % 16 != 0
    cases.append(((q_off, k, v), (True, 0, 0)))
    n0 = tat.flash_forward.f32out_launches
    for i, ((q, k, v), cfg) in enumerate(cases):
        _check(q, k, v, cfg, (tuple(q.shape), tuple(k.shape), cfg))
        assert tat.flash_forward.f32out_launches == n0 + i + 1
    assert called == ["vtpu_flash_fwd_bf16_f32out"] * len(cases)
    called.clear()
    _check(*_inputs(gen, 1, 4, 1, 256, 192), (True, -1, 0), "hd 192")
    assert called == ["vtpu_flash_fwd_wide_bf16_f32out"]
    assert tat.flash_forward.f32out_launches == n0 + len(cases) + 1
