"""Package rules of the PyTorch port: it imports no JAX and nothing of
vtpu, its entry points refuse to run on a CPU they were not asked for,
and its CUDA kernels are tested on the card only."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "vtpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "vtpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts), path


def test_import_pulls_in_no_jax_and_no_vtpu():
    names = [name for name, _ in _modules()]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(names) >= 12


def test_no_source_imports_jax_flax_or_vtpu():
    offenders = []
    for name, path in _modules():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            offenders += [(name, m) for m in mods
                          if m.split(".")[0] in FORBIDDEN]
    assert not offenders


@pytest.mark.parametrize("entry", ["TransformerLM", "params_from_flax",
                                   "PagedBatcher", "generate",
                                   "cnn_params_from_flax", "create_model",
                                   "entry", "ShimRuntime",
                                   "stream_to_device", "share_forward",
                                   "ai_benchmark_step"])
def test_default_device_entry_points_refuse_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from vtpu_torch.models.convert import params_from_flax
    from vtpu_torch.models.transformer import TransformerLM, generate
    from vtpu_torch.serving.paged import PagedBatcher

    kw = dict(vocab=16, d_model=16, depth=1, num_heads=2, max_seq=16,
              kv_block_size=8, kv_pool_blocks=5)
    cpu_model = TransformerLM(**kw, device="cpu")
    from vtpu_torch.bench import ai_benchmark, share
    from vtpu_torch.entry import entry as graft_entry
    from vtpu_torch.models.convert import cnn_params_from_flax
    from vtpu_torch.models.registry import create_model
    from vtpu_torch.shim import ShimRuntime, stream_to_device

    calls = {
        "cnn_params_from_flax": lambda: cnn_params_from_flax({}),
        "create_model": lambda: create_model("lstm", hidden=4, embed=4),
        "entry": graft_entry,
        "ShimRuntime": lambda: ShimRuntime(limits_bytes=[]),
        "stream_to_device": lambda: stream_to_device(torch.zeros(2)),
        "share_forward": lambda: share.build_forward(batch=1, size=32),
        "ai_benchmark_step": lambda: ai_benchmark.build_step(
            "lstm", 1, "inference"),
        "TransformerLM": lambda: TransformerLM(**kw),
        "params_from_flax": lambda: params_from_flax(
            {"wte": {"embedding": np.zeros((2, 2), np.float32)}}),
        "PagedBatcher": lambda: PagedBatcher(cpu_model, max_batch=2),
        "generate": lambda: generate(cpu_model.clone(kv_pool_blocks=0),
                                     np.zeros((1, 2), np.int32), 2),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++)")
    from vtpu_torch.device import reference_numerics

    reference_numerics()
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card(cuda_card):
    """Each kernel against its plain version on the card (run on the GPU
    machine: ``python -m pytest tests/test_torch_package.py -m cuda``)."""
    from vtpu_torch.ops import layernorm as tln
    from vtpu_torch.ops import paged_attention as tpa
    from vtpu_torch.ops.quant import quantize_int8

    gen = torch.Generator(device=cuda_card).manual_seed(0)
    for rows, d in [(8, 4096), (37, 100), (3, 64)]:
        x = torch.randn(rows, d, device=cuda_card, generator=gen)
        g = torch.randn(d, device=cuda_card, generator=gen)
        b = torch.randn(d, device=cuda_card, generator=gen)
        err = (tln.fused_layernorm(x, g, b)
               - tln._reference_ln(x, g, b)).abs().max().item()
        assert err <= 2e-5
    # one split and several; block sizes below and at the tile width;
    # hd 256, whose K and V tiles take turns in one stage; 16 and 32
    # query heads a kv head
    for bsz, nh, n_kv, hd, bs, nb in [(3, 8, 2, 64, 16, 4),
                                      (4, 32, 8, 128, 16, 64),
                                      (2, 4, 4, 32, 8, 80),
                                      (4, 4, 1, 256, 16, 20),
                                      (4, 32, 2, 64, 16, 20),
                                      (4, 32, 1, 32, 16, 20)]:
        P = 1 + bsz * nb
        q = torch.randn(bsz, nh, hd, device=cuda_card, generator=gen)
        k = torch.randn(P, n_kv, bs, hd, device=cuda_card, generator=gen)
        v = torch.randn(P, n_kv, bs, hd, device=cuda_card, generator=gen)
        tables = (torch.randperm(P - 1, device=cuda_card, generator=gen)
                  + 1).to(torch.int32).reshape(bsz, nb)
        lengths = torch.tensor([0, bs, nb * bs + 3, nb * bs // 2 + 5][:bsz],
                               dtype=torch.int32, device=cuda_card)
        got = tpa.paged_attention_decode(q, k, v, tables, lengths)
        want = tpa.paged_attention_reference(q, k, v, tables, lengths)
        assert (got - want).abs().max().item() <= 2e-5
        kq, vq = quantize_int8(k, axis=-1), quantize_int8(v, axis=-1)
        args = (q, kq.q, vq.q, tables, lengths, kq.scale, vq.scale)
        err = (tpa.paged_attention_decode(*args)
               - tpa.paged_attention_reference(*args)).abs().max().item()
        assert err <= 2e-5
    _flash_kernels_match_plain(cuda_card, gen)


@pytest.mark.cuda
def test_bf16_layernorm_matches_plain_on_the_card(cuda_card):
    """The bf16 LayerNorm kernel against ``_reference_ln`` within two bf16
    ulps at the output's scale: the train path's rows (8192 x 4096), a
    decode batch (8 x 4096), the widest row of the register path (d 8192)
    and rows that take the shared-memory path (d 100 and d 33, whose
    width is no whole number of 16-byte chunks; an x that is not 16-byte
    aligned; d 8200, wider than the register path).  Two calls give the
    same bits."""
    from vtpu_torch.ops import layernorm as tln

    gen = torch.Generator(device=cuda_card).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda_card, generator=gen)

    cases = [(3 * rnd(rows, d) + 1).bfloat16()
             for rows, d in [(8192, 4096), (8, 4096), (5, 8192), (37, 100),
                             (9, 33), (3, 8200), (64, 4096)]]
    x = cases.pop()
    x_off = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_card)[1:]
    x_off = x_off.view(x.shape).copy_(x)
    assert x_off.data_ptr() % 16 != 0
    cases.append(x_off)
    for x in cases:
        d = x.shape[-1]
        g = (1 + 0.1 * rnd(d)).bfloat16()
        b = (0.1 * rnd(d)).bfloat16()
        got = tln.fused_layernorm(x, g, b)
        assert got.dtype == torch.bfloat16
        assert _bf16_ulps(got, tln._reference_ln(x, g, b)) <= 2, x.shape
        assert torch.equal(got, tln.fused_layernorm(x, g, b)), x.shape


PAGED_KERNEL_LENGTHS = [0, 16, 4095, 1023, 777, 2048, 31, 3000]


def _unaligned(t):
    """A copy of ``t`` whose data does not start on 16 bytes."""
    off = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    off = off.view(t.shape).copy_(t)
    assert off.data_ptr() % 16 != 0
    return off


def _check_paged_bf16(dev, gen, b, nh, n_kv, hd, bs, nb, lengths, quant,
                      unaligned=False):
    from vtpu_torch.ops import paged_attention as tpa
    from vtpu_torch.ops.quant import quantize_int8

    P = 1 + b * nb
    q = torch.randn(b, nh, hd, device=dev, generator=gen).bfloat16()
    k = torch.randn(P, n_kv, bs, hd, device=dev, generator=gen)
    v = torch.randn(P, n_kv, bs, hd, device=dev, generator=gen)
    tables = (torch.randperm(P - 1, device=dev, generator=gen)
              + 1).to(torch.int32).reshape(b, nb)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if quant:
        kq, vq = quantize_int8(k, axis=-1), quantize_int8(v, axis=-1)
        pools, scales = (kq.q, vq.q), (kq.scale, vq.scale)
    else:
        pools, scales = (k.bfloat16(), v.bfloat16()), ()
    if unaligned:
        pools = tuple(_unaligned(p) for p in pools)
    args = (q, *pools, tables, lengths, *scales)
    what = (b, nh, n_kv, hd, bs, nb, quant, unaligned)
    got = tpa.paged_attention_decode(*args)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, tpa.paged_attention_reference(*args)) <= 2, what
    assert torch.equal(got, tpa.paged_attention_decode(*args)), what


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
def test_bf16_paged_kernels_match_plain_on_the_card(cuda_card, quant):
    """The paged kernel with a bf16 q over native bf16 pools and over int8
    pools, within two bf16 ulps at the output's scale: the kernel-phase
    shape of chip_smoke.py; hd 36 and hd 40, which are no whole number of
    16-byte vectors in one of the two pool types and take the plain-load
    staging there; block sizes 32 and 64; 32, 8 and 1 query heads a kv
    head;
    a row whose position overshoots nb_max * bs - 1; pools that are not
    16-byte aligned.  Two calls give the same bits."""
    gen = torch.Generator(device=cuda_card).manual_seed(1)
    for case in [(8, 32, 8, 128, 16, 256, PAGED_KERNEL_LENGTHS),
                 (3, 8, 2, 36, 16, 12, [0, 100, 12 * 16 + 5]),
                 (3, 8, 2, 40, 16, 12, [17, 191, 64]),
                 (2, 8, 2, 128, 32, 20, [20 * 32 + 7, 300]),
                 (2, 8, 2, 128, 64, 10, [639, 64]),
                 (2, 16, 2, 64, 16, 40, [639, 5]),
                 (2, 4, 4, 256, 16, 40, [1, 600]),
                 (2, 32, 1, 32, 16, 20, [300, 7])]:
        _check_paged_bf16(cuda_card, gen, *case, quant)
    _check_paged_bf16(cuda_card, gen, 2, 8, 2, 128, 16, 40, [639, 200],
                      quant, unaligned=True)


FLASH_SHAPES = [  # q shape, kv heads, causal, shift, window, o dtype
    ((2, 8, 256, 128), 2, True, 0, 0, None),
    ((192, 64), 1, False, 0, 0, None),
    ((1, 4, 200, 64), 4, True, 0, 0, None),
    ((1, 4, 300, 32), 1, True, 0, 70, None),
    ((1, 2, 256, 128), 2, True, -1, 0, torch.float32),
    ((1, 2, 130, 40), 2, False, 0, 0, None)]


def _flash_inputs(dev, gen, q_shape, n_kv, dtype=torch.float32, s_k=None):
    kv_shape = q_shape if len(q_shape) == 2 else (
        q_shape[0], n_kv, *q_shape[2:])
    if s_k is not None:
        kv_shape = (*kv_shape[:-2], s_k, kv_shape[-1])
    q, do = (torch.randn(q_shape, device=dev, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(kv_shape, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    return q, k, v, do


def _bf16_ulps(got, want):
    """max |got - want| in bf16 ulps at want's scale (its largest
    magnitude), as chip_smoke.py's tolerance counts them."""
    want = want.float()
    scale = want.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale else 1.0
    return (got.float() - want).abs().max().item() / ulp


def _flash_bf16_kernels_match_plain(dev, gen):
    """The bf16 kernels (the tensor-core forward, dq and dk/dv) on the
    shapes above, less the f32-o row, which stays on the
    CUDA-core forward, plus s 1000 at hd 128, head dims that take the
    plain-load staging (36, and 33 under shift -1), a window under
    shift -1 with GQA, fewer queries than keys, and a q that is not
    16-byte aligned: o, dq, dk and dv within two bf16 ulps at the
    output's scale, lse within 2e-5 relative."""
    shapes = [s for s in FLASH_SHAPES if s[-1] is None]
    shapes += [((1, 4, 1000, 128), 2, True, 0, 0, None),
               ((1, 2, 150, 36), 1, True, 0, 0, None),
               ((1, 2, 77, 33), 2, True, -1, 0, None)]
    shapes.append(((2, 8, 333, 128), 2, True, -1, 100, None))
    for q_shape, n_kv, causal, shift, window, _out in shapes:
        _check_bf16(*_flash_inputs(dev, gen, q_shape, n_kv, torch.bfloat16),
                    (causal, shift, window))
    _check_bf16(*_flash_inputs(dev, gen, (1, 4, 100, 64), 2, torch.bfloat16,
                               s_k=300), (False, 0, 0))
    q, k, v, do = _flash_inputs(dev, gen, (1, 2, 256, 64), 1,
                                torch.bfloat16)
    q_off = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:]
    q_off = q_off.view(q.shape).copy_(q)
    assert q_off.data_ptr() % 16 != 0
    _check_bf16(q_off, k, v, do, (True, 0, 0))


def _check_bf16(q, k, v, do, cfg):
    from vtpu_torch.ops import attention as tat

    what = (tuple(q.shape), tuple(k.shape), cfg)
    o, lse = tat.flash_forward(q, k, v, *cfg)
    ro, rlse = tat.flash_attention_reference(q, k, v, *cfg)
    assert o.dtype == torch.bfloat16
    assert _bf16_ulps(o, ro) <= 2, what
    assert ((lse - rlse).abs() / rlse.abs().clamp_min(1)).max() <= 2e-5
    delta = (do.float() * ro.float()).sum(-1, keepdim=True)
    dq = tat.flash_bwd_dq(q, k, v, do, rlse, delta, *cfg)
    rdq = tat.flash_bwd_dq_reference(q, k, v, do, rlse, delta, *cfg)
    assert _bf16_ulps(dq, rdq) <= 2, what
    dk, dv = tat.flash_bwd_dkv(q, k, v, do, rlse, delta, *cfg)
    rdk, rdv = tat.flash_bwd_dkv_reference(q, k, v, do, rlse, delta, *cfg)
    assert _bf16_ulps(dk, rdk) <= 2, what
    assert _bf16_ulps(dv, rdv) <= 2, what


def _flash_kernels_match_plain(dev, gen):
    """Forward, dq and dk/dv against their plain versions in f32: GQA,
    MHA in 2D, a ragged length, a window, the strict mask (shift -1, f32
    o) and head dims below and at the widest tile; then the bf16 pass."""
    from vtpu_torch.ops import attention as tat

    for q_shape, n_kv, causal, shift, window, out in FLASH_SHAPES:
        q, k, v, do = _flash_inputs(dev, gen, q_shape, n_kv)
        cfg = (causal, shift, window)
        o, lse = tat.flash_forward(q, k, v, *cfg, out_dtype=out)
        ro, rlse = tat.flash_attention_reference(q, k, v, *cfg,
                                                 out_dtype=out)
        assert (o - ro).abs().max().item() <= 2e-5
        assert ((lse - rlse).abs() / rlse.abs().clamp_min(1)).max() <= 2e-5
        delta = (do * ro).sum(-1, keepdim=True)
        dq = tat.flash_bwd_dq(q, k, v, do, rlse, delta, *cfg)
        rdq = tat.flash_bwd_dq_reference(q, k, v, do, rlse, delta, *cfg)
        assert (dq - rdq).abs().max() <= 1e-4 * rdq.abs().max()
        dk, dv = tat.flash_bwd_dkv(q, k, v, do, rlse, delta, *cfg)
        rdk, rdv = tat.flash_bwd_dkv_reference(q, k, v, do, rlse, delta,
                                               *cfg)
        assert (dk - rdk).abs().max() <= 1e-4 * rdk.abs().max()
        assert (dv - rdv).abs().max() <= 1e-4 * rdv.abs().max()
    _flash_bf16_kernels_match_plain(dev, gen)
    # shapes the kernels would read out of bounds raise instead
    q = torch.randn(2, 4, 64, 32, device=dev, generator=gen)
    k = torch.randn(2, 2, 64, 32, device=dev, generator=gen)
    lse = torch.zeros(2, 4, 64, 1, device=dev)
    for args in [(q, k, k[:, :, :32]), (q, k[:1], k[:1]),
                 (q, k, k, q[:, :, :32], lse, lse)]:
        fn = tat.flash_forward if len(args) == 3 else tat.flash_bwd_dq
        with pytest.raises(ValueError):
            fn(*args)


@pytest.mark.cuda
def test_lstm_reads_its_weights_in_place_on_the_card(cuda_card):
    """The bf16 LSTM's weights are one buffer in cuDNN's own layout (the
    offsets that ``nn.LSTM.flatten_parameters`` gives), so neither an
    inference nor a training step warns of a repack, and the output is
    ``nn.LSTM``'s on the same bf16 weights."""
    import warnings

    from vtpu_torch.models.lstm import LSTMClassifier

    def offsets(ws):
        return [(w.data_ptr() - ws[0].data_ptr()) // w.element_size()
                for w in ws]

    model = LSTMClassifier(hidden=64, vocab=50, embed=32, device=cuda_card)
    # torch flattens an f32 LSTM only (cuDNN's accepted dtypes exclude
    # bf16): its element offsets are cuDNN's layout
    flat = torch.nn.LSTM(32, 64, batch_first=True, device=cuda_card)
    ref = torch.nn.LSTM(32, 64, batch_first=True, device=cuda_card,
                        dtype=torch.bfloat16)
    with torch.no_grad():
        views = model._weights()
        for name, w in zip(ref._flat_weights_names, views):
            getattr(ref, name).copy_(w)
    assert offsets(views) == offsets(flat._flat_weights)
    assert len({w.untyped_storage().data_ptr()
                for w in flat._flat_weights}) == 1
    tokens = torch.randint(0, 50, (3, 7), device=cuda_card)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            logits, _ = model(tokens)
        model(tokens)[0].sum().backward()
    assert not [w for w in caught if "contiguous chunk" in str(w.message)]
    assert model.OptimizedLSTMCell_0.weight_hh_l0.grad is not None
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the bf16 nn.LSTM repacks
        y, _ = ref(model.Embed_0(tokens).bfloat16())
        want = model.Dense_0(y[:, -1]).float()
    assert torch.equal(logits, want)
