#!/usr/bin/env python3
"""Drive the PyTorch port's paged serving and training paths, its
ai-benchmark rows and its four-tenant share run on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, full width (one card)

Phases (each prints one JSON line; any failure exits non-zero):

0. the card's name and power limit (nvidia-smi), and the build of the
   CUDA kernels from ``vtpu_torch/csrc`` (nvcc, sm_90a) with its seconds
   and, for each flash and paged kernel, its registers, stack bytes,
   local loads and stores and tensor-core instructions (HMMA / HGMMA),
   all from one ``cuobjdump -res-usage -sass`` of the library, so a
   reused build reports the same; the tensor-core and paged kernels must
   spill nothing, and the tensor-core kernels must hold such
   instructions;
1. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (the paged kernels at the kernel
   phase's lengths and at the serve phase's): max abs error against the stated
   tolerance, kernel/plain/library times (CUDA events, median of 30
   after warm-up, with the device held busy first so that the calls are
   queued and each time is the device's) and the least time the card
   could take (bound);
2. the serving path at full width -- TransformerLM with the widths of
   docs/workloads.md (vocab 32000, d_model 4096, depth 32, 32 heads, 8 kv
   heads, rope), seeded random bf16 weights, PagedBatcher(max_batch=8)
   over a 1 + 8*256 block pool -- once with a native pool and once with
   an int8 pool, 16 requests each, each decode window one CUDA graph
   replay after the first window of its length (eager, then captured);
   every kernel's launch count is set to 0 just before each run and read
   just after, a replay adding the launches its graph holds;
3. torch.profiler over one admission round and four (graphed) decode
   steps at full width: device busy time, wall time, idle share and the
   kernels that take the most device time; paged_partial must be among
   the decode steps' kernels;
4. exactness: depth 2, f32, the kernel path against the plain path
   (paged_kernel="off", ln_kernel="off") and graphed windows against
   eager ones (decode_graph="off"), greedy tokens identical; the count of
   full-depth bf16 serve tokens that differ between graphed and eager
   windows (expected 0); and, as information, the share of tokens on
   which the full-depth bf16 kernel and plain paths agree;
5. (with phase 1) the flash-attention kernels -- forward, dq, dk/dv --
   against their plain versions at the training path's shape (b 2, 32
   heads, 8 kv heads, s 4096, hd 128, causal) in bf16 and f32, with the
   library time of scaled_dot_product_attention and of its backward, and
   correctness rows at s 1024 (window 256, shift -1 with f32 o, ragged
   s 1000); ``err_to_tol`` is the worst output's error over its own
   tolerance (dk and dv each against their own scale); and the bf16 ->
   f32-out forward timed at the training path's shape; then one small
   row per head dim or group that only the chunked and head-grouped
   kernels take (``shape: "wide_heads"``: paged at g 8 / hd 256, g 4 /
   hd 512, g 1 / hd 512, g 32 / hd 128; flash at hd 192, 256, 512);
6. the training path at full width (the same widths, attn_window 4096,
   depth 16, bf16, b 2 x s 4096): TransformerLM(tokens, decode=False),
   lm_loss, backward and torch.optim.Adam(lr=1e-4), 4 steps on one
   seeded batch -- loss, step ms, tokens/s, peak memory and the launch
   counts of every step -- then torch.profiler over one more step;
7. training exactness: depth 2, b 1 x s 1024, the kernel path against
   clone(flash_kernel="off", ln_kernel="off"); in f32 the loss within
   1e-5 relative and every grad within 1e-4 of its max |grad|; in bf16
   (where the tensor-core kernels round p and dS to bf16) the loss within
   1e-2 relative and every grad's cosine similarity with the plain
   path's at least 0.99;
8. the kernels at the ai-benchmark transformer rows' shapes, at b 8 and
   b 4 (LayerNorm over b * 512 rows of 512; bf16 flash forward, dq and
   dk/dv, 8 heads, s 512, hd 64, causal) with plain, SDPA and bound
   times (``shape: "ai_transformer_b8"`` / ``"_b4"``); then every
   ai-benchmark row (``vtpu_torch.bench.ai_benchmark.ROWS``) at its
   batch and mode in bf16: img/s over a 1.5 s window of waited-for
   steps, peak memory, no cuDNN repack of the LSTM's weights, and for
   the transformer rows the kernels' launches (checked against one
   forward a layer, dq and dk/dv a layer in training, 2 * depth + 1
   LayerNorms a step); then ResNetV2_50 in f32 at batch 2, 224^2 on the
   card against the port on the CPU (logits and batch statistics within
   1e-3 of their scale);
9. the share run (``vtpu_torch.bench.share.run``): bf16 ResNet-V2-50 at
   batch 50, 224^2, the exclusive arm (one stream) and four tenants
   (``ShimRuntime`` each, one region, a stream and a thread each) over
   6 s each, eager and with each tenant's forward one CUDA graph replay,
   and the eager share without the runtime: img/s per tenant, summed /
   exclusive, quota violations (must be 0), the region's proc slots and
   bytes read back (must be the four tenants and their resident bytes),
   the device idle share of each arm's own window (device-only tracing)
   and the step's host and device times; and a tenant at 50 % whose duty
   (its rate over its rate at 100 %), eager and graphed, must be within
   0.15 of 0.5, beside the duty that the reference's pacing rule gives;
   ``share.run`` also runs the four-process arm, which phase 10 checks;
10. the GPU node path: ``NvmlProvider`` lists this card with nvidia-smi's
   UUID and memory and finds it healthy; the CUDA driver-API interposer
   (``vtpu_torch/native``) builds with g++ from the repo's sources; then
   plain PyTorch tenants (``vtpu_torch.bench.tenant``) under its
   ``LD_PRELOAD``, each with the env the device plugin writes at Allocate
   (``PJRT_*``): a quota tenant at 8192 MiB meets
   ``torch.OutOfMemoryError`` while NVML still shows > 40 GB free on the
   card, with ``mem_get_info`` and NVML inside the tenant reporting the
   quota and the region's peak within it;
   the paged serve path (depth 4, decode graphs) gives the same tokens as
   the same run without the interposer; a graphed ResNet-V2-50 tenant at
   core limit 50 holds a device busy share (from its own traced window)
   within 0.15 of 0.5, its rate beside the same tenant's at 100; the
   four-process share arm (``share.run_processes``, run by phase 9's
   ``share.run``), eager and graphed, 16 GiB and core limit 100 each:
   per-tenant, summed and exclusive img/s and the ratio (the reference's
   0.95 printed beside it, not asserted), 0 violations, four live region
   slots each holding its tenant's reserved memory, its context's charge
   and what libraries allocated outside PyTorch's allocator (at most
   256 MiB); and the interposer's cost per launch and per allocation pair
   (``vgpu_hook_bench``, with and without it, in turns).

Ends with the ``kernels`` line, the nvidia-smi line, and
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero with
no result when CUDA is absent or the ``vtpu_torch`` package is not
beside this script.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores
            "bfloat16": 989e12,    # dense tensor cores
            "int8": 1979e12}
TOL_F32 = 2e-5                     # as tests/test_paged.py
HOLD_CYCLES = 40_000_000           # ~20 ms at the H100's 1.98 GHz clock
LN_D = 4096


def emit(**doc) -> None:
    print(json.dumps(doc), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        print(f"chip_smoke: FAILED: {what}", file=sys.stderr, flush=True)
        sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of one call (CUDA events around each call).
    The device is held busy first, so the host has queued the calls
    before the device reaches them: a call whose Python side takes longer
    than its kernels (the LN wrapper's does at 8192 x 4096) is timed by
    its kernels, not by the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    pairs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def bf16_tol(ref) -> float:
    """Two bf16 ulps at the output's scale."""
    import math

    scale = float(ref.abs().max())
    return 2.0 * 2.0 ** (math.floor(math.log2(scale)) - 7) if scale else 0.0


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- phase 0: what the build made ------------------------------------------
TENSOR_CORE_KERNELS = ("flash_fwd_tc", "flash_dq_tc", "flash_dkv_tc")
PAGED_KERNELS = ("paged_partial", "paged_combine")


def _short(sym: str) -> str:
    """``flash_bwd_dq<bf16,128>``- or ``paged_partial<bf16,i8,true,4,4>``-
    style name of a mangled kernel symbol."""
    m = re.search(r"((?:flash|paged)_[a-z_]+?)I(\w+?)EE+v", sym)
    if not m:
        return sym
    args = []
    for a in re.finditer(r"13__nv_bfloat16|S\d*_|Lb([01])E|Li(\d+)E?|[fa]",
                         m.group(2)):
        tok = a.group(0)
        if tok.startswith("S"):     # a substitution: the type just named
            args.append(args[-1] if args else tok)
        elif tok.startswith("Lb"):
            args.append("true" if a.group(1) == "1" else "false")
        elif tok.startswith("Li"):
            args.append(a.group(2))
        else:
            args.append({"13__nv_bfloat16": "bf16", "f": "f32",
                         "a": "i8"}[tok])
    return f"{m.group(1)}<{','.join(args)}>"


def parse_cuobjdump(text: str) -> dict:
    """Per flash and paged kernel in ``cuobjdump -res-usage -sass`` output:
    ``registers`` and ``stack_bytes`` (REG and STACK; ptxas spills into
    the stack frame), ``local_ops`` (LDL / STL in its SASS, the spill
    loads and stores) and ``tensor_core_ops`` (HMMA / HGMMA)."""
    out, row = {}, None
    for line in text.splitlines():
        # "Function name:" in the resource usage, "Function : name" in SASS
        m = re.match(r"\s*Function\s*:?\s*(\S+?):?\s*$", line)
        if m:
            row = None
            if re.search(r"flash|paged_(partial|combine)", m.group(1)):
                row = out.setdefault(_short(m.group(1)), {
                    "registers": None, "stack_bytes": None,
                    "local_ops": 0, "tensor_core_ops": 0})
            continue
        if row is None:
            continue
        for key, pat in (("registers", r"\bREG:(\d+)"),
                         ("stack_bytes", r"\bSTACK:(\d+)")):
            m = re.search(pat, line)
            if m:
                row[key] = int(m.group(1))
        row["local_ops"] += bool(re.search(r"\b(LDL|STL)\b", line))
        row["tensor_core_ops"] += bool(re.search(r"\bHG?MMA\b", line))
    return out


def kernel_build_report(so_path: str, nvcc_dir: str) -> dict:
    """:func:`parse_cuobjdump` of the loaded library: the same whether
    this process built it or reused an earlier build."""
    res = subprocess.run(
        [os.path.join(nvcc_dir, "cuobjdump"), "-res-usage", "-sass", so_path],
        capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump: {res.stderr.strip()}")
    return parse_cuobjdump(res.stdout)


def build_failures(report: dict) -> list:
    """Each tensor-core kernel and each paged kernel must be in the
    library and spill nothing (no stack frame, no LDL / STL); the
    tensor-core kernels must hold tensor-core instructions."""
    bad = []
    for name in TENSOR_CORE_KERNELS + PAGED_KERNELS:
        rows = {k: r for k, r in report.items() if name in k}
        if not rows:
            bad.append(f"{name}: not in the library")
        for k, r in rows.items():
            if name in TENSOR_CORE_KERNELS and not r["tensor_core_ops"]:
                bad.append(f"{k}: no tensor-core instructions in its SASS")
            if r["stack_bytes"] != 0 or r["local_ops"]:
                bad.append(f"{k}: spills (stack {r['stack_bytes']} bytes, "
                           f"{r['local_ops']} local loads/stores)")
    return bad


# -- phase 1: kernels against their plain versions ------------------------
def layernorm_phase(card: str, gen) -> dict:
    import torch
    import torch.nn.functional as F

    from vtpu_torch.ops.layernorm import _reference_ln, fused_layernorm

    summary = None
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (8, 8 * 1024):
            x = torch.randn(rows, LN_D, device="cuda", generator=gen) * 3 + 1
            g = 1 + 0.1 * torch.randn(LN_D, device="cuda", generator=gen)
            b = 0.1 * torch.randn(LN_D, device="cuda", generator=gen)
            x, g, b = x.to(dtype), g.to(dtype), b.to(dtype)
            got = fused_layernorm(x, g, b)
            ref = _reference_ln(x, g, b)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tol = TOL_F32 if dtype == torch.float32 else bf16_tol(ref.float())
            elt = x.element_size()
            nbytes = 2 * rows * LN_D * elt + 2 * LN_D * elt
            b_ms, b_by = bound(nbytes, 9.0 * rows * LN_D,
                               str(dtype).split(".")[1])
            row = dict(
                phase="kernel", kernel="fused_layernorm", rows=rows, d=LN_D,
                dtype=str(dtype).split(".")[1], max_abs_err=err, tol=tol,
                ms=time_ms(lambda: fused_layernorm(x, g, b)),
                plain_ms=time_ms(lambda: _reference_ln(x, g, b)),
                library_ms=time_ms(lambda: F.layer_norm(x, (LN_D,), g, b,
                                                        1e-6)),
                bound_ms=b_ms, bound_by=b_by, card=card)
            emit(**row)
            check(err <= tol, f"layernorm {row['dtype']} rows={rows}: "
                              f"err {err} > {tol}")
            if dtype == torch.bfloat16 and rows == 8 * 1024:
                summary = row
    return summary


PAGED = dict(b=8, heads=32, kv_heads=8, hd=128, block=16, nb_max=256)
# 0, a block boundary, the last slot, and ragged lengths between
KERNEL_LENGTHS = [0, 16, 4095, 1023, 777, 2048, 31, 3000]


def serve_lengths(seed: int) -> list:
    """The positions the serving path gives the kernel: the first eight
    prompts of the serve phase, 16 tokens into their decode."""
    return [len(p) + 16 for _rid, p, _n in make_requests(seed)[:8]]


def paged_inputs(gen, dtype, quant: bool, lengths, geom=None):
    import torch

    from vtpu_torch.ops.quant import quantize_int8

    b, nh, n_kv, hd, bs, nb_max = (dict(geom or PAGED)[k] for k in (
        "b", "heads", "kv_heads", "hd", "block", "nb_max"))
    P = 1 + b * nb_max
    q = torch.randn(b, nh, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(P, n_kv, bs, hd, device="cuda", generator=gen)
    v = torch.randn(P, n_kv, bs, hd, device="cuda", generator=gen)
    perm = torch.randperm(P - 1, device="cuda", generator=gen) + 1
    tables = perm.to(torch.int32).reshape(b, nb_max)  # shuffled blocks
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if quant:
        kq, vq = quantize_int8(k, axis=-1), quantize_int8(v, axis=-1)
        return (q, kq.q, vq.q, tables, lengths, kq.scale, vq.scale)
    return (q, k.to(dtype), v.to(dtype), tables, lengths)


def paged_bytes_ops(args, quant: bool):
    q, kp, _vp, _tables, lengths = args[:5]
    _p, n_kv, bs, hd = kp.shape
    keys = int((lengths.long() + 1).sum())  # valid keys this data holds
    blocks = int((lengths.long() // bs + 1).sum())
    kv_elt = kp.element_size()
    nbytes = (2 * q.numel() * q.element_size()          # q in, out
              + 2 * keys * n_kv * hd * kv_elt           # valid K and V
              + 4 * blocks + 4 * q.shape[0])            # table, lengths
    if quant:
        nbytes += 2 * keys * n_kv * 4                   # K and V scales
    ops = 4.0 * keys * q.shape[1] * hd                  # QK^T and PV
    return nbytes, ops


def paged_phase(card: str, gen, seed: int) -> dict:
    """Both paged kernels in f32 and bf16 at the kernel-phase lengths and
    at the serving path's; returns the kernel-phase bf16 rows."""
    import torch

    from vtpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference)

    summary = {}
    for shape, lengths in (("kernel", KERNEL_LENGTHS),
                           ("serve", serve_lengths(seed))):
        for quant in (False, True):
            name = "paged_decode_q8" if quant else "paged_decode"
            for dtype in (torch.float32, torch.bfloat16):
                args = paged_inputs(gen, dtype, quant, lengths)
                got = paged_attention_decode(*args)
                ref = paged_attention_reference(*args)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                tol = (TOL_F32 if dtype == torch.float32
                       else bf16_tol(ref.float()))
                nbytes, ops = paged_bytes_ops(args, quant)
                b_ms, b_by = bound(nbytes, ops, "int8" if quant
                                   else str(dtype).split(".")[1])
                row = dict(
                    phase="kernel", kernel=name, shape=shape, **PAGED,
                    lengths=lengths, dtype=str(dtype).split(".")[1],
                    max_abs_err=err, tol=tol,
                    ms=time_ms(lambda: paged_attention_decode(*args)),
                    plain_ms=time_ms(
                        lambda: paged_attention_reference(*args)),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by,
                    card=card)
                emit(**row)
                check(err <= tol, f"{name} {shape} {row['dtype']}: "
                                  f"err {err} > {tol}")
                if dtype == torch.bfloat16 and shape == "kernel":
                    summary[name] = row
    return summary


# head dims and query-head groups beyond the kernels' register tiles (the
# chunked flash kernels, the paged kernel's head groups and smaller
# tiles): one small row each, error against the plain version, times and
# bound
WIDE_PAGED = [dict(b=4, heads=2 * g, kv_heads=2, hd=hd, block=16, nb_max=64)
              for g, hd in ((8, 256), (4, 512), (1, 512), (32, 128))]
WIDE_PAGED_LENGTHS = [0, 300, 1023, 517]
WIDE_FLASH = [dict(b=1, heads=8, kv_heads=2, s=512, hd=hd)
              for hd in (192, 256, 512)]


def wide_heads_phase(card: str, gen) -> None:
    """The paged kernels at (g 8, hd 256), (g 4, hd 512), (g 1, hd 512)
    and (g 32, hd 128), native and int8, f32 and bf16 q; the flash
    forward, dq and dk/dv at hd 192, 256 and 512 in f32 and bf16."""
    import torch

    from vtpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference)

    for geom in WIDE_PAGED:
        for quant in (False, True):
            name = "paged_decode_q8" if quant else "paged_decode"
            for dtype in (torch.float32, torch.bfloat16):
                args = paged_inputs(gen, dtype, quant, WIDE_PAGED_LENGTHS,
                                    geom)
                got = paged_attention_decode(*args)
                ref = paged_attention_reference(*args)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                tol = (TOL_F32 if dtype == torch.float32
                       else bf16_tol(ref.float()))
                nbytes, ops = paged_bytes_ops(args, quant)
                b_ms, b_by = bound(nbytes, ops, "int8" if quant
                                   else str(dtype).split(".")[1])
                row = dict(
                    phase="kernel", kernel=name, shape="wide_heads", **geom,
                    g=geom["heads"] // geom["kv_heads"],
                    lengths=WIDE_PAGED_LENGTHS,
                    dtype=str(dtype).split(".")[1], max_abs_err=err,
                    tol=tol, ms=time_ms(lambda: paged_attention_decode(*args)),
                    plain_ms=time_ms(
                        lambda: paged_attention_reference(*args)),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by,
                    card=card)
                emit(**row)
                check(err <= tol, f"{name} {geom} {row['dtype']}: "
                                  f"err {err} > {tol}")
    for geom in WIDE_FLASH:
        for dtype in (torch.float32, torch.bfloat16):
            flash_check(gen, dtype, geom, time_it=True, card=card,
                        shape_tag="wide_heads")


# -- phase 5: the flash-attention kernels ----------------------------------
FLASH = dict(b=2, heads=32, kv_heads=8, s=4096, hd=128)


def flash_work(b, heads, s_q, s_k, hd, causal, shift=0, window=0):
    """Kept (query, key) pairs of this mask: the pairs the kernels'
    arithmetic needs (fully masked tiles are skipped)."""
    import torch

    if not causal:
        return b * heads * s_q * s_k
    q = torch.arange(s_q, dtype=torch.float64)[:, None] + shift
    k = torch.arange(s_k, dtype=torch.float64)[None, :]
    keep = k <= q
    if window > 0:
        keep &= k > q - window
    return b * heads * int(keep.sum())


def flash_inputs(gen, dtype, b, heads, kv_heads, s, hd):
    import torch

    def rnd(h):
        return torch.randn(b, h, s, hd, device="cuda",
                           generator=gen).to(dtype)

    return rnd(heads), rnd(kv_heads), rnd(kv_heads), rnd(heads)


def flash_check(gen, dtype, shape, causal=True, shift=0, window=0,
                out_dtype=None, time_it=False, card="", shape_tag=None):
    """Forward, dq and dk/dv kernels against their plain versions on the
    same inputs (the backward from the kernel's own o and lse).  Returns
    one row per kernel."""
    import torch
    import torch.nn.functional as F

    from vtpu_torch.ops import attention as tat

    q, k, v, do = flash_inputs(gen, dtype, **shape)
    cfg = (causal, shift, window)
    dt = str(dtype).split(".")[1]
    o, lse = tat.flash_forward(q, k, v, *cfg, out_dtype=out_dtype)
    ro, rlse = tat.flash_attention_reference(q, k, v, *cfg,
                                             out_dtype=out_dtype)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    got = {"flash_forward": [o],
           "flash_bwd_dq": [tat.flash_bwd_dq(q, k, v, do, lse, delta, *cfg)],
           "flash_bwd_dkv": list(tat.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                   *cfg))}
    lse_err = float(((lse - rlse).abs() / rlse.abs().clamp_min(1)).max())
    del rlse
    want = {"flash_forward": [ro],
            "flash_bwd_dq": [tat.flash_bwd_dq_reference(
                q, k, v, do, lse, delta, *cfg)]}
    want["flash_bwd_dkv"] = list(tat.flash_bwd_dkv_reference(
        q, k, v, do, lse, delta, *cfg))
    torch.cuda.synchronize()
    b, h, s, hd = q.shape
    pairs = flash_work(b, h, s, k.shape[2], hd, *cfg)
    elt = q.element_size()
    qb, kb = q.numel() * elt, k.numel() * elt
    rowb = b * h * s * 4                        # lse or delta, f32
    io = {"flash_forward": (qb + 2 * kb + qb + rowb, 4.0 * hd * pairs),
          "flash_bwd_dq": (2 * qb + 2 * kb + 2 * rowb + qb, 6.0 * hd * pairs),
          "flash_bwd_dkv": (2 * qb + 2 * kb + 2 * rowb + 2 * kb,
                            8.0 * hd * pairs)}
    calls = {
        "flash_forward": (
            lambda: tat.flash_forward(q, k, v, *cfg, out_dtype=out_dtype),
            lambda: tat.flash_attention_reference(q, k, v, *cfg,
                                                  out_dtype=out_dtype)),
        "flash_bwd_dq": (
            lambda: tat.flash_bwd_dq(q, k, v, do, lse, delta, *cfg),
            lambda: tat.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                               *cfg)),
        "flash_bwd_dkv": (
            lambda: tat.flash_bwd_dkv(q, k, v, do, lse, delta, *cfg),
            lambda: tat.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                *cfg)),
    }
    library = {}
    if time_it:
        # one PyTorch call for the same function: SDPA forward, and one
        # autograd.grad of it for the backward (held against dq + dk/dv)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention
        out = sdpa(qr, kr, vr, is_causal=causal, enable_gqa=True)
        library["flash_forward"] = time_ms(
            lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
            iters=5, warmup=1)
        bwd = time_ms(lambda: torch.autograd.grad(out, (qr, kr, vr), do,
                                                  retain_graph=True),
                      iters=5, warmup=1)
        library["flash_bwd_dq"] = library["flash_bwd_dkv"] = bwd
        del out, qr, kr, vr
    rows = {}
    for name in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv"):
        errs, tols = [], []
        for g, w in zip(got[name], want[name]):
            errs.append(float((g.float() - w.float()).abs().max()))
            wf = w.float()
            if g.dtype == torch.bfloat16:
                tols.append(bf16_tol(wf))
            elif name == "flash_forward":
                tols.append(TOL_F32)
            else:  # the f32 sum order differs: relative to the output
                tols.append(1e-4 * float(wf.abs().max()))
        row = dict(phase="kernel", kernel=name, b=b, heads=h,
                   kv_heads=k.shape[1], s=s, hd=hd, causal=causal,
                   shift=shift, window=window, dtype=dt,
                   out_dtype=str(g.dtype).split(".")[1],
                   max_abs_err=max(errs), tol=min(tols),
                   err_to_tol=max(e / t for e, t in zip(errs, tols)),
                   card=card)
        if name == "flash_forward":
            row["lse_rel_err"] = lse_err
        if shape_tag:
            row["shape"] = shape_tag
        if time_it:
            nbytes, ops = io[name]
            b_ms, b_by = bound(nbytes, ops, dt)
            kern, plain = calls[name]
            row.update(ms=time_ms(kern, iters=5, warmup=1),
                       plain_ms=time_ms(plain, iters=3, warmup=1),
                       library_ms=library[name], bound_ms=b_ms,
                       bound_by=b_by, kept_pairs=pairs)
        emit(**row)
        check(all(e <= t for e, t in zip(errs, tols)),
              f"{name} {dt} {cfg}: err {errs} > {tols}")
        check(name != "flash_forward" or lse_err <= TOL_F32,
              f"flash_forward lse {dt} {cfg}: rel err {lse_err}")
        rows[name] = row
    del q, k, v, do, ro, got, want
    torch.cuda.empty_cache()
    return rows


def flash_f32out_row(gen, card: str) -> None:
    """The bf16 -> f32-out forward (ring attention's inner op) at the
    training path's shape: o against the plain version at 2e-5, its
    time, the plain version's and the bound (no library call returns an
    f32 o from bf16 inputs)."""
    import torch

    from vtpu_torch.ops import attention as tat

    q, k, v, _do = flash_inputs(gen, torch.bfloat16, **FLASH)
    cfg = (True, 0, 0)
    f32 = torch.float32
    o, _lse = tat.flash_forward(q, k, v, *cfg, out_dtype=f32)
    ro, _rlse = tat.flash_attention_reference(q, k, v, *cfg, out_dtype=f32)
    torch.cuda.synchronize()
    err = float((o - ro).abs().max())
    b, h, s, hd = q.shape
    pairs = flash_work(b, h, s, k.shape[2], hd, *cfg)
    nbytes = (q.numel() + 2 * k.numel()) * q.element_size() \
        + o.numel() * 4 + b * h * s * 4
    b_ms, b_by = bound(nbytes, 4.0 * hd * pairs, "bfloat16")
    row = dict(phase="kernel", kernel="flash_forward", b=b, heads=h,
               kv_heads=k.shape[1], s=s, hd=hd, causal=True, shift=0,
               window=0, dtype="bfloat16", out_dtype="float32",
               max_abs_err=err, tol=TOL_F32,
               ms=time_ms(lambda: tat.flash_forward(q, k, v, *cfg,
                                                    out_dtype=f32),
                          iters=5, warmup=1),
               plain_ms=time_ms(lambda: tat.flash_attention_reference(
                   q, k, v, *cfg, out_dtype=f32), iters=3, warmup=1),
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               kept_pairs=pairs, card=card)
    emit(**row)
    check(err <= TOL_F32, f"flash_forward bf16 -> f32: err {err}")
    del q, k, v, _do, o, ro
    torch.cuda.empty_cache()


def flash_phase(card: str, gen) -> dict:
    import torch

    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        rows = flash_check(gen, dtype, FLASH, time_it=True, card=card)
        if dtype == torch.bfloat16:
            summary = rows
    flash_f32out_row(gen, card)
    small = dict(FLASH, b=1, s=1024)
    for dtype in (torch.float32, torch.bfloat16):
        flash_check(gen, dtype, small, window=256, card=card)
        flash_check(gen, dtype, small, shift=-1, out_dtype=torch.float32,
                    card=card)
        flash_check(gen, dtype, dict(small, s=1000), card=card)
    return summary


# -- phase 2: the serving path at full width ------------------------------
FULL = dict(vocab=32000, d_model=4096, depth=32, num_heads=32,
            num_kv_heads=8, pos_embedding="rope", attn_window=0,
            max_seq=4096, kv_cache_layout="paged", kv_block_size=16,
            kv_pool_blocks=1 + 8 * 256)
REDUCED = ["attn_window 4096 -> 0: the paged decode kernel has no sliding "
           "window (the reference refuses paged_kernel='on' with one)",
           "max_seq 131072 -> 4096"]


def make_requests(seed: int, n: int = 16, num_new: int = 32):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(0, FULL["vocab"],
                                   int(rng.integers(64, 1001))).astype(
                                       np.int32), num_new)
            for i in range(n)]


def zero_counts() -> None:
    from vtpu_torch.ops import attention as tat
    from vtpu_torch.ops.layernorm import fused_layernorm
    from vtpu_torch.ops.paged_attention import paged_attention_decode

    fused_layernorm.launches = 0
    paged_attention_decode.launches = {"native": 0, "int8": 0}
    tat.flash_forward.launches = 0
    tat.flash_bwd_dq.launches = 0
    tat.flash_bwd_dkv.launches = 0


def read_counts() -> dict:
    from vtpu_torch.ops import attention as tat
    from vtpu_torch.ops.layernorm import fused_layernorm
    from vtpu_torch.ops.paged_attention import paged_attention_decode

    return {"fused_layernorm": fused_layernorm.launches,
            "paged_decode": paged_attention_decode.launches["native"],
            "paged_decode_q8": paged_attention_decode.launches["int8"],
            "flash_forward": tat.flash_forward.launches,
            "flash_bwd_dq": tat.flash_bwd_dq.launches,
            "flash_bwd_dkv": tat.flash_bwd_dkv.launches}


def serve(model, reqs, *, count: bool, decode_graph: str = "auto"):
    """Serve ``reqs`` (all submitted at t=0) on a fresh PagedBatcher
    whose decode windows are CUDA graphs (``decode_graph="auto"``) or
    eager.  Returns (outputs, metrics).  With ``count``, the kernels'
    launch counts are zeroed just before and read just after: a replay
    adds the launches its graph holds.  The engine and its graphs are
    released before returning."""
    import torch

    from vtpu_torch.serving.paged import PagedBatcher

    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    eng = PagedBatcher(model, max_batch=8, decode_graph=decode_graph)
    free0 = eng.pool_stats()["free"]
    # forwards outside the decode windows (admission), by a hook; a
    # window makes one forward a step, which a replay runs without Python
    prefill_forwards, in_window = [0], [False]
    hook = model.register_forward_hook(
        lambda *_: prefill_forwards.__setitem__(
            0, prefill_forwards[0] + (not in_window[0])))
    windows = []
    step_k = eng._step_k

    def timed_step_k(k):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        active = sum(eng.active)
        replay = k in eng._graphs
        in_window[0] = True
        t = time.perf_counter()
        s.record()
        out = step_k(k)
        e.record()
        host_s = time.perf_counter() - t
        in_window[0] = False
        windows.append((k, active, s, e, replay, host_s))
        return out

    eng._step_k = timed_step_k
    torch.cuda.synchronize()
    if count:
        zero_counts()
    t0 = time.perf_counter()
    for rid, prompt, n in reqs:
        eng.submit(rid, prompt, num_new=n)
    ttft = {}
    while (any(eng.active) or eng.queue or eng.prefilling
           or eng._inflight):
        eng.step()
        now = time.perf_counter()
        for rid, toks in eng.out.items():
            if toks and rid not in ttft:
                ttft[rid] = now - t0
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts() if count else None
    hook.remove()

    def decode(ws):
        ms = sum(s.elapsed_time(e) for _k, _a, s, e, *_ in ws)
        toks = sum(k * a for k, a, *_ in ws)
        steps = sum(k for k, *_ in ws)
        return (toks / (ms / 1e3) if ms else None,
                ms / steps if steps else None)

    replays = [w for w in windows if w[4]]
    tps, step_ms = decode(windows)
    tps_replay, step_ms_replay = decode(replays)
    ttfts = sorted(ttft.values())
    metrics = dict(
        requests=len(reqs), finished=sum(
            len(out.get(rid, [])) == n for rid, _p, n in reqs),
        pool_free_before=free0, pool_free_after=eng.pool_stats()["free"],
        decode_steps=eng.steps, forwards=prefill_forwards[0] + eng.steps,
        wall_s=wall, tokens=sum(len(t) for t in out.values()),
        tokens_per_s=sum(len(t) for t in out.values()) / wall,
        decode_graph=decode_graph, decode_graphs=eng.stats()["decode_graphs"],
        windows=len(windows), replayed_windows=len(replays),
        # the first window of each length: eager, then captured
        first_windows_host_s=[w[5] for w in windows if not w[4]],
        decode_tokens_per_s=tps, decode_step_ms=step_ms,
        decode_tokens_per_s_replayed=tps_replay,
        decode_step_ms_replayed=step_ms_replay,
        ttft_s_min=ttfts[0] if ttfts else None,
        ttft_s_p50=ttfts[len(ttfts) // 2] if ttfts else None,
        ttft_s_max=ttfts[-1] if ttfts else None,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts)
    # the wrapper (an attribute of the engine) and the bound method it
    # calls both hold the engine: drop them with it
    del eng._step_k
    del eng, step_k, timed_step_k
    torch.cuda.empty_cache()
    metrics["mem_left_after_release_gb"] = (
        torch.cuda.memory_allocated() - alloc0) / 1e9
    return out, metrics


def serve_phase(card: str, seed: int):
    import torch

    from vtpu_torch.models.transformer import TransformerLM

    cfg = dict(FULL)
    depth = cfg["depth"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = TransformerLM(**cfg, device="cuda", dtype=torch.bfloat16,
                          generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit(phase="setup", params=n_params, dtype="bfloat16",
         weights_gb=n_params * 2 / 1e9, seconds=time.perf_counter() - t0,
         config=cfg, reduced=REDUCED, card=card)
    # warm-up (cuBLAS handles, allocator), outside every measured run
    serve(model, make_requests(seed + 1, n=1, num_new=2), count=False)
    reqs = make_requests(seed)
    results, launches = {}, {}
    for pool in ("native", "int8"):
        m = model if pool == "native" else model.clone(kv_cache_dtype="int8")
        torch.cuda.reset_peak_memory_stats()
        out, met = serve(m, reqs, count=True)
        emit(phase="serve", pool=pool, reduced=REDUCED, card=card, **met)
        c = met["launches"]
        check(met["finished"] == len(reqs), f"{pool}: unfinished requests")
        check(met["pool_free_after"] == met["pool_free_before"],
              f"{pool}: leaked blocks")
        check(c["fused_layernorm"] >= (2 * depth + 1) * met["forwards"],
              f"{pool}: layernorm launches {c['fused_layernorm']}")
        paged = "paged_decode_q8" if pool == "int8" else "paged_decode"
        check(c[paged] >= depth * met["decode_steps"] > 0,
              f"{pool}: {paged} launches {c[paged]}")
        check(met["replayed_windows"] > 0 and met["decode_graphs"],
              f"{pool}: no decode window was a graph replay")
        check(met["mem_left_after_release_gb"] < 0.5,
              f"{pool}: the engine kept {met['mem_left_after_release_gb']} "
              f"GB after release")
        results[pool] = out
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    return model, reqs, results, launches


# -- phase 3: where the time goes ------------------------------------------
def profile_window(card: str, name: str, fn, require=()) -> None:
    """torch.profiler around ``fn``: device busy time (the union of the
    kernels' intervals), wall time, idle share and the kernels that take
    the most device time; each kernel named in ``require`` (a part of its
    name) must have run in the window."""
    from vtpu_torch.utils.devtrace import busy_ms, device_events

    wall_ms, kernels = device_events(fn)
    busy = busy_ms(kernels)
    by_name = {}
    for kname, start, stop in kernels:
        by_name[kname] = by_name.get(kname, 0.0) + (stop - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    required = {}
    for part in require:
        hits = [(start, stop) for kname, start, stop in kernels
                if part in kname]
        required[part] = [len(hits), sum(stop - start
                                         for start, stop in hits) / 1e3]
    emit(phase="profile", window=name, wall_ms=wall_ms,
         device_busy_ms=busy,
         idle_share=1.0 - busy / wall_ms if wall_ms else None,
         kernel_launches=len(kernels),
         top_kernels_ms=[[n[:80], ms] for n, ms in top],
         required_kernels=required, card=card)
    for part, (n, _ms) in required.items():
        check(n > 0, f"profile {name}: no {part} kernel in the window")


def profile_phase(card: str, model, reqs) -> None:
    """Where a decode step's time goes: one admission round (8 prompts)
    and 4 decode steps of a fresh engine."""
    import torch

    from vtpu_torch.serving.paged import PagedBatcher

    eng = PagedBatcher(model, max_batch=8)
    profile_window(card, "admission_prefill_8_prompts",
                   lambda: [eng.submit(rid, p, n) for rid, p, n in reqs[:8]])
    for _ in range(2):  # the admission's first harvest, then steady state
        eng.step()
    check(eng.stats()["decode_graphs"] == [1], "profile: no decode graph")
    profile_window(card, "decode_4_steps",
                   lambda: [eng.step() for _ in range(4)],
                   require=("paged_partial",))
    del eng
    torch.cuda.empty_cache()


# -- phase 4: exactness ----------------------------------------------------
def exactness_phase(card: str, seed: int, model_bf16, reqs, kernel_out):
    import torch

    from vtpu_torch.models.transformer import TransformerLM

    gen = torch.Generator(device="cuda").manual_seed(seed)
    small = TransformerLM(**dict(FULL, depth=2), device="cuda",
                          dtype=torch.float32, generator=gen)
    for pool in ("native", "int8"):
        kern = small.clone(kv_cache_dtype=pool)
        plain = kern.clone(paged_kernel="off", ln_kernel="off")
        a, _ = serve(kern, reqs, count=False)
        b, _ = serve(plain, reqs, count=False)
        eager, _ = serve(kern, reqs, count=False, decode_graph="off")
        same = all(a[rid] == b[rid] for rid, *_ in reqs)
        graph_same = all(a[rid] == eager[rid] for rid, *_ in reqs)
        emit(phase="exactness", depth=2, dtype="float32", pool=pool,
             requests=len(reqs), token_identical=same,
             graphed_equals_eager=graph_same, card=card)
        check(same, f"f32 {pool}: kernel and plain tokens differ")
        check(graph_same, f"f32 {pool}: graphed and eager tokens differ")
    del small, kern, plain
    torch.cuda.empty_cache()
    eager, _ = serve(model_bf16, reqs, count=False, decode_graph="off")
    pairs = [(x, y) for rid, *_ in reqs
             for x, y in zip(kernel_out[rid], eager[rid])]
    emit(phase="graph_agreement", depth=model_bf16.depth, dtype="bfloat16",
         pool="native", tokens=len(pairs),
         differing_tokens=sum(x != y for x, y in pairs),
         note="the serve phase's graphed tokens against an eager run; "
              "expected 0", card=card)
    plain = model_bf16.clone(paged_kernel="off", ln_kernel="off")
    b, _ = serve(plain, reqs, count=False)
    pairs = [(x, y) for rid, *_ in reqs
             for x, y in zip(kernel_out[rid], b[rid])]
    emit(phase="agreement", depth=model_bf16.depth, dtype="bfloat16",
         pool="native", tokens=len(pairs),
         agree_share=sum(x == y for x, y in pairs) / len(pairs),
         note="information only: bf16 rounds differently on the two paths",
         card=card)


# -- phase 6: the training path at full width ----------------------------
TRAIN = dict(vocab=32000, d_model=4096, depth=16, num_heads=32,
             num_kv_heads=8, pos_embedding="rope", attn_window=4096,
             max_seq=4096)
TRAIN_REDUCED = [
    "depth 32 -> 16: bf16 params, grads and two Adam moments of 5.9 B "
    "params are 47 GB before activations; at depth 16 (3.08 B params) "
    "they are ~25 GB, plus ~21 GB of saved activations and ~4 GB of f32 "
    "logits and their log-softmax",
    "max_seq 131072 -> 4096"]
TRAIN_BATCH, TRAIN_STEPS = (2, 4096), 4


def train_phase(card: str, seed: int) -> dict:
    """Adam steps on one seeded batch; every step's launch counts are
    zeroed just before it and read just after.  Returns the summed
    launch counts of the counted steps."""
    import torch

    from vtpu_torch.models.transformer import TransformerLM, lm_loss

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = TransformerLM(**TRAIN, device="cuda", dtype=torch.bfloat16,
                          generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, TRAIN["vocab"], TRAIN_BATCH, device="cuda",
                           generator=gen, dtype=torch.int32)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    torch.cuda.synchronize()
    depth = TRAIN["depth"]
    emit(phase="train_setup", params=n_params, dtype="bfloat16",
         batch=list(TRAIN_BATCH), optimizer="Adam(lr=1e-4)",
         seconds=time.perf_counter() - t0, config=TRAIN,
         reduced=TRAIN_REDUCED, card=card)

    def step():
        loss = lm_loss(model(tokens, decode=False), tokens)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    losses, total = [], {}
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        zero_counts()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t1 = time.perf_counter()
        s.record()
        loss = step()
        e.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        c = read_counts()
        ms = s.elapsed_time(e)
        losses.append(float(loss))
        emit(phase="train", step=i, loss=losses[-1], step_ms=ms,
             wall_s=wall, tokens_per_s=tokens.numel() / (ms / 1e3),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches=c, card=card)
        for name in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv"):
            check(c[name] == depth, f"train step {i}: {name} launched "
                                    f"{c[name]} times, not {depth}")
        check(c["fused_layernorm"] == 2 * depth + 1,
              f"train step {i}: layernorm launched {c['fused_layernorm']} "
              f"times, not {2 * depth + 1}")
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    import math

    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    profile_window(card, "train_step", step)
    del model, opt, tokens
    torch.cuda.empty_cache()
    return total


# -- phase 7: training exactness ------------------------------------------
def _kernel_and_plain_grads(seed: int, dtype):
    """Depth 2, b 1 x s 1024: the loss on the kernel path and on
    clone(flash_kernel="off", ln_kernel="off"), and each parameter's
    gradient on both, as (loss_k, loss_p, {name: (grad_k, grad_p)})."""
    import torch

    from vtpu_torch.models.transformer import TransformerLM, lm_loss

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = TransformerLM(**dict(TRAIN, depth=2), device="cuda",
                          dtype=dtype, generator=gen)
    tokens = torch.randint(0, TRAIN["vocab"], (1, 1024), device="cuda",
                           generator=gen, dtype=torch.int32)
    loss_k = lm_loss(model(tokens, decode=False), tokens)
    loss_k.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    plain = model.clone(flash_kernel="off", ln_kernel="off")
    loss_p = lm_loss(plain(tokens, decode=False), tokens)
    loss_p.backward()
    pairs = {n: (grads[n], p.grad) for n, p in model.named_parameters()}
    return loss_k.item(), loss_p.item(), pairs


def train_exactness_phase(card: str, seed: int) -> None:
    import torch

    loss_k, loss_p, pairs = _kernel_and_plain_grads(seed, torch.float32)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = ("", 0.0)
    for n, (got, ref) in pairs.items():
        scale = float(ref.abs().max())
        rel = float((got - ref).abs().max()) / scale if scale else 0.0
        if rel >= worst[1]:
            worst = (n, rel)
    emit(phase="train_exactness", depth=2, dtype="float32", batch=[1, 1024],
         loss_kernel=loss_k, loss_plain=loss_p,
         loss_rel_err=loss_rel, worst_grad=worst[0],
         worst_grad_rel_err=worst[1], card=card)
    check(loss_rel <= 1e-5, f"train exactness: loss rel err {loss_rel}")
    check(worst[1] <= 1e-4, f"train exactness: grad {worst[0]} rel err "
                            f"{worst[1]}")
    del pairs
    torch.cuda.empty_cache()


def train_exactness_bf16_phase(card: str, seed: int) -> None:
    """The same comparison in bf16, where the tensor-core kernels round p
    and dS to bf16: the loss within 1e-2 relative and each gradient's
    cosine similarity with the plain path's at least 0.99 (parameters
    whose plain gradient is all zero are skipped and listed)."""
    import torch

    loss_k, loss_p, pairs = _kernel_and_plain_grads(seed, torch.bfloat16)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    cosine, skipped = {}, []
    for n, (got, ref) in pairs.items():
        got, ref = got.double(), ref.double()
        if not bool(ref.any()):
            skipped.append(n)
            continue
        cosine[n] = float((got * ref).sum()
                          / (got.norm() * ref.norm()).clamp_min(1e-300))
    worst = min(cosine, key=cosine.get)
    emit(phase="train_exactness", depth=2, dtype="bfloat16",
         batch=[1, 1024], loss_kernel=loss_k, loss_plain=loss_p,
         loss_rel_err=loss_rel, grad_cosine=cosine, worst_grad=worst,
         worst_grad_cosine=cosine[worst], skipped_zero_grads=skipped,
         card=card)
    check(loss_rel <= 1e-2, f"bf16 train exactness: loss rel err {loss_rel}")
    check(cosine[worst] >= 0.99, f"bf16 train exactness: grad {worst} "
                                 f"cosine {cosine[worst]}")
    del pairs
    torch.cuda.empty_cache()


# -- phase 8: the ai-benchmark rows ---------------------------------------
AI_SECONDS = 1.5                   # timed window per row (the CLI: 10)
AI_F32_TOL = 1e-3                  # of max |logit|: cuDNN's f32 algorithms


def ai_benchmark_phase(card: str, seed: int) -> dict:
    """Every row of ``vtpu_torch.bench.ai_benchmark.ROWS`` at its batch
    and mode in bf16 (seeded random weights): img/s over a window of
    waited-for steps after one warm-up step, peak memory, and the kernel
    launches of the row (set to 0 just before it, read just after).  The
    transformer rows run the flash and LayerNorm kernels: one forward a
    layer (plus dq and dk/dv in training) and 2 * depth + 1 LayerNorms a
    step.  Returns those rows' summed launches."""
    import math

    import torch

    from vtpu_torch.bench.ai_benchmark import ROWS, build_step
    from vtpu_torch.utils.sync import hard_sync

    total = {}
    for name, batch, mode in ROWS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        t0 = time.perf_counter()
        step, x, model = build_step(name, batch, mode, device="cuda",
                                    dtype=torch.bfloat16, generator=gen)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        zero_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = step(x)
            first = hard_sync(out)
            steps, t1 = 1, time.perf_counter()
            while time.perf_counter() - t1 < AI_SECONDS:
                out = step(x)
                hard_sync(out)
                steps += 1
            window = time.perf_counter() - t1
        # cuDNN copies an LSTM's weights into one buffer on every call
        # when they are not one already (models/lstm.py casts them so)
        repacks = sum("contiguous chunk" in str(w.message) for w in caught)
        c = read_counts()
        finite = bool(torch.isfinite(out.float()).all())
        row = dict(phase="ai_benchmark", model=name, batch=batch, mode=mode,
                   dtype="bfloat16", img_per_s=(steps - 1) * batch / window,
                   steps=steps, setup_s=setup_s,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   params=sum(p.numel() for p in model.parameters()),
                   output_shape=list(out.shape), first_output=first,
                   finite=finite, repack_warnings=repacks, card=card)
        if name == "transformer":
            row["launches"] = c
            depth = model.depth
            want = {"flash_forward": depth * steps,
                    "fused_layernorm": (2 * depth + 1) * steps}
            if mode == "training":
                want["flash_bwd_dq"] = want["flash_bwd_dkv"] = depth * steps
            for k, n in want.items():
                check(c[k] == n, f"ai_benchmark {name} {mode}: {k} "
                                 f"launched {c[k]} times, not {n}")
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        emit(**row)
        check(finite and math.isfinite(first) and steps > 1,
              f"ai_benchmark {name} {mode}: output finite {finite}, "
              f"steps {steps}")
        check(repacks == 0, f"ai_benchmark {name} {mode}: cuDNN repacked "
                            f"the LSTM's weights")
        del step, x, model, out
    gc.collect()
    torch.cuda.empty_cache()
    return total


def resnet_f32_phase(card: str, seed: int) -> None:
    """ResNetV2_50 in f32 at batch 2, 224^2: the card against the port on
    the CPU, the same weights and seeded images; logits and the updated
    batch statistics within AI_F32_TOL of their largest magnitude (TF32
    is off; cuDNN's f32 convolution algorithms sum in other orders than
    the CPU's)."""
    import numpy as np
    import torch

    from vtpu_torch.models.resnet import ResNetV2_50

    cpu = ResNetV2_50(num_classes=1000, dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    gpu = ResNetV2_50(num_classes=1000, dtype=torch.float32, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 224, 224, 3)).astype(np.float32))
    with torch.no_grad():
        want, want_stats = cpu(x)
        got, got_stats = gpu(x.cuda())

    def rel(a, b):
        return float((a.cpu().double() - b.double()).abs().max()
                     / b.double().abs().max())

    err = rel(got, want)
    stats_err = max(rel(got_stats[k], v) for k, v in want_stats.items())
    emit(phase="ai_f32_exactness", model="resnet50", batch=2, image=224,
         logits_rel_err=err, batch_stats_rel_err=stats_err, tol=AI_F32_TOL,
         card=card)
    check(err <= AI_F32_TOL and stats_err <= AI_F32_TOL,
          f"resnet50 f32 card vs CPU: logits {err}, stats {stats_err}")
    del cpu, gpu
    torch.cuda.empty_cache()


def ai_kernel_rows(card: str, gen) -> dict:
    """The kernels at the transformer rows' shapes (d 512, 8 heads, hd 64,
    s 512), each at b 8 (the inference row) and b 4 (the training row):
    LayerNorm over b * s rows of 512, and the bf16 flash forward, dq and
    dk/dv, with their plain versions, the library's time and bounds."""
    import torch
    import torch.nn.functional as F

    from vtpu_torch.ops.layernorm import _reference_ln, fused_layernorm

    d = 512
    rows_out = {}
    for batch in (8, 4):
        rows = batch * 512
        x = (torch.randn(rows, d, device="cuda", generator=gen) * 3
             + 1).bfloat16()
        g = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).bfloat16()
        b = (0.1 * torch.randn(d, device="cuda", generator=gen)).bfloat16()
        ref = _reference_ln(x, g, b)
        err = float((fused_layernorm(x, g, b).float()
                     - ref.float()).abs().max())
        tol = bf16_tol(ref.float())
        b_ms, b_by = bound(2 * rows * d * 2 + 2 * d * 2, 9.0 * rows * d,
                           "bfloat16")
        emit(phase="kernel", kernel="fused_layernorm", rows=rows, d=d,
             dtype="bfloat16", shape=f"ai_transformer_b{batch}",
             max_abs_err=err, tol=tol,
             ms=time_ms(lambda: fused_layernorm(x, g, b)),
             plain_ms=time_ms(lambda: _reference_ln(x, g, b)),
             library_ms=time_ms(lambda: F.layer_norm(x, (d,), g, b, 1e-6)),
             bound_ms=b_ms, bound_by=b_by, card=card)
        check(err <= tol, f"layernorm {rows} x {d}: err {err} > {tol}")
        rows_out[batch] = flash_check(
            gen, torch.bfloat16, dict(b=batch, heads=8, kv_heads=8, s=512,
                                      hd=64),
            time_it=True, card=card, shape_tag=f"ai_transformer_b{batch}")
    return rows_out


# -- phase 9: four tenants share the card ----------------------------------
SHARE_WINDOW = 6.0                 # seconds per arm (the CLI: 10)
SHARE_QUOTA = 4 << 30              # each tenant's HBM quota (bench.py's)
DUTY_WINDOW = 2.5                  # seconds per duty probe
DUTY_TOL = 0.15                    # of 0.5, the 50 % tenant's duty
DUTY_CORE = 50                     # the paced tenant's core limit


def share_phase(card: str) -> dict:
    """``vtpu_torch.bench.share.run`` on the card (bf16 ResNet-V2-50 at
    batch 50, 224^2; its docstring lists the arms), checked and emitted:
    one ``share`` line per forward (eager, graphed) with the exclusive
    and four-tenant img/s, their ratio and each window's device idle
    share; quota violations must be 0 and the region must hold the four
    tenants and exactly their resident bytes.  ``share_duty``: the duty
    of a tenant at 50 % (its rate over its rate at 100 %) within DUTY_TOL
    of 0.5 -- the bound of tests/test_monitor.py's pacing accuracy test,
    inside the band that test_dispatch_pacing_converges_30_70 allows --
    and, reported beside it, the duty under the reference's rule; eager
    and graphed."""
    from vtpu_torch.bench import share

    t0 = time.perf_counter()
    doc = share.run("cuda", window=SHARE_WINDOW, quota=SHARE_QUOTA,
                    duty_window=DUTY_WINDOW, process_window=NODE_WINDOW)
    phase_s = time.perf_counter() - t0
    for kind in ("eager", "graphed"):
        arm = doc[kind]
        ex, sh = arm["exclusive"], arm["share"]
        extra = {}
        if kind == "eager":
            bare = arm["share_without_runtime"]
            extra = {"share_without_runtime_img_s": bare["summed_img_s"],
                     "share_without_runtime_idle_share": bare["idle_share"],
                     "share_without_runtime_trace_s": bare["trace_s"]}
        emit(phase="share", arm=kind, model="resnet50", dtype="bfloat16",
             batch=doc["batch"], image=doc["image"], window_s=SHARE_WINDOW,
             setup_s=doc["setup_s"], step_host_ms=arm["step_host_ms"],
             step_device_ms=arm["step_device_ms"],
             exclusive_img_s=ex["img_s"],
             per_tenant_img_s=sh["per_tenant_img_s"],
             summed_img_s=sh["summed_img_s"], ratio=arm["ratio"],
             target_ratio=0.95, violations=sh["violations"],
             region=sh["region"], exclusive_idle_share=ex["idle_share"],
             share_idle_share=sh["idle_share"], traced="device",
             kernels_traced=[ex["kernels"], sh["kernels"]],
             trace_s=[ex["trace_s"], sh["trace_s"]], phase_s=phase_s,
             **extra, card=card)
        check(sh["violations"] == 0,
              f"share {kind}: {sh['violations']} violations")
        region = sh["region"]
        check(region["procs"] == 4
              and region["pids"] == [1000, 1001, 1002, 1003],
              f"share {kind}: region slots {region}")
        check(region["total_bytes"] == region["expected_bytes"],
              f"share {kind}: region holds {region['total_bytes']} B, not "
              f"{region['expected_bytes']}")
        check(region["launches"] > 0, f"share {kind}: no launch recorded")
    q = doc["duty"]["core_limit"]
    for kind in ("eager", "graphed"):
        duty = doc["duty"][kind]
        emit(phase="share_duty", arm=kind, core_limit=q,
             window_s=doc["duty"]["window_s"], img_s=duty["img_s"],
             img_s_at_100=duty["img_s_at_100"], measured=duty["measured"],
             tol=DUTY_TOL,
             reference_rule_img_s=duty["reference_rule_img_s"],
             reference_rule_measured=duty["reference_rule_measured"],
             card=card)
        check(abs(duty["measured"] - q / 100) <= DUTY_TOL,
              f"share {kind}: duty at {q}% measured {duty['measured']}")
    return doc["processes"]


# -- phase 10: the GPU node path ------------------------------------------
NODE_QUOTA_MB = 8192               # the quota tenant's Allocate quota
NODE_FREE_BYTES = 40e9             # NVML's free memory at its OOM, at least
NODE_WINDOW = 2.0                  # seconds per tenant window
# a slot holds its tenant's reserved memory, its context's charge (as
# program bytes) and what libraries allocate outside PyTorch's caching
# allocator, which the interposer charges too: 128.3 MiB a tenant of the
# eager ResNet-V2-50 arm on an H100 80GB HBM3 at 700 W (not attributed);
# at most this much
NODE_OUTSIDE_ALLOCATOR = 256 << 20


def node_quota(card: str, uuid: str, so: str, tmp: str) -> None:
    """The quota tenant: 1 GiB tensors until the interposer refuses one;
    the card's free memory is read here while the tenant holds them.
    Every tenant of the node phase takes its context lock in
    ``<tmp>/lock``."""
    from vtpu_torch.bench import share
    from vtpu_torch.bench.tenant import GIB, nvml_memory

    t = time.perf_counter()
    qdir = os.path.join(tmp, "quota")
    os.makedirs(qdir)
    env = share.tenant_env(os.path.join(qdir, "vtpu.cache"), qdir,
                           quota_mb=NODE_QUOTA_MB, cores=100, uuid=uuid,
                           lock_dir=os.path.join(tmp, "lock"), interposer=so)
    tenant = share.Tenants([(["--mode", "quota"], env)], qdir)
    try:
        (q,) = tenant.phase("quota", [0])
        card_free = nvml_memory(uuid)["free"]
        (final,) = tenant.close()
    except BaseException:
        tenant.kill()
        raise
    proof = final["proof"]
    limit = NODE_QUOTA_MB << 20
    slot = q["region"]["slot"]
    emit(phase="node_quota", quota_mb=NODE_QUOTA_MB,
         bytes_at_oom=q["bytes_at_oom"], tensors=q["tensors"],
         oom=q["oom"], nvml_free_at_oom=card_free,
         nvml_in_tenant=q["nvml_in_tenant"],
         mem_get_info=proof["mem_get_info"],
         memory_reserved=q["memory_reserved"], region_slot=slot,
         region_total=q["region"]["device_total"],
         seconds=time.perf_counter() - t, card=card)
    check(proof["mem_get_info"][1] == limit,
          f"node quota: mem_get_info {proof['mem_get_info']}")
    check(q["nvml_in_tenant"]["total"] == limit,
          f"node quota: NVML in the tenant {q['nvml_in_tenant']}")
    check(q["tensors"] < NODE_QUOTA_MB // 1024
          and card_free > NODE_FREE_BYTES,
          f"node quota: OOM after {q['tensors']} GiB with {card_free} B "
          f"free on the card")
    check(slot["hbm_peak"] <= limit
          and q["region"]["device_total"] <= limit,
          f"node quota: region {q['region']} past {limit}")
    check(slot["buffer"] >= q["tensors"] * GIB,
          f"node quota: region holds {slot['buffer']} B of "
          f"{q['tensors']} GiB")


def node_serve(card: str, env, barrier: str) -> None:
    """The paged serve path with and without the interposer, at once:
    the same tokens.  The serve tenants wait at no barrier; ``barrier``
    only receives ``Tenants``' exit mark."""
    from vtpu_torch.bench import share

    t = time.perf_counter()
    tenants = share.Tenants(
        [(["--mode", "serve"], env("serve")),
         (["--mode", "serve", "--plain"], env("serve_plain", interposer=""))],
        barrier)
    shimmed, plain = tenants.close()
    same = shimmed["tokens"] == plain["tokens"]
    emit(phase="node_serve", depth=shimmed["depth"],
         requests=len(shimmed["tokens"]),
         tokens=sum(len(toks) for toks in shimmed["tokens"].values()),
         identical=same, launches=shimmed["launches"],
         launches_plain=plain["launches"],
         region_slot=shimmed["region"]["slot"],
         seconds=time.perf_counter() - t, card=card)
    check(same, "node serve: tokens differ under the interposer")
    check(all(v > 0 for v in shimmed["launches"].values()),
          f"node serve: kernels not launched {shimmed['launches']}")


def node_phase(card: str, processes: dict) -> None:
    """Phase 10 (the module docstring): the provider against nvidia-smi,
    the interposer's build, and plain PyTorch tenants under it;
    ``processes`` is the four-process arm that ``share.run`` ran in the
    share phase (``share.run_processes``), checked and emitted here."""
    import tempfile

    import torch

    from vtpu_torch.bench import share
    from vtpu_torch.device.nvml import NvmlProvider
    from vtpu_torch.native import build

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    prov = NvmlProvider()
    chips, health = prov.enumerate(), prov.health_check()
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,memory.total",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi: {res.stderr.strip()}")
    smi = [[f.strip() for f in line.split(",")]
           for line in res.stdout.strip().splitlines()]
    emit(phase="node_provider", chips=[vars(c) for c in chips],
         nvidia_smi=smi, healthy=[c.healthy for c in health],
         topology=list(prov.topology().dims), card=card)
    check(len(chips) == 1 and len(smi) == 1,
          f"node: {len(chips)} chips from NVML, {len(smi)} from nvidia-smi")
    check(chips[0].uuid == smi[0][0]
          and chips[0].hbm_mb == int(smi[0][1]),
          f"node: provider {chips[0].uuid} {chips[0].hbm_mb} MiB against "
          f"nvidia-smi {smi[0]}")
    check(all(c.healthy for c in health), "node: card unhealthy")
    uuid = chips[0].uuid
    check(uuid == share.card_uuid(), "node: NVML and torch name "
          "different cards")

    t = time.perf_counter()
    so = build.interposer()
    emit(phase="node_build", seconds=time.perf_counter() - t,
         interposer=os.path.relpath(so, HERE), card=card)

    with tempfile.TemporaryDirectory(prefix="vtpu-node-") as tmp:
        def env(name, interposer=so):
            os.makedirs(os.path.join(tmp, name))
            return share.tenant_env(
                os.path.join(tmp, name, "vtpu.cache"), "", quota_mb=16384,
                cores=100, uuid=uuid, lock_dir=os.path.join(tmp, "lock"),
                interposer=interposer)

        # the duty tenants build and capture their graphs beside the
        # quota and serve tenants, then wait at the barrier
        duty_dir = os.path.join(tmp, "duty")
        os.makedirs(duty_dir)
        specs = []
        for cores in (DUTY_CORE, 100):
            e = share.tenant_env(os.path.join(duty_dir, f"{cores}.cache"),
                                 duty_dir, quota_mb=16384, cores=cores,
                                 uuid=uuid, lock_dir=os.path.join(tmp, "lock"),
                                 interposer=so)
            specs.append((["--mode", "resnet", "--graphed", "--seconds",
                           str(NODE_WINDOW), "--phases", f"at{cores}"]
                          + (["--trace"] if cores == DUTY_CORE else []), e))
        duty = share.Tenants(specs, duty_dir)
        try:
            node_quota(card, uuid, so, tmp)
            node_serve(card, env, os.path.join(tmp, "serve"))
            # in turns, a graphed tenant at 50 % and the same at 100 %
            t = time.perf_counter()
            (at_q,) = duty.phase(f"at{DUTY_CORE}", [0])
            (at_100,) = duty.phase("at100", [1])
            final = duty.close()
        except BaseException:
            duty.kill()
            raise
        busy = at_q["busy_share"]
        emit(phase="node_duty", core_limit=DUTY_CORE, window_s=NODE_WINDOW,
             busy_share=busy, img_s=at_q["img_s"],
             img_s_at_100=at_100["img_s"],
             rate_ratio=at_q["img_s"] / at_100["img_s"], tol=DUTY_TOL,
             kernels_traced=at_q["kernels"], trace_s=at_q["trace_s"],
             setup_s=[doc["setup_s"] for doc in final],
             seconds=time.perf_counter() - t, card=card)
        check(abs(busy - DUTY_CORE / 100) <= DUTY_TOL,
              f"node duty at {DUTY_CORE}%: busy share {busy}")

        # the four-process share arm (run by share.run in the share phase)
        for kind in ("eager", "graphed"):
            arm = processes[kind]
            region = arm["region"]
            outside = [s.get("buffer", 0) - s["reserved"]
                       for s in region["slots"]]
            emit(phase="node_share", arm=arm["kind"], model="resnet50",
                 dtype="bfloat16", window_s=arm["window_s"],
                 quota_mb=arm["quota_mb"],
                 exclusive_img_s=arm["exclusive_img_s"],
                 per_tenant_img_s=arm["per_tenant_img_s"],
                 summed_img_s=arm["summed_img_s"], ratio=arm["ratio"],
                 target_ratio=0.95, violations=arm["violations"],
                 region=region, outside_allocator_bytes=outside,
                 setup_s=arm["setup_s"], seconds=arm["seconds"], card=card)
            check(arm["violations"] == 0,
                  f"node share {arm['kind']}: {arm['violations']} violations")
            check(region["procs"] == 4
                  and region["pids"] == region["tenant_pids"],
                  f"node share {arm['kind']}: region slots {region}")
            for s, extra in zip(region["slots"], outside):
                check(s.get("program", 0) > 0
                      and 0 <= extra <= NODE_OUTSIDE_ALLOCATOR,
                      f"node share {arm['kind']}: slot {s} is not its "
                      f"tenant's reserved memory and context charge")

        # what the interposer adds to a launch and to an allocation pair
        t = time.perf_counter()
        bench = build.hook_bench()
        cost = {"interposer": [], "plain": []}
        for name in ("plain", "interposer", "interposer", "plain"):
            res = subprocess.run(
                [bench, "20000", "2000", str(2 << 20)],
                env=env(f"hook_{len(cost[name])}_{name}",
                        interposer=so if name == "interposer" else ""),
                capture_output=True, text=True, timeout=300)
            check(res.returncode == 0, f"hook bench: {res.stderr[-2000:]}")
            cost[name].append(json.loads(res.stdout))
        mean = {k: {m: sum(r[m] for r in v) / len(v)
                    for m in ("launch_issue_us", "alloc_free_us")}
                for k, v in cost.items()}
        emit(phase="node_hook_cost", runs=cost, mean=mean,
             launch_added_us=mean["interposer"]["launch_issue_us"]
             - mean["plain"]["launch_issue_us"],
             alloc_free_added_us=mean["interposer"]["alloc_free_us"]
             - mean["plain"]["alloc_free_us"],
             seconds=time.perf_counter() - t, card=card)
    emit(phase="node", seconds=time.perf_counter() - t_phase, card=card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from vtpu_torch.device import reference_numerics
        from vtpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the vtpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    reference_numerics()
    card = card_line()
    emit(phase="card", nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    so_path = _build.lib()._name
    build_s = time.perf_counter() - t0
    report = kernel_build_report(so_path, os.path.dirname(_build._nvcc()))
    emit(phase="build", seconds=build_s,
         built_now=_build.build_seconds is not None, kernel_report=report,
         card=card)
    if _build.build_log:
        print(_build.build_log, file=sys.stderr)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    failures = build_failures(report)
    check(not failures, "; ".join(failures))
    rows = {"fused_layernorm": layernorm_phase(card, gen),
            **paged_phase(card, gen, args.seed), **flash_phase(card, gen)}
    wide_heads_phase(card, gen)
    model, reqs, results, launches = serve_phase(card, args.seed)
    profile_phase(card, model, reqs)
    exactness_phase(card, args.seed, model, reqs, results["native"])
    del model, results
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in train_phase(card, args.seed).items():
        launches[k] = launches.get(k, 0) + v
    train_exactness_phase(card, args.seed)
    train_exactness_bf16_phase(card, args.seed)
    ai_kernel_rows(card, gen)
    for k, v in ai_benchmark_phase(card, args.seed).items():
        launches[k] = launches.get(k, 0) + v
    resnet_f32_phase(card, args.seed)
    node_phase(card, share_phase(card))

    sources = {
        "fused_layernorm": ("vtpu_torch/csrc/layernorm.cu",
                            "vtpu/ops/layernorm.py:18"),
        "paged_decode": ("vtpu_torch/csrc/paged_attention.cu",
                         "vtpu/ops/paged_attention.py:74"),
        "paged_decode_q8": ("vtpu_torch/csrc/paged_attention.cu",
                            "vtpu/ops/paged_attention.py:87"),
        "flash_forward": ("vtpu_torch/csrc/flash_attention_sm90.cu",
                          "vtpu/ops/attention.py:48"),
        "flash_bwd_dq": ("vtpu_torch/csrc/flash_attention_sm90.cu",
                         "vtpu/ops/attention.py:91"),
        "flash_bwd_dkv": ("vtpu_torch/csrc/flash_attention_sm90.cu",
                          "vtpu/ops/attention.py:130"),
    }
    kernels = []
    for name, (src, repl) in sources.items():
        r = rows.get(name, {})
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=launches.get(name), max_abs_err=r.get("max_abs_err"),
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
            library_ms=r.get("library_ms"), dtype=r.get("dtype"),
            card=card))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
