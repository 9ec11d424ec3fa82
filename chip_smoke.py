#!/usr/bin/env python3
"""Drive the PyTorch port's paged and dense serving, its serving front
door, generate and training paths, its ai-benchmark rows and its
four-tenant share run on one NVIDIA GPU.

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
   (its rate over the mean of its rates at 100 % read before and after
   the paced window), eager and graphed, must be within
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
   (``vgpu_hook_bench``, with and without it, in turns);
11. disaggregated serving (``vtpu_torch/serving/disagg.py``): the wire
   extract of every codec on the card gives the CPU's bytes (bf16, f32
   with a zero and a subnormal block, int8 with f32 scales), each
   codec's device time for an extract of 63, 65 and 128 blocks (the
   extract gathers exactly its blocks; 128 is what a power-of-two pad
   made of 65), and the host's time for one 8 MiB chunk of it (payload
   join, frame encode and decode, crc32, the copy to the card); at depth
   2, f32, both pools, shared-pool, cross-pool copy and fp32-wire
   disaggregation, the prefix cache off and on (a shared 512-token
   prefix, fp32 wire) and session moves (fp32 wire, bit-equal blocks)
   give exactly the monolithic PagedBatcher's tokens;
   then the serve configuration (the serve phase's weights and 16
   requests) through a PrefillEngine and a DecodeEngine(max_batch=8):
   shared and copy on both pools, and the wire (the port's StreamSender
   -> LoopbackLink -> ReceiverHub, speculative adoption) under fp32,
   int8, fp8 and int4 on the native pool and fp32 on the int8 pool, each
   arm a line: the share of tokens equal to the serve phase's
   (information: a different admission grouping rounds bf16
   differently), the adopted blocks' largest error against their source
   beside ``error_bound(wire_quant_max_scale, codec)`` plus half a bf16
   ulp of the largest adopted value, the pool's own rounding
   (``wire_error_bound``; required within; and each block within its own
   scale's bound plus half a pool-dtype ulp of the value; fp32 exact;
   the rows are copied on the device at FIN and compared after the run,
   outside its timing), blocks
   leaked on each pool (required 0), handoff host bytes (required 0 but
   on the wire), wire bytes a request, handoff ms a request (device copy
   or bind by CUDA events; wire_open to FIN by the host clock), TTFT
   p50, decode tokens/s, the replayed step ms (over all replays and over
   those with all 8 slots active: a step's attention grows with its
   active rows' keys), replayed decode windows (required > 0), the
   LN and paged-decode launches (required: the serve phase's bounds per
   forward and per decode step), and the drive loop's host seconds in
   prefill, handoff and decode.  On each pool, the session arm: nine
   requests on decode engine A (eight in slots, one queued), four live
   sessions and the queued one moved to engine B by the port's
   SessionMover after 8 decode steps, then both run to the end (move ms,
   blocks shipped and skipped, fp32 blocks bit-equal, replayed steps on
   both engines after the move, 0 leaks).  The prefix arm (int8 wire,
   16 requests of one 512-token prefix and a 64-488-token suffix, the
   first request to its FIN before the other 15), prefix cache off and
   on: 15 hits skipping 7,680 tokens, every wave-2 stream skipping the
   prefix's 32 blocks, wire MB a request and TTFT p50 of both.  The
   spill arm (a 1 + 128-block standalone prefill pool, int8 spill codec,
   a journal in a temporary directory; eight 512-token prefixes in two
   passes): demotions and onloads >= 1, every onloaded block its
   payload's dequantization bit for bit and within its own block's bound
   of the block demoted, and a fresh engine on the journal rehydrating
   and onloading on its first revisit; demote and onload host ms a run.
   Every arm's LN and paged-decode launches at the serve phase's bounds;
12. (after phase 4) the dense layout: the serve configuration and
   weights cloned to ``kv_cache_layout="dense"`` (the reference's
   default) through ``ContinuousBatcher(max_batch=8)`` on native and int8
   caches, the serve lines' metrics (``dense_serve``), LN at its bound a
   forward, no paged launch, replayed windows > 0, every request
   finished, memory released; at depth 2, f32, on both caches, the dense
   engine's tokens equal PagedBatcher's, the dense ``generate`` of each
   prompt alone and its own eager windows', and speculative decoding (a
   paged dense-equivalent target, a depth-1 draft of its first block)
   equals the target's greedy ``generate``; then at full width, bf16, on
   two prompts: sampled ``generate`` (temperature 0.8, top_k 50, a
   generator seeded on the card; ``top_k=1`` must give the greedy tokens
   and every draw must lie in its step's top 50), ``generate_beam``
   (beam 4) and ``generate_speculative`` (k 4, the paged dense-equivalent
   target, a depth-2 draft of its first two blocks, ln_f and head:
   verify forwards, acceptance, and the share of tokens equal to greedy
   as information), with the phase's launches (the draft's one-token
   steps must launch the paged kernel);
13. (after phase 11) the serving front door: the serve configuration and
   weights behind the port's ``Router`` (``vtpu_torch/serving/router.py``),
   the serve phase's 16 requests over 8 sessions, one PrefillEngine and
   (a) two DecodeEngine(max_batch=8) replicas, copy handoff, tracing
   off: no span and no ledger record; (b) the same requests again on the
   same Router and engines with tracing on: every request's five ledger
   stages (p50 of each, ms and share of the TTFT) within 5 % of the TTFT
   the driver measures (submit to the moment the host holds the first
   token), span and record counts; then once more with tracing switched
   on and off at every pump: the replayed windows dispatched with it on
   within 5 % of those with it off (the hooks cost the window nothing on
   the device; a fresh run's step moves by up to 9 % between runs, so
   the serve phase's step and a monolithic engine's of this phase are
   printed beside it as information, ``router_overhead``); (c) one replica reached by the loopback wire under int8 with a
   1 + 8*32-block pool, so that the Router parks saturated handoffs and
   retries them (parks > 0, host bytes = wire bytes); (d) two replicas,
   the one holding most of the first eight requests failing its pings
   until the Router drains it (``ReplicaDrained``), its requests
   finishing in place and the last eight (new sessions) all on the
   other; each arm a ``router`` line (decode tokens/s, replayed step ms,
   TTFT p50, routes a replica, rejects, parks, handoff host bytes,
   blocks leaked (required 0), LN and paged launches at the serve
   bounds); then (e) at depth 2, f32, the copy and fp32-wire arms'
   tokens equal the monolithic PagedBatcher's (``router_exactness``).

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
import zlib

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
    """Serve ``reqs`` (all submitted at t=0) on a fresh PagedBatcher (a
    paged model) or ContinuousBatcher (a dense one) whose decode windows
    are CUDA graphs (``decode_graph="auto"``) or eager.  Returns
    (outputs, metrics).  With ``count``, the kernels' launch counts are
    zeroed just before and read just after: a replay adds the launches
    its graph holds.  The engine and its graphs are released before
    returning."""
    import torch

    from vtpu_torch.serving.batcher import ContinuousBatcher
    from vtpu_torch.serving.paged import PagedBatcher

    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    paged = model.kv_cache_layout == "paged"
    eng = (PagedBatcher if paged else ContinuousBatcher)(
        model, max_batch=8, decode_graph=decode_graph)
    free0 = eng.pool_stats()["free"] if paged else None
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
    # every slot active: the step's attention over 8 real rows
    _tps, step_ms_full = decode([w for w in replays if w[1] == eng.max_batch])
    ttfts = sorted(ttft.values())
    metrics = dict(
        requests=len(reqs), finished=sum(
            len(out.get(rid, [])) == n for rid, _p, n in reqs),
        pool_free_before=free0,
        pool_free_after=eng.pool_stats()["free"] if paged else None,
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
        decode_step_ms_replayed_full=step_ms_full,
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
    results, launches, mets = {}, {}, {}
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
        mets[pool] = met
        tally(launches, c)
    return model, reqs, results, launches, mets


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


# -- phase 12: the dense layout and the generate entries --------------------
GEN_NEW = 32                       # new tokens of every generate arm


def tally(into: dict, counts: dict) -> None:
    for k, v in counts.items():
        into[k] = into.get(k, 0) + v


def dense_serve_phase(card: str, model, reqs) -> dict:
    """The serve configuration and weights cloned to the dense layout
    (the reference's default) through ContinuousBatcher(max_batch=8) on
    both cache dtypes: the serve lines' metrics, with LN at its bound a
    forward, no paged launch, replayed windows and every request
    finished.  Returns the launches."""
    import torch

    depth, launches = model.depth, {}
    for cache in ("native", "int8"):
        m = model.clone(kv_cache_layout="dense", kv_cache_dtype=cache)
        torch.cuda.reset_peak_memory_stats()
        _out, met = serve(m, reqs, count=True)
        emit(phase="dense_serve", layout="dense", cache=cache,
             reduced=REDUCED, card=card, **met)
        c = met["launches"]
        what = f"dense {cache}"
        check(met["finished"] == len(reqs), f"{what}: unfinished requests")
        check(c["fused_layernorm"] >= (2 * depth + 1) * met["forwards"] > 0,
              f"{what}: layernorm launches {c['fused_layernorm']} for "
              f"{met['forwards']} forwards")
        check(c["paged_decode"] == 0 and c["paged_decode_q8"] == 0,
              f"{what}: a dense engine launched the paged kernel")
        check(met["replayed_windows"] > 0 and met["decode_graphs"],
              f"{what}: no decode window was a graph replay")
        check(met["mem_left_after_release_gb"] < 0.5,
              f"{what}: the engine kept {met['mem_left_after_release_gb']} "
              f"GB after release")
        tally(launches, c)
        del m
    return launches


def draft_of(target, depth: int):
    """A draft of the target's widths at ``depth``: the target's first
    ``depth`` blocks, embeddings, ln_f and head (the same tensors)."""
    import torch

    from vtpu_torch.models.transformer import TransformerLM

    knobs = ("vocab", "d_model", "num_heads", "max_seq", "num_kv_heads",
             "pos_embedding", "attn_window", "kv_cache_dtype",
             "kv_cache_layout", "kv_block_size", "kv_pool_blocks")
    draft = TransformerLM(**{k: getattr(target, k) for k in knobs},
                          depth=depth, device="cuda", dtype=target.dtype)
    draft.wte, draft.ln_f, draft.lm_head = (target.wte, target.ln_f,
                                            target.lm_head)
    if target.pos_embedding == "learned":
        draft.wpe = target.wpe
    draft.h = torch.nn.ModuleList(list(target.h)[:depth])
    return draft


def gen_prompts(reqs, n: int = 2):
    """The first ``n`` requests' prompts cut to their common length."""
    import numpy as np

    length = min(len(p) for _r, p, _n in reqs[:n])
    return np.stack([p[:length] for _r, p, _n in reqs[:n]])


def dense_exactness_phase(card: str, seed: int, reqs) -> None:
    """Depth 2, f32, both cache dtypes: the dense engine's tokens equal
    PagedBatcher's, the dense ``generate`` of each prompt alone, and its
    own eager windows'; speculative decoding on a paged dense-equivalent
    target (a depth-1 draft of its first block) equals the target's
    greedy ``generate``."""
    import torch

    from vtpu_torch.models.transformer import (
        TransformerLM,
        generate,
        generate_speculative,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    small = TransformerLM(**dict(FULL, depth=2), device="cuda",
                          dtype=torch.float32, generator=gen)
    for cache in ("native", "int8"):
        paged = small.clone(kv_cache_dtype=cache)
        dense = paged.clone(kv_cache_layout="dense")
        graphed, _ = serve(dense, reqs, count=False)
        eager, _ = serve(dense, reqs, count=False, decode_graph="off")
        pool, _ = serve(paged, reqs, count=False)
        solo = {rid: generate(dense, p[None], n)[0].tolist()
                for rid, p, n in reqs}
        same = {name: all(graphed[rid] == other[rid] for rid, *_ in reqs)
                for name, other in (("paged", pool), ("generate", solo),
                                    ("eager", eager))}
        emit(phase="dense_exactness", depth=2, dtype="float32", cache=cache,
             requests=len(reqs), dense_equals_paged=same["paged"],
             dense_equals_generate=same["generate"],
             graphed_equals_eager=same["eager"], card=card)
        for name, ok in same.items():
            check(ok, f"f32 dense {cache}: engine tokens differ from "
                      f"{name}")
    target = small.clone(kv_pool_blocks=0)
    prompts = gen_prompts(reqs)
    spec, stats = generate_speculative(target, draft_of(target, 1), prompts,
                                       GEN_NEW, k=4, return_stats=True)
    greedy = generate(target, prompts, GEN_NEW)
    emit(phase="speculative_exactness", depth=2, draft_depth=1, k=4,
         dtype="float32", layout="paged", kv_pool_blocks=0,
         prompts=list(prompts.shape), equals_greedy=torch.equal(spec, greedy),
         verify_forwards=stats["verify_forwards"], card=card)
    check(torch.equal(spec, greedy),
          "f32 speculative tokens differ from the target's greedy decode")
    del small, paged, dense, target
    torch.cuda.empty_cache()


def timed(fn):
    """(result, host seconds) of ``fn`` ended by a synchronize."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def generate_phase(card: str, model, reqs, seed: int) -> dict:
    """The generate entries at full width in bf16 on two prompts: sampled
    (temperature 0.8, top_k 50, a generator seeded on the card), beam 4,
    and speculative (k 4) on the paged dense-equivalent target with a
    depth-2 draft of its first two blocks.  Returns the launches of the
    whole phase (the speculative steps launch the paged kernel)."""
    import torch

    from vtpu_torch.models.transformer import (
        generate,
        generate_beam,
        generate_speculative,
    )

    prompts = gen_prompts(reqs)
    dense = model.clone(kv_cache_layout="dense")
    zero_counts()
    greedy, greedy_s = timed(lambda: generate(dense, prompts, GEN_NEW))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sampled, sampled_s = timed(lambda: generate(
        dense, prompts, GEN_NEW, temperature=0.8, top_k=50, generator=gen))
    top1 = generate(dense, prompts, GEN_NEW, temperature=0.8, top_k=1,
                    generator=gen)
    # the logits each sampled token was drawn from, by the same forwards
    cache = dense.init_cache(prompts.shape[0])
    with torch.no_grad():
        steps = [dense(torch.as_tensor(prompts, device="cuda"),
                       cache)[:, -1]]
        for t in range(GEN_NEW - 1):
            steps.append(dense(sampled[:, t:t + 1], cache)[:, -1])
    scaled = torch.stack(steps, dim=1) / 0.8
    kth = torch.topk(scaled, 50, dim=-1).values[..., -1]
    in_top = bool((scaled.gather(-1, sampled.long()[..., None])[..., 0]
                   >= kth).all())
    emit(phase="generate_sampled", layout="dense", dtype="bfloat16",
         prompts=list(prompts.shape), new=GEN_NEW, temperature=0.8,
         top_k=50, seconds=sampled_s, greedy_seconds=greedy_s,
         tokens_per_s=sampled.numel() / sampled_s,
         top_k_1_equals_greedy=torch.equal(top1, greedy),
         every_token_in_top_k=in_top,
         equal_to_greedy_share=float((sampled == greedy).float().mean()),
         card=card)
    check(torch.equal(top1, greedy), "sampling at top_k=1 is not greedy")
    check(in_top, "a sampled token lies outside its step's top 50")
    beams, beam_s = timed(lambda: generate_beam(dense, prompts, GEN_NEW,
                                                beam=4))
    emit(phase="generate_beam", layout="dense", dtype="bfloat16", beam=4,
         prompts=list(prompts.shape), new=GEN_NEW, seconds=beam_s,
         equal_to_greedy_share=float((beams == greedy).float().mean()),
         card=card)
    check(beams.shape == greedy.shape and bool(
        ((beams >= 0) & (beams < model.vocab)).all()), "beam output")
    del dense
    target = model.clone(kv_pool_blocks=0)
    draft = draft_of(target, 2)
    (spec, stats), spec_s = timed(lambda: generate_speculative(
        target, draft, prompts, GEN_NEW, k=4, return_stats=True))
    tgreedy, tgreedy_s = timed(lambda: generate(target, prompts, GEN_NEW))
    vf = stats["verify_forwards"]
    counts = read_counts()
    emit(phase="generate_speculative", layout="paged", kv_pool_blocks=0,
         dtype="bfloat16", k=4, draft_depth=2, prompts=list(prompts.shape),
         new=GEN_NEW, seconds=spec_s, greedy_seconds=tgreedy_s,
         verify_forwards=vf,
         # drafts kept over drafts proposed (the last round's cut aside)
         draft_acceptance=(GEN_NEW - 1 - vf) / (4 * vf),
         equal_to_greedy_share=float((spec == tgreedy).float().mean()),
         agree_note="information only at bf16: the (k+1)-token verify "
                    "rounds differently from one-token steps",
         launches=counts, card=card)
    check(counts["paged_decode"] > 0,
          "the speculative steps launched no paged kernel")
    check(counts["fused_layernorm"] > 0, "no layernorm launch")
    del target, draft
    torch.cuda.empty_cache()
    return counts


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
    of a tenant at 50 % (its rate over the mean of its rates at 100 %
    read just before and just after, both emitted) within DUTY_TOL
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
             img_s_at_100_before=duty["img_s_at_100_before"],
             img_s_at_100_after=duty["img_s_at_100_after"],
             at_100_after_over_before=duty["at_100_after_over_before"],
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


# -- phase 11: disaggregated serving ---------------------------------------
WIRE_CODECS = ("fp32", "int8", "fp8", "int4")


def codec_bytes_phase(card: str, seed: int) -> None:
    """The wire extract (gather, blockwise codec, pack, D2H, payload) on
    the card against the same extract on the CPU, every codec, over pool
    leaves of the serve widths: bf16 and f32 K/V with a zero block and a
    subnormal block, and the int8 pool's int8 K/V with f32 scales; bytes
    equal.  Then each codec's device time for one request of the
    full-width model (63, 65 and 128 blocks of its 64 pool leaves), its
    bound, and the bytes it hands to the D2H."""
    import torch

    from vtpu_torch.serving import disagg

    gen = torch.Generator(device="cpu").manual_seed(seed)
    geom = (96, 8, 16, 128)
    f32 = torch.randn(geom, generator=gen) * 3
    f32[5] = 0.0
    f32[6] = 1e-45
    leaves = [(torch.randn(geom, generator=gen) * 3).to(torch.bfloat16), f32,
              torch.randint(-128, 128, geom, generator=gen,
                            dtype=torch.int8),
              torch.rand(geom[:3] + (1,), generator=gen) / 127]
    card_leaves = [t.cuda() for t in leaves]
    blocks = [5, 6] + list(range(20, 55))  # 37 blocks
    gathers = disagg._make_wire_gathers()
    for codec in WIRE_CODECS:
        a = disagg._extract_blocks(leaves, blocks, codec,
                                   gathers).payload(0, len(blocks))
        b = disagg._extract_blocks(card_leaves, blocks, codec,
                                   gathers).payload(0, len(blocks))
        emit(phase="disagg_codec_bytes", codec=codec, blocks=len(blocks),
             bytes=len(a), equal=a == b, card=card)
        check(a == b, f"{codec}: card extract bytes differ from the CPU's")
    del card_leaves
    # one request's extract at the serve widths (64 bf16 leaves): 63
    # blocks (a 1000-token request), 65, and 128 -- what the power-of-two
    # pad made of 65 before the extract gathered exactly its blocks
    pool = [torch.randn((130,) + geom[1:], device="cuda",
                        dtype=torch.bfloat16) for _ in range(64)]
    for n in (63, 65, 128):
        idx = torch.arange(1, n + 1, device="cuda").long()
        read = n * 64 * 8 * 16 * 128 * 2
        for codec in WIRE_CODECS:
            q, sc = gathers[codec](pool, idx)
            out = sum(t.numel() * t.element_size() for t in q) + (
                sum(t.numel() * 4 for t in sc) if sc else 0)
            ms = time_ms(lambda: gathers[codec](pool, idx), iters=10)
            # bytes: the gathered rows read once, the extract written once
            b_ms, by = bound(read + out, 0, "float32")
            emit(phase="disagg_extract", codec=codec, blocks=n, leaves=64,
                 ms=ms, bound_ms=b_ms, bound_by=by, d2h_bytes=out,
                 card=card)
    # the wire's host work on one chunk of that request (the default 4
    # blocks of its 64 leaves): the extract's payload join, the frame's
    # encode and decode (each with its crc32), the crc32 alone, and the
    # receiver's copy to the card (pinned staging, H2D, waited for)
    from vtpu_torch.serving import transport as ttp

    ex = disagg._extract_blocks(pool, list(range(1, 64)), "fp32", gathers)
    payload = ex.payload(0, 4)
    frame = ttp.encode_frame(ttp.KIND_DATA, bytes(16), seq=1, nchunks=16,
                             nblocks=4, payload=payload)

    def host_ms(fn, n: int = 10) -> float:
        fn()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e3

    def to_card():
        disagg.chunk_to_device(frame[-len(payload):], torch.device("cuda"))
        torch.cuda.synchronize()

    steps = {"payload": lambda: ex.payload(0, 4),
             "encode_frame": lambda: ttp.encode_frame(
                 ttp.KIND_DATA, bytes(16), seq=1, nchunks=16, nblocks=4,
                 payload=payload),
             "decode_frame": lambda: ttp.decode_frame(frame),
             "crc32": lambda: zlib.crc32(payload),
             "to_card": to_card}
    ms = {k: host_ms(fn) for k, fn in steps.items()}
    emit(phase="disagg_wire_host", chunk_bytes=len(payload), ms=ms,
         gb_per_s={k: len(payload) / v / 1e6 for k, v in ms.items()},
         card=card)
    del pool, ex
    torch.cuda.empty_cache()


def disagg_arm(model, reqs, mono, *, mode: str, codec=None,
               count: bool, prefix_cache: bool = False,
               waves: bool = False):
    """Serve ``reqs`` (all submitted at t=0) through a PrefillEngine and
    a DecodeEngine(max_batch=8): ``shared`` (one pool), ``copy`` (a
    standalone prefill pool, device copy) or ``wire`` (the port's
    StreamSender -> LoopbackLink -> ReceiverHub -> DecodeEngine under
    ``codec``, speculative adoption on).  ``prefix_cache`` turns on the
    prefill engine's prefix cache and hands each result's chain to the
    decode side; with ``waves`` the first request is driven to its FIN
    before the rest are submitted, so that both registries hold its chain
    first (each request's TTFT from its own submit).  Returns (outputs,
    metrics); ``mono`` is the monolithic engine's tokens for the same
    requests.  With ``count`` the kernels' launch counts are zeroed just
    before and read just after.  The engines die with the call
    (``release_arm`` measures what is left); blocks the registries still
    pin at the end are not leaks."""
    import torch

    from vtpu_torch.serving import transport as ttp
    from vtpu_torch.serving.disagg import (
        DecodeEngine,
        PrefillEngine,
        wire_leaves,
    )

    dec = DecodeEngine(model, max_batch=8)
    pf = PrefillEngine(model, shared_with=dec if mode == "shared" else None,
                       prefix_cache=prefix_cache)
    windows, handoff, skips = [], [], []
    # forwards outside the decode windows (the prefill engine's), by a
    # hook, as in ``serve``: the launch checks' lower bounds
    prefill_forwards, in_window = [0], [False]
    timed_windows(dec, windows, in_window)
    hook = model.register_forward_hook(
        lambda *_: prefill_forwards.__setitem__(
            0, prefill_forwards[0] + (not in_window[0])))
    rep = None
    # (source rows, adopted rows) of every stream, copied on the device
    # at FIN into buffers sized for the run's leases before it starts:
    # the sender frees its blocks and decode appends to the tail block
    # after FIN; the errors are computed once the run is over
    snap, snap_at, snap_s = [], [0], [0.0]
    if mode == "wire":
        rep = ttp.WireReplica(ttp.LoopbackLink(ttp.ReceiverHub(dec)), "w0",
                              local=dec, codec=codec)
        finish = dec.wire_finish
        bs = model.kv_block_size
        cap = sum(-(-(len(p) + n) // bs) + 1 for _r, p, n in reqs)
        for pair in zip(pf.pool_leaves(), wire_leaves(dec.cache["layers"])):
            snap.append(tuple(torch.empty((cap,) + t.shape[1:],
                                          dtype=t.dtype, device=t.device)
                              for t in pair))

        def wire_finish(ctx, meta):
            finish(ctx, meta)
            handoff.append((ctx["finished"] - ctx["opened"]) * 1e3)
            skips.append(ctx["skip"])
            t = time.perf_counter()
            # the blocks that shipped (a suffix-only stream skips the
            # prefix the decode registry holds)
            lo, blocks = snap_at[0], meta["handle"]["blocks"][ctx["skip"]:]
            hi = snap_at[0] = lo + len(blocks)
            check(hi <= cap, f"snapshot room: {hi} blocks of {cap}")
            si = torch.as_tensor(blocks, device=model.device).long()
            di = torch.as_tensor(ctx["dst"], device=model.device).long()
            for (sb, db), sl, dl in zip(snap, pf.pool_leaves(),
                                        wire_leaves(dec.cache["layers"])):
                torch.index_select(sl, 0, si, out=sb[lo:hi])
                torch.index_select(dl, 0, di, out=db[lo:hi])
            snap_s[0] += time.perf_counter() - t

        dec.wire_finish = wire_finish
    else:
        name = "_copy_rows" if mode == "copy" else "_bind_rows"
        inner = getattr(dec, name)

        def timed_handoff(entries):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            inner(entries)
            e.record()
            handoff.append((s, e, len(entries)))

        setattr(dec, name, timed_handoff)
    torch.cuda.synchronize()
    if count:
        zero_counts()
    t0 = time.perf_counter()
    later = list(reqs[1:]) if waves else []
    submitted = {}
    for rid, prompt, n in reqs[:1] if waves else reqs:
        pf.submit(rid, prompt, num_new=n)
        submitted[rid] = t0
    ttft = {}
    src = pf if mode == "copy" else None
    # the loop's host seconds by part: prefill rounds, handoff (the
    # OPENs and pumps, or the adoptions), decode steps
    host_s = {"prefill": 0.0, "handoff": 0.0, "decode": 0.0}
    while (later or pf.queue or dec.queue or any(dec.active)
           or dec._inflight or (rep is not None and rep.idle_senders())):
        if (later and not pf.queue and reqs[0][0] in dec.out
                and not (rep is not None and rep.idle_senders())):
            t = time.perf_counter()  # the first request is adopted
            for rid, prompt, n in later:
                pf.submit(rid, prompt, num_new=n)
                submitted[rid] = t
            later = []
        t = time.perf_counter()
        results = pf.step()
        t1 = time.perf_counter()
        for res in results:
            chain = list(res.chain) or None
            if rep is not None:
                rep.submit_handle(res.rid, res.handle, res.first_token,
                                  res.num_new, source=pf, admit=False,
                                  chain=chain)
            else:
                dec.submit_handle(res.rid, res.handle, res.first_token,
                                  res.num_new, source=src, admit=False,
                                  chain=chain)
        if rep is not None:
            rep.pump_streams()
        else:
            dec.admit_pending()
        t2 = time.perf_counter()
        dec.step()
        now = time.perf_counter()
        host_s["prefill"] += t1 - t
        host_s["handoff"] += t2 - t1
        host_s["decode"] += now - t2
        for rid, toks in dec.out.items():
            if toks and rid not in ttft:
                ttft[rid] = now - submitted[rid]
    out = dec.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts() if count else None
    hook.remove()
    # the largest error, the largest over its own block's bound, and the
    # largest adopted value (the pool's rounding of it is in the bound)
    err, err_ratio, top = 0.0, None, 0.0
    for sb, db in snap:
        e, r = block_error(sb[:snap_at[0]], db[:snap_at[0]], codec)
        err = max(err, e)
        err_ratio = r if err_ratio is None else max(err_ratio, r)
        if snap_at[0]:
            top = max(top, float(db[:snap_at[0]].float().abs().max()))
    pool_dtype = snap[0][1].dtype if snap else None
    snap.clear()
    if mode == "wire":
        per_req = sorted(handoff)
    else:
        per_req = sorted(s.elapsed_time(e) / n for s, e, n in handoff)
    ms = sum(s.elapsed_time(e) for _k, _a, s, e, *_ in windows)
    toks = sum(k * a for k, a, *_ in windows)
    replays = [w for w in windows if w[4]]
    rms = sum(s.elapsed_time(e) for _k, _a, s, e, *_ in replays)
    rsteps = sum(k for k, *_ in replays)
    # every slot active: the step's attention over 8 real rows
    full = [w for w in replays if w[1] == dec.max_batch]
    fms = sum(s.elapsed_time(e) for _k, _a, s, e, *_ in full)
    fsteps = sum(k for k, *_ in full)
    pairs = [(x, y) for rid, *_ in reqs
             for x, y in zip(out.get(rid, []), mono[rid])]
    dst, srcp = dec.pool.stats(), pf.pool.stats()
    hub = rep.link.hub.stats() if rep is not None else {}
    ttfts = sorted(ttft.values())
    metrics = dict(
        requests=len(reqs),
        finished=sum(len(out.get(rid, [])) == n for rid, _p, n in reqs),
        agree_share=sum(x == y for x, y in pairs) / max(1, len(pairs)),
        tokens_equal_mono=all(out.get(rid) == mono[rid]
                              for rid, *_ in reqs),
        max_abs_err=err if mode == "wire" else None,
        error_bound=(wire_error_bound(dec.wire_quant_max_scale, top, codec,
                                      pool_dtype)
                     if mode == "wire" and codec != "fp32" else None),
        max_adopted_abs=(top if mode == "wire" and codec != "fp32"
                         else None),
        wire_quant_max_scale=(dec.wire_quant_max_scale
                              if mode == "wire" else None),
        max_err_over_block_bound=err_ratio,
        leaked_decode_pool=(dst["leased"] - dst["prefix_blocks"]
                            + dst["detached_handles"]),
        leaked_prefill_pool=(srcp["leased"] - srcp["prefix_blocks"]
                             + srcp["detached_handles"]),
        registry_blocks=[dst["prefix_blocks"], srcp["prefix_blocks"]],
        prefix_hits=pf.prefix_hits,
        prefix_tokens_skipped=pf.prefix_tokens_skipped,
        skip_blocks=skips if mode == "wire" else None,
        handoffs=dst[f"handoff_{mode}"],
        handoff_host_bytes=dst["handoff_host_bytes"],
        handoff_device_bytes=dst["handoff_device_bytes"],
        wire_bytes_per_request=(hub.get("bytes", 0) / len(reqs)
                                if rep is not None else 0),
        handoff_ms_mean=sum(per_req) / len(per_req) if per_req else None,
        handoff_ms_p50=per_req[len(per_req) // 2] if per_req else None,
        ttft_s_p50=ttfts[len(ttfts) // 2] if ttfts else None,
        ttft_s_max=ttfts[-1] if ttfts else None,
        decode_tokens_per_s=toks / (ms / 1e3) if ms else None,
        decode_step_ms_replayed=rms / rsteps if rsteps else None,
        decode_step_ms_replayed_full=fms / fsteps if fsteps else None,
        windows=len(windows), replayed_windows=len(replays),
        replayed_windows_full=len(full),
        spec_adoptions=dst["spec_adoptions"],
        prefill_forwards=prefill_forwards[0], decode_steps=dec.steps,
        wall_s=wall, host_s=host_s, check_snapshot_host_s=snap_s[0],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts)
    for attr in ("_step_k", "wire_finish", "_copy_rows", "_bind_rows"):
        dec.__dict__.pop(attr, None)  # the wrappers hold the engine
    return out, metrics


PREFIX_TOKENS = 512                # the prefix arm's shared prefix
SPILL_POOL = 1 + 128               # the spill arm's prefill pool


def make_prefix_requests(seed: int, n: int = 16, num_new: int = 32):
    """``n`` prompts of one shared ``PREFIX_TOKENS``-token prefix (32
    blocks) and a suffix of their own, 64 to 488 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, FULL["vocab"], PREFIX_TOKENS).astype(np.int32)
    return [(f"p{i}", np.concatenate([prefix, rng.integers(
        0, FULL["vocab"], int(rng.integers(64, 489))).astype(np.int32)]),
        num_new) for i in range(n)]


def timed_windows(eng, windows: list, in_window: list) -> None:
    """Record each decode window of ``eng`` as (k, active slots, start
    and end CUDA events, replayed, host clock at dispatch); ``in_window``
    flags the forwards a window runs."""
    import torch

    step_k = eng._step_k

    def timed(k):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        active, replay = sum(eng.active), k in eng._graphs
        in_window[0] = True
        t = time.perf_counter()
        s.record()
        try:
            out = step_k(k)
        finally:
            in_window[0] = False
        e.record()
        windows.append((k, active, s, e, replay, t))
        return out

    eng._step_k = timed


def wire_error_bound(max_scale: float, max_value: float, codec: str,
                     pool_dtype) -> float:
    """The largest error a stream's adopted blocks may show against
    their source: the codec's bound at the stream's largest scale (the
    f32 reconstruction, ``wirecodec.error_bound``) plus the pool's own
    rounding of the reconstruction, at most half an ulp of the largest
    adopted value (the JAX scatter rounds the same way)."""
    import torch

    from vtpu_torch.serving import wirecodec

    return (wirecodec.error_bound(max_scale, codec)
            + max_value * torch.finfo(pool_dtype).eps / 2)


def block_error(src, got, codec):
    """(largest |got - src|, largest error over its own block's bound)
    of adopted or onloaded rows against their source rows, on the card;
    the bound of a quantized codec is its scale's (scale/2, fp8 scale*16)
    plus the pool dtype's rounding of the reconstruction."""
    from vtpu_torch.ops.quant import (
        quantize_blockwise,
        quantize_blockwise_fp8,
        quantize_blockwise_int4,
    )

    diff = (got.float() - src.float()).abs()
    quantize = {"int8": quantize_blockwise, "fp8": quantize_blockwise_fp8,
                "int4": quantize_blockwise_int4}.get(codec)
    if quantize is None:
        return float(diff.max()), None
    import torch

    per = quantize(src)[1] * (16.0 if codec == "fp8" else 0.5)
    per = per + torch.maximum(got.float().abs(), src.float().abs()) * (
        torch.finfo(src.dtype).eps / 2)
    return float(diff.max()), float((diff / per).max())


def spill_arm(model, seed: int, *, count: bool):
    """The host spill tier at full width: a PrefillEngine on a standalone
    pool of ``SPILL_POOL`` blocks (a clone sharing the model's weights)
    with the prefix cache, ``host_spill`` (the int8 spill codec) and
    ``persist_dir`` in a temporary directory, handing off by device copy
    to a DecodeEngine(max_batch=8) on the full pool.  Eight prompts of
    distinct ``PREFIX_TOKENS``-token prefixes and suffixes shorter than a
    block (so a prompt's digest chain is its prefix's), then the eight
    prefixes again with new suffixes: the working set (256 prefix blocks)
    is twice the pool, so the first pass demotes and the second onloads.  Every onloaded block must equal the dequantization
    of its payload (parsed by numpy, dequantized on the card) bit for
    bit, and lie within the codec's bound of the block demoted.  Then a
    fresh PrefillEngine on the same directory must rehydrate the journal
    and onload on its first revisit.  Returns (outputs, metrics)."""
    import tempfile

    import numpy as np
    import torch

    from vtpu_torch.ops.quant import dequantize_blockwise
    from vtpu_torch.serving import wirecodec
    from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine

    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, FULL["vocab"], PREFIX_TOKENS).astype(
        np.int32) for _ in range(8)]

    def requests(tag):
        return [(f"{tag}{i}", np.concatenate([p, rng.integers(
            0, FULL["vocab"], int(rng.integers(1, 16))).astype(np.int32)]),
            32) for i, p in enumerate(prefixes)]

    small = model.clone(kv_pool_blocks=SPILL_POOL)
    dec = DecodeEngine(model, max_batch=8)
    windows, in_window, pf_forwards = [], [False], [0]
    timed_windows(dec, windows, in_window)
    hook = model.register_forward_hook(
        lambda *_: pf_forwards.__setitem__(
            0, pf_forwards[0] + (not in_window[0])))
    demoted, onloaded = {}, []
    host = {"demote_s": 0.0, "onload_s": 0.0, "check_s": 0.0}
    onload_events = []

    def instrument(pf):
        store, demote, scatter = (pf.pool.store_spilled, pf._demote_for,
                                  pf._spill_scatter)

        def store_spilled(chain, payload, codec):
            # the run still holds what is demoted: keep it to compare
            t = time.perf_counter()
            run = pf.pool._prefix_runs[chain[-1]]
            demoted[tuple(chain)] = (
                [x[list(run)].clone() for x in pf.pool_leaves()], payload)
            host["check_s"] += time.perf_counter() - t
            store(chain, payload, codec)

        def demote_for(need):
            t, c = time.perf_counter(), host["check_s"]
            try:
                return demote(need)
            finally:
                host["demote_s"] += (time.perf_counter() - t
                                     - (host["check_s"] - c))

        def spill_scatter(blocks, payload, codec):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            s.record()
            scatter(blocks, payload, codec)
            e.record()
            host["onload_s"] += time.perf_counter() - t
            onload_events.append((s, e))
            onloaded.append(([x[list(blocks)].clone()
                              for x in pf.pool_leaves()], payload, codec))

        pf.pool.store_spilled = store_spilled
        pf._demote_for = demote_for
        pf._spill_scatter = spill_scatter

    def drive(pf, reqs):
        for rid, p, n in reqs:
            pf.submit(rid, p, num_new=n)
        while pf.queue or dec.queue or any(dec.active) or dec._inflight:
            for res in pf.step():
                dec.submit_handle(res.rid, res.handle, res.first_token,
                                  res.num_new, source=pf, admit=False)
            dec.admit_pending()
            dec.step()

    torch.cuda.synchronize()
    if count:
        zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="vtpu-spill-") as d:
        pf = PrefillEngine(small, prefix_cache=True, host_spill=True,
                           persist_dir=d)
        check(pf.host_spill and pf._spill_codec == "int8",
              "spill: the engine refused the host tier")
        instrument(pf)
        drive(pf, requests("a"))
        pass1 = dict(demotions=pf.spill_demotions, onloads=pf.spill_onloads)
        drive(pf, requests("b"))
        st = pf.stats()
        pf._persist.close()
        # a restart: a fresh engine on the same journal
        pf2 = PrefillEngine(small, prefix_cache=True, host_spill=True,
                            persist_dir=d)
        st2 = pf2.pool.stats()
        instrument(pf2)
        drive(pf2, requests("c")[:1])
        out = dec.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts() if count else None
        hook.remove()
        pf2_onloads = pf2.spill_onloads
        journal_mb = sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d)) / 1e6
        pf2._persist.close()
    # the onloads against their payloads and their demoted blocks
    exact, err, ratio, max_scale = True, 0.0, 0.0, 0.0
    by_payload = {payload: rows for rows, payload in demoted.values()}
    for rows, payload, codec in onloaded:
        meta = [(int(np.prod(x.shape[1:])), tuple(x.shape[1:]), None)
                for x in rows]
        k = rows[0].shape[0]
        for (scales, q), got, leaf_src in zip(
                wirecodec.split_payload(payload, meta, k, codec), rows,
                by_payload.get(payload, [None] * len(rows))):
            max_scale = max(max_scale, float(scales.max()))
            sc = torch.from_numpy(scales.copy()).cuda().reshape(
                (k,) + (1,) * (got.dim() - 1))
            want = dequantize_blockwise(torch.from_numpy(q.copy()).cuda(),
                                        sc, got.dtype)
            exact = exact and torch.equal(got, want)
            if leaf_src is not None:
                e, r = block_error(leaf_src, got, codec)
                err, ratio = max(err, e), max(ratio, r)
    dst = dec.pool.stats()
    replays = [w for w in windows if w[4]]
    rms = sum(s.elapsed_time(e) for _k, _a, s, e, *_ in replays)
    rsteps = sum(k for k, *_ in replays)
    demotions = st["spill_demotions"]
    metrics = dict(
        requests=17, finished=sum(len(t) == 32 for t in out.values()),
        demotions=demotions, onloads=st["spill_onloads"],
        pass1=pass1, rehydrated_runs=st2["spilled_runs"],
        rehydrated_blocks=st2["spilled_blocks"],
        disk_blocks=st2["disk_blocks"], restart_onloads=pf2_onloads,
        spilled_runs=st["spilled_runs"],
        spill_mb=st["spilled_bytes"] / 1e6, journal_mb=journal_mb,
        payload_mb_per_run=(st["spilled_bytes"] / st["spilled_runs"] / 1e6
                            if st["spilled_runs"] else None),
        demote_host_ms_per_run=host["demote_s"] * 1e3 / max(1, demotions),
        onload_host_ms_per_run=host["onload_s"] * 1e3 / max(
            1, len(onloaded)),
        onload_device_ms_per_run=(sum(s.elapsed_time(e) for s, e in
                                      onload_events) / len(onload_events)
                                  if onload_events else None),
        onloads_bit_equal_payload=exact, onloads_checked=len(onloaded),
        max_abs_err=err, error_bound=wirecodec.error_bound(max_scale,
                                                           "int8"),
        max_err_over_block_bound=ratio,
        prefix_hits=st["prefix_hits"],
        leaked_prefill_pool=(st["leased"] - st["prefix_blocks"]
                             + st["detached_handles"]),
        leaked_decode_pool=dst["leased"] + dst["detached_handles"],
        decode_steps=dec.steps, prefill_forwards=pf_forwards[0],
        replayed_windows=len(replays),
        decode_step_ms_replayed=rms / rsteps if rsteps else None,
        wall_s=wall, check_host_s=host["check_s"], launches=counts)
    dec.__dict__.pop("_step_k", None)
    return out, metrics


def session_arm(model, reqs, mono, *, codec: str = "fp32", count: bool):
    """Live session moves at full width: two DecodeEngines (max_batch 8)
    with pools of their own; a PrefillEngine shares A's pool.  Nine
    requests: eight decode on A, the ninth waits in A's queue (a claimed
    adoption).  After 8 decode steps the port's SessionMover moves four
    live sessions and the queued one to B over the wire (``codec``, the
    port's hub over LoopbackLink, speculative adoption); then both
    engines run to the end.  At each FIN the rows that shipped are copied
    on the card and compared after the run.  Returns (outputs, metrics)."""
    import torch

    from vtpu_torch.serving.disagg import (
        DecodeEngine,
        PrefillEngine,
        wire_leaves,
    )
    from vtpu_torch.serving.migrate import SessionMover

    a = DecodeEngine(model, max_batch=8, replica_id="A")
    b = DecodeEngine(model, max_batch=8, replica_id="B")
    pf = PrefillEngine(model, shared_with=a)
    wins, in_window, pf_forwards = {"A": [], "B": []}, [False], [0]
    timed_windows(a, wins["A"], in_window)
    timed_windows(b, wins["B"], in_window)
    hook = model.register_forward_hook(
        lambda *_: pf_forwards.__setitem__(
            0, pf_forwards[0] + (not in_window[0])))
    pairs = []
    finish = b.wire_finish

    def wire_finish(ctx, meta):
        shipped = meta["handle"]["blocks"][ctx["skip"]:]
        si = torch.as_tensor(shipped, device=model.device).long()
        di = torch.as_tensor(ctx["dst"], device=model.device).long()
        pairs.append([(s.index_select(0, si), d.index_select(0, di))
                      for s, d in zip(wire_leaves(a.cache["layers"]),
                                      wire_leaves(b.cache["layers"]))])
        finish(ctx, meta)

    b.wire_finish = wire_finish
    torch.cuda.synchronize()
    if count:
        zero_counts()
    t0 = time.perf_counter()
    for rid, prompt, n in reqs:
        pf.submit(rid, prompt, num_new=n)
    while pf.queue:
        for res in pf.step():
            a.submit_handle(res.rid, res.handle, res.first_token,
                            res.num_new, admit=False)
    a.admit_pending()
    while a.steps < 8:
        a.step()
    live = [r for r in a.rid if r is not None][:4]
    queued = [pa.rid for pa in a.queue]
    check(len(live) == 4 and len(queued) == 1,
          f"session: {len(live)} live and {len(queued)} queued to move")
    mover = SessionMover(codec=codec)
    t_move = time.perf_counter()
    moves = []
    for rid in live + queued:
        t = time.perf_counter()
        rep = mover.move(rid, a, [("B", b)])
        moves.append(((time.perf_counter() - t) * 1e3, rep))
    moved_s = time.perf_counter()
    while (any(a.active) or a.queue or a._inflight or any(b.active)
           or b.queue or b._inflight):
        a.step()
        b.step()
    a._flush_first_tokens()
    b._flush_first_tokens()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts() if count else None
    hook.remove()
    out = {**a.out, **b.out}
    err = 0.0
    for pair in pairs:
        for s, d in pair:
            err = max(err, block_error(s, d, codec)[0])
    pairs.clear()
    sa, sb = a.pool.stats(), b.pool.stats()
    after = {k: [w for w in ws if w[4] and w[5] >= moved_s]
             for k, ws in wins.items()}
    replays = [w for ws in wins.values() for w in ws if w[4]]
    rms = sum(s.elapsed_time(e) for _k, _a, s, e, *_ in replays)
    rsteps = sum(k for k, *_ in replays)
    ms = sorted(m for m, _r in moves)
    metrics = dict(
        requests=len(reqs),
        finished=sum(len(out.get(rid, [])) == n for rid, _p, n in reqs),
        tokens_equal_mono=all(out.get(rid) == mono[rid]
                              for rid, *_ in reqs),
        agree_share=sum(x == y for rid, *_ in reqs for x, y in zip(
            out.get(rid, []), mono[rid])) / max(1, sum(
                len(mono[rid]) for rid, *_ in reqs)),
        moved=len(moves), moved_live=len(live), moved_queued=len(queued),
        on_b=sum(rid in b.out for rid in live + queued),
        move_ms_per_session=sum(ms) / len(ms), move_ms_p50=ms[len(ms) // 2],
        move_ms_max=ms[-1], moves_s=moved_s - t_move,
        blocks_shipped=[r.blocks_shipped for _m, r in moves],
        blocks_skipped=[r.blocks_skipped for _m, r in moves],
        wire_mb=sum(r.wire_bytes for _m, r in moves) / 1e6, codec=codec,
        max_abs_err=err,
        replayed_steps_after_move={k: sum(w[0] for w in v)
                                   for k, v in after.items()},
        decode_step_ms_replayed=rms / rsteps if rsteps else None,
        decode_steps=a.steps + b.steps, decode_steps_ab=[a.steps, b.steps],
        prefill_forwards=pf_forwards[0],
        leaked_pool_a=sa["leased"] + sa["detached_handles"],
        leaked_pool_b=sb["leased"] + sb["detached_handles"],
        wall_s=wall, launches=counts)
    for eng in (a, b):
        for attr in ("_step_k", "wire_finish"):
            eng.__dict__.pop(attr, None)
    return out, metrics


def release_arm(arm, *args, **kw):
    """``arm(*args, **kw)`` (an arm of this phase), and the device memory
    it left behind (GB)."""
    import torch

    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    out, met = arm(*args, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    met["mem_left_after_release_gb"] = (
        torch.cuda.memory_allocated() - alloc0) / 1e9
    return out, met


def disagg_exactness_phase(card: str, seed: int) -> None:
    """Depth 2, f32, the exactness phase's model on both pools: shared,
    copy and fp32-wire disaggregation give exactly the monolithic
    PagedBatcher's tokens; so do the prefix arm's requests with the
    prefix cache off and on (fp32 wire, two waves), and the session arm
    (fp32 wire), whose moved blocks arrive bit for bit."""
    import torch

    from vtpu_torch.models.transformer import TransformerLM

    gen = torch.Generator(device="cuda").manual_seed(seed)
    small = TransformerLM(**dict(FULL, depth=2), device="cuda",
                          dtype=torch.float32, generator=gen)
    reqs = make_requests(seed)
    preqs = make_prefix_requests(seed + 2)
    sreqs = make_requests(seed + 3, n=9)
    for pool in ("native", "int8"):
        m = small.clone(kv_cache_dtype=pool)
        runs = [(reqs, disagg_arm, dict(mode=mode, codec=codec))
                for mode, codec in (("shared", None), ("copy", None),
                                    ("wire", "fp32"))]
        runs += [(preqs, disagg_arm, dict(mode="wire", codec="fp32",
                                          waves=True, prefix_cache=on))
                 for on in (False, True)]
        runs += [(sreqs, session_arm, dict(codec="fp32"))]
        monos = {}
        for rq, arm, kw in runs:
            key = id(rq)
            if key not in monos:
                monos[key] = serve(m, rq, count=False)[0]
            out, met = release_arm(arm, m, rq, monos[key], count=False, **kw)
            name = ("session" if arm is session_arm else
                    "prefix" if kw.get("waves") else kw["mode"])
            leaked = sum(v for k, v in met.items() if k.startswith("leaked"))
            emit(phase="disagg_exactness", depth=2, dtype="float32",
                 pool=pool, arm=name, codec=kw.get("codec"),
                 prefix_cache=kw.get("prefix_cache"), requests=len(rq),
                 token_identical=met["tokens_equal_mono"],
                 max_abs_err=met["max_abs_err"], leaked=leaked,
                 prefix_hits=met.get("prefix_hits"),
                 skip_blocks=met.get("skip_blocks"),
                 moved=met.get("moved"), card=card)
            what = f"f32 {pool} {name} {kw.get('prefix_cache') or ''}"
            check(met["tokens_equal_mono"],
                  f"{what}: disaggregated tokens differ from the "
                  f"monolithic engine's")
            check(kw.get("codec") != "fp32" or met["max_abs_err"] == 0.0,
                  f"{what}: fp32 wire blocks differ")
            check(leaked == 0, f"{what}: leaked blocks")
            check(not kw.get("prefix_cache")
                  or met["prefix_hits"] == len(rq) - 1,
                  f"{what}: {met.get('prefix_hits')} prefix hits")
    del small, m
    torch.cuda.empty_cache()


def check_launches(what: str, met: dict, depth: int, pool: str) -> None:
    """The serve phase's bounds: LN in every block of every forward (one
    before each of the two sublayers, one at the end), paged decode in
    every layer of every decode step."""
    c = met["launches"]
    paged = "paged_decode_q8" if pool == "int8" else "paged_decode"
    forwards = met["prefill_forwards"] + met["decode_steps"]
    check(met["prefill_forwards"] > 0 and c["fused_layernorm"]
          >= (2 * depth + 1) * forwards,
          f"{what}: layernorm launches {c['fused_layernorm']} for "
          f"{forwards} forwards")
    check(c[paged] >= depth * met["decode_steps"] > 0,
          f"{what}: {paged} launches {c[paged]} for "
          f"{met['decode_steps']} decode steps")


def session_phase(card: str, model, seed: int, pool: str) -> dict:
    """The session arm on ``pool`` (fp32 wire; 4 live sessions and 1
    queued moved A -> B), checked and emitted.  Returns its launches."""
    import torch

    sreqs = make_requests(seed + 3, n=9)
    torch.cuda.reset_peak_memory_stats()
    _out, met = release_arm(session_arm, model, sreqs,
                            serve(model, sreqs, count=False)[0],
                            codec="fp32", count=True)
    emit(phase="disagg_session", pool=pool, depth=model.depth,
         dtype="bfloat16", reduced=REDUCED, card=card, **met)
    what = f"{pool} session"
    check(met["finished"] == len(sreqs), f"{what}: unfinished")
    check(met["moved"] == 5 and met["on_b"] == 5,
          f"{what}: {met['on_b']} of 5 sessions on B")
    check(met["leaked_pool_a"] == 0 and met["leaked_pool_b"] == 0,
          f"{what}: leaked blocks")
    check(met["max_abs_err"] == 0.0, f"{what}: fp32 blocks differ")
    check(all(v > 0 for v in met["replayed_steps_after_move"].values()),
          f"{what}: replayed steps after the move "
          f"{met['replayed_steps_after_move']}")
    check(met["mem_left_after_release_gb"] < 0.5,
          f"{what}: the arm kept {met['mem_left_after_release_gb']} GB")
    check_launches(what, met, model.depth, pool)
    return met["launches"]


def prefix_phase(card: str, model, seed: int) -> dict:
    """The prefix arm (native pool, int8 wire, one shared 512-token
    prefix, two waves) with the prefix cache off and on, checked and
    emitted.  Adopted blocks are held to their own block's bound (the
    codec's scale bound plus the bf16 rounding of the reconstruction).
    Returns the launches of both."""
    import torch

    preqs = make_prefix_requests(seed + 2)
    pmono = serve(model, preqs, count=False)[0]
    prefix, launches = {}, {}
    for on in (False, True):
        torch.cuda.reset_peak_memory_stats()
        _out, met = release_arm(disagg_arm, model, preqs, pmono,
                                mode="wire", codec="int8", waves=True,
                                prefix_cache=on, count=True)
        prefix[on] = met
        emit(phase="disagg_prefix", pool="native", codec="int8",
             prefix_cache=on, depth=model.depth, dtype="bfloat16",
             reduced=REDUCED, prefix_tokens=PREFIX_TOKENS, card=card, **met)
        what = f"prefix cache {'on' if on else 'off'}"
        check(met["finished"] == len(preqs), f"{what}: unfinished")
        check(met["leaked_decode_pool"] == 0
              and met["leaked_prefill_pool"] == 0, f"{what}: leaked blocks")
        check(met["max_err_over_block_bound"] <= 1.0,
              f"{what}: an adopted block past its own bound")
        check(met["replayed_windows"] > 0, f"{what}: no graph replay")
        check(met["mem_left_after_release_gb"] < 0.5,
              f"{what}: the arm kept {met['mem_left_after_release_gb']} GB")
        check_launches(what, met, model.depth, "native")
        tally(launches, met["launches"])
    hits = prefix[True]
    check(hits["prefix_hits"] == len(preqs) - 1
          and hits["prefix_tokens_skipped"] == PREFIX_TOKENS
          * (len(preqs) - 1),
          f"prefix: {hits['prefix_hits']} hits skipping "
          f"{hits['prefix_tokens_skipped']} tokens")
    blocks = PREFIX_TOKENS // FULL["kv_block_size"]
    check(sorted(hits["skip_blocks"]) == [0] + [blocks] * (len(preqs) - 1),
          f"prefix: skip_blocks {hits['skip_blocks']}")
    check(prefix[False]["prefix_hits"] == 0
          and not any(prefix[False]["skip_blocks"]),
          "prefix off: a hit or a skip")
    emit(phase="disagg_prefix_saving",
         wire_mb_per_request=[prefix[o]["wire_bytes_per_request"] / 1e6
                              for o in (False, True)],
         ttft_s_p50=[prefix[o]["ttft_s_p50"] for o in (False, True)],
         prefill_host_s=[prefix[o]["host_s"]["prefill"]
                         for o in (False, True)], card=card)
    return launches


def spill_phase(card: str, model, seed: int) -> dict:
    """The spill arm, checked and emitted: an onloaded block is within the
    codec's bound of the block demoted, each held to its own block's
    scale plus the bf16 rounding of the reconstruction.  Returns its
    launches."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    _out, met = release_arm(spill_arm, model, seed + 4, count=True)
    emit(phase="disagg_spill", pool="native", codec="int8",
         prefill_pool_blocks=SPILL_POOL, depth=model.depth,
         dtype="bfloat16", reduced=REDUCED, card=card, **met)
    check(met["finished"] == met["requests"], "spill: unfinished")
    check(met["demotions"] >= 1 and met["onloads"] >= 1,
          f"spill: {met['demotions']} demotions, {met['onloads']} onloads")
    check(met["onloads_bit_equal_payload"] and met["onloads_checked"] >= 1,
          "spill: an onloaded block is not its payload's dequantization")
    check(met["max_err_over_block_bound"] <= 1.0,
          f"spill: onloaded blocks {met['max_err_over_block_bound']} of "
          f"their own bound off their source")
    check(met["rehydrated_runs"] >= 1 and met["restart_onloads"] >= 1,
          f"spill: restart rehydrated {met['rehydrated_runs']} runs, "
          f"onloaded {met['restart_onloads']}")
    check(met["leaked_decode_pool"] == 0 and met["leaked_prefill_pool"] == 0,
          "spill: leaked blocks")
    check(met["replayed_windows"] > 0, "spill: no graph replay")
    check(met["mem_left_after_release_gb"] < 0.5,
          f"spill: the arm kept {met['mem_left_after_release_gb']} GB")
    check_launches("spill", met, model.depth, "native")
    return met["launches"]


def disagg_phase(card: str, seed: int, mono_out=None) -> dict:
    """Phase 11 (the module docstring): the serve configuration at full
    width through the disaggregated engines.  ``mono_out`` holds the
    serve phase's monolithic tokens per pool (computed here when
    absent).  Returns the kernels' launches over the arms."""
    import torch

    from vtpu_torch.models.transformer import TransformerLM

    t_phase = time.perf_counter()
    codec_bytes_phase(card, seed)
    disagg_exactness_phase(card, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = TransformerLM(**FULL, device="cuda", dtype=torch.bfloat16,
                          generator=gen)  # the serve phase's weights
    depth = model.depth
    serve(model, make_requests(seed + 1, n=1, num_new=2), count=False)
    reqs = make_requests(seed)
    launches = {}
    for pool in ("native", "int8"):
        m = model if pool == "native" else model.clone(kv_cache_dtype="int8")
        mono = (mono_out or {}).get(pool) or serve(m, reqs, count=False)[0]
        arms = [("shared", None), ("copy", None)] + [
            ("wire", c) for c in (WIRE_CODECS if pool == "native"
                                  else ("fp32",))]
        for mode, codec in arms:
            torch.cuda.reset_peak_memory_stats()
            _out, met = release_arm(disagg_arm, m, reqs, mono, mode=mode,
                                    codec=codec, count=True)
            emit(phase="disagg", pool=pool, arm=mode, codec=codec,
                 depth=depth, dtype="bfloat16", reduced=REDUCED,
                 agree_note="information only: bf16 admission groups "
                            "round differently from the monolithic "
                            "engine's", card=card, **met)
            what = f"{pool} {mode} {codec or ''}"
            check(met["finished"] == len(reqs), f"{what}: unfinished")
            check(met["leaked_decode_pool"] == 0
                  and met["leaked_prefill_pool"] == 0,
                  f"{what}: leaked blocks")
            check(mode == "wire" or met["handoff_host_bytes"] == 0,
                  f"{what}: {met['handoff_host_bytes']} handoff host bytes")
            check(met["handoffs"] == len(reqs), f"{what}: handoffs")
            if mode == "wire":
                check(met["max_abs_err"] <= (met["error_bound"] or 0.0),
                      f"{what}: adopted blocks {met['max_abs_err']} off, "
                      f"bound {met['error_bound']}")
                check((met["max_err_over_block_bound"] or 0.0) <= 1.0,
                      f"{what}: an adopted block past its own bound")
                check(met["spec_adoptions"] > 0,
                      f"{what}: no speculative adoption")
            check(met["replayed_windows"] > 0,
                  f"{what}: no decode window was a graph replay")
            check(met["mem_left_after_release_gb"] < 0.5,
                  f"{what}: the arm kept "
                  f"{met['mem_left_after_release_gb']} GB")
            check_launches(what, met, depth, pool)
            tally(launches, met["launches"])
        tally(launches, session_phase(card, m, seed, pool))
        del m
    tally(launches, prefix_phase(card, model, seed))
    tally(launches, spill_phase(card, model, seed))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="disagg_phase", seconds=time.perf_counter() - t_phase,
         card=card)
    return launches


# -- phase 13: the serving front door ---------------------------------------
ROUTER_SESSIONS = 8                # the serve phase's 16 requests over these
ROUTER_SATURATE_POOL = 1 + 8 * 32  # arm (c)'s decode pool: the wire parks
ROUTER_FAIL_THRESHOLD = 3


def router_arm(model, reqs, mono, *, mode: str, codec=None, traced=False,
               drain=False, decode_pool: int = 0):
    """Serve ``reqs`` through the port's Router: one PrefillEngine (its own
    pool) and two DecodeEngine(max_batch=8) replicas (``copy``) or one
    reached by the loopback wire under ``codec`` (``wire``; with
    ``decode_pool`` its pool holds that many blocks, so that the wire
    saturates and the Router parks).  Sessions are ``sess<i % 8>``.  With
    ``traced``, the same requests (new ids, the same sessions) go through
    the same Router and engines a second time with tracing on, and a
    third time with tracing switched on and off at every pump, so that
    the runs share every allocation and graph and the third one's windows
    of either kind share the device's state too.  With ``drain``, the
    first eight requests are admitted and adopted, the replica holding
    the most of them then fails every ping until the Router drains it
    (``fail_threshold`` pings), and the last eight come as new sessions.
    The driver stamps each request's submit and the moment the host holds
    its first token (the adoption, or a speculative OPEN) on the host
    clock; a traced run's ledger records them too.  The kernels' launch
    counts are zeroed just before each run and read just after.  Returns
    (outputs, metrics), a traced run's metrics under ``traced``."""
    import collections

    import torch

    from vtpu_torch.obs import events
    from vtpu_torch.serving import kvpool as tkv
    from vtpu_torch.serving import transport as ttp
    from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
    from vtpu_torch.serving.reqtrace import LEDGER, STAGES
    from vtpu_torch.serving.router import Router, RouterReject
    from vtpu_torch.utils import trace

    dmodel = (model.clone(kv_pool_blocks=decode_pool) if decode_pool
              else model)
    pf = PrefillEngine(model, device=model.device)
    decs = {f"d{i}": DecodeEngine(dmodel, max_batch=8, replica_id=f"d{i}",
                                  device=model.device)
            for i in range(1 if mode == "wire" else 2)}
    windows, in_window, first = [], [False], {}
    prefill_forwards = [0]
    for dec in decs.values():
        timed_windows(dec, windows, in_window)
        adopt, wopen = dec._adopt_group, dec.wire_open

        def stamped_adopt(group, adopt=adopt):
            adopt(group)
            t = time.perf_counter()
            for _slot, pa, _dst in group:
                first.setdefault(pa.rid, t)

        def stamped_open(rid, *a, wopen=wopen, dec=dec, **kw):
            ctx = wopen(rid, *a, **kw)
            if ctx is not None and rid in dec.out:  # speculative publish
                first.setdefault(rid, time.perf_counter())
            return ctx

        dec._adopt_group, dec.wire_open = stamped_adopt, stamped_open
    hook = model.register_forward_hook(
        lambda *_: prefill_forwards.__setitem__(
            0, prefill_forwards[0] + (not in_window[0])))
    if mode == "wire":
        reps = {"w0": ttp.WireReplica(
            ttp.LoopbackLink(ttp.ReceiverHub(decs["d0"])), "w0",
            local=decs["d0"], codec=codec)}
    else:
        reps = dict(decs)
    router = Router(pf, reps, fail_threshold=ROUTER_FAIL_THRESHOLD,
                    migrate_on_drain=False)
    journal = events.journal()
    was = trace.tracing()

    def drive(reqs, tracing) -> dict:
        """One run of ``reqs``; ``tracing`` True, False or "alternate"
        (flipped at every pump, each window tagged with the state it was
        dispatched under)."""
        seq0 = journal.snapshot()[-1]["seq"] if len(journal) else 0
        trace.tracing(tracing is True)
        trace.clear()
        LEDGER.clear()
        windows.clear()
        prefill_forwards[0] = 0
        steps0 = sum(d.steps for d in decs.values())
        shed0 = router.stats()["shed"]
        host0 = tkv.HANDOFF_HOST_BYTES.value()
        wire0 = ttp.TRANSPORT_BYTES.value()
        parks0 = ttp.TRANSPORT_STREAMS.value(outcome="saturated")
        submitted, route_of, rejects = {}, {}, [0]

        def submit(rid, prompt, n, sess):
            while True:
                submitted[rid] = time.perf_counter()
                try:
                    route_of[rid] = router.submit(sess, rid, prompt, n)
                    return
                except RouterReject:
                    rejects[0] += 1
                    router.pump()

        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        extra = {}
        if drain:
            for i, (rid, p, n) in enumerate(reqs[:8]):
                submit(rid, p, n, f"sess{i % ROUTER_SESSIONS}")
            while any(rid not in first for rid, *_ in reqs[:8]):
                router.pump()
            victim = collections.Counter(
                route_of[rid] for rid, *_ in reqs[:8]).most_common(1)[0][0]
            decs[victim].ping = lambda: False
            for _ in range(ROUTER_FAIL_THRESHOLD):
                router.check_health()
                router.pump()
            extra.update(victim=victim,
                         drained=victim not in router.stats()["healthy"])
            for i, (rid, p, n) in enumerate(reqs[8:]):
                submit(rid, p, n, f"new{i}")
        else:
            for i, (rid, p, n) in enumerate(reqs):
                submit(rid, p, n, f"sess{i % ROUTER_SESSIONS}")
        tags = []
        if tracing == "alternate":
            while not router.idle():
                on = not trace.tracing()
                trace.tracing(on)
                n0 = len(windows)
                router.pump()
                tags += [on] * (len(windows) - n0)
            out = router.results()
        else:
            out = router.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        out = {rid: out[rid] for rid, *_ in reqs if rid in out}
        ttfts = sorted(first[rid] - submitted[rid] for rid, *_ in reqs
                       if rid in first)
        ms = sum(s.elapsed_time(e) for _k, _a, s, e, *_ in windows)
        toks = sum(k * a for k, a, *_ in windows)
        replays = [w for w in windows if w[4]]
        rms = sum(s.elapsed_time(e) for _k, _a, s, e, *_ in replays)
        rsteps = sum(k for k, *_ in replays)
        full = [w for w in replays if w[1] == 8]
        fms = sum(s.elapsed_time(e) for _k, _a, s, e, *_ in full)
        fsteps = sum(k for k, *_ in full)
        pools = [pf.pool] + [d.pool for d in decs.values()]
        leaked = sum(p.stats()["leased"] - p.stats()["prefix_blocks"]
                     + p.stats()["detached_handles"] for p in pools)
        # a rerun's ids are the first run's with a letter appended
        want = {rid: mono[rid] if rid in mono else mono[rid[:-1]]
                for rid, *_ in reqs}
        pairs = [(x, y) for rid, *_ in reqs
                 for x, y in zip(out.get(rid, []), want[rid])]
        evs = [r for r in journal.snapshot() if r["seq"] > seq0]
        met = dict(
            requests=len(reqs), sessions=ROUTER_SESSIONS, tracing=tracing,
            finished=sum(len(out.get(rid, [])) == n for rid, _p, n in reqs),
            tokens_equal_mono=all(out.get(rid) == want[rid]
                                  for rid, *_ in reqs),
            agree_share=sum(x == y for x, y in pairs) / max(1, len(pairs)),
            routes=dict(collections.Counter(route_of.values())),
            rejects=rejects[0], router_shed=router.stats()["shed"] - shed0,
            parks=int(ttp.TRANSPORT_STREAMS.value(outcome="saturated")
                      - parks0),
            handoff_host_bytes=int(tkv.HANDOFF_HOST_BYTES.value() - host0),
            wire_bytes=int(ttp.TRANSPORT_BYTES.value() - wire0),
            leaked_blocks=leaked,
            tokens=sum(len(t) for t in out.values()), wall_s=wall,
            tokens_per_s=sum(len(t) for t in out.values()) / wall,
            decode_tokens_per_s=toks / (ms / 1e3) if ms else None,
            decode_tokens_per_s_replayed=(
                sum(k * act for k, act, *_ in replays) / (rms / 1e3)
                if rms else None),
            decode_step_ms_replayed=rms / rsteps if rsteps else None,
            decode_step_ms_replayed_full=fms / fsteps if fsteps else None,
            windows=len(windows), replayed_windows=len(replays),
            ttft_s_min=ttfts[0] if ttfts else None,
            ttft_s_p50=ttfts[len(ttfts) // 2] if ttfts else None,
            ttft_s_max=ttfts[-1] if ttfts else None,
            prefill_forwards=prefill_forwards[0],
            decode_steps=sum(d.steps for d in decs.values()) - steps0,
            events=collections.Counter(r["type"] for r in evs),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=counts, **extra)
        if drain:
            met.update(
                drained_events=[r.get("node") for r in evs if r["type"]
                                == events.EventType.REPLICA_DRAINED],
                new_session_routes=sorted({route_of[rid]
                                           for rid, *_ in reqs[8:]}),
                victim_finished=sum(len(out.get(rid, [])) == n
                                    for rid, _p, n in reqs[:8]
                                    if route_of[rid] == extra["victim"]))
        if tracing == "alternate":
            def replay_ms(on):
                ws = [w for w, t in zip(windows, tags) if w[4] and t == on]
                return (sum(s.elapsed_time(e) for _k, _a, s, e, *_ in ws)
                        / max(1, sum(k for k, *_ in ws)), len(ws))
            (met["step_ms_on"], met["windows_on"]), (
                met["step_ms_off"], met["windows_off"]) = (
                replay_ms(True), replay_ms(False))
        elif tracing:
            docs = {rid: LEDGER.get(rid) for rid, *_ in reqs}
            done = {rid: d for rid, d in docs.items()
                    if d and d["ttft_s"] is not None and rid in first}
            stages = {s: sorted(1e3 * d["stages"][s] for d in done.values())
                      for s in STAGES[:5]}
            errs = [abs(sum(d["stages"][s] for s in STAGES[:5])
                        - (first[rid] - submitted[rid]))
                    / (first[rid] - submitted[rid])
                    for rid, d in done.items()]
            spans = collections.Counter(
                sp["name"] for sp in trace.recent_spans(n=2048))
            met.update(
                stage_ms_p50={s: v[len(v) // 2] if v else None
                              for s, v in stages.items()},
                stage_share_of_ttft_p50={
                    s: (v[len(v) // 2] / (1e3 * met["ttft_s_p50"])
                        if v and met["ttft_s_p50"] else None)
                    for s, v in stages.items()},
                requests_attributed=len(errs),
                stage_sum_max_rel_err=max(errs) if errs else None,
                ledger=LEDGER.stats(), spans=dict(spans),
                span_count=sum(spans.values()))
        else:
            met.update(span_count=len(trace.recent_spans(n=2048)),
                       ledger=LEDGER.stats())
        return out, met

    try:
        out, met = drive(reqs, False)
        if traced:
            out_t, met["traced"] = drive(
                [(rid + "t", p, n) for rid, p, n in reqs], True)
            out_a, met["alternate"] = drive(
                [(rid + "a", p, n) for rid, p, n in reqs], "alternate")
            out.update(out_t)
            out.update(out_a)
    finally:
        trace.tracing(was)
        trace.clear()
        LEDGER.clear()
        hook.remove()
        for dec in decs.values():
            for attr in ("_step_k", "_adopt_group", "wire_open", "ping"):
                dec.__dict__.pop(attr, None)  # the wrappers hold the engine
    return out, met


def check_router_arm(what: str, met: dict, depth: int) -> None:
    check(met["finished"] == met["requests"], f"{what}: unfinished")
    check(met["leaked_blocks"] == 0, f"{what}: leaked blocks")
    check(met["replayed_windows"] > 0,
          f"{what}: no decode window was a graph replay")
    check(met["mem_left_after_release_gb"] < 0.5,
          f"{what}: the arm kept {met['mem_left_after_release_gb']} GB")
    check_launches(what, met, depth, "native")


def router_phase(card: str, seed: int, serve_native: dict) -> dict:
    """Phase 13 (the module docstring): the serve configuration at full
    width behind the port's Router, then its f32 depth-2 exactness.
    ``serve_native`` is the serve phase's native-pool metrics.  Returns
    the kernels' launches over the arms."""
    import torch

    from vtpu_torch.models.transformer import TransformerLM

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = TransformerLM(**FULL, device="cuda", dtype=torch.bfloat16,
                          generator=gen)  # the serve phase's weights
    depth = model.depth
    reqs = make_requests(seed)
    mono, ref_met = serve(model, reqs, count=False)
    # the monolithic engine of this phase, beside the serve phase's: a
    # fresh engine's replayed step varies between instances (PERF.md)
    emit(phase="router_reference", engine="PagedBatcher",
         decode_step_ms_replayed=ref_met["decode_step_ms_replayed"],
         serve_phase_step_ms_replayed=serve_native["decode_step_ms_replayed"],
         card=card)
    launches, mets = {}, {}
    arms = (("a_copy", dict(mode="copy", traced=True)),
            ("c_wire_int8", dict(mode="wire", codec="int8",
                                 decode_pool=ROUTER_SATURATE_POOL)),
            ("d_drain", dict(mode="copy", drain=True)))
    for name, kw in arms:
        torch.cuda.reset_peak_memory_stats()
        _out, met = release_arm(router_arm, model, reqs, mono, **kw)
        runs = [(name, met)]
        if "traced" in met:  # arm (b): the same engines, tracing on
            alt = met.pop("alternate")
            check_launches("alternating run", alt, depth, "native")
            tally(launches, alt["launches"])
            met["traced"]["mem_left_after_release_gb"] = met[
                "mem_left_after_release_gb"]
            runs.append(("b_copy_traced", met.pop("traced")))
        for what, m in runs:
            mets[what] = m
            emit(phase="router", arm=what, depth=depth, dtype="bfloat16",
                 codec=kw.get("codec"), decode_pool=kw.get("decode_pool"),
                 reduced=REDUCED, agree_note="information only: bf16 "
                 "admission groups round differently from the monolithic "
                 "engine's", card=card, **m)
            check_router_arm(what, m, depth)
            check(m["handoff_host_bytes"] == (
                m["wire_bytes"] if kw["mode"] == "wire" else 0),
                f"{what}: {m['handoff_host_bytes']} handoff host bytes")
            tally(launches, m["launches"])
    a, b, c, d = (mets[k] for k in ("a_copy", "b_copy_traced",
                                    "c_wire_int8", "d_drain"))
    check(a["span_count"] == 0 and a["ledger"]["completed"] == 0,
          "tracing off recorded spans or ledger records")
    check(b["requests_attributed"] == len(reqs)
          and b["stage_sum_max_rel_err"] <= 0.05,
          f"traced arm: {b['requests_attributed']} records, stage sums "
          f"{b['stage_sum_max_rel_err']} off the measured TTFT")
    check(c["parks"] > 0, "the wire arm never parked a handoff")
    check(d["drained"] and d["victim"] in d["drained_events"],
          "the failing replica was not drained")
    check(d["new_session_routes"] == sorted(
        set(d["routes"]) - {d["victim"]}) and d["victim_finished"] > 0,
          f"drain: new sessions went to {d['new_session_routes']}")
    # the hooks' device cost: the replayed windows dispatched with tracing
    # on against those with it off, alternating pump by pump on the same
    # engines; the separate runs' steps, the serve phase's and this
    # phase's monolithic engine's beside them (a fresh run's step moves
    # by up to 9 % between runs, PERF.md)
    step, on = a["decode_step_ms_replayed"], b["decode_step_ms_replayed"]
    ratio = (alt["step_ms_on"] / alt["step_ms_off"]
             if alt["windows_on"] and alt["windows_off"] else None)
    emit(phase="router_overhead", alternate_step_ms_on=alt["step_ms_on"],
         alternate_step_ms_off=alt["step_ms_off"],
         alternate_windows=[alt["windows_on"], alt["windows_off"]],
         alternate_on_over_off=ratio, alternate_finished=alt["finished"],
         step_ms_replayed_off=step, step_ms_replayed_on=on,
         serve_phase_step_ms_replayed=serve_native["decode_step_ms_replayed"],
         off_over_serve_phase=(
             step / serve_native["decode_step_ms_replayed"] if step
             else None),
         reference_step_ms_replayed=ref_met["decode_step_ms_replayed"],
         tokens_per_s_off=a["tokens_per_s"], tokens_per_s_on=b["tokens_per_s"],
         decode_tokens_per_s_replayed_off=a["decode_tokens_per_s_replayed"],
         decode_tokens_per_s_replayed_on=b["decode_tokens_per_s_replayed"],
         ttft_s_p50_off=a["ttft_s_p50"], ttft_s_p50_on=b["ttft_s_p50"],
         card=card)
    check(alt["finished"] == len(reqs) and alt["leaked_blocks"] == 0,
          "alternating run: unfinished or leaked")
    check(ratio is not None and abs(ratio - 1) <= 0.05,
          f"replayed step {alt['step_ms_on']} ms traced against "
          f"{alt['step_ms_off']} untraced")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # (e) f32, depth 2: the Router's transcripts are the monolithic
    # engine's, for the copy arm and the fp32 wire arm (parking too)
    small = TransformerLM(**dict(FULL, depth=2), device="cuda",
                          dtype=torch.float32,
                          generator=torch.Generator(
                              device="cuda").manual_seed(seed))
    smono = serve(small, reqs, count=False)[0]
    for name, kw in (("e_copy_f32", dict(mode="copy")),
                     ("e_wire_fp32", dict(mode="wire", codec="fp32",
                                          decode_pool=ROUTER_SATURATE_POOL))):
        _out, met = release_arm(router_arm, small, reqs, smono, **kw)
        emit(phase="router_exactness", arm=name, depth=2, dtype="float32",
             codec=kw.get("codec"), token_identical=met["tokens_equal_mono"],
             routes=met["routes"], parks=met["parks"],
             leaked_blocks=met["leaked_blocks"],
             handoff_host_bytes=met["handoff_host_bytes"],
             launches=met["launches"], card=card)
        check(met["tokens_equal_mono"],
              f"{name}: the Router's tokens differ from the monolithic "
              f"engine's")
        check_router_arm(name, met, 2)
        tally(launches, met["launches"])
    del small
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="router_phase", seconds=time.perf_counter() - t_phase,
         card=card)
    return launches


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
    model, reqs, results, launches, serve_mets = serve_phase(card,
                                                            args.seed)
    profile_phase(card, model, reqs)
    exactness_phase(card, args.seed, model, reqs, results["native"])
    t_dense = time.perf_counter()
    tally(launches, dense_serve_phase(card, model, reqs))
    dense_exactness_phase(card, args.seed, reqs)
    tally(launches, generate_phase(card, model, reqs, args.seed))
    emit(phase="dense_phase", seconds=time.perf_counter() - t_dense,
         card=card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tally(launches, train_phase(card, args.seed))
    train_exactness_phase(card, args.seed)
    train_exactness_bf16_phase(card, args.seed)
    ai_kernel_rows(card, gen)
    tally(launches, ai_benchmark_phase(card, args.seed))
    resnet_f32_phase(card, args.seed)
    node_phase(card, share_phase(card))
    tally(launches, disagg_phase(card, args.seed, results))
    tally(launches, router_phase(card, args.seed, serve_mets["native"]))

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
