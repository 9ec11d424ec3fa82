#!/usr/bin/env python3
"""Drive the PyTorch port's paged serving path on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, full width (one card)

Phases (each prints one JSON line; any failure exits non-zero):

0. the card's name and power limit (nvidia-smi), and the build of the
   CUDA kernels from ``vtpu_torch/csrc`` (nvcc, sm_90a) with its seconds;
1. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it: max abs error against the stated
   tolerance, kernel/plain/library times (CUDA events, median of 30
   after warm-up) and the least time the card could take (bound);
2. the serving path at full width -- TransformerLM with the widths of
   docs/workloads.md (vocab 32000, d_model 4096, depth 32, 32 heads, 8 kv
   heads, rope), seeded random bf16 weights, PagedBatcher(max_batch=8)
   over a 1 + 8*256 block pool -- once with a native pool and once with
   an int8 pool, 16 requests each; every kernel's launch count is set to
   0 just before each run and read just after;
3. torch.profiler over one admission round and four decode steps at
   full width: device busy time, wall time, idle share and the kernels
   that take the most device time;
4. exactness: depth 2, f32, the kernel path against the plain path
   (paged_kernel="off", ln_kernel="off"), greedy tokens identical; and,
   as information, the share of tokens on which the full-depth bf16
   kernel and plain paths agree.

Ends with the ``kernels`` line, the nvidia-smi line, and
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero with
no result when CUDA is absent or the ``vtpu_torch`` package is not
beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores
            "bfloat16": 989e12,    # dense tensor cores
            "int8": 1979e12}
TOL_F32 = 2e-5                     # as tests/test_paged.py
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
    """Median device time of one call (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def paged_inputs(gen, dtype, quant: bool):
    import torch

    from vtpu_torch.ops.quant import quantize_int8

    b, nh, n_kv, hd, bs, nb_max = 8, 32, 8, 128, 16, 256
    P = 1 + b * nb_max
    q = torch.randn(b, nh, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(P, n_kv, bs, hd, device="cuda", generator=gen)
    v = torch.randn(P, n_kv, bs, hd, device="cuda", generator=gen)
    perm = torch.randperm(P - 1, device="cuda", generator=gen) + 1
    tables = perm.to(torch.int32).reshape(b, nb_max)  # shuffled blocks
    # 0, a block boundary, the last slot, and ragged lengths between
    lengths = torch.tensor([0, bs, nb_max * bs - 1, 1023, 777, 2048, 31,
                            3000], dtype=torch.int32, device="cuda")
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


def paged_phase(card: str, gen) -> dict:
    import torch

    from vtpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference)

    summary = {}
    for quant in (False, True):
        name = "paged_decode_q8" if quant else "paged_decode"
        for dtype in (torch.float32, torch.bfloat16):
            args = paged_inputs(gen, dtype, quant)
            got = paged_attention_decode(*args)
            ref = paged_attention_reference(*args)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tol = TOL_F32 if dtype == torch.float32 else bf16_tol(ref.float())
            nbytes, ops = paged_bytes_ops(args, quant)
            b_ms, b_by = bound(nbytes, ops,
                               "int8" if quant else str(dtype).split(".")[1])
            row = dict(
                phase="kernel", kernel=name, b=8, heads=32, kv_heads=8,
                hd=128, block=16, nb_max=256,
                lengths=args[4].tolist(), dtype=str(dtype).split(".")[1],
                max_abs_err=err, tol=tol,
                ms=time_ms(lambda: paged_attention_decode(*args)),
                plain_ms=time_ms(lambda: paged_attention_reference(*args)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by, card=card)
            emit(**row)
            check(err <= tol, f"{name} {row['dtype']}: err {err} > {tol}")
            if dtype == torch.bfloat16:
                summary[name] = row
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
    from vtpu_torch.ops.layernorm import fused_layernorm
    from vtpu_torch.ops.paged_attention import paged_attention_decode

    fused_layernorm.launches = 0
    paged_attention_decode.launches = {"native": 0, "int8": 0}


def read_counts() -> dict:
    from vtpu_torch.ops.layernorm import fused_layernorm
    from vtpu_torch.ops.paged_attention import paged_attention_decode

    return {"fused_layernorm": fused_layernorm.launches,
            "paged_decode": paged_attention_decode.launches["native"],
            "paged_decode_q8": paged_attention_decode.launches["int8"]}


def serve(model, reqs, *, count: bool):
    """Serve ``reqs`` (all submitted at t=0) on a fresh PagedBatcher.
    Returns (outputs, metrics).  With ``count``, the kernels' launch
    counts are zeroed just before and read just after."""
    import torch

    from vtpu_torch.serving.paged import PagedBatcher

    eng = PagedBatcher(model, max_batch=8)
    free0 = eng.pool_stats()["free"]
    forwards = [0]
    hook = model.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    windows = []
    step_k = eng._step_k

    def timed_step_k(k):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        active = sum(eng.active)
        s.record()
        out = step_k(k)
        e.record()
        windows.append((k, active, s, e))
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
    dec_ms = sum(s.elapsed_time(e) for _k, _a, s, e in windows)
    dec_tokens = sum(k * a for k, a, _s, _e in windows)
    ttfts = sorted(ttft.values())
    metrics = dict(
        requests=len(reqs), finished=sum(
            len(out.get(rid, [])) == n for rid, _p, n in reqs),
        pool_free_before=free0, pool_free_after=eng.pool_stats()["free"],
        decode_steps=eng.steps, forwards=forwards[0], wall_s=wall,
        tokens=sum(len(t) for t in out.values()),
        tokens_per_s=sum(len(t) for t in out.values()) / wall,
        decode_tokens_per_s=dec_tokens / (dec_ms / 1e3) if dec_ms else None,
        decode_step_ms=dec_ms / max(1, sum(k for k, *_ in windows)),
        ttft_s_min=ttfts[0] if ttfts else None,
        ttft_s_p50=ttfts[len(ttfts) // 2] if ttfts else None,
        ttft_s_max=ttfts[-1] if ttfts else None,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts)
    del eng
    torch.cuda.empty_cache()
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
        results[pool] = out
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    return model, reqs, results, launches


# -- phase 3: where the time goes ------------------------------------------
def profile_phase(card: str, model, reqs) -> None:
    """Where a decode step's time goes: torch.profiler over one admission
    round (8 prompts) and over 4 decode steps of a fresh engine; device
    busy time (sum of kernel times; one stream), wall time, idle share
    and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vtpu_torch.serving.paged import PagedBatcher

    eng = PagedBatcher(model, max_batch=8)

    def window(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        by_name = {}
        for e in kernels:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        emit(phase="profile", window=name, wall_ms=wall_ms,
             device_busy_ms=busy_ms,
             idle_share=1.0 - busy_ms / wall_ms if wall_ms else None,
             kernel_launches=len(kernels),
             top_kernels_ms=[[n[:80], ms] for n, ms in top], card=card)

    window("admission_prefill_8_prompts",
           lambda: [eng.submit(rid, p, n) for rid, p, n in reqs[:8]])
    for _ in range(2):  # the admission's first harvest, then steady state
        eng.step()
    window("decode_4_steps", lambda: [eng.step() for _ in range(4)])
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
        same = all(a[rid] == b[rid] for rid, *_ in reqs)
        emit(phase="exactness", depth=2, dtype="float32", pool=pool,
             requests=len(reqs), token_identical=same, card=card)
        check(same, f"f32 {pool}: kernel and plain tokens differ")
    del small, kern, plain
    torch.cuda.empty_cache()
    plain = model_bf16.clone(paged_kernel="off", ln_kernel="off")
    b, _ = serve(plain, reqs, count=False)
    pairs = [(x, y) for rid, *_ in reqs
             for x, y in zip(kernel_out[rid], b[rid])]
    emit(phase="agreement", depth=model_bf16.depth, dtype="bfloat16",
         pool="native", tokens=len(pairs),
         agree_share=sum(x == y for x, y in pairs) / len(pairs),
         note="information only: bf16 rounds differently on the two paths",
         card=card)


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
    _build.lib()
    emit(phase="build", seconds=time.perf_counter() - t0,
         built_now=_build.build_seconds is not None, card=card)
    if _build.build_log:
        print(_build.build_log, file=sys.stderr)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = {"fused_layernorm": layernorm_phase(card, gen),
            **paged_phase(card, gen)}
    model, reqs, results, launches = serve_phase(card, args.seed)
    profile_phase(card, model, reqs)
    exactness_phase(card, args.seed, model, reqs, results["native"])
    del model

    sources = {
        "fused_layernorm": ("vtpu_torch/csrc/layernorm.cu",
                            "vtpu/ops/layernorm.py:18"),
        "paged_decode": ("vtpu_torch/csrc/paged_attention.cu",
                         "vtpu/ops/paged_attention.py:74"),
        "paged_decode_q8": ("vtpu_torch/csrc/paged_attention.cu",
                            "vtpu/ops/paged_attention.py:87"),
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
