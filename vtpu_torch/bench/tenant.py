#!/usr/bin/env python3
"""A tenant that never calls the runtime: a plain PyTorch program whose
quotas the CUDA interposer enforces from outside (the GPU twin of
``vtpu/shim/native_tenant.py``).

    LD_PRELOAD=<libvgpu_interpose.so> PJRT_DEVICE_MEMORY_LIMIT_0=8192 \\
    PJRT_DEVICE_MEMORY_SHARED_CACHE=<dir>/vtpu.cache \\
    VTPU_PJRT_VISIBLE_UUIDS=<GPU-uuid> \\
        python -m vtpu_torch.bench.tenant --mode quota

It reads the env the device plugin writes at Allocate (the pjrt family's
``PJRT_*`` names, or ``TPU_*`` where ``TPU_DEVICE_MEMORY_LIMIT_0`` is set,
as the interposer does).  Before anything else it proves the interposer
is live -- the library is mapped, its region slot for this pid exists,
``torch.cuda.mem_get_info()[1]`` is the quota, and PyTorch's allocator is
the native one (a ``cudaMallocAsync`` pool keeps freed memory the region
does not see) -- and exits 3 otherwise.  ``--plain`` runs without the
interposer (the control arm) and skips the proof.

Modes (one JSON line on stdout at the end):

- ``quota``: allocate 1 GiB tensors until ``torch.OutOfMemoryError``;
  reports, while it still holds them (phase ``quota`` of the barrier),
  the bytes held, NVML's memory as the tenant sees it, and the region's
  view of the slot.
- ``resnet``: bf16 ResNet-V2-50 at b 50, 224^2 (``share.build_forward``),
  eager or ``--graphed`` (one CUDA graph replay a step); one window of
  ``--seconds`` per phase named in ``--phases`` (``exclusive``, ``share``;
  the orchestrator opens each phase to the tenants that take part), each
  step retired by its own event, two in flight; ``--trace`` adds the
  device busy share of the window (torch.profiler, this process only).
- ``serve``: the port's paged serve path (``TransformerLM`` at the widths
  of ``docs/workloads.md``, depth 4, seeded random bf16 weights,
  ``PagedBatcher`` with decode graphs, 8 requests of 16 new tokens):
  every request's tokens.

Barrier (``VTPU_TENANT_BARRIER`` = a directory): before each phase the
tenant touches ``ready_<phase>_<pid>`` and waits for ``go_<phase>``;
after it writes ``done_<phase>_<pid>.json`` and, after the last phase,
waits for ``exit`` while the orchestrator reads the region.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from vtpu_torch.utils.envs import env_str

GIB = 1 << 30
EXIT_NOT_ENFORCED = 3
BARRIER_TIMEOUT_S = 600.0
# the serve mode: depth, requests, new tokens each, weight seed
SERVE_DEPTH, SERVE_REQUESTS, SERVE_NEW, SERVE_SEED = 4, 8, 16, 0


def family_prefix() -> str:
    """The interposer's family rule (``vgpu_interpose.cc``)."""
    fam = env_str("VTPU_SHIM_FAMILY").lower()
    if fam in ("pjrt", "tpu"):
        return fam.upper()
    return "TPU" if os.environ.get("TPU_DEVICE_MEMORY_LIMIT_0") else "PJRT"


def quota_env() -> dict:
    """The quota, region path and card UUID the env hands this tenant."""
    pfx = family_prefix()
    visible = (env_str("VTPU_PJRT_VISIBLE_UUIDS") if pfx == "PJRT"
               else env_str("VTPU_VISIBLE_UUIDS"))
    return {"prefix": pfx,
            "limit_bytes": int(env_str(f"{pfx}_DEVICE_MEMORY_LIMIT_0", "0"))
            << 20,
            "region": env_str(f"{pfx}_DEVICE_MEMORY_SHARED_CACHE",
                              "/tmp/vtpu/vtpu.cache"),
            "uuid": visible.split(",")[0] if visible else "",
            "cores": int(env_str(f"{pfx}_DEVICE_CORES_LIMIT", "100"))}


def interposer_mapped() -> bool:
    with open("/proc/self/maps") as f:
        return "libvgpu_interpose.so" in f.read()


def _slots(rf) -> dict:
    """pid -> card 0's usage of every live slot, as plain numbers (no
    view into the mapping outlives the call, so the file can close)."""
    from vtpu_torch.monitor.shared_region import MAX_PROCS

    out = {}
    for p in range(MAX_PROCS):
        slot = rf.region.procs[p]
        if slot.status == 1:
            u = slot.used[0]
            out[slot.pid] = {"index": p, "program": u.program_bytes,
                             "buffer": u.buffer_bytes,
                             "total": u.total_bytes,
                             "hbm_peak": u.hbm_peak_bytes,
                             "launches": u.launches, "busy_ns": u.busy_ns}
    return out


def region_read(path: str) -> dict:
    """Every live slot (by pid) and card 0's totals as the region holds
    them (the port's reader); ``{}`` when there is no region."""
    from vtpu_torch.monitor.shared_region import open_region

    rf = open_region(path)
    if rf is None:
        return {}
    try:
        usage = rf.usage()
        return {"slots": _slots(rf), "usage": usage[0] if usage else {},
                "limits": rf.limits(), "uuids": rf.device_uuids()}
    finally:
        rf.close()


def region_view(path: str, pid: int) -> dict:
    """This pid's slot and the card's totals; ``{"slot": None}`` when
    there is no slot."""
    doc = region_read(path)
    if not doc:
        return {"slot": None}
    return {"slot": doc["slots"].get(pid),
            "device_total": doc["usage"].get("total", 0),
            "limits": doc["limits"], "uuids": doc["uuids"],
            "procs": len(doc["slots"])}


def prove_enforced(q: dict) -> dict:
    """The interposer is live for this process, or exit 3."""
    torch.cuda.init()
    free, total = torch.cuda.mem_get_info()
    view = region_view(q["region"], os.getpid())
    proof = {"mapped": interposer_mapped(), "mem_get_info": [free, total],
             "slot": view["slot"],
             "allocator": torch.cuda.get_allocator_backend()}
    problems = []
    if not proof["mapped"]:
        problems.append("libvgpu_interpose.so is not mapped")
    if q["limit_bytes"] and total != q["limit_bytes"]:
        problems.append(f"mem_get_info total {total} != quota "
                        f"{q['limit_bytes']}")
    if view["slot"] is None:
        problems.append(f"no region slot for pid {os.getpid()} in "
                        f"{q['region']}")
    if proof["allocator"] != "native":
        problems.append(f"allocator backend {proof['allocator']}: a "
                        "cudaMallocAsync pool is not charged")
    if problems:
        print(json.dumps({"error": problems, "proof": proof}), flush=True)
        sys.exit(EXIT_NOT_ENFORCED)
    return proof


class Barrier:
    """The file barrier of the module docstring; a no-op without a dir."""

    def __init__(self, path: str) -> None:
        self.path = path

    def _wait(self, name: str) -> None:
        deadline = time.monotonic() + BARRIER_TIMEOUT_S
        go = os.path.join(self.path, name)
        while not os.path.exists(go):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"barrier: no {name} in {BARRIER_TIMEOUT_S} s")
            time.sleep(0.01)

    def before(self, phase: str) -> None:
        if self.path:
            open(os.path.join(self.path, f"ready_{phase}_{os.getpid()}"),
                 "w").close()
            self._wait(f"go_{phase}")

    def after(self, phase: str, doc: dict) -> None:
        if self.path:
            tmp = os.path.join(self.path, f".done_{phase}_{os.getpid()}")
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, os.path.join(
                self.path, f"done_{phase}_{os.getpid()}.json"))

    def hold(self) -> None:
        if self.path:
            self._wait("exit")


def nvml_memory(uuid: str) -> dict:
    """NVML's ``{"total", "free", "used"}`` bytes of the card: the card's
    own outside the interposer, the quota's under it (as nvidia-smi in a
    tenant's container sees it)."""
    from vtpu_torch.device.nvml import Nvml

    nvml = Nvml()
    for i in range(nvml.count()):
        h = nvml.handle(i)
        if nvml.uuid(h) == uuid:
            return nvml.memory(h)
    raise LookupError(f"NVML has no card {uuid}")


def run_quota(q: dict, barrier: Barrier) -> dict:
    """1 GiB tensors until the quota refuses one; the report is handed
    over at the barrier while the tensors are still held (the card's own
    free memory is read from outside: inside, NVML shows the quota)."""
    barrier.before("quota")
    held = []
    try:
        while True:
            held.append(torch.empty(GIB, dtype=torch.uint8, device="cuda"))
    except torch.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
    torch.cuda.synchronize()
    doc = {"tensors": len(held), "bytes_at_oom": len(held) * GIB,
           "oom": oom, "nvml_in_tenant": nvml_memory(q["uuid"]),
           "memory_allocated": torch.cuda.memory_allocated(),
           "memory_reserved": torch.cuda.memory_reserved(),
           "mem_get_info_at_oom": list(torch.cuda.mem_get_info()),
           "region": region_view(q["region"], os.getpid())}
    barrier.after("quota", doc)
    barrier.hold()
    del held
    return doc


def run_resnet(args, barrier: Barrier) -> dict:
    from vtpu_torch.bench.share import build_forward, capture, run_streams
    from vtpu_torch.utils.devtrace import busy_ms, device_events

    t0 = time.perf_counter()
    forward, x, batch, _ = build_forward("cuda")
    stream = torch.cuda.Stream()
    step = capture(forward, x, [stream])[0] if args.graphed else forward
    with torch.cuda.stream(stream):
        for _ in range(3):  # warm-up: the pacer's first observations
            step(x)
    torch.cuda.synchronize()
    doc = {"graphed": args.graphed, "batch": batch, "phases": {},
           "setup_s": time.perf_counter() - t0}
    for phase in args.phases.split(","):
        barrier.before(phase)
        box = {}

        def window():
            try:
                rates, _ = run_streams(step, x, batch, args.seconds,
                                       n_streams=1, streams=[stream])
                box.update(img_s=rates[0], violations=0)
            except RuntimeError as e:  # a step the quota refused
                if not isinstance(e.__cause__, torch.OutOfMemoryError):
                    raise
                box.update(img_s=0.0, violations=1, oom=str(e.__cause__))

        if args.trace:
            t = time.perf_counter()
            wall_ms, kernels = device_events(window, cpu=False)
            box.update(busy_share=busy_ms(kernels) / wall_ms,
                       wall_ms=wall_ms, kernels=len(kernels),
                       trace_s=time.perf_counter() - t - wall_ms / 1e3)
        else:
            window()
        box["memory_reserved"] = torch.cuda.memory_reserved()
        doc["phases"][phase] = box
        barrier.after(phase, box)
    return doc


def serve_config(depth: int) -> dict:
    """The serve phase's widths (``chip_smoke.FULL``, docs/workloads.md),
    depth cut to ``depth`` and the pool to 64 blocks a slot."""
    return dict(vocab=32000, d_model=4096, depth=depth, num_heads=32,
                num_kv_heads=8, pos_embedding="rope", attn_window=0,
                max_seq=1024, kv_cache_layout="paged", kv_block_size=16,
                kv_pool_blocks=1 + 8 * 64)


def serve_tokens(cfg: dict, seed: int, n: int, num_new: int,
                 device="cuda", dtype=torch.bfloat16) -> dict:
    """Every request's greedy tokens from a fresh ``PagedBatcher`` over a
    ``TransformerLM`` of ``cfg`` with weights drawn from ``seed``."""
    from vtpu_torch.models.transformer import TransformerLM
    from vtpu_torch.serving.paged import PagedBatcher

    gen = torch.Generator(device=device).manual_seed(seed)
    model = TransformerLM(**cfg, device=device, dtype=dtype, generator=gen)
    rng = np.random.default_rng(seed)
    eng = PagedBatcher(model, max_batch=8, device=device)
    longest = min(400, cfg["max_seq"] - num_new)
    for i in range(n):
        prompt = rng.integers(0, cfg["vocab"],
                              int(rng.integers(16, longest + 1)))
        eng.submit(f"r{i}", prompt.astype(np.int32), num_new=num_new)
    out = eng.run()
    return {rid: [int(t) for t in toks] for rid, toks in sorted(out.items())}


def run_serve() -> dict:
    from vtpu_torch.ops.layernorm import fused_layernorm
    from vtpu_torch.ops.paged_attention import paged_attention_decode

    fused_layernorm.launches = 0
    paged_attention_decode.launches = {"native": 0, "int8": 0}
    tokens = serve_tokens(serve_config(SERVE_DEPTH), SERVE_SEED,
                          SERVE_REQUESTS, SERVE_NEW)
    torch.cuda.synchronize()
    return {"tokens": tokens, "depth": SERVE_DEPTH,
            "launches": {"fused_layernorm": fused_layernorm.launches,
                         "paged_decode":
                             paged_attention_decode.launches["native"]}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=("quota", "resnet", "serve"),
                   required=True)
    p.add_argument("--plain", action="store_true",
                   help="no interposer: skip the proof (the control arm)")
    p.add_argument("--graphed", action="store_true")
    p.add_argument("--phases", default="share")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--trace", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("tenant: CUDA is not available", file=sys.stderr)
        return 2
    q = quota_env()
    doc = {"mode": args.mode, "pid": os.getpid(), "plain": args.plain,
           "device": torch.cuda.get_device_name(0), "quota": q}
    if not args.plain:
        doc["proof"] = prove_enforced(q)
    barrier = Barrier(env_str("VTPU_TENANT_BARRIER"))
    if args.mode == "quota":
        doc.update(run_quota(q, barrier))
    elif args.mode == "resnet":
        doc.update(run_resnet(args, barrier))
    else:
        doc.update(run_serve())
    if not args.plain:
        doc["region"] = doc.get("region") or region_view(q["region"],
                                                         os.getpid())
    barrier.hold()
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
