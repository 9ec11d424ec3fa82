#!/usr/bin/env python3
"""Four tenants sharing one card: ``bench.py``'s exclusive arm and its
in-process share (``run_streams``, ``run_inprocess_share``) for the port.

    python -m vtpu_torch.bench.share [--window 10] [--quota-mb 4096] [--json]

The workload is ResNet-V2-50 in bf16 (weights and activations) at batch
50, 224^2 (the ai-benchmark resnet50 batch), seeded random weights.
``run`` composes every arm; the CLI and ``chip_smoke.py`` both call it.

- Exclusive arm: one stream of steps, two in flight.
- Share arm: four tenants, each a ``ShimRuntime`` on one region file and
  on its own CUDA stream, each a thread that steps through ``dispatch``
  with ``try_alloc`` / ``free`` of the input's bytes around each step
  (core limit 100: memory-isolated; the card arbitrates the cores).
- Both arms eager, and graphed: each tenant's forward captured once as a
  CUDA graph on its stream and replayed (the counterpart of the
  reference's one jitted program a step): the same kernels, without the
  host's issue of ~300 launches a step under the interpreter lock.  The
  eager share also runs without the runtime (four bare threads).
- Every arm's window is traced on the device only (torch.profiler), so
  its img/s and its device idle share come from the same window.
- Duty probe (``duty_probe``): one tenant at ``core_limit=q`` between
  two windows of the same tenant at 100 on the same loop; its step rate
  over the mean of the two rates at 100 is its duty, so a change in the
  host's speed during the probe moves both sides of the ratio.  It runs
  eager and graphed, each with the port's pacing and with the
  reference's (``ReferencePacing``): the two differ where a launch
  returns long before its step is done, as a graph replay does.
- Four-process arm (``run_processes``): four tenant processes
  (``vtpu_torch.bench.tenant``, plain PyTorch programs that never call
  the runtime) under ``LD_PRELOAD`` of the CUDA interposer
  (``vtpu_torch/native``), with the env the device plugin writes at
  Allocate (``PJRT_DEVICE_MEMORY_LIMIT_0`` 16384 MiB, core limit 100, one
  region file), started together through a file barrier: tenant 0's
  window alone (the exclusive arm, under the same interposer), then the
  four together; eager and graphed.  The region is read back while the
  tenants hold at the barrier: four live slots, each holding its
  tenant's reserved memory and its context's charge.

Reports per-tenant img/s, summed / exclusive (the reference's target is
>= 0.95), quota violations, what the region holds after the run, and the
duty.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import nullcontext

import torch

from vtpu_torch.device import resolve_device
from vtpu_torch.models.resnet import ResNetV2_50
from vtpu_torch.monitor.shared_region import open_region
from vtpu_torch.shim import ShimRuntime
from vtpu_torch.utils.devtrace import busy_ms, device_events
from vtpu_torch.utils.sync import hard_sync

BATCH, SIZE = 50, 224
DUTY_CORE_LIMIT = 50
PROCESS_TENANTS = 4
PROCESS_QUOTA_MB = 16384           # each tenant process's Allocate quota
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ReferencePacing(ShimRuntime):
    """The port's runtime with vtpu's run-state rule
    (``vtpu/shim/runtime.py``, ``dispatch``): sleep T x (100 - q) / q
    before each launch, however long the previous launch took.  The
    duty probe measures it beside the port's deadline."""

    def _pace(self, q: int) -> None:
        self._clock.sleep(self._last_step_s * (100 - q) / q)


def build_forward(device="cuda", *, batch: int = BATCH, size: int = SIZE,
                  **model_kw):
    """``(forward, x, batch, param_bytes)``: a bf16 ResNet-V2-50 inference
    step (run once, and waited for) and its input, ones.  ``model_kw``
    override the model's widths (the CPU tests shrink it)."""
    dev = resolve_device(device)
    model = ResNetV2_50(num_classes=1000, device=dev, **model_kw)
    model.to(torch.bfloat16)
    x = torch.ones((batch, size, size, 3), dtype=torch.bfloat16, device=dev)

    @torch.no_grad()
    def forward(images):
        return model(images)[0]

    hard_sync(forward(x))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in model.state_dict().values())
    return forward, x, batch, param_bytes


def capture(forward, x, streams):
    """One CUDA graph of ``forward(x)`` per stream (each with its own
    memory, as each tenant has its own buffers), captured after an eager
    warm-up on that stream; returns the replay callables, which take the
    input (its address is the graph's) and return the graph's output."""
    replays = []
    for s in streams:
        torch.cuda.synchronize()
        with torch.cuda.stream(s):
            forward(x)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            out = forward(x)

        def replay(_x, g=g, out=out):
            g.replay()
            return out

        replays.append(replay)
    torch.cuda.synchronize()
    return replays


def step_costs(forward, x, n: int = 10) -> dict:
    """The host's issue time of one step (median of ``n``, each on an
    idle card, so the launch queue never fills) and the device's time of
    one step (CUDA events around ``n`` queued steps), in ms."""
    host = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(x)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(n):
        forward(x)
    e.record()
    torch.cuda.synchronize()
    return {"host_ms": sorted(host)[n // 2], "device_ms": s.elapsed_time(e) / n}


def run_streams(forward, x, batch: int, seconds: float, n_streams: int = 4,
                before_step=None, after_step=None, dispatch=None,
                streams=None):
    """img/s of each of ``n_streams`` threads over a window of
    ``seconds``, each keeping one step in flight while it issues the
    next, and the number of quota rejections.  A step counts when its own
    work is done: on the card, an event recorded after it (as JAX's
    ``block_until_ready`` waits for one result; a copy to the host would
    also wait for the step queued behind it).  ``forward`` is one
    callable, or one per thread (graph replays).

    ``before_step(i)`` may raise MemoryError to signal a quota rejection
    (the in-flight step is retired first, so a tight quota alternates
    instead of wedging); ``dispatch(i, fn, x)`` routes the launch (the
    shim's path); ``after_step(i)`` runs when a step retires; thread i
    runs on ``streams[i]`` when given."""
    counts = [0] * n_streams
    violations = [0] * n_streams
    errors = []
    stop_at = time.monotonic() + seconds
    t0 = time.monotonic()

    def stream(i):
        fwd = forward[i] if isinstance(forward, list) else forward
        pending = collections.deque()

        def retire():
            out, done = pending.popleft()
            if done is not None:
                done.synchronize()
            else:
                hard_sync(out)
            if after_step is not None:
                after_step(i)
            counts[i] += batch

        while time.monotonic() < stop_at:
            if before_step is not None:
                try:
                    before_step(i)
                except MemoryError:
                    # quota full: retire the in-flight step (freeing its
                    # bytes); with nothing in flight, back off
                    if pending:
                        retire()
                    else:
                        violations[i] += 1
                        time.sleep(0.001)
                    continue
            out = (dispatch(i, fwd, x) if dispatch is not None
                   else fwd(x))
            done = None
            if x.is_cuda:
                done = torch.cuda.Event()
                done.record()
            pending.append((out, done))
            if len(pending) >= 2:
                retire()
        while pending:
            retire()

    def guarded(i):
        ctx = torch.cuda.stream(streams[i]) if streams else nullcontext()
        try:
            with ctx:
                stream(i)
        except Exception as e:  # noqa: BLE001 -- surfaced after the join
            errors.append((i, e))

    threads = [threading.Thread(target=guarded, args=(i,))
               for i in range(n_streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # a dead stream means partial counts: the ratio would be garbage
        raise RuntimeError(f"stream(s) failed: {errors}") from errors[0][1]
    elapsed = time.monotonic() - t0
    return [c / elapsed for c in counts], sum(violations)


def make_streams(dev, n):
    """One CUDA stream a tenant on the card; None on the CPU."""
    return [torch.cuda.Stream(dev) for _ in range(n)] \
        if dev.type == "cuda" else None


def run_share(forward, x, batch: int, param_bytes: int, window: float,
              quota: int, region_path: str, n_tenants: int = 4,
              device="cuda", streams=None) -> dict:
    """The share arm: ``n_tenants`` tenants on one region, each charging
    its parameters and input once and each step's input around the step;
    ``forward`` is one callable or one per tenant (then ``streams`` are
    the streams their graphs were captured on).  Returns per-tenant
    img/s, violations and the region's read-back."""
    dev = resolve_device(device)
    input_bytes = x.numel() * x.element_size()
    streams = streams or make_streams(dev, n_tenants)
    tenants = []
    for i in range(n_tenants):
        rt = ShimRuntime(limits_bytes=[quota], core_limit=100,
                         region_path=region_path, uuids=["bench-gpu-0"],
                         pid=1000 + i, device=dev,
                         stream=streams[i] if streams else None)
        rt.try_alloc(param_bytes + input_bytes, 0)
        tenants.append(rt)
    try:
        per_tenant, violations = run_streams(
            forward, x, batch, window, n_streams=n_tenants,
            before_step=lambda i: tenants[i].try_alloc(input_bytes, 0),
            after_step=lambda i: tenants[i].free(input_bytes, 0),
            dispatch=lambda i, fn, a: tenants[i].dispatch(fn, a),
            streams=streams)
        rf = open_region(region_path)
        procs = rf.live_procs()
        usage = rf.usage()[0]
        limits = rf.limits()
        rf.close()
    finally:
        for rt in tenants:
            rt.close()
    return {"per_tenant_img_s": per_tenant, "violations": violations,
            "region": {"procs": len(procs),
                       "pids": sorted(p["pid"] for p in procs),
                       "total_bytes": usage["total"],
                       "expected_bytes": n_tenants * (param_bytes
                                                      + input_bytes),
                       "launches": usage["launches"],
                       "limit_bytes": limits[0] if limits else 0}}


def paced_rate(forward, x, batch: int, window: float, core_limit: int,
               region_path: str, device="cuda",
               runtime_cls=ShimRuntime) -> float:
    """img/s of one tenant at ``core_limit`` stepping through
    ``dispatch`` on its own stream, two steps in flight, after the
    pacer's warm-up and first calibration; ``runtime_cls`` picks the
    pacing rule."""
    dev = resolve_device(device)
    streams = make_streams(dev, 1)
    rt = runtime_cls(limits_bytes=[], core_limit=core_limit,
                     region_path=region_path, uuids=["bench-gpu-0"],
                     pid=2000 + core_limit, device=dev,
                     stream=streams[0] if streams else None)
    try:
        for _ in range(4):  # warmup + calibrate outside the window
            hard_sync(rt.dispatch(forward, x))
        rates, _ = run_streams(forward, x, batch, window, n_streams=1,
                               dispatch=lambda i, fn, a: rt.dispatch(fn, a),
                               streams=streams)
    finally:
        rt.close()
    return rates[0]


def duty_probe(rate_of, q: int) -> dict:
    """The duty of a tenant at core limit ``q``: the paced window (the
    port's rule) between two windows at 100, its rate over their mean,
    and the reference's rule after them, over the same mean.
    ``rate_of(name, core_limit, runtime_cls)`` runs one window and gives
    its img/s.  The two readings at 100 and their ratio are kept: a ratio
    far from 1 says the host's speed moved during the probe."""
    before = rate_of("at_100_before", 100, ShimRuntime)
    port = rate_of("port", q, ShimRuntime)
    after = rate_of("at_100_after", 100, ShimRuntime)
    reference = rate_of("reference", q, ReferencePacing)
    at_100 = (before + after) / 2
    return {"img_s_at_100_before": before, "img_s_at_100_after": after,
            "at_100_after_over_before": after / before,
            "img_s_at_100": at_100, "img_s": port,
            "measured": port / at_100,
            "reference_rule_img_s": reference,
            "reference_rule_measured": reference / at_100}


def card_uuid() -> str:
    """NVML's name of the card (``GPU-<uuid>``), which the plugin writes
    into ``VTPU_PJRT_VISIBLE_UUIDS``."""
    return f"GPU-{torch.cuda.get_device_properties(0).uuid}"


def tenant_env(region: str, barrier: str, *, quota_mb: int, cores: int,
               uuid: str, lock_dir: str, interposer: str = "") -> dict:
    """The env of one tenant process: this process's, less every quota
    name, plus the pjrt family's Allocate env, the node's context lock
    directory (``lock_dir``, one for every tenant of the card; the
    plugin mounts ``/tmp/vtpulock`` there in production) and the
    interposer (``interposer=""`` for the plain control arm)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "PJRT_", "VTPU_"))}
    env.update(PJRT_DEVICE_MEMORY_LIMIT_0=str(quota_mb),
               PJRT_DEVICE_CORES_LIMIT=str(cores),
               PJRT_DEVICE_MEMORY_SHARED_CACHE=region,
               VTPU_PJRT_VISIBLE_UUIDS=uuid, VTPU_TENANT_BARRIER=barrier,
               VTPU_LOCK_DIR=lock_dir,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    if interposer:
        env["LD_PRELOAD"] = interposer
    return env


class Tenants:
    """Tenant processes driven phase by phase through the file barrier of
    ``vtpu_torch.bench.tenant``.  ``close`` releases and reaps them (and
    kills any that outlive ``timeout``); ``kill`` ends them at once (on a
    failure, while they may wait at a barrier that will not open)."""

    def __init__(self, specs, barrier: str, timeout: float = 600.0):
        self.barrier, self.timeout = barrier, timeout
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "vtpu_torch.bench.tenant", *args],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for args, env in specs]

    def _wait(self, names, what):
        deadline = time.monotonic() + self.timeout
        while not all(os.path.exists(os.path.join(self.barrier, n))
                      for n in names):
            for p in self.procs:
                if p.poll() is not None:
                    _, err = p.communicate()
                    raise RuntimeError(f"tenant {p.pid} exited "
                                       f"{p.returncode} before {what}: "
                                       f"{err[-3000:]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"tenants never reached {what}")
            time.sleep(0.02)

    def phase(self, name: str, members) -> list:
        """Open phase ``name`` once ``members`` (indices) are ready; their
        reports when each is done."""
        pids = [self.procs[i].pid for i in members]
        self._wait([f"ready_{name}_{pid}" for pid in pids], f"{name} ready")
        open(os.path.join(self.barrier, f"go_{name}"), "w").close()
        done = [f"done_{name}_{pid}.json" for pid in pids]
        self._wait(done, f"{name} done")
        out = []
        for d in done:
            with open(os.path.join(self.barrier, d)) as f:
                out.append(json.load(f))
        return out

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.communicate()

    def close(self) -> list:
        """Release the tenants; their final JSON lines."""
        open(os.path.join(self.barrier, "exit"), "w").close()
        out = []
        try:
            for p in self.procs:
                stdout, err = p.communicate(timeout=self.timeout)
                if p.returncode != 0:
                    raise RuntimeError(f"tenant {p.pid} exited "
                                       f"{p.returncode}: {err[-3000:]}")
                out.append(json.loads(stdout.strip().splitlines()[-1]))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        return out


def run_processes(graphed: bool, window: float, tmp: str) -> dict:
    """The four-process arm (module docstring) for one forward kind:
    tenant 0 alone, then all four; per-tenant img/s, the
    exclusive img/s, violations, and the region read back while the
    tenants hold (its slots beside each tenant's reserved memory)."""
    from vtpu_torch.bench.tenant import region_read
    from vtpu_torch.native import build

    t0 = time.perf_counter()
    kind = "graphed" if graphed else "eager"
    barrier = os.path.join(tmp, f"procs_{kind}")
    os.makedirs(barrier)
    region = os.path.join(barrier, "vtpu.cache")
    env = tenant_env(region, barrier, quota_mb=PROCESS_QUOTA_MB, cores=100,
                     uuid=card_uuid(), lock_dir=os.path.join(tmp, "lock"),
                     interposer=build.interposer())
    args = ["--mode", "resnet", "--seconds", str(window)] + (
        ["--graphed"] if graphed else [])
    specs = [(args + ["--phases", "exclusive,share" if i == 0 else "share"],
              env) for i in range(PROCESS_TENANTS)]
    tenants = Tenants(specs, barrier)
    try:
        (exclusive,) = tenants.phase("exclusive", [0])
        shared = tenants.phase("share", range(PROCESS_TENANTS))
        held = region_read(region)
        final = tenants.close()
    except BaseException:
        tenants.kill()
        raise
    pids = [t.pid for t in tenants.procs]
    per_tenant = [s["img_s"] for s in shared]
    usage, limit = held["usage"], held["limits"][0]
    return {"kind": kind, "quota_mb": PROCESS_QUOTA_MB, "window_s": window,
            "exclusive_img_s": exclusive["img_s"],
            "per_tenant_img_s": per_tenant,
            "summed_img_s": sum(per_tenant),
            "ratio": sum(per_tenant) / exclusive["img_s"],
            # steps the quota refused, and the region's summed peaks
            # (an upper bound of its simultaneous use) past the quota
            "violations": sum(s["violations"] for s in shared)
            + exclusive["violations"] + int(usage["hbm_peak"] > limit),
            "region": {"procs": len(held["slots"]),
                       "pids": sorted(held["slots"]),
                       "tenant_pids": sorted(pids),
                       "total_bytes": usage["total"],
                       "hbm_peak": usage["hbm_peak"], "limit_bytes": limit,
                       "slots": [dict(held["slots"].get(pid, {}), pid=pid,
                                      reserved=s["memory_reserved"])
                                 for pid, s in zip(pids, shared)]},
            "proof": [t["proof"] for t in final],
            "setup_s": [t["setup_s"] for t in final],
            "seconds": time.perf_counter() - t0}


def run(device="cuda", *, window: float = 10.0, quota: int = 4 << 30,
        duty_window: float = 5.0, process_window: float = 3.0) -> dict:
    """Every arm on the card, ``window`` seconds each (the duty probes
    ``duty_window``): for the eager and the graphed forward, the step's
    host issue and device time, the exclusive arm, the four-tenant share
    arm (per-tenant img/s, violations, the region read back) and, eager
    only, the share without the runtime; each arm's img/s and device
    idle share from its own traced window.  Then the duty of a tenant at
    ``DUTY_CORE_LIMIT``, eager and graphed, under the port's pacing and
    under the reference's.  Then the four-process arm through the
    interposer (``run_processes``, ``process_window`` seconds a window),
    eager and graphed."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    forward, x, batch, param_bytes = build_forward(dev)
    streams = make_streams(dev, 4)
    replays = capture(forward, x, streams)
    doc = {"device": torch.cuda.get_device_name(dev), "batch": batch,
           "image": x.shape[1], "window_s": window,
           "setup_s": time.perf_counter() - t0}

    with tempfile.TemporaryDirectory(prefix="vtpu-share-") as tmp:
        def traced(go):
            """``go()``'s result, with the device idle share of its
            window (device-only tracing) and the seconds the trace took
            to collect after the window."""
            box = {}
            t = time.perf_counter()
            wall_ms, kernels = device_events(
                lambda: box.update(go()), cpu=False)
            box["idle_share"] = 1.0 - busy_ms(kernels) / wall_ms
            box["kernels"] = len(kernels)
            box["trace_s"] = time.perf_counter() - t - wall_ms / 1e3
            return box

        def exclusive(fwd):
            rates, _ = run_streams(fwd, x, batch, window, n_streams=1,
                                   streams=streams[:1])
            return {"img_s": rates[0]}

        def shared(kind, fwd):
            res = run_share(fwd, x, batch, param_bytes, window, quota,
                            os.path.join(tmp, f"{kind}.cache"), device=dev,
                            streams=streams)
            return {**res, "summed_img_s": sum(res["per_tenant_img_s"])}

        def bare():
            rates, _ = run_streams(forward, x, batch, window, n_streams=4,
                                   streams=streams)
            return {"summed_img_s": sum(rates)}

        for kind, fwd in (("eager", forward), ("graphed", replays)):
            costs = step_costs(fwd if kind == "eager" else fwd[0], x)
            ex = traced(lambda: exclusive(
                fwd if kind == "eager" else fwd[:1]))
            sh = traced(lambda: shared(kind, fwd))
            doc[kind] = {"step_host_ms": costs["host_ms"],
                         "step_device_ms": costs["device_ms"],
                         "exclusive": ex, "share": sh,
                         "ratio": sh["summed_img_s"] / ex["img_s"]}
        doc["eager"]["share_without_runtime"] = traced(bare)

        q = DUTY_CORE_LIMIT
        doc["duty"] = {"core_limit": q, "window_s": duty_window}
        for kind, fwd in (("eager", forward), ("graphed", replays[0])):
            doc["duty"][kind] = duty_probe(
                lambda name, limit, cls: paced_rate(
                    fwd, x, batch, duty_window, limit,
                    os.path.join(tmp, f"duty_{kind}_{name}.cache"),
                    device=dev, runtime_cls=cls), q)
        doc["processes"] = {
            kind: run_processes(kind == "graphed", process_window, tmp)
            for kind in ("eager", "graphed")}
    return doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--window", type=float, default=10.0, help="seconds per arm")
    p.add_argument("--quota-mb", type=int, default=4096,
                   help="each tenant's HBM quota")
    p.add_argument("--json", action="store_true", help="one JSON line")
    args = p.parse_args(argv)
    doc = run("cuda", window=args.window, quota=args.quota_mb << 20,
              duty_window=args.window / 2, process_window=args.window / 2)
    if args.json:
        print(json.dumps(doc), flush=True)
        return 0
    for kind in ("eager", "graphed"):
        arm = doc[kind]
        print(f"{kind}: exclusive {arm['exclusive']['img_s']:.2f} img/s "
              f"(idle {arm['exclusive']['idle_share']:.3f}); 4 tenants "
              f"{[round(r, 2) for r in arm['share']['per_tenant_img_s']]} "
              f"= {arm['share']['summed_img_s']:.2f} img/s (idle "
              f"{arm['share']['idle_share']:.3f}), ratio "
              f"{arm['ratio']:.4f}, violations "
              f"{arm['share']['violations']}", flush=True)
    for kind in ("eager", "graphed"):
        duty = doc["duty"][kind]
        print(f"{kind}: duty at {doc['duty']['core_limit']}% "
              f"{duty['measured']:.3f} (the reference's rule: "
              f"{duty['reference_rule_measured']:.3f})", flush=True)
    for kind in ("eager", "graphed"):
        arm = doc["processes"][kind]
        print(f"{kind}, four processes through the interposer: exclusive "
              f"{arm['exclusive_img_s']:.2f} img/s; 4 tenants "
              f"{[round(r, 2) for r in arm['per_tenant_img_s']]} = "
              f"{arm['summed_img_s']:.2f} img/s, ratio {arm['ratio']:.4f}, "
              f"violations {arm['violations']}, region slots "
              f"{arm['region']['procs']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
