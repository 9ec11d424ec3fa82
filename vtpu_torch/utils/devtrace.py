"""The device's own timeline of a stretch of host code, by torch.profiler:
the kernels that ran and the union of their intervals, from which an
idle share follows (1 - busy / wall)."""

from __future__ import annotations

import time

import torch


def device_events(fn, cpu: bool = True):
    """Run ``fn`` under torch.profiler; returns ``(wall_ms, kernels)``,
    each kernel ``(name, start_us, end_us)``: the device events less the
    annotations that span them (an optimizer's step is recorded on the
    device timeline as a range over its kernels).  The profiler's raw
    events are read as they come: building its per-event Python objects
    for a window of ~10^5 kernels takes longer than the window.
    ``cpu=False`` traces the device only, which costs the host less."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()]
    return wall_ms, kernels


def busy_ms(kernels) -> float:
    """The union of the kernels' intervals, in ms (kernels on several
    streams overlap: each instant counts once)."""
    busy_us, end = 0.0, float("-inf")
    for _, start, stop in sorted(kernels, key=lambda k: k[1]):
        lo = max(start, end)
        if stop > lo:
            busy_us += stop - lo
        end = max(end, stop)
    return busy_us / 1e3
