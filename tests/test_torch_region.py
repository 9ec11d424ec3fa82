"""The port's shared region (``vtpu_torch.monitor.shared_region``) is
byte-compatible with ``vtpu.monitor.shared_region`` both ways: the same
struct layouts, each package reads what the other writes, the unchanged
monitor's UtilizationSampler turns the port's launch records into a duty
ratio, and a JAX tenant and a PyTorch tenant share one quota."""

import ctypes
import os

import numpy as np
import pytest

from vtpu.monitor import shared_region as jsr
from vtpu.monitor.pathmonitor import REGION_FILENAME, PathMonitor
from vtpu.monitor.sampler import UtilizationSampler
from vtpu.shim import ShimRuntime as JaxShimRuntime
from vtpu_torch.monitor import shared_region as tsr
from vtpu_torch.shim import QuotaExceeded, ShimRuntime

STRUCTS = ["DeviceUsage", "ProcSlot", "SharedRegion", "_DeviceUsageV3",
           "_ProcSlotV3", "_SharedRegionV3"]


def _layout(cls):
    """(name, offset, size) of every field, nested structs and arrays
    flattened by their own layouts."""
    out = []
    for name, ftype in cls._fields_:
        field = getattr(cls, name)
        out.append((name, field.offset, field.size))
        inner = getattr(ftype, "_type_", None)
        if isinstance(ftype, type) and issubclass(ftype, ctypes.Structure):
            out += [(f"{name}.{n}", field.offset + o, s)
                    for n, o, s in _layout(ftype)]
        elif inner is not None and isinstance(inner, type) and issubclass(
                inner, ctypes.Structure):
            out += [(f"{name}[].{n}", o, s) for n, o, s in _layout(inner)]
    return out


@pytest.mark.parametrize("name", STRUCTS)
def test_struct_layouts_match(name):
    a, b = getattr(jsr, name), getattr(tsr, name)
    assert ctypes.sizeof(a) == ctypes.sizeof(b)
    assert _layout(a) == _layout(b)


def test_constants_and_squeeze_ladder_match():
    for c in ("VTPU_REGION_MAGIC", "VTPU_REGION_VERSION", "MAX_DEVICES",
              "MAX_PROCS", "UUID_LEN", "THROTTLE_LEVEL_MIN",
              "THROTTLE_LEVEL_MAX", "REGION_SIZE", "REGION_SIZE_V3"):
        assert getattr(jsr, c) == getattr(tsr, c), c
    for q in (0, 1, 7, 30, 50, 99, 100):
        for switch in range(7):
            assert (tsr.effective_core_limit(q, switch)
                    == jsr.effective_core_limit(q, switch))


def test_vtpu_reads_what_the_port_writes(tmp_path):
    path = str(tmp_path / "p.cache")
    a = ShimRuntime(limits_bytes=[64 << 20, 32 << 20], core_limit=40,
                    region_path=path, uuids=["gpu-a", "gpu-b"], pid=501,
                    priority=1, oversubscribe=True, device="cpu")
    b = ShimRuntime(limits_bytes=[64 << 20, 32 << 20], core_limit=40,
                    region_path=path, uuids=["gpu-a", "gpu-b"], pid=502,
                    device="cpu")
    a.try_alloc(5 << 20)
    a.try_alloc(3 << 20, dev=1, kind="program")
    b.try_alloc(7 << 20)
    big = a.device_put(np.ones((60 << 20) // 4, np.float32))  # to swap
    for _ in range(3):
        a.dispatch(lambda: None)
    b.region.record_exec_result(False)
    r = jsr.RegionFile(path)
    assert r.version == 4
    assert r.device_uuids() == ["gpu-a", "gpu-b"]
    assert r.limits() == [64 << 20, 32 << 20]
    assert r.core_limits() == [40, 40]
    u = r.usage()
    assert u[0]["buffer"] == 12 << 20 and u[0]["total"] == 12 << 20
    assert u[0]["swap"] == 60 << 20
    assert u[1]["program"] == 3 << 20
    assert u[0]["launches"] == 3 and u[0]["hbm_peak"] == 12 << 20
    procs = {p["pid"]: p for p in r.live_procs()}
    assert set(procs) == {501, 502}
    assert procs[501]["priority"] == 1 and procs[501]["launches"] == 3
    assert procs[502]["total_bytes"] == 7 << 20
    assert r.region.error_streak == 1 and r.region.exec_errors == 1
    assert r.region.recent_kernel == 3
    r.close()
    a.release(big)
    a.close()
    b.close()


def test_port_reads_what_vtpu_writes(tmp_path):
    path = str(tmp_path / "j.cache")
    w = jsr.RegionFile(path, create=True)
    w.set_devices(["tpu-0"], [100 << 20], [30])
    w.register_proc(9, priority=2)
    w.add_usage(9, 0, 40 << 20)
    w.add_usage(9, 0, 2 << 20, kind="swap")
    w.record_launch(9, 0, 5_000_000, n=2)
    w.set_utilization_switch(3)
    w.close()
    r = tsr.RegionFile(path)
    assert r.device_uuids() == ["tpu-0"] and r.core_limits() == [30]
    assert r.usage()[0] == {"buffer": 40 << 20, "program": 0,
                            "total": 40 << 20, "swap": 2 << 20,
                            "busy_ns": 5_000_000, "launches": 2,
                            "hbm_peak": 40 << 20}
    assert r.live_procs()[0]["priority"] == 2
    assert r.region.utilization_switch == 3
    r.close()
    # the port's tenant on the same region: vtpu's tenant's bytes count
    # against the quota, and the squeeze ladder applies to it
    rt = ShimRuntime(limits_bytes=[100 << 20], core_limit=30,
                     region_path=path, pid=10, device="cpu")
    with pytest.raises(QuotaExceeded):
        rt.try_alloc(70 << 20)
    rt.try_alloc(50 << 20)
    assert rt._effective_quota() == (7, False)  # 30 >> 2
    rt.close()


def test_jax_and_torch_tenants_share_one_quota(tmp_path):
    path = str(tmp_path / "mix.cache")
    j = JaxShimRuntime(limits_bytes=[100 << 20], region_path=path,
                       uuids=["tpu-0"], pid=1)
    t = ShimRuntime(limits_bytes=[100 << 20], region_path=path,
                    uuids=["tpu-0"], pid=2, device="cpu")
    j.try_alloc(60 << 20)
    with pytest.raises(QuotaExceeded):
        t.try_alloc(60 << 20)
    t.try_alloc(30 << 20)
    from vtpu.shim import QuotaExceeded as JaxQuotaExceeded

    with pytest.raises(JaxQuotaExceeded):
        j.try_alloc(20 << 20)
    assert j.device_usage(0) == t.device_usage(0) == 90 << 20
    j.close()
    t.close()


def test_legacy_v3_region_read_path(tmp_path):
    path = str(tmp_path / "v3.cache")
    buf = bytearray(jsr.REGION_SIZE_V3)
    reg = jsr._SharedRegionV3.from_buffer(buf)
    reg.magic = jsr.VTPU_REGION_MAGIC
    reg.version = 3
    reg.initialized = 1
    reg.num_devices = 1
    reg.uuids[0].value = b"tpu-old"
    reg.procs[0].pid = 11
    reg.procs[0].status = 1
    reg.procs[0].used[0].buffer_bytes = 12 << 20
    reg.procs[0].used[0].total_bytes = 12 << 20
    reg.proc_num = 1
    del reg
    with open(path, "wb") as f:
        f.write(buf)
    r = tsr.RegionFile(path, create=True)
    assert r.version == 3
    u = r.usage()[0]
    assert u["total"] == 12 << 20 and u["busy_ns"] == 0
    r.record_launch(11, 0, 999)  # v4 counters silently skipped
    assert r.region.recent_kernel == 1
    r.close()
    assert os.path.getsize(path) == jsr.REGION_SIZE_V3


class FakeClock:
    def __init__(self, t0: float = 100.0) -> None:
        self.t = t0

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return 1.7e9 + self.t

    def sleep(self, dt: float) -> None:
        self.t += max(0.0, dt)


def _paced(root, clk, q):
    d = os.path.join(root, "pod-duty_0")
    os.makedirs(d, exist_ok=True)
    return ShimRuntime(limits_bytes=[256 << 20], core_limit=q,
                       region_path=os.path.join(d, REGION_FILENAME),
                       uuids=["gpu-0"], clock=clk, device="cpu")


def _last_duty(sampler):
    series = sampler.series()["containers"]
    return series["pod-duty_0"]["devices"]["gpu-0"][-1]["duty"]


def test_vtpu_sampler_reads_the_port_tenants_duty(tmp_path):
    """A port tenant paced at 30 % samples at 30 % duty in the unchanged
    monitor: each fake-clock step is busy for T and the sampler diffs the
    region's busy-ns counter over the same clock."""
    clk = FakeClock()
    rt = _paced(str(tmp_path), clk, 30)
    pm = PathMonitor(str(tmp_path))
    sampler = UtilizationSampler(pm, clock=clk.monotonic, wallclock=clk.time)
    sampler.sample_once()
    for _ in range(300):
        rt.dispatch(lambda: clk.sleep(0.01))
    sampler.sample_once()
    assert _last_duty(sampler) == pytest.approx(0.30, abs=0.05)
    rt.close()
    pm.close()


def test_vtpu_sampler_sees_the_suspend_lift_the_duty(tmp_path):
    clk = FakeClock()
    rt = _paced(str(tmp_path), clk, 30)
    pm = PathMonitor(str(tmp_path))
    sampler = UtilizationSampler(pm, clock=clk.monotonic, wallclock=clk.time)
    for _ in range(20):
        rt.dispatch(lambda: clk.sleep(0.01))
    rt.region.set_utilization_switch(1)  # the arbiter's priority suspend
    sampler.sample_once()
    for _ in range(50):
        rt.dispatch(lambda: clk.sleep(0.01))
    sampler.sample_once()
    assert _last_duty(sampler) > 0.5
    rt.close()
    pm.close()
