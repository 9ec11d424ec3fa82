"""The CUDA driver-API interposer (``vtpu_torch/native``) over the mock
``libcuda.so.1`` and ``libnvidia-ml.so.1``: quota admission and reject,
frees, ``cuMemGetInfo``, two tenants on one region, the
``dlsym`` -> ``cuGetProcAddress_v2`` route, the OOM killer, the reclaim
of a dead tenant's slot, the region as both readers see it, the health
streak that device-side failures feed, and the pacing arithmetic with
made-up times.

Every tenant is a subprocess (``tests/torch_interposer_harness.py``)
with its own ``env=`` and a timeout; every file lives under ``tmp_path``.
Nothing here measures time: the pacer is held through its pure
function, its accuracy on the card by ``chip_smoke.py``."""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from vtpu.monitor import shared_region as jsr
from vtpu_torch.monitor import shared_region as tsr

HARNESS = os.path.join(os.path.dirname(__file__),
                       "torch_interposer_harness.py")
UUID = "GPU-5e3c1a2b-7d4f-4e6a-9b8c-0123456789ab"
OTHER_UUID = "GPU-00000000-1111-2222-3333-444444444444"
CTX_MB = 256
MIB = 1 << 20


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the interposer is built with g++")
    from vtpu_torch.native import build

    return build.build()


def write_nvml(path, **card):
    path.write_text(json.dumps({"devices": [dict(
        {"uuid": UUID, "name": "NVIDIA H100 80GB HBM3", "total_mb": 81559},
        **card)]}))


def node_env(native, tmp_path):
    """Mock fixtures for one H100 and the env every tenant starts from."""
    cuda = tmp_path / "cuda.json"
    cuda.write_text(json.dumps({"ctx_mb": CTX_MB, "kernel_us": 5,
                                "graph_us": 50,
                                "devices": [{"uuid": UUID,
                                             "total_mb": 81559}]}))
    nvml = tmp_path / "nvml.json"
    write_nvml(nvml)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "PJRT_", "VTPU_"))}
    env.update(LD_LIBRARY_PATH=os.path.join(native, "mock"),
               VTPU_MOCK_CUDA_JSON=str(cuda), VTPU_MOCK_NVML_JSON=str(nvml))
    return env


@pytest.fixture
def node(native, tmp_path):
    return node_env(native, tmp_path)


def tenant_env(node, tmp_path, limit_mb, family="pjrt", uuid=UUID,
               interposer=True, **extra):
    env = dict(node, VTPU_LOCK_DIR=str(tmp_path / "lock"))
    region = str(tmp_path / "region" / "vtpu.cache")
    if family == "pjrt":
        env.update(PJRT_DEVICE_MEMORY_LIMIT_0=str(limit_mb),
                   PJRT_DEVICE_MEMORY_SHARED_CACHE=region,
                   VTPU_PJRT_VISIBLE_UUIDS=uuid)
    else:
        env.update(TPU_DEVICE_MEMORY_LIMIT_0=str(limit_mb),
                   TPU_DEVICE_MEMORY_SHARED_CACHE=region,
                   VTPU_VISIBLE_UUIDS=uuid)
    if interposer:
        env["LD_PRELOAD"] = os.path.join(
            os.path.dirname(env["LD_LIBRARY_PATH"]), "libvgpu_interpose.so")
    env.update(extra)
    return env, region


def run(env, *ops, rc=0):
    res = subprocess.run([sys.executable, HARNESS, *ops], env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == rc, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]) if rc == 0 \
        else res


def start(env, *ops):
    return subprocess.Popen([sys.executable, HARNESS, *ops], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc):
    try:
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def wait_for(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@contextlib.contextmanager
def held(env, tmp_path, *ops):
    """A tenant that runs ``ops`` and then holds at a barrier for the
    length of the block; released and reaped on the way out, its results
    in ``box["out"]``."""
    ready, release = tmp_path / "ready", tmp_path / "exit"
    proc = start(env, *ops, f"touch:{ready}", f"wait:{release}")
    box = {"pid": proc.pid}
    try:
        wait_for(ready.exists, "tenant not ready")
        yield box
    finally:
        release.touch()
        box["out"] = finish(proc)


@pytest.mark.parametrize("family", ["pjrt", "tpu"])
def test_allocation_within_quota_succeeds_and_past_it_gives_error_2(
        node, tmp_path, family):
    env, _ = tenant_env(node, tmp_path, 1024, family=family)
    out = run(env, "init", "alloc:600", "alloc:200", "managed:100",
              "pitch:1000:1000", "alloc:68", "alloc:67")
    assert [r["rc"] for r in out] == [0, 0, 2, 0, 0, 2, 0]
    # the context (256) + 600 + 100 + 1024 * 1000 pitched bytes are in
    # (956.98 MiB): 68 more would pass 1024 MiB, 67 do not


def test_free_returns_the_bytes(node, tmp_path):
    env, region = tenant_env(node, tmp_path, 1024)
    with held(env, tmp_path, "init", "alloc:600", "free:0", "alloc:300",
              "create:100", "release:0", "async:50:2",
              "freeasync:2") as box:
        rf = tsr.open_region(region)
        usage = rf.usage()[0]
        (slot,) = rf.live_procs()
        rf.close()
    assert all(r.get("rc", 0) == 0 for r in box["out"])
    assert slot["pid"] == box["pid"]
    assert usage["program"] == CTX_MB * MIB   # the context, once
    assert usage["buffer"] == 300 * MIB       # the one allocation kept
    assert usage["hbm_peak"] == (CTX_MB + 600) * MIB
    rf = tsr.open_region(region)
    assert rf.live_procs() == []  # a clean exit frees the slot
    rf.close()


def test_tenant_reads_its_slot_from_a_live_region(node, tmp_path):
    from vtpu_torch.bench.tenant import region_read, region_view

    env, region = tenant_env(node, tmp_path, 1024)
    with held(env, tmp_path, "init", "alloc:100") as box:
        view = region_view(region, box["pid"])
        whole = region_read(region)
    assert view["slot"]["program"] == CTX_MB * MIB
    assert view["slot"]["buffer"] == 100 * MIB
    assert view["device_total"] == (CTX_MB + 100) * MIB
    assert (view["limits"], view["uuids"], view["procs"]) == (
        [1024 * MIB], [UUID], 1)
    assert list(whole["slots"]) == [box["pid"]]
    assert region_view(str(tmp_path / "none.cache"), 1) == {"slot": None}


@pytest.mark.parametrize("procs,noise_mb,charged_mb", [
    (True, 0, CTX_MB),      # the process that appeared: this one
    (True, 100, CTX_MB),    # ... whatever else fills the card meanwhile
    (False, 0, CTX_MB),     # no process list: the card's used bytes
    (False, 100, CTX_MB + 100),  # ... which hold the others' too
])
def test_context_is_charged_once_as_program_bytes(node, tmp_path, procs,
                                                  noise_mb, charged_mb):
    write_nvml(tmp_path / "nvml.json", procs=procs, noise_mb=noise_mb)
    env, region = tenant_env(node, tmp_path, 4096)
    with held(env, tmp_path, "init", "init", "alloc:10"):
        rf = tsr.open_region(region)
        usage = rf.usage()[0]
        rf.close()
    assert usage["program"] == charged_mb * MIB
    assert usage["buffer"] == 10 * MIB


def test_mem_get_info_reports_the_quota(node, tmp_path):
    env, _ = tenant_env(node, tmp_path, 2048)
    out = run(env, "init", "meminfo", "alloc:512", "meminfo")
    assert out[1]["total"] == out[3]["total"] == 2048 * MIB
    assert out[1]["free"] == (2048 - CTX_MB) * MIB
    assert out[3]["free"] == (2048 - CTX_MB - 512) * MIB
    # without the interposer the driver's own numbers come back
    plain, _ = tenant_env(node, tmp_path, 2048, interposer=False)
    out = run(plain, "init", "meminfo")
    assert out[1]["total"] == 81559 * MIB


@pytest.mark.parametrize("version", ["1", "2"])
def test_nvml_memory_queries_report_the_quota(node, tmp_path, version):
    env, _ = tenant_env(node, tmp_path, 2048)
    # as nvidia-smi asks, with no CUDA call before; then a tenant's view
    out = run(env, f"nvmlmem:{version}", "init", "alloc:512",
              f"nvmlmem:{version}")
    assert (out[0]["total"], out[0]["used"], out[0]["free"]) == (
        2048 * MIB, 0, 2048 * MIB)
    used = (CTX_MB + 512) * MIB
    assert (out[3]["total"], out[3]["used"], out[3]["free"]) == (
        2048 * MIB, used, 2048 * MIB - used)
    plain, _ = tenant_env(node, tmp_path, 2048, interposer=False)
    (card,) = run(plain, f"nvmlmem:{version}")
    assert card["total"] == 81559 * MIB


def test_two_processes_on_one_region_never_sum_past_the_quota(
        node, tmp_path):
    limit = 2048
    env, region = tenant_env(node, tmp_path, limit)
    go, done = tmp_path / "go", tmp_path / "exit"
    procs = [start(env, "init", f"touch:{tmp_path}/ready{i}",
                   f"wait:{go}", "fill:64", f"touch:{tmp_path}/done{i}",
                   f"wait:{done}") for i in range(2)]
    try:
        wait_for(lambda: all((tmp_path / f"ready{i}").exists()
                             for i in range(2)), "tenants not ready")
        go.touch()
        wait_for(lambda: all((tmp_path / f"done{i}").exists()
                             for i in range(2)), "tenants did not fill")
        rf = tsr.open_region(region)
        total = rf.usage()[0]["total"]
        slots = rf.live_procs()
        rf.close()
    finally:
        go.touch()
        done.touch()
        fills = [finish(p)[3] for p in procs]
    assert len(slots) == 2
    assert total <= limit * MIB
    assert limit * MIB - total < 64 * MIB
    assert all(f["rc"] == 2 for f in fills)
    assert sum(f["count"] for f in fills) == (limit - 2 * CTX_MB) // 64


ROUTES = [
    ("cuLaunchKernel", 0, "cuLaunchKernel"),
    ("cuLaunchKernel", 2, "cuLaunchKernel_ptsz"),
    ("cuGraphLaunch", 2, "cuGraphLaunch_ptsz"),
    ("cuMemAlloc", 0, "cuMemAlloc_v2"),
    ("cuMemFree", 0, "cuMemFree_v2"),
    ("cuMemAllocAsync", 2, "cuMemAllocAsync_ptsz"),
    ("cuGetProcAddress", 0, "cuGetProcAddress_v2"),
    ("cuStreamBeginCapture", 0, "cuStreamBeginCapture_v2"),
    ("cuStreamBeginCapture", 2, "cuStreamBeginCapture_v2_ptsz"),
    ("cuDevicePrimaryCtxRetain", 0, "cuDevicePrimaryCtxRetain"),
]


@pytest.fixture(scope="module")
def routes(native, tmp_path_factory):
    """Every entry of ``ROUTES`` resolved by one tenant under the
    interposer and by one without it."""
    tmp = tmp_path_factory.mktemp("routes")
    node = node_env(native, tmp)
    ops = [f"resolve:{name}:{flags}" for name, flags, _ in ROUTES]
    return {kind: run(tenant_env(node, tmp, 1024,
                                 interposer=kind == "interposer")[0], *ops)
            for kind in ("interposer", "plain")}


@pytest.mark.parametrize("name,flags,variant", ROUTES)
def test_get_proc_address_route_hands_back_wrappers(routes, name, flags,
                                                    variant):
    i = ROUTES.index((name, flags, variant))
    got = routes["interposer"][i]
    assert got["lib"] == "libvgpu_interpose.so"
    assert got["sym"] == variant
    got = routes["plain"][i]
    assert (got["lib"], got["sym"]) == ("libcuda.so.1", variant)


def test_each_wrapper_calls_its_own_variant(node, tmp_path):
    env, region = tenant_env(node, tmp_path, 1024)
    out = run(env, "init", "launch:0:40", "launch:2:24", "graph:0:3",
              "graph:2:2", "sync", "calls:cuLaunchKernel",
              "calls:cuLaunchKernel_ptsz", "calls:cuGraphLaunch",
              "calls:cuGraphLaunch_ptsz")
    assert all(r["rcs"] == [0] for r in out[1:5])
    assert [r["n"] for r in out[6:]] == [40, 24, 3, 2]


def test_launches_and_busy_time_reach_the_region(node, tmp_path):
    env, region = tenant_env(node, tmp_path, 1024)
    with held(env, tmp_path, "init", "launch:0:64", "graph:2:4", "sync"):
        def usage():
            rf = tsr.open_region(region)
            try:
                return rf.usage()[0]
            finally:
                rf.close()

        # two batches of 32 launches and four graph launches, each closed
        # by an event the watcher observes
        wait_for(lambda: usage()["launches"] == 68, "launches not published")
        assert usage()["busy_ns"] > 0


def test_launches_under_graph_capture_are_neither_paced_nor_evented(
        node, tmp_path):
    env, _ = tenant_env(node, tmp_path, 1024,
                        PJRT_DEVICE_CORES_LIMIT="10")
    out = run(env, "init", "capture:1", "launch:0:200", "graph:2:20",
              "calls:cuEventRecord", "capture:0", "launch:0:32", "sync",
              "calls:cuEventRecord",
              "waitcalls:cuThreadExchangeStreamCaptureMode:1")
    # captured launches record no event (a paced tenant at 10 % would
    # also have waited after the first batches); the first 32 launches
    # after the capture close a batch with one, and the watcher that
    # observes it runs in the relaxed capture mode
    assert out[4]["n"] == 0
    assert out[8]["n"] == 1
    assert out[9]["n"] == 1


def test_batch_left_open_is_closed_when_its_stream_goes_quiet(node,
                                                              tmp_path):
    env, region = tenant_env(node, tmp_path, 1024)
    # 5 launches are fewer than a batch: the watcher closes it once the
    # stream has been quiet, so a host pause is never counted as busy
    with held(env, tmp_path, "init", "launch:0:5",
              "waitcalls:cuEventRecord:1") as box:
        def launches():
            rf = tsr.open_region(region)
            try:
                return rf.usage()[0]["launches"]
            finally:
                rf.close()

        wait_for(lambda: launches() == 5, "the open batch was not closed")
    assert box["out"][2]["n"] == 1


def test_batch_is_closed_before_its_stream_begins_a_capture(node, tmp_path):
    env, _ = tenant_env(node, tmp_path, 1024)
    out = run(env, "init", "launch:0:5", "begincapture:0", "launch:0:10",
              "sleep:0.05", "calls:cuEventRecord_captured",
              "calls:cuEventRecord", "endcapture")
    # the open batch got its event before the capture began, and nothing
    # was recorded into the capture, though the stream went quiet in it
    assert out[2]["rc"] == 0
    assert out[5]["n"] == 0
    assert out[6]["n"] == 1


@pytest.mark.parametrize("where,code,device_side", [
    ("launch", 214, True),   # uncorrectable ECC error
    ("event", 714, True),    # hardware stack error
    ("event", 700, False),   # illegal address: the tenant's own fault
    ("launch", 719, False),  # launch failure: the tenant's own fault
])
def test_device_side_failures_mark_the_card_unhealthy(
        node, native, tmp_path, monkeypatch, where, code, device_side):
    from vtpu_torch.device.nvml import NvmlProvider

    monkeypatch.setenv("VTPU_MOCK_NVML_JSON", node["VTPU_MOCK_NVML_JSON"])
    monkeypatch.delenv("VTPU_HEALTH_ERROR_STREAK", raising=False)
    prov = NvmlProvider(
        library=os.path.join(native, "mock", "libnvidia-ml.so.1"),
        containers_root=str(tmp_path))
    env, region = tenant_env(node, tmp_path, 1024)

    def streak():
        rf = tsr.open_region(region)
        try:
            return rf.region.error_streak
        finally:
            rf.close()

    # three failed launches, or three batches of 32 launches whose events
    # fail (the watcher feeds the streak before it destroys the event):
    # the provider's default threshold
    fail = (["launch:0:3"] if where == "launch"
            else ["launch:0:96", "waitcalls:cuEventDestroy_v2:3"])
    with held(env, tmp_path, "init", f"error:{where}:{code}", *fail):
        assert streak() == (3 if device_side else 0)
        assert prov.health_check()[0].healthy is not device_side
    if device_side:
        # one batch that completes clears the streak: the card recovers
        for name in ("ready", "exit"):
            (tmp_path / name).unlink()
        with held(env, tmp_path, "init", "launch:0:32"):
            wait_for(lambda: streak() == 0, "the streak was not cleared")
            assert prov.health_check()[0].healthy


def test_oom_killer_exits_137(node, tmp_path):
    env, _ = tenant_env(node, tmp_path, 1024,
                        VTPU_ACTIVE_OOM_KILLER="true")
    res = run(env, "init", "alloc:600", "alloc:600", rc=137)
    assert "ACTIVE_OOM_KILLER" in res.stderr


def test_dead_tenant_slot_is_reclaimed(node, tmp_path):
    env, region = tenant_env(node, tmp_path, 1024)
    victim = start(env, "init", "alloc:600",
                   "touch:" + str(tmp_path / "ready"),
                   "wait:" + str(tmp_path / "never"))
    try:
        wait_for(lambda: (tmp_path / "ready").exists(), "tenant not ready")
        rf = tsr.open_region(region)
        assert [p["pid"] for p in rf.live_procs()] == [victim.pid]
        assert rf.usage()[0]["total"] == (CTX_MB + 600) * MIB
        rf.close()
    finally:
        victim.kill()
        victim.communicate(timeout=10)
    # its slot still holds the bytes until the next tenant starts
    rf = tsr.open_region(region)
    assert len(rf.live_procs()) == 1
    rf.close()
    out = run(env, "init", "meminfo", "alloc:600")
    assert out[1]["free"] == (1024 - CTX_MB) * MIB
    assert out[2]["rc"] == 0


def test_forked_child_gets_its_own_slot(node, tmp_path):
    env, region = tenant_env(node, tmp_path, 1024)
    with held(env, tmp_path, "init", "alloc:300", "fork:100") as box:
        rf = tsr.open_region(region)
        slots = {p["pid"]: p["total_bytes"] for p in rf.live_procs()}
        rf.close()
    out = box["out"]
    assert out[2]["rc"] == 0
    # the child is charged apart from its parent, whose bytes stay its own
    assert slots == {box["pid"]: (CTX_MB + 300) * MIB,
                     out[2]["child"]: 100 * MIB}


def test_card_not_handed_over_is_refused(node, tmp_path):
    env, _ = tenant_env(node, tmp_path, 1024, uuid=OTHER_UUID)
    out = run(env, "init", "alloc:1")
    assert out[0]["rc"] == 0
    assert out[1]["rc"] == 101  # CUDA_ERROR_INVALID_DEVICE


def test_region_reads_the_same_through_both_readers(node, tmp_path):
    env, region = tenant_env(node, tmp_path, 1024)
    with held(env, tmp_path, "init", "alloc:100", "create:50",
              "launch:0:32", "sync"):
        def read(mod):
            rf = mod.open_region(region)
            try:
                return (rf.device_uuids(), rf.limits(), rf.core_limits(),
                        rf.usage(), rf.live_procs(),
                        rf.region.utilization_switch, rf.version)
            finally:
                rf.close()

        wait_for(lambda: read(tsr)[3][0]["launches"] == 32,
                 "launches not published")
        port, ref = read(tsr), read(jsr)
    assert port == ref
    assert port[0] == [UUID] and port[1] == [1024 * MIB]
    assert port[3][0]["total"] == (CTX_MB + 150) * MIB


def test_hook_bench_runs_through_the_interposer_and_without(node, tmp_path,
                                                            native):
    bench = os.path.join(native, "vgpu_hook_bench")
    for interposer in (True, False):
        env, _ = tenant_env(node, tmp_path, 1024, interposer=interposer)
        res = subprocess.run([bench, "200", "50", str(MIB)], env=env,
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, res.stderr
        doc = json.loads(res.stdout)
        assert doc["launches"] == 200 and doc["alloc_free_pairs"] == 50


# -- the tenant's pieces that run without a card ---------------------------
def test_tenant_reads_the_env_the_plugin_writes(monkeypatch):
    from vtpu_torch.bench import tenant

    for k in list(os.environ):
        if k.startswith(("TPU_", "PJRT_", "VTPU_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PJRT_DEVICE_MEMORY_LIMIT_0", "8192")
    monkeypatch.setenv("PJRT_DEVICE_MEMORY_SHARED_CACHE", "/r/vtpu.cache")
    monkeypatch.setenv("VTPU_PJRT_VISIBLE_UUIDS", f"{UUID},{OTHER_UUID}")
    assert tenant.quota_env() == {"prefix": "PJRT", "limit_bytes": 8 << 30,
                                  "region": "/r/vtpu.cache", "uuid": UUID,
                                  "cores": 100}
    # the interposer's family rule: TPU_* wins when its limit is set
    monkeypatch.setenv("TPU_DEVICE_MEMORY_LIMIT_0", "1024")
    assert tenant.family_prefix() == "TPU"
    monkeypatch.setenv("VTPU_SHIM_FAMILY", "pjrt")
    assert tenant.family_prefix() == "PJRT"


def test_share_tenant_env_replaces_every_quota_name(monkeypatch):
    from vtpu_torch.bench import share

    monkeypatch.setenv("TPU_DEVICE_MEMORY_LIMIT_0", "1")
    monkeypatch.setenv("VTPU_VISIBLE_UUIDS", "stale")
    monkeypatch.setenv("VTPU_LOCK_DIR", "/tmp/vtpulock")
    env = share.tenant_env("/r/vtpu.cache", "/b", quota_mb=16384, cores=50,
                           uuid=UUID, lock_dir="/run/lock",
                           interposer="/lib.so")
    assert "TPU_DEVICE_MEMORY_LIMIT_0" not in env
    assert "VTPU_VISIBLE_UUIDS" not in env
    assert {k: env[k] for k in env if k.startswith(("PJRT_", "VTPU_"))} == {
        "PJRT_DEVICE_MEMORY_LIMIT_0": "16384",
        "PJRT_DEVICE_CORES_LIMIT": "50",
        "PJRT_DEVICE_MEMORY_SHARED_CACHE": "/r/vtpu.cache",
        "VTPU_PJRT_VISIBLE_UUIDS": UUID, "VTPU_TENANT_BARRIER": "/b",
        "VTPU_LOCK_DIR": "/run/lock"}
    assert env["LD_PRELOAD"] == "/lib.so"
    assert "LD_PRELOAD" not in share.tenant_env(
        "/r", "", quota_mb=1, cores=100, uuid=UUID, lock_dir="/run/lock")


def test_tenant_barrier_orders_the_phases(tmp_path):
    import threading

    from vtpu_torch.bench.tenant import Barrier

    barrier = Barrier(str(tmp_path))
    seen = []

    def tenant():
        barrier.before("share")
        seen.append("ran")
        barrier.after("share", {"img_s": 1.5})
        barrier.hold()
        seen.append("released")

    t = threading.Thread(target=tenant)
    t.start()
    try:
        ready = tmp_path / f"ready_share_{os.getpid()}"
        wait_for(ready.exists, "no ready file")
        assert seen == []
        (tmp_path / "go_share").touch()
        done = tmp_path / f"done_share_{os.getpid()}.json"
        wait_for(done.exists, "no done file")
        assert json.loads(done.read_text()) == {"img_s": 1.5}
        assert seen == ["ran"]
    finally:
        (tmp_path / "go_share").touch()
        (tmp_path / "exit").touch()
        t.join(timeout=30)
    assert not t.is_alive() and seen == ["ran", "released"]


def test_tenant_serve_tokens_repeat(tmp_path):
    """The serve tenant's run is a pure function of its seed (the card
    holds it against the same run without the interposer)."""
    import torch

    from vtpu_torch.bench import tenant

    cfg = dict(tenant.serve_config(2), vocab=64, d_model=32, num_heads=4,
               num_kv_heads=2, max_seq=128, kv_pool_blocks=1 + 8 * 8)
    a = tenant.serve_tokens(cfg, 3, 4, 5, device="cpu", dtype=torch.float32)
    b = tenant.serve_tokens(cfg, 3, 4, 5, device="cpu", dtype=torch.float32)
    assert a == b and len(a) == 4
    assert all(len(t) == 5 for t in a.values())


# -- the pacing arithmetic, with made-up times ------------------------------
PACE_SIM = r"""
import ctypes, json, sys
lib = ctypes.CDLL(sys.argv[1])
class Pace(ctypes.Structure):
    _fields_ = [("next_ok", ctypes.c_double), ("last_complete", ctypes.c_double),
                ("busy_s", ctypes.c_double)]
lib.vgpu_pace_observe.argtypes = [ctypes.POINTER(Pace), ctypes.c_double,
                                  ctypes.c_double, ctypes.c_int]
lib.vgpu_pace_observe.restype = ctypes.c_double
lib.vgpu_pace_wait.argtypes = [ctypes.POINTER(Pace), ctypes.c_double,
                               ctypes.c_int, ctypes.c_int]
lib.vgpu_pace_wait.restype = ctypes.c_double
lib.vgpu_pace_quota.argtypes = [ctypes.c_int] * 3
lib.vgpu_pace_quota.restype = ctypes.c_int

def simulate(q, batch_s, issue_s, n, idle_at=None, idle_s=0.0):
    # a tenant whose launches return at once: each batch of device work
    # takes batch_s on the card, queue-ordered; its completion is
    # observed when it happens; the host pays issue_s a batch and waits
    # at the gate (the interposer's gate: the deadline, and at most
    # VGPU_PACE_MAX_AHEAD batches in flight).  Returns the card's busy
    # intervals.
    p, pending, busy = Pace(), [], []
    now = dev_free = 0.0
    def drain(t):
        while pending and pending[0][0] <= t:
            done, sub = pending.pop(0)
            lib.vgpu_pace_observe(ctypes.byref(p), sub, done, q)
    for i in range(n):
        if i == idle_at:
            now = max(now, dev_free) + idle_s
        drain(now)
        w = lib.vgpu_pace_wait(ctypes.byref(p), now, len(pending), q)
        while w > 0:
            now += w
            drain(now)
            w = lib.vgpu_pace_wait(ctypes.byref(p), now, len(pending), q)
        start = max(now, dev_free)
        dev_free = start + batch_s
        busy.append((start, dev_free))
        pending.append((dev_free, now))
        now += issue_s
    return busy

def duty(busy, lo, hi):
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in busy) / (hi - lo)

out = {}
for q in (25, 50, 75):
    b = simulate(q, 0.005, 0.0002, 400)
    out[f"duty_{q}"] = duty(b, b[0][0], b[-1][1])
b = simulate(0, 0.005, 0.0002, 200)
out["duty_unpaced"] = duty(b, b[0][0], b[-1][1])
b = simulate(50, 0.005, 0.0002, 200, idle_at=100, idle_s=1.0)
t_idle_end = b[100][0]
out["duty_after_idle"] = duty(b, t_idle_end, t_idle_end + 0.1)
# one blocking step: the wait after it is the reference's sleep
p = Pace()
lib.vgpu_pace_observe(ctypes.byref(p), 10.0, 10.004, 50)
out["blocking_wait"] = lib.vgpu_pace_wait(ctypes.byref(p), 10.004, 0, 50)
lib.vgpu_pace_observe(ctypes.byref(p), 10.008, 10.012, 50)
out["blocking_wait_2"] = lib.vgpu_pace_wait(ctypes.byref(p), 10.012, 0, 50)
out["unpaced_wait"] = lib.vgpu_pace_wait(ctypes.byref(p), 10.012, 9, 100)
out["quota"] = {f"{c},{pol},{sw}": lib.vgpu_pace_quota(c, pol, sw)
                for c in (0, 30, 50, 100) for pol in (0, 1, 2)
                for sw in range(6)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def pace(native):
    res = subprocess.run(
        [sys.executable, "-c", PACE_SIM,
         os.path.join(native, "libvgpu_interpose.so")],
        capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout)


@pytest.mark.parametrize("q", [25, 50, 75])
def test_pacer_holds_an_early_returning_tenant_at_its_quota(pace, q):
    assert abs(pace[f"duty_{q}"] - q / 100) <= 0.01


def test_pacer_leaves_an_unlimited_tenant_alone(pace):
    assert pace["duty_unpaced"] > 0.99
    assert pace["unpaced_wait"] == 0


def test_pacer_banks_no_credit_across_idle_time(pace):
    # after a 1 s idle a tenant at 50 % may run ahead by the batches it
    # launches before the first completion is observed (MAX_AHEAD + 1 of
    # 5 ms) and no more: 0.5 + 3 * 5 ms / 100 ms * (1 - 0.5) = 0.575 in
    # the 100 ms window.  Credit banked over the idle second would give 1.
    assert pace["duty_after_idle"] <= 0.5 + 3 * 0.005 / 0.1 * 0.5


def test_pacer_waits_the_reference_sleep_after_a_blocking_step(pace):
    # T = 4 ms at q 50: T * (100 - q) / q, as vtpu's runtime sleeps and
    # the port's deadline (vtpu_torch/shim/runtime.py::_pace) gives
    assert pace["blocking_wait"] == pytest.approx(0.004, abs=1e-9)
    assert pace["blocking_wait_2"] == pytest.approx(0.004, abs=1e-9)


def test_pacer_quota_follows_the_switch_and_policy(pace):
    for key, q in pace["quota"].items():
        core, policy, switch = map(int, key.split(","))
        if policy == 2:
            want = 0
        elif switch == 1:  # suspended, unless the policy is force
            want = core if policy == 1 and 0 < core < 100 else 0
        else:
            eff = tsr.effective_core_limit(core, switch)
            assert eff == jsr.effective_core_limit(core, switch)
            want = eff if 0 < eff < 100 else 0
        assert q == want, key
