"""The unchanged device plugin and scheduler (``vtpu.plugin``,
``vtpu.scheduler``) driven with the port's ``NvmlProvider`` over the mock
NVML: the H100 registers in the plugin's second family (``pjrt``), its
annotation decodes with vtpu's codec, a ``vtpu.io/pjrt`` pod with a memory
request is filtered and bound onto a share of it (the flow of
``tests/test_multivendor.py``), ``Allocate`` writes the ``PJRT_*`` env,
and that env, fed to the interposer over the mock ``libcuda``, enforces
the quota the scheduler booked.  No registrar or cache thread is started;
every file lives under ``tmp_path``."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from vtpu.k8s import FakeClient, new_node, new_pod
from vtpu.k8s.objects import get_annotations
from vtpu.plugin import v1beta1_pb2 as pb
from vtpu.plugin.cache import DeviceCache
from vtpu.plugin.config import PluginConfig
from vtpu.plugin.register import register_once
from vtpu.plugin.server import VtpuDevicePlugin, split_device_ids
from vtpu.scheduler import Scheduler
from vtpu.utils import codec
from vtpu.utils.types import DEVICE_TYPE_PJRT, annotations, resources
from vtpu_torch.device.nvml import NvmlProvider

NODE = "gpu-node"
NAME = "NVIDIA H100 80GB HBM3"
HARNESS = os.path.join(os.path.dirname(__file__),
                       "torch_interposer_harness.py")


def uuid_of(i):
    return f"GPU-{i:08x}-aaaa-4bbb-8ccc-0123456789ab"


class Aborted(Exception):
    pass


class Context:
    """The gRPC servicer context ``Allocate`` aborts through."""

    def abort(self, code, details):
        raise Aborted(f"{code}: {details}")


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the mocks are built with g++")
    from vtpu_torch.native import build

    return build.build()


@pytest.fixture
def rig(native, tmp_path, monkeypatch):
    """A fake cluster with one node whose plugin serves ``n`` mock H100s
    in the pjrt family; returns a factory of (client, cache, cfg,
    plugin)."""
    nvml = tmp_path / "nvml.json"
    monkeypatch.setenv("VTPU_MOCK_NVML_JSON", str(nvml))
    caches = []

    def make(n=1):
        nvml.write_text(json.dumps({"devices": [
            {"uuid": uuid_of(i), "name": NAME, "total_mb": 81559,
             "minor": i} for i in range(n)]}))
        client = FakeClient()
        client.create_node(new_node(NODE))
        provider = NvmlProvider(
            library=os.path.join(native, "mock", "libnvidia-ml.so.1"),
            containers_root=str(tmp_path / "containers"))
        cache = DeviceCache(provider, poll_interval_s=3600)  # never started
        caches.append(cache)
        cfg = PluginConfig(node_name=NODE, device_family="pjrt",
                           resource_name="vtpu.io/pjrt",
                           device_split_count=4,
                           socket_dir=str(tmp_path / "sock"),
                           shim_host_dir=str(tmp_path / "shim"),
                           cache_host_root=str(tmp_path / "containers"),
                           container_cache_dir="/tmp/vtpu-pjrt")
        return client, cache, cfg, VtpuDevicePlugin(client, cache, cfg)

    yield make
    for cache in caches:
        cache.stop()


def test_h100_registers_in_the_pjrt_family(rig):
    client, cache, cfg, _ = rig(1)
    register_once(client, cache, cfg)
    annos = get_annotations(client.get_node(NODE))
    assert annos[annotations.NODE_HANDSHAKE_PJRT].startswith("Reported")
    assert annotations.NODE_REGISTER not in annos
    assert annotations.NODE_TOPOLOGY not in annos  # a TPU-family key
    (info,) = codec.decode_node_devices(annos[annotations.NODE_REGISTER_PJRT])
    assert info.uuid == uuid_of(0)
    assert info.type == f"PJRT-NVIDIA-{NAME}"
    assert info.hbm_mb == 81559 and info.count == 4 and info.cores == 100
    assert info.health is True


def book(client, cfg, mem_mb, name="trainer"):
    """Filter and bind a pod asking for one pjrt device with ``mem_mb``;
    returns the pod and its assigned device."""
    sched = Scheduler(client)
    sched.register_from_node_annotations()
    pod = client.create_pod(new_pod(name, containers=[{
        "name": "main", "resources": {"limits": {
            resources.pjrt_chip: 1, resources.pjrt_memory: mem_mb}}}]))
    res = sched.filter(pod, [NODE])
    assert res.node == NODE, res.error
    assert sched.bind("default", name, NODE) is None
    annos = get_annotations(client.get_pod("default", name))
    (assigned,) = codec.decode_pod_devices(
        annos[annotations.DEVICES_TO_ALLOCATE])
    return pod, assigned


def test_scheduler_places_a_pjrt_pod_on_a_share_of_the_h100(rig):
    client, cache, cfg, plugin = rig(1)
    register_once(client, cache, cfg)
    _, assigned = book(client, cfg, 8192)
    (dev,) = assigned
    assert dev.uuid == uuid_of(0)
    assert dev.type == DEVICE_TYPE_PJRT
    assert dev.usedmem == 8192
    # the plugin's Allocate releases the node lock; a second tenant then
    # shares the same card
    allocate(client, cfg, plugin, assigned)
    _, (dev2,) = book(client, cfg, 16384, name="server")
    assert dev2.uuid == uuid_of(0) and dev2.usedmem == 16384


def allocate(client, cfg, plugin, assigned):
    req = pb.AllocateRequest()
    req.container_requests.append(pb.ContainerAllocateRequest(
        devicesIDs=[split_device_ids(d.uuid, cfg.device_split_count)[0]
                    for d in assigned]))
    return plugin.Allocate(req, Context()).container_responses[0]


def test_allocate_writes_the_pjrt_env(rig):
    client, cache, cfg, plugin = rig(1)
    register_once(client, cache, cfg)
    _, assigned = book(client, cfg, 8192)
    resp = allocate(client, cfg, plugin, assigned)
    envs = dict(resp.envs)
    assert envs["PJRT_DEVICE_MEMORY_LIMIT_0"] == "8192"
    assert envs["VTPU_PJRT_VISIBLE_UUIDS"] == uuid_of(0)
    assert envs["PJRT_VISIBLE_DEVICES"] == "0"
    assert envs["PJRT_DEVICE_MEMORY_SHARED_CACHE"] == "/tmp/vtpu-pjrt/vtpu.cache"
    assert not any(k.startswith("TPU_") for k in envs)
    assert [d.container_path for d in resp.devices] == ["/dev/nvidia0"]
    # the handshake finished: the node lock is released for the next pod
    annos = get_annotations(client.get_pod("default", "trainer"))
    assert annos[annotations.BIND_PHASE] == "success"


def test_allocate_env_drives_the_interposer_to_the_booked_quota(
        rig, native, tmp_path):
    client, cache, cfg, plugin = rig(1)
    register_once(client, cache, cfg)
    _, assigned = book(client, cfg, 4096)
    resp = allocate(client, cfg, plugin, assigned)
    # the container sees its region dir at container_cache_dir; here the
    # tenant runs on the host, so point it at the mount's host side
    (mount,) = [m for m in resp.mounts
                if m.container_path == cfg.container_cache_dir]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "PJRT_", "VTPU_"))}
    env.update(resp.envs)
    region = os.path.join(mount.host_path, "vtpu.cache")
    env["PJRT_DEVICE_MEMORY_SHARED_CACHE"] = region
    cuda = tmp_path / "cuda.json"
    cuda.write_text(json.dumps({"ctx_mb": 512, "devices": [
        {"uuid": uuid_of(0), "total_mb": 81559}]}))
    env.update(LD_PRELOAD=os.path.join(native, "libvgpu_interpose.so"),
               VTPU_LOCK_DIR=str(tmp_path / "lock"),
               LD_LIBRARY_PATH=os.path.join(native, "mock"),
               VTPU_MOCK_CUDA_JSON=str(cuda),
               VTPU_MOCK_NVML_JSON=os.environ["VTPU_MOCK_NVML_JSON"])
    res = subprocess.run([sys.executable, HARNESS, "init", "meminfo",
                          "fill:512"], env=env, capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out[1]["total"] == 4096 << 20
    assert out[2] == {"op": "fill:512", "count": (4096 - 512) // 512,
                      "rc": 2}
    from vtpu_torch.monitor.shared_region import open_region

    rf = open_region(region)
    assert rf.device_uuids() == [uuid_of(0)]
    assert rf.limits() == [4096 << 20]
    rf.close()


def test_preferred_allocation_over_eight_h100s(rig):
    client, cache, cfg, plugin = rig(8)
    avail = [fid for i in range(8)
             for fid in split_device_ids(uuid_of(i), cfg.device_split_count)]
    req = pb.PreferredAllocationRequest()
    req.container_requests.append(pb.ContainerPreferredAllocationRequest(
        available_deviceIDs=avail, allocation_size=2))
    resp = plugin.GetPreferredAllocation(req, Context())
    ids = list(resp.container_responses[0].deviceIDs)
    assert len(ids) == 2 and set(ids) <= set(avail)
    assert len({i.rsplit("-", 1)[0] for i in ids}) == 2  # two cards


def test_lost_card_goes_unhealthy_in_the_plugin_and_recovers(rig, tmp_path):
    client, cache, cfg, plugin = rig(2)
    nvml = tmp_path / "nvml.json"
    doc = json.loads(nvml.read_text())
    doc["devices"][1]["healthy"] = False
    nvml.write_text(json.dumps(doc))
    cache._poll_once()
    health = {d.ID: d.health for d in plugin._api_devices()}
    sick = set(split_device_ids(uuid_of(1), cfg.device_split_count))
    assert {i for i, h in health.items() if h == "Unhealthy"} == sick
    doc["devices"][1]["healthy"] = True
    nvml.write_text(json.dumps(doc))
    cache._poll_once()
    assert all(d.health == "Healthy" for d in plugin._api_devices())
