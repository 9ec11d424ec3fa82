"""``vtpu_torch.device.nvml.NvmlProvider`` over the mock NVML
(``vtpu_torch/native/mock_nvml.cc``) with one and with eight H100s: the
``Chip`` fields, the topology beside ``vtpu``'s ``PjrtProvider``, health
that flips and recovers (a lost card, a hung driver, a region's error
streak), and no NVML at all, which lists nothing and leaves ``torch.cuda``
alone.  The fixture path reaches the mock through ``monkeypatch``; every
file lives under ``tmp_path``."""

import json
import shutil

import pytest
import torch

from vtpu_torch.device import nvml as nvml_mod
from vtpu_torch.device.nvml import NvmlProvider
from vtpu_torch.monitor.shared_region import RegionFile

NAME = "NVIDIA H100 80GB HBM3"


def uuid_of(i):
    return f"GPU-{i:08x}-1b2c-4d3e-8f40-5a6b7c8d9e0f"


def cards(n, over=None):
    """``n`` H100s; ``over`` maps an index to fields that differ."""
    return [dict({"uuid": uuid_of(i), "name": NAME, "total_mb": 81559,
                  "used_mb": 0, "minor": 7 - i if n == 8 else 0},
                 **(over or {}).get(i, {})) for i in range(n)]


@pytest.fixture(scope="module")
def mock_nvml():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the mock NVML is built with g++")
    from vtpu_torch.native import build

    return f"{build.mock_dir()}/libnvidia-ml.so.1"


@pytest.fixture
def fixture(tmp_path, monkeypatch):
    path = tmp_path / "nvml.json"
    monkeypatch.setenv("VTPU_MOCK_NVML_JSON", str(path))

    def write(devices):
        path.write_text(json.dumps({"devices": devices}))

    return write


def provider(mock_nvml, tmp_path):
    return NvmlProvider(library=mock_nvml,
                        containers_root=str(tmp_path / "containers"))


def test_one_h100_chip_fields(mock_nvml, fixture, tmp_path):
    fixture(cards(1))
    (chip,) = provider(mock_nvml, tmp_path).enumerate()
    assert chip.index == 0
    assert chip.uuid == uuid_of(0)
    # the reference's Type behind the pjrt family's vendor prefix
    assert chip.model == f"PJRT-NVIDIA-{NAME}"
    assert chip.hbm_mb == 81559
    assert chip.devpath == "/dev/nvidia0"
    assert chip.tensorcores == 1 and chip.cores == 100
    assert chip.coords is None and chip.healthy


def test_eight_h100s_in_nvml_order_with_their_device_nodes(
        mock_nvml, fixture, tmp_path):
    fixture(cards(8))
    chips = provider(mock_nvml, tmp_path).enumerate()
    assert [c.index for c in chips] == list(range(8))
    assert [c.uuid for c in chips] == [uuid_of(i) for i in range(8)]
    assert [c.devpath for c in chips] == [f"/dev/nvidia{7 - i}"
                                          for i in range(8)]


def test_topology_is_the_pjrt_providers_line(mock_nvml, fixture, tmp_path):
    """``PjrtProvider.topology()`` in vtpu: ``(n, 1, 1)``, no wrap; the
    test process has 8 CPU devices there (tests/conftest.py)."""
    from vtpu.device.pjrt import PjrtProvider

    fixture(cards(8))
    ours = provider(mock_nvml, tmp_path).topology()
    ref = PjrtProvider(platform="cpu").topology()
    assert (ours.dims, ours.wrap) == (ref.dims, ref.wrap) == (
        (8, 1, 1), (False, False, False))
    assert hash(ours) == hash(type(ours)((8, 1, 1)))


def test_health_flips_and_recovers(mock_nvml, fixture, tmp_path):
    fixture(cards(8))
    prov = provider(mock_nvml, tmp_path)
    assert all(c.healthy for c in prov.health_check())
    fixture(cards(8, {3: {"healthy": False}}))
    after = prov.health_check()
    assert [c.uuid for c in after if not c.healthy] == [uuid_of(3)]
    assert [c.uuid for c in after] == [uuid_of(i) for i in range(8)]
    fixture(cards(8))
    assert all(c.healthy for c in prov.health_check())


def test_hung_probe_counts_unhealthy_and_is_not_stacked(
        mock_nvml, fixture, tmp_path, monkeypatch):
    monkeypatch.setenv(nvml_mod.ENV_PROBE_TIMEOUT, "0.2")
    fixture(cards(1))
    prov = provider(mock_nvml, tmp_path)
    prov.enumerate()
    fixture(cards(1, {0: {"hang": True}}))
    try:
        assert not prov.health_check()[0].healthy
        parked = prov._probes[uuid_of(0)]
        assert parked.is_alive()
        assert not prov.health_check()[0].healthy
        assert prov._probes[uuid_of(0)] is parked  # no second thread
    finally:
        fixture(cards(1))
        parked.join(timeout=10)
    assert not parked.is_alive()
    assert prov.health_check()[0].healthy


def test_region_error_streak_marks_the_card_unhealthy(
        mock_nvml, fixture, tmp_path):
    fixture(cards(2))
    prov = provider(mock_nvml, tmp_path)
    region_dir = tmp_path / "containers" / "pod_0"
    region_dir.mkdir(parents=True)
    rf = RegionFile(str(region_dir / "vtpu.cache"), create=True)
    try:
        rf.set_devices([uuid_of(1)], [1 << 30], [100])
        for _ in range(3):
            rf.record_exec_result(False)
        health = {c.uuid: c.healthy for c in prov.health_check()}
        assert health == {uuid_of(0): True, uuid_of(1): False}
        rf.record_exec_result(True)
        assert all(c.healthy for c in prov.health_check())
    finally:
        rf.close()


def test_no_nvml_lists_nothing_without_touching_torch_cuda(
        mock_nvml, tmp_path, monkeypatch, caplog):
    def forbidden(*_a, **_k):
        raise AssertionError("the provider touched torch.cuda")

    for name in ("init", "is_available", "device_count",
                 "get_device_properties", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    # the library is missing
    prov = NvmlProvider(library=str(tmp_path / "libnvidia-ml.so.1"))
    assert prov.enumerate() == []
    assert prov.health_check() == []
    assert prov.topology().dims == (1, 1, 1)
    # the library loads but the driver does not answer (nvmlInit fails)
    monkeypatch.delenv("VTPU_MOCK_NVML_JSON", raising=False)
    assert NvmlProvider(library=mock_nvml).enumerate() == []
    assert "NVML unavailable" in caplog.text
    assert not torch.cuda.is_initialized()
