"""The port's co-location glue (``vtpu_torch/serving/colo.py``) against
the JAX package's: placement docs, role boot on the port's engines,
``router_for_gang`` wiring, ``mesh_for_placement`` in a gloo world, the
EvictBridge over fakes, and a live eviction whose sessions migrate
token-exactly (against a PagedBatcher control) with clean pools."""

import json

import jax
import numpy as np
import pytest

from torch_parity import jax_params, port_of
from vtpu.models.transformer import TransformerLM as JaxLM
from vtpu.parallel.mesh import mesh_from_rectangle as j_mesh_from_rectangle
from vtpu.serving import colo as jcolo
from vtpu_torch.obs import events as tevents
from vtpu_torch.parallel.distributed import spawn_world
from vtpu_torch.scheduler.shard import HashRing
from vtpu_torch.serving import colo
from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
from vtpu_torch.serving.paged import PagedBatcher
from vtpu_torch.serving.router import Router
from vtpu_torch.serving.transport import (LoopbackLink, ReceiverHub,
                                          WireReplica)

KW = dict(vocab=64, d_model=32, depth=2, num_heads=4, max_seq=64,
          kv_cache_layout="paged", kv_block_size=8, kv_pool_blocks=33)


def _annos(role="prefill", shape="2x1x1", hosts=2, index=0, node="host-1",
           gang="default/serve"):
    return {colo.GANG_PLACEMENT: json.dumps({
        "gang": gang, "role": role, "shape": shape, "hosts": hosts,
        "index": index, "node": node})}


def test_annotation_names_are_the_reference_s():
    from vtpu.utils.types import annotations as A

    assert colo.GANG_PLACEMENT == A.GANG_PLACEMENT
    assert colo.EVICT_REQUESTED == A.EVICT_REQUESTED


def test_parse_placement_round_trip_matches_jax():
    for kw in (dict(), dict(role="decode", shape="2x2x1", hosts=3,
                            index=2)):
        pl = colo.parse_placement(_annos(**kw))
        assert vars(pl) == vars(jcolo.parse_placement(_annos(**kw)))
    pl = colo.parse_placement(_annos())
    assert pl.chips == 2 and pl.replica_id() == "prefill-0"
    assert colo.host_split(pl) == [(2, 1, 1), (2, 1, 1)]
    assert colo.parse_placement({}) is None
    assert colo.parse_placement({"other": "x"}) is None


@pytest.mark.parametrize("doc", [
    "{not json",
    json.dumps({"role": "prefill"}),
    json.dumps({"gang": "g", "role": "p", "shape": "2x2", "hosts": 1,
                "index": 0}),
    json.dumps({"gang": "g", "role": "p", "shape": "2x0x1", "hosts": 1,
                "index": 0}),
    json.dumps({"gang": "g", "role": "p", "shape": "2x1x1", "hosts": 2,
                "index": 2}),
    json.dumps({"gang": "g", "role": "p", "shape": "2x1x1", "hosts": 0,
                "index": 0}),
], ids=["json", "keys", "2d", "zero_dim", "index", "hosts"])
def test_malformed_placement_fails_loudly_like_jax(doc):
    with pytest.raises(ValueError):
        colo.parse_placement({colo.GANG_PLACEMENT: doc})
    with pytest.raises(ValueError):
        jcolo.parse_placement({colo.GANG_PLACEMENT: doc})


@pytest.fixture(scope="module")
def model():
    jm = JaxLM(**KW)
    return port_of(jm, jax_params(jm))


def test_boot_role_engine_builds_the_port_s_engines(model):
    pl, pf = colo.boot_role_engine(_annos(role="prefill"), model,
                                   engine_kw=dict(device="cpu"))
    assert isinstance(pf, PrefillEngine) and pl.role == "prefill"
    pl, dec = colo.boot_role_engine(
        _annos(role="decode", hosts=2, index=1), model, max_batch=3,
        engine_kw=dict(device="cpu"))
    assert isinstance(dec, DecodeEngine)
    assert dec.replica_id == "decode-1" and dec.max_batch == 3


def test_boot_role_engine_refusals():
    with pytest.raises(ValueError, match="not a bound"):
        colo.boot_role_engine({}, None)
    with pytest.raises(ValueError, match="no serving engine"):
        colo.boot_role_engine(_annos(role="trainer"), None)


def _gang(model, n_prefill=2, n_decode=2, max_batch=3):
    members = []
    for role, hosts in (("prefill", n_prefill), ("decode", n_decode)):
        for i in range(hosts):
            members.append(colo.boot_role_engine(
                _annos(role=role, hosts=hosts, index=i, node=f"host-{i}"),
                model, max_batch=max_batch, engine_kw=dict(device="cpu")))
    return members


def test_router_for_gang_wires_roles(model):
    members = _gang(model)
    router = colo.router_for_gang(members)
    assert isinstance(router, Router)
    assert sorted(router.prefills) == ["prefill-0", "prefill-1"]
    assert sorted(router.replicas) == ["decode-0", "decode-1"]
    with pytest.raises(ValueError, match="at least one prefill"):
        colo.router_for_gang(members[:2])
    with pytest.raises(ValueError, match="router topology"):
        colo.router_for_gang([(colo.parse_placement(_annos(role="trainer")),
                               object())])


def _mesh_rank(docs):
    from vtpu_torch.parallel.mesh import mesh_shape

    out = []
    for doc in docs:
        m = colo.mesh_for_placement(colo.parse_placement(doc))
        out.append((mesh_shape(m), m.mesh.tolist()))
    return out


def test_mesh_for_placement_in_a_gloo_world():
    """The role's mesh from the annotation alone, over 4 ranks: the
    host-split (dp across the role's hosts) shapes and names of the
    reference's mesh on 4 devices."""
    docs = [_annos(role="prefill", shape="2x1x1", hosts=2),
            _annos(role="decode", shape="2x2x1", hosts=1)]
    got = spawn_world(_mesh_rank, 4, "cpu", args=(docs,), timeout_s=120)
    for doc, (shape, ranks) in zip(docs, got[0]):
        pl = jcolo.parse_placement(doc)
        want = j_mesh_from_rectangle(jcolo.host_split(pl),
                                     devices=jax.devices()[:4])
        assert shape == dict(want.shape)
        assert np.asarray(ranks).shape == want.devices.shape
    assert all(r == got[0] for r in got)


# -- the EvictBridge over fakes ---------------------------------------------
class _Router:
    def __init__(self, moved=2, fail_first=False, unknown=()):
        self.calls, self.moved = [], moved
        self.fail_first, self.unknown = fail_first, set(unknown)

    def request_evict(self, rid, reason=""):
        self.calls.append((rid, reason))
        if rid in self.unknown:
            raise KeyError(rid)
        if self.fail_first and len(self.calls) == 1:
            raise RuntimeError("transient")
        return self.moved


def _pod(uid="u1", reason="r"):
    return {"metadata": {"uid": uid, "name": "x",
                         "annotations": {colo.EVICT_REQUESTED: reason}}}


def test_evict_bridge_defer_drains_on_the_serving_thread():
    router = _Router()
    bridge = colo.EvictBridge(router, defer=True)
    bridge.register("u1", "d0")
    assert bridge.observe_pod(_pod()) == 0 and router.calls == []
    assert bridge.drain() == 2 and router.calls == [("d0", "r")]
    assert bridge.evictions_bridged == 1 and bridge.drain() == 0


def test_evict_bridge_retries_after_transient_router_failure():
    router = _Router(fail_first=True)
    bridge = colo.EvictBridge(router, replica_of=lambda p: "d0")
    assert bridge.observe_pod(_pod()) == 0      # failed: claim released
    assert bridge.observe_pod(_pod()) == 2      # retried and bridged
    assert bridge.observe_pod(_pod()) == 0      # handled for good
    assert len(router.calls) == 2 and bridge.evictions_bridged == 1


def test_evict_bridge_ignores_unmapped_and_unknown_replicas():
    router = _Router(unknown={"nope"})
    bridge = colo.EvictBridge(router)
    assert bridge.observe_pod(_pod()) == 0          # unmapped: ignored
    assert router.calls == []
    bridge.register("u1", "nope")
    assert bridge.observe_pod(_pod()) == 0          # unknown: warned
    assert bridge.evictions_bridged == 0
    bridge.register("u1", "d0")                     # registered later
    assert bridge.observe_pod(_pod()) == 2
    no_request = {"metadata": {"uid": "u2", "annotations": {}}}
    assert bridge.observe_pods([no_request]) == 0
    assert bridge.sessions_migrated == 2


# -- a live eviction on the port's engines -------------------------------------
def _sid_for(ring_ids, want, start=0):
    ring = HashRing(sorted(ring_ids))
    i = start
    while True:
        sid = f"sess-{i}"
        if ring.owner(sid) == want:
            return sid, i + 1
        i += 1


def test_live_eviction_migrates_every_session_token_exactly(model):
    """Members booted from placements alone, ``decode-1`` reached over
    the loopback wire; three sessions pinned onto it (two slots and a
    wire-mode queued adoption); the evict-requested pod goes through the
    bridge, every session moves to ``decode-0``, and the transcripts
    equal a PagedBatcher control's, with every pool clean."""
    members = _gang(model, n_prefill=1, n_decode=2, max_batch=2)
    pl, victim = members[-1]
    members[-1] = (pl, WireReplica(LoopbackLink(ReceiverHub(victim)),
                                   pl.replica_id(), local=victim,
                                   codec="fp32"))
    router = colo.router_for_gang(members)
    rng = np.random.default_rng(3)
    reqs, nxt = [], 0
    for i in range(3):  # 2 slots + 1 queued on the victim
        sid, nxt = _sid_for(router.replicas, "decode-1", nxt)
        reqs.append((sid, f"r{i}", rng.integers(0, 64, 5 + 3 * i)
                     .astype(np.int32), 12))
    for sid, rid, p, n in reqs:
        assert router.submit(sid, rid, p, n) == "decode-1"
    for _ in range(3):
        router.pump()
    assert victim.active.count(True) == 2
    bridge = colo.EvictBridge(router)
    bridge.register("uid-be", "decode-1")
    ev0 = colo.COLO_EVICTIONS_MIGRATED.value()
    moved = bridge.observe_pod(_pod("uid-be", "besteffort_contention"))
    assert moved == len(reqs) == bridge.sessions_migrated
    assert colo.COLO_EVICTIONS_MIGRATED.value() == ev0 + 1
    assert not any(victim.active) and not victim.queue
    assert any(e["type"] == "EvictMigrated" and e["pod"] == "uid-be"
               for e in tevents.journal().query(n=10_000))
    got = router.drain()
    control = PagedBatcher(model, max_batch=2, device="cpu")
    for _sid, rid, p, n in reqs:
        control.submit(rid, p, num_new=n)
    want = control.run()
    for _sid, rid, _p, n in reqs:
        assert got[rid] == want[rid] and len(got[rid]) == n
    for eng in (members[0][1], members[1][1], victim):
        st = eng.pool.stats()
        assert st["leased"] == 0 and st["detached_handles"] == 0
