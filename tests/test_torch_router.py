"""The port's Router (vtpu_torch/serving/router.py) against the JAX
package's (vtpu/serving/router.py) on the CPU.

Policy parity: every scenario of tests/test_router.py (affinity and
pinning, typed sheds, health drain and restore, prefill scaling, wire
backpressure parking, cancel, evict and migration, prefix-aware prefill
picks) runs through each package's Router over identical fake replicas
built on that package's own pool, result and error classes, with an
injected clock.  The two runs must agree on every route, every reject,
the journal events, ``results()``, ``stats()`` and the rendered text of
the ``vtpu_router_*`` families.  The HashRing and the PrefixIndex are
held alike on their own.

Real engines: a JAX Router over a JAX PrefillEngine and two
DecodeEngines, against the port's Router over the port's engines with
the same converted weights, f32, depth 2: the same routes and token-equal
transcripts (both equal to each package's monolithic PagedBatcher), no
cache byte across the host on the in-process handoffs, no block leaked,
and the ``vtpu_kv_handoff_*`` and transport counters moved by the same
amounts in both packages; for copy handoff, shared handoff (one replica)
and the loopback wire.
"""

import types

import numpy as np
import pytest

import vtpu.obs.events as jevents
import vtpu.serving.disagg as jdisagg
import vtpu.serving.kvpool as jkvpool
import vtpu.serving.migrate as jmigrate
import vtpu.serving.prefix as jprefix
import vtpu.serving.router as jrouter
import vtpu.serving.transport as jtransport
from vtpu.scheduler.shard import HashRing as JaxRing
import vtpu_torch.obs.events as tevents
import vtpu_torch.serving.disagg as tdisagg
import vtpu_torch.serving.kvpool as tkvpool
import vtpu_torch.serving.migrate as tmigrate
import vtpu_torch.serving.prefix as tprefix
import vtpu_torch.serving.router as trouter
import vtpu_torch.serving.transport as ttransport
from vtpu_torch.scheduler.shard import HashRing as TorchRing

PACKAGES = {
    "jax": types.SimpleNamespace(
        router=jrouter, kvpool=jkvpool, disagg=jdisagg, migrate=jmigrate,
        prefix=jprefix, transport=jtransport, events=jevents),
    "torch": types.SimpleNamespace(
        router=trouter, kvpool=tkvpool, disagg=tdisagg, migrate=tmigrate,
        prefix=tprefix, transport=ttransport, events=tevents),
}

ROUTER_FAMILIES = ("_REQS_TOTAL", "_SHED_TOTAL", "_HEALTHY_INFO",
                   "_TRANSITIONS", "_BACKLOG", "_PREFILL_ACTIVE", "_PINNED")


# ---------------------------------------------------------------------------
# fake replicas, built on one package's classes
# ---------------------------------------------------------------------------

def fakes(pkg):
    """tests/test_router.py's stand-ins over ``pkg``'s BlockPool,
    PrefillResult, ReplicaSaturatedError and chain_digests."""

    class FakePrefill:
        def __init__(self, blocks=64, block_size=8):
            # a fixed pool id: the ids show up in nothing compared, but
            # both packages' pools then look the same
            self.pool = pkg.kvpool.BlockPool(blocks, block_size,
                                             pool_id="pf")
            self.queue = []
            self.healthy = True
            self.release = True

        def submit(self, rid, prompt, num_new):
            self.queue.append((rid, list(prompt), num_new))

        def step(self):
            if not self.release:
                return []
            out = []
            for rid, prompt, num_new in self.queue:
                need = -(-(len(prompt) + num_new) // self.pool.block_size)
                handle = self.pool.detach(self.pool.lease(need),
                                          seq_len=len(prompt))
                out.append(pkg.disagg.PrefillResult(rid, 7, handle,
                                                    num_new))
            self.queue = []
            return out

        def stats(self):
            return {"queued": len(self.queue), **self.pool.stats()}

    class SlowPrefill(FakePrefill):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.release = False

        def ping(self):
            if not self.healthy:
                raise ConnectionError("prefill gone")
            return True

        def purge(self, rid):
            for i, item in enumerate(self.queue):
                if item[0] == rid:
                    del self.queue[i]
                    return True
            return False

    class DeadStatsPrefill(SlowPrefill):
        def stats(self):
            if not self.healthy:
                raise ConnectionError("prefill process gone")
            return super().stats()

    class PrefixFakePrefill(FakePrefill):
        prefix_cache = True

        def __init__(self, blocks=64, block_size=8):
            super().__init__(blocks=blocks, block_size=block_size)
            self.block_size = block_size

        def submit(self, rid, prompt, num_new, chain=None):
            self.queue.append((rid, list(prompt), num_new))

        def register(self, tokens):
            chain = pkg.prefix.chain_digests(tokens, self.pool.block_size)
            blocks = self.pool.lease(len(chain))
            self.pool.register_prefix(chain, blocks)
            self.pool.release(blocks)
            return chain

    class FakeReplica:
        def __init__(self, max_batch=4):
            self.max_batch = max_batch
            self.adopted = []
            self.out = {}
            self.healthy = True
            self.active = 0
            self.queued = 0
            self.free = 8
            self.fail_handoffs = False
            self.saturated = False

        def ping(self):
            if not self.healthy:
                raise ConnectionError("replica gone")
            return True

        def submit_handle(self, rid, handle, first_token, num_new,
                          source=None, submitted=0.0):
            if self.fail_handoffs:
                raise ConnectionError("replica died mid-handoff")
            if self.saturated:
                raise pkg.transport.ReplicaSaturatedError("no credits")
            if source is not None:
                source.pool.release_handle(handle)
            self.adopted.append(rid)
            self.out[rid] = [int(first_token)] * int(num_new)

        def step(self):
            pass

        def stats(self):
            return {"max_batch": self.max_batch,
                    "active_slots": self.active, "queued": self.queued,
                    "inflight_windows": 0, "prefilling_slots": 0,
                    "free": self.free}

    class PendingReplica(FakeReplica):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.pending = {}
            self.purged = []

        def submit_handle(self, rid, handle, first_token, num_new,
                          source=None, submitted=0.0):
            if source is not None:
                self.pending[rid] = (source.pool,
                                     source.pool.adopt(handle))

        def purge_pending(self, rid):
            ent = self.pending.pop(rid, None)
            if ent is None:
                return False
            pool, blocks = ent
            pool.release(blocks)
            self.purged.append(rid)
            return True

    class FakeMover:
        """A session mover over scripted exports: ``sessions`` maps a
        replica to the rids it exports; a rid in ``fail`` raises the
        package's MigrationError, in ``gone`` its SessionGoneError."""

        def __init__(self, sessions, fail=(), gone=()):
            self.sessions = sessions
            self.fail = set(fail)
            self.gone = set(gone)
            self.moves = []

        def exportable(self, rep):
            return list(self.sessions.get(id(rep), []))

        def move(self, rid, src, targets):
            if rid in self.gone:
                raise pkg.migrate.SessionGoneError(f"{rid} finished",
                                                   phase="export")
            if rid in self.fail:
                raise pkg.migrate.MigrationError(f"{rid} failed",
                                                 phase="stream",
                                                 restored=True)
            tid = targets[0][0]
            self.moves.append((rid, tid))
            return types.SimpleNamespace(target=tid, blocks_shipped=2,
                                         blocks_skipped=1)

    return types.SimpleNamespace(**{c.__name__: c for c in (
        FakePrefill, SlowPrefill, DeadStatsPrefill, PrefixFakePrefill,
        FakeReplica, PendingReplica, FakeMover)})


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class Run:
    """One scenario's run in one package: its fakes, a Router factory
    with the injected clock, and the log of what the Router did."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.f = fakes(pkg)
        self.clock = Clock()
        self.log = []
        self.routers = []

    def router(self, prefill, replicas, **kw):
        r = self.pkg.router.Router(prefill, replicas, clock=self.clock, **kw)
        self.routers.append(r)
        return r

    def submit(self, router, sess, rid, prompt, num_new):
        try:
            got = router.submit(sess, rid, prompt, num_new)
        except self.pkg.router.RouterReject as e:
            self.log.append(("reject", rid, e.reason, e.status))
            return None
        self.log.append(("route", rid, got))
        return got

    def note(self, *what):
        self.log.append(what)


# each scenario drives one Router (or a few) through ``run`` and notes
# what it saw; the test compares the notes, the journal, results(),
# stats() and the vtpu_router_* text across the packages

def sc_affinity(run):
    reps = {f"d{i}": run.f.FakeReplica() for i in range(3)}
    r = run.router(run.f.FakePrefill(), reps)
    for i in range(60):
        run.submit(r, f"s{i % 12}", f"r{i}", [1, 2, 3], 4)
        run.note("pump", r.pump())
    run.note("adopted", {k: v.adopted for k, v in reps.items()})


def sc_admission_shed(run):
    rep = run.f.FakeReplica()
    r = run.router(run.f.FakePrefill(), {"d0": rep}, max_backlog=2)
    rep.active, rep.queued = 4, 3
    run.submit(r, "s", "r0", [1, 2], 2)
    rep.active, rep.queued = 0, 0
    run.submit(r, "s", "r1", [1, 2], 2)
    for i in range(2, 10):
        run.submit(r, "s", f"r{i}", [1], 1)
    run.note("pump", r.pump())
    run.submit(r, "s", "r-after", [1], 1)


def sc_drain_restore_by_clock(run):
    reps = {f"d{i}": run.f.FakeReplica() for i in range(2)}
    r = run.router(run.f.FakePrefill(), reps, fail_threshold=3,
                   ping_interval_s=5.0)
    pins = {f"s{i}": run.submit(r, f"s{i}", f"p{i}", [1], 1)
            for i in range(8)}
    dead = pins["s0"]
    reps[dead].healthy = False
    for _ in range(4):
        run.clock.t += 5.0
        run.note("pump", r.pump())
        run.note("healthy", r.stats()["healthy"])
    run.submit(r, "s0", "p-more", [1], 1)      # pinned: finishes there
    for i in range(6):
        run.submit(r, f"fresh{i}", f"fr{i}", [1], 1)
    reps[dead].healthy = True
    run.clock.t += 1.0                          # not yet due
    run.note("pump", r.pump())
    run.clock.t += 5.0
    run.note("pump", r.pump())
    run.note("healthy", r.stats()["healthy"])


def sc_all_drained(run):
    reps = {f"d{i}": run.f.FakeReplica() for i in range(2)}
    r = run.router(run.f.FakePrefill(), reps, fail_threshold=1)
    for rep in reps.values():
        rep.healthy = False
    r.check_health()
    run.submit(r, "nobody-home", "r0", [1], 1)


def sc_handoff_fallback(run):
    reps = {f"d{i}": run.f.FakeReplica() for i in range(2)}
    pf = run.f.FakePrefill()
    r = run.router(pf, reps)
    victim = run.submit(r, "sx", "rx", [1, 2], 2)
    reps[victim].fail_handoffs = True
    run.note("pump", r.pump())
    run.note("pool", pf.pool.stats()["detached_handles"])
    # nobody can take it: released, shed
    r2 = run.router(run.f.FakePrefill(), {"d0": run.f.FakeReplica()},
                    fail_threshold=1)
    run.submit(r2, "s", "r0", [1, 2, 3], 2)
    r2.replicas["d0"].healthy = False
    r2.replicas["d0"].fail_handoffs = True
    r2.check_health()
    run.note("pump", r2.pump())
    run.note("pool", r2.prefill.pool.stats()["leased"])


def sc_prefill_scaling(run):
    pfs = {"p0": run.f.SlowPrefill(), "p1": run.f.SlowPrefill()}
    r = run.router(pfs, {"d0": run.f.FakeReplica()}, prefill_scale_high=4,
                   prefill_scale_low=2, prefill_scale_cooldown=0)
    run.note("active", r.stats()["prefill_active"])
    r.pump()
    run.note("active", r.stats()["prefill_active"])
    r.pump()
    for i in range(10):
        run.submit(r, f"s{i}", f"r{i}", [1, 2], 2)
    r.pump()
    run.note("active", r.stats()["prefill_active"])
    run.submit(r, "sx", "rx", [1, 2], 2)
    run.note("queued", {p: e.stats()["queued"] for p, e in pfs.items()})


def sc_prefill_scale_on_starved_decode(run):
    """A shallow backlog restores a scaled-down prefill replica only while
    the decode tier starves (mean slots_active_ratio under one half)."""
    pfs = {"p0": run.f.SlowPrefill(), "p1": run.f.SlowPrefill()}
    busy = run.f.FakeReplica(max_batch=10)
    busy.active = 4                             # 0.45 of its slots
    ratio = run.f.FakeReplica(max_batch=4)
    ratio.stats = lambda: {"max_batch": 4, "active_slots": 2,
                           "slots_active_ratio": 0.45, "queued": 0}
    r = run.router(pfs, {"d0": busy, "d1": ratio}, prefill_scale_high=100,
                   prefill_scale_low=1, prefill_scale_cooldown=1)
    for rnd in range(6):
        if rnd == 2:
            for i in range(3):
                run.submit(r, f"s{i}", f"r{i}", [1, 2], 2)
        if rnd == 4:
            busy.active = 9                     # slots full: no longer starved
        r.pump()
        run.note("active", rnd, r.stats()["prefill_active"])


def sc_multi_prefill_shed(run):
    pfs = {"p0": run.f.FakePrefill(), "p1": run.f.FakePrefill()}
    rep = run.f.FakeReplica()
    r = run.router(pfs, {"d0": rep}, fail_threshold=1,
                   prefill_scale_low=0)
    pfs["p0"].queue.append(("decoy", [1], 1))
    run.submit(r, "s0", "r0", [1, 2, 3], 2)
    pfs["p0"].queue.clear()
    rep.fail_handoffs = True
    run.note("pump", r.pump())
    run.note("pool", pfs["p1"].pool.stats()["free"],
             pfs["p1"].pool.stats()["detached_handles"])


def sc_prefill_health(run):
    pfs = {"p0": run.f.SlowPrefill(), "p1": run.f.SlowPrefill()}
    rep = run.f.FakeReplica(max_batch=1)
    r = run.router(pfs, {"d0": rep}, fail_threshold=1, max_backlog=2,
                   prefill_scale_low=0)
    for i in range(3):
        run.submit(r, f"s{i}", f"r{i}", [1], 1)
    run.submit(r, "s3", "rx", [1], 1)
    pfs["p0"].healthy = pfs["p1"].healthy = False
    r.check_health()
    run.submit(r, "s4", "ry", [1], 1)
    pfs["p0"].healthy = pfs["p1"].healthy = True
    pfs["p0"].release = pfs["p1"].release = True
    r.check_health()
    run.note("pump", r.pump())
    run.note("adopted", sorted(rep.adopted))


def sc_dead_prefill_stats(run):
    pfs = {"p0": run.f.DeadStatsPrefill(), "p1": run.f.DeadStatsPrefill()}
    pfs["p0"].release = pfs["p1"].release = True
    rep = run.f.FakeReplica()
    r = run.router(pfs, {"d0": rep}, prefill_scale_low=0)
    pfs["p0"].healthy = False
    run.note("pump", r.pump())
    run.note("idle", r.idle())
    run.submit(r, "s0", "r0", [1, 2], 2)
    run.note("pump", r.pump())
    pfs["p1"].healthy = False
    run.submit(r, "s1", "r1", [1], 1)


def sc_parked_wire(run):
    pf = run.f.FakePrefill()
    rep = run.f.FakeReplica()
    r = run.router(pf, {"d0": rep})
    rep.saturated = True
    run.submit(r, "s", "r0", [1, 2], 2)
    run.submit(r, "s", "r1", [1, 2, 3], 1)
    run.note("pump", r.pump())
    run.note("pump", r.pump())
    run.note("pool", pf.pool.stats()["detached_handles"])
    rep.saturated = False
    run.note("pump", r.pump())
    run.note("pool", pf.pool.stats()["detached_handles"])
    # parked handoffs are not prefill backlog: the tier stays down
    pfs = {"p0": run.f.SlowPrefill(), "p1": run.f.SlowPrefill()}
    r2 = run.router(pfs, {"d0": run.f.FakeReplica()}, prefill_scale_high=2,
                    prefill_scale_low=1, prefill_scale_cooldown=0)
    r2._scale_prefills()
    r2._parked.extend(("d0", object(), None) for _ in range(16))
    r2._scale_prefills()
    run.note("active", r2.stats()["prefill_active"])
    r2._parked.clear()


def sc_cancel(run):
    pf = run.f.SlowPrefill()
    r = run.router(pf, {"d0": run.f.FakeReplica()})
    run.submit(r, "s", "r0", [1, 2], 2)
    run.note("cancel", r.cancel("r0"))
    r.pump()
    # after the claim: purge_pending frees it
    pf2 = run.f.FakePrefill()
    rep = run.f.PendingReplica()
    r2 = run.router(pf2, {"d0": rep})
    run.submit(r2, "s", "r1", [1, 2], 2)
    run.note("pump", r2.pump())
    run.note("cancel", r2.cancel("r1"), rep.purged)
    # mid prefill: released on arrival
    pf3 = run.f.SlowPrefill()
    pf3.purge = lambda rid: False
    r3 = run.router(pf3, {"d0": run.f.FakeReplica()})
    run.submit(r3, "s", "r2", [1, 2], 2)
    run.note("cancel", r3.cancel("r2"))
    pf3.release = True
    run.note("pump", r3.pump())
    run.note("cancel", r3.cancel("unknown"))
    run.note("pools", [p.pool.stats()["leased"] for p in (pf, pf2, pf3)])


def sc_prefix_routing(run):
    digests = run.pkg.prefix.chain_digests
    pfs = {"p0": run.f.PrefixFakePrefill(), "p1": run.f.PrefixFakePrefill()}
    r = run.router(pfs, {"d0": run.f.FakeReplica()})
    pfs["p1"].register(list(range(16)))
    r._prefix_index.record(digests(list(range(16)), 8), "p1")
    run.submit(r, "sessA", "r0", list(range(16)) + [99, 98], 4)
    run.note("queues", {p: [x[0] for x in e.queue]
                        for p, e in pfs.items()})
    # an unverified hint is kept, not followed
    chain = digests(list(range(40, 56)), 8)
    r._prefix_index.record(chain, "p0")
    run.submit(r, "sessB", "r1", list(range(40, 56)) + [5], 4)
    run.note("routed", r.prefix_routed)
    # a routed chain converges the next session onto its replica
    shared = list(range(24))
    run.submit(r, "sessC", "r2", shared + [77], 4)
    first = next(p for p, e in pfs.items()
                 if any(x[0] == "r2" for x in e.queue))
    pfs[first].register(shared)
    run.submit(r, "sessD", "r3", shared + [88, 89], 4)
    run.note("queues", {p: [x[0] for x in e.queue]
                        for p, e in pfs.items()})
    run.note("pump", r.pump())
    run.note("rehydrated", r.rehydrate_prefix_index())


def sc_prefix_forgotten_on_drain(run):
    digests = run.pkg.prefix.chain_digests
    pfs = {"p0": run.f.PrefixFakePrefill(), "p1": run.f.PrefixFakePrefill()}
    pings = {"p0": True, "p1": True}

    def ping_of(pid):
        def ping():
            if not pings[pid]:
                raise ConnectionError("prefill gone")
            return True
        return ping

    for pid, pf in pfs.items():
        pf.ping = ping_of(pid)
    r = run.router(pfs, {"d0": run.f.FakeReplica()}, fail_threshold=2)
    r._prefix_index.record(digests(list(range(16)), 8), "p1")
    r._prefix_index.record(digests(list(range(40, 56)), 8), "p0")
    pings["p1"] = False
    r.check_health()
    r.check_health()
    run.note("hints", sorted(set(r._prefix_index._entries.values())))
    pings["p1"] = True
    r.check_health()
    run.note("active", r.stats()["prefill_active"])


def sc_evict_and_migrate(run):
    reps = {f"d{i}": run.f.FakeReplica() for i in range(3)}
    pins = {}
    sessions = {}
    mover = run.f.FakeMover(sessions, fail={"m2"}, gone={"m3"})
    r = run.router(run.f.FakePrefill(), reps, mover=mover)
    for i in range(12):
        pins[f"s{i}"] = run.submit(r, f"s{i}", f"m{i}", [1, 2, 3], 2)
        run.note("pump", r.pump())
    src = pins["s0"]
    sessions[id(reps[src])] = [f"m{i}" for i in range(12)
                               if pins[f"s{i}"] == src] + ["m2", "m3"]
    reps[sorted(set(reps) - {src})[0]].free = 0   # no credit there
    run.note("moved", r.request_evict(src), mover.moves)
    run.submit(r, "s0", "m-next", [1, 2], 2)      # the pin moved
    run.submit(r, "fresh", "m99", [1, 2], 2)
    run.note("pump", r.pump())
    # a health drain migrates too, and keeps its series
    left = sorted(set(reps) - {src})
    sessions[id(reps[left[0]])] = ["m-next"]
    reps[left[0]].healthy = False
    r.fail_threshold = 1
    r.check_health()
    run.note("healthy", r.stats()["healthy"])
    with pytest.raises(KeyError):
        r.request_evict("nope")


def sc_shared_pool_misconfig(run):
    pf = run.f.FakePrefill()
    host = run.f.FakeReplica()
    pf._host = host
    r = run.router(pf, {"d0": host})
    run.submit(r, "s", "r0", [1, 2], 2)
    run.note("pump", r.pump())
    for reps in ({"d0": host, "d1": run.f.FakeReplica()},
                 {"d0": run.f.FakeReplica()}, {}):
        with pytest.raises(ValueError) as e:
            run.pkg.router.Router(pf, reps)
        run.note("refused", str(e.value))


SCENARIOS = [sc_affinity, sc_admission_shed, sc_drain_restore_by_clock,
             sc_all_drained, sc_handoff_fallback, sc_prefill_scaling,
             sc_prefill_scale_on_starved_decode, sc_multi_prefill_shed, sc_prefill_health,
             sc_dead_prefill_stats, sc_parked_wire, sc_cancel,
             sc_prefix_routing, sc_prefix_forgotten_on_drain,
             sc_evict_and_migrate, sc_shared_pool_misconfig]


@pytest.fixture
def fresh_router_families():
    """Each package's vtpu_router_* families start empty for the test and
    get their series back after it, so the rendered text compares this
    test's runs alone and no other test sees a change."""
    saved = []
    for pkg in PACKAGES.values():
        for name in ROUTER_FAMILIES:
            inst = getattr(pkg.router, name)
            saved.append((inst, inst._values))
            inst._values = {}
    yield
    for inst, values in saved:
        inst._values = values


def _family_text(pkg) -> str:
    lines = []
    for name in ROUTER_FAMILIES:
        getattr(pkg.router, name).render(lines)
    return "\n".join(lines)


def _run_scenario(scenario, name):
    pkg = PACKAGES[name]
    journal = pkg.events.journal()
    seq0 = journal.snapshot()[-1]["seq"] if len(journal) else 0
    for inst_name in ROUTER_FAMILIES:
        getattr(pkg.router, inst_name)._values = {}
    run = Run(pkg)
    scenario(run)
    events = [{k: v for k, v in rec.items() if k not in ("seq", "ts")}
              for rec in journal.snapshot() if rec["seq"] > seq0]
    return {
        "log": run.log,
        "events": events,
        "results": [r.results() for r in run.routers],
        "stats": [r.stats() for r in run.routers],
        "families": _family_text(pkg),
    }


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_router_policies_match_the_jax_router(scenario,
                                              fresh_router_families):
    """Exact equality: routes, rejects (reason and status), the journal
    records up to their sequence number and timestamp, results(),
    stats() and the vtpu_router_* exposition text."""
    want = _run_scenario(scenario, "jax")
    got = _run_scenario(scenario, "torch")
    assert got["log"] == want["log"]
    assert got["events"] == want["events"]
    assert got["results"] == want["results"]
    assert got["stats"] == want["stats"]
    assert got["families"] == want["families"]
    assert want["log"]  # the scenario did something


def test_router_catches_only_its_own_packages_saturation():
    """Errors travel by class: a JAX replica's ReplicaSaturatedError is
    a plain failure to the port's Router (handoff_failed, the result
    released), never backpressure."""
    run = Run(PACKAGES["torch"])
    jf = fakes(PACKAGES["jax"])
    pf = run.f.FakePrefill()
    rep = jf.FakeReplica()
    rep.saturated = True
    r = run.router(pf, {"d0": rep})
    r.submit("s", "r0", [1, 2], 2)
    r.pump()
    st = r.stats()
    assert st["parked_handoffs"] == 0 and st["shed"] == 1
    assert pf.pool.stats()["detached_handles"] == 0


@pytest.mark.parametrize("replicas", [
    ["d0", "d1"], ["d0", "d1", "d2"], ["a", "b", "c", "d", "e"],
    [f"replica-{i}" for i in range(8)],
])
def test_hash_ring_owners_match(replicas):
    """The same md5 points: every one of 10,000 names gets the same owner
    from both rings, and partitions agree."""
    names = [f"sess-{i}" for i in range(10000)]
    j, t = JaxRing(replicas), TorchRing(replicas)
    assert [t.owner(n) for n in names] == [j.owner(n) for n in names]
    assert t.partition(names[:500]) == j.partition(names[:500])
    assert sorted(set(t.owner(n) for n in names)) == sorted(replicas)


def test_prefix_index_routes_and_prunes_alike():
    """route/record/forget_replica and the LRU cap give the same answers
    over the same (fake) pools."""
    out = {}
    for name, pkg in PACKAGES.items():
        pools = {p: pkg.kvpool.BlockPool(64, 8, pool_id=p)
                 for p in ("p0", "p1")}
        engines = {p: types.SimpleNamespace(pool=pool)
                   for p, pool in pools.items()}
        idx = pkg.prefix.PrefixIndex(cap=6)
        chains = [pkg.prefix.chain_digests(list(range(s, s + 24)), 8)
                  for s in (0, 100, 200)]
        log = []
        blocks = pools["p1"].lease(2)
        pools["p1"].register_prefix(chains[0][:2], blocks)
        pools["p1"].release(blocks)
        idx.record(chains[0], "p1")
        idx.record(chains[1], "p0")
        log.append(idx.route(chains[0], engines))
        log.append(idx.route(chains[1], engines))   # unverified: kept
        log.append(len(idx))
        idx.record(chains[2], "p1")                 # past the cap
        log.append(len(idx))
        log.append(idx.route(chains[0], engines))
        idx.forget_replica("p1")
        log.append((len(idx), idx.route(chains[0], engines)))
        log.append(idx.route([], engines))
        out[name] = log
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# real engines, f32, depth 2, CPU
# ---------------------------------------------------------------------------

KW = dict(vocab=64, d_model=32, depth=2, num_heads=4, max_seq=32)
BS = 8
POOL = 33


def _requests(n=8):
    rng = np.random.default_rng(5)
    lens = [3, 5, 8, 9, 12, 17, 4, 24]
    news = [4, 6, 2, 8, 1, 5, 7, 3]
    return [(f"r{i}", rng.integers(0, 64, lens[i % len(lens)]).astype(
        np.int32), news[i % len(news)]) for i in range(n)]


def _serve(pkg, mods, model, mode, reqs, jax_params=None):
    """Route ``reqs`` over 4 sessions through ``pkg``'s Router; returns
    (routes, transcripts, pools, host bytes delta, wire bytes delta)."""
    Dec, Pf = mods.disagg.DecodeEngine, mods.disagg.PrefillEngine
    tp = mods.transport
    if jax_params is not None:
        def dec_of(**kw):
            return Dec(model, jax_params, max_batch=4, eos_id=2, **kw)

        def pf_of(**kw):
            return Pf(model, jax_params, **kw)
    else:
        def dec_of(**kw):
            return Dec(model, 4, eos_id=2, device="cpu", **kw)

        def pf_of(**kw):
            return Pf(model, device="cpu", **kw)
    kv = mods.kvpool
    fams = {"shared": lambda: kv.HANDOFF_TOTAL.value(mode="shared"),
            "copy": lambda: kv.HANDOFF_TOTAL.value(mode="copy"),
            "wire": lambda: kv.HANDOFF_TOTAL.value(mode="wire"),
            "blocks": kv.HANDOFF_BLOCKS.value,
            "device_bytes": kv.HANDOFF_DEVICE_BYTES.value,
            "stale": kv.HANDOFF_STALE.value,
            "chunks": tp.TRANSPORT_CHUNKS.value}
    c0 = {k: f() for k, f in fams.items()}
    h0 = mods.kvpool.HANDOFF_HOST_BYTES.value()
    b0 = tp.TRANSPORT_BYTES.value()
    if mode == "copy":
        decs = {f"d{i}": dec_of(replica_id=f"d{i}") for i in range(2)}
        pf = pf_of()
        reps = decs
    elif mode == "shared":
        decs = {"d0": dec_of(replica_id="d0")}
        pf = pf_of(shared_with=decs["d0"])
        reps = decs
    else:
        decs = {"w0": dec_of(replica_id="w0")}
        pf = pf_of()
        reps = {"w0": tp.WireReplica(tp.LoopbackLink(
            tp.ReceiverHub(decs["w0"])), "w0", local=decs["w0"],
            chunk_blocks=2, codec="fp32")}
    router = mods.router.Router(pf, reps)
    routes = []
    for i, (rid, p, n) in enumerate(reqs):
        while True:
            try:
                routes.append(router.submit(f"sess{i % 4}", rid, p, n))
                break
            except mods.router.RouterReject:
                router.pump()
    got = router.drain()
    pools = [pf.pool] if mode != "shared" else []
    pools += [d.pool for d in decs.values()]
    return (routes, got, pools,
            mods.kvpool.HANDOFF_HOST_BYTES.value() - h0,
            tp.TRANSPORT_BYTES.value() - b0,
            {k: f() - c0[k] for k, f in fams.items()})


@pytest.fixture(scope="module")
def jax_side():
    from torch_parity import jax_params
    from vtpu.models.transformer import TransformerLM as JaxLM
    from vtpu.serving.paged import PagedBatcher as JPaged

    jm = JaxLM(**KW, kv_cache_layout="paged", kv_block_size=BS,
               kv_pool_blocks=POOL)
    params = jax_params(jm)
    reqs = _requests()
    mono = JPaged(jm, params, max_batch=4, eos_id=2)
    for rid, p, n in reqs:
        mono.submit(rid, p, num_new=n)
    out = {"mono": mono.run(), "model": jm, "params": params}
    for mode in ("copy", "shared", "wire"):
        out[mode] = _serve("jax", PACKAGES["jax"], jm, mode, reqs,
                           jax_params=params)
    return out


def _leak_free(pool):
    st = pool.stats()
    return st["leased"] == 0 and st["detached_handles"] == 0


@pytest.mark.parametrize("mode", ["copy", "shared", "wire"])
def test_router_over_real_engines_matches_jax(jax_side, mode):
    """Token-exact (f32): the port's Router over the port's engines
    routes like the JAX Router over the JAX engines, and both give the
    monolithic PagedBatcher's transcripts.  The in-process handoffs keep
    vtpu_kv_handoff_host_bytes_total at 0 in both packages; the wire's
    host bytes are exactly its payload bytes.  No block leaks."""
    from torch_parity import port_of
    from vtpu_torch.serving.paged import PagedBatcher

    tm = port_of(jax_side["model"], jax_side["params"])
    reqs = _requests()
    mono = PagedBatcher(tm, 4, eos_id=2, device="cpu")
    for rid, p, n in reqs:
        mono.submit(rid, p, num_new=n)
    tmono = mono.run()
    assert tmono == jax_side["mono"]
    j_routes, j_got, j_pools, j_host, j_wire, j_fams = jax_side[mode]
    t_routes, t_got, t_pools, t_host, t_wire, t_fams = _serve(
        "torch", PACKAGES["torch"], tm, mode, reqs)
    assert t_routes == j_routes
    # the vtpu_kv_handoff_* and transport families move alike
    assert t_fams == j_fams and t_fams[mode] == len(reqs)
    assert j_got == jax_side["mono"]
    assert t_got == j_got
    if mode == "wire":
        assert t_wire > 0 and t_host == t_wire
        assert j_host == j_wire
    else:
        assert t_host == 0 and j_host == 0
        assert t_wire == 0
    assert all(_leak_free(p) for p in t_pools)
    assert all(_leak_free(p) for p in j_pools)
