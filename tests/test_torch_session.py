"""Live session export, adoption and moves on the port's decode engines,
on the CPU in f32, against the never-moved monolithic engine and across
packages.

- torch -> torch (the port's ``SessionMover``), mid-decode: tokens equal
  the monolithic engine's, the fp32 blocks arrive bit for bit, both
  pools leak-free;
- JAX -> torch (the JAX package's mover, a JAX source engine) and
  torch -> JAX (the port's mover, a JAX target engine), at depth 12 (the
  wire's leaf order, tests/test_torch_wire.py);
- a queued adoption moves; a queued cross-pool adoption finishes in
  place; a suffix-only move skips the prefix the target holds; a torn
  stream restores the session on the source; an EOS-frozen session moves
  frozen; an unknown rid is ``SessionGoneError``; no target with credit
  restores the session (``NoMigrationTargetError``);
- an export parks the slot's table row on the garbage block at once: the
  decode windows that run before the restore never write the exported
  blocks.

- over HTTP (the target's package serving ``handle_http_frame``), a
  torch session moves into a JAX engine, and a JAX target whose pool
  layout differs refuses the OPEN by name: the port's mover restores the
  session (``NoMigrationTargetError``).

Failure paths in process run through one package's mover, sender and
hub: each package catches its own error classes (ROADMAP C, trap 3).
"""

import numpy as np
import pytest
import torch

from torch_parity import jax_params, port_of
from vtpu_torch.serving import transport as ttp
from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
from vtpu_torch.serving.migrate import (
    MigrationError,
    NoMigrationTargetError,
    SessionGoneError,
    SessionMover,
)
from vtpu_torch.serving.paged import PagedBatcher

KW = dict(vocab=64, d_model=32, num_heads=4, max_seq=32)
BS = 8
POOL = 33


def _leak_free(pool) -> bool:
    st = pool.stats()
    return (st["leased"] == 0 and st["detached_handles"] == 0
            and st["free"] == st["pool_blocks"] - 1)


def _only_pins(pool) -> bool:
    st = pool.stats()
    return (st["leased"] == st["prefix_blocks"]
            and st["detached_handles"] == 0)


@pytest.fixture(scope="module")
def world():
    """The JAX models at depth 2 and 12 (one weight set each) and their
    ports."""
    from vtpu.models.transformer import TransformerLM as JaxLM

    w = {}
    for depth in (2, 12):
        jm = JaxLM(**KW, depth=depth, kv_cache_layout="paged",
                   kv_block_size=BS, kv_pool_blocks=POOL)
        params = jax_params(jm)
        w[depth] = {"jm": jm, "params": params, "tm": port_of(jm, params)}
    return w


def mig_requests(seed=53, n=6, num_new=8):
    """tests/test_disagg.py's migration requests."""
    rng = np.random.default_rng(seed)
    lens = [5, 9, 12, 16, 7, 11]
    return [(f"m{i}", rng.integers(0, 64, lens[i % len(lens)]).astype(
        np.int32), num_new) for i in range(n)]


def run_monolithic(tm, reqs, eos_id=2):
    eng = PagedBatcher(tm, max_batch=4, eos_id=eos_id, device="cpu")
    for rid, p, n in reqs:
        eng.submit(rid, p, num_new=n)
    return {rid: list(t) for rid, t in eng.run().items()}


def drain(eng) -> None:
    while any(eng.active) or eng._inflight or eng.queue:
        eng.step()
    eng._flush_first_tokens()


def merged(*engines) -> dict:
    out = {}
    for e in engines:
        out.update({rid: list(t) for rid, t in e.out.items()})
    return out


def torch_pair(tm, max_batch=8, **kw):
    return (DecodeEngine(tm, max_batch, eos_id=2, replica_id="A",
                         device="cpu", **kw),
            DecodeEngine(tm, max_batch, eos_id=2, replica_id="B",
                         device="cpu", **kw))


def adopt_all(pf, eng, reqs, chain=False, **kw) -> None:
    for rid, p, n in reqs:
        pf.submit(rid, p, num_new=n)
    for res in pf.run():
        eng.submit_handle(res.rid, res.handle, res.first_token, res.num_new,
                          source=None if pf.pool is eng.pool else pf,
                          chain=list(res.chain) if chain else None, **kw)


def snapshot_at_fin(src, dst) -> list:
    """At each stream's FIN into ``dst``, the (source rows, adopted rows)
    of the blocks that shipped; the source's blocks are still claimed by
    the mover then."""
    from vtpu_torch.serving.disagg import wire_leaves

    snaps, inner = [], dst.wire_finish

    def wire_finish(ctx, meta):
        shipped = meta["handle"]["blocks"][ctx["skip"]:]
        snaps.append([(s[shipped].clone(), d[list(ctx["dst"])].clone())
                      for s, d in zip(wire_leaves(src.cache["layers"]),
                                      wire_leaves(dst.cache["layers"]))])
        inner(ctx, meta)

    dst.wire_finish = wire_finish
    return snaps


# -- torch -> torch --------------------------------------------------------
@pytest.mark.parametrize("pipeline_depth,harvest_every", [(0, 1), (1, 2)])
def test_move_mid_decode_token_exact_and_leak_free(world, pipeline_depth,
                                                   harvest_every):
    """Three sessions move A -> B a few windows into decode: the merged
    transcripts equal the never-moved control, the fp32 blocks arrive bit
    for bit, and no pool leaks."""
    tm = world[2]["tm"]
    reqs = mig_requests()
    want = run_monolithic(tm, reqs)
    pf = PrefillEngine(tm, device="cpu")
    a, b = torch_pair(tm, pipeline_depth=pipeline_depth,
                      harvest_every=harvest_every)
    snaps = snapshot_at_fin(a, b)
    adopt_all(pf, a, reqs)
    for _ in range(2):  # windows in flight at the export, when pipelined
        a.step()
    mover = SessionMover()
    moved = list(a.exportable_sessions())[:3]
    for rid in moved:
        rep = mover.move(rid, a, [("B", b)])
        assert rep.target == "B" and rep.blocks_skipped == 0
        assert rep.blocks_shipped > 0 and rep.codec == "fp32"
    assert len(snaps) == 3
    assert all(torch.equal(s, d) for snap in snaps for s, d in snap)
    drain(a)
    drain(b)
    assert merged(a, b) == want
    for rid in moved:
        assert rid in b.out and rid not in a.out
    assert _leak_free(pf.pool) and _leak_free(a.pool) and _leak_free(b.pool)


def test_export_parks_the_slot_before_the_next_window(world):
    """An export points the slot's table row at the garbage block and its
    position at 0 in place; the windows the engine runs before the
    restore leave the exported blocks untouched; the restore resumes
    token for token."""
    tm = world[2]["tm"]
    reqs = mig_requests(seed=57, n=3)
    want = run_monolithic(tm, reqs)
    pf = PrefillEngine(tm, device="cpu")
    a, _b = torch_pair(tm)
    adopt_all(pf, a, reqs)
    for _ in range(2):
        a.step()
    table, pos = a.cache["block_table"], a.cache["pos"]
    slot = a.rid.index("m1")
    export = a.export_session("m1")
    assert a.cache["block_table"] is table and a.cache["pos"] is pos
    assert int(table[slot].abs().sum()) == 0 and int(pos[slot]) == 0
    assert export.cursor == len(reqs[1][1]) + len(export.tail) - 1
    assert export.remaining + len(export.tail) == reqs[1][2]
    from vtpu_torch.serving.disagg import wire_leaves

    blocks = list(export.handle.blocks)
    before = [t[blocks].clone() for t in wire_leaves(a.cache["layers"])]
    for _ in range(3):
        a.step()
    assert all(torch.equal(t[blocks], x) for t, x in
               zip(wire_leaves(a.cache["layers"]), before))
    assert "m1" not in a.exportable_sessions()
    a.adopt_session(export)
    drain(a)
    assert merged(a) == want
    assert _leak_free(a.pool) and _leak_free(pf.pool)


def test_queued_pending_adoption_moves(world):
    """A claimed-but-unslotted adoption in A's pool exports and moves
    instead of finishing in place."""
    tm = world[2]["tm"]
    reqs = mig_requests(seed=71, n=4)
    want = run_monolithic(tm, reqs)
    a, b = torch_pair(tm)
    pf = PrefillEngine(tm, shared_with=a, device="cpu")
    adopt_all(pf, a, reqs, admit=False)
    queued = [pa.rid for pa in a.queue]
    assert len(queued) == 4 and set(a.exportable_sessions()) == set(queued)
    rep = SessionMover().move(queued[0], a, [("B", b)])
    assert rep.target == "B"
    assert all(pa.rid != queued[0] for pa in a.queue)
    a.admit_pending()
    drain(a)
    drain(b)
    assert merged(a, b) == want
    assert queued[0] in b.out and queued[0] not in a.out
    assert _leak_free(a.pool) and _leak_free(b.pool)


def test_queued_cross_pool_adoption_finishes_in_place(world):
    tm = world[2]["tm"]
    reqs = mig_requests(seed=73, n=2)
    want = run_monolithic(tm, reqs)
    pf = PrefillEngine(tm, device="cpu")
    a, b = torch_pair(tm)
    adopt_all(pf, a, reqs, admit=False)
    rid0 = a.queue[0].rid
    assert rid0 not in a.exportable_sessions()
    with pytest.raises(SessionGoneError):
        SessionMover().move(rid0, a, [("B", b)])
    assert any(pa.rid == rid0 for pa in a.queue)
    a.admit_pending()
    drain(a)
    assert merged(a) == want
    assert _leak_free(pf.pool) and _leak_free(a.pool) and _leak_free(b.pool)


def test_suffix_only_move(world):
    """Sessions sharing a prompt prefix, adopted with their chains: the
    first move ships every block and the target registers the chain; the
    second skips the 2-block prefix (``skip_blocks``).  Tokens exact."""
    tm = world[2]["tm"]
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 64, 16).astype(np.int32)
    reqs = [(f"s{i}", np.concatenate(
        [prefix, rng.integers(0, 64, 3 + i).astype(np.int32)]), 8)
        for i in range(3)]
    want = run_monolithic(tm, reqs)
    pf = PrefillEngine(tm, prefix_cache=True, device="cpu")
    a, b = torch_pair(tm, max_batch=4)
    snaps = snapshot_at_fin(a, b)
    adopt_all(pf, a, reqs, chain=True)
    for _ in range(3):
        a.step()
    mover = SessionMover()
    r1 = mover.move("s0", a, [("B", b)])
    r2 = mover.move("s1", a, [("B", b)])
    assert r1.blocks_skipped == 0
    assert r2.blocks_skipped == 2
    assert r2.blocks_shipped == r1.blocks_shipped - 2
    assert all(torch.equal(s, d) for snap in snaps for s, d in snap)
    drain(a)
    drain(b)
    assert merged(a, b) == want
    for pool in (a.pool, b.pool, pf.pool):
        assert _only_pins(pool)


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_torn_stream_restores_on_the_source(world, codec):
    """A persistently torn stream: a typed failure, the session restored
    on the source goes on token for token, both pools clean."""
    tm = world[2]["tm"]
    reqs = mig_requests(seed=59, n=2)
    want = run_monolithic(tm, reqs)
    pf = PrefillEngine(tm, device="cpu")
    a, b = torch_pair(tm, max_batch=4)
    adopt_all(pf, a, reqs)
    for _ in range(2):
        a.step()

    def fault(data):
        fr = ttp.decode_frame(data)
        if fr.kind in ttp._DATA_KINDS and fr.seq >= 1:
            raise OSError("torn")

    mover = SessionMover(chunk_blocks=1, retries=2, codec=codec)
    mover._hubs[id(b)] = ttp.LoopbackLink(ttp.ReceiverHub(b), fault=fault)
    with pytest.raises(MigrationError) as ei:
        mover.move("m0", a, [("B", b)])
    assert ei.value.restored is True and ei.value.phase == "stream"
    assert "m0" in a.exportable_sessions() and "m0" not in b.out
    drain(a)
    assert merged(a) == want
    assert _leak_free(pf.pool) and _leak_free(a.pool) and _leak_free(b.pool)


def test_frozen_session_moves_frozen(world):
    """A session that met EOS before the move carries its freeze: the
    target pads with EOS as the never-moved control does."""
    tm = world[2]["tm"]
    reqs = mig_requests(seed=61, n=4, num_new=12)
    free = run_monolithic(tm, reqs, eos_id=None)
    rid, toks = next((r, t) for r, t in free.items() if len(set(t[:3])) > 1)
    eos = toks[1]  # the session's second token becomes EOS
    want = run_monolithic(tm, reqs, eos_id=eos)
    assert want[rid][2:] == [eos] * (len(toks) - 2)
    pf = PrefillEngine(tm, device="cpu")
    a = DecodeEngine(tm, 8, eos_id=eos, replica_id="A", device="cpu")
    b = DecodeEngine(tm, 8, eos_id=eos, replica_id="B", device="cpu")
    adopt_all(pf, a, reqs)
    for _ in range(3):
        a.step()
    exports, inner = [], a.export_session
    a.export_session = lambda r: exports.append(inner(r)) or exports[-1]
    SessionMover().move(rid, a, [("B", b)])
    assert exports[0].frozen and exports[0].session_doc()["done"]
    assert b.done_frozen[b.rid.index(rid)]
    drain(a)
    drain(b)
    assert merged(a, b) == want
    assert _leak_free(a.pool) and _leak_free(b.pool)


def test_unknown_rid_is_session_gone(world):
    tm = world[2]["tm"]
    a, b = torch_pair(tm, max_batch=2)
    with pytest.raises(SessionGoneError) as ei:
        a.export_session("nobody")
    assert ei.value.phase == "export" and not ei.value.restored
    with pytest.raises(SessionGoneError):
        SessionMover().move("nobody", a, [("B", b)])
    assert a.exportable_sessions() == []


def test_no_target_with_credit_restores(world):
    """A target whose pool has no free block answers the OPEN saturated:
    the session is restored on the source and finishes there."""
    tm = world[2]["tm"]
    reqs = mig_requests(seed=67, n=2)
    want = run_monolithic(tm, reqs)
    pf = PrefillEngine(tm, device="cpu")
    a, b = torch_pair(tm, max_batch=4)
    held = b.pool.lease(b.pool.free_blocks())
    adopt_all(pf, a, reqs)
    a.step()
    with pytest.raises(NoMigrationTargetError) as ei:
        SessionMover().move("m1", a, [("B", b)])
    assert ei.value.restored
    drain(a)
    assert merged(a) == want
    b.pool.release(held)
    assert _leak_free(a.pool) and _leak_free(b.pool) and _leak_free(pf.pool)


# -- across packages, depth 12 ----------------------------------------------
def test_move_jax_to_torch_depth_12(world):
    """The JAX package's mover takes sessions from a JAX decode engine to
    a torch one (the JAX hub over the port's sink), mid-decode: tokens
    equal the never-moved control, both pools leak-free."""
    from vtpu.serving.disagg import DecodeEngine as JDec
    from vtpu.serving.disagg import PrefillEngine as JPf
    from vtpu.serving.migrate import SessionMover as JMover

    w = world[12]
    reqs = mig_requests(seed=79, n=4)
    want = run_monolithic(w["tm"], reqs)
    jpf = JPf(w["jm"], w["params"])
    a = JDec(w["jm"], w["params"], max_batch=4, eos_id=2)
    b = DecodeEngine(w["tm"], 4, eos_id=2, device="cpu")
    adopt_all(jpf, a, reqs)
    for _ in range(3):
        a.step()
    moved = list(a.exportable_sessions())[:2]
    for rid in moved:
        assert JMover().move(rid, a, [("B", b)]).target == "B"
    drain(a)
    drain(b)
    assert merged(a, b) == want
    assert all(rid in b.out for rid in moved)
    assert _leak_free(b.pool) and a.pool.stats()["leased"] == 0


def test_move_torch_to_jax_depth_12(world):
    """The port's mover takes sessions from a torch decode engine to a JAX
    one (the port's hub over the JAX sink), one of them queued."""
    from vtpu.serving.disagg import DecodeEngine as JDec

    w = world[12]
    reqs = mig_requests(seed=83, n=5)
    want = run_monolithic(w["tm"], reqs)
    pf = PrefillEngine(w["tm"], device="cpu")
    a = DecodeEngine(w["tm"], 4, eos_id=2, replica_id="A", device="cpu")
    pfa = PrefillEngine(w["tm"], shared_with=a, device="cpu")
    b = JDec(w["jm"], w["params"], max_batch=4, eos_id=2)
    adopt_all(pf, a, reqs[:4])
    adopt_all(pfa, a, reqs[4:], admit=False)  # a queued one
    for _ in range(3):
        a.step()
    live = [r for r in a.rid if r is not None][:2]
    queued = [pa.rid for pa in a.queue]
    assert queued
    mover = SessionMover()
    for rid in live + queued:
        assert mover.move(rid, a, [("B", b)]).target == "B"
    drain(a)
    drain(b)
    assert merged(a, b) == want
    assert _leak_free(a.pool) and _leak_free(pf.pool)
    assert b.pool.stats()["leased"] == 0


class _HttpTarget:
    """A migration target reached over HTTP: the mover uses its link."""

    def __init__(self, link) -> None:
        self.link = link


def test_move_torch_to_jax_over_http_depth_12(world):
    """The port's mover into a JAX engine served over HTTP: a session
    moves token for token; a JAX target on an int8 pool refuses the OPEN
    (PoolMismatchError, by name), and the session is restored on the
    source (NoMigrationTargetError) and finishes there."""
    from test_torch_wire import http_receiver
    from vtpu.serving import transport as jtp
    from vtpu.serving.disagg import DecodeEngine as JDec

    w = world[12]
    reqs = mig_requests(seed=89, n=3)
    want = run_monolithic(w["tm"], reqs)
    pf = PrefillEngine(w["tm"], device="cpu")
    a = DecodeEngine(w["tm"], 4, eos_id=2, replica_id="A", device="cpu")
    b = JDec(w["jm"], w["params"], max_batch=4, eos_id=2)
    bad = JDec(w["jm"].clone(kv_cache_dtype="int8"), w["params"],
               max_batch=4, eos_id=2)
    adopt_all(pf, a, reqs)
    for _ in range(2):
        a.step()
    hubs = {"b": jtp.ReceiverHub(b), "bad": jtp.ReceiverHub(bad)}
    with http_receiver(lambda body: jtp.handle_http_frame(
            hubs["b"], body)) as url_b, http_receiver(
            lambda body: jtp.handle_http_frame(hubs["bad"], body)) as url_x:
        link_b = ttp.HttpKVLink(url_b, timeout_s=30.0)
        link_x = ttp.HttpKVLink(url_x, timeout_s=30.0)
        try:
            mover = SessionMover()
            rep = mover.move("m0", a, [("B", _HttpTarget(link_b))])
            assert rep.target == "B" and rep.blocks_shipped > 0
            probe = a.pool.detach(a.pool.lease(1), 1)
            with pytest.raises(Exception) as ei:
                ttp.StreamSender(link_x, "probe", probe,
                                 layout=a.wire_layout()).open()
            a.pool.release_handle(probe)
            assert type(ei.value).__name__ == "PoolMismatchError"
            assert isinstance(ei.value, ttp.PoolMismatchError)
            with pytest.raises(NoMigrationTargetError) as ei:
                mover.move("m1", a, [("X", _HttpTarget(link_x))])
            assert ei.value.restored
        finally:
            link_b.close()
            link_x.close()
    drain(b)
    drain(a)
    assert merged(a, b) == want
    assert "m0" in b.out and "m1" in a.out
    assert _leak_free(a.pool) and _leak_free(pf.pool)
    assert b.pool.stats()["leased"] == 0 and hubs["bad"].open_streams() == 0
