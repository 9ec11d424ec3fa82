"""The K/V wire handoff across frameworks, at depth 12.

A JAX ``PrefillEngine`` streams into a torch ``DecodeEngine`` (the JAX
package's ``WireReplica`` and links into the port's ``ReceiverHub``), and
a torch ``PrefillEngine`` into a JAX ``DecodeEngine`` (the port's sender
into the JAX package's hub), over ``LoopbackLink`` and over
``HttpKVLink`` to a ``handle_http_frame`` server on 127.0.0.1, native
and int8 pools, in f32:

- ``fp32``: the transcripts equal the monolithic engine's and the
  adopted blocks equal the source blocks bit for bit; int8, fp8, int4
  (native pool): every adopted block within
  ``wirecodec.error_bound(wire_quant_max_scale, codec)`` of its source,
  and within its own block's bound; the same JAX stream teed into a JAX
  decode engine adopts bit-identical blocks (the int8 pool's cases are
  tests/test_torch_wire_int8.py, which builds its world with this
  file's helpers);
- both pools leak-free after every case, after a mid-stream death too;
- the speculative-rollback matrix of tests/test_disagg.py;
- a layout mismatch and a stale handle arrive as the same error class
  by name, whichever package raised them.

Depth 12 because the wire order of the pool leaves is JAX's flatten
order, layer names sorted as strings (``h0, h1, h10, h11, h2, ...``):
every layer's leaves have one shape and dtype, so a stream in layer
order would pass the layout check and land layer 10's K/V in layer 2.
At depth 2 (tests/test_disagg.py) both orders agree.

The JAX side runs once, in a module-scoped fixture, and its engines
serve the file's other tests.
"""

import contextlib
import http.server
import json
import threading

import numpy as np
import pytest
import torch

from torch_parity import jax_params, port_of
from vtpu_torch.serving import transport as ttp
from vtpu_torch.serving import wirecodec
from vtpu_torch.serving.disagg import (
    DecodeEngine,
    PrefillEngine,
    pool_layout,
    wire_leaves,
)
from vtpu_torch.serving.paged import PagedBatcher

KW = dict(vocab=64, d_model=32, depth=12, num_heads=4, max_seq=32,
          kv_cache_layout="paged", kv_block_size=8)
POOL = 161
CODECS = ("fp32", "int8", "fp8", "int4")
LINKS = ("loopback", "http")
# (pool, codec): the int8 pool's leaves are int8, which a quantized
# codec's f32 reconstruction cannot hold within its bound; the wire arm
# of an int8 pool runs fp32
CASES = [("native", c) for c in CODECS] + [("int8", "fp32")]


def requests(tag: str, seed: int = 3):
    """Prompts in two length buckets (16 and 32) whose leases all pad to
    four blocks, so that each JAX extract program compiles once a
    codec."""
    rng = np.random.default_rng(seed)
    lens, news = [17, 9, 24, 12, 20], [4, 13, 6, 9, 3]
    return [(f"{tag}{i}", rng.integers(0, 64, n).astype(np.int32), k)
            for i, (n, k) in enumerate(zip(lens, news))]


def _leak_free(pool) -> bool:
    st = pool.stats()
    return (st["leased"] == 0 and st["detached_handles"] == 0
            and st["free"] == st["pool_blocks"] - 1)


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        status, doc = self.server.handle_frame(self.rfile.read(n))
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


class _Server(http.server.ThreadingHTTPServer):
    """A thread per connection, each kept so that it can be joined."""

    def __init__(self, handle_frame):
        super().__init__(("127.0.0.1", 0), _Handler)
        self.handle_frame = handle_frame
        self.handlers = []

    def process_request(self, request, client_address):
        t = threading.Thread(target=self.process_request_thread,
                             args=(request, client_address), daemon=True)
        self.handlers.append(t)
        t.start()


@contextlib.contextmanager
def http_receiver(handle_frame):
    """A receiver on 127.0.0.1 (port 0) whose POSTs go to
    ``handle_frame(body) -> (status, doc)``.  On exit (after the caller
    closed its connections) the server is shut down and every thread it
    started is joined, with a timeout."""
    srv = _Server(handle_frame)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        for th in [t] + srv.handlers:
            th.join(timeout=10)
            assert not th.is_alive()


@contextlib.contextmanager
def link_to(kind: str, hub, client_tp, server_tp):
    """A ``client_tp`` link into ``hub`` (served by ``server_tp``'s
    ``handle_http_frame`` over HTTP)."""
    if kind == "loopback":
        yield client_tp.LoopbackLink(hub)
        return
    with http_receiver(lambda body: server_tp.handle_http_frame(
            hub, body)) as url:
        link = client_tp.HttpKVLink(url, timeout_s=30.0)
        try:
            yield link
        finally:
            link.close()


def _pump_all(rep) -> None:
    while rep.idle_senders():
        rep.pump_streams()


def _block_error(src_leaves, dst_leaves, pairs) -> float:
    """Largest |dst - src| over every leaf of the (source handle blocks,
    adopted blocks) pairs."""
    worst = 0.0
    for s, d in zip(src_leaves, dst_leaves):
        for sb, db in pairs:
            a = np.asarray(s)[list(sb)].astype(np.float64)
            b = np.asarray(d)[list(db)].astype(np.float64)
            worst = max(worst, float(np.abs(a - b).max()))
    return worst


def _block_bound_ratio(src_leaves, dst_leaves, pairs, codec) -> float:
    """Largest |dst - src| over its own block's bound, every leaf of the
    (source handle blocks, adopted blocks) pairs: the block's scale/2
    (int8, int4) or scale*16 (fp8), scaled by the numpy twin from the
    source block, plus half a pool-dtype ulp of the value."""
    worst = 0.0
    for s, d in zip(src_leaves, dst_leaves):
        for sb, db in pairs:
            a = np.asarray(s)[list(sb)].astype(np.float32)
            b = np.asarray(d)[list(db)]
            _q, sc = wirecodec.quantize_blocks_for(a, codec)
            per = sc.reshape((-1,) + (1,) * (a.ndim - 1)).astype(
                np.float64) * (16.0 if codec == "fp8" else 0.5)
            per = per + np.maximum(np.abs(a), np.abs(b)) * (
                np.finfo(b.dtype).eps / 2)
            diff = np.abs(b.astype(np.float64) - a)
            worst = max(worst, float((diff / per).max()))
    return worst


class _TeeLink:
    """A loopback link into two receiver hubs: the sender reads the
    first hub's answers, the second takes the same frames; both answers
    are kept."""

    def __init__(self, hub, twin) -> None:
        self.hub, self.twin, self.answers = hub, twin, []

    def send(self, data: bytes, fresh: bool = False) -> dict:
        got = self.hub.handle(data)
        self.answers.append((got, self.twin.handle(data)))
        return got

    def close(self) -> None:
        pass


def _adopted_by_rid(dec, rids) -> dict:
    return {rid: list(dec._slot_blocks[slot])
            for slot, rid in enumerate(dec.rid) if rid in rids}


def _adopted(dec, handles) -> list:
    """(source blocks, adopted blocks) per request, read from the decode
    engine's slots right after the streams bound them."""
    pairs = []
    for slot, rid in enumerate(dec.rid):
        if rid in handles:
            pairs.append((handles[rid].blocks, dec._slot_blocks[slot]))
    assert len(pairs) == len(handles)
    return pairs


def _run_decode(dec) -> dict:
    while any(dec.active) or dec.queue or dec._inflight:
        dec.step()
    dec._flush_first_tokens()
    return dec.out


def build_world(pools) -> dict:
    """The models of ``pools`` (one set of weights), the monolithic
    tokens, and the outcome of every cross-framework stream of
    ``CASES`` on those pools; the JAX engines stay in the result."""
    import jax

    from vtpu.models.transformer import TransformerLM as JaxLM
    from vtpu.serving import transport as jtp
    from vtpu.serving.disagg import DecodeEngine as JDec
    from vtpu.serving.disagg import PrefillEngine as JPf
    from vtpu.serving.paged import PagedBatcher as JPaged

    jm = {pool: JaxLM(**KW, kv_pool_blocks=POOL, kv_cache_dtype=pool)
          for pool in pools}
    params = jax_params(jm[pools[0]])
    tm = {pool: port_of(m, params) for pool, m in jm.items()}
    w = {"jm": jm, "params": params, "tm": tm, "jtp": jtp, "JDec": JDec,
         "JPf": JPf, "want": {}, "j2t": {}, "t2j": {}, "jpf": {},
         "jdec": {}, "layouts": {}}
    for pool in jm:
        eng = PagedBatcher(tm[pool], max_batch=8, eos_id=2, device="cpu")
        for rid, p, n in requests("m"):
            eng.submit(rid, p, num_new=n)
        w["want"][pool] = {r[1:]: t for r, t in eng.run().items()}
    mono = JPaged(jm[pools[0]], params, max_batch=8, eos_id=2)
    for rid, p, n in requests("m"):
        mono.submit(rid, p, num_new=n)
    w["jax_mono"] = {r[1:]: t for r, t in mono.run().items()}

    def flat(tree):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]

    for pool in jm:
        cases = [(c, link) for p_, c in CASES if p_ == pool
                 for link in LINKS]
        # JAX prefill -> torch decode: one JAX engine prefills every
        # case's requests (its programs compile once)
        jpf = JPf(jm[pool], params)
        for codec, link in cases:
            for rid, p, n in requests(f"{codec}/{link}/"):
                jpf.submit(rid, p, num_new=n)
        results = {r.rid: r for r in jpf.run()}
        src = flat(jpf.pool_leaves())
        # a JAX decode engine takes the same frames as the torch one in
        # every quantized loopback case (one slot a request, never
        # decoded): the two receivers' decodings of one stream
        twins = [c for c, link in cases
                 if c in wirecodec.QUANT_CODECS and link == "loopback"]
        jsink = (JDec(jm[pool], params, max_batch=5 * len(twins), eos_id=2)
                 if twins else None)
        for codec, link in cases:
            tag = f"{codec}/{link}/"
            dec = DecodeEngine(tm[pool], 8, eos_id=2, device="cpu")
            hub = ttp.ReceiverHub(dec)
            mine = {rid: r for rid, r in results.items()
                    if rid.startswith(tag)}
            tee = (_TeeLink(hub, jtp.ReceiverHub(jsink))
                   if codec in twins and link == "loopback" else None)
            with (contextlib.nullcontext(tee) if tee is not None
                  else link_to(link, hub, jtp, ttp)) as jlink:
                rep = jtp.WireReplica(jlink, "w0", chunk_blocks=2,
                                      codec=codec)
                for r in mine.values():
                    rep.submit_handle(r.rid, r.handle, r.first_token,
                                      r.num_new, source=jpf, admit=False)
                _pump_all(rep)
            pairs = _adopted(dec, {k: r.handle for k, r in mine.items()})
            dst = [t.numpy() for t in wire_leaves(dec.cache["layers"])]
            err = _block_error(src, dst, pairs)
            case = dict(err=err, block_ratio=(
                _block_bound_ratio(src, dst, pairs, codec)
                if codec in wirecodec.QUANT_CODECS else None))
            if tee is not None:
                mine_b = _adopted_by_rid(dec, mine)
                jsink_b = _adopted_by_rid(jsink, mine)
                jdst = flat(jsink._split_cache()[0])
                case["twin"] = dict(
                    answers=[(a.get("status"), b.get("status"))
                             for a, b in tee.answers],
                    rids=(sorted(mine_b), sorted(jsink_b)),
                    blocks=sum(len(b) for b in mine_b.values()),
                    bits_equal=all(
                        t[mine_b[rid]].tobytes() == j[jsink_b[rid]].tobytes()
                        for t, j in zip(dst, jdst) for rid in mine_b))
            out = _run_decode(dec)
            w["j2t"][pool, codec, link] = dict(
                case, out={r[len(tag):]: t for r, t in out.items()},
                bound=wirecodec.error_bound(dec.wire_quant_max_scale,
                                            codec),
                dec_clean=_leak_free(dec.pool), hub=hub.stats(),
                host_bytes=dec.pool.stats()["handoff_host_bytes"])
        w["j2t"][pool, "source_clean"] = _leak_free(jpf.pool)
        # torch prefill -> JAX decode: one JAX decode engine takes every
        # case in turn
        tpf = PrefillEngine(tm[pool], device="cpu")
        jdec = JDec(jm[pool], params, max_batch=8, eos_id=2)
        jhub = jtp.ReceiverHub(jdec)
        for codec, link in cases:
            tag = f"{codec}/{link}/"
            for rid, p, n in requests(tag):
                tpf.submit(rid, p, num_new=n)
            mine = {r.rid: r for r in tpf.run()}
            with link_to(link, jhub, ttp, jtp) as tlink:
                rep = ttp.WireReplica(tlink, "w0", chunk_blocks=2,
                                      codec=codec)
                for r in mine.values():
                    rep.submit_handle(r.rid, r.handle, r.first_token,
                                      r.num_new, source=tpf, admit=False)
                _pump_all(rep)
            pairs = _adopted(jdec, {k: r.handle for k, r in mine.items()})
            tsrc = [t.numpy() for t in tpf.pool_leaves()]
            jdst = flat(jdec._split_cache()[0])
            err = _block_error(tsrc, jdst, pairs)
            ratio = (_block_bound_ratio(tsrc, jdst, pairs, codec)
                     if codec in wirecodec.QUANT_CODECS else None)
            out = _run_decode(jdec)
            w["t2j"][pool, codec, link] = dict(
                out={r[len(tag):]: t for r, t in out.items()
                     if r.startswith(tag)}, err=err, block_ratio=ratio,
                bound=wirecodec.error_bound(jdec.wire_quant_max_scale,
                                            codec),
                dec_clean=_leak_free(jdec.pool),
                source_clean=_leak_free(tpf.pool))
        w["layouts"][pool] = (jdec.wire_layout(), jpf.wire_layout())
        w["jpf"][pool], w["jdec"][pool] = jpf, jdec
    return w


@pytest.fixture(scope="module")
def world():
    return build_world(["native"])


NATIVE = [c for c in CASES if c[0] == "native"]


def test_monolithic_engines_agree_at_depth_12(world):
    assert world["want"]["native"] == world["jax_mono"]


def check_jax_to_torch(world, pool, codec, link):
    got = world["j2t"][pool, codec, link]
    if codec == "fp32":
        assert got["out"] == world["want"][pool]
        assert got["err"] == 0.0
    else:
        assert 0.0 < got["err"] <= got["bound"]
        assert 0.0 < got["block_ratio"] <= 1.0
        assert sorted(got["out"]) == sorted(world["want"][pool])
    assert got["dec_clean"]
    assert got["hub"]["streams_ok"] == 5 and got["hub"]["chunks"] > 0
    assert got["host_bytes"] == got["hub"]["bytes"] > 0
    assert world["j2t"][pool, "source_clean"]


def check_torch_to_jax(world, pool, codec, link):
    got = world["t2j"][pool, codec, link]
    if codec == "fp32":
        assert got["out"] == world["want"][pool]
        assert got["err"] == 0.0
    else:
        assert 0.0 < got["err"] <= got["bound"]
        assert 0.0 < got["block_ratio"] <= 1.0
        assert sorted(got["out"]) == sorted(world["want"][pool])
    assert got["dec_clean"] and got["source_clean"]


def check_layout_digest(world, pool):
    dec = DecodeEngine(world["tm"][pool], 2, device="cpu")
    pf = PrefillEngine(world["tm"][pool], device="cpu")
    jdec_layout, jpf_layout = world["layouts"][pool]
    assert dec.wire_layout() == pf.wire_layout() == jdec_layout == jpf_layout


@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("pool,codec", NATIVE)
def test_jax_prefill_to_torch_decode(world, pool, codec, link):
    check_jax_to_torch(world, pool, codec, link)


@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("pool,codec", NATIVE)
def test_torch_prefill_to_jax_decode(world, pool, codec, link):
    check_torch_to_jax(world, pool, codec, link)


def test_layout_digest_equal_across_packages(world):
    check_layout_digest(world, "native")


@pytest.mark.parametrize("codec", wirecodec.QUANT_CODECS)
def test_quantized_stream_decodes_bit_equal_in_both_packages(world, codec):
    """One JAX prefill's quantized stream, teed frame by frame into the
    port's DecodeEngine and the JAX package's: both receivers answer
    every frame alike and adopt bit-identical blocks (the scale and data
    segments, int4's nibble order and fp8's bytes read the same way)."""
    twin = world["j2t"]["native", codec, "loopback"]["twin"]
    assert twin["answers"] and all(a == b for a, b in twin["answers"])
    assert twin["rids"][0] == twin["rids"][1] and len(twin["rids"][0]) == 5
    assert twin["blocks"] > 0
    assert twin["bits_equal"]


def test_wire_order_is_jax_flatten_order(world):
    """The port's leaf order names the same (layer, leaf) as JAX's
    flatten path at every position, and is not layer order."""
    import jax

    from vtpu.models.transformer import _zero_cache

    from vtpu.models.transformer import TransformerLM as JaxLM

    jm = JaxLM(**KW, kv_pool_blocks=9, kv_cache_dtype="int8")
    pools = _zero_cache(jm, np.zeros((1, 1), np.int32))
    pools.pop("pos")
    pools.pop("block_table")
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(pools)[0]]
    layers = [{name: (i, name) for name in ("k_pool", "k_pool_scale",
                                            "v_pool", "v_pool_scale")}
              for i in range(KW["depth"])]
    port = [f"['h{i}']['attn']['{name}']" for i, name in
            wire_leaves(layers)]
    assert port == paths
    in_layer_order = [f"['h{i}']['attn']['{name}']"
                      for i in range(KW["depth"])
                      for name in sorted(layers[i])]
    assert port != in_layer_order
    tm = port_of(jm, world["params"])
    leaves = wire_leaves(tm.init_cache(1)["layers"])
    assert pool_layout(leaves) == [
        {"shape": [int(d) for d in x.shape[1:]], "dtype": str(x.dtype)}
        for x in jax.tree_util.tree_leaves(pools)]


def _torch_pair(world, pool="native", **dec_kw):
    tm = world["tm"][pool]
    return (PrefillEngine(tm, device="cpu"),
            DecodeEngine(tm, 4, eos_id=2, device="cpu", **dec_kw))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_mid_stream_death_releases_both_pools(world, direction):
    """A link that dies at every data chunk: the sender spends its resume
    budget, aborts, and both pools come back leak-free."""
    jtp = world["jtp"]
    if direction == "jax_to_torch":
        pf = world["jpf"]["native"]
        dec = DecodeEngine(world["tm"]["native"], 4, eos_id=2, device="cpu")
        hub, client, server = ttp.ReceiverHub(dec), jtp, ttp
    else:
        pf = PrefillEngine(world["tm"]["native"], device="cpu")
        dec = world["jdec"]["native"]
        hub, client, server = jtp.ReceiverHub(dec), ttp, jtp

    def fault(data):
        fr = server.decode_frame(data)
        if fr.kind == server.KIND_DATA and fr.seq >= 1:
            raise OSError("wire cut")

    rep = client.WireReplica(client.LoopbackLink(hub, fault=fault), "w0",
                             local=dec, chunk_blocks=1, retries=2)
    pf.submit("death", np.arange(9, dtype=np.int32) % 64, 4)
    res = pf.step()[0]
    with pytest.raises(client.StreamAbortedError):
        rep.submit_handle(res.rid, res.handle, res.first_token,
                          res.num_new, source=pf)
    assert _leak_free(pf.pool) and _leak_free(dec.pool)
    assert hub.open_streams() == 0
    assert "death" not in dec.out


@pytest.mark.parametrize("torn", ["first_chunk", "mid_stream",
                                  "every_frame"])
@pytest.mark.parametrize("abort_timing", ["stream_death",
                                          "receiver_abort"])
def test_speculative_rollback_fuzz_leak_free(world, torn, abort_timing):
    """tests/test_disagg.py's matrix on the port's engines and transport:
    every combination rolls the reservation back (token retracted, slot
    freed, both pools leak-free), and the engine serves on."""
    pf, dec = _torch_pair(world)
    hub = ttp.ReceiverHub(dec)

    def fault(data):
        fr = ttp.decode_frame(data)
        if fr.kind not in (ttp.KIND_DATA, ttp.KIND_DATA_QUANT) \
                or fr.seq == 0:
            return
        if torn == "first_chunk" and fr.seq == 1:
            raise OSError("torn")
        if torn == "mid_stream" and fr.seq == 2:
            raise OSError("torn")
        if torn == "every_frame":
            raise OSError("torn")

    rep = ttp.WireReplica(
        ttp.LoopbackLink(hub, fault=None if abort_timing
                         == "receiver_abort" else fault),
        "w0", local=dec, chunk_blocks=1, retries=2)
    pf.submit("rx", np.arange(20, dtype=np.int32) % 64, 4)
    res = pf.step()[0]
    try:
        rep.submit_handle(res.rid, res.handle, res.first_token,
                          res.num_new, source=pf, admit=False)
        assert dec.out["rx"] == [res.first_token]  # published at OPEN
        if abort_timing == "receiver_abort":
            hub.abort_all()
        _pump_all(rep)
    except ttp.WireError:
        pass
    _run_decode(dec)
    assert "rx" not in dec.out
    assert not dec._spec_slots
    assert dec.pool.stats()["spec_rollbacks"] == 1
    assert _leak_free(pf.pool) and _leak_free(dec.pool)
    pf.submit("ry", np.arange(9, dtype=np.int32) % 64, 3)
    res2 = pf.step()[0]
    dec.submit_handle("ry", res2.handle, res2.first_token, res2.num_new,
                      source=pf)
    assert len(_run_decode(dec)["ry"]) == 3
    assert _leak_free(pf.pool) and _leak_free(dec.pool)


def test_speculative_first_token_before_fin(world):
    pf, dec = _torch_pair(world)
    hub = ttp.ReceiverHub(dec)
    rep = ttp.WireReplica(ttp.LoopbackLink(hub), "w0", local=dec,
                          chunk_blocks=1)
    pf.submit("s0", np.arange(17, dtype=np.int32) % 64, 5)
    res = pf.step()[0]
    rep.submit_handle(res.rid, res.handle, res.first_token, res.num_new,
                      source=pf, admit=False)
    (slot,) = dec._spec_slots
    assert dec.out["s0"] == [res.first_token]
    # the reserved slot is inactive and its row stays on the garbage
    # block until FIN: decode windows cannot write the blocks in flight
    assert not dec.active[slot]
    assert int(dec.cache["block_table"][slot].abs().sum()) == 0
    _pump_all(rep)
    assert not dec._spec_slots and dec.active[slot]
    assert dec.pool.stats()["spec_adoptions"] == 1
    assert len(_run_decode(dec)["s0"]) == 5
    assert _leak_free(pf.pool) and _leak_free(dec.pool)


@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_typed_refusals_by_name_across_packages(world, direction, link):
    """A layout mismatch (an int8 pool's layout into a native pool) and a
    reused stamp are refused with PoolMismatchError and StaleHandleError:
    in process the receiver's own class, over HTTP the sender package's
    class of the same name.  Nothing is leased on either side."""
    jtp = world["jtp"]
    if direction == "jax_to_torch":
        pf = world["jpf"]["native"]
        hub = ttp.ReceiverHub(DecodeEngine(world["tm"]["native"], 2,
                                           device="cpu"))
        client, server = jtp, ttp
    else:
        pf = PrefillEngine(world["tm"]["native"], device="cpu")
        hub = jtp.ReceiverHub(world["jdec"]["native"])
        client, server = ttp, jtp
    int8_layout = pool_layout(wire_leaves(port_of(
        world["jm"]["native"], world["params"], kv_cache_dtype="int8"
    ).init_cache(1)["layers"]))
    assert int8_layout != pf.wire_layout()
    receiver = server if link == "loopback" else client
    pf.submit(f"refuse/{direction}/{link}", np.arange(9, dtype=np.int32), 2)
    (res,) = pf.step()
    with link_to(link, hub, client, server) as lk:
        with pytest.raises(Exception) as ei:
            client.StreamSender(lk, "a", res.handle,
                                layout=int8_layout).open()
        assert type(ei.value).__name__ == "PoolMismatchError"
        assert isinstance(ei.value, receiver.PoolMismatchError)
        client.StreamSender(lk, "b", res.handle,
                            layout=pf.wire_layout()).open()
        with pytest.raises(Exception) as ei:
            client.StreamSender(lk, "b2", res.handle,
                                layout=pf.wire_layout()).open()
        assert type(ei.value).__name__ == "StaleHandleError"
        assert isinstance(ei.value, receiver.StaleHandleError)
        hub.abort_all()
    assert hub.open_streams() == 0
    assert _leak_free(hub.sink.pool)
    pf.pool.release_handle(res.handle)
    assert _leak_free(pf.pool)
