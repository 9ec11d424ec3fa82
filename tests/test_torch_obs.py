"""The port's observability layer against the JAX package's, on the CPU.

- the registries (vtpu_torch/obs/registry.py): one sequence of
  inc/set/observe renders byte-equal Prometheus text in both packages;
- the journals (vtpu_torch/obs/events.py): ``emit`` gives the same
  records up to the timestamp;
- the spans (vtpu_torch/utils/trace.py): the same span trees, timeline
  and Chrome export, up to ids, times and process tokens;
- the ledgers (vtpu_torch/serving/reqtrace.py): with an injected clock
  the same marks give the same records, and the five telescope stages
  sum exactly to the TTFT;
- the port's engines: tracing off records no span and no ledger record;
  tracing on, every request behind the port's Router has a record whose
  stages sum to its TTFT and a span tree under its ``request`` span;
- a topology that mixes the packages (a JAX prefill streaming into a
  torch decode engine) gives partial records, not wrong ones;
- the shim runtime's two histograms observe every check and every sleep.

Both packages' switches, rings and ledgers live in one process here, so
every test sets and clears both (fixture ``both_traced``).
"""

import importlib
import json
import types

import numpy as np
import pytest

import vtpu.obs.events as jevents
import vtpu.serving.reqtrace as jreqtrace
import vtpu.utils.trace as jtrace
import vtpu_torch.obs.events as tevents
import vtpu_torch.serving.reqtrace as treqtrace
import vtpu_torch.utils.trace as ttrace

# the packages' obs/__init__ export a function named ``registry``, which
# shadows the module of that name as an attribute
jregistry = importlib.import_module("vtpu.obs.registry")
tregistry = importlib.import_module("vtpu_torch.obs.registry")

PKGS = {
    "jax": types.SimpleNamespace(trace=jtrace, registry=jregistry,
                                 events=jevents, reqtrace=jreqtrace),
    "torch": types.SimpleNamespace(trace=ttrace, registry=tregistry,
                                   events=tevents, reqtrace=treqtrace),
}


@pytest.fixture
def both_traced():
    """Tracing on in both packages, empty rings and ledgers; afterwards
    both switches go back to what they were and both are emptied."""
    was = {n: p.trace.tracing() for n, p in PKGS.items()}
    for p in PKGS.values():
        p.trace.tracing(True)
        p.trace.clear()
        p.reqtrace.LEDGER.clear()
    yield
    for n, p in PKGS.items():
        p.trace.tracing(was[n])
        p.trace.clear()
        p.reqtrace.LEDGER.clear()


def _drive_registry(mod) -> str:
    reg = mod.Registry("parity")
    c = reg.counter("vtpu_parity_events_total", 'Events "quoted" \\ help')
    g = reg.gauge("vtpu_parity_depth_ratio", "A gauge")
    h = reg.histogram("vtpu_parity_wait_seconds", "A histogram")
    h2 = reg.histogram("vtpu_parity_size_bytes", "Custom buckets",
                       buckets=(1, 10, 100))
    rng = np.random.default_rng(11)
    for i in range(200):
        c.inc(kind=f"k{i % 3}")
        c.inc(2.5)
        g.set(float(i) / 7, replica=f"d{i % 4}")
        g.add(0.5, replica="d0")
        h.observe(float(rng.exponential(0.01)), stage=f"s{i % 2}")
        h.observe(float(rng.exponential(0.5)))
        h2.observe(float(rng.integers(0, 200)), pool='p"\n1')
    c.remove(kind="k2")
    g.remove(replica="d3")
    lines = []
    mod.render_family(lines, "vtpu_legacy_total", "Legacy", "counter",
                      [({}, 3), ({"a": "x\\y"}, 4)])
    assert mod.escape_label('a"b\\c\nd') == 'a\\"b\\\\c\\nd'
    return reg.render() + "\n".join(lines) + json.dumps(
        [h.snapshot(stage="s0"), h.series_snapshot(), c.samples(),
         g.samples(), reg.names()], sort_keys=True)


def test_registries_render_byte_equal_text():
    assert _drive_registry(tregistry) == _drive_registry(jregistry)
    assert tregistry.LATENCY_BUCKETS == jregistry.LATENCY_BUCKETS
    reg = tregistry.Registry("x")
    reg.counter("vtpu_a_total", "h")
    with pytest.raises(TypeError):
        reg.gauge("vtpu_a_total", "h")


def test_lint_names_flags_the_same_problems():
    out = {}
    for name, p in PKGS.items():
        reg = p.registry.registry(f"lint-parity-{name}")
        reg.counter("bad_counter", "no prefix, no _total")
        reg.gauge("vtpu_no_unit", "no unit")
        out[name] = sorted(x.split(": ", 1)[1] for x in
                           p.registry.lint_names()
                           if x.startswith(f"lint-parity-{name}: "))
        with p.registry._registries_lock:
            del p.registry._registries[f"lint-parity-{name}"]
    assert out["torch"] == out["jax"] and len(out["jax"]) == 3


def test_event_journals_emit_the_same_records(tmp_path):
    out = {}
    for name, p in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        j = p.events.EventJournal(cap=4, jsonl_path=str(path),
                                  wallclock=lambda: 1234.5)
        types_ = [p.events.EventType.REPLICA_DRAINED,
                  p.events.EventType.REPLICA_RESTORED,
                  p.events.EventType.SESSION_MIGRATED,
                  p.events.EventType.POD_BOUND,
                  p.events.EventType.EVICT_MIGRATED,
                  p.events.EventType.SESSION_MIGRATION_FAILED]
        for i, t in enumerate(types_):
            j.emit(t, "router", pod=f"uid{i}" if i % 2 else "",
                   node=f"d{i}", n=i)
        with pytest.raises(ValueError):
            j.emit("NotAType", "router")
        j.close()
        out[name] = {
            "ring": j.snapshot(),
            "query": j.query(type=p.events.EventType.POD_BOUND),
            "body": json.loads(j.events_body({"n": "2"})),
            "file": [json.loads(x) for x in path.read_text().splitlines()],
            "chrome": [{k: v for k, v in e.items() if k != "pid"}
                       for e in j.chrome_events()],
        }
    assert out["torch"] == out["jax"]
    assert (tevents.EVENT_TYPES == jevents.EVENT_TYPES
            and "ReplicaDrained" in tevents.EVENT_TYPES)


def _span_shape(spans):
    """Spans with ids, times and process identity replaced by their
    order of appearance, so two packages' trees compare."""
    ids = {}
    keep = []
    for sp in spans:
        ids.setdefault(sp["span_id"], len(ids))
    for sp in spans:
        d = {k: v for k, v in sp.items()
             if k not in ("start", "dur_ms", "proc", "pid", "tid",
                          "span_id", "parent", "trace_id", "ctx")}
        d["id"] = ids[sp["span_id"]]
        d["parent"] = ids.get(sp.get("parent"), sp.get("parent"))
        d["trace"] = sp.get("trace_id")
        keep.append(d)
    return keep


def _drive_spans(tr):
    with tr.span("filter", trace_id="pod-1", nodes=3) as sp:
        sp["picked"] = "n1"
        with tr.span("score", k=1):
            pass
        ctx = tr.current_context()
    root = tr.start_span("request", trace_id="rid-1", rid="rid-1")
    child = tr.start_span("prefill", ctx=tr.context_of(root), rid="rid-1")
    with tr.span("kv_wire_recv", ctx=tr.context_of(child)):
        pass
    tr.end_span(child)
    tr.end_span(child)  # a double close is a no-op
    with pytest.raises(RuntimeError):
        with tr.span("failing", ctx=ctx):
            raise RuntimeError("boom")
    tr.end_span(root, ok=False, error="cancelled")
    tr.end_span({})
    assert tr.parse_context("t:7") == ("t", 7)
    assert tr.parse_context("t:x") == ("t", None)
    return {
        "recent": _span_shape(tr.recent_spans(100)),
        "timeline": [s["name"] for s in tr.timeline("rid-1")],
        "pod": [s["name"] for s in tr.timeline("pod-1")],
        "chrome": [{k: v for k, v in e.items()
                    if k not in ("ts", "dur", "pid", "tid", "args")}
                   for e in json.loads(tr.export_chrome())["traceEvents"]],
    }


def test_span_trees_timeline_and_chrome_export_match(both_traced):
    got = _drive_spans(ttrace)
    want = _drive_spans(jtrace)
    assert got == want
    assert got["timeline"] == ["request", "prefill", "kv_wire_recv"]
    # ingest dedups on (proc, span_id) in both
    for tr in (ttrace, jtrace):
        dump = tr.recent_spans(100)
        assert tr.ingest(dump) == 0
        assert tr.ingest([{**dump[0], "proc": "other"}]) == 1


def test_tracing_off_spans_are_empty(both_traced):
    for tr in (ttrace, jtrace):
        tr.tracing(False)
        assert tr.start_span("x") == {}
        with tr.span("y") as sp:
            assert sp == {}
        assert tr.recent_spans() == []


def _drive_ledger(mod, monkeypatch):
    t = {"now": 1000.0}
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        perf_counter=lambda: t["now"], time=lambda: 5.0))
    led = mod.RequestLedger(cap=16)
    docs = []
    # a full telescope, every stage non-zero
    led.admit("a", "acme/s1", prompt_tokens=12)
    for mark, dt in (("prefill_start", 0.25), ("prefill_done", 1.5),
                     ("handoff_done", 0.125), ("adopted", 0.5)):
        t["now"] += dt
        led.mark("a", mark)
    t["now"] += 0.75
    led.first_token("a")
    for dt in (0.5, 0.25):
        t["now"] += dt
        led.token("a")
    led.pause("a", "migration_pause", 0.375)
    led.finish("a")
    # marks skipped (an in-process handoff) and a mark after the first
    # token (a speculative publish before the FIN): clamped
    led.ensure("b")
    t["now"] += 1.0
    led.mark("b", "prefill_start")
    t["now"] += 2.0
    led.first_token("b", t=t["now"])
    t["now"] += 1.0
    led.mark("b", "handoff_done")
    led.mark("b", "prefill_start", t=0.0)  # first write wins
    led.finish("b", ok=False, error="cancelled")
    led.mark("gone", "adopted")           # unknown rids are no-ops
    led.finish("gone")
    def shape(doc):
        # span ids are process-wide counters: keep the context's form
        tid, _, sid = doc["trace"].partition(":")
        return dict(doc, trace=(tid, sid.isdigit()))

    docs = [shape(led.get("a")), shape(led.get("b"))]
    return docs, led.stats(), [shape(d) for d in json.loads(
        json.dumps(led.recent(5), default=str))]


def test_ledgers_give_the_same_records_and_exact_stage_sums(
        both_traced, monkeypatch):
    got = _drive_ledger(treqtrace, monkeypatch)
    want = _drive_ledger(jreqtrace, monkeypatch)
    assert got == want
    docs = got[0]
    for doc in docs:
        ssum = sum(doc["stages"][s] for s in treqtrace.STAGES[:5])
        assert ssum == doc["ttft_s"]  # exact: dyadic clock steps
    assert docs[0]["ttft_s"] == 3.125
    assert docs[0]["stages"]["migration_pause"] == 0.375
    assert docs[0]["itl_n"] == 2 and docs[0]["tokens_out"] == 3
    # the late handoff mark clamps to the first token; the missing
    # prefill_done collapses its stage to zero width
    st = docs[1]["stages"]
    assert (st["router_queue"], st["prefill_compute"], st["wire_transfer"],
            st["adoption"], st["decode_window"]) == (1.0, 0.0, 2.0, 0.0, 0.0)
    assert docs[1]["error"] == "cancelled"
    assert treqtrace.STAGES == jreqtrace.STAGES


def test_ledger_is_a_no_op_while_tracing_is_off(both_traced):
    ttrace.tracing(False)
    led = treqtrace.RequestLedger(cap=16)
    assert led.admit("a", "s") is None
    led.ensure("b")
    led.mark("a", "prefill_start")
    led.first_token("a")
    led.finish("a")
    assert led.stats() == {"active": 0, "completed": 0, "dropped": 0}
    body = json.loads(treqtrace.requests_body({"rid": "a"}))
    assert body == {"rid": "a", "found": False}


# ---------------------------------------------------------------------------
# the port's engines
# ---------------------------------------------------------------------------

KW = dict(vocab=64, d_model=32, depth=2, num_heads=4, max_seq=32)


def _torch_model():
    from vtpu_torch.models.transformer import TransformerLM

    return TransformerLM(**KW, kv_cache_layout="paged", kv_block_size=8,
                         kv_pool_blocks=33, device="cpu")


def _requests(n=6):
    rng = np.random.default_rng(9)
    lens = [3, 9, 12, 5, 17, 8]
    return [(f"q{i}", rng.integers(0, 64, lens[i % 6]).astype(np.int32),
             2 + i % 4) for i in range(n)]


def _routed(model, wire=False):
    from vtpu_torch.serving import transport as tp
    from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
    from vtpu_torch.serving.router import Router

    decs = {f"d{i}": DecodeEngine(model, 4, eos_id=2, device="cpu",
                                  replica_id=f"d{i}") for i in range(2)}
    reps = dict(decs)
    if wire:
        reps["d1"] = tp.WireReplica(tp.LoopbackLink(tp.ReceiverHub(
            decs["d1"])), "d1", local=decs["d1"], chunk_blocks=1)
    router = Router(PrefillEngine(model, device="cpu"), reps)
    for i, (rid, p, n) in enumerate(_requests()):
        router.submit(f"sess{i % 3}", rid, p, n)
    return router.drain()


def test_tracing_off_records_nothing_on_the_engines(both_traced):
    from vtpu_torch.serving.paged import PagedBatcher

    ttrace.tracing(False)
    model = _torch_model()
    got = _routed(model, wire=True)
    mono = PagedBatcher(model, 4, eos_id=2, device="cpu")
    for rid, p, n in _requests():
        mono.submit(rid, p, n)
    assert mono.run() == got
    assert ttrace.recent_spans(2048) == []
    assert treqtrace.LEDGER.stats() == {"active": 0, "completed": 0,
                                        "dropped": 0}
    assert jtrace.recent_spans(2048) == []  # the other package untouched


def test_tracing_on_attributes_every_request(both_traced):
    """Every request routed through the port's Router (two replicas, one
    behind the loopback wire) retires with a record whose five stages sum
    to its TTFT, and owns a span tree rooted at its request span."""
    model = _torch_model()
    got = _routed(model, wire=True)
    assert set(got) == {rid for rid, _p, _n in _requests()}
    names = {}
    for sp in ttrace.recent_spans(2048):
        names.setdefault(sp.get("trace_id"), set()).add(sp["name"])
    for rid, _p, n in _requests():
        doc = treqtrace.LEDGER.get(rid)
        assert doc is not None and doc["done"] and doc["ok"], rid
        assert doc["ttft_s"] > 0
        ssum = sum(doc["stages"][s] for s in treqtrace.STAGES[:5])
        assert abs(ssum - doc["ttft_s"]) <= 1e-6 * doc["ttft_s"] + 1e-9
        assert doc["tokens_out"] == len(got[rid])
        assert {"request", "prefill"} <= names[rid]
    wired = [rid for rid in names if "kv_wire_stream" in names[rid]]
    assert wired and all("kv_wire_recv" in names[r] for r in wired)
    assert any(sp["name"] == "decode_window"
               for sp in ttrace.recent_spans(2048))
    assert jtrace.recent_spans(2048) == []
    assert jreqtrace.LEDGER.stats()["completed"] == 0


def test_cross_package_wire_gives_partial_records(both_traced):
    """A JAX prefill streaming into a torch decode engine: the JAX
    ledger holds the sender's marks up to the handoff, the port's holds
    nothing (its engine marks only records its own Router or engines
    opened), and no record carries a wrong stage."""
    from torch_parity import jax_params, port_of
    from vtpu.models.transformer import TransformerLM as JaxLM
    from vtpu.serving import transport as jtp
    from vtpu.serving.disagg import PrefillEngine as JPf
    from vtpu_torch.serving import transport as ttp
    from vtpu_torch.serving.disagg import DecodeEngine

    jm = JaxLM(**KW, kv_cache_layout="paged", kv_block_size=8,
               kv_pool_blocks=33)
    params = jax_params(jm)
    dec = DecodeEngine(port_of(jm, params), 4, eos_id=2, device="cpu")
    pf = JPf(jm, params)
    rep = jtp.WireReplica(jtp.LoopbackLink(ttp.ReceiverHub(dec)), "x0",
                          local=dec, chunk_blocks=2)
    for rid, p, n in _requests(3):
        pf.submit(rid, p, num_new=n)
    for res in pf.run():
        rep.submit_handle(res.rid, res.handle, res.first_token,
                          res.num_new, source=pf, submitted=res.submitted,
                          admit=False)
    while rep.idle_senders():
        rep.step()
    while any(dec.active) or dec.queue or dec._inflight:
        dec.step()
    for rid, _p, n in _requests(3):
        assert len(dec.out[rid]) == n
        doc = jreqtrace.LEDGER.get(rid)
        assert doc is not None and doc["ttft_s"] is None
        st = doc["stages"]
        assert st["prefill_compute"] > 0 and st["wire_transfer"] > 0
        assert st["adoption"] == 0 and st["decode_window"] == 0
        assert all(v >= 0 for v in st.values())
        assert treqtrace.LEDGER.get(rid) is None
    assert treqtrace.LEDGER.stats()["active"] == 0
    # the receiver's span lives in the port's ring, under the JAX
    # sender's trace id (the context crosses in the OPEN meta)
    recv = [s for s in ttrace.recent_spans(100)
            if s["name"] == "kv_wire_recv"]
    assert {s["trace_id"] for s in recv} == {r for r, *_ in _requests(3)}


def test_shim_histograms_observe_checks_and_sleeps(tmp_path):
    from vtpu_torch.shim import runtime as rt

    class FakeClock:
        def __init__(self):
            self.t = 0.0
            self.slept = []

        def monotonic(self):
            return self.t

        def sleep(self, s):
            self.slept.append(s)
            self.t += s

    q0 = rt._QUOTA_HIST.snapshot() or {"count": 0}
    p0 = rt._PACE_HIST.snapshot() or {"count": 0}
    clock = FakeClock()
    shim = rt.ShimRuntime(limits_bytes=[1 << 20], core_limit=50,
                          region_path=str(tmp_path / "r" / "vtpu.cache"),
                          device="cpu", clock=clock)
    for _ in range(3):
        shim.try_alloc(1 << 10)
    with pytest.raises(MemoryError):
        shim.try_alloc(1 << 21)
    assert rt._QUOTA_HIST.snapshot()["count"] - q0["count"] == 4

    def step():
        clock.t += 0.01
        return 1

    for _ in range(12):
        shim.dispatch(step)
    wrapped = shim.throttled(step)
    wrapped()
    wrapped()
    slept = len(clock.slept)
    assert slept >= 2
    assert rt._PACE_HIST.snapshot()["count"] - p0["count"] == slept
    assert rt._SHIM_REG.names() == ["vtpu_shim_pace_sleep_seconds",
                                    "vtpu_shim_quota_check_seconds"]
    shim.close()


def test_shim_init_span_joins_the_pod_trace(tmp_path, monkeypatch,
                                            both_traced):
    from vtpu_torch.shim import runtime as rt

    monkeypatch.setenv("VTPU_TRACE_CONTEXT", "pod-uid-7:42")
    shim = rt.ShimRuntime(limits_bytes=[1 << 20],
                          region_path=str(tmp_path / "vtpu.cache"),
                          device="cpu")
    shim.close()
    (sp,) = ttrace.recent_spans(10, name="shim.init")
    assert sp["trace_id"] == "pod-uid-7" and sp["parent"] == 42
    assert sp["ok"] is True
