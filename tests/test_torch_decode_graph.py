"""The decode window as one captured CUDA graph (``PagedBatcher`` on the
card, ``decode_graph="auto"``).

A graph reads and writes the storage it was captured with, so the
engine's slot state must only ever be written in place.  The CPU test
checks that across windows, admissions (batched, chunked, with shared
prefixes) and retirements ``engine.tok``, the cache's ``pos`` and
``block_table`` and every pool stay the same tensors at the same
addresses.  The ``cuda``-marked tests hold graphed windows against eager
ones (``decode_graph="off"``) token for token, and run a replay and the
captured window's code under ``torch.cuda.set_sync_debug_mode("error")``
(``python -m pytest tests/test_torch_decode_graph.py -m cuda
--noconftest``).
"""

import numpy as np
import pytest
import torch

from vtpu_torch.models.transformer import TransformerLM
from vtpu_torch.serving.paged import PagedBatcher

KW = dict(vocab=64, d_model=64, depth=2, num_heads=4, num_kv_heads=2,
          max_seq=64, pos_embedding="rope", kv_cache_layout="paged",
          kv_block_size=8, kv_pool_blocks=33)


def _requests(seed: int, n: int = 7):
    """Prompts that share a two-block prefix (the prefix cache maps it)
    and long ones that a chunked prefill takes in several chunks."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 64, 16).astype(np.int32)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, 64, int(rng.integers(2, 20))).astype(np.int32)
        prompt = np.concatenate([prefix, tail]) if i % 2 else tail
        reqs.append((f"r{i}", prompt, int(rng.integers(3, 10))))
    return reqs


def _state(eng):
    tensors = {"tok": eng.tok, "pos": eng.cache["pos"],
               "block_table": eng.cache["block_table"]}
    for i, layer in enumerate(eng.cache["layers"]):
        tensors.update({f"{i}.{n}": t for n, t in layer.items()})
    return {n: (t, t.data_ptr()) for n, t in tensors.items()}


def _serve(eng, reqs, between: int = 1, probe=None):
    for rid, prompt, n in reqs:
        eng.submit(rid, prompt, num_new=n)
        for _ in range(between):
            eng.step()
            if probe:
                probe()
    while (any(eng.active) or eng.queue or eng.prefilling
           or eng._inflight):
        eng.step()
        if probe:
            probe()
    return eng.run()


@pytest.mark.parametrize("cache", ["native", "int8"])
def test_slot_state_keeps_its_tensors(cache):
    model = TransformerLM(**KW, kv_cache_dtype=cache, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    eng = PagedBatcher(model, max_batch=3, harvest_every=4,
                       pipeline_depth=2, prefill_chunk=8, prefix_cache=2,
                       device="cpu")
    before = _state(eng)
    seen = {"retired": 0, "admitted": 0}

    def probe():
        now = _state(eng)
        assert now.keys() == before.keys()
        for n, (t, ptr) in before.items():
            assert now[n][0] is t and now[n][1] == ptr, n
        seen["admitted"] = max(seen["admitted"], len(eng.out))
        seen["retired"] = max(seen["retired"],
                              len(eng.out) - sum(eng.active))

    reqs = _requests(3)
    out = _serve(eng, reqs, probe=probe)
    probe()
    assert all(len(out[rid]) == n for rid, _p, n in reqs)
    # every slot was re-tenanted: 7 requests through 3 slots
    assert seen["admitted"] == len(reqs) and seen["retired"] == len(reqs)
    # only the registered prefixes still hold blocks
    held = {b for blocks in eng._prefixes.values() for b in blocks}
    assert held and eng.pool_stats()["leased"] == len(held)
    assert eng.stats()["decode_graphs"] == []  # the CPU window is eager


def test_decode_graph_knob_is_checked():
    model = TransformerLM(**KW, device="cpu")
    with pytest.raises(ValueError, match="decode_graph"):
        PagedBatcher(model, max_batch=2, decode_graph="on", device="cpu")


# -- on the card -----------------------------------------------------------
@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++)")
    from vtpu_torch.device import reference_numerics

    reference_numerics()
    return torch.device("cuda")


def _card_model(cache):
    gen = torch.Generator(device="cuda").manual_seed(0)
    return TransformerLM(**KW, kv_cache_dtype=cache, device="cuda",
                         generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["native", "int8"])
@pytest.mark.parametrize("harvest,depth", [(1, 0), (1, 1), (4, 1), (4, 2),
                                           (4, 0)])
def test_graphed_windows_match_eager_on_the_card(cuda_card, cache, harvest,
                                                 depth):
    """Prefix cache and chunked prefill on, 7 requests through 3 slots
    (every slot re-tenanted between windows): the graphed engine's tokens
    equal the eager engine's, and its windows were replays."""
    from vtpu_torch.ops.paged_attention import paged_attention_decode

    model = _card_model(cache)
    reqs = _requests(5)
    kw = dict(max_batch=3, harvest_every=harvest, pipeline_depth=depth,
              prefill_chunk=8, prefix_cache=2, device="cuda")
    eager = _serve(PagedBatcher(model, decode_graph="off", **kw), reqs)
    graphed_eng = PagedBatcher(model, **kw)
    key = "int8" if cache == "int8" else "native"
    n0 = paged_attention_decode.launches[key]
    graphed = _serve(graphed_eng, reqs)
    assert graphed == eager
    ks = graphed_eng.stats()["decode_graphs"]
    assert ks and set(ks) <= {1, 2, 4}
    # replays count their launches: one per layer and decode step
    assert (paged_attention_decode.launches[key] - n0
            == KW["depth"] * graphed_eng.steps)


@pytest.mark.cuda
def test_replay_and_window_do_not_sync_on_the_card(cuda_card):
    """The window's code (what the graph holds) and its replay under
    ``set_sync_debug_mode("error")``: neither synchronizes the host."""
    model = _card_model("int8")
    eng = PagedBatcher(model, max_batch=2, harvest_every=2, device="cuda")
    for rid, prompt, n in _requests(9, n=2):
        eng.submit(rid, prompt, num_new=n)
    eng.step()  # the first window of length 2: eager, then captured
    assert eng.stats()["decode_graphs"] == [2]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._step_k(2)
        eng._run_window(eng._tokens_buffer(2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
