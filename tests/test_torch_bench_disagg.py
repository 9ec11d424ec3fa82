"""The port's disaggregation bench (vtpu_torch/bench/serving_disagg.py) on
the CPU: ``--smoke`` in both modes writes a schema-complete artifact with
the JAX bench's keys and passes the bench's own rules (token exactness,
zero host bytes on the adopt path, five ledger stages summing to the
TTFT within 5 %); the virtual-clock simulation gives exactly the JAX
bench's arms on the same measured units.  The times it prints mean
something only on the card."""

import json

import pytest

from benchmarks import serving_disagg as jbench
from vtpu_torch.bench import serving_disagg as tbench

HEADLINE_KEYS = {
    "tokens_per_s_x_disagg_4", "mono_itl_p50_ms",
    "disagg_4_burst_itl_p99_ms", "burst_p99_within_mono_p50",
    "wire_hidden_fraction", "wire_bytes", "int8_wire_byte_reduction_x",
    "int8_hidden_fraction", "int8_token_match_fraction",
    "int8_quant_error_bound", "prefix_hits", "prefix_tokens_skipped",
    "ftl_ms_baseline_fp32_nospec", "ftl_ms_speculative_fp32",
    "dyn_mean_prefill_devices", "trace_off_tokens_per_s",
    "trace_on_tokens_per_s", "trace_overhead_x",
    "trace_stage_sum_max_rel_err",
}


def test_smoke_artifact_is_schema_complete(tmp_path):
    """tests/test_disagg.py's assertions on the JAX artifact, on the
    port's, plus the keys of every phase."""
    out = tmp_path / "serving_disagg_torch.json"
    rc = tbench.main(["--smoke", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["platform"] == "cpu" and res["device"] == "cpu"
    assert res["verdict"] == {"ok": True, "failures": []}
    for key in ("exactness", "wire", "wire_int8", "shared_prefix", "trace",
                "units", "arms", "headline", "config", "timebase"):
        assert key in res, key
    assert res["exactness"]["token_exact"] is True
    assert res["exactness"]["handoff_host_bytes"] == 0
    assert res["exactness"]["handoffs"] > 0
    assert res["exactness"]["pools_leak_free"] is True
    arms = res["arms"]
    assert set(arms) == {"monolithic", "disagg_1", "disagg_2", "disagg_4",
                         "disagg_dyn"}
    for arm in arms.values():
        assert arm["tokens_per_s"] > 0
        assert arm["decode_itl_p99_ms"] >= arm["decode_itl_p50_ms"] >= 0
    assert res["headline"]["tokens_per_s_x_disagg_4"] > 0
    assert set(res["headline"]) == HEADLINE_KEYS
    assert res["wire"]["token_exact"] is True
    assert res["wire"]["death_fuzz"]["leak_free_all"] is True
    assert res["wire_int8"]["host_bytes_accounted"] is True
    assert res["shared_prefix"]["arms"]["fp32"]["prefix_hits"] >= 1
    attr = res["trace"]["attribution"]
    assert res["trace"]["arms"]["tracing_off"]["spans_recorded"] == 0
    assert attr["requests_attributed"] > 0
    assert attr["stage_sum_max_rel_err"] <= 0.05
    assert set(res["units"]) == {
        "decode_window_s", "prefill_1x16_s", "prefill_1x64_s",
        "prefill_8x16_s", "prefill_8x64_s", "adopt_1_s", "adopt_8_s"}


def test_kv_smoke_artifact_is_schema_complete(tmp_path):
    """tests/test_kvspill.py's assertions on the JAX --kv artifact."""
    out = tmp_path / "serving_kv_torch.json"
    rc = tbench.main(["--kv", "--smoke", "--device", "cpu",
                      "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["verdict"] == {"ok": True, "failures": []}
    assert set(res["codec_curve"]) == set(jbench.KV_CODECS)
    assert res["codec_curve"]["fp32"]["token_exact"] is True
    assert res["headline"]["int4_wire_byte_reduction_x"] >= 6.0
    assert res["spill"]["overcommit"] is True
    assert res["spill"]["demotions"] >= 1
    assert res["spill"]["onloads"] >= 1
    assert res["restart"]["rehydrated_onloads"] >= 1
    assert res["restart"]["token_exact_cold"] is True
    assert res["torn_journal"]["ok"] is True


@pytest.mark.parametrize("overload,burst", [(2.5, 6), (0.8, 24)])
def test_simulation_matches_the_jax_bench(overload, burst):
    """The virtual-clock arms are plain arithmetic over the units: on the
    same units both benches give the same workload and the same arms."""
    units = {"decode_window_s": 0.0031, "prefill_1x16_s": 0.0012,
             "prefill_1x64_s": 0.0031, "prefill_8x16_s": 0.0042,
             "prefill_8x64_s": 0.0121, "adopt_1_s": 0.0004,
             "adopt_8_s": 0.0011}
    want_reqs, want_bursts = jbench.gen_workload(3.0, units, overload,
                                                 1.0, burst)
    got_reqs, got_bursts = tbench.gen_workload(3.0, units, overload,
                                               1.0, burst)
    assert (got_reqs, got_bursts) == (want_reqs, want_bursts)
    for n, dyn in ((0, 0), (1, 0), (2, 0), (4, 0), (4, 4)):
        assert (tbench.sim_arm(got_reqs, got_bursts, units, n, dyn)
                == jbench.sim_arm(want_reqs, want_bursts, units, n, dyn))
    assert tbench.prefill_unit(units, 3, 64) == jbench.prefill_unit(
        units, 3, 64)
    assert tbench.adopt_unit(units, 2) == jbench.adopt_unit(units, 2)
