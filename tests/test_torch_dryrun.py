"""``vtpu_torch.entry.dryrun_multichip`` on the CPU: every program of the
port's parallel layer over a gloo world of 4 ranks, then the two-host
form (two launcher processes of 2 ranks, dcn x tp), with the JAX
dryrun's asserts (losses fall over three steps with a checkpoint round
trip after the second; ring, sp x tp ring and Ulysses numerics; the
hybrid psum; pipeline, MoE and pp x ep shapes; a finite tp LM loss)."""

import numpy as np

from vtpu_torch.entry import dryrun_multichip


def test_dryrun_multichip_over_four_ranks_and_two_hosts():
    s = dryrun_multichip(4, device="cpu", timeout_s=300)
    assert s["mesh"] == {"dp": 2, "tp": 2}
    assert s["losses"][-1] < s["losses"][0]
    assert s["ring"] == [2, 2, 8, 64] and s["ring_sptp"] == [2, 1, 8, 64]
    assert s["ulysses"] == [2, 4, 8, 64]
    assert s["pipeline"] == [8, 4, 16] and s["moe"] == [4, 16]
    assert s["pp_ep"] == [4, 4, 16]
    assert np.isfinite(s["lm_loss"])
    assert len(s["two_host"]) == 4
    for losses in s["two_host"]:
        assert losses[-1] < losses[0]
