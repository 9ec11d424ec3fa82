"""The port's twins of ``__graft_entry__``'s entry points, for PyTorch.

``entry()`` returns ``(forward, example_args)``: an inference step on
the flagship model (ResNet-V2-50, the ai-benchmark headline row, seeded
random weights) and its example input, NHWC f32 images at batch 8,
224^2.  ``forward(images)`` returns the f32 logits ``[8, 1000]``.

``dryrun_multichip(n, device=...)`` runs every program of the parallel
layer over a world of ``n`` ranks (``vtpu_torch.parallel.distributed.
spawn_world``; NCCL on the card, gloo on the CPU), with the reference
dryrun's asserts: a dp x tp ResNet-V2 train step whose loss falls over
three steps, with a checkpoint round trip after the second; ring
attention on an sp mesh and on an sp x tp mesh; Ulysses; a psum over a
hybrid dcn x tp mesh; a pipeline; the expert-parallel MoE FFN; a
pipeline whose stages are expert ensembles (pp x ep); a dp x fsdp x tp
matmul on 8 ranks; and a tp-sharded ``TransformerLM`` gradient step.
For ``n`` >= 4 and even it then runs the two-host form: two launcher
processes of n / 2 ranks each, a dcn x tp mesh whose outer axis is the
host boundary, a causal ring across it and a dp-over-hosts train step.

    python -m vtpu_torch.entry --dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np
import torch

from vtpu_torch.device import resolve_device
from vtpu_torch.models.resnet import ResNetV2, ResNetV2_50


def entry(device="cuda"):
    dev = resolve_device(device)
    model = ResNetV2_50(num_classes=1000, device=dev)
    example = torch.ones((8, 224, 224, 3), dtype=torch.float32, device=dev)

    def forward(images):
        logits, _ = model(images)
        return logits

    return forward, (example,)


def _randn(seed: int, shape, dev) -> torch.Tensor:
    """Seeded normal data, the same on every rank."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev)


def _train_resnet(mesh, dp_axis: str, dev, ckpt_dir=None):
    """Three dp x tp steps of a small ResNet-V2 on one repeated batch
    (ones, labels 0; it must overfit), with a checkpoint round trip
    after the second step when ``ckpt_dir`` is given.  Returns the
    losses."""
    from vtpu_torch.models.layers import load_batch_stats
    from vtpu_torch.parallel.mesh import mesh_shape
    from vtpu_torch.parallel.sharding import make_train_step
    from vtpu_torch.utils.checkpoint import Checkpointer

    model = ResNetV2(stage_sizes=(1, 1), num_filters=64, num_classes=128,
                     device=dev, generator=torch.Generator(
                         device=dev).manual_seed(0))
    step, optimizer = make_train_step(model, mesh, dp_axis=dp_axis)
    per_rank = 2 if dp_axis == "dp" else mesh_shape(mesh)["tp"]
    images = torch.ones((per_rank, 32, 32, 3), device=dev)
    labels = torch.zeros((per_rank,), dtype=torch.int64, device=dev)
    losses = []
    for i in range(3):
        losses.append(float(step(images, labels)))
        assert np.isfinite(losses[-1]), f"non-finite loss {losses[-1]}"
        if i == 1 and ckpt_dir is not None:
            ck = Checkpointer(ckpt_dir)
            tree = {"params": step.params.local,
                    "opt": optimizer.state_dict(),
                    "bs": dict(model.named_buffers())}
            ck.save(1, tree)
            restored = ck.restore(tree)
            for name, t in step.params.local.items():
                assert torch.equal(restored["params"][name], t), (
                    f"checkpoint round trip changed {name}")
            with torch.no_grad():
                for name, t in step.params.local.items():
                    t.copy_(restored["params"][name])
            optimizer.load_state_dict(restored["opt"])
            load_batch_stats(model, restored["bs"])
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    return losses


def _dryrun_rank(n: int, device: str, ckpt_dir: str) -> dict:
    """One rank of :func:`dryrun_multichip`: every program, collectively."""
    from vtpu_torch.models.transformer import TransformerLM, tp_param_specs
    from vtpu_torch.ops.attention import reference_attention
    from vtpu_torch.parallel import comm
    from vtpu_torch.parallel.distributed import process_index, rank_device
    from vtpu_torch.parallel.mesh import (axis_group, make_hybrid_mesh,
                                          make_mesh, mesh_shape)
    from vtpu_torch.parallel.moe import moe_ffn
    from vtpu_torch.parallel.pipeline import pipeline_apply
    from vtpu_torch.parallel.ring import ring_attention
    from vtpu_torch.parallel.sharding import (local_shard, lm_value_and_grad,
                                              shard_params)
    from vtpu_torch.parallel.ulysses import ulysses_attention

    dev = rank_device(device)
    even = n >= 4 and n % 2 == 0
    mesh = make_mesh(("dp", "tp"))
    losses = _train_resnet(mesh, "dp", dev, ckpt_dir)

    # sequence parallelism: ring attention over a 1-D sp mesh, against
    # the unsharded reference
    sp_mesh = make_mesh(("sp",), (n,))
    seq = (None, None, "sp", None)
    q = _randn(1, (2, 2, 8 * n, 64), dev)
    out = ring_attention(*(local_shard(q, sp_mesh, seq),) * 3, sp_mesh,
                         axis="sp")
    want = local_shard(reference_attention(q, q, q), sp_mesh, seq)
    assert torch.allclose(out, want, atol=2e-4, rtol=2e-4), "ring numerics"

    # SP x TP: heads over tp, the sequence ringing over sp
    out_sptp = None
    if even:
        sptp = make_mesh(("sp", "tp"), (n // 2, 2))
        q2 = _randn(9, (2, 2, 8 * (n // 2), 64), dev)
        spec = (None, "tp", "sp", None)
        out_sptp = ring_attention(*(local_shard(q2, sptp, spec),) * 3, sptp,
                                  axis="sp", head_axis="tp")
        want = local_shard(reference_attention(q2, q2, q2), sptp, spec)
        assert torch.allclose(out_sptp, want, atol=2e-4, rtol=2e-4), \
            "sp x tp ring numerics"

    # all-to-all sequence parallelism (Ulysses) over the same axis
    qh = _randn(2, (2, n, 8 * n, 64), dev)
    out_u = ulysses_attention(*(local_shard(qh, sp_mesh, seq),) * 3,
                              sp_mesh, axis="sp")
    want = local_shard(reference_attention(qh, qh, qh), sp_mesh, seq)
    assert torch.allclose(out_u, want, atol=2e-4, rtol=2e-4), "ulysses"

    # the hybrid tier: a psum over tp nested in one over dcn
    if even:
        hybrid = make_hybrid_mesh((n // 2,), ici_axis_names=("tp",),
                                  num_slices=2)
        xs = local_shard(torch.ones((n, 8), device=dev), hybrid,
                         (("dcn", "tp"), None))
        summed = comm.all_reduce_sum(
            comm.all_reduce_sum(xs, axis_group(hybrid, "tp")),
            axis_group(hybrid, "dcn"))
        assert float(summed[0, 0]) == float(n), summed

    # pipeline: one stage a rank, microbatches streamed over the ring
    pp_mesh = make_mesh(("pp",), (n,))
    d = 16
    ws = {"w": local_shard(torch.ones((n, d, d), device=dev) * 0.01,
                           pp_mesh, ("pp",))}
    pp_out = pipeline_apply(lambda p, x: torch.tanh(x @ p["w"]), ws,
                            torch.ones((2 * n, 4, d), device=dev), pp_mesh,
                            axis="pp")

    # expert parallelism: top-1 MoE FFN, one expert a rank
    ep_mesh = make_mesh(("ep",), (n,))
    ep = ("ep",)
    moe_out = moe_ffn(
        local_shard(torch.ones((4 * n, d), device=dev), ep_mesh, ep),
        torch.ones((d, n), device=dev),
        local_shard(torch.ones((n, d, 2 * d), device=dev) * 0.01, ep_mesh,
                    ep),
        local_shard(torch.ones((n, 2 * d, d), device=dev) * 0.01, ep_mesh,
                    ep),
        ep_mesh, axis="ep")

    # pipeline x expert parallelism: each stage an expert ensemble
    pp_ep_out = None
    if even:
        pe_mesh = make_mesh(("pp", "ep"), (2, n // 2))
        n_ep = n // 2
        ep_group = axis_group(pe_mesh, "ep")

        def stage_moe(p, x):
            y = torch.tanh(x @ p["w"])
            # each ep rank applies its expert; the mean mixes them
            ye = torch.tanh(y @ p["we"][0])
            return comm.all_reduce_sum(ye, ep_group) / n_ep

        pe_params = {
            "w": local_shard(torch.ones((2, d, d), device=dev) * 0.01,
                             pe_mesh, ("pp",)),
            "we": local_shard(torch.ones((2, n_ep, d, d), device=dev) * 0.01,
                              pe_mesh, ("pp", "ep")),
        }
        pp_ep_out = pipeline_apply(stage_moe, pe_params,
                                   torch.ones((4, 4, d), device=dev),
                                   pe_mesh, axis="pp")

    # 3-D mesh (2 x 2 x 2): dp x fsdp x tp matmul, every axis live
    if n >= 8 and n % 8 == 0:
        mesh3 = make_mesh(("dp", "fsdp", "tp"), (2, 2, 2),
                          devices=range(8))
        xb, wb = _randn(7, (8, 16), dev), _randn(8, (16, 32), dev)
        y3 = local_shard(xb, mesh3, (("dp", "fsdp"), None)) \
            @ local_shard(wb, mesh3, (None, "tp"))
        want = local_shard(xb @ wb, mesh3, (("dp", "fsdp"), "tp"))
        assert torch.allclose(y3, want, atol=1e-5), "3-D mesh matmul"

    # transformer LM: one gradient step with Megatron-style tp specs
    tp = mesh_shape(mesh)["tp"]
    lm = TransformerLM(vocab=64, d_model=32, depth=1, num_heads=tp,
                       max_seq=16, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(4))
    toks = torch.randint(0, 64, (mesh_shape(mesh)["dp"], 8),
                         generator=torch.Generator().manual_seed(3)).to(dev)
    params = shard_params(lm, mesh, spec_of=tp_param_specs("tp"))
    lm_loss_val = float(lm_value_and_grad(
        lm, params, local_shard(toks, mesh, ("dp", None)), mesh))
    assert np.isfinite(lm_loss_val)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in params.leaves())
    return dict(rank=process_index(), mesh=mesh_shape(mesh), losses=losses,
                ring=list(out.shape),
                ring_sptp=None if out_sptp is None else list(out_sptp.shape),
                ulysses=list(out_u.shape), pipeline=list(pp_out.shape),
                moe=list(moe_out.shape),
                pp_ep=None if pp_ep_out is None else list(pp_ep_out.shape),
                lm_loss=lm_loss_val)


def _two_host_rank(n: int, device: str) -> dict:
    """One rank of the two-host form: the outer mesh axis is the host
    boundary."""
    from vtpu_torch.ops.attention import reference_attention
    from vtpu_torch.parallel import comm, distributed
    from vtpu_torch.parallel.mesh import (axis_group, make_hybrid_mesh,
                                          make_mesh)
    from vtpu_torch.parallel.ring import ring_attention
    from vtpu_torch.parallel.sharding import local_shard

    assert distributed.global_device_count() == n
    assert distributed.local_device_count() == n // 2
    dev = distributed.rank_device(device)
    mesh = make_hybrid_mesh((n // 2,), ici_axis_names=("tp",),
                            num_slices=2)
    xs = local_shard(torch.ones((n,), device=dev), mesh, (("dcn", "tp"),))
    summed = comm.all_reduce_sum(comm.all_reduce_sum(
        xs, axis_group(mesh, "tp")), axis_group(mesh, "dcn"))
    assert float(summed[0]) == float(n), summed
    # a causal ring whose hops cross the host boundary
    sp = make_mesh(("sp",), (n,))
    seq = (None, None, "sp", None)
    q, k, v = (_randn(s, (1, 2, 16 * n, 16), dev) for s in (0, 1, 2))
    out = ring_attention(*(local_shard(t, sp, seq) for t in (q, k, v)), sp,
                         axis="sp", causal=True)
    want = local_shard(reference_attention(q, k, v, causal=True), sp, seq)
    assert torch.allclose(out, want, atol=2e-3, rtol=2e-3), "ring across hosts"
    # a dp (across hosts) x tp train step
    losses = _train_resnet(mesh, "dcn", dev)
    return dict(rank=distributed.process_index(), losses=losses)


def dryrun_multichip(n_devices: int, device="cuda", *,
                     timeout_s: float = 600.0) -> dict:
    """Run the parallel layer's programs over a world of ``n_devices``
    ranks (and, for n >= 4 and even, the two-host form); returns rank
    0's summary, with the two-host form's losses under ``"two_host"``.
    Raises when a rank fails or the world passes ``timeout_s``."""
    from vtpu_torch.parallel.distributed import spawn_world

    dev = resolve_device(device)
    ckpt = tempfile.mkdtemp(prefix="vtpu-dryrun-ckpt-")
    try:
        res = spawn_world(_dryrun_rank, n_devices, dev.type,
                          args=(n_devices, dev.type, ckpt),
                          timeout_s=timeout_s)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    summary = res[0]
    if n_devices >= 4 and n_devices % 2 == 0:
        two = spawn_world(_two_host_rank, n_devices, dev.type,
                          args=(n_devices, dev.type), hosts=2,
                          timeout_s=timeout_s)
        summary["two_host"] = [r["losses"] for r in two]
    print(f"dryrun_multichip ok: {summary}", flush=True)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description="the port's dryrun")
    ap.add_argument("--dryrun", type=int, default=1,
                    help="ranks in the world")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dryrun_multichip(args.dryrun, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
