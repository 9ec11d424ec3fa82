"""The rank side of ``tests/test_torch_parallel.py``: every case of the
port's parallel layer, run in each rank of a gloo world started by
``vtpu_torch.parallel.distributed.spawn_world``.  This module imports
no JAX (the ranks must not), and makes its inputs from seeds with numpy,
so the test process rebuilds the same inputs for the JAX package.

Each case returns global arrays (the ranks' blocks gathered to every
rank) or the message of the error it expected; :func:`run_cases` returns
rank 0's dict of them."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

D = 16       # feature width of the pipeline and MoE cases
HD = 16      # head dim of the attention cases


def arr(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _blocks(x: torch.Tensor, mesh, spec):
    """This rank's (start, length) per dim of ``x``'s global shape."""
    from vtpu_torch.parallel.sharding import _block

    out = []
    for dim, size in enumerate(x.shape):
        axes = spec[dim] if dim < len(spec) else None
        if axes is None:
            out.append((0, size))
        else:
            start, n = _block(size * _count(mesh, axes), mesh, axes)
            out.append((start, n))
    return out


def _count(mesh, axes) -> int:
    from vtpu_torch.parallel.mesh import axis_size

    axes = (axes,) if isinstance(axes, str) else axes
    return int(np.prod([axis_size(mesh, a) for a in axes]))


def gather_global(local: torch.Tensor, mesh, spec) -> np.ndarray:
    """The global array whose blocks the ranks hold under ``spec``."""
    blocks = _blocks(local, mesh, spec)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (blocks, local.detach().numpy()))
    shape = [max(b[i][0] + b[i][1] for b, _ in parts)
             for i in range(local.dim())]
    out = np.zeros(shape, np.float32)
    for b, a in parts:
        out[tuple(slice(s, s + n) for s, n in b)] = a
    return out


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def mesh_cases(n: int) -> dict:
    from vtpu_torch.parallel.mesh import (axis_group, make_hybrid_mesh,
                                          make_mesh, mesh_from_rectangle,
                                          mesh_shape)
    from vtpu_torch.parallel import comm

    out = {"default": mesh_shape(make_mesh())}
    hs = mesh_from_rectangle([(2, 1, 1)] * (n // 2))
    out["host_split"] = (mesh_shape(hs), hs.mesh.tolist())
    x = torch.tensor([float(dist.get_rank())])
    out["host_split_psum"] = gather_global(
        comm.all_reduce_sum(x, axis_group(hs, "tp")), hs, ("dp",))
    if n % 4 == 0:
        m = mesh_from_rectangle([(2, 2, 1)] * (n // 4))
        out["multi_inner"] = mesh_shape(m)
        m = mesh_from_rectangle([(2, 2, 1)] * (n // 4),
                                axis_names=("dcn", "x", "y"))
        out["named"] = mesh_shape(m)
    out["single_rect"] = mesh_shape(mesh_from_rectangle((2, n // 2, 1)))
    out["err_homogeneous"] = _error(
        lambda: mesh_from_rectangle([(2, 1, 1), (1, 2, 1)]))
    out["err_devices"] = _error(
        lambda: mesh_from_rectangle([(2, 2, 1)] * n))
    out["err_names"] = _error(
        lambda: mesh_from_rectangle([(2, 1, 1)] * (n // 2),
                                    axis_names=("dp",)))
    hy = make_hybrid_mesh((n // 2,), ici_axis_names=("tp",), num_slices=2)
    ones = torch.ones((1, 8))
    out["hybrid"] = (mesh_shape(hy), float(comm.all_reduce_sum(
        comm.all_reduce_sum(ones, axis_group(hy, "tp")),
        axis_group(hy, "dcn"))[0, 0]))
    return out


def ring_cases(n: int) -> dict:
    """Outputs and (q, k, v) gradients of ring attention, contiguous and
    striped, causal or not, on an sp mesh; and the sp x tp form."""
    from vtpu_torch.parallel.mesh import make_mesh
    from vtpu_torch.parallel.ring import ring_attention
    from vtpu_torch.parallel.sharding import local_shard

    out = {}
    sp = make_mesh(("sp",), (n,))
    seq = (None, None, "sp", None)
    shape = (1, 2, 4 * n, HD)
    q, k, v, cot = (torch.from_numpy(arr(s, shape)) for s in (1, 2, 3, 4))
    for causal in (False, True):
        for layout in ("contiguous", "striped"):
            ql, kl, vl = (local_shard(t, sp, seq).clone().requires_grad_()
                          for t in (q, k, v))
            o = ring_attention(ql, kl, vl, sp, causal=causal, layout=layout)
            (o * local_shard(cot, sp, seq)).sum().backward()
            key = f"{layout}_{'causal' if causal else 'full'}"
            out[key] = [gather_global(t, sp, seq)
                        for t in (o, ql.grad, kl.grad, vl.grad)]
    sptp = make_mesh(("sp", "tp"), (n // 2, 2))
    spec = (None, "tp", "sp", None)
    ql, kl, vl = (local_shard(t, sptp, spec) for t in (q, k, v))
    o = ring_attention(ql, kl, vl, sptp, axis="sp", causal=True,
                       head_axis="tp")
    out["sptp"] = gather_global(o, sptp, spec)
    return out


def ulysses_cases(n: int) -> dict:
    from vtpu_torch.parallel.mesh import make_mesh
    from vtpu_torch.parallel.sharding import local_shard
    from vtpu_torch.parallel.ulysses import ulysses_attention

    out = {}
    sp = make_mesh(("sp",), (n,))
    seq = (None, None, "sp", None)
    q, k, v, cot = (torch.from_numpy(arr(s, (2, n, 4 * n, HD)))
                    for s in (5, 6, 7, 8))
    for causal in (False, True):
        ql, kl, vl = (local_shard(t, sp, seq).clone().requires_grad_()
                      for t in (q, k, v))
        o = ulysses_attention(ql, kl, vl, sp, causal=causal)
        (o * local_shard(cot, sp, seq)).sum().backward()
        out[f"causal{int(causal)}"] = [gather_global(t, sp, seq)
                                       for t in (o, ql.grad, kl.grad,
                                                 vl.grad)]
    dpsp = make_mesh(("dp", "sp"), (2, n // 2))
    spec = ("dp", None, "sp", None)
    o = ulysses_attention(*(local_shard(t, dpsp, spec) for t in (q, k, v)),
                          dpsp, causal=True, batch_axis="dp")
    out["dp_sp"] = gather_global(o, dpsp, spec)
    bad = torch.zeros((1, n + 1, 4, HD))
    out["err_heads"] = _error(lambda: ulysses_attention(bad, bad, bad, sp))
    return out


def pipeline_cases(n: int) -> dict:
    from vtpu_torch.parallel import comm
    from vtpu_torch.parallel.mesh import axis_group, make_mesh
    from vtpu_torch.parallel.pipeline import pipeline_apply
    from vtpu_torch.parallel.sharding import local_shard

    out = {}
    pp = make_mesh(("pp",), (n,))
    ws = torch.from_numpy(arr(10, (n, D, D), 0.3))
    xs = torch.from_numpy(arr(11, (2 * n, 4, D)))
    w = local_shard(ws, pp, ("pp",)).clone().requires_grad_()
    got = pipeline_apply(lambda p, x: torch.tanh(x @ p["w"]), {"w": w}, xs,
                         pp)
    torch.mean(got ** 2).backward()
    out["pipeline"] = got.detach().numpy()
    out["pipeline_grad"] = gather_global(w.grad, pp, ("pp",))
    out["err_micro"] = _error(lambda: pipeline_apply(
        lambda p, x: x, {"w": w}, xs[:1], pp))
    # pp x ep: each stage an expert ensemble, mixed by a mean over ep
    pe = make_mesh(("pp", "ep"), (2, n // 2))
    n_ep = n // 2
    group = axis_group(pe, "ep")

    def stage(p, x):
        y = torch.tanh(x @ p["w"])
        return comm.all_reduce_sum(torch.tanh(y @ p["we"][0]), group) / n_ep

    params = {
        "w": local_shard(torch.from_numpy(arr(12, (2, D, D), 0.3)), pe,
                         ("pp",)),
        "we": local_shard(torch.from_numpy(arr(13, (2, n_ep, D, D), 0.3)),
                          pe, ("pp", "ep")),
    }
    out["pp_ep"] = pipeline_apply(stage, params,
                                  torch.from_numpy(arr(14, (4, 4, D))),
                                  pe).numpy()
    return out


def moe_cases(n: int) -> dict:
    """Sharded ``moe_ffn`` (one and two experts a rank, top-1 and top-2,
    explicit and default capacity) with its gradients, and
    ``moe_ffn_local`` on the same inputs."""
    from vtpu_torch.parallel.mesh import make_mesh
    from vtpu_torch.parallel.moe import moe_ffn, moe_ffn_local
    from vtpu_torch.parallel.sharding import local_shard

    out = {}
    ep = make_mesh(("ep",), (n,))
    t = 4 * n
    for per, top_k, cap in ((1, 1, 0), (2, 2, 2 * t), (1, 2, 3)):
        e = per * n
        x, rw, wi, wo, cot = (torch.from_numpy(a) for a in (
            arr(20, (t, D)), arr(21, (D, e)), arr(22, (e, D, 2 * D), 0.1),
            arr(23, (e, 2 * D, D), 0.1), arr(24, (t, D))))
        xl = local_shard(x, ep, ("ep",)).clone().requires_grad_()
        rwl = rw.clone().requires_grad_()
        wil, wol = (local_shard(w, ep, ("ep",)).clone().requires_grad_()
                    for w in (wi, wo))
        o = moe_ffn(xl, rwl, wil, wol, ep, capacity=cap, top_k=top_k)
        (o * local_shard(cot, ep, ("ep",))).sum().backward()
        rw_grad = rwl.grad.clone()
        dist.all_reduce(rw_grad)  # a replicated leaf: the ranks' sum
        key = f"e{e}_k{top_k}_c{cap}"
        out[key] = [gather_global(o, ep, ("ep",)),
                    gather_global(xl.grad, ep, ("ep",)), rw_grad.numpy(),
                    gather_global(wil.grad, ep, ("ep",)),
                    gather_global(wol.grad, ep, ("ep",))]
        out[key + "_local"] = moe_ffn_local(
            x, rw, wi, wo, capacity=cap if cap else 2 * t,
            top_k=top_k).numpy()
    out["err_indivisible"] = _error(lambda: moe_ffn(
        torch.ones((4, 4)), torch.ones((4, n + 1)), torch.ones((1, 4, 4)),
        torch.ones((1, 4, 4)), ep))
    out["err_top_k"] = _error(lambda: moe_ffn(
        torch.ones((4, 4)), torch.ones((4, n)), torch.ones((1, 4, 4)),
        torch.ones((1, 4, 4)), ep, top_k=n + 1))
    return out


def run_cases(n: int) -> dict:
    """Every case, in this rank; rank 0's results (the others' are the
    same global arrays)."""
    import sys

    res = {"mesh": mesh_cases(n), "ring": ring_cases(n),
           "ulysses": ulysses_cases(n), "pipeline": pipeline_cases(n),
           "moe": moe_cases(n), "jax_loaded": "jax" in sys.modules}
    return res if dist.get_rank() == 0 else None


# -- sharded train steps and checkpoints (tests/test_torch_sharding.py) ------
def _resnet(state: dict):
    from vtpu_torch.models.resnet import ResNetV2

    model = ResNetV2(stage_sizes=(1, 1), num_filters=64, num_classes=128,
                     dtype=torch.float32, device="cpu")
    model.load_state_dict(state)
    return model


def resnet_steps(state: dict, images: np.ndarray, labels: np.ndarray,
                 ckpt_dir: str, steps: int = 3, resume_at: int = -1) -> dict:
    """``steps`` dp x tp SGD steps of the small ResNet-V2 on a (2, n/2)
    mesh, each rank fed its dp block of the batch; with ``resume_at``
    >= 0 the run saves a checkpoint after that step, builds a fresh
    model and step from the initial weights, restores into them and
    goes on.  Returns the losses, each parameter's spec and local shard
    (rank order), the running statistics and the restored-equal flag."""
    from vtpu_torch.parallel.mesh import make_mesh
    from vtpu_torch.parallel.sharding import local_shard, make_train_step
    from vtpu_torch.utils.checkpoint import Checkpointer

    n = dist.get_world_size()
    mesh = make_mesh(("dp", "tp"), (2, n // 2))
    model = _resnet(state)
    step, opt = make_train_step(model, mesh)
    x = local_shard(torch.from_numpy(images), mesh, ("dp",))
    y = local_shard(torch.from_numpy(labels), mesh, ("dp",))
    losses, restored_equal = [], None
    for i in range(steps):
        losses.append(float(step(x, y)))
        if i == resume_at:
            ck = Checkpointer(ckpt_dir, max_to_keep=2)
            tree = {"params": step.params.local, "opt": opt.state_dict(),
                    "bs": dict(model.named_buffers())}
            ck.save(i, tree)
            model = _resnet(state)
            step, opt = make_train_step(model, mesh)
            fresh = {"params": step.params.local, "opt": opt.state_dict(),
                     "bs": dict(model.named_buffers())}
            back = ck.restore(fresh)
            restored_equal = all(
                torch.equal(back["params"][k], v)
                for k, v in tree["params"].items()) and all(
                torch.equal(back["bs"][k], v) for k, v in tree["bs"].items())
            with torch.no_grad():
                for k, v in step.params.local.items():
                    v.copy_(back["params"][k])
                for k, v in model.named_buffers():
                    v.copy_(back["bs"][k])
            opt.load_state_dict(back["opt"])
    return dict(losses=losses, restored_equal=restored_equal,
                specs=step.params.specs,
                local={k: v.detach().numpy().copy()
                       for k, v in step.params.local.items()},
                stats={k: v.numpy().copy()
                       for k, v in model.named_buffers()})


def lm_grads(state: dict, cfg: dict, tokens: np.ndarray) -> dict:
    """The tp-sharded TransformerLM's global loss and this rank's
    gradient shards on a (2, n/2) dp x tp mesh."""
    from vtpu_torch.models.transformer import TransformerLM, tp_param_specs
    from vtpu_torch.parallel.mesh import make_mesh
    from vtpu_torch.parallel.sharding import (local_shard, lm_value_and_grad,
                                              shard_params)

    n = dist.get_world_size()
    mesh = make_mesh(("dp", "tp"), (2, n // 2))
    model = TransformerLM(**cfg, device="cpu")
    model.load_state_dict(state)
    params = shard_params(model, mesh, spec_of=tp_param_specs("tp"))
    loss = lm_value_and_grad(model, params, local_shard(
        torch.from_numpy(tokens), mesh, ("dp", None)), mesh)
    return dict(loss=float(loss), specs=params.specs,
                grads={k: v.grad.numpy().copy()
                       for k, v in params.local.items()})


def checkpoint_round_trip(ckpt_dir: str) -> dict:
    """Sharded save and restore in a world (the DCP path): each rank's
    tp shard of a tensor and a plain value come back bit for bit, and
    retention keeps the newest two steps."""
    from vtpu_torch.parallel.mesh import make_mesh
    from vtpu_torch.parallel.sharding import local_shard
    from vtpu_torch.utils.checkpoint import Checkpointer

    mesh = make_mesh(("tp",), (dist.get_world_size(),))
    w = local_shard(torch.from_numpy(arr(30, (8, 16))), mesh, ("tp", None))
    ck = Checkpointer(ckpt_dir, max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"w": w * step, "step": step})
    got = ck.restore({"w": torch.zeros_like(w), "step": 0})
    old = ck.restore({"w": torch.zeros_like(w), "step": 0}, step=2)
    return dict(equal=bool(torch.equal(got["w"], w * 3)), step=got["step"],
                old_equal=bool(torch.equal(old["w"], w * 2)),
                steps=ck.all_steps(), latest=ck.latest_step())


def sharding_cases(resnet_state, images, labels, lm_state, lm_cfg, tokens,
                   tmp: str) -> dict:
    """Every case of ``tests/test_torch_sharding.py`` in one world:
    the ResNet steps straight and resumed from a checkpoint, the LM's
    gradients and the checkpoint round trip; each rank's results."""
    import os

    return dict(
        straight=resnet_steps(resnet_state, images, labels, ""),
        resumed=resnet_steps(resnet_state, images, labels,
                             os.path.join(tmp, "resume"), resume_at=1),
        lm=lm_grads(lm_state, lm_cfg, tokens),
        ckpt=checkpoint_round_trip(os.path.join(tmp, "ckpt")))


def fail_on_rank(bad: int) -> None:
    if dist.get_rank() == bad:
        raise ValueError("this rank fails on purpose")
    dist.barrier()


def sleep_forever() -> None:
    import time

    time.sleep(3600)


def world_facts():
    from vtpu_torch.parallel import distributed

    return (distributed.process_index(), distributed.global_device_count(),
            distributed.local_device_count())
