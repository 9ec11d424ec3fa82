"""The port's parallel layer against the JAX package on the CPU.

One gloo world of 8 ranks and one of 4 (``spawn_world``, each started
once for the module) run every case of ``tests/torch_world_cases.py`` and
hand back global arrays; this process holds them against ``vtpu.parallel``
on the first 8 or 4 of its 8 virtual CPU devices: mesh shapes and the
host-split validation, the hybrid psum, ring attention (contiguous and
striped, causal or not, sp x tp) with its gradients, Ulysses (and
dp x sp) with its gradients, the pipeline and its gradient, pp x ep, and
the sharded MoE FFN with its gradients and against ``moe_ffn_local``.
Outputs within 2e-5, gradients within 1e-4 of their largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_world_cases as cases
from torch_world_cases import D, HD, arr
from vtpu.parallel import mesh as jmesh
from vtpu.parallel.moe import moe_ffn as j_moe_ffn
from vtpu.parallel.pipeline import pipeline_apply as j_pipeline
from vtpu.parallel.ring import ring_attention as j_ring
from vtpu.parallel.ulysses import ulysses_attention as j_ulysses
from vtpu_torch.parallel.distributed import spawn_world
from vtpu_torch.parallel.ring import ring_attention_shards

WORLDS = [8, 4]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request):
    n = request.param
    return n, spawn_world(cases.run_cases, n, "cpu", args=(n,),
                          timeout_s=240)[0]


def _mesh(n, shape, names):
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _close(got, want, atol=2e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _out_and_grads(f, args, cot):
    """``f(*args)`` and the gradients of ``sum(f(*args) * cot)``, as one
    jitted program (eager shard_map runs op by op, tens of seconds)."""
    def loss(*a):
        out = f(*a)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return out, grads


def _grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(np.asarray(g) - w).max() <= 1e-4 * max(
            np.abs(w).max(), 1e-12)


def test_mesh_shapes_and_host_split_validation(world):
    n, res = world
    assert res["jax_loaded"] is False  # the ranks never import JAX
    m = res["mesh"]
    devs = jax.devices()[:n]
    ref = jmesh.make_mesh(devices=devs)
    assert m["default"] == dict(ref.shape)
    ref = jmesh.mesh_from_rectangle([(2, 1, 1)] * (n // 2), devices=devs)
    assert m["host_split"][0] == dict(ref.shape)
    assert m["host_split"][1] == np.arange(n).reshape(n // 2, 2).tolist()
    # psum over tp sums each host's pair of ranks
    _close(m["host_split_psum"], np.arange(n).reshape(-1, 2).sum(1))
    if n == 8:
        ref = jmesh.mesh_from_rectangle([(2, 2, 1)] * 2, devices=devs)
        assert m["multi_inner"] == dict(ref.shape)
        assert list(m["multi_inner"]) == ["dp", "ici0", "ici1"]
        assert list(m["named"]) == ["dcn", "x", "y"]
    ref = jmesh.mesh_from_rectangle((2, n // 2, 1), devices=devs)
    assert m["single_rect"] == dict(ref.shape)
    assert "homogeneous" in m["err_homogeneous"]
    assert f"needs {4 * n} devices, have {n}" in m["err_devices"]
    assert "axis names" in m["err_names"]
    ref = jmesh.make_hybrid_mesh((n // 2,), ici_axis_names=("tp",),
                                 num_slices=2, devices=devs)
    assert m["hybrid"] == (dict(ref.shape), float(n))


def _ring_ref(n, causal, layout):
    shape = (1, 2, 4 * n, HD)
    q, k, v, cot = (jnp.asarray(arr(s, shape)) for s in (1, 2, 3, 4))
    mesh = _mesh(n, (n,), ("sp",))

    def f(q, k, v):
        return j_ring(q, k, v, mesh, axis="sp", causal=causal,
                      layout=layout)

    return _out_and_grads(f, (q, k, v), cot)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_ring_attention_and_grads_match_jax(world, layout, causal):
    n, res = world
    got = res["ring"][f"{layout}_{'causal' if causal else 'full'}"]
    out, grads = _ring_ref(n, causal, layout)
    _close(got[0], out)
    _grads_close(got[1:], grads)
    # every rank's schedule in turn on one device (how the card runs it)
    q, k, v = (torch.from_numpy(arr(s, (1, 2, 4 * n, HD))) for s in (1, 2, 3))
    _close(ring_attention_shards(q, k, v, n, causal=causal, layout=layout),
           out)


def test_ring_attention_sp_tp_matches_jax(world):
    n, res = world
    shape = (1, 2, 4 * n, HD)
    q, k, v = (jnp.asarray(arr(s, shape)) for s in (1, 2, 3))
    mesh = _mesh(n, (n // 2, 2), ("sp", "tp"))
    want = jax.jit(lambda *a: j_ring(*a, mesh, axis="sp", causal=True,
                                     head_axis="tp"))(q, k, v)
    _close(res["ring"]["sptp"], want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ulysses_and_grads_match_jax(world, causal):
    n, res = world
    q, k, v, cot = (jnp.asarray(arr(s, (2, n, 4 * n, HD)))
                    for s in (5, 6, 7, 8))
    mesh = _mesh(n, (n,), ("sp",))

    def f(q, k, v):
        return j_ulysses(q, k, v, mesh, axis="sp", causal=causal)

    got = res["ulysses"][f"causal{int(causal)}"]
    out, grads = _out_and_grads(f, (q, k, v), cot)
    _close(got[0], out)
    _grads_close(got[1:], grads)


def test_ulysses_dp_sp_and_head_check(world):
    n, res = world
    q, k, v = (jnp.asarray(arr(s, (2, n, 4 * n, HD))) for s in (5, 6, 7))
    mesh = _mesh(n, (2, n // 2), ("dp", "sp"))
    want = jax.jit(lambda *a: j_ulysses(*a, mesh, axis="sp", causal=True,
                                        batch_axis="dp"))(q, k, v)
    _close(res["ulysses"]["dp_sp"], want)
    assert f"heads ({n + 1}) must divide" in res["ulysses"]["err_heads"]


def test_pipeline_and_grad_match_jax(world):
    n, res = world
    mesh = _mesh(n, (n,), ("pp",))
    ws = jnp.asarray(arr(10, (n, D, D), 0.3))
    xs = jnp.asarray(arr(11, (2 * n, 4, D)))

    def f(w):
        return j_pipeline(lambda p, x: jnp.tanh(x @ p["w"]), {"w": w}, xs,
                          mesh, axis="pp")

    got = res["pipeline"]
    (_, out), grad = jax.jit(jax.value_and_grad(
        lambda w: (jnp.mean(f(w) ** 2), f(w)), has_aux=True))(ws)
    _close(got["pipeline"], out)
    _grads_close([got["pipeline_grad"]], [grad])
    # the sequential oracle, as the reference's own test
    want = np.asarray(xs)
    for s in range(n):
        want = np.tanh(want @ np.asarray(ws[s]))
    _close(got["pipeline"], want, atol=1e-5)
    assert "microbatches" in got["err_micro"]


def test_pipeline_times_expert_parallel_matches_jax(world):
    n, res = world
    n_ep = n // 2
    mesh = _mesh(n, (2, n_ep), ("pp", "ep"))

    def stage(p, x):
        y = jnp.tanh(x @ p["w"])
        return jax.lax.pmean(jnp.tanh(y @ p["we"][0]), "ep")

    params = {"w": jnp.asarray(arr(12, (2, D, D), 0.3)),
              "we": jnp.asarray(arr(13, (2, n_ep, D, D), 0.3))}
    want = jax.jit(lambda p, xs: j_pipeline(
        stage, p, xs, mesh, axis="pp",
        param_specs={"w": P("pp"), "we": P("pp", "ep")}))(
            params, jnp.asarray(arr(14, (4, 4, D))))
    _close(res["pipeline"]["pp_ep"], want)


@pytest.mark.parametrize("per,top_k,cap", [(1, 1, 0), (2, 2, None), (1, 2, 3)],
                         ids=["top1_default_cap", "two_local_top2",
                              "top2_overflow"])
def test_sharded_moe_and_grads_match_jax(world, per, top_k, cap):
    """``moe_ffn`` over the ep ranks against the reference's, with the
    gradients of every input (the replicated router's summed over the
    ranks, as ``jax.grad`` sums it); with roomy capacity it equals
    ``moe_ffn_local``."""
    n, res = world
    t, e = 4 * n, per * n
    cap = 2 * t if cap is None else cap
    x, rw, wi, wo, cot = (jnp.asarray(a) for a in (
        arr(20, (t, D)), arr(21, (D, e)), arr(22, (e, D, 2 * D), 0.1),
        arr(23, (e, 2 * D, D), 0.1), arr(24, (t, D))))
    mesh = _mesh(n, (n,), ("ep",))

    def f(*a):
        return j_moe_ffn(*a, mesh, axis="ep", capacity=cap, top_k=top_k)

    got = res["moe"][f"e{e}_k{top_k}_c{cap}"]
    out, grads = _out_and_grads(f, (x, rw, wi, wo), cot)
    _close(got[0], out)
    _grads_close(got[1:], grads)
    if cap == 2 * t:
        _close(got[0], res["moe"][f"e{e}_k{top_k}_c{cap}_local"])


def test_sharded_moe_argument_errors(world):
    n, res = world
    assert f"n_experts={n + 1} not divisible" in res["moe"]["err_indivisible"]
    assert f"top_k={n + 1} out of range" in res["moe"]["err_top_k"]
