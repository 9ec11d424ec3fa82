"""The port's sharded train steps, checkpoints, host offload and world
bootstrap against the JAX package on the CPU.

One gloo world of 4 ranks (a 2 x 2 dp x tp mesh, ``spawn_world``) runs
``torch_world_cases.sharding_cases``: three SGD steps of
``ResNetV2(stage_sizes=(1, 1), num_filters=64, num_classes=128)`` (f32;
BatchNorm statistics over the whole dp batch) against
``vtpu.parallel.sharding.make_train_step`` on four virtual devices, the
block of every parameter each rank holds against the JAX shard on the
same device index, the same run resumed from a checkpoint after step 2,
the tp ``TransformerLM``'s loss and gradient shards against
``jax.value_and_grad`` over ``tp_param_specs``, and a sharded checkpoint
round trip.  The rest runs in this process: ``Checkpointer`` on a world
of one, the offload functions, ``ensure_initialized`` and the
launcher's failure paths."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_world_cases as cases
from torch_parity import jax_params
from vtpu.models import transformer as jtf
from vtpu.models.resnet import ResNetV2 as JResNet
from vtpu.parallel import sharding as jsh
from vtpu_torch.models.convert import cnn_params_from_flax, params_from_flax
from vtpu_torch.parallel import distributed as tdist
from vtpu_torch.utils import offload
from vtpu_torch.utils.checkpoint import Checkpointer

LM = dict(vocab=64, d_model=64, depth=2, num_heads=4, max_seq=16)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module")
def setup():
    jmodel = JResNet(stage_sizes=(1, 1), num_filters=64, num_classes=128,
                     dtype=jnp.float32)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 128, (4,)).astype(np.int64)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    jlm = jtf.TransformerLM(**LM)
    lm_params = jax_params(jlm)
    tokens = rng.integers(0, 64, (2, 8)).astype(np.int32)
    return dict(jmodel=jmodel, images=images, labels=labels,
                variables=variables, jlm=jlm, lm_params=lm_params,
                tokens=tokens)


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    s = setup
    state = cnn_params_from_flax(_np_tree(s["variables"]), device="cpu")
    lm_state = params_from_flax(_np_tree(s["lm_params"]), device="cpu")
    return tdist.spawn_world(
        cases.sharding_cases, 4, "cpu",
        args=(state, s["images"], s["labels"], lm_state, LM, s["tokens"],
              str(tmp_path_factory.mktemp("world"))), timeout_s=240)


@pytest.fixture(scope="module")
def jax_run(setup):
    """The reference: make_train_step over a 2 x 2 mesh, three steps."""
    s = setup
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    params = jsh.shard_params(s["variables"]["params"], mesh)
    stats = s["variables"]["batch_stats"]
    step, opt = jsh.make_train_step(s["jmodel"], mesh)
    opt_state = opt.init(params)
    losses = []
    first = params
    for _ in range(3):
        params, stats, opt_state, loss = step(
            params, stats, opt_state, jnp.asarray(s["images"]),
            jnp.asarray(s["labels"].astype(np.int32)))
        losses.append(float(loss))
    return dict(losses=losses, stats=stats, first=first, final=params)


def _shard_on(arr, device_id: int) -> np.ndarray:
    (sh,) = [x for x in arr.addressable_shards if x.device.id == device_id]
    return np.asarray(sh.data)


def test_dp_tp_resnet_steps_match_jax(world, jax_run):
    """Three losses within 1e-4 of the reference's and falling, the
    same on every rank, and the running statistics over the whole
    batch."""
    for r in world:
        got = r["straight"]["losses"]
        np.testing.assert_allclose(got, jax_run["losses"], atol=1e-4, rtol=0)
        assert got[-1] < got[0]
    want = cnn_params_from_flax({"batch_stats": _np_tree(jax_run["stats"])},
                                device="cpu")
    for name, t in want.items():
        np.testing.assert_allclose(world[0]["straight"]["stats"][name],
                                   t.numpy(), atol=1e-4, rtol=0)


def test_each_tp_shard_lands_where_jax_puts_it(world, jax_run):
    """Every parameter is split where ``shard_params`` splits its flax
    twin (the output-feature dim: the flax kernel's last, dim 0 of the
    port's conv and dense weights), and rank r holds the block that
    device r holds; after the three steps each block equals that block
    of the reference's parameters."""
    first, final = jax_run["first"], jax_run["final"]
    specs = cnn_params_from_flax({"params": jax.tree.map(
        lambda a: np.asarray(tuple(a.sharding.spec) == (None,) * (a.ndim - 1)
                             + ("tp",)), first)}, device="cpu")
    blocks = [cnn_params_from_flax({"params": jax.tree.map(
        lambda a: _shard_on(a, r), first)}, device="cpu") for r in range(4)]
    full = cnn_params_from_flax({"params": _np_tree(final)}, device="cpu")
    sharded = 0
    for r, res in enumerate(world):
        for name, t in full.items():
            spec = res["straight"]["specs"][name]
            split = bool(specs[name].reshape(-1)[0])
            assert ("tp" in spec) == split, name
            got = res["straight"]["local"][name]
            assert got.shape == tuple(blocks[r][name].shape), name
            if split:
                assert spec.index("tp") == 0, name
                n = got.shape[0]
                t = t[(r % 2) * n:(r % 2 + 1) * n]
                sharded += 1
            np.testing.assert_allclose(got, t.numpy(), atol=1e-4, rtol=0)
    assert sharded > 0


def test_checkpoint_round_trip_mid_run_continues_to_the_same_loss(world):
    for r in world:
        assert r["resumed"]["restored_equal"] is True
        assert r["resumed"]["losses"] == r["straight"]["losses"]


def test_tp_lm_loss_and_grads_match_jax(setup, world):
    s = setup
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    spec_of = jtf.tp_param_specs("tp")

    def place(path, leaf):
        p = "/".join(getattr(k, "key", str(k)) for k in path)
        return jax.device_put(leaf, NamedSharding(mesh, spec_of(p)))

    params = jax.tree_util.tree_map_with_path(place, s["lm_params"])
    toks = jax.device_put(jnp.asarray(s["tokens"]),
                          NamedSharding(mesh, P("dp", None)))
    jm = s["jlm"]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(jm.apply({"params": p}, toks), toks)))(params)
    # the flax spec of each leaf, by the port's name: a column split
    # (None, tp) of the kernel [in, out] is (tp, None) of the weight
    # [out, in], a row split the other way round
    codes = {(): 0, (None, "tp"): 1, ("tp", None): 2}
    flax_spec = params_from_flax(jax.tree.map(
        lambda a: np.full(a.shape, codes[tuple(a.sharding.spec)],
                          np.float32), params), device="cpu")
    full = params_from_flax(_np_tree(grads), device="cpu")
    column = row = 0
    for r, res in enumerate(world):
        assert abs(res["lm"]["loss"] - float(loss)) <= 1e-5
        for name, t in full.items():
            spec = res["lm"]["specs"][name]
            want = [(), ("tp", None), (None, "tp")][
                int(flax_spec[name].reshape(-1)[0])]
            assert spec == want, name
            for dim, axis in enumerate(spec):
                if axis is not None:
                    n = t.shape[dim] // 2
                    t = t.narrow(dim, (r % 2) * n, n)
            g = res["lm"]["grads"][name]
            scale = float(full[name].abs().max())
            assert np.abs(g - t.numpy()).max() <= 1e-4 * max(scale, 1e-12)
            column += spec == ("tp", None)
            row += spec == (None, "tp")
    assert column > 0 and row > 0


def test_sharded_checkpoint_in_a_world(world):
    for r in world:
        c = r["ckpt"]
        assert c["equal"] and c["old_equal"] and c["step"] == 3
        assert c["steps"] == [2, 3] and c["latest"] == 3


# -- a world of one, in this process -----------------------------------------
def test_checkpointer_round_trip_retention_and_missing(tmp_path):
    w = torch.from_numpy(cases.arr(31, (8, 16)))
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"w": w * step, "nested": [w, {"step": step}]})
    assert ck.latest_step() == 3 and ck.all_steps() == [2, 3]
    target = {"w": torch.zeros(8, 16, dtype=torch.float64),
              "nested": [torch.zeros(8, 16), {"step": 0}]}
    got = ck.restore(target)
    assert got["w"].dtype == torch.float64  # the target's placement
    assert torch.equal(got["w"], (w * 3).double())
    assert torch.equal(got["nested"][0], w) and got["nested"][1]["step"] == 3
    assert torch.equal(target["w"], torch.zeros(8, 16, dtype=torch.float64))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"w": w})


def test_offload_round_trip_and_update_pattern():
    """No second tier on a machine without a card: the offloads return
    their input.  The offloaded-optimizer pattern (momenta parked between
    steps) keeps SGD-momentum numerics, as the reference's test does."""
    params = {"w": torch.arange(8.0), "b": torch.ones(4)}
    assert offload.host_sharding() is None
    assert offload.host_out_shardings(params) is None
    assert offload.offload_to_host(params) is params
    back = offload.to_device(offload.offload_to_host(params), "cpu")
    for k in params:
        assert torch.equal(back[k], params[k])

    def run(park: bool):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        opt = torch.optim.SGD(p.values(), lr=0.1, momentum=0.9)
        for _ in range(3):
            opt.zero_grad()
            sum((v * 0.5).sum() for v in p.values()).backward()
            offload.optimizer_state_to(opt, "cpu")  # stream in
            opt.step()
            if park:
                offload.optimizer_state_to(opt, offload.host_sharding()
                                           or "cpu")
        return p

    a, b = run(True), run(False)
    for k in params:
        assert torch.equal(a[k], b[k])
    # the same update as optax.sgd(0.1, momentum=0.9)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    opt = optax.sgd(0.1, momentum=0.9)
    st = opt.init(jp)
    for _ in range(3):
        g = jax.tree.map(lambda x: jnp.full_like(x, 0.5), jp)
        up, st = opt.update(g, st)
        jp = optax.apply_updates(jp, up)
    for k in params:
        np.testing.assert_allclose(a[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6)


def test_ensure_initialized_env_contract(monkeypatch):
    for name in ("VTPU_COORDINATOR", "VTPU_NUM_PROCESSES",
                 "VTPU_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.ensure_initialized(device="cpu") is False
    monkeypatch.setenv("VTPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("VTPU_NUM_PROCESSES", "1")
    assert tdist.ensure_initialized(device="cpu") is False
    monkeypatch.setenv("VTPU_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="VTPU_PROCESS_ID"):
        tdist.ensure_initialized(device="cpu")
    assert tdist.process_index() == 0 and tdist.global_device_count() == 1


def test_spawn_world_reports_a_failing_rank_and_the_deadline():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        tdist.spawn_world(cases.fail_on_rank, 2, "cpu", args=(1,),
                          timeout_s=60)
    with pytest.raises(TimeoutError, match="deadline"):
        tdist.spawn_world(cases.sleep_forever, 2, "cpu", timeout_s=4)
    assert tdist.spawn_world(cases.world_facts, 2, "cpu", hosts=2,
                             timeout_s=60) == [(0, 2, 1), (1, 2, 1)]
