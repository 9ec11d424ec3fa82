"""The port's benchmarks on the CPU at toy sizes: the ai-benchmark twin
(its rows, its SGD step against ``optax.sgd`` on the reference's loss)
and the share bench (four tenants on one region, the duty probe).  The
timings they print are only meaningful on the card; here they check the
control flow and the accounting."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_cnn_models import rel_err, seeded_variables
from vtpu.models.resnet import ResNetV2 as JResNet
from vtpu_torch.bench import ai_benchmark, share
from vtpu_torch.models.convert import cnn_params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)


def _reference_script():
    path = os.path.join(ROOT, "benchmarks", "ai-benchmark", "run_benchmark.py")
    spec = importlib.util.spec_from_file_location("jax_ai_benchmark", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rows_are_the_reference_rows():
    assert ai_benchmark.ROWS == _reference_script().ROWS
    assert ai_benchmark.parse_rows("") == ai_benchmark.ROWS
    assert ai_benchmark.parse_rows("vgg16:2:training,lstm:5:inference") == [
        ("vgg16", 2, "training"), ("lstm", 5, "inference")]


def test_training_step_matches_optax_sgd():
    """Two SGD steps of the resnet50 row's trainer (a tiny ResNet at the
    row's 346^2 input) against optax.sgd(1e-3, momentum=0.9) on the
    reference script's loss, the batch statistics fed back.  In float64
    on both sides: in f32 each side's gradient is 1e-3 of its norm from
    its own float64 one (a BatchNorm's input gradient sums to zero over
    the batch, so the sums of the gradients before it cancel), which
    would hide a wrong update.  Losses and running statistics within
    1e-9 relative, the whole update (every parameter's change,
    concatenated) within 1e-6 of its norm.  The images are seeded noise,
    not the row's ones: on a constant image the activations' spread is
    tiny against their mean, where flax's E[x^2] - E[x]^2 variance
    cancels and the port's does not
    (test_torch_cnn_models.py::test_batch_variance_does_not_cancel)."""
    batch, f64 = 2, torch.float64
    step, x, model = ai_benchmark.build_step(
        "resnet50", batch, "training", device="cpu", dtype=f64, **TINY)
    assert tuple(x.shape) == (batch, 346, 346, 3)
    model.to(f64)  # in place: the optimizer keeps its parameters
    xs = np.random.default_rng(7).standard_normal(x.shape)
    x = torch.from_numpy(xs)
    with jax.enable_x64(True):
        jm = JResNet(**TINY, dtype=jnp.float64)
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 seeded_variables(jm, xs.astype(np.float32)))
        model.load_state_dict(cnn_params_from_flax(variables, device="cpu",
                                                   dtype=f64))
        start = {k: v.clone() for k, v in model.state_dict().items()}
        tx = optax.sgd(1e-3, momentum=0.9)
        params, rest = variables["params"], {"batch_stats":
                                             variables["batch_stats"]}
        opt_state = tx.init(params)
        labels = jnp.zeros((batch,), jnp.int32)

        def loss_fn(p, rest):  # run_benchmark.py's loss
            out, updates = jm.apply({"params": p, **rest}, jnp.asarray(xs),
                                    mutable=["batch_stats"])
            logp = jax.nn.log_softmax(out[:, :1000])
            return -jnp.mean(logp[jnp.arange(batch), labels]), updates

        for _ in range(2):
            (loss, rest), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, rest)
            upd, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, upd)
            got = step(x)
            assert abs(float(got) - float(loss)) <= 1e-9 * abs(float(loss))
        want = cnn_params_from_flax(
            jax.device_get({"params": params, **rest}), device="cpu",
            dtype=f64)
    sd = model.state_dict()
    for k in [k for k in want if k.endswith((".mean", ".var"))]:
        assert rel_err(sd[k], want[k].numpy()) <= 1e-9, k
    names = [n for n, _ in model.named_parameters()]
    got_upd = torch.cat([(sd[n] - start[n]).ravel() for n in names])
    want_upd = torch.cat([(want[n] - start[n]).ravel() for n in names])
    assert float((got_upd - want_upd).norm() / want_upd.norm()) <= 1e-6


@pytest.mark.parametrize("name", ["lstm", "transformer", "deeplab"])
def test_rows_step_on_the_cpu(name):
    """One training and one inference step of the other model families,
    shrunk: finite outputs of the row's batch."""
    small = {"lstm": dict(hidden=16, vocab=30000, embed=8),
             "transformer": dict(depth=1, d_model=32, num_heads=2,
                                 vocab=64),
             "deeplab": dict(stage_sizes=(1, 1, 1, 1), num_filters=4)}[name]
    for mode in ("inference", "training"):
        step, x, _ = ai_benchmark.build_step(name, 1, mode, device="cpu",
                                             **small)
        out = step(x)
        assert bool(torch.isfinite(out).all())
        if mode == "inference":
            assert out.shape[0] == 1


def test_timed_rows_run_under_the_shim(tmp_path):
    from vtpu_torch.shim import ShimRuntime

    step, x, _ = ai_benchmark.build_step(
        "lstm", 2, "inference", device="cpu", hidden=8, embed=8)
    rt = ShimRuntime(limits_bytes=[1 << 30], core_limit=50, device="cpu",
                     region_path=str(tmp_path / "ai.cache"), uuids=["g"])
    rate = ai_benchmark.timed_imgs_per_s(step, x, 2, 0.05, rt)
    assert rate > 0
    assert rt.region.usage()[0]["launches"] >= 2
    rt.close()


def test_share_run_accounts_every_tenant(tmp_path):
    forward, x, batch, param_bytes = share.build_forward(
        "cpu", batch=2, size=32, stage_sizes=(1, 1, 1, 1), num_filters=8)
    assert x.dtype == torch.bfloat16
    res = share.run_share(forward, x, batch, param_bytes, 0.3, 1 << 30,
                          str(tmp_path / "share.cache"), device="cpu")
    assert len(res["per_tenant_img_s"]) == 4
    assert all(r > 0 for r in res["per_tenant_img_s"])
    assert res["violations"] == 0
    region = res["region"]
    assert region["procs"] == 4 and region["pids"] == [1000, 1001, 1002, 1003]
    # every step's input was freed again: what stays is the resident bytes
    assert region["total_bytes"] == region["expected_bytes"]
    assert region["launches"] >= 4


def test_share_quota_rejections_are_counted(tmp_path):
    """A quota that holds the resident bytes and one step's input at a
    time makes the tenants take turns: rejections, no failure."""
    forward, x, batch, param_bytes = share.build_forward(
        "cpu", batch=1, size=32, stage_sizes=(1, 1, 1, 1), num_filters=8)
    input_bytes = x.numel() * x.element_size()
    quota = 4 * (param_bytes + input_bytes) + input_bytes
    res = share.run_share(forward, x, batch, param_bytes, 0.3, quota,
                          str(tmp_path / "tight.cache"), device="cpu")
    assert res["violations"] > 0
    assert sum(r > 0 for r in res["per_tenant_img_s"]) >= 1
    assert res["region"]["total_bytes"] == res["region"]["expected_bytes"]


def test_paced_rate_runs_through_dispatch(tmp_path):
    forward, x, batch, _ = share.build_forward(
        "cpu", batch=1, size=32, stage_sizes=(1, 1, 1, 1), num_filters=8)
    rate = share.paced_rate(forward, x, batch, 0.2, 50,
                            str(tmp_path / "d.cache"), device="cpu")
    assert rate > 0


def test_reference_pacing_probe_keeps_vtpu_rule(tmp_path):
    """``share.ReferencePacing``, the duty probe's second rule, gives the
    duty of vtpu's own runtime on launches that only enqueue; the port's
    runtime on the same loop holds q %."""
    from test_torch_shim_runtime import _async_duty
    from vtpu.shim import ShimRuntime as JaxShimRuntime
    from vtpu_torch.shim import ShimRuntime

    def make(cls, name, **kw):
        def build(clk, q):
            return cls(limits_bytes=[], core_limit=q, uuids=["tpu-0"],
                       region_path=str(tmp_path / f"{name}{q}.cache"),
                       clock=clk, **kw)
        return build

    for q in (30, 50):
        probe = _async_duty(make(share.ReferencePacing, "probe",
                                 device="cpu"), q)
        assert probe == pytest.approx(_async_duty(make(JaxShimRuntime, "ref"),
                                                  q), abs=1e-12)
        assert probe == pytest.approx(min(1.0, q / (100 - q)), abs=0.03)
        port = _async_duty(make(ShimRuntime, "port", device="cpu"), q)
        assert port == pytest.approx(q / 100, abs=0.03)


def test_paced_rate_takes_the_reference_rule(tmp_path):
    forward, x, batch, _ = share.build_forward(
        "cpu", batch=1, size=32, stage_sizes=(1, 1, 1, 1), num_filters=8)
    rate = share.paced_rate(forward, x, batch, 0.2, 50,
                            str(tmp_path / "r.cache"), device="cpu",
                            runtime_cls=share.ReferencePacing)
    assert rate > 0


def test_busy_ms_counts_overlapping_kernels_once():
    """The share arms' idle share: kernels on several streams overlap,
    and each instant of the union counts once (times in us)."""
    from vtpu_torch.utils.devtrace import busy_ms

    kernels = [("a", 0.0, 1000.0), ("b", 500.0, 1500.0),
               ("c", 3000.0, 3500.0), ("d", 3100.0, 3200.0)]
    assert busy_ms(kernels) == pytest.approx(2.0)
    assert busy_ms(list(reversed(kernels))) == pytest.approx(2.0)
    assert busy_ms([]) == 0.0
