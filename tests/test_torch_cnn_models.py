"""The port's ai-benchmark models against the JAX package's on the CPU.

The same weights -- every leaf of the flax tree drawn with numpy from a
seed -- go through flax (``model.apply(..., mutable=["batch_stats"])``)
and, converted by ``cnn_params_from_flax``, through the port's model on
``device="cpu"``.  Tolerances, against the largest magnitude of the
reference: in f32, logits within 2e-5 and the updated batch statistics
within 1e-5 (the two frameworks sum the convolutions and the batch
moments in other orders); in bf16 (the models' default compute type),
where the two round at other places, cosine similarity >= 0.999 for the
logits and the statistics.  ResNet runs at 64^2, where every stride-2
SAME window pads (0, 1), and at 66^2, where the stride-2 3x3 conv pads
(1, 1) at 17^2 and the root max pool (1, 1) at 33^2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import registry as jreg
from vtpu.models.deeplab import DeepLabV3 as JDeepLab
from vtpu.models.lstm import LSTMClassifier as JLSTM
from vtpu.models.resnet import ResNetV2 as JResNet
from vtpu.models.vgg import VGG16 as JVGG
from vtpu_torch.models import registry as treg
from vtpu_torch.models.convert import cnn_params_from_flax, params_from_flax
from vtpu_torch.models.deeplab import DeepLabV3
from vtpu_torch.models.layers import BatchNorm, load_batch_stats, same_pads
from vtpu_torch.models.lstm import LSTMClassifier
from vtpu_torch.models.resnet import ResNetV2
from vtpu_torch.models.vgg import VGG16

TOL_LOGITS, TOL_STATS, MIN_COSINE = 2e-5, 1e-5, 0.999


def seeded_variables(jmodel, x, seed=0):
    """The flax variable tree of ``jmodel`` with every leaf drawn by
    numpy: kernels N(0, 1/fan_in), biases and BN offsets small, BN
    scales near 1, running variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "embedding":
            v = rng.standard_normal(shape)
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def cosine(got, want) -> float:
    a = np.asarray(got.detach().double().numpy()).ravel()
    b = np.asarray(want, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def flax_run(jmodel, variables, x):
    logits, upd = jmodel.apply(variables, jnp.asarray(x),
                               mutable=["batch_stats"])
    return np.asarray(logits, np.float32), jax.device_get(upd)


def port_run(tmodel, variables, x):
    tmodel.load_state_dict(cnn_params_from_flax(jax.device_get(variables),
                                                device="cpu"))
    with torch.no_grad():
        logits, stats = tmodel(torch.from_numpy(np.asarray(x)))
    return logits, stats


def check(jmodel, tmodel, x, f32: bool):
    variables = seeded_variables(jmodel, x)
    want, upd = flax_run(jmodel, variables, x)
    got, stats = port_run(tmodel, variables, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    want_stats = cnn_params_from_flax(upd, device="cpu")
    assert set(stats) == set(want_stats)
    if f32:
        assert rel_err(got, want) <= TOL_LOGITS
        for k, v in want_stats.items():
            assert rel_err(stats[k], v.numpy()) <= TOL_STATS, k
    else:
        assert cosine(got, want) >= MIN_COSINE
        for k, v in want_stats.items():
            assert cosine(stats[k], v.numpy()) >= MIN_COSINE, k
    return got, stats


def images(size, batch=2, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def test_same_pads_match_flax():
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(17, 3, 2) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)
    assert same_pads(4, 3, 1, dilation=18) == (18, 18)
    from jax import lax

    for n, k, s, d in [(112, 3, 2, 1), (33, 3, 2, 1), (64, 1, 2, 1),
                       (16, 3, 1, 6), (7, 3, 2, 1)]:
        want = lax.padtype_to_pads((n,), ((k - 1) * d + 1,), (s,), "SAME")
        assert same_pads(n, k, s, d) == tuple(want[0])


RESNET = dict(stage_sizes=(1, 1, 1, 1), num_filters=16, num_classes=10)


@pytest.mark.parametrize("size", [64, 66])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_resnet_matches_flax(size, f32):
    dt = dict(dtype=jnp.float32) if f32 else {}
    tdt = dict(dtype=torch.float32) if f32 else {}
    check(JResNet(**RESNET, **dt), ResNetV2(**RESNET, **tdt, device="cpu"),
          images(size), f32)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_vgg_matches_flax(f32):
    cfg = ((8, 1), (16, 2))
    dt = dict(dtype=jnp.float32) if f32 else {}
    tdt = dict(dtype=torch.float32) if f32 else {}
    got, stats = check(JVGG(cfg=cfg, num_classes=10, **dt),
                       VGG16(cfg=cfg, num_classes=10, image=32, **tdt,
                             device="cpu"), images(32), f32)
    assert stats == {}


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_deeplab_matches_flax(f32):
    kw = dict(stage_sizes=(1, 1, 1, 1), num_filters=16, num_classes=5)
    dt = dict(dtype=jnp.float32) if f32 else {}
    tdt = dict(dtype=torch.float32) if f32 else {}
    got, _ = check(JDeepLab(**kw, **dt), DeepLabV3(**kw, **tdt, device="cpu"),
                   images(64, batch=1), f32)
    assert tuple(got.shape) == (1, 64, 64, 5)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_lstm_matches_flax(f32):
    kw = dict(hidden=32, vocab=100, embed=16)
    dt = dict(dtype=jnp.float32) if f32 else {}
    tdt = dict(dtype=torch.float32) if f32 else {}
    tokens = np.random.default_rng(2).integers(0, 100, (3, 12)).astype(
        np.int32)
    got, stats = check(JLSTM(**kw, **dt),
                       LSTMClassifier(**kw, **tdt, device="cpu"), tokens, f32)
    assert tuple(got.shape) == (3, 2) and stats == {}


def test_upsampling_is_jax_bilinear():
    """``F.interpolate(bilinear, align_corners=False)`` is
    ``jax.image.resize(bilinear)`` when upsampling (x16, x4, x3)."""
    x = np.random.default_rng(3).standard_normal((1, 4, 5, 3)).astype(
        np.float32)
    for h, w in [(64, 80), (16, 20), (12, 15)]:
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, h, w, 3),
                                           "bilinear"))
        got = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(h, w),
            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        assert np.abs(got.numpy() - want).max() <= 1e-6


def test_vgg_flattens_nhwc():
    """The first dense layer sees the feature map in flax's (H, W, C)
    order: permuting its rows to a (C, H, W) flatten changes the logits."""
    cfg = ((4, 1),)
    jm = JVGG(cfg=cfg, num_classes=3, dtype=jnp.float32)
    x = images(8)
    variables = seeded_variables(jm, x)
    want, _ = flax_run(jm, variables, x)
    tm = VGG16(cfg=cfg, num_classes=3, image=8, dtype=torch.float32,
               device="cpu")
    got, _ = port_run(tm, variables, x)
    assert rel_err(got, want) <= TOL_LOGITS
    sd = cnn_params_from_flax(jax.device_get(variables), device="cpu")
    w = sd["Dense_0.weight"].reshape(-1, 4, 4, 4)  # [out, H, W, C]
    sd["Dense_0.weight"] = w.permute(0, 3, 1, 2).reshape(w.shape[0], -1)
    tm.load_state_dict(sd)
    with torch.no_grad():
        chw, _ = tm(torch.from_numpy(x))
    assert rel_err(chw, want) > 1e-2


def test_batch_stats_train_loop_matches_flax():
    """Two forwards whose updated statistics are written back (the
    training loop's ``updates``): the second's statistics follow the
    first's, as flax's do."""
    jm = JResNet(**RESNET, dtype=jnp.float32)
    tm = ResNetV2(**RESNET, dtype=torch.float32, device="cpu")
    x1, x2 = images(64, seed=4), images(64, seed=5)
    variables = seeded_variables(jm, x1)
    _, upd = flax_run(jm, variables, x1)
    _, upd = flax_run(jm, {"params": variables["params"], **upd}, x2)
    _, stats = port_run(tm, variables, x1)
    load_batch_stats(tm, stats)
    with torch.no_grad():
        _, stats = tm(torch.from_numpy(x2))
    for k, v in cnn_params_from_flax(upd, device="cpu").items():
        assert rel_err(stats[k], v.numpy()) <= TOL_STATS, k


def test_remat_gives_the_same_logits_and_grads():
    torch.manual_seed(0)
    a = ResNetV2(**RESNET, dtype=torch.float32, device="cpu")
    b = ResNetV2(**RESNET, dtype=torch.float32, remat=True, device="cpu")
    b.load_state_dict(a.state_dict())
    x = torch.from_numpy(images(32))
    grads = []
    for m in (a, b):
        logits, stats = m(x)
        logits.square().sum().backward()
        grads.append([p.grad for p in m.parameters()])
        n_bn = sum(isinstance(mod, BatchNorm) for mod in m.modules())
        assert len(stats) == 2 * n_bn  # a mean and a var each, once
    for ga, gb in zip(*grads):
        assert torch.allclose(ga, gb, rtol=1e-5, atol=1e-6)


def test_transformer_registry_row_matches_flax():
    """The registry's "transformer" row (the JAX defaults: d 512, 8
    heads, vocab 32000) at depth 2 and b 1 x s 128 (the row's s is 512;
    cut for the CPU), full forward, f32: logits within 1e-4 abs, the
    tolerance of tests/test_torch_train.py."""
    jm, jshape, jdt = jreg.create_model("transformer", depth=2)
    tm, tshape, tdt = treg.create_model("transformer", depth=2,
                                        device="cpu")
    assert jshape(8) == tshape(8) == (8, 512)
    assert tdt == torch.int32 and jdt == jnp.int32
    tokens = np.random.default_rng(6).integers(0, 32000, (1, 128)).astype(
        np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))[
        "params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    tm.load_state_dict(params_from_flax(jax.device_get(params),
                                        device="cpu"))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), decode=False)
    assert np.abs(got.numpy() - want).max() <= 1e-4


# -- registry (the twin of tests/test_models.py's registry cases) ----------


def test_registry_names_shapes_and_dtypes_match():
    assert set(treg.MODELS) == set(jreg.MODELS)
    for name, (_, shape_fn, in_dtype) in treg.MODELS.items():
        _, jshape_fn, jdtype = jreg.MODELS[name]
        assert shape_fn(3) == jshape_fn(3), name
        assert str(in_dtype).split(".")[-1] == jnp.dtype(jdtype).name, name


def test_registry_rejects_unknown():
    with pytest.raises(KeyError):
        treg.create_model("alexnet")


@pytest.mark.parametrize("name", ["resnet50", "vgg16", "lstm"])
def test_model_forward_shapes(name):
    # tiny spatial dims for CPU test speed (VGG's dense width follows)
    kw = dict(image=64) if name == "vgg16" else {}
    model, shape_fn, in_dtype = treg.create_model(name, device="cpu", **kw)
    if len(shape_fn(2)) == 4:
        x = torch.ones((2, 64, 64, 3), dtype=in_dtype)
    else:
        x = torch.zeros((2, 16), dtype=in_dtype)
    with torch.no_grad():
        logits, _ = model(x)
    assert logits.shape[0] == 2 and logits.ndim == 2
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


def test_deeplab_dense_output():
    model, _, _ = treg.create_model("deeplab", num_classes=11, device="cpu")
    with torch.no_grad():
        out, _ = model(torch.ones((1, 64, 64, 3)))
    assert out.shape == (1, 64, 64, 11)


def test_resnet152_depth():
    from vtpu_torch.models.resnet import ResNetV2_152

    m = ResNetV2_152(num_classes=10, device="cpu")
    assert len(m.blocks) == 3 + 8 + 36 + 3


def test_entry_returns_logits_of_the_flagship():
    from vtpu_torch.entry import entry

    forward, (example,) = entry(device="cpu")
    assert tuple(example.shape) == (8, 224, 224, 3)
    assert example.dtype == torch.float32
    with torch.no_grad():
        logits = forward(example)
    assert tuple(logits.shape) == (8, 1000)
    assert bool(torch.isfinite(logits).all())


def test_batch_variance_does_not_cancel():
    """The port's one deliberate divergence in the batch statistics: on
    activations whose spread is tiny against their mean (a constant
    image after the root conv), flax's E[x^2] - E[x]^2 cancels in f32
    (here to 0 or to rounding noise), while the port's batch variance
    (``native_batch_norm``: two passes) stays within 1e-3 of the float64
    value.  On activations of comparable mean and spread the two agree
    (the parity tests above)."""
    import flax.linen as fnn

    x = (3.0 + 1e-3 * np.random.default_rng(8).standard_normal(
        (2, 40, 40, 8))).astype(np.float32)
    truth = x.astype(np.float64).var(axis=(0, 1, 2))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.0,
                        dtype=jnp.float32)
    variables = jbn.init(jax.random.PRNGKey(0), x)
    _, upd = jbn.apply(variables, x, mutable=["batch_stats"])
    flax_var = np.asarray(upd["batch_stats"]["var"], np.float64)
    bn = BatchNorm(8, dtype=torch.float32, device="cpu")
    bn.reset_parameters()
    stats = []
    bn(torch.from_numpy(x).permute(0, 3, 1, 2), stats)
    port_var = (stats[0][2].double() ** -2 - 1e-5).numpy()
    assert np.abs(port_var / truth - 1).max() <= 1e-3
    assert np.abs(flax_var / truth - 1).max() >= 0.1


def test_lstm_weights_are_one_buffer_kept_until_a_step():
    """The LSTM's bf16 weights are views of one buffer in cuDNN's order;
    without autograd the same buffer serves every call until a parameter
    changes, with autograd a fresh one carries the gradients back."""
    model = LSTMClassifier(hidden=8, vocab=20, embed=4, device="cpu")
    cell = model.OptimizedLSTMCell_0
    params = [cell.weight_ih_l0, cell.weight_hh_l0, cell.bias_ih_l0,
              cell.bias_hh_l0]
    with torch.no_grad():
        views = model._weights()
        assert model._weights() is views
    base = views[0].data_ptr()
    assert [v.data_ptr() - base for v in views] == [
        2 * sum(p.numel() for p in params[:i]) for i in range(4)]
    assert all(v.dtype == torch.bfloat16 and v.shape == p.shape
               for v, p in zip(views, params))
    tokens = torch.randint(0, 20, (2, 5))
    model(tokens)[0].sum().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in params[:2])
    with torch.no_grad():
        cell.weight_hh_l0.add_(1.0)
        fresh = model._weights()
    assert fresh is not views
    assert torch.equal(fresh[1], cell.weight_hh_l0.bfloat16())
