"""The port's training path against the JAX package's on the CPU: the
full forward (``decode=False``), ``lm_loss``, the gradient of every
parameter, Adam steps against ``optax.adam``, and causality.

Both sides start from the same flax params (``params_from_flax``) and
the same numpy-seeded tokens.  The JAX side is ``model.apply`` +
``lm_loss`` + ``jax.grad`` as its own trainer test runs them; the port
runs its flash and LayerNorm wrappers, whose plain versions (and their
autograd backward) serve CPU tensors.  Tolerances: logits and grads
1e-4 abs, the loss 1e-5, the Adam losses 1e-4 relative (f32, different
summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import jax_params, port_of, to_np
from vtpu.models import transformer as jtf
from vtpu_torch.models import transformer as ttf
from vtpu_torch.models.convert import params_from_flax

TINY = dict(vocab=128, d_model=64, depth=2, num_heads=4, max_seq=64)
CONFIGS = {
    "mha-learned": dict(TINY),
    "gqa-rope-window": dict(TINY, num_kv_heads=2, pos_embedding="rope",
                            attn_window=8),
}
ADAM_STEPS = 3


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """The JAX side's results for one configuration, computed once."""
    jm = jtf.TransformerLM(**CONFIGS[request.param])
    params = jax_params(jm, seed=1)
    tokens = np.random.default_rng(0).integers(
        0, TINY["vocab"], (2, 16)).astype(np.int32)
    jt = jnp.asarray(tokens)

    def loss_fn(p):
        return jtf.lm_loss(jm.apply({"params": p}, jt), jt)

    logits = np.array(jm.apply({"params": params}, jt))
    loss, grads = jax.value_and_grad(loss_fn)(params)
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p, s):
        val, g = jax.value_and_grad(loss_fn)(p)
        upd, s = opt.update(g, s)
        return optax.apply_updates(p, upd), s, val

    p, s, losses = params, opt.init(params), []
    for _ in range(ADAM_STEPS):
        p, s, val = step(p, s)
        losses.append(float(val))
    return dict(jm=jm, params=params, tokens=tokens, logits=logits,
                loss=float(loss), grads=jax.device_get(grads),
                adam_losses=losses)


def _port(case):
    return port_of(case["jm"], case["params"])


def test_full_forward_logits_match_jax(case):
    tm = _port(case)
    got = tm(torch.from_numpy(case["tokens"]), decode=False)
    assert got.dtype == torch.float32 and got.requires_grad
    np.testing.assert_allclose(to_np(got), case["logits"], atol=1e-4,
                               rtol=0)


def test_lm_loss_matches_jax(case):
    logits = torch.from_numpy(case["logits"])
    got = ttf.lm_loss(logits, torch.from_numpy(case["tokens"]))
    want = jtf.lm_loss(jnp.asarray(case["logits"]),
                       jnp.asarray(case["tokens"]))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=0)
    tm = _port(case)
    tok = torch.from_numpy(case["tokens"])
    full = ttf.lm_loss(tm(tok, decode=False), tok)
    np.testing.assert_allclose(full.item(), case["loss"], atol=1e-5, rtol=0)


def test_every_grad_matches_jax(case):
    tm = _port(case)
    tok = torch.from_numpy(case["tokens"])
    ttf.lm_loss(tm(tok, decode=False), tok).backward()
    want = params_from_flax(case["grads"], device="cpu")
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        got = named[name].grad
        assert got is not None, name
        np.testing.assert_allclose(to_np(got), g.numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_adam_steps_match_optax(case):
    """torch.optim.Adam's defaults are optax.adam's (b1 0.9, b2 0.999,
    eps 1e-8 outside the sqrt)."""
    tm = _port(case)
    tok = torch.from_numpy(case["tokens"])
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    losses = []
    for _ in range(ADAM_STEPS):
        opt.zero_grad()
        loss = ttf.lm_loss(tm(tok, decode=False), tok)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, case["adam_losses"], rtol=1e-4,
                               atol=0)
    assert losses[-1] < losses[0]


def test_causality(case):
    """Changing a future token must not change earlier logits."""
    tm = _port(case)
    tok = torch.from_numpy(case["tokens"]).long()
    with torch.no_grad():
        base = tm(tok, decode=False)
        mutated = tok.clone()
        mutated[:, 10] = (mutated[:, 10] + 1) % TINY["vocab"]
        out = tm(mutated, decode=False)
    np.testing.assert_allclose(to_np(base[:, :10]), to_np(out[:, :10]),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(to_np(base[:, 10:]), to_np(out[:, 10:]))


def test_plain_attention_path_matches_the_flash_path(case):
    """flash_kernel="off" (the plain attention through autograd) gives
    the same loss and grads as the flash wrappers' path."""
    tm = _port(case)
    tok = torch.from_numpy(case["tokens"])
    ttf.lm_loss(tm(tok, decode=False), tok).backward()
    flash = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad()
    off = tm.clone(flash_kernel="off", ln_kernel="off")
    ttf.lm_loss(off(tok, decode=False), tok).backward()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(to_np(p.grad), to_np(flash[n]),
                                   atol=1e-5, rtol=0, err_msg=n)
