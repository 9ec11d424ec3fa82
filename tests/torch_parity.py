"""Shared helpers of the tests that hold ``vtpu_torch`` against ``vtpu``:
the same flax params go into both packages (converted with
``params_from_flax``), and data crosses as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vtpu_torch.models.convert import params_from_flax
from vtpu_torch.models.transformer import TransformerLM as TorchLM

# the knobs both packages share, read off the flax module
KNOBS = ("vocab", "d_model", "depth", "num_heads", "max_seq",
         "num_kv_heads", "pos_embedding", "attn_window", "mlp",
         "n_experts", "moe_top_k", "moe_capacity",
         "kv_cache_dtype", "kv_cache_layout", "kv_block_size",
         "kv_pool_blocks", "paged_kernel")


def jax_params(model, seed: int = 0):
    return model.init(jax.random.PRNGKey(seed),
                      jnp.zeros((1, 4), jnp.int32))["params"]


def port_of(jmodel, params, **override) -> TorchLM:
    """The port's model with ``jmodel``'s knobs and ``params``' weights,
    on the CPU."""
    cfg = {k: getattr(jmodel, k) for k in KNOBS}
    cfg.update(override)
    model = TorchLM(**cfg, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params),
                                           device="cpu"))
    return model


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)
