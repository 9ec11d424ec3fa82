"""Load flax parameter trees into the port's models:
:func:`params_from_flax` for ``TransformerLM``, :func:`cnn_params_from_flax`
for the ai-benchmark models (ResNet-V2, VGG-16, DeepLab-v3, the LSTM
classifier).

The tree comes as nested dicts of numpy arrays (``jax.device_get`` of
the flax params, or any arrays ``np.asarray`` accepts); nothing here
imports JAX.  Module names map one to one: ``wte``, ``wpe``,
``h{i}/attn/{qkv | q, kv, out}``, ``h{i}/ln{1,2}/{scale,bias}``,
``h{i}/mlp_in``, ``h{i}/mlp_out``, ``ln_f``, ``lm_head``.  A flax Dense
``kernel`` is ``[in, out]``; the port's ``nn.Linear.weight`` is
``[out, in]``, so every kernel is TRANSPOSED on the way in.  ``mlp_in``
and ``mlp_out`` carry biases; ``qkv``/``q``/``kv``/``out``/``lm_head``
do not.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vtpu_torch.device import resolve_device


def _tensor(arr, transpose: bool, device, dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy path
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        t = t.to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))
    if transpose:
        t = t.t().contiguous()
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_flax(params, *, device="cuda",
                     dtype=None) -> Dict[str, torch.Tensor]:
    """The port's state dict (``TransformerLM.load_state_dict``) for a
    flax params tree; ``dtype`` casts every tensor when given."""
    dev = resolve_device(device)
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr, transpose=False):
        sd[name] = _tensor(arr, transpose, dev, dtype)

    put("wte.weight", params["wte"]["embedding"])
    if "wpe" in params:
        put("wpe.weight", params["wpe"]["embedding"])
    i = 0
    while f"h{i}" in params:
        blk, pre = params[f"h{i}"], f"h.{i}."
        if "moe" in blk:
            raise NotImplementedError(
                "MoE blocks come with the parallel slice of the port")
        for proj in ("qkv", "q", "kv", "out"):
            if proj in blk["attn"]:
                put(f"{pre}attn.{proj}.weight", blk["attn"][proj]["kernel"],
                    transpose=True)
        for ln in ("ln1", "ln2"):
            put(f"{pre}{ln}.scale", blk[ln]["scale"])
            put(f"{pre}{ln}.bias", blk[ln]["bias"])
        for lin in ("mlp_in", "mlp_out"):
            put(f"{pre}{lin}.weight", blk[lin]["kernel"], transpose=True)
            put(f"{pre}{lin}.bias", blk[lin]["bias"])
        i += 1
    put("ln_f.scale", params["ln_f"]["scale"])
    put("ln_f.bias", params["ln_f"]["bias"])
    put("lm_head.weight", params["lm_head"]["kernel"], transpose=True)
    return sd


def _lstm_params(cell, name: str, put) -> None:
    """flax ``OptimizedLSTMCell`` -> ``nn.LSTM``: the gate kernels in
    torch's order (i, f, g, o) concatenated and transposed; flax's one
    bias (on the hidden kernels) as ``bias_ih_l0``, ``bias_hh_l0`` = 0."""
    gates = "ifgo"
    w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"], np.float32)
                           for g in gates], axis=-1)
    w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"], np.float32)
                           for g in gates], axis=-1)
    b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"], np.float32)
                        for g in gates])
    put(f"{name}.weight_ih_l0", w_ih, transpose=True)
    put(f"{name}.weight_hh_l0", w_hh, transpose=True)
    put(f"{name}.bias_ih_l0", b)
    put(f"{name}.bias_hh_l0", np.zeros_like(b))


def cnn_params_from_flax(variables, *, device="cuda",
                         dtype=None) -> Dict[str, torch.Tensor]:
    """The state dict of an ai-benchmark model for flax ``variables``
    (``{"params": ..., "batch_stats": ...}`` as numpy arrays).  The port's
    module names are flax's, so a path maps to a name; leaves map as

    - a conv ``kernel`` (HWIO) -> ``weight`` (OIHW);
    - a Dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]``;
    - ``embedding`` -> ``weight``; BatchNorm ``scale``, ``bias``,
      ``mean``, ``var`` and biases keep their names;
    - an ``OptimizedLSTMCell`` subtree -> ``nn.LSTM``'s four tensors.

    A ``batch_stats`` tree alone (a forward's updated statistics) gives
    the buffer entries only."""
    dev = resolve_device(device)
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr, transpose=False):
        sd[name] = _tensor(arr, transpose, dev, dtype)

    def walk(tree, path):
        for key, sub in tree.items():
            name = f"{path}.{key}" if path else key
            if key.startswith("OptimizedLSTMCell"):
                _lstm_params(sub, name, put)
            elif isinstance(sub, dict):
                walk(sub, name)
            elif key == "kernel" and np.ndim(sub) == 4:
                w = np.transpose(np.asarray(sub), (3, 2, 0, 1))
                put(f"{path}.weight", w)
            elif key == "kernel":
                put(f"{path}.weight", sub, transpose=True)
            elif key == "embedding":
                put(f"{path}.weight", sub)
            else:
                put(name, sub)

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), "")
    return sd
