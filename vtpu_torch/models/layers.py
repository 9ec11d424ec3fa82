"""flax's convolution, dense and batch-norm layers as the ai-benchmark
models use them, in PyTorch.

The models take and return the JAX package's NHWC layout; inside, an
activation is an NCHW tensor in ``torch.channels_last`` memory (the
permuted view of an NHWC tensor is one, at no copy), which cuDNN keeps
through its convolutions.

Semantics held to flax:

- ``padding="SAME"``: out = ceil(n / stride); the pad total
  max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0) is split
  (total // 2, total - total // 2).  A 3x3 stride-2 window on an even
  input pads (0, 1), where torch's ``padding=1`` pads (1, 1) and shifts
  every window: the asymmetric case is padded explicitly.  A max pool
  pads with -inf.
- ``dtype`` is the compute type: inputs, kernels and biases are cast to
  it before the product (flax's ``promote_dtype``); parameters stay in
  their own type (f32).
- BatchNorm in training mode (``use_running_average=False``): the batch
  statistics in f32 (also under a bf16 ``dtype``), normalised with the
  BIASED variance, ``(x - mean) * rsqrt(var + eps) * scale + bias`` in
  f32, rounded once to ``dtype``.  The running statistics are returned,
  not written: ``mean <- 0.99 mean + 0.01 batch_mean`` and the same for
  ``var`` with the biased batch variance (torch's BatchNorm would use
  the unbiased one and momentum 0.1).

Module names follow flax's (``Conv_0``, ``BatchNorm_1``, ``Dense_2``,
explicit names where the flax module sets one), so a flax tree maps onto
a state dict by path (``vtpu_torch.models.convert.cnn_params_from_flax``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vtpu_torch.parallel.comm import all_reduce_sum

BN_MOMENTUM = 0.99
BN_EPS = 1e-5
_TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


def same_pads(n: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dim: (low, high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` on an NCHW (channels_last) activation.  ``weight``
    is OIHW, the flax kernel (HWIO) transposed; ``padding`` is
    ``"SAME"``, ``"VALID"`` or ((lo, hi), (lo, hi))."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 dilation: int = 1, bias: bool = True,
                 dtype=torch.bfloat16, device=None) -> None:
        super().__init__()
        self.k, self.stride, self.dilation = kernel, stride, dilation
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(cout, device=device))
                     if bias else None)

    def reset_parameters(self, generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _pads(self, h: int, w: int):
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if self.padding == "SAME":
            return (same_pads(h, self.k, self.stride, self.dilation),
                    same_pads(w, self.k, self.stride, self.dilation))
        return tuple(self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        (ph0, ph1), (pw0, pw1) = self._pads(x.shape[2], x.shape[3])
        if ph0 == ph1 and pw0 == pw1:
            pad = (ph0, pw0)
        else:
            x = F.pad(x, (pw0, pw1, ph0, ph1))
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride,
                        pad, self.dilation)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is ``[out, in]`` (the flax kernel
    transposed), computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def reset_parameters(self, generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=False)`` over the channel
    dim.  ``forward(x, stats)`` appends ``(self, batch mean, batch
    invstd)`` to ``stats``, a list the model's forward owns (so one model
    serves several threads), from which :func:`new_batch_stats` makes
    the running statistics flax returns."""

    def __init__(self, c: int, dtype=torch.bfloat16, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.sync_group = None
        self.scale = nn.Parameter(torch.empty(c, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.register_buffer("mean", torch.empty(c, device=device))
        self.register_buffer("var", torch.empty(c, device=device))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.mean)
        nn.init.ones_(self.var)

    def forward(self, x: torch.Tensor, stats: List) -> torch.Tensor:
        if self.sync_group is not None:
            return self._synced(x, stats)
        # statistics and the affine map in f32 (the accumulate type of
        # a bf16 input), one rounding to x's type at the end
        y, mean, invstd = torch.native_batch_norm(
            x.to(self.dtype), self.scale, self.bias, None, None, True, 0.0,
            BN_EPS)
        stats.append((self, mean, invstd))
        return y

    def _synced(self, x: torch.Tensor, stats: List) -> torch.Tensor:
        """The same arithmetic over the group's whole batch: two passes
        of all-reduced per-channel sums (differentiable)."""
        xf = x.to(self.dtype).float()
        dims = [0] + list(range(2, xf.dim()))
        view = [1, -1] + [1] * (xf.dim() - 2)
        n = xf.numel() // xf.shape[1] * dist.get_world_size(self.sync_group)
        mean = all_reduce_sum(xf.sum(dims), self.sync_group) / n
        xc = xf - mean.view(view)
        var = all_reduce_sum((xc * xc).sum(dims), self.sync_group) / n
        invstd = torch.rsqrt(var + BN_EPS)
        y = xc * invstd.view(view) * self.scale.view(view) \
            + self.bias.view(view)
        stats.append((self, mean, invstd))
        return y.to(self.dtype)


def reset_parameters(model: nn.Module, generator) -> None:
    for m in model.modules():
        if isinstance(m, (Conv, Dense, BatchNorm)):
            m.reset_parameters(generator)


@torch.no_grad()
def new_batch_stats(model: nn.Module, stats: List) -> Dict[str, torch.Tensor]:
    """flax's updated ``batch_stats`` for one forward, keyed by buffer
    name (``"BottleneckV2_0.preact_bn.mean"``): one concatenation for all
    the layers, so the update costs a few launches, not a few a layer."""
    if not stats:
        return {}
    names = {id(m): n for n, m in model.named_modules()}
    batch_mean = torch.cat([m for _, m, _ in stats])
    dt = batch_mean.dtype  # f32, or f64 for an f64 model
    # the kernel returns 1 / sqrt(var + eps); flax keeps the biased var
    batch_var = torch.cat([s for _, _, s in stats]).pow(-2) - BN_EPS
    old_mean = torch.cat([bn.mean for bn, _, _ in stats]).to(dt)
    old_var = torch.cat([bn.var for bn, _, _ in stats]).to(dt)
    mean = BN_MOMENTUM * old_mean + (1 - BN_MOMENTUM) * batch_mean
    var = BN_MOMENTUM * old_var + (1 - BN_MOMENTUM) * batch_var
    sizes = [bn.mean.numel() for bn, _, _ in stats]
    out = {}
    for (bn, _, _), m, v in zip(stats, mean.split(sizes), var.split(sizes)):
        out[f"{names[id(bn)]}.mean"] = m
        out[f"{names[id(bn)]}.var"] = v
    return out


@torch.no_grad()
def load_batch_stats(model: nn.Module, stats: Dict[str, torch.Tensor]) -> None:
    """Write the running statistics a forward returned into the model's
    buffers (what a training loop does with flax's ``updates``)."""
    for name, value in stats.items():
        model.get_buffer(name).copy_(value)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (stride, stride), padding="SAME")``: pads
    with -inf, split as flax splits it."""
    (h0, h1), (w0, w1) = (same_pads(x.shape[2], k, stride),
                          same_pads(x.shape[3], k, stride))
    if h0 == h1 and w0 == w1:
        return F.max_pool2d(x, k, stride, (h0, w0))
    x = F.pad(x, (w0, w1, h0, h1), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC input as the NCHW channels_last view the layers take."""
    return x.permute(0, 3, 1, 2)
