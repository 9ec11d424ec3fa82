"""ResNet-V2 (pre-activation), the ai-benchmark flagship:
``vtpu/models/resnet.py`` in PyTorch.

``forward(x)`` takes NHWC images (the JAX layout) and returns
``(logits, new_batch_stats)`` as ``model.apply(..., mutable=
["batch_stats"])`` does: f32 logits and the updated running statistics
(``vtpu_torch.models.layers``), which the model does not write itself.
Compute is bf16 by default with f32 parameters and an f32 head.
Activations are NCHW in channels_last memory, cuDNN's fast layout.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vtpu_torch.device import resolve_device
from vtpu_torch.models.layers import (BatchNorm, Conv, Dense, max_pool_same,
                                      nchw, new_batch_stats,
                                      reset_parameters)


class BottleneckV2(nn.Module):
    """Pre-activation bottleneck (BN -> ReLU -> conv x3 + identity)."""

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.preact_bn = BatchNorm(cin, **kw)
        self.proj = None
        if cin != filters * 4 or stride != 1:
            self.proj = Conv(cin, filters * 4, 1, stride, bias=False, **kw)
        self.Conv_0 = Conv(cin, filters, 1, bias=False, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, stride, bias=False, **kw)
        self.BatchNorm_1 = BatchNorm(filters, **kw)
        self.Conv_2 = Conv(filters, filters * 4, 1, bias=False, **kw)

    def forward(self, x: torch.Tensor, stats: List) -> torch.Tensor:
        preact = F.relu(self.preact_bn(x, stats))
        shortcut = x if self.proj is None else self.proj(preact)
        y = F.relu(self.BatchNorm_0(self.Conv_0(preact), stats))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), stats))
        return shortcut + self.Conv_2(y)


class ResNetV2(nn.Module):
    """``remat`` recomputes each block's activations in the backward
    (``torch.utils.checkpoint``, flax's ``nn.remat``).  Weights are drawn
    from ``generator`` (default: seed 0 on ``device``) as flax's default
    initializers draw them."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.bfloat16,
                 remat: bool = False, *, device="cuda",
                 generator=None) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.dtype, self.remat = dtype, remat
        kw = dict(dtype=dtype, device="meta")
        self.conv_root = Conv(3, num_filters, 7, 2, padding=((3, 3), (3, 3)),
                              bias=False, **kw)
        self.blocks: List[str] = []
        cin = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                name = f"BottleneckV2_{len(self.blocks)}"
                self.add_module(name, BottleneckV2(cin, filters, stride, **kw))
                self.blocks.append(name)
                cin = filters * 4
        self.final_bn = BatchNorm(cin, **kw)
        self.head = Dense(cin, num_classes, dtype=torch.float32,
                          device="meta")
        self.to_empty(device=dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor):
        stats: List = []
        x = max_pool_same(self.conv_root(nchw(x)), 3, 2)
        for name in self.blocks:
            blk = getattr(self, name)
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, stats, use_reentrant=False)
            else:
                x = blk(x, stats)
        x = F.relu(self.final_bn(x, stats))
        logits = self.head(x.mean(dim=(2, 3)))
        return logits.float(), new_batch_stats(self, stats)


ResNetV2_50 = functools.partial(ResNetV2, stage_sizes=(3, 4, 6, 3))
ResNetV2_101 = functools.partial(ResNetV2, stage_sizes=(3, 4, 23, 3))
ResNetV2_152 = functools.partial(ResNetV2, stage_sizes=(3, 8, 36, 3))
