"""DeepLab-v3-style segmentation (the ai-benchmark DeepLab rows):
``vtpu/models/deeplab.py`` in PyTorch -- a ResNet-V2 backbone at output
stride 16, the ASPP head, dense logits upsampled to the input size.

``forward(x)`` takes NHWC images and returns ``(logits, new_batch_stats)``
with NHWC f32 logits.  The upsampling is ``F.interpolate(mode=
"bilinear", align_corners=False)``: half-pixel centres, as
``jax.image.resize(..., "bilinear")`` uses.  The atrous 3x3 convs at
stride 1 pad symmetrically by their rate (SAME).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vtpu_torch.device import resolve_device
from vtpu_torch.models.layers import (Conv, max_pool_same, nchw,
                                      new_batch_stats, reset_parameters)
from vtpu_torch.models.resnet import BottleneckV2


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (1x1 + three atrous 3x3 + image
    pool), flax's ``Conv_0`` .. ``Conv_5`` in that order."""

    def __init__(self, cin: int, filters: int = 256,
                 rates: Tuple[int, ...] = (6, 12, 18),
                 dtype=torch.bfloat16, device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.n_rates = len(rates)
        self.Conv_0 = Conv(cin, filters, 1, **kw)
        for i, r in enumerate(rates):
            self.add_module(f"Conv_{i + 1}",
                            Conv(cin, filters, 3, dilation=r, **kw))
        self.add_module(f"Conv_{len(rates) + 1}", Conv(cin, filters, 1, **kw))
        self.add_module(f"Conv_{len(rates) + 2}",
                        Conv(filters * (len(rates) + 2), filters, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_rates
        branches = [getattr(self, f"Conv_{i}")(x) for i in range(n + 1)]
        pooled = getattr(self, f"Conv_{n + 1}")(x.mean(dim=(2, 3),
                                                       keepdim=True))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        y = getattr(self, f"Conv_{n + 2}")(torch.cat(branches, dim=1))
        return F.relu(y)


class DeepLabV3(nn.Module):
    def __init__(self, num_classes: int = 21,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_filters: int = 64, dtype=torch.bfloat16, *,
                 device="cuda", generator=None) -> None:
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device="meta")
        self.Conv_0 = Conv(3, num_filters, 7, 2, padding=((3, 3), (3, 3)),
                           bias=False, **kw)
        self.blocks: List[str] = []
        cin = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                # output stride 16: stage 3 keeps stride 1
                stride = 2 if i in (1, 2) and j == 0 else 1
                filters = num_filters * 2 ** i
                name = f"BottleneckV2_{len(self.blocks)}"
                self.add_module(name, BottleneckV2(cin, filters, stride, **kw))
                self.blocks.append(name)
                cin = filters * 4
        self.ASPP_0 = ASPP(cin, **kw)
        self.Conv_1 = Conv(256, num_classes, 1, dtype=torch.float32,
                           device="meta")
        self.to_empty(device=dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor):
        h, w = x.shape[1], x.shape[2]
        stats: List = []
        x = max_pool_same(self.Conv_0(nchw(x)), 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x, stats)
        x = self.Conv_1(self.ASPP_0(x))
        x = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False)
        return x.permute(0, 2, 3, 1).float(), new_batch_stats(self, stats)
