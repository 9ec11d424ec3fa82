"""VGG-16 (the ai-benchmark VGG-16 rows): ``vtpu/models/vgg.py`` in
PyTorch.  ``forward(x)`` takes NHWC images and returns ``(logits, {})``
(the model has no batch statistics), as ``model.apply(...,
mutable=["batch_stats"])`` does.

flax flattens the last feature map in NHWC order (H, W, C); a torch
flatten of NCHW would order it (C, H, W) and scramble the first dense
layer's inputs.  The feature map is channels_last, so its NHWC permute
is a view and the flatten keeps flax's order: ``Dense_0.weight`` is the
flax kernel transposed, with no permutation of its rows.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vtpu_torch.device import resolve_device
from vtpu_torch.models.layers import Conv, Dense, nchw, reset_parameters

# (filters, n_convs) per stage: configuration D
_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16(nn.Module):
    """``image`` is the input's side (224 for the registry's rows): the
    first dense layer's width depends on it, where flax reads it from the
    input at init."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 cfg: Sequence = _CFG, image: int = 224, *, device="cuda",
                 generator=None) -> None:
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device="meta")
        self.n_convs = [n for _, n in cfg]
        cin, i = 3, 0
        for filters, n in cfg:
            for _ in range(n):
                self.add_module(f"Conv_{i}", Conv(cin, filters, 3, **kw))
                cin, i = filters, i + 1
            image //= 2
        self.Dense_0 = Dense(image * image * cin, 4096, **kw)
        self.Dense_1 = Dense(4096, 4096, **kw)
        self.Dense_2 = Dense(4096, num_classes, dtype=torch.float32,
                             device="meta")
        self.to_empty(device=dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor):
        x, i = nchw(x), 0
        for n in self.n_convs:
            for _ in range(n):
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x).float(), {}
