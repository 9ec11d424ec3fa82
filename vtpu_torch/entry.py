"""The port's twin of ``__graft_entry__.entry()``, for
PyTorch.

``entry()`` returns ``(forward, example_args)``: an inference step on
the flagship model (ResNet-V2-50, the ai-benchmark headline row, seeded
random weights) and its example input, NHWC f32 images at batch 8,
224^2.  ``forward(images)`` returns the f32 logits ``[8, 1000]``.
"""

from __future__ import annotations

import torch

from vtpu_torch.device import resolve_device
from vtpu_torch.models.resnet import ResNetV2_50


def entry(device="cuda"):
    dev = resolve_device(device)
    model = ResNetV2_50(num_classes=1000, device=dev)
    example = torch.ones((8, 224, 224, 3), dtype=torch.float32, device=dev)

    def forward(images):
        logits, _ = model(images)
        return logits

    return forward, (example,)
