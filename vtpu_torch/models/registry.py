"""Model registry keyed by the ai-benchmark test names:
``vtpu/models/registry.py`` for the port, with the same names, input
shapes (NHWC images, token ids) and input dtypes."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from vtpu_torch.models.deeplab import DeepLabV3
from vtpu_torch.models.lstm import LSTMClassifier
from vtpu_torch.models.resnet import ResNetV2_50, ResNetV2_101, ResNetV2_152
from vtpu_torch.models.transformer import TransformerLM
from vtpu_torch.models.vgg import VGG16

# name -> (ctor, example input shape fn(batch), input dtype)
MODELS: Dict[str, Tuple[Callable, Callable[[int], tuple], Any]] = {
    "resnet50": (ResNetV2_50, lambda b: (b, 346, 346, 3), torch.float32),
    "resnet101": (ResNetV2_101, lambda b: (b, 256, 256, 3), torch.float32),
    "resnet152": (ResNetV2_152, lambda b: (b, 256, 256, 3), torch.float32),
    "vgg16": (VGG16, lambda b: (b, 224, 224, 3), torch.float32),
    "deeplab": (DeepLabV3, lambda b: (b, 512, 512, 3), torch.float32),
    "lstm": (LSTMClassifier, lambda b: (b, 300), torch.int32),
    "transformer": (TransformerLM, lambda b: (b, 512), torch.int32),
}


def create_model(name: str, **kwargs):
    """``(model, shape_fn, in_dtype)``; ``kwargs`` go to the model's
    constructor (``device`` defaults to ``"cuda"`` there)."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    ctor, shape_fn, in_dtype = MODELS[name]
    return ctor(**kwargs), shape_fn, in_dtype
