"""Device resolution for the port's entry points, and the device layer:
``chip`` (the ``Chip`` record and the provider protocol), ``topology``,
``health`` (region error streaks) and ``nvml`` (``NvmlProvider``, the
GPU provider the unchanged device plugin serves).

Every entry point (``TransformerLM``, ``PagedBatcher``, ``generate``,
``params_from_flax``) takes an explicit ``device`` that defaults to
``"cuda"``.  Nothing falls back to the CPU on its own: a missing card is
an error, and the CPU runs only when the caller asks for it by name (the
CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vtpu_torch: CUDA is not available. The port runs on an NVIDIA "
            "GPU by default; pass device='cpu' explicitly to run its plain "
            "PyTorch path on the CPU."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def reference_numerics() -> None:
    """Full-precision float32 on the card: no TF32 in matrix products or
    convolutions.  Reference and parity runs call this before they
    compare the kernels with their plain versions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
