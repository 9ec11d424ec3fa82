"""vtpu_torch — the PyTorch/CUDA port of vtpu's accelerator paths.

A package beside ``vtpu/`` (the JAX reference, which stays as it is).
It imports ``torch`` and numpy and nothing of ``vtpu``, ``jax`` or
``flax``.  It holds:

- ``vtpu_torch.ops``: the Hopper kernels (fused LayerNorm, paged decode
  attention over native and int8 pools, flash attention forward and
  backward; CUDA C++ in ``csrc/`` built by ``nvcc`` at first use) and
  their plain PyTorch versions;
- ``vtpu_torch.models``: ``TransformerLM`` (paged decode and training
  paths), the ai-benchmark models (ResNet-V2, VGG-16, DeepLab-v3, the
  LSTM classifier) with their registry, and the flax converters;
- ``vtpu_torch.serving``: ``PagedBatcher`` and its block pool;
- ``vtpu_torch.shim``: the cooperative tenant runtime (HBM quota,
  core-percent pacing) over ``vtpu_torch.monitor``'s shared region;
- ``vtpu_torch.bench``: the ai-benchmark rows and the four-tenant share
  run; ``vtpu_torch.entry``: the flagship forward.

Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``.
"""
