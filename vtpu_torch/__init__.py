"""vtpu_torch — the PyTorch/CUDA port of vtpu's accelerator paths.

A package beside ``vtpu/`` (the JAX reference, which stays as it is).
It imports ``torch`` and numpy and nothing of ``vtpu``, ``jax`` or
``flax``.  This slice holds the paged serving path:

- ``vtpu_torch.ops``: the Hopper kernels (fused LayerNorm, paged decode
  attention over native and int8 pools, CUDA C++ in ``csrc/`` built by
  ``nvcc`` at first use) and their plain PyTorch versions;
- ``vtpu_torch.models``: ``TransformerLM`` (paged decode path) and
  ``params_from_flax``;
- ``vtpu_torch.serving``: ``PagedBatcher`` and its block pool.

Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``.
"""
