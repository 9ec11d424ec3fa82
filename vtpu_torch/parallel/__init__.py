"""Multi-device parallelism for the port: ``vtpu/parallel`` in PyTorch.

A world of ranks (one device a rank, ``distributed``) is laid out as a
``DeviceMesh`` from a gang rectangle (``mesh``); over it run data x
tensor parallel train steps (``sharding``), ring and Ulysses attention
(sequence parallelism), the GPipe pipeline and the expert-parallel MoE
FFN.  The collectives carry gradients (``comm``).  Each function runs in
every rank on that rank's shards, as a ``shard_map`` body does.
"""

from vtpu_torch.parallel.mesh import mesh_from_rectangle, make_mesh  # noqa: F401
from vtpu_torch.parallel.ring import (  # noqa: F401
    ring_attention,
    stripe_sequence,
    unstripe_sequence,
)
