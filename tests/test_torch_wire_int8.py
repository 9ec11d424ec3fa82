"""The K/V wire handoff across frameworks on the int8 pool, at depth 12:
tests/test_torch_wire.py's cases for a pool whose K/V leaves are int8
with f32 scale leaves, in a file of their own so that each file's JAX
compiles stay within its share of the run.

- JAX prefill -> torch decode and torch prefill -> JAX decode under the
  ``fp32`` codec, over ``LoopbackLink`` and ``HttpKVLink``: transcripts
  equal the monolithic engine's (the port's, held against the JAX
  package's here too), adopted blocks equal the source blocks bit for
  bit, both pools leak-free;
- the layout digest is the same in both packages;
- the same pool contents give the same stream bytes from both packages'
  extracts (fp32, fp8 and int4).
"""

import numpy as np
import pytest
import torch

from test_torch_wire import (
    LINKS,
    build_world,
    check_jax_to_torch,
    check_layout_digest,
    check_torch_to_jax,
)
from vtpu_torch.serving.disagg import PrefillEngine


@pytest.fixture(scope="module")
def world():
    return build_world(["int8"])


def test_monolithic_engines_agree_at_depth_12(world):
    assert world["want"]["int8"] == world["jax_mono"]


@pytest.mark.parametrize("link", LINKS)
def test_jax_prefill_to_torch_decode(world, link):
    check_jax_to_torch(world, "int8", "fp32", link)


@pytest.mark.parametrize("link", LINKS)
def test_torch_prefill_to_jax_decode(world, link):
    check_torch_to_jax(world, "int8", "fp32", link)


def test_layout_digest_equal_across_packages(world):
    check_layout_digest(world, "int8")


def test_extract_bytes_equal_the_jax_extract(world):
    """The same pool contents give the same fp32 stream bytes from both
    packages' extracts (f32 and int8 leaves, 12 layers)."""
    import jax
    import jax.numpy as jnp

    tm = world["tm"]["int8"]
    jpf = world["jpf"]["int8"]
    tpf = PrefillEngine(tm, device="cpu")
    rng = np.random.default_rng(5)
    leaves = tpf.pool_leaves()
    for t in leaves:
        if t.dtype == torch.int8:
            t.copy_(torch.from_numpy(rng.integers(-127, 128, t.shape
                                                  ).astype(np.int8)))
        else:
            t.copy_(torch.from_numpy(rng.random(t.shape, np.float32)))
    treedef = jax.tree_util.tree_structure(jpf.pool_leaves())
    jpf._pools = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(t.numpy()) for t in leaves])  # a fresh pool
    blocks = [7, 3, 11]
    a = jpf.start_extract(blocks).payload(0, 3)
    b = tpf.start_extract(blocks).payload(0, 3)
    assert a == b and len(a) == 3 * sum(
        int(np.prod(t.shape[1:])) * t.element_size() for t in leaves)
    for codec in ("fp8", "int4"):
        # the fp8 and int4 device halves are op-identical across the two
        # packages (the int8 scale may sit one ulp apart under jax.jit)
        assert (jpf.start_extract(blocks, codec).payload(0, 3)
                == tpf.start_extract(blocks, codec).payload(0, 3))
