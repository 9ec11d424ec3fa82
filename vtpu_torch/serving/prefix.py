"""Chained block digests: the content address of a prompt prefix.

The port's copy of ``vtpu/serving/prefix.py::chain_digests`` (the port
imports nothing of vtpu).  Digest ``i`` is ``sha256(digest[i-1] ‖ tokens
of block i)``, so one digest names the whole token prefix up to block
``i``: a prefill engine's pool registry, a decode engine's and the wire's
OPEN document all agree on it without shipping tokens.  A chain crosses
between the two packages in the OPEN document, so the digests are byte
for byte the JAX package's (tests/test_torch_prefix.py).

The router's ``PrefixIndex`` comes with the port's copy of the router.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence


def chain_digests(tokens: Sequence[int], block_size: int) -> List[str]:
    """Chained digests (hex) of every full block of ``tokens``: entry
    ``i`` is ``sha256(entry[i-1] ‖ block i's tokens)``, each token as 8
    little-endian signed bytes.  The partial tail block is never
    digested (its K/V keeps being appended to)."""
    if block_size <= 0:
        return []
    out: List[str] = []
    prev = b""
    n = (len(tokens) // block_size) * block_size
    for i in range(0, n, block_size):
        h = hashlib.sha256(prev)
        for t in tokens[i:i + block_size]:
            h.update(int(t).to_bytes(8, "little", signed=True))
        prev = h.digest()
        out.append(prev.hex())
    return out
