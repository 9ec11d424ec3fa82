"""On-disk prefix persistence: the third tier of the K/V memory hierarchy.

The port's copy of ``vtpu/serving/kvpersist.py::PrefixStore`` (the port
imports nothing of vtpu), with its own copy of the part of
``vtpu/obs/jsonl.py::RotatingJsonlSink`` it uses.  A prefill engine's
host spill tier dies with the process; the store journals each demoted
run (digest chain and quantized payload) to local disk, so a restarted
engine rehydrates its host tier instead of recomputing.  The journal is
byte-compatible with the JAX package's: a journal written by either
package's ``PrefillEngine`` rehydrates the other's.

Two files per store directory:

- ``prefix_index.jsonl``: one JSON record a journaled run (digest
  chain, codec, segment offset and length, payload crc32, block size,
  the pool-layout signature), appended best-effort: the first OSError
  turns persistence off with one warning, never crashes the engine;
- ``prefix_segments.bin``: the payloads, each behind a ``<u32 len, u32
  crc32>`` header, so a torn tail is detected, not read.

When the segment file would pass the byte cap
(``VTPU_KV_PERSIST_MAX_BYTES``) both files rename to ``.1`` together.
Loading is strict: a record that does not parse, points past its
segment file, disagrees with the segment header, fails its crc, or
carries a foreign signature is skipped; the last record a deepest
digest wins.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import zlib
from typing import Iterator, List, Sequence, Tuple

from vtpu_torch.utils.envs import env_int

log = logging.getLogger(__name__)

INDEX_NAME = "prefix_index.jsonl"
SEGMENTS_NAME = "prefix_segments.bin"
_SEG_HEADER = struct.Struct("<II")  # payload length, crc32

DEFAULT_PERSIST_MAX_BYTES = env_int("VTPU_KV_PERSIST_MAX_BYTES", 1 << 30)


class _JsonlSink:
    """Append-only JSONL file (``RotatingJsonlSink`` without rotation,
    which the store drives itself): every write is one line, flushed;
    the first OSError turns the sink off with one warning."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._fh = None
        self._dead = False

    @property
    def dead(self) -> bool:
        return self._dead

    def write(self, rec: dict) -> None:
        """Append one record as a JSON line (best-effort; never raises)."""
        if self._dead:
            return
        line = json.dumps(rec, default=str) + "\n"
        with self._lock:
            try:
                if self._fh is None:
                    self._fh = open(self.path, "a", encoding="utf-8")
                self._fh.write(line)
                self._fh.flush()
            except OSError:
                self._dead = True
                log.warning("JSONL sink %s failed; disabling mirror",
                            self.path, exc_info=True)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


class PrefixStore:
    """Durable journal of demoted prefix runs for one prefill engine.

    ``sig`` is the owning pool's layout signature (leaf shapes and dtypes
    and block size, hashed by the engine): ``load`` drops records of
    another signature, so a journal of another model or pool geometry
    never scatters into this one.  ``append`` never raises."""

    def __init__(self, path: str, sig: str = "",
                 max_bytes: int = 0) -> None:
        self.dir = path
        self.sig = str(sig)
        self.max_bytes = int(max_bytes) or DEFAULT_PERSIST_MAX_BYTES
        self._lock = threading.Lock()
        self._dead = False
        self.blocks_journaled = 0  # blocks' worth of valid records
        os.makedirs(path, exist_ok=True)
        self._index_path = os.path.join(path, INDEX_NAME)
        self._seg_path = os.path.join(path, SEGMENTS_NAME)
        self._sink = _JsonlSink(self._index_path)

    @property
    def dead(self) -> bool:
        return self._dead or self._sink.dead

    # -- write path ------------------------------------------------------
    def append(self, chain: Sequence[str], payload: bytes, codec: str,
               block_size: int) -> None:
        """Journal one demoted run (best-effort; never raises)."""
        if self.dead or not chain:
            return
        payload = bytes(payload)
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        with self._lock:
            try:
                size = (os.path.getsize(self._seg_path)
                        if os.path.exists(self._seg_path) else 0)
                need = _SEG_HEADER.size + len(payload)
                if size > 0 and size + need > self.max_bytes:
                    self._rotate_pair()
                with open(self._seg_path, "ab") as f:
                    off = f.tell()
                    f.write(_SEG_HEADER.pack(len(payload), crc))
                    f.write(payload)
            except OSError:
                self._dead = True
                log.warning("prefix store %s failed; disabling "
                            "persistence", self.dir, exc_info=True)
                return
        self._sink.write({
            "digest": chain[-1],
            "chain": list(chain),
            "codec": str(codec),
            "off": off,
            "len": len(payload),
            "crc": crc,
            "blocks": len(chain),
            "block_size": int(block_size),
            "sig": self.sig,
        })
        self.blocks_journaled += len(chain)

    def _rotate_pair(self) -> None:
        """Rename both files to ``.1`` together (keep one previous pair).
        A crash between the two renames leaves records whose offsets miss
        their crc: torn, skipped on load."""
        self._sink.close()
        for p in (self._seg_path, self._index_path):
            if os.path.exists(p):
                os.replace(p, p + ".1")

    def close(self) -> None:
        self._sink.close()

    # -- read path -------------------------------------------------------
    def _iter_valid(self, suffix: str,
                    ) -> Iterator[Tuple[Tuple[str, ...], bytes, str, int]]:
        idx_path = self._index_path + suffix
        seg_path = self._seg_path + suffix
        if not os.path.exists(idx_path) or not os.path.exists(seg_path):
            return
        try:
            seg_size = os.path.getsize(seg_path)
            with open(idx_path, "r", encoding="utf-8") as idx, \
                    open(seg_path, "rb") as seg:
                for line in idx:
                    try:
                        rec = json.loads(line)
                        chain = tuple(str(d) for d in rec["chain"])
                        codec = str(rec["codec"])
                        off = int(rec["off"])
                        length = int(rec["len"])
                        crc = int(rec["crc"])
                        block_size = int(rec["block_size"])
                        sig = str(rec.get("sig", ""))
                    except (ValueError, KeyError, TypeError):
                        continue  # torn or garbage index line
                    if self.sig and sig != self.sig:
                        continue  # foreign pool layout
                    if (not chain or length < 0 or off < 0
                            or off + _SEG_HEADER.size + length > seg_size):
                        continue  # points past a torn segment tail
                    seg.seek(off)
                    header = seg.read(_SEG_HEADER.size)
                    if len(header) != _SEG_HEADER.size:
                        continue
                    hlen, hcrc = _SEG_HEADER.unpack(header)
                    if hlen != length or hcrc != crc:
                        continue  # index and segment disagree
                    payload = seg.read(length)
                    if (len(payload) != length
                            or (zlib.crc32(payload) & 0xFFFFFFFF) != crc):
                        continue  # bit rot or a torn write
                    yield chain, payload, codec, block_size
        except OSError:
            log.warning("prefix store %s unreadable; skipping %s",
                        self.dir, idx_path, exc_info=True)

    def load(self) -> List[Tuple[Tuple[str, ...], bytes, str, int]]:
        """Every valid journaled run as ``(chain, payload, codec,
        block_size)``, the last record a deepest digest winning; the
        rotated pair is read first, so the newer wins."""
        out = {}
        with self._lock:
            for suffix in (".1", ""):
                for chain, payload, codec, bs in self._iter_valid(suffix):
                    out[chain[-1]] = (chain, payload, codec, bs)
        self.blocks_journaled = sum(len(c) for c, _p, _co, _b in out.values())
        return list(out.values())
