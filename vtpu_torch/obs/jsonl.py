"""Size-capped rotating JSONL sink shared by the durable journals.

The port's copy of ``vtpu/obs/jsonl.py``.
Locks are plain ``threading.Lock`` objects (the JAX package's
``make_lock`` is one too unless its lock witness is switched on).

The event journal (``VTPU_EVENT_JSONL``) and the decision journal
(``VTPU_DECISION_JSONL``) both mirror their in-memory rings to append-only
JSONL files so post-mortems outlive the process — and both previously (or
would have) grown those files without bound.  This sink is the one shared
writer: when a write would push the file past ``VTPU_EVENT_JSONL_MAX_BYTES``
(0 = unlimited, the default), the current file is renamed to ``<path>.1``
(keep-one-previous — the same policy logrotate's ``rotate 1`` gives) and a
fresh file is opened.  A reader that wants the full window concatenates
``<path>.1`` + ``<path>`` and sorts on ``seq``.

Failure policy matches the original event sink: the first OSError disables
the mirror with one warning — a full disk must not turn every hot-path
emit into a failing syscall.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Optional

from vtpu_torch.utils.envs import env_int

log = logging.getLogger(__name__)

ENV_MAX_BYTES = "VTPU_EVENT_JSONL_MAX_BYTES"


class RotatingJsonlSink:
    """Append-only JSONL file with size-capped keep-one-previous rotation.

    Thread-safe; every ``write`` serialises under the sink's own lock so
    callers can (and do — see EventJournal) keep disk I/O off their ring
    locks.  ``max_bytes`` <= 0 means unlimited (no rotation)."""

    def __init__(
        self,
        path: str,
        max_bytes: Optional[int] = None,
        lock_name: str = "obs.jsonl_sink",
    ) -> None:
        self.path = path
        self.max_bytes = (
            max_bytes if max_bytes is not None
            else env_int(ENV_MAX_BYTES, 0)
        )
        self._lock = threading.Lock()
        self._fh = None        # lazily opened append handle
        self._size = 0         # bytes in the current file (from open + writes)
        self._dead = False     # one warning, then the mirror stays off
        self.rotations = 0

    @property
    def dead(self) -> bool:
        return self._dead

    def write(self, rec: dict) -> None:
        """Append one record as a JSON line (best-effort; never raises)."""
        if self._dead:
            return
        line = json.dumps(rec, default=str) + "\n"
        data = line.encode("utf-8")
        with self._lock:
            try:
                if self._fh is None:
                    self._open()
                if (
                    self.max_bytes > 0
                    and self._size > 0
                    and self._size + len(data) > self.max_bytes
                ):
                    self._rotate()
                self._fh.write(line)
                self._fh.flush()
                self._size += len(data)
            except OSError:
                # one warning, then stop trying: a full disk must not
                # turn every journal write into a failing syscall
                self._dead = True
                log.warning("JSONL sink %s failed; disabling mirror",
                            self.path, exc_info=True)

    def _open(self) -> None:
        self._fh = open(self.path, "a", encoding="utf-8")
        try:
            self._size = os.fstat(self._fh.fileno()).st_size
        except OSError:
            self._size = 0

    def _rotate(self) -> None:
        """Close, rename to ``<path>.1`` (replacing any previous), reopen."""
        try:
            self._fh.close()
        except OSError:
            pass
        self._fh = None
        os.replace(self.path, self.path + ".1")
        self._open()
        self.rotations += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
