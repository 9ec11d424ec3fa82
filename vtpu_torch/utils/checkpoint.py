"""Sharded checkpoint save and restore: ``vtpu/utils/checkpoint.py`` for
PyTorch, over ``torch.distributed.checkpoint``.

    ckpt = Checkpointer("/ckpts/run1")
    ckpt.save(step, {"params": params, "opt": optimizer.state_dict()})
    restored = ckpt.restore({"params": params_like, "opt": opt_like})

A tree is nested dicts, lists and tuples of tensors and plain values.
In a world of several ranks every rank calls ``save`` and ``restore``
together, and each rank writes and reads its own shards (a tensor's key
carries its rank: tensor-parallel shards differ between ranks); a world
of one (no process group, or one rank) writes one ``torch.save`` file.
Restore puts every tensor back on the device and in the dtype of its
leaf in the target tree.  A step counts once its ``COMMIT`` marker is
written, after every rank's files; ``max_to_keep`` keeps the newest
steps.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

_COMMIT = "COMMIT"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _rebuild(target: Any, flat: Dict[str, Any], prefix: str = ""):
    """``target``'s structure with each leaf from ``flat``, tensors on
    their target leaf's device and in its dtype."""
    if isinstance(target, dict):
        return {k: _rebuild(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(
            _rebuild(v, flat, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(target))
    value = flat[prefix]
    if isinstance(target, torch.Tensor):
        return value.to(device=target.device, dtype=target.dtype)
    return value


class Checkpointer:
    """Step directories under ``directory``, with retention."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, _COMMIT)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, wait: bool = True) -> None:
        """Write ``tree`` as step ``step`` (collective in a world of
        several ranks).  ``wait`` is the reference's flag; the write is
        synchronous."""
        del wait
        path = self._path(step)
        flat = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                for k, v in _flatten(tree).items()}
        if _world() == 1:
            os.makedirs(path, exist_ok=True)
            torch.save(flat, os.path.join(path, "state.pt"))
        else:
            import torch.distributed.checkpoint as dcp

            rank = dist.get_rank()
            dcp.save({f"{k}@{rank}": v for k, v in flat.items()},
                     checkpoint_id=path)
            dist.barrier()
        if _world() == 1 or dist.get_rank() == 0:
            open(os.path.join(path, _COMMIT), "w").close()
            for old in self.all_steps()[:-self.max_to_keep or None]:
                shutil.rmtree(self._path(old), ignore_errors=True)
        if _world() > 1:
            dist.barrier()

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Step ``step`` (default the latest) in the structure of
        ``target``, each tensor on its target leaf's device with its
        dtype; ``target`` itself is not written."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self._path(step)
        if _world() == 1:
            flat = torch.load(os.path.join(path, "state.pt"),
                              map_location="cpu", weights_only=False)
        else:
            import torch.distributed.checkpoint as dcp

            rank = dist.get_rank()
            like = {k: (v.detach().clone() if isinstance(v, torch.Tensor)
                        else v) for k, v in _flatten(target).items()}
            keyed = {f"{k}@{rank}": v for k, v in like.items()}
            dcp.load(keyed, checkpoint_id=path)
            flat = {k: keyed[f"{k}@{rank}"] for k in like}
        return _rebuild(target, flat)

    def close(self) -> None:
        """Nothing to release (the reference's manager has a thread)."""
