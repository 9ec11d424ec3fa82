"""Multi-process runtime initialization: ``vtpu/parallel/distributed.py``
for PyTorch, plus the launcher the dryrun and the tests start worlds
with.

One rank is one process and one device.  A gang's ranks meet through
``torch.distributed.init_process_group`` under the same env contract the
JAX package reads (all optional; absent means a world of one)::

  VTPU_COORDINATOR        host:port of rank 0 (the gang leader)
  VTPU_NUM_PROCESSES      the world size (ranks)
  VTPU_PROCESS_ID         this process's rank

The backend is NCCL on the card and gloo on the CPU, and every group
gets an explicit ``timeout``, so a rank that never arrives fails the
world instead of hanging it.

:func:`spawn_world` starts ``world`` ranks with the ``spawn`` start
method (never ``fork``: the parent may run XLA's or CUDA's threads),
each with one intra-op thread, runs ``fn(*args)`` in every rank after
:func:`init_world`, and returns the ranks' results in rank
order, or raises with the failing rank's traceback.  The whole world
has one deadline.  ``hosts=2`` starts two launcher processes that each
start half the ranks, so the world spans a process tree the way a
two-host gang does.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import shutil
import signal
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from vtpu_torch.utils.envs import env_int, env_str

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 120.0


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ensure_initialized(coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, *,
                       device="cuda",
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Initialize the default process group from the arguments or the
    VTPU_* env contract.

    Returns True when a world is up (this call made it or an earlier
    one did), False for the single-process no-op.  ``device`` picks the
    backend (NCCL for ``"cuda"``, gloo for ``"cpu"``); on the card the
    rank's device is ``cuda:<rank % visible cards>``."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or env_str("VTPU_COORDINATOR")
    if num_processes is None:
        num_processes = env_int("VTPU_NUM_PROCESSES", 0)
    if not coordinator or num_processes <= 1:
        log.debug("single process; torch.distributed not initialized")
        return False
    if process_id is None:
        raw = env_str("VTPU_PROCESS_ID") or None
        if raw is None:
            # defaulting to 0 would make every worker claim rank 0 and
            # stall the gang until the rendezvous timeout
            raise RuntimeError(
                "VTPU_PROCESS_ID is required when VTPU_COORDINATOR is set "
                f"with VTPU_NUM_PROCESSES={num_processes}")
        process_id = int(raw)
    init_world(coordinator, num_processes, process_id, device=device,
               timeout_s=timeout_s)
    return True


def init_world(coordinator: str, world: int, rank: int, *, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``init_process_group`` for rank ``rank`` of ``world`` (a world of
    one too: the launcher's ranks always run in a process group)."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        _backend(device), init_method=f"tcp://{coordinator}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("torch.distributed up: rank %d/%d via %s", rank, world,
             coordinator)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_device_count() -> int:
    """The world's devices: one a rank."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_count() -> int:
    """This host's ranks (``VTPU_LOCAL_WORLD_SIZE``, which
    :func:`spawn_world` sets; the whole world when unset)."""
    return env_int("VTPU_LOCAL_WORLD_SIZE", global_device_count())


def rank_device(device="cuda") -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# -- the launcher ------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, rank: int, world: int, env: dict, device: str,
               timeout_s: float, out_dir: str) -> None:
    os.environ.update(env)
    os.environ["VTPU_PROCESS_ID"] = str(rank)
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        init_world(env["VTPU_COORDINATOR"], world, rank, device=device,
                   timeout_s=timeout_s)
        result = (True, fn(*args))
    except Exception:  # noqa: BLE001 -- reported to the parent
        result = (False, traceback.format_exc())
    try:
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    finally:
        if not result[0]:
            # a failed rank leaves at once, and the launcher that sees
            # its exit code ends the world
            os._exit(1)
        if dist.is_initialized():
            dist.destroy_process_group()


def _start(ctx, target, args):
    p = ctx.Process(target=target, args=args, daemon=False)
    p.start()
    return p


def _join(procs, deadline: float, what: str) -> None:
    """Wait for ``procs``; a process that exits non-zero or outlives the
    deadline ends the wait, and every process still running is killed
    (its peers would otherwise wait out their collectives' timeout)."""
    try:
        while any(p.is_alive() for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if not p.is_alive() and p.exitcode != 0]
            if bad:
                return
            if time.monotonic() > deadline:
                late = [i for i, p in enumerate(procs) if p.is_alive()]
                raise TimeoutError(f"{what} {late} passed the world's "
                                   f"deadline")
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)


def _host_main(fn, args, ranks: Sequence[int], world: int, env: dict,
               device: str, timeout_s: float, out_dir: str) -> None:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [_start(ctx, _rank_main, (fn, args, r, world, env, device,
                                      timeout_s, out_dir)) for r in ranks]
    # the parent kills these by pid if this launcher dies first
    with open(os.path.join(out_dir, f"pids{ranks[0]}"), "w") as f:
        f.write(" ".join(str(p.pid) for p in procs))
    _join(procs, time.monotonic() + timeout_s, "rank")
    if any(p.exitcode != 0 for p in procs):
        sys.exit(1)


def _kill_ranks(out_dir: str) -> None:
    for name in os.listdir(out_dir):
        if name.startswith("pids"):
            with open(os.path.join(out_dir, name)) as f:
                for pid in f.read().split():
                    try:
                        os.kill(int(pid), signal.SIGKILL)
                    except (OSError, ValueError):
                        pass


def spawn_world(fn: Callable[..., Any], world: int, device: str = "cuda", *,
                args: tuple = (), hosts: int = 1,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` in each rank of a new world of ``world`` ranks
    and return their results in rank order.  ``fn`` and ``args`` must
    pickle (a module-level function of a module the ranks can import).
    Raises RuntimeError with the first failing rank's traceback, or
    TimeoutError when the world passes ``timeout_s``.  The ranks run on
    the card (NCCL, one card a rank) unless ``device="cpu"`` (gloo)."""
    import multiprocessing as mp

    if world < 1 or hosts < 1 or world % hosts:
        raise ValueError(f"a world of {world} ranks cannot split over "
                         f"{hosts} hosts")
    from vtpu_torch.device import resolve_device

    device = resolve_device(device).type
    if device == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"a world of {world} ranks needs {world} cards, "
                         f"have {torch.cuda.device_count()}")
    out_dir = tempfile.mkdtemp(prefix="vtpu-world-")
    env = {"VTPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "VTPU_NUM_PROCESSES": str(world),
           "VTPU_LOCAL_WORLD_SIZE": str(world // hosts)}
    ctx = mp.get_context("spawn")
    deadline = time.monotonic() + timeout_s
    try:
        if hosts == 1:
            procs = [_start(ctx, _rank_main, (fn, args, r, world, env,
                                              device, timeout_s, out_dir))
                     for r in range(world)]
            what = "rank"
        else:
            per = world // hosts
            procs = [_start(ctx, _host_main,
                            (fn, args, range(h * per, (h + 1) * per), world,
                             env, device, timeout_s, out_dir))
                     for h in range(hosts)]
            what = "host"
        try:
            _join(procs, deadline, what)
        except BaseException:
            _kill_ranks(out_dir)
            raise
        if any(p.exitcode != 0 for p in procs):
            _kill_ranks(out_dir)
        done, when = {}, {}
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if os.path.exists(path):
                when[r] = os.stat(path).st_mtime_ns
                with open(path, "rb") as f:
                    done[r] = pickle.load(f)
        # the first rank to fail is the cause; its peers fail after it
        for r in sorted(done, key=when.get):
            ok, value = done[r]
            if not ok:
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
        missing = sorted(set(range(world)) - set(done))
        if missing:
            raise RuntimeError(f"ranks {missing} of {world} reported nothing")
        results = [done[r][1] for r in range(world)]
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
