"""The co-location glue: ``vtpu/serving/colo.py`` for PyTorch.

A bound role-gang member carries the ``vtpu.io/gang-placement``
annotation the gang coordinator writes: ``{"gang", "role", "shape",
"hosts", "index", "node"}``.  From it alone:

- :func:`parse_placement` decodes it and :func:`host_split` derives the
  host-split rectangle ``[shape] * hosts``;
- :func:`mesh_for_placement` boots the role's ``DeviceMesh``
  (``vtpu_torch.parallel.mesh.mesh_from_rectangle``: ``dp`` across the
  role's hosts, inner axes inside one host);
- :func:`boot_role_engine` builds the port's ``PrefillEngine`` or
  ``DecodeEngine`` (replica id from role and index), and
  :func:`router_for_gang` wires the booted members into one ``Router``.

:class:`EvictBridge` turns the monitor's ``vtpu.io/evict-requested``
annotation into ``Router.request_evict`` before the scheduler's
eviction reconciler deletes the pod (``Scheduler.add_evict_hook``), so
the evicted replica's sessions migrate instead of dying with it.

The port imports nothing of vtpu: the annotation names and the two pod
accessors are copies, the events and metric families the port's own.
The engines, the Router and the mesh are imported where they are used,
so the bridge runs over fakes without them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

from vtpu_torch import obs
from vtpu_torch.obs.events import EventType, emit

log = logging.getLogger(__name__)

__all__ = [
    "EvictBridge",
    "RolePlacement",
    "ROLE_DECODE",
    "ROLE_PREFILL",
    "boot_role_engine",
    "host_split",
    "mesh_for_placement",
    "parse_placement",
    "router_for_gang",
]

# the gang coordinator's and the arbiter's annotation names
# (vtpu/utils/types.py)
GANG_PLACEMENT = "vtpu.io/gang-placement"
EVICT_REQUESTED = "vtpu.io/evict-requested"

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"

_REG = obs.registry("serving")

COLO_BESTEFFORT_TOKENS = _REG.counter(
    "vtpu_colo_besteffort_tokens_total",
    "Tokens generated by best-effort decode replicas riding sustained-"
    "idle prefill chips (the co-location dividend; migrated sessions "
    "keep counting at their new replica)",
)
COLO_EVICTIONS_MIGRATED = _REG.counter(
    "vtpu_colo_evictions_migrated_total",
    "vtpu.io/evict-requested annotations the EvictBridge turned into "
    "Router.request_evict — the evicted replica's pinned sessions "
    "migrated instead of finishing in place or dying with the pod",
)
COLO_GOODPUT_RATIO = _REG.gauge(
    "vtpu_colo_goodput_ratio",
    "Cluster goodput of the co-located topology relative to its static "
    "partition (useful tokens per second ratio; set by the deployment's "
    "measurement loop / make bench-colo)",
)


def _annotations(obj: dict) -> Dict[str, str]:
    return (obj.get("metadata") or {}).get("annotations") or {}


@dataclasses.dataclass(frozen=True)
class RolePlacement:
    """A decoded ``vtpu.io/gang-placement`` doc."""

    gang: str
    role: str
    shape: Tuple[int, int, int]   # per-host sub-rectangle
    hosts: int                    # member count of this role
    index: int                    # this member's rank within the role
    node: str

    @property
    def chips(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]

    def replica_id(self) -> str:
        """Stable router replica id for this member."""
        return f"{self.role or 'member'}-{self.index}"


def parse_placement(pod_annos: Dict[str, str]) -> Optional[RolePlacement]:
    """The placement doc of pod annotations; None when the pod is not a
    bound role-gang member, ValueError when the annotation is there but
    malformed (never boot a wrong-shaped mesh)."""
    raw = (pod_annos or {}).get(GANG_PLACEMENT, "").strip()
    if not raw:
        return None
    try:
        doc = json.loads(raw)
        shape = tuple(int(d) for d in str(doc["shape"]).split("x"))
        if len(shape) != 3 or any(d < 1 for d in shape):
            raise ValueError(f"bad shape {doc['shape']!r}")
        hosts = int(doc["hosts"])
        index = int(doc["index"])
        if hosts < 1 or not (0 <= index < hosts):
            raise ValueError(f"bad hosts/index {hosts}/{index}")
        return RolePlacement(
            gang=str(doc.get("gang", "")), role=str(doc.get("role", "")),
            shape=shape,  # type: ignore[arg-type]
            hosts=hosts, index=index, node=str(doc.get("node", "")))
    except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
        raise ValueError(f"malformed {GANG_PLACEMENT} {raw!r}: {e}") from e


def host_split(placement: RolePlacement) -> List[Tuple[int, int, int]]:
    """The role's host-split rectangle: one sub-rectangle a member."""
    return [placement.shape] * placement.hosts


def mesh_for_placement(placement: RolePlacement, devices=None):
    """The role's mesh from the placement alone (collective: every rank
    of the world calls it)."""
    from vtpu_torch.parallel.mesh import mesh_from_rectangle

    return mesh_from_rectangle(host_split(placement), devices=devices)


def boot_role_engine(pod_annos: Dict[str, str], model, *,
                     max_batch: int = 8, engine_kw: Optional[dict] = None):
    """The serving engine a bound gang member runs, from its annotations
    alone: ``prefill`` -> ``PrefillEngine(model)``, ``decode`` ->
    ``DecodeEngine(model, max_batch)`` with the placement's replica id.
    The port's engines take the model, which holds its weights (the
    reference also takes a params tree): a model with int8 weights
    (``TransformerLM.quantize_weights``) goes to the engine as it is.
    Returns ``(placement, engine)``; ValueError on a missing placement or
    a role with no engine."""
    placement = parse_placement(pod_annos)
    if placement is None:
        raise ValueError(
            f"pod carries no {GANG_PLACEMENT} annotation — not a bound "
            f"role-gang member")
    kw = dict(engine_kw or {})
    if placement.role == ROLE_PREFILL:
        from vtpu_torch.serving.disagg import PrefillEngine

        return placement, PrefillEngine(model, **kw)
    if placement.role == ROLE_DECODE:
        from vtpu_torch.serving.disagg import DecodeEngine

        return placement, DecodeEngine(
            model, max_batch, replica_id=placement.replica_id(), **kw)
    raise ValueError(
        f"role {placement.role!r} has no serving engine (known: "
        f"{ROLE_PREFILL!r}, {ROLE_DECODE!r})")


def router_for_gang(members, **router_kw):
    """One Router over booted members, ``(RolePlacement, engine)`` pairs:
    prefill members form the prefill tier, decode members the replica
    ring, each under its placement's replica id."""
    from vtpu_torch.serving.router import Router

    prefills: Dict[str, object] = {}
    replicas: Dict[str, object] = {}
    for placement, engine in members:
        if placement.role == ROLE_PREFILL:
            prefills[placement.replica_id()] = engine
        elif placement.role == ROLE_DECODE:
            replicas[placement.replica_id()] = engine
        else:
            raise ValueError(
                f"role {placement.role!r} does not map onto the router "
                f"topology")
    if not prefills or not replicas:
        raise ValueError(
            f"a serving gang needs at least one prefill and one decode "
            f"member (got {len(prefills)} prefill / {len(replicas)} "
            f"decode)")
    return Router(prefills, replicas, **router_kw)


class EvictBridge:
    """``vtpu.io/evict-requested`` -> ``Router.request_evict``.

    Wire it with ``scheduler.add_evict_hook(bridge.hook)`` or poll
    :meth:`observe_pods`.  ``replica_of`` maps a pod to its router
    replica id: a dict (uid -> replica id, kept with :meth:`register`)
    or a callable ``(pod) -> replica id | None``; a pod that maps to no
    replica is ignored.  Each pod is bridged once; a failed
    ``request_evict`` releases the claim so the reconciler's retry
    retries the migration.  ``request_evict`` exports live sessions,
    which must run on the engines' driving thread: with ``defer=True``
    the hook only queues, and the serving loop applies the queue with
    :meth:`drain`."""

    def __init__(self, router,
                 replica_of: Union[Dict[str, str],
                                   Callable[[dict], Optional[str]],
                                   None] = None,
                 defer: bool = False) -> None:
        self.router = router
        self.defer = bool(defer)
        self._map: Dict[str, str] = (
            dict(replica_of) if isinstance(replica_of, dict) else {})
        self._fn = replica_of if callable(replica_of) else None
        self._lock = threading.Lock()
        self._handled: set = set()
        self._queued: List[Tuple[str, str, str]] = []  # (uid, rid, why)
        self.evictions_bridged = 0
        self.sessions_migrated = 0

    def register(self, uid: str, replica_id: str) -> None:
        """Pod ``uid`` backs router replica ``replica_id``."""
        with self._lock:
            self._map[uid] = replica_id

    def _resolve(self, pod: dict, uid: str) -> Optional[str]:
        with self._lock:
            rid = self._map.get(uid)
        if rid is None and self._fn is not None:
            rid = self._fn(pod)
        return rid

    def hook(self, pod: dict) -> None:
        """``Scheduler.add_evict_hook`` entry point."""
        self.observe_pod(pod)

    def observe_pod(self, pod: dict) -> int:
        """Bridge one pod if it carries an unhandled evict request;
        returns the sessions migrated (0 when not bridged or queued)."""
        reason = _annotations(pod).get(EVICT_REQUESTED, "")
        if not reason:
            return 0
        uid = pod["metadata"]["uid"]
        rid = self._resolve(pod, uid)
        if rid is None:
            return 0
        with self._lock:
            if uid in self._handled:
                return 0
            self._handled.add(uid)
            if len(self._handled) > 8192:
                # bounded: re-bridging an old pod is a no-op at the
                # router (its replica is already evicted)
                self._handled = {uid}
            if self.defer:
                self._queued.append((uid, rid, reason))
                return 0
        return self._bridge(uid, rid, reason)

    def _bridge(self, uid: str, rid: str, reason: str) -> int:
        try:
            moved = self.router.request_evict(rid, reason=reason)
        except KeyError:
            with self._lock:
                self._handled.discard(uid)  # register() may still come
            log.warning("evict bridge: pod %s names unknown replica %s",
                        uid, rid)
            return 0
        except Exception:  # noqa: BLE001 -- the delete proceeds; retried
            with self._lock:
                self._handled.discard(uid)
            log.exception("evict bridge: request_evict(%s) failed", rid)
            return 0
        COLO_EVICTIONS_MIGRATED.inc()
        self.evictions_bridged += 1
        self.sessions_migrated += moved
        emit(EventType.EVICT_MIGRATED, "router", pod=uid, replica=rid,
             sessions=moved, reason=reason)
        log.info("evict bridge: replica %s (pod %s) drained via "
                 "migration, %d session(s) moved", rid, uid, moved)
        return moved

    def drain(self) -> int:
        """Apply the queued evictions (``defer=True``) from the serving
        loop's thread; returns the sessions migrated."""
        with self._lock:
            batch, self._queued = self._queued, []
        return sum(self._bridge(uid, rid, reason)
                   for uid, rid, reason in batch)

    def observe_pods(self, pods) -> int:
        """Poll form: bridge every evict-requested pod of ``pods``."""
        return sum(self.observe_pod(p) for p in pods)
