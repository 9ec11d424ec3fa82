"""Zero-dependency metrics registry + the single Prometheus text renderer.

The port's copy of ``vtpu/obs/registry.py``: the same instruments and
byte-equal Prometheus text.  Its registries are its own, apart from the
JAX package's.
Locks are plain ``threading.Lock`` objects (the JAX package's
``make_lock`` is one too unless its lock witness is switched on).

The SURVEY records the reference shipping only ad-hoc gauge exporters and
our rebuild duplicating the hand-rolled exposition helpers in
vtpu/scheduler/metrics.py and vtpu/monitor/metrics.py.  This module is the
one copy both now call: ``escape_label`` / ``render_family`` reproduce the
legacy renderers' output byte-for-byte (guarded by tests/test_obs.py
goldens), and ``Registry`` adds the stateful instruments the legacy
renderers could not express — counters, gauges, and fixed-bucket
**histograms** — with the same exposition dialect.

Registries are named per component (``registry("scheduler")``,
``registry("shim")``, …) so each daemon's /metrics carries only its own
hot-path latency families even when several components share a process
(the test harness, bench.py's in-process tenants).

Conventions (enforced by ``make obs-lint`` via ``lint_names``): every
registered name starts with ``vtpu_``, counters end in ``_total``, and
other instruments end in a unit suffix (``_seconds``, ``_bytes``, …).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "Registry",
    "all_registries",
    "escape_label",
    "lint_names",
    "registry",
    "render_family",
]

# Prometheus-style latency buckets, in seconds: 100 µs → 10 s covers every
# control-plane hot path (filter p50 ≈ 1.6 ms at 1000 nodes) and the shim's
# pacing sleeps (up to ~1 s at low core quotas).
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def escape_label(s: str) -> str:
    """Prometheus label-value escaping (the legacy ``_esc``)."""
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_family(
    lines: List[str],
    name: str,
    help_: str,
    typ: str,
    samples: Iterable[Tuple[dict, object]],
) -> None:
    """Append one family's HELP/TYPE header + samples to ``lines``.

    Byte-compatible with the legacy hand-rolled renderers: values go
    through str() formatting, labels render in dict insertion order, and
    a sample with no labels omits the braces entirely (the legacy counter
    form ``name value``)."""
    lines.append(f"# HELP {name} {help_}")
    lines.append(f"# TYPE {name} {typ}")
    for labels, value in samples:
        if labels:
            lbl = ",".join(
                f'{k}="{escape_label(str(v))}"' for k, v in labels.items()
            )
            lines.append(f"{name}{{{lbl}}} {value}")
        else:
            lines.append(f"{name} {value}")


def _fmt_bound(b: float) -> str:
    if b == float("inf"):
        return "+Inf"
    s = repr(float(b))
    return s[:-2] if s.endswith(".0") else s


def _label_key(labels: Dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


class _Instrument:
    def __init__(self, name: str, help_: str) -> None:
        self.name = name
        self.help = help_
        self._lock = threading.Lock()

    def render(self, lines: List[str]) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonic counter; ``inc()`` with optional labels."""

    def __init__(self, name: str, help_: str) -> None:
        super().__init__(name, help_)
        self._values: Dict[tuple, Tuple[Dict[str, str], float]] = {}

    def inc(self, amount: float = 1, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            prev = self._values.get(key)
            total = (prev[1] if prev else 0) + amount
            self._values[key] = (labels, total)

    def value(self, **labels: str) -> float:
        with self._lock:
            ent = self._values.get(_label_key(labels))
            return ent[1] if ent else 0

    def remove(self, **labels: str) -> None:
        """Drop one label set from the exposition — for per-entity
        counters (per-peer reconnects, per-replica shard families) whose
        entity was retired; without this a dead replica's series would be
        exported forever.  Prometheus treats the disappearance as a
        series end, same as a restarted target."""
        with self._lock:
            self._values.pop(_label_key(labels), None)

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        """Every (labels, value) pair — the flight recorder's scrape."""
        with self._lock:
            return [(dict(lbl), v) for lbl, v in self._values.values()]

    def render(self, lines: List[str]) -> None:
        with self._lock:
            samples = [(dict(lbl), v) for lbl, v in self._values.values()]
        render_family(lines, self.name, self.help, "counter", samples)


class Gauge(_Instrument):
    """Last-write-wins gauge; ``set()`` / ``add()`` with optional labels."""

    def __init__(self, name: str, help_: str) -> None:
        super().__init__(name, help_)
        self._values: Dict[tuple, Tuple[Dict[str, str], float]] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = (labels, value)

    def add(self, amount: float, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            prev = self._values.get(key)
            self._values[key] = (labels, (prev[1] if prev else 0) + amount)

    def value(self, **labels: str) -> float:
        with self._lock:
            ent = self._values.get(_label_key(labels))
            return ent[1] if ent else 0

    def remove(self, **labels: str) -> None:
        """Drop one label set from the exposition — for per-entity gauges
        (per-pod duty cycle, per-node fragmentation) whose entity is gone;
        without this a dead pod's last value would be exported forever."""
        with self._lock:
            self._values.pop(_label_key(labels), None)

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        """Every (labels, value) pair — the flight recorder's scrape."""
        with self._lock:
            return [(dict(lbl), v) for lbl, v in self._values.values()]

    def render(self, lines: List[str]) -> None:
        with self._lock:
            samples = [(dict(lbl), v) for lbl, v in self._values.values()]
        render_family(lines, self.name, self.help, "gauge", samples)


class _HistSeries:
    __slots__ = ("labels", "counts", "sum", "count")

    def __init__(self, labels: Dict[str, str], n_buckets: int) -> None:
        self.labels = labels
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Instrument):
    """Fixed-bucket histogram (cumulative exposition, ``+Inf`` included).

    ``observe`` is the hot-path call: one bisect over the precomputed
    bounds + three integer adds under the lock — cheap enough to stay on
    even when tracing is off (the filter fast path budget is guarded by
    make bench-sched)."""

    def __init__(
        self,
        name: str,
        help_: str,
        buckets: Sequence[float] = LATENCY_BUCKETS,
    ) -> None:
        super().__init__(name, help_)
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] == float("inf"):
            raise ValueError("buckets must be finite and non-empty; "
                             "+Inf is appended automatically")
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self._series: Dict[tuple, _HistSeries] = {}

    def observe(self, value: float, **labels: str) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(labels, len(self.bounds))
            s.counts[idx] += 1
            s.sum += value
            s.count += 1

    def remove(self, **labels: str) -> None:
        """Drop one label set (all its buckets) from the exposition —
        the per-entity pruning counters and gauges already have, for
        per-replica histogram series (``vtpu_shard_evaluate_seconds``)
        when the autoscaler retires the replica."""
        with self._lock:
            self._series.pop(_label_key(labels), None)

    def snapshot(self, **labels: str) -> Optional[dict]:
        """(cumulative bucket counts, sum, count) for tests/debugging."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None:
                return None
            cum, acc = [], 0
            for c in s.counts:
                acc += c
                cum.append(acc)
            return {"buckets": cum, "sum": s.sum, "count": s.count}

    def series_snapshot(self) -> List[dict]:
        """Every label set's cumulative state — the flight recorder's
        scrape.  ``buckets`` are cumulative counts aligned with
        ``self.bounds`` + the implicit +Inf."""
        with self._lock:
            series = [
                (dict(s.labels), list(s.counts), s.sum, s.count)
                for s in self._series.values()
            ]
        out = []
        for labels, counts, total, count in series:
            cum, acc = [], 0
            for c in counts:
                acc += c
                cum.append(acc)
            out.append({
                "labels": labels, "buckets": cum,
                "sum": total, "count": count,
            })
        return out

    def render(self, lines: List[str]) -> None:
        lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} histogram")
        with self._lock:
            series = [
                (dict(s.labels), list(s.counts), s.sum, s.count)
                for s in self._series.values()
            ]
        for labels, counts, total, count in series:
            acc = 0
            for bound, c in zip(
                tuple(self.bounds) + (float("inf"),), counts
            ):
                acc += c
                le = dict(labels, le=_fmt_bound(bound))
                lbl = ",".join(
                    f'{k}="{escape_label(str(v))}"' for k, v in le.items()
                )
                lines.append(f"{self.name}_bucket{{{lbl}}} {acc}")
            if labels:
                lbl = ",".join(
                    f'{k}="{escape_label(str(v))}"' for k, v in labels.items()
                )
                lines.append(f"{self.name}_sum{{{lbl}}} {total}")
                lines.append(f"{self.name}_count{{{lbl}}} {count}")
            else:
                lines.append(f"{self.name}_sum {total}")
                lines.append(f"{self.name}_count {count}")


class Registry:
    """Named collection of instruments with one text-exposition render."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_make(self, cls, name: str, help_: str, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help_, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"{name} already registered as {type(inst).__name__}"
                )
            return inst

    def counter(self, name: str, help_: str) -> Counter:
        return self._get_or_make(Counter, name, help_)

    def gauge(self, name: str, help_: str) -> Gauge:
        return self._get_or_make(Gauge, name, help_)

    def histogram(
        self, name: str, help_: str,
        buckets: Sequence[float] = LATENCY_BUCKETS,
    ) -> Histogram:
        return self._get_or_make(Histogram, name, help_, buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def get(self, name: str) -> Optional[_Instrument]:
        """The registered instrument, or None — so the flight recorder
        can sample declared families without creating empty ones."""
        with self._lock:
            return self._instruments.get(name)

    def render(self) -> str:
        """Exposition for every instrument, name-sorted (deterministic)."""
        lines: List[str] = []
        with self._lock:
            insts = [self._instruments[n] for n in sorted(self._instruments)]
        for inst in insts:
            inst.render(lines)
        return "\n".join(lines) + "\n" if lines else ""


_registries: Dict[str, Registry] = {}
_registries_lock = threading.Lock()


def registry(name: str) -> Registry:
    """The process-wide registry for one component (created on demand)."""
    with _registries_lock:
        reg = _registries.get(name)
        if reg is None:
            reg = _registries[name] = Registry(name)
        return reg


def all_registries() -> Dict[str, Registry]:
    with _registries_lock:
        return dict(_registries)


_UNIT_SUFFIXES = (
    "_seconds", "_bytes", "_total", "_ratio", "_percent", "_info",
)


def lint_names() -> List[str]:
    """Naming-convention violations across every registry (obs-lint)."""
    problems: List[str] = []
    for reg in all_registries().values():
        with reg._lock:
            insts = list(reg._instruments.values())
        for inst in insts:
            n = inst.name
            if not n.startswith("vtpu_"):
                problems.append(f"{reg.name}: {n}: missing vtpu_ prefix")
            if isinstance(inst, Counter) and not n.endswith("_total"):
                problems.append(f"{reg.name}: {n}: counter without _total")
            if not isinstance(inst, Counter) and not n.endswith(_UNIT_SUFFIXES):
                problems.append(
                    f"{reg.name}: {n}: missing unit suffix "
                    f"(one of {', '.join(_UNIT_SUFFIXES)})"
                )
    return problems
