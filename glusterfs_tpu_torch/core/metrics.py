"""Unified metrics registry — counters, gauges, log-bucket histograms.

The reference has no single metrics plane: io-stats keeps per-fop
count/avg/max, every xlator hand-rolls private counters, and the
``monitoring.c`` dump (glusterfsd/src/gf_proc_dump) walks them ad hoc.
This build had grown the same scatter — ``wire.blob_stats``,
``ec.read_fanout``, the gf256 program-LRU hit/miss, io-threads queue
depths, write-behind window bytes, codec probe state — each readable
only by whoever knew the module global.  This module is the one plane
they all report to:

* **Owned instruments**: :class:`Counter` / :class:`Gauge` created via
  the registry for new code.
* **Collectors**: a callback per family that reads EXISTING state at
  scrape time (the prometheus-client "custom collector" shape) — the
  scattered globals stay where their hot paths want them and cost
  nothing until someone looks.
* **Histograms**: :class:`LogHistogram`, fixed power-of-two log buckets
  (µs → minutes), zero-allocation record path; per-fop instances live
  in ``core.layer._FopStats`` and derive p50/p90/p99 on read.

Naming convention (docs/observability.md): ``gftpu_<area>_<name>``,
``_total`` suffix on counters, labels for sub-series (prometheus
conventions).  The registry renders the text exposition format
(``render()``) for the daemon's ``--metrics-port`` endpoint, the
``.meta/metrics`` file and ``gftpu volume metrics``, and a JSON-able
``snapshot()`` for the mgmt RPC path.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable

#: log2 bucket count: bucket i counts samples whose duration in µs has
#: bit_length i, i.e. [2^(i-1), 2^i) µs; bucket 0 is sub-µs and the
#: last bucket is open-ended (2^38 µs ≈ 4.6 min — far past any fop
#: deadline).  40 buckets * 8B = 320B per (layer, fop): cheap enough to
#: keep always-allocated, which is what makes the record path
#: allocation-free.
HIST_BUCKETS = 40


class LogHistogram:
    """Fixed power-of-two latency histogram (µs → minutes).

    ``record`` is the hot path: one int multiply, one ``bit_length``,
    one list increment — no allocation, no branching on configuration.
    Percentiles are derived on read by walking the cumulative counts
    and reporting the bucket's UPPER bound (conservative: the true
    quantile is never above the reported one by more than 2x)."""

    __slots__ = ("buckets", "total")

    def __init__(self):
        self.buckets = [0] * HIST_BUCKETS
        self.total = 0

    def record(self, seconds: float) -> None:
        idx = int(seconds * 1e6).bit_length()
        self.buckets[idx if idx < HIST_BUCKETS else HIST_BUCKETS - 1] += 1
        self.total += 1

    @staticmethod
    def bound(idx: int) -> float:
        """Upper bound of bucket ``idx`` in seconds."""
        return (1 << idx) * 1e-6

    def percentile(self, q: float) -> float:
        """q-th percentile (0-100) in seconds; 0.0 when empty."""
        if not self.total:
            return 0.0
        rank = q / 100.0 * self.total
        seen = 0
        for i, c in enumerate(self.buckets):
            seen += c
            if seen >= rank and c:
                return self.bound(i)
        return self.bound(HIST_BUCKETS - 1)

    def merge(self, other: "LogHistogram") -> None:
        for i, c in enumerate(other.buckets):
            self.buckets[i] += c
        self.total += other.total

    def to_dict(self) -> dict:
        return {"total": self.total,
                "p50": self.percentile(50),
                "p90": self.percentile(90),
                "p99": self.percentile(99)}


class Counter:
    """Monotonic counter (owned instrument)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (owned instrument)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


def _fmt_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class MetricsRegistry:
    """Process-global family registry.

    A family is ``(type, help, collect)`` where ``collect()`` yields
    ``(labels_dict, value)`` samples at scrape time.  Registration is
    idempotent by name (module reloads in tests must not error)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, tuple[str, str, Callable[[], Iterable]]] \
            = {}

    # -- registration ------------------------------------------------------

    def register(self, name: str, mtype: str, help_text: str,
                 collect: Callable[[], Iterable]) -> None:
        with self._lock:
            self._families[name] = (mtype, help_text, collect)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._families.pop(name, None)

    def register_objects(self, name: str, mtype: str, help_text: str,
                         samples_of: Callable[[Any], Iterable],
                         live: Any = None):
        """Register a family scraped from a weakly-tracked set of live
        objects (the per-layer-instance pattern: ec read-fanout,
        io-threads queues, write-behind occupancy).  ``samples_of(obj)``
        yields that object's ``(labels, value)`` samples.  Returns the
        WeakSet — constructors add instances to it; pass an existing
        ``live`` set to hang several families off one population."""
        import weakref

        if live is None:
            live = weakref.WeakSet()
        self.register(name, mtype, help_text,
                      lambda: [s for obj in list(live)
                               for s in samples_of(obj)])
        return live

    def counter(self, name: str, help_text: str = "") -> Counter:
        c = Counter()
        self.register(name, "counter", help_text,
                      lambda: [({}, c.value)])
        return c

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        g = Gauge()
        self.register(name, "gauge", help_text, lambda: [({}, g.value)])
        return g

    # -- scraping ----------------------------------------------------------

    def collect(self) -> dict[str, dict]:
        """name -> {type, help, samples: [[labels, value], ...]} — a
        collector that raises loses only its own family (a dead layer's
        stale callback must not take the whole scrape down)."""
        _ensure_default_families()
        with self._lock:
            fams = dict(self._families)
        out: dict[str, dict] = {}
        for name, (mtype, help_text, fn) in sorted(fams.items()):
            try:
                samples = [[dict(labels), value]
                           for labels, value in fn()]
            except Exception:  # noqa: BLE001 - scrape isolation
                continue
            out[name] = {"type": mtype, "help": help_text,
                         "samples": samples}
        return out

    def snapshot(self) -> dict:
        """JSON/wire-able scrape (the mgmt RPC + .meta shape)."""
        return self.collect()

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        return render_families(self.collect())


def render_families(families: dict) -> str:
    """Text exposition of a ``collect()``-shaped family dict — shared
    by the registry's own ``render()`` and aggregators that merge
    OTHER processes' snapshots (the gateway worker-pool supervisor)."""
    lines: list[str] = []
    for name, fam in families.items():
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for labels, value in fam["samples"]:
            if isinstance(value, float) and value == int(value):
                value = int(value)
            lines.append(f"{name}{_fmt_labels(labels)} {value}")
    return "\n".join(lines) + "\n"


#: THE process-global registry (the prometheus default-registry shape);
#: modules register their families at import / instance-construction
#: time and every exposure surface reads this one object.
REGISTRY = MetricsRegistry()


# Families whose owning modules may not be loaded yet in a given role
# (a plain distribute brick never touches the codec): imported once on
# the FIRST scrape so every dump carries the full family set — the
# acceptance contract is "the families are present", not "present iff
# the right import happened first".  Scraping is a cold path; these
# imports are cheap (numpy is already resident in any serving process).
_DEFAULT_SOURCES = ("glusterfs_tpu_torch.ops.gf256",
                    "glusterfs_tpu_torch.ops.codec")
_ensured = False


def _ensure_default_families() -> None:
    global _ensured
    if _ensured:
        return
    _ensured = True
    import importlib

    for mod in _DEFAULT_SOURCES:
        try:
            importlib.import_module(mod)
        except Exception:  # noqa: BLE001 - a missing optional dep
            pass           # loses that family, never the scrape


def labeled(samples: dict, **fixed) -> list:
    """Helper: a flat ``{key: value}`` dict -> labeled samples, with
    ``fixed`` labels merged in (the one-line collector for the absorbed
    module-global counter dicts)."""
    return [({**fixed, "counter": k}, v) for k, v in samples.items()]


def register_build_info(role: str) -> None:
    """Register the standard ``gftpu_build_info{version,op_version,
    role}`` info-gauge (value always 1, the prometheus build-info
    idiom): every daemon role calls this at startup so merged bundles
    and history rings are attributable to the code + op-version that
    produced them.  Idempotent by registry contract (last registration
    wins — one role per process)."""
    from .. import OP_VERSION, __version__

    REGISTRY.register(
        "gftpu_build_info", "gauge",
        "build/version identity of this process (value is always 1)",
        lambda: [({"version": __version__,
                   "op_version": str(OP_VERSION),
                   "role": str(role)}, 1)])


__all__ = ["REGISTRY", "MetricsRegistry", "Counter", "Gauge",
           "LogHistogram", "HIST_BUCKETS", "labeled",
           "register_build_info"]
