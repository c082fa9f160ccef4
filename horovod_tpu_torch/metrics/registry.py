"""Process-wide metrics registry: counters, gauges, histograms — the
port of ``horovod_tpu/metrics/registry.py``, line for line.

Prometheus-shaped on purpose: counters are cumulative, histograms use
fixed upper-bound buckets with ``_bucket{le=...}`` / ``_sum`` /
``_count`` exposition, so the text output drops into any
Prometheus/Grafana stack; the JSON snapshot is the per-rank
``metrics.json`` the timeline dumps next to ``comm.json``.  The same
registry contents give byte-equal text and equal snapshots on both
packages (``tests/test_torch_metrics.py``).

Design constraints, in order:

1. **hot-path cost**: every update is one dict lookup on a pre-interned
   label tuple plus a small per-child lock; call sites gate on
   ``registry.enabled`` so a disabled registry costs one attribute read.
2. **thread safety**: the eager plane, the frontend's handles and the
   timeline writer touch the registry concurrently.
3. **no deps**: text exposition and JSON snapshot are hand-rolled.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import env as env_util

_INF = float("inf")


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` upper bounds growing geometrically from ``start``
    (prometheus_client's ``exponential_buckets`` contract)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


def latency_buckets_from_env(
        floor_var: Optional[str] = None,
        floor_default: Optional[float] = None) -> Tuple[float, ...]:
    """The configurable latency bucket scheme: exponential from a floor.

    The defaults (100 µs floor, ×2, 18 buckets) are tuned for µs-scale
    dispatch spans; workloads on a different latency scale — the serving
    plane's sub-ms..seconds request latencies — pass their own
    ``floor_var`` (e.g. ``HVD_SERVE_LATENCY_BUCKET_FLOOR``) and
    ``floor_default`` so their histograms don't collapse into one
    bucket.  ``HVD_METRICS_BUCKET_{FLOOR,FACTOR,COUNT}`` reshape the
    default scheme job-wide (factor/count are shared by every scheme)."""
    floor = env_util.get_float(
        floor_var or env_util.HVD_METRICS_BUCKET_FLOOR,
        floor_default if floor_default is not None
        else env_util.DEFAULT_METRICS_BUCKET_FLOOR)
    factor = env_util.get_float(env_util.HVD_METRICS_BUCKET_FACTOR,
                                env_util.DEFAULT_METRICS_BUCKET_FACTOR)
    count = env_util.get_int(env_util.HVD_METRICS_BUCKET_COUNT,
                             env_util.DEFAULT_METRICS_BUCKET_COUNT)
    return exponential_buckets(floor, factor, count)


#: default latency buckets: 100 µs .. ~26 s in x2 steps — wide enough to
#: cover eager dispatch (sub-ms) through big-model step times in one
#: scheme; reshaped by HVD_METRICS_BUCKET_{FLOOR,FACTOR,COUNT} (read at
#: import — set them before the first ``import horovod_tpu``)
LATENCY_BUCKETS = latency_buckets_from_env()

#: payload-size buckets: 64 B .. 4 GB in x8 steps
BYTES_BUCKETS = exponential_buckets(64.0, 8.0, 10)


def _fmt(v: float) -> str:
    """Prometheus sample value formatting: integers render bare."""
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    if isinstance(v, float) and v != v:  # NaN
        return "NaN"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class _Child:
    """One labeled time series.

    ``ts`` is the child's last-mutation wall time — snapshot() folds it
    into the family-level ``updated`` stamp so consumers (the observe/
    watchdog, GET /metrics.json) can tell a stale *family* apart from a
    stale snapshot.  Stamped inside the existing per-update lock: one
    extra ``time.time()`` per update, well inside the hot-path budget.
    """

    __slots__ = ("_lock", "value", "ts")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0
        self.ts = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount
            self.ts = time.time()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)
            self.ts = time.time()

    def get(self) -> float:
        return self.value


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count", "ts")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * len(buckets)  # per-bucket, NON-cumulative
        self.sum = 0.0
        self.count = 0
        self.ts = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.sum += v
            self.count += 1
            self.ts = time.time()
            # linear scan: bucket lists are short (<= ~20) and the scan
            # usually exits in the first few entries for latency data
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    self.counts[i] += 1
                    break


class Metric:
    """A named family of children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _new_child(self):
        return _Child()

    def labels(self, *values, **kv):
        """The child for one label-value combination (created on first
        use, then cached — call sites may hold the returned child)."""
        if kv:
            values = tuple(str(kv[k]) for k in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}"
            )
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._new_child())
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()"
            )
        return self.labels()

    def samples(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, vals)), child)
                for vals, child in items]


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def get(self, *values, **kv) -> float:
        if values or kv or not self.labelnames:
            return self.labels(*values, **kv).get()
        raise ValueError(f"{self.name}: label values required")


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().inc(-amount)

    def get(self, *values, **kv) -> float:
        return self.labels(*values, **kv).get() if (values or kv) \
            else self._default().get()


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None) -> None:
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in (buckets or LATENCY_BUCKETS)))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)


class MetricsRegistry:
    """Thread-safe registry of metric families.

    ``enabled`` gates the instrumented call sites (they check it before
    touching any child); the registry itself always works so tests and
    the exposition path never need special cases.  Collector callbacks
    run at snapshot time — the hook for pull-style gauges (controller
    cycle counters, stall-inspector queue depth) that would be wasteful
    to push on every event.
    """

    def __init__(self, enabled: Optional[bool] = None) -> None:
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.RLock()
        self._collectors: Dict[str, Callable[[], None]] = {}
        self.enabled = (
            enabled if enabled is not None
            else env_util.get_bool(env_util.HVD_METRICS, True)
        )

    # -- registration -------------------------------------------------------
    def _register(self, cls, name, help, labelnames, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != cls.kind or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with different "
                        f"kind/labels ({m.kind}{m.labelnames} vs "
                        f"{cls.kind}{tuple(labelnames)})"
                    )
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def register_collector(self, key: str, fn: Callable[[], None]) -> None:
        """Pre-snapshot callback; keyed so re-registration replaces (the
        stall-inspector singleton re-registers across hvd.init cycles)."""
        with self._lock:
            self._collectors[key] = fn

    def unregister_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    # -- export -------------------------------------------------------------
    def _run_collectors(self) -> None:
        with self._lock:
            fns = list(self._collectors.values())
        for fn in fns:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a broken collector must
                pass           # never take down the scrape

    def snapshot(self) -> dict:
        """JSON-able state: the wire form ranks push to the launcher."""
        # a disabled registry is silent end to end: call sites don't
        # push, and pull-gauges don't refresh (their ``updated`` stamp
        # would otherwise tick on every scrape)
        if self.enabled:
            self._run_collectors()
        out: Dict[str, dict] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            samples = []
            updated = 0.0
            for labels, child in m.samples():
                if child.ts > updated:
                    updated = child.ts
                if m.kind == "histogram":
                    with child._lock:
                        samples.append({
                            "labels": labels,
                            "buckets": list(child.counts),
                            "sum": child.sum,
                            "count": child.count,
                        })
                else:
                    samples.append({"labels": labels, "value": child.get()})
            entry = {"type": m.kind, "help": m.help, "samples": samples}
            if m.kind == "histogram":
                entry["le"] = list(m.buckets)
            # per-family staleness stamp (None = registered but never
            # updated): lets GET /metrics.json consumers and the observe/
            # watchdog flag one dead signal inside an otherwise-fresh
            # snapshot, instead of trusting the snapshot-level ts alone
            entry["updated"] = updated or None
            out[m.name] = entry
        return {"metrics": out, "ts": time.time()}

    def to_prometheus(self, extra_labels: Optional[Dict[str, str]] = None) -> str:
        """This registry's state in Prometheus text exposition format."""
        return render_prometheus([(extra_labels or {}, self.snapshot())])

    def dump(self, path: str) -> None:
        """Write the JSON snapshot (the per-rank ``metrics.json`` artifact
        landing next to ``comm.json`` in the trace dir)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)

    def reset(self) -> None:
        """Zero every family's samples (tests).  Families are kept —
        module-level instruments hold references to them, so dropping
        the objects would silently disconnect all instrumentation from
        the registry; clearing children resets values while `.labels()`
        keeps repopulating the same live families."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                m._children.clear()


def render_prometheus(
    snapshots: Sequence[Tuple[Dict[str, str], dict]],
) -> str:
    """Merge one or more JSON snapshots into a single valid Prometheus
    text page: one ``# HELP``/``# TYPE`` block per metric family even
    when every rank contributes samples (``extra_labels`` — typically
    ``{"rank": N}`` — distinguishes them).  This is what the rendezvous
    server's ``GET /metrics`` serves for the whole job."""
    # family name -> (type, help, [ (labels, sample_dict, le) ... ])
    families: Dict[str, list] = {}
    order: List[str] = []
    for extra, snap in snapshots:
        for name, entry in (snap.get("metrics") or {}).items():
            fam = families.get(name)
            if fam is None:
                families[name] = fam = [entry.get("type", "untyped"),
                                        entry.get("help", ""), []]
                order.append(name)
            for s in entry.get("samples", ()):
                labels = dict(s.get("labels") or {})
                labels.update(extra)
                fam[2].append((labels, s, entry.get("le")))
    lines: List[str] = []
    for name in order:
        kind, help_s, samples = families[name]
        if help_s:
            lines.append(f"# HELP {name} {help_s}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, s, le in samples:
            if kind == "histogram":
                counts = s.get("buckets") or []
                cum = 0
                for ub, n in zip(le or [], counts):
                    cum += n
                    bl = dict(labels)
                    bl["le"] = _fmt(float(ub))
                    lines.append(f"{name}_bucket{_label_str(bl)} {cum}")
                bl = dict(labels)
                bl["le"] = "+Inf"
                lines.append(
                    f"{name}_bucket{_label_str(bl)} {s.get('count', 0)}"
                )
                lines.append(
                    f"{name}_sum{_label_str(labels)} "
                    f"{_fmt(float(s.get('sum', 0.0)))}"
                )
                lines.append(
                    f"{name}_count{_label_str(labels)} {s.get('count', 0)}"
                )
            else:
                lines.append(
                    f"{name}{_label_str(labels)} "
                    f"{_fmt(float(s.get('value', 0.0)))}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


#: the process-wide registry every instrumented layer reports into
registry = MetricsRegistry()
