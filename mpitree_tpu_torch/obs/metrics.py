"""Lock-safe serving metrics: counters, gauges, log-bucketed histograms.

Counterpart of ``mpitree_tpu/obs/metrics.py``, kept as its own copy (the
port never imports the JAX package). Each served
:class:`~mpitree_tpu_torch.serving.model.CompiledModel` keeps one
:class:`MetricsRegistry` (request and row counters, per-bucket latency
histograms, the stream stage's in-flight gauge); ``ModelRegistry`` and
the scheduler merge theirs into one Prometheus text exposition.

The design is the JAX module's, and so is its text, byte for byte, for
the same observations (``tests/test_torch_metrics.py``):

- **No sample storage.** :class:`Histogram` keeps integer counts in
  geometric buckets at ratio ``2**0.25``, so p50/p95/p99 come out within
  about 9% relative error at constant memory. The one opt-in exception,
  ``MPITREE_TPU_METRICS_EXEMPLARS=K``, keeps the K most recent raw values
  per bucket, shown as ``# exemplars`` comment lines; off by default.
- **One lock** per registry covers metric creation and every update:
  requests are served from many threads, and a lost increment would
  under-report traffic.
- **Prometheus text exposition**: counters and gauges as ``name{labels}
  value``, histograms as cumulative ``name_bucket{le="..."}`` series plus
  ``_sum``/``_count``; merged registries share one ``# TYPE`` line per
  family (:func:`render_text`).

Stdlib only: observation sits on the request path and touches no device.
"""

from __future__ import annotations

import math
import threading

from mpitree_tpu_torch.config import knobs

# Geometric bucket ratio: 2**(1/4) per bucket = 4 buckets per octave.
# Quantile estimates use the geometric midpoint of the winning bucket, so
# the worst-case relative error is sqrt(ratio) - 1 ≈ 9% — tight enough to
# tell a 1 ms p99 from a 10 ms one, at ~150 buckets across ns..hours.
_BUCKET_RATIO = 2.0 ** 0.25
_LOG_RATIO = math.log(_BUCKET_RATIO)


class Counter:
    """Monotonic counter. ``inc`` only; see ``set_total`` for mirrors."""

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, v=1) -> None:
        if v < 0:
            raise ValueError(f"counters only go up; got inc({v!r})")
        with self._lock:
            self._value += v

    def set_total(self, v) -> None:
        """Sync from an upstream monotonic source (a served model's retry
        and fallback counts) — takes the max so the mirror can never run
        a counter backwards."""
        with self._lock:
            self._value = max(self._value, float(v))

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (queue depth, inflight batches)."""

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, v=1) -> None:
        with self._lock:
            self._value += v

    def dec(self, v=1) -> None:
        with self._lock:
            self._value -= v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Log-bucketed distribution: quantiles without sample storage.

    Bucket ``i`` covers ``(ratio**(i-1), ratio**i]``; non-positive
    observations land in a dedicated zero bucket (quantile 0.0). The
    estimator returns the geometric midpoint of the bucket the target
    rank falls in, clamped to the observed [min, max] — so tiny
    populations degrade gracefully to exact extremes.
    """

    def __init__(self, lock):
        self._lock = lock
        self._buckets: dict = {}  # index -> count; None key = zero bucket
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        # Exemplar reservoir (knob read once at creation): K most recent
        # raw values per bucket, overwritten ring-style by the bucket's
        # own count. None = off, and observe() pays a single None check.
        k = knobs.value("MPITREE_TPU_METRICS_EXEMPLARS")
        self._exemplar_k = max(0, int(k or 0))
        self._exemplars: dict | None = {} if self._exemplar_k else None

    def observe(self, v) -> None:
        v = float(v)
        idx = None if v <= 0.0 else math.ceil(
            math.log(v) / _LOG_RATIO - 1e-9
        )
        with self._lock:
            n = self._buckets[idx] = self._buckets.get(idx, 0) + 1
            self.count += 1
            self.sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if self._exemplars is not None:
                ring = self._exemplars.get(idx)
                if ring is None:
                    ring = self._exemplars[idx] = []
                if len(ring) < self._exemplar_k:
                    ring.append(v)
                else:
                    ring[(n - 1) % self._exemplar_k] = v

    def quantile(self, q: float) -> float | None:
        """Estimated q-quantile (q in [0, 1]); None with no observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q!r}")
        with self._lock:
            if self.count == 0:
                return None
            if q == 0.0:
                return self._min
            if q == 1.0:
                return self._max
            target = q * self.count
            cum = 0.0
            # None (zero bucket) sorts first: it holds the smallest values
            for idx in sorted(
                self._buckets, key=lambda i: -math.inf if i is None else i
            ):
                cum += self._buckets[idx]
                if cum >= target:
                    if idx is None:
                        return max(0.0, self._min)
                    mid = _BUCKET_RATIO ** (idx - 0.5)
                    return min(max(mid, self._min), self._max)
            return self._max

    def snapshot(self) -> dict:
        """(upper_bound -> cumulative count) plus sum/count, for text
        exposition and ``serve_report_``."""
        with self._lock:
            cum = 0
            bounds = {}
            exemplars = {}
            for idx in sorted(
                self._buckets, key=lambda i: -math.inf if i is None else i
            ):
                cum += self._buckets[idx]
                bound = 0.0 if idx is None else _BUCKET_RATIO ** idx
                bounds[bound] = cum
                if self._exemplars is not None and self._exemplars.get(idx):
                    exemplars[bound] = list(self._exemplars[idx])
            snap = {"buckets": bounds, "count": self.count, "sum": self.sum}
            if self._exemplars is not None:
                # Key only present when the knob is on — snapshot shape
                # (and every golden pinning it) is unchanged by default.
                snap["exemplars"] = exemplars
            return snap


def _esc(v) -> str:
    """Prometheus label-value escaping: backslash, quote, newline —
    slot names are caller-controlled, and one raw ``\"`` would make the
    whole scrape endpoint unparseable."""
    return (
        str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _label_str(labels: dict, extra=None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{_esc(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + body + "}"


class MetricsRegistry:
    """Named metric families with label sets; one lock for everything."""

    _TYPES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}

    def __init__(self):
        self._lock = threading.RLock()
        # name -> (cls, {label_tuple: metric})
        self._families: dict = {}

    def _get(self, cls, name: str, labels: dict):
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = (cls, {})
            if fam[0] is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{self._TYPES[fam[0]]}, not {self._TYPES[cls]}"
                )
            metric = fam[1].get(key)
            if metric is None:
                metric = fam[1][key] = cls(self._lock)
            return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def render_families(self, extra_labels: dict | None = None) -> dict:
        """{family name: (prometheus type, [sample lines])}, sorted by
        name. The composable half of the exposition: merging several
        registries into ONE scrape (``ModelRegistry.metrics_text``) must
        group samples under a single ``# TYPE`` line per family — the
        Prometheus text parser rejects duplicate TYPE lines, so naive
        per-registry concatenation would fail the whole scrape."""
        with self._lock:
            families = {
                name: (cls, dict(children))
                for name, (cls, children) in self._families.items()
            }
        out: dict = {}
        for name in sorted(families):
            cls, children = families[name]
            lines: list = []
            for key in sorted(children):
                metric = children[key]
                labels = dict(key)
                if cls is Histogram:
                    snap = metric.snapshot()
                    exemplars = snap.get("exemplars") or {}
                    c = 0
                    for bound, c in snap["buckets"].items():
                        le = _label_str(
                            labels, {**(extra_labels or {}),
                                     "le": f"{bound:.9g}"}
                        )
                        lines.append(f"{name}_bucket{le} {c}")
                        if bound in exemplars:
                            # Comment lines (not TYPE/HELP) are ignored
                            # by exposition parsers — the scrape stays
                            # valid with exemplars on.
                            vals = ",".join(
                                f"{v:.9g}" for v in exemplars[bound]
                            )
                            lines.append(
                                f"# exemplars {name}_bucket{le} [{vals}]"
                            )
                    inf = _label_str(
                        labels, {**(extra_labels or {}), "le": "+Inf"}
                    )
                    lines.append(f"{name}_bucket{inf} {snap['count']}")
                    ls = _label_str(labels, extra_labels)
                    lines.append(f"{name}_sum{ls} {snap['sum']:.9g}")
                    lines.append(f"{name}_count{ls} {snap['count']}")
                else:
                    ls = _label_str(labels, extra_labels)
                    v = metric.value
                    val = f"{int(v)}" if float(v).is_integer() else f"{v:.9g}"
                    lines.append(f"{name}{ls} {val}")
            out[name] = (self._TYPES[cls], lines)
        return out

    def metrics_text(self, extra_labels: dict | None = None) -> str:
        """Prometheus text exposition of every family.

        ``extra_labels`` merge into each sample's label set — how
        ``ModelRegistry.metrics_text`` stamps per-slot ``model=...``
        labels onto each published model's private registry.
        """
        return render_text([self.render_families(extra_labels)])

    def snapshot(self) -> dict:
        """Plain-dict view:
        {name: {label_str: value-or-histogram-snapshot}}."""
        with self._lock:
            families = {
                name: (cls, dict(children))
                for name, (cls, children) in self._families.items()
            }
        out: dict = {}
        for name, (cls, children) in families.items():
            fam: dict = {}
            for key, metric in children.items():
                label = _label_str(dict(key)) or ""
                fam[label] = (
                    metric.snapshot() if cls is Histogram else metric.value
                )
            out[name] = fam
        return out


def render_text(family_maps: list) -> str:
    """Merge ``render_families`` maps into one exposition: one ``# TYPE``
    line per family name, all contributors' samples grouped under it.
    Conflicting types for the same name raise — two registries must not
    silently publish a counter and a gauge under one family."""
    merged: dict = {}
    for fams in family_maps:
        for name, (tname, lines) in fams.items():
            prev = merged.get(name)
            if prev is None:
                merged[name] = (tname, list(lines))
            else:
                if prev[0] != tname:
                    raise TypeError(
                        f"metric {name!r} exposed as both {prev[0]} "
                        f"and {tname} across merged registries"
                    )
                prev[1].extend(lines)
    out: list = []
    for name in sorted(merged):
        tname, lines = merged[name]
        out.append(f"# TYPE {name} {tname}")
        out.extend(lines)
    return "\n".join(out) + ("\n" if out else "")


# The process-default registry (module-level convenience for exporters
# that want one scrape surface); serving models keep their own private
# registries so per-model latency never mixes across slots.
DEFAULT = MetricsRegistry()


def metrics_text() -> str:
    """Text exposition of the process-default registry."""
    return DEFAULT.metrics_text()
