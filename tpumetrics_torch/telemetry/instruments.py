"""Low-overhead instruments: counters, gauges, fixed-bucket histograms
(counterpart of ``tpumetrics/telemetry/instruments.py``, the same code: it
is pure Python, so the port keeps its own copy).

Where spans (the JAX package's ``telemetry.spans``) answer "where did THIS
batch's time go", instruments answer "what is the distribution" — cheaply
enough to sit on the submit path of a 1000-stream service: one
``observe()`` is a flag test, a label-tuple dict lookup, a bisect over a
dozen bucket edges, and four integer/float updates under a per-instrument
lock.  No allocation after the first observation of a label set.

The registry is **process-global and get-or-create**: any module may call
:func:`counter`/:func:`gauge`/:func:`histogram` with the same name and get
the same instrument (a type or label mismatch raises — names are a
contract).  ``bench.py`` and ``stats()`` read the same histograms the
runtime writes, and :func:`tpumetrics_torch.telemetry.export.prometheus_text`
exposes the whole registry in Prometheus text format.

Label cardinality is the caller's budget (see ``docs/observability.md``):
every distinct label tuple materializes one series.  The runtime labels by
stream/tenant id — thousands are fine (a histogram series is ~20 numbers);
never label by batch content or shape.

Instruments default **enabled** (unlike spans, they are cheap enough to
leave on); :func:`disable` turns every ``inc``/``set``/``observe`` into a
single flag test for processes that want literally zero accounting.

Histogram quantiles are estimated from the fixed buckets (linear
interpolation inside the covering bucket; the overflow bucket reports the
exact tracked ``max``), so a ``p99`` is only as fine as the bucket grid —
the default millisecond grid resolves sub-millisecond latencies, which is
what the soak gate needs.  ``sum``/``count``/``max`` are exact.

**Sketch mode** (``histogram(..., sketch=True)``) additionally folds every
observation into a sparse host-side log-linear sketch with EXACTLY the
geometry of :class:`tpumetrics_torch.monitoring.sketch.SketchLayout` (levels ×
capacity linear buckets per magnitude octave, mirrored per sign, exact
min/max envelope — a parity test pins the bin indices against the device
sketch).  Quantile reads then carry the sketch's documented bound —
**relative error ≤ 1/capacity** inside the covered magnitude range —
instead of fixed-grid interpolation, and because the sketch is a sparse
count map its merge is a plain key-wise sum: serialized series from N
processes federate into one exact-bound distribution
(the JAX package's ``telemetry.federate``).  The Prometheus exposition is
unchanged (the fixed ``le`` buckets still export); only ``quantile()``/
``summary()`` and the federation payload see the sketch.  Cost per
``observe``: one log2, two clips, one dict bump — the runtime's shared
submit/dispatch/restore histograms run in this mode.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Instrument",
    "SKETCH_CAPACITY",
    "SKETCH_LEVELS",
    "counter",
    "disable",
    "enable",
    "enabled",
    "gauge",
    "get_instrument",
    "histogram",
    "latency_section",
    "registry",
    "reset",
    "sketch_index",
    "sketch_quantile",
]

_ENABLED = True
_LOCK = threading.Lock()
_REGISTRY: "Dict[str, Instrument]" = {}

#: default latency grid (milliseconds): resolves the sub-ms enqueue-shaped
#: submit path and still covers multi-second stalls
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 10000.0,
)
#: default duration grid (seconds): XLA compile times
DEFAULT_S_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# -------------------------------------------------------- sketch geometry
#
# The host-side mirror of monitoring/sketch.py's SketchLayout index math —
# pure python so the submit path never touches a device.  Parameters default to
# the device sketch's defaults; a parity test pins the two bucket_index
# implementations against each other, so the geometry cannot drift.

#: default sketch geometry for sketch-mode histograms (matches
#: monitoring.sketch.SketchLayout defaults: relative error <= 1/capacity)
SKETCH_LEVELS = 44
SKETCH_CAPACITY = 64


def _sketch_unit(levels: int) -> float:
    return 2.0 ** (24 - levels)


def sketch_index(value: float, levels: int = SKETCH_LEVELS,
                 capacity: int = SKETCH_CAPACITY) -> int:
    """Flat sketch-slot index of one value (sign-mirrored, level-major) —
    bit-identical to ``SketchLayout.bucket_index`` on the same geometry."""
    unit = _sketch_unit(levels)
    a = abs(value)
    if a != a:  # NaN: bin like the device sketch's masked zero
        a = 0.0
    safe = max(a, unit * 2.0 ** -40)
    if math.isinf(safe):  # the device sketch's float-space clip to the top level
        lvl = levels - 1
    else:
        lvl = min(max(int(math.floor(math.log2(safe / unit))) + 1, 0), levels - 1)
    if lvl == 0:
        lo, width = 0.0, unit
    else:
        lo = width = unit * 2.0 ** (lvl - 1)
    if math.isinf(a):
        j = capacity - 1  # inf outliers clip into the top bucket, not wrap
    else:
        j = min(max(int((a - lo) * capacity / width), 0), capacity - 1)
    flat = lvl * capacity + j
    side = levels * capacity
    return flat + side if value < 0 else flat


def _sketch_rep(index: int, levels: int, capacity: int) -> float:
    """Signed bucket-midpoint representative value of one sketch slot."""
    unit = _sketch_unit(levels)
    side = levels * capacity
    sign = -1.0 if index >= side else 1.0
    flat = index - side if index >= side else index
    lvl, j = divmod(flat, capacity)
    if lvl == 0:
        lo, width = 0.0, unit
    else:
        lo = width = unit * 2.0 ** (lvl - 1)
    return sign * (lo + (j + 0.5) * (width / capacity))


def sketch_quantile(
    counts: Dict[int, float],
    q: float,
    *,
    minimum: float,
    maximum: float,
    levels: int = SKETCH_LEVELS,
    capacity: int = SKETCH_CAPACITY,
) -> Optional[float]:
    """q-quantile of a sparse sketch count map: midpoint lookup on the
    cumulative counts in ascending value order, clamped into the exact
    ``[minimum, maximum]`` envelope (``SketchLayout.quantile`` semantics).
    ``None`` on an empty sketch.  THE one copy of the read — live
    summaries and the federated merged view both call it."""
    total = sum(counts.values())
    if total <= 0:
        return None
    reps = sorted(
        (_sketch_rep(i, levels, capacity), c) for i, c in counts.items() if c > 0
    )
    rank = q * total
    cum = 0.0
    est = reps[-1][0]
    for rep, c in reps:
        cum += c
        if cum >= rank:
            est = rep
            break
    return min(max(est, minimum), maximum)

# shared instrument names the runtime registers (stats()/bench read these)
SUBMIT_LATENCY_MS = "tpumetrics_submit_latency_ms"
DISPATCH_LATENCY_MS = "tpumetrics_dispatch_latency_ms"
QUEUE_DEPTH = "tpumetrics_queue_depth"
TENANTS_LIVE = "tpumetrics_tenants_live"
JOURNAL_LEN = "tpumetrics_journal_len"
XLA_COMPILE_SECONDS = "tpumetrics_xla_compile_seconds"
RECOMPILES_TOTAL = "tpumetrics_recompiles_total"
DRIFT_SCORE = "tpumetrics_drift_score"
DRIFT_ALERTS = "tpumetrics_drift_alerts_total"
RESTORE_LATENCY_MS = "tpumetrics_restore_latency_ms"
DRAIN_LATENCY_MS = "tpumetrics_drain_latency_ms"
# device-side observability (telemetry/device.py + telemetry/health.py)
PROGRAM_FLOPS = "tpumetrics_program_flops"
PROGRAM_HBM_BYTES = "tpumetrics_program_hbm_bytes"
STATE_HBM_BYTES = "tpumetrics_state_hbm_bytes"
STATE_NONFINITE = "tpumetrics_state_nonfinite_total"
# SLO engine (telemetry/slo.py)
SLO_BURN_RATE = "tpumetrics_slo_burn_rate"
SLO_VIOLATIONS = "tpumetrics_slo_violations_total"
# tenant lifecycle (lifecycle/manager.py)
RESIDENT_TENANTS = "tpumetrics_resident_tenants"
HIBERNATED_BYTES = "tpumetrics_hibernated_bytes"
REVIVAL_LATENCY_MS = "tpumetrics_revival_latency_ms"
# fleet placement + migration (fleet/)
FLEET_RANKS = "tpumetrics_fleet_ranks"
ROUTING_EPOCH = "tpumetrics_routing_epoch"
MIGRATION_LATENCY_MS = "tpumetrics_migration_latency_ms"
MIGRATIONS_TOTAL = "tpumetrics_migrations_total"
AUTOSCALE_DECISIONS = "tpumetrics_autoscale_decisions_total"
# storage fault tolerance (resilience/storage.py + the evaluator's
# durability-degradation latch)
IO_RETRIES_TOTAL = "tpumetrics_io_retries_total"
DURABILITY_DEGRADED = "tpumetrics_durability_degraded"


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


class Instrument:
    """Base: a named family of label-keyed series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labels)
        self._lock = threading.Lock()

    def _check_labels(self, labels: Tuple[Any, ...]) -> None:
        if len(labels) != len(self.labelnames):
            raise ValueError(
                f"{self.kind} {self.name!r} takes {len(self.labelnames)} label "
                f"value(s) {self.labelnames}, got {len(labels)}"
            )

    def clear(self) -> None:
        raise NotImplementedError

    def collect(self) -> Iterator[Tuple[Tuple[str, ...], Any]]:
        """Yield ``(label_values, value)`` per series (export format)."""
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.kind,
            "name": self.name,
            "help": self.help,
            "labels": list(self.labelnames),
            "series": [
                {"label_values": list(lv), "value": v} for lv, v in self.collect()
            ],
        }


class Counter(Instrument):
    """Monotonically increasing count per label tuple."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()) -> None:
        super().__init__(name, help, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, n: float = 1.0, *labels: str) -> None:
        if not _ENABLED:
            return
        self._check_labels(labels)
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + n

    def value(self, *labels: str) -> float:
        with self._lock:
            if not self.labelnames:
                return self._values.get((), 0.0)
            if labels:
                return self._values.get(labels, 0.0)
            return sum(self._values.values())  # aggregate across label sets

    def remove(self, *labels: str) -> None:
        with self._lock:
            self._values.pop(labels, None)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def collect(self) -> Iterator[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            items = list(self._values.items())
        yield from items


class Gauge(Instrument):
    """Last-set value per label tuple (queue depth, live tenants, …)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()) -> None:
        super().__init__(name, help, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, *labels: str) -> None:
        if not _ENABLED:
            return
        self._check_labels(labels)
        with self._lock:
            self._values[labels] = float(value)

    def inc(self, n: float = 1.0, *labels: str) -> None:
        if not _ENABLED:
            return
        self._check_labels(labels)
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + n

    def dec(self, n: float = 1.0, *labels: str) -> None:
        self.inc(-n, *labels)

    def value(self, *labels: str) -> float:
        with self._lock:
            return self._values.get(labels, 0.0)

    def remove(self, *labels: str) -> None:
        with self._lock:
            self._values.pop(labels, None)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def collect(self) -> Iterator[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            items = list(self._values.items())
        yield from items


class _Series:
    __slots__ = ("counts", "sum", "count", "max", "min", "sketch")

    def __init__(self, n_buckets: int, sketch: bool = False) -> None:
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0
        self.max = 0.0
        self.min = float("inf")  # exact envelope (sketch-mode clamp)
        # sparse sketch-slot counts ({flat index: count}); None in plain mode
        self.sketch: Optional[Dict[int, float]] = {} if sketch else None


class Histogram(Instrument):
    """Fixed-bucket latency/duration distribution per label tuple.

    ``buckets`` are finite upper edges (an overflow ``+Inf`` bucket is
    implicit); ``sum``/``count``/``max`` are tracked exactly per series.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
        sketch: bool = False,
    ) -> None:
        super().__init__(name, help, labels)
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.edges = edges
        #: sketch mode (module docstring): quantiles carry the sketch's
        #: <= 1/capacity relative-error bound and series become federatable
        self.sketch = bool(sketch)
        self.sketch_levels = SKETCH_LEVELS
        self.sketch_capacity = SKETCH_CAPACITY
        self._series: Dict[Tuple[str, ...], _Series] = {}

    def observe(self, value: float, *labels: str) -> None:
        if not _ENABLED:
            return
        self._check_labels(labels)
        i = bisect_left(self.edges, value)
        si = (
            sketch_index(value, self.sketch_levels, self.sketch_capacity)
            if self.sketch
            else -1
        )
        with self._lock:
            row = self._series.get(labels)
            if row is None:
                row = self._series[labels] = _Series(len(self.edges) + 1, self.sketch)
            row.counts[i] += 1
            row.sum += value
            row.count += 1
            if value > row.max:
                row.max = value
            if value < row.min:
                row.min = value
            if row.sketch is not None:
                row.sketch[si] = row.sketch.get(si, 0.0) + 1.0

    # ------------------------------------------------------------- reading

    def _aggregate(self, labels: Optional[Tuple[str, ...]]) -> _Series:
        agg = _Series(len(self.edges) + 1, self.sketch)
        with self._lock:
            rows = (
                [self._series[labels]]
                if labels is not None and labels in self._series
                else ([] if labels is not None else list(self._series.values()))
            )
            for row in rows:
                for i, c in enumerate(row.counts):
                    agg.counts[i] += c
                agg.sum += row.sum
                agg.count += row.count
                agg.max = max(agg.max, row.max)
                agg.min = min(agg.min, row.min)
                if agg.sketch is not None and row.sketch is not None:
                    for si, c in row.sketch.items():
                        agg.sketch[si] = agg.sketch.get(si, 0.0) + c
        return agg

    def _quantile_of(self, agg: _Series, q: float) -> Optional[float]:
        if agg.count == 0:
            return None
        if agg.sketch:
            # sketch mode: bucket-midpoint lookup with the documented
            # <= 1/capacity relative-error bound, clamped to the exact
            # [min, max] envelope — SketchLayout.quantile semantics
            return sketch_quantile(
                agg.sketch, q, minimum=agg.min, maximum=agg.max,
                levels=self.sketch_levels, capacity=self.sketch_capacity,
            )
        rank = q * agg.count
        cum = 0.0
        for i, c in enumerate(agg.counts):
            prev = cum
            cum += c
            if cum >= rank and c > 0:
                if i == len(self.edges):  # overflow bucket: exact max
                    return agg.max
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i]
                frac = (rank - prev) / c
                return min(lo + (hi - lo) * frac, agg.max if agg.max > 0 else hi)
        return agg.max

    def quantile(self, q: float, *labels: str) -> Optional[float]:
        """Bucket-interpolated q-quantile (``labels`` empty = aggregate over
        every series).  ``None`` with no observations.  Values landing in
        the overflow bucket report the exact tracked max."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        return self._quantile_of(self._aggregate(labels if labels else None), q)

    def summary(self, *labels: str) -> Dict[str, Any]:
        """``{"count", "p50", "p90", "p99", "max"}`` for one label tuple (or
        the cross-label aggregate when no labels are given).  One locked
        aggregation serves all three quantiles — at 1000-series scale the
        scan, not the math, is the cost."""
        agg = self._aggregate(labels if labels else None)
        if agg.count == 0:
            return {"count": 0, "p50": None, "p90": None, "p99": None, "max": None}
        return {
            "count": agg.count,
            "p50": self._quantile_of(agg, 0.50),
            "p90": self._quantile_of(agg, 0.90),
            "p99": self._quantile_of(agg, 0.99),
            "max": agg.max,
        }

    def remove(self, *labels: str) -> None:
        """Drop one label tuple's series (a closed stream releasing its
        auto-minted label from the process-global registry)."""
        with self._lock:
            self._series.pop(labels, None)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def collect(self) -> Iterator[Tuple[Tuple[str, ...], Dict[str, Any]]]:
        with self._lock:
            rows = list(self._series.items())
        for lv, row in rows:
            data = {
                "buckets": list(zip(self.edges, row.counts[:-1])),
                "overflow": row.counts[-1],
                "sum": row.sum,
                "count": row.count,
                "max": row.max,
                "min": row.min if row.count else None,
            }
            if row.sketch is not None:
                # JSON-able sparse sketch state: the federation payload
                # (key-wise sum is the merge; telemetry/federate.py)
                data["sketch"] = {str(i): c for i, c in row.sketch.items()}
            yield lv, data

    def to_dict(self) -> Dict[str, Any]:
        out = super().to_dict()
        if self.sketch:
            out["sketch_params"] = {
                "levels": self.sketch_levels, "capacity": self.sketch_capacity,
            }
        return out


# ------------------------------------------------------------------ registry


def _get_or_create(cls: type, name: str, help: str, labels: Sequence[str], **kwargs: Any):
    with _LOCK:
        got = _REGISTRY.get(name)
        if got is not None:
            if type(got) is not cls or got.labelnames != tuple(labels):
                raise ValueError(
                    f"instrument {name!r} already registered as {got.kind} with "
                    f"labels {got.labelnames}; requested {cls.kind} with "
                    f"labels {tuple(labels)} — instrument names are a contract"
                )
            return got
        inst = cls(name, help=help, labels=labels, **kwargs)
        _REGISTRY[name] = inst
        return inst


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
    """Get-or-create the named :class:`Counter`."""
    return _get_or_create(Counter, name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    """Get-or-create the named :class:`Gauge`."""
    return _get_or_create(Gauge, name, help, labels)


def histogram(
    name: str,
    help: str = "",
    labels: Sequence[str] = (),
    buckets: Optional[Sequence[float]] = None,
    sketch: bool = False,
) -> Histogram:
    """Get-or-create the named :class:`Histogram` (``buckets`` and
    ``sketch`` only apply at creation; a later mismatched value is ignored
    — like the edges, the quantile mode is part of the first
    registration)."""
    return _get_or_create(
        Histogram, name, help, labels,
        buckets=tuple(buckets) if buckets is not None else DEFAULT_MS_BUCKETS,
        sketch=bool(sketch),
    )


def latency_section(stream: str) -> Dict[str, Any]:
    """The ``stats()["latency"]`` payload for one stream/tenant label:
    submit and device-dispatch latency summaries (p50/p90/p99/max/count)
    read from the shared runtime histograms.  All-``None`` summaries when
    nothing was observed (instruments disabled, or a fresh stream)."""
    return {
        "submit_ms": histogram(
            SUBMIT_LATENCY_MS, help="submit() call latency", labels=("stream",),
            sketch=True,
        ).summary(stream),
        "dispatch_ms": histogram(
            DISPATCH_LATENCY_MS, help="device dispatch latency", labels=("stream",),
            sketch=True,
        ).summary(stream),
    }


def registry() -> List[Instrument]:
    """Snapshot of every registered instrument (export order: by name)."""
    with _LOCK:
        return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_instrument(name: str) -> Optional[Instrument]:
    """The registered instrument, or ``None`` — a pure read (no
    get-or-create side effects: SLO signals and federation must observe
    the registry, never mint families)."""
    with _LOCK:
        return _REGISTRY.get(name)


def reset(full: bool = False) -> None:
    """Clear every instrument's series (``full=True`` drops registrations
    too — tests only; long-lived processes keep the families)."""
    with _LOCK:
        if full:
            _REGISTRY.clear()
            return
        insts = list(_REGISTRY.values())
    for inst in insts:
        inst.clear()
