"""Drift monitors: live sketch vs a frozen reference distribution
(counterpart of ``tpumetrics/monitoring/drift.py``).

A drift monitor is an ordinary sketch-backed metric (state = the mergeable
``(slots, N)`` sketch of :mod:`tpumetrics_torch.monitoring.sketch`,
optionally windowed) whose ``compute()`` returns a **divergence score**
between the live distribution and a reference frozen at construction:

========================= =============================================
:class:`PSI`              population stability index
                          ``sum((p - q) * ln(p / q))`` over the score
                          bins (eps-smoothed); rule of thumb: < 0.1
                          stable, > 0.25 shifted
:class:`KLDrift`          ``KL(live || reference)`` over the score bins
                          (eps-smoothed)
:class:`KSDistance`       Kolmogorov–Smirnov statistic: the max CDF gap
                          between the live histogram and the reference,
                          in ``[0, 1]``
========================= =============================================

The reference goes through the *same* exact sketch binning once, on the
host, at construction, and is kept as plain (non-state) bucket masses.
``reference_digest`` (the sha1 of its float32 ordered counts) equals the JAX
package's for a reference with no value on a bucket edge that the JAX
binning misplaces (see the sketch module's note).

The scores read the live counts exactly: each score bin is a contiguous run
of sketch buckets (the assignment is fixed at construction and
non-decreasing in the canonical order), so a bin's count is a difference of
the float64 cumulative counts at its ends, with no float atomics; KS
divides the exact cumulative counts by the total once. The scores are then
taken in float64 and returned as float32.

**Alerting** is a host-side ``compute()`` effect (``update()`` never reads
the host): every score refreshes the ``tpumetrics_drift_score{stream,
monitor}`` gauge, and an upward threshold crossing emits ONE
``drift_alert`` ledger event and bumps
``tpumetrics_drift_alerts_total{stream,monitor}``. The alert then latches:
it re-arms only after the score falls below ``threshold - hysteresis``. The
stream label comes from :func:`stream_scope` (``""`` outside one), and
latches are kept **per stream**.
"""

from __future__ import annotations

import hashlib
import threading
from contextlib import contextmanager
from typing import Any, Dict, Generator, Optional

import numpy as np
import torch

from tpumetrics_torch.monitoring.sketch import _SketchBacked
from tpumetrics_torch.telemetry import instruments as _instruments
from tpumetrics_torch.telemetry import ledger as _telemetry
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

Tensor = torch.Tensor

__all__ = [
    "DriftMonitor",
    "KLDrift",
    "KSDistance",
    "PSI",
    "current_stream",
    "monitoring_stats",
    "release_stream",
    "stream_scope",
]

_DRIFT_GAUGE = _instruments.gauge(
    _instruments.DRIFT_SCORE, help="latest drift-monitor score", labels=("stream", "monitor")
)
_DRIFT_ALERTS = _instruments.counter(
    _instruments.DRIFT_ALERTS,
    help="drift threshold crossings (hysteresis-latched)",
    labels=("stream", "monitor"),
)

_SCOPE = threading.local()


@contextmanager
def stream_scope(stream: str) -> Generator[None, None, None]:
    """Ambient stream/tenant label for drift bookkeeping on this thread, so
    one shared metric instance keeps per-tenant scores, latches and gauge
    series apart."""
    prev = getattr(_SCOPE, "stream", "")
    _SCOPE.stream = str(stream)
    try:
        yield
    finally:
        _SCOPE.stream = prev


def current_stream() -> str:
    return getattr(_SCOPE, "stream", "")


class DriftMonitor(_SketchBacked):
    """Base class: live sketch vs frozen reference + threshold alerting.

    Args:
        reference: reference sample values (array-like or tensor), binned
            once at construction through this monitor's own sketch layout.
        threshold: score at or above which a ``drift_alert`` fires.
        hysteresis: re-arm margin: after an alert, the latch clears only
            once the score drops below ``threshold - hysteresis``.
        score_bins: PSI/KL are scored over this many **equal-reference-mass
            groups** of sketch buckets (assignment frozen at construction).
            KS ignores it.
        eps: probability floor for the PSI/KL ratio terms (ignored by KS).
        name: monitor label for telemetry (default: the class name).
        window / slots / levels / capacity / unit: sketch geometry
            (:class:`~tpumetrics_torch.monitoring.sketch._SketchBacked`).
    """

    higher_is_better = False

    def __init__(
        self,
        reference: Any,
        threshold: float = 0.25,
        hysteresis: float = 0.0,
        score_bins: int = 10,
        eps: float = 1e-6,
        name: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.threshold = float(threshold)
        self.hysteresis = float(hysteresis)
        self.eps = float(eps)
        self.score_bins = int(score_bins)
        if self.hysteresis < 0:
            raise TPUMetricsUserError(f"hysteresis must be >= 0, got {hysteresis}")
        if self.score_bins < 2:
            raise TPUMetricsUserError(f"score_bins must be >= 2, got {score_bins}")
        self.monitor_name = str(name) if name is not None else type(self).__name__
        ref = torch.as_tensor(reference).detach().to(device="cpu", dtype=self._dtype)
        ref = ref.reshape(-1)[torch.isfinite(ref.reshape(-1))]
        if ref.numel() == 0:
            raise TPUMetricsUserError(f"{type(self).__name__} needs a non-empty finite reference sample.")
        layout = self._sketch_layout
        idx = layout.bucket_index(ref).numpy()
        flat = np.bincount(idx, minlength=2 * layout.side).astype(np.float32)
        counts = np.concatenate([flat[layout.side :][::-1], flat[: layout.side]])
        self._ref_pmf = (counts / max(float(np.float32(ref.numel())), 1.0)).astype(np.float32)
        # sketch bucket -> score-bin assignment at equal reference mass
        # (midpoint-CDF rule; zero-mass tail buckets join the edge bins, so
        # out-of-reference-range live data still shows up as edge-bin mass)
        cdf = np.cumsum(self._ref_pmf, dtype=np.float64)
        mid = cdf - 0.5 * self._ref_pmf
        self._score_assign = np.clip((mid * self.score_bins).astype(np.int32), 0, self.score_bins - 1)
        self._ref_binned = np.bincount(self._score_assign, weights=self._ref_pmf, minlength=self.score_bins).astype(
            np.float32
        )
        # each score bin is a contiguous run of buckets: its end in the canonical order
        self._bin_ends = np.searchsorted(self._score_assign, np.arange(self.score_bins), side="right")
        # content hash of the binned reference (a snapshot restored into a
        # monitor frozen against a different reference must fail loudly)
        self.reference_digest = hashlib.sha1(counts.tobytes()).hexdigest()
        self._on_device: Dict[torch.device, Dict[str, Tensor]] = {}
        # per-stream host bookkeeping: {stream: {score, active, alerts}},
        # under a lock: an unguarded check-then-act on the latch would page
        # one crossing twice from two threads
        self._stream_state: Dict[str, Dict[str, Any]] = {}
        self._alert_lock = threading.Lock()

    def _reference_on(self, device: torch.device) -> Dict[str, Tensor]:
        """The frozen reference's score-time constants on ``device``
        (copied once per device, at the first ``compute()`` there)."""
        if device not in self._on_device:
            self._on_device[device] = {
                "binned": torch.from_numpy(self._ref_binned.astype(np.float64)).to(device),
                "cdf": torch.from_numpy(np.cumsum(self._ref_pmf, dtype=np.float64)).to(device),
                "ends": torch.from_numpy(self._bin_ends.astype(np.int64)).to(device),
            }
        return self._on_device[device]

    def _binned(self, cumulative: Tensor) -> Tensor:
        """Live counts per score bin from the float64 cumulative counts:
        differences at the bins' ends (an empty bin counts 0)."""
        at_ends = torch.cat([cumulative.new_zeros(1), cumulative])[self._reference_on(cumulative.device)["ends"]]
        return torch.diff(at_ends, prepend=cumulative.new_zeros(1))

    # locks don't deepcopy or pickle: a copy gets a fresh one (the latch
    # state itself is plain data and copies)
    def __getstate__(self) -> Dict[str, Any]:
        state = super().__getstate__()
        state.pop("_alert_lock", None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self._alert_lock = threading.Lock()

    # ----------------------------------------------------------------- score

    def _score(self, cumulative: Tensor, total: Tensor) -> Tensor:
        """The score (float64) from the live cumulative ordered counts and
        the live total (at least 1)."""
        raise NotImplementedError

    def drift_score(self) -> Tensor:
        """The pure score (no alerting side effects): live sketch vs the
        frozen reference; ``0`` before any live data."""
        layout = self._sketch_layout
        row = self.merged_row()
        total = layout.total(row).to(torch.float64)
        score = self._score(layout.cumulative_counts(row), torch.clamp(total, min=1.0))
        return torch.where(total > 0, score, 0.0).to(self._dtype)

    def compute(self) -> Tensor:
        score = self.drift_score()
        self._maybe_alert(score)
        return score

    # -------------------------------------------------------------- alerting

    def _runtime(self, stream: str) -> Dict[str, Any]:
        entry = self._stream_state.get(stream)
        if entry is None:
            entry = {"score": None, "active": False, "alerts": 0}
            self._stream_state[stream] = entry
        return entry

    def _maybe_alert(self, score: Tensor) -> None:
        """Host-side: gauge refresh + hysteresis-latched threshold alert.
        The whole read-modify-write runs under the alert lock, so two
        threads computing at once cannot fire one crossing twice."""
        value = float(score)
        stream = current_stream()
        with self._alert_lock:
            entry = self._runtime(stream)
            entry["score"] = value
            if _instruments.enabled():
                _DRIFT_GAUGE.set(value, stream, self.monitor_name)
            if value >= self.threshold and not entry["active"]:
                entry["active"] = True
                entry["alerts"] += 1
                if _instruments.enabled():
                    _DRIFT_ALERTS.inc(1, stream, self.monitor_name)
                _telemetry.record_event(
                    self._active_backend(),
                    "drift_alert",
                    monitor=self.monitor_name,
                    metric=type(self).__name__,
                    stream=stream,
                    score=value,
                    threshold=self.threshold,
                )
            elif entry["active"] and value < self.threshold - self.hysteresis:
                entry["active"] = False

    def monitoring_entry(self, stream: Optional[str] = None) -> Dict[str, Any]:
        """This monitor's telemetry view for one stream."""
        with self._alert_lock:
            entry = dict(self._runtime(current_stream() if stream is None else stream))
        return {
            "monitor": type(self).__name__,
            "score": entry["score"],
            "threshold": self.threshold,
            "hysteresis": self.hysteresis,
            "alert_active": entry["active"],
            "alerts": entry["alerts"],
            "window": self.window,
        }


def _smoothed(p: Tensor, eps: float) -> Tensor:
    return torch.clamp(p, eps, 1.0)


class PSI(DriftMonitor):
    """Population stability index between the live sketch and the reference.

    Example:
        >>> import numpy as np
        >>> from tpumetrics_torch.monitoring import PSI
        >>> rng = np.random.default_rng(0)
        >>> ref = rng.normal(0.0, 1.0, 4000)
        >>> m = PSI(reference=ref, threshold=0.25, device="cpu")
        >>> m.update(rng.normal(0.0, 1.0, 4000))  # same distribution
        >>> bool(m.compute() < 0.1)
        True
    """

    def _score(self, cumulative: Tensor, total: Tensor) -> Tensor:
        p = _smoothed(self._binned(cumulative) / total, self.eps)
        q = _smoothed(self._reference_on(cumulative.device)["binned"], self.eps)
        return ((p - q) * torch.log(p / q)).sum()


class KLDrift(DriftMonitor):
    """``KL(live || reference)`` over the shared score bins.

    Example:
        >>> import numpy as np
        >>> from tpumetrics_torch.monitoring import KLDrift
        >>> ref = np.arange(1.0, 1001.0)
        >>> m = KLDrift(reference=ref, threshold=0.25, device="cpu")
        >>> m.update(ref + 2000.0)  # the live stream moved entirely
        >>> bool(m.compute() > 0.25)
        True
    """

    def _score(self, cumulative: Tensor, total: Tensor) -> Tensor:
        p = _smoothed(self._binned(cumulative) / total, self.eps)
        q = _smoothed(self._reference_on(cumulative.device)["binned"], self.eps)
        return (p * torch.log(p / q)).sum()


class KSDistance(DriftMonitor):
    """Kolmogorov–Smirnov distance between the live (windowed) histogram's
    CDF and the reference CDF: scale-free, bounded in ``[0, 1]``.

    Example:
        >>> import numpy as np
        >>> from tpumetrics_torch.monitoring import KSDistance
        >>> ref = np.arange(1.0, 1001.0)
        >>> m = KSDistance(reference=ref, threshold=0.5, device="cpu")
        >>> m.update(ref)  # live matches the reference
        >>> bool(m.compute() < 0.05)
        True
    """

    def _score(self, cumulative: Tensor, total: Tensor) -> Tensor:
        return (cumulative / total - self._reference_on(cumulative.device)["cdf"]).abs().amax()


# ----------------------------------------------------------- runtime surface


def _iter_monitors(metric: Any):
    from tpumetrics_torch.collections import MetricCollection

    if isinstance(metric, MetricCollection):
        for key, member in metric._modules.items():
            if isinstance(member, DriftMonitor):
                yield key, member
    elif isinstance(metric, DriftMonitor):
        yield metric.monitor_name, metric


def monitoring_stats(metric: Any, stream: str) -> Dict[str, Dict[str, Any]]:
    """The monitoring section for one stream: every :class:`DriftMonitor`
    in ``metric`` (a bare monitor or a collection member), keyed by its
    collection key / monitor name. Empty when the metric has no monitors."""
    return {key: mon.monitoring_entry(stream) for key, mon in _iter_monitors(metric)}


def release_stream(metric: Any, stream: str) -> None:
    """Drop one stream's drift bookkeeping and its gauge/counter label
    series (a closed stream must not leave dead series behind)."""
    for _key, mon in _iter_monitors(metric):
        with mon._alert_lock:
            mon._stream_state.pop(stream, None)
        _DRIFT_GAUGE.remove(stream, mon.monitor_name)
        _DRIFT_ALERTS.remove(stream, mon.monitor_name)
