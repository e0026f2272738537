"""Continuous-monitoring metrics: windows, decay, sketches, drift
(counterpart of ``tpumetrics/monitoring``).

Unbounded serving streams where "the metric" is a sliding window, a decayed
average, a streaming quantile or a drift score, all with fixed-shape,
mergeable state, so sync and the fused collection update carry them
unchanged.
"""

from tpumetrics_torch.monitoring.drift import (
    PSI,
    DriftMonitor,
    KLDrift,
    KSDistance,
    current_stream,
    monitoring_stats,
    release_stream,
    stream_scope,
)
from tpumetrics_torch.monitoring.sketch import (
    SketchLayout,
    SketchQuantiles,
    empty_sketch,
    sketch_merge,
)
from tpumetrics_torch.monitoring.windowed import (
    DecayedMean,
    WindowedMax,
    WindowedMean,
    WindowedMin,
    WindowedSum,
)

__all__ = [
    "DecayedMean",
    "DriftMonitor",
    "KLDrift",
    "KSDistance",
    "PSI",
    "SketchLayout",
    "SketchQuantiles",
    "WindowedMax",
    "WindowedMean",
    "WindowedMin",
    "WindowedSum",
    "current_stream",
    "empty_sketch",
    "monitoring_stats",
    "release_stream",
    "sketch_merge",
    "stream_scope",
]
