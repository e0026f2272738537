"""Wrapper metrics of the port (counterpart of ``tpumetrics/wrappers``)."""

from tpumetrics_torch.wrappers.abstract import WrapperMetric
from tpumetrics_torch.wrappers.bootstrapping import BootStrapper
from tpumetrics_torch.wrappers.classwise import ClasswiseWrapper
from tpumetrics_torch.wrappers.minmax import MinMaxMetric
from tpumetrics_torch.wrappers.multioutput import MultioutputWrapper
from tpumetrics_torch.wrappers.multitask import MultitaskWrapper
from tpumetrics_torch.wrappers.running import Running
from tpumetrics_torch.wrappers.tracker import MetricTracker

__all__ = [
    "BootStrapper",
    "ClasswiseWrapper",
    "MetricTracker",
    "MinMaxMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "Running",
    "WrapperMetric",
]
