"""Wrapper metrics of the port (counterpart of ``tpumetrics/wrappers``)."""

from tpumetrics_torch.wrappers.abstract import WrapperMetric
from tpumetrics_torch.wrappers.running import Running

__all__ = ["Running", "WrapperMetric"]
