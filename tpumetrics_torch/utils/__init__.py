"""Helpers of the port (counterpart of ``tpumetrics/utils``)."""

from tpumetrics_torch.utils.data import dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError, TPUMetricsUserWarning

__all__ = [
    "TPUMetricsUserError",
    "TPUMetricsUserWarning",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
]
