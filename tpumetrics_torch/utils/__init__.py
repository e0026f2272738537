"""Helpers of the port (counterpart of ``tpumetrics/utils``)."""

from tpumetrics_torch.utils.checks import check_forward_full_state_property
from tpumetrics_torch.utils.data import (
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    select_topk,
    to_categorical,
    to_onehot,
)
from tpumetrics_torch.utils.distributed import class_reduce, gather_all_tensors, reduce
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError, TPUMetricsUserWarning
from tpumetrics_torch.utils.prints import rank_zero_debug, rank_zero_info, rank_zero_warn

__all__ = [
    "check_forward_full_state_property",
    "class_reduce",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "gather_all_tensors",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_warn",
    "reduce",
    "select_topk",
    "to_categorical",
    "to_onehot",
    "TPUMetricsUserError",
    "TPUMetricsUserWarning",
]
