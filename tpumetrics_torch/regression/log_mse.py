"""MeanSquaredLogError (port of ``tpumetrics/regression/log_mse.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.log_mse import (
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
)
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class MeanSquaredLogError(Metric):
    """MSLE: a float32 sum and an int32 element count.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import MeanSquaredLogError
        >>> metric = MeanSquaredLogError(device="cpu")
        >>> metric.update(torch.tensor([0., 1, 2, 3]), torch.tensor([0., 1, 2, 2]))
        >>> round(float(metric.compute()), 4)
        0.0207
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    sum_squared_log_error: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_log_error, num_obs = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + sum_squared_log_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)
