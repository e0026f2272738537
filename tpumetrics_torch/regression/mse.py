"""MeanSquaredError (port of ``tpumetrics/regression/mse.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


def _check_num_outputs(num_outputs: int) -> int:
    if not (isinstance(num_outputs, int) and num_outputs > 0):
        raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
    return num_outputs


class MeanSquaredError(Metric):
    """MSE, or RMSE with ``squared=False``: a float32 sum of squared errors
    per output and an int32 row count.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import MeanSquaredError
        >>> metric = MeanSquaredError(device="cpu")
        >>> metric.update(torch.tensor([0., 1, 2, 3]), torch.tensor([0., 1, 2, 2]))
        >>> round(float(metric.compute()), 4)
        0.25
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    sum_squared_error: Tensor
    total: Tensor

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared
        self.num_outputs = _check_num_outputs(num_outputs)
        self.add_state("sum_squared_error", torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, num_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, self.squared)
