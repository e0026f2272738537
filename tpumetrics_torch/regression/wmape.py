"""WeightedMeanAbsolutePercentageError (port of ``tpumetrics/regression/wmape.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.mape import (
    _weighted_mean_absolute_percentage_error_compute,
    _weighted_mean_absolute_percentage_error_update,
)
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class WeightedMeanAbsolutePercentageError(Metric):
    """WMAPE: float32 sums of ``|t - p|`` and of ``|t|``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import WeightedMeanAbsolutePercentageError
        >>> metric = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> metric.update(torch.tensor([0.9, 15., 1.2e6]), torch.tensor([1., 10, 1e6]))
        >>> round(float(metric.compute()), 4)
        0.2
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    sum_abs_error: Tensor
    sum_scale: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("sum_scale", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.sum_scale = self.sum_scale + sum_scale

    def compute(self) -> Tensor:
        return _weighted_mean_absolute_percentage_error_compute(self.sum_abs_error, self.sum_scale)
