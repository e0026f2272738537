"""SymmetricMeanAbsolutePercentageError (port of ``tpumetrics/regression/symmetric_mape.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.mape import _symmetric_mean_absolute_percentage_error_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class SymmetricMeanAbsolutePercentageError(Metric):
    """SMAPE: a float32 sum and an int32 element count.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import SymmetricMeanAbsolutePercentageError
        >>> metric = SymmetricMeanAbsolutePercentageError(device="cpu")
        >>> metric.update(torch.tensor([0.9, 15., 1.2e6]), torch.tensor([1., 10, 1e6]))
        >>> round(float(metric.compute()), 4)
        0.229
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    sum_abs_per_error: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return self.sum_abs_per_error / self.total
