"""MeanAbsoluteError (port of ``tpumetrics/regression/mae.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class MeanAbsoluteError(Metric):
    """MAE: a float32 sum and an int32 element count.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import MeanAbsoluteError
        >>> metric = MeanAbsoluteError(device="cpu")
        >>> metric.update(torch.tensor([0., 1, 2, 3]), torch.tensor([0., 1, 2, 1]))
        >>> round(float(metric.compute()), 4)
        0.5
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    sum_abs_error: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_error, num_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)
