"""RelativeSquaredError (port of ``tpumetrics/regression/rse.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.r2 import _r2_score_update
from tpumetrics_torch.functional.regression.rse import _relative_squared_error_compute
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class RelativeSquaredError(Metric):
    """RSE: float32 sums per output and an int32 row count.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import RelativeSquaredError
        >>> metric = RelativeSquaredError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))
        >>> round(float(metric.compute()), 4)
        0.0514
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    sum_squared_obs: Tensor
    sum_obs: Tensor
    sum_squared_error: Tensor
    total: Tensor

    def __init__(self, num_outputs: int = 1, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.squared = squared
        self.add_state("sum_squared_obs", torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_obs", torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_squared_error", torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
        self.sum_squared_obs = self.sum_squared_obs + sum_squared_obs
        self.sum_obs = self.sum_obs + sum_obs
        self.sum_squared_error = self.sum_squared_error + rss
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _relative_squared_error_compute(
            self.sum_squared_obs, self.sum_obs, self.sum_squared_error, self.total, self.squared
        )
