"""LogCoshError (port of ``tpumetrics/regression/log_cosh.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.log_cosh import _log_cosh_error_compute, _log_cosh_error_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.regression.mse import _check_num_outputs

Tensor = torch.Tensor


class LogCoshError(Metric):
    """LogCosh error: a float32 sum per output and an int32 row count.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import LogCoshError
        >>> metric = LogCoshError(device="cpu")
        >>> metric.update(torch.tensor([3.0, 5.0, 2.5, 7.0]), torch.tensor([2.5, 5.0, 4.0, 8.0]))
        >>> round(float(metric.compute()), 4)
        0.3523
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    sum_log_cosh_error: Tensor
    total: Tensor

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = _check_num_outputs(num_outputs)
        self.add_state("sum_log_cosh_error", torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_log_cosh_error, num_obs = _log_cosh_error_update(preds, target, self.num_outputs)
        self.sum_log_cosh_error = self.sum_log_cosh_error + sum_log_cosh_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _log_cosh_error_compute(self.sum_log_cosh_error, self.total)
