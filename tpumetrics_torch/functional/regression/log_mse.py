"""Mean squared log error (port of ``tpumetrics/functional/regression/log_mse.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    sum_squared_log_error = torch.sum(torch.pow(torch.log1p(preds) - torch.log1p(target), 2))
    return sum_squared_log_error, target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, num_obs: Union[int, Tensor]) -> Tensor:
    return sum_squared_log_error / num_obs


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """MSLE.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import mean_squared_log_error
        >>> round(float(mean_squared_log_error(torch.tensor([0., 1, 2, 3]), torch.tensor([0., 1, 2, 2]))), 4)
        0.0207
    """
    sum_squared_log_error, num_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, num_obs)
