"""Mean squared error (port of ``tpumetrics/functional/regression/mse.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, int]:
    """Sum of squared errors (per output) and the number of rows."""
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = preds - target
    return torch.sum(diff * diff, dim=0), target.shape[0]


def _mean_squared_error_compute(sum_squared_error: Tensor, num_obs: Union[int, Tensor], squared: bool = True) -> Tensor:
    mse = sum_squared_error / num_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    """MSE (or RMSE with ``squared=False``).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import mean_squared_error
        >>> round(float(mean_squared_error(torch.tensor([0., 1, 2, 3]), torch.tensor([0., 1, 2, 2]))), 4)
        0.25
    """
    sum_squared_error, num_obs = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, num_obs, squared)
