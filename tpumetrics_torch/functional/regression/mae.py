"""Mean absolute error (port of ``tpumetrics/functional/regression/mae.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from tpumetrics_torch.utils.checks import _check_same_shape
from tpumetrics_torch.utils.compute import _as_float

Tensor = torch.Tensor


def _mean_absolute_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    """Sum of absolute errors over every element, and the element count."""
    _check_same_shape(preds, target)
    return torch.sum(torch.abs(_as_float(preds) - _as_float(target))), target.numel()


def _mean_absolute_error_compute(sum_abs_error: Tensor, num_obs: Union[int, Tensor]) -> Tensor:
    return sum_abs_error / num_obs


def mean_absolute_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAE.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import mean_absolute_error
        >>> round(float(mean_absolute_error(torch.tensor([0., 1, 2, 3]), torch.tensor([0., 1, 2, 1]))), 4)
        0.5
    """
    sum_abs_error, num_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, num_obs)
