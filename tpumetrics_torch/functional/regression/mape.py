"""Mean absolute percentage error family: MAPE, SMAPE and WMAPE (port of
``tpumetrics/functional/regression/mape.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor

_EPSILON = 1.17e-06


def _mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = _EPSILON
) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target), min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: Union[int, Tensor]) -> Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAPE.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import mean_absolute_percentage_error
        >>> target = torch.tensor([1., 10, 1e6])
        >>> preds = torch.tensor([0.9, 15, 1.2e6])
        >>> round(float(mean_absolute_percentage_error(preds, target)), 4)
        0.2667
    """
    sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)


def _symmetric_mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = _EPSILON
) -> Tuple[Tensor, int]:
    """Sum of ``2|t - p| / max(|t| + |p|, eps)`` and the element count."""
    _check_same_shape(preds, target)
    arr = 2 * torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return torch.sum(arr), target.numel()


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """SMAPE.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import symmetric_mean_absolute_percentage_error
        >>> target = torch.tensor([1., 10, 1e6])
        >>> preds = torch.tensor([0.9, 15, 1.2e6])
        >>> round(float(symmetric_mean_absolute_percentage_error(preds, target)), 4)
        0.229
    """
    sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return sum_abs_per_error / num_obs


def _weighted_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Sum of ``|t - p|`` and sum of ``|t|``."""
    _check_same_shape(preds, target)
    sum_abs_error = torch.sum(torch.abs((preds - target).reshape(-1)))
    sum_scale = torch.sum(torch.abs(target.reshape(-1)))
    return sum_abs_error, sum_scale


def _weighted_mean_absolute_percentage_error_compute(
    sum_abs_error: Tensor, sum_scale: Tensor, epsilon: float = _EPSILON
) -> Tensor:
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """WMAPE.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import weighted_mean_absolute_percentage_error
        >>> target = torch.tensor([1., 10, 1e6])
        >>> preds = torch.tensor([0.9, 15, 1.2e6])
        >>> round(float(weighted_mean_absolute_percentage_error(preds, target)), 4)
        0.2
    """
    sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(sum_abs_error, sum_scale)
