"""Explained variance (port of ``tpumetrics/functional/regression/explained_variance.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor

ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    """``(n, Σ(t - p), Σ(t - p)², Σ t, Σ t²)`` over dim 0."""
    _check_same_shape(preds, target)
    num_obs = preds.shape[0]
    diff = target - preds
    sum_error = torch.sum(diff, dim=0)
    sum_squared_error = torch.sum(diff * diff, dim=0)
    sum_target = torch.sum(target, dim=0)
    sum_squared_target = torch.sum(target * target, dim=0)
    return num_obs, sum_error, sum_squared_error, sum_target, sum_squared_target


def _explained_variance_compute(
    num_obs: Union[int, Tensor],
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    diff_avg = sum_error / num_obs
    numerator = sum_squared_error / num_obs - diff_avg * diff_avg
    target_avg = sum_target / num_obs
    denominator = sum_squared_target / num_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    output_scores = torch.where(
        nonzero_numerator & nonzero_denominator,
        1.0 - numerator / torch.where(nonzero_denominator, denominator, 1.0),
        torch.where(nonzero_numerator, 0.0, 1.0),
    )
    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        return torch.sum(denominator / torch.sum(denominator) * output_scores)
    raise ValueError(f"Argument `multioutput` must be one of {ALLOWED_MULTIOUTPUT}, but got {multioutput}")


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Explained variance.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import explained_variance
        >>> round(float(explained_variance(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))), 4)
        0.9572
    """
    if multioutput not in ALLOWED_MULTIOUTPUT:
        raise ValueError(f"Argument `multioutput` must be one of {ALLOWED_MULTIOUTPUT}, but got {multioutput}")
    num_obs, sum_error, ss_error, sum_target, ss_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(num_obs, sum_error, ss_error, sum_target, ss_target, multioutput)
