"""R² score (port of ``tpumetrics/functional/regression/r2.py``).

The update keeps sums only. ``compute`` reads the observation count on the
host (at least two samples, the adjusted score's fall-backs), as the JAX
package does outside ``jit``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from tpumetrics_torch.utils.checks import _check_same_shape
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    """``(Σ t², Σ t, Σ (t - p)², n)`` over dim 0."""
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors, but received tensors with dimension"
            f" {tuple(preds.shape)}"
        )
    sum_obs = torch.sum(target, dim=0)
    sum_squared_obs = torch.sum(target * target, dim=0)
    residual = target - preds
    rss = torch.sum(residual * residual, dim=0)
    return sum_squared_obs, sum_obs, rss, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    rss: Tensor,
    num_obs: Union[int, Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    n = int(num_obs)
    if n < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")

    mean_obs = sum_obs / num_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    cond = tss == 0
    raw_scores = torch.where(cond, 0.0, 1 - (rss / torch.where(cond, 1.0, tss)))

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        r2 = torch.sum(tss / torch.sum(tss) * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if not isinstance(adjusted, int) or adjusted < 0:
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0:
        if adjusted > n - 1:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == n - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            return 1 - (1 - r2) * (num_obs - 1) / (num_obs - adjusted - 1)
    return r2


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    """R² score.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import r2_score
        >>> round(float(r2_score(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))), 4)
        0.9486
    """
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, num_obs, adjusted, multioutput)
