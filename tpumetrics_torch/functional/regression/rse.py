"""Relative squared error (port of ``tpumetrics/functional/regression/rse.py``)."""

from __future__ import annotations

from typing import Union

import torch

from tpumetrics_torch.functional.regression.r2 import _r2_score_update

Tensor = torch.Tensor


def _relative_squared_error_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    sum_squared_error: Tensor,
    num_obs: Union[int, Tensor],
    squared: bool = True,
) -> Tensor:
    """``Σ(y - ŷ)² / Σ(y - ȳ)²`` per output, averaged over the outputs."""
    epsilon = torch.finfo(torch.float32).eps
    rse = sum_squared_error / torch.clamp(sum_squared_obs - sum_obs * sum_obs / num_obs, min=epsilon)
    if not squared:
        rse = torch.sqrt(rse)
    return torch.mean(rse)


def relative_squared_error(preds: Tensor, target: Tensor, squared: bool = True) -> Tensor:
    """RSE (averaged over the outputs of 2-D inputs).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import relative_squared_error
        >>> round(float(relative_squared_error(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))), 4)
        0.0514
    """
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
    return _relative_squared_error_compute(sum_squared_obs, sum_obs, rss, num_obs, squared=squared)
