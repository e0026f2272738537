"""LogCosh error (port of ``tpumetrics/functional/regression/log_cosh.py``)."""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from tpumetrics_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _unsqueeze_tensors(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.ndim == 2:
        return preds, target
    return preds.unsqueeze(1), target.unsqueeze(1)


def _log_cosh_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, int]:
    """Sum of ``log(cosh(p - t))`` per output, in the stable form
    ``x + softplus(-2x) - log(2)``, and the number of rows."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    preds, target = _unsqueeze_tensors(preds, target)
    diff = preds - target
    sum_log_cosh_error = torch.sum(diff + F.softplus(-2.0 * diff) - math.log(2.0), dim=0).squeeze()
    return sum_log_cosh_error, preds.shape[0]


def _log_cosh_error_compute(sum_log_cosh_error: Tensor, num_obs: Union[int, Tensor]) -> Tensor:
    return (sum_log_cosh_error / num_obs).squeeze()


def log_cosh_error(preds: Tensor, target: Tensor) -> Tensor:
    """LogCosh error.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import log_cosh_error
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> round(float(log_cosh_error(preds, target)), 4)
        0.3523
    """
    sum_log_cosh_error, num_obs = _log_cosh_error_update(
        preds, target, num_outputs=1 if preds.ndim == 1 else preds.shape[1]
    )
    return _log_cosh_error_compute(sum_log_cosh_error, num_obs)
