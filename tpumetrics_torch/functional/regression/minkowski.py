"""Minkowski distance (port of ``tpumetrics/functional/regression/minkowski.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.utils.checks import _check_same_shape
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

Tensor = torch.Tensor


def _check_p(p: float) -> None:
    if not (isinstance(p, (float, int)) and p >= 1):
        raise TPUMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")


def _minkowski_distance_update(preds: Tensor, targets: Tensor, p: float) -> Tensor:
    _check_same_shape(preds, targets)
    _check_p(p)
    return torch.sum(torch.pow(torch.abs(preds - targets), p))


def _minkowski_distance_compute(distance: Tensor, p: float) -> Tensor:
    return torch.pow(distance, 1.0 / p)


def minkowski_distance(preds: Tensor, targets: Tensor, p: float) -> Tensor:
    """Minkowski distance of order p.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import minkowski_distance
        >>> round(float(minkowski_distance(torch.tensor([0., 1, 2, 3]), torch.tensor([0., 2, 3, 1]), p=5)), 4)
        2.0244
    """
    return _minkowski_distance_compute(_minkowski_distance_update(preds, targets, p), p)
