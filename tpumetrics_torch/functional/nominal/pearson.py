"""Pearson's contingency coefficient (port of
``tpumetrics/functional/nominal/pearson.py``)."""

from __future__ import annotations

import itertools
from typing import Optional

import torch

from tpumetrics_torch.functional.nominal.utils import (
    _compute_chi_squared,
    _infer_num_classes,
    _nominal_confmat,
    _nominal_input_validation,
)

Tensor = torch.Tensor


def _pearsons_contingency_coefficient_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """The int32 contingency table."""
    return _nominal_confmat(preds, target, num_classes, nan_strategy, nan_replace_value)


def _pearsons_contingency_coefficient_compute(confmat: Tensor) -> Tensor:
    """C = sqrt(phi² / (1 + phi²))."""
    confmat = confmat.to(torch.float32)
    cm_sum = confmat.sum()
    chi_squared = _compute_chi_squared(confmat, bias_correction=False)
    phi_squared = chi_squared / torch.where(cm_sum > 0, cm_sum, 1.0)
    return torch.clamp(torch.sqrt(phi_squared / (1 + phi_squared)), 0.0, 1.0)


def pearsons_contingency_coefficient(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
    num_classes: Optional[int] = None,
) -> Tensor:
    """Pearson's contingency coefficient between two categorical series.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.nominal import pearsons_contingency_coefficient
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 0])
        >>> round(float(pearsons_contingency_coefficient(preds, target)), 4)
        0.686
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    if num_classes is None:
        num_classes = _infer_num_classes(preds, target, nan_strategy, nan_replace_value)
    confmat = _pearsons_contingency_coefficient_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_compute(confmat)


def pearsons_contingency_coefficient_matrix(
    matrix: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Pearson's contingency coefficient between every pair of columns
    (symmetric); each pair's class space is read on the host.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.nominal import pearsons_contingency_coefficient_matrix
        >>> matrix = torch.tensor([[0, 0, 0], [1, 1, 1], [2, 2, 2], [1, 2, 1]])
        >>> tuple(pearsons_contingency_coefficient_matrix(matrix).shape)
        (3, 3)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    num_variables = matrix.shape[1]
    value = torch.ones((num_variables, num_variables), dtype=torch.float32, device=matrix.device)
    for i, j in itertools.combinations(range(num_variables), 2):
        x, y = matrix[:, i], matrix[:, j]
        num_classes = _infer_num_classes(x, y, nan_strategy, nan_replace_value)
        confmat = _pearsons_contingency_coefficient_update(x, y, num_classes, nan_strategy, nan_replace_value)
        value[i, j] = value[j, i] = _pearsons_contingency_coefficient_compute(confmat)
    return value
