"""Cramer's V (port of ``tpumetrics/functional/nominal/cramers.py``)."""

from __future__ import annotations

import itertools
from typing import Optional

import torch

from tpumetrics_torch.functional.nominal.utils import (
    _compute_bias_corrected_values,
    _compute_chi_squared,
    _effective_shape,
    _infer_num_classes,
    _nominal_confmat,
    _nominal_input_validation,
    _unable_to_use_bias_correction_warning,
)

Tensor = torch.Tensor


def _cramers_v_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """The int32 contingency table."""
    return _nominal_confmat(preds, target, num_classes, nan_strategy, nan_replace_value)


def _cramers_v_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    """V = sqrt(phi² / min(r - 1, c - 1)) over the effective rows and
    columns; NaN (with a warning) where the bias correction leaves one."""
    confmat = confmat.to(torch.float32)
    cm_sum = confmat.sum()
    chi_squared = _compute_chi_squared(confmat, bias_correction)
    phi_squared = chi_squared / torch.where(cm_sum > 0, cm_sum, 1.0)
    num_rows, num_cols = _effective_shape(confmat)

    if bias_correction:
        phi_squared_corrected, rows_corrected, cols_corrected = _compute_bias_corrected_values(
            phi_squared, num_rows, num_cols, cm_sum
        )
        denom = torch.minimum(rows_corrected - 1, cols_corrected - 1)
        degenerate = torch.minimum(rows_corrected, cols_corrected) == 1
        if bool(degenerate):  # a host read, in compute only
            _unable_to_use_bias_correction_warning(metric_name="Cramer's V")
        value = torch.sqrt(phi_squared_corrected / torch.where(degenerate, 1.0, denom))
        value = torch.where(degenerate, torch.nan, value)
    else:
        denom = torch.minimum(num_rows - 1, num_cols - 1)
        value = torch.sqrt(phi_squared / torch.where(denom > 0, denom, 1.0))
    return torch.clamp(value, 0.0, 1.0)


def cramers_v(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
    num_classes: Optional[int] = None,
) -> Tensor:
    """Cramer's V association between two categorical series.

    ``num_classes`` fixes the table's size; without it the size is read
    from the data on the host.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.nominal import cramers_v
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 0])
        >>> round(float(cramers_v(preds, target, bias_correction=False)), 4)
        0.6667
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    if num_classes is None:
        num_classes = _infer_num_classes(preds, target, nan_strategy, nan_replace_value)
    confmat = _cramers_v_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _cramers_v_compute(confmat, bias_correction)


def cramers_v_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Cramer's V between every pair of columns of a categorical dataset
    (symmetric, ones on the diagonal); each pair's class space is read on
    the host.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.nominal import cramers_v_matrix
        >>> matrix = torch.tensor([[0, 0, 0], [1, 1, 1], [2, 2, 2], [1, 2, 1]])
        >>> tuple(cramers_v_matrix(matrix, bias_correction=False).shape)
        (3, 3)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    num_variables = matrix.shape[1]
    value = torch.ones((num_variables, num_variables), dtype=torch.float32, device=matrix.device)
    for i, j in itertools.combinations(range(num_variables), 2):
        x, y = matrix[:, i], matrix[:, j]
        num_classes = _infer_num_classes(x, y, nan_strategy, nan_replace_value)
        confmat = _cramers_v_update(x, y, num_classes, nan_strategy, nan_replace_value)
        value[i, j] = value[j, i] = _cramers_v_compute(confmat, bias_correction)
    return value
