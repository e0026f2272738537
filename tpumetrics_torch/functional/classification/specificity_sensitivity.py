"""The best specificity at a minimum sensitivity, binary, multiclass and
multilabel (port of
``tpumetrics/functional/classification/specificity_sensitivity.py``): a
reduction of the ROC curve.

The reduction is the JAX package's masked ``argmax``: among the points whose
sensitivity reaches the minimum, the first of the largest specificity, with
no tie-break on a second key; value 0 and threshold 1e6 only when no point
qualifies. ``torch.argmax`` also returns the first maximal index, so on a
binned state the ``(C, T)`` curves of all classes are reduced at once over
the last dimension, bit for bit the JAX per-class loop. The exact curves of
``thresholds=None`` differ in length per class and are reduced one class at
a time (``_per_class`` of recall at a fixed precision, which dispatches
both).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    CurveState,
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from tpumetrics_torch.functional.classification.recall_fixed_precision import _check_min_value, _per_class
from tpumetrics_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)

Tensor = torch.Tensor


def _convert_fpr_to_specificity(fpr: Tensor) -> Tensor:
    return 1 - fpr


def _specificity_at_sensitivity(
    specificity: Tensor, sensitivity: Tensor, thresholds: Tensor, min_sensitivity: float
) -> Tuple[Tensor, Tensor]:
    """Over the last dimension: the largest specificity with sensitivity >=
    ``min_sensitivity`` (its first index) and its threshold; (0, 1e6) where
    no point qualifies. ``thresholds`` has the curves' last dimension."""
    valid = sensitivity >= min_sensitivity
    idx = torch.argmax(torch.where(valid, specificity, float("-inf")), dim=-1)
    any_valid = valid.any(dim=-1)
    best = specificity.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    max_spec = torch.where(any_valid, best, 0.0)
    best_threshold = torch.where(any_valid, thresholds[idx], 1e6)
    return max_spec.to(specificity.dtype), best_threshold.to(thresholds.dtype)


def _binary_specificity_at_sensitivity_arg_validation(
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _check_min_value("min_sensitivity", min_sensitivity)


def _multiclass_specificity_at_sensitivity_arg_validation(
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _check_min_value("min_sensitivity", min_sensitivity)


def _multilabel_specificity_at_sensitivity_arg_validation(
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _check_min_value("min_sensitivity", min_sensitivity)


def _specificity_at_sensitivity_of_roc(
    fpr: Tensor, tpr: Tensor, thresholds: Tensor, min_sensitivity: float
) -> Tuple[Tensor, Tensor]:
    return _specificity_at_sensitivity(_convert_fpr_to_specificity(fpr), tpr, thresholds, min_sensitivity)


def _binary_specificity_at_sensitivity_compute(
    state: CurveState,
    thresholds: Optional[Tensor],
    min_sensitivity: float,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor]:
    return _specificity_at_sensitivity_of_roc(*_binary_roc_compute(state, thresholds, pos_label), min_sensitivity)


def binary_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """(max specificity, its threshold) subject to sensitivity >= ``min_sensitivity``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_specificity_at_sensitivity
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> spec, threshold = binary_specificity_at_sensitivity(preds, target, min_sensitivity=0.5)
        >>> (round(float(spec), 4), round(float(threshold), 4))
        (1.0, 0.8)
    """
    if validate_args:
        _binary_specificity_at_sensitivity_arg_validation(min_sensitivity, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ignore_index)
    return _binary_specificity_at_sensitivity_compute(state, thresholds, min_sensitivity)


def _multiclass_specificity_at_sensitivity_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    min_sensitivity: float,
) -> Tuple[Tensor, Tensor]:
    curves = _multiclass_roc_compute(state, num_classes, thresholds)
    return _per_class(curves, num_classes, min_sensitivity, _specificity_at_sensitivity_of_roc)


def multiclass_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class (max specificity, its threshold) subject to sensitivity >= ``min_sensitivity``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_specificity_at_sensitivity
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05], [0.05, 0.05, 0.9]])
        >>> target = torch.tensor([0, 1, 2])
        >>> spec, thresholds = multiclass_specificity_at_sensitivity(preds, target, num_classes=3,
        ...                                                          min_sensitivity=0.5)
        >>> spec.tolist()
        [1.0, 1.0, 1.0]
    """
    if validate_args:
        _multiclass_specificity_at_sensitivity_arg_validation(num_classes, min_sensitivity, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds_arr = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds_arr, None, ignore_index)
    return _multiclass_specificity_at_sensitivity_compute(state, num_classes, thresholds_arr, min_sensitivity)


def _multilabel_specificity_at_sensitivity_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int],
    min_sensitivity: float,
) -> Tuple[Tensor, Tensor]:
    curves = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _per_class(curves, num_labels, min_sensitivity, _specificity_at_sensitivity_of_roc)


def multilabel_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label (max specificity, its threshold) subject to sensitivity >= ``min_sensitivity``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_specificity_at_sensitivity
        >>> preds = torch.tensor([[0.75, 0.05], [0.05, 0.75], [0.05, 0.05], [0.75, 0.75]])
        >>> target = torch.tensor([[1, 0], [0, 1], [0, 0], [1, 1]])
        >>> spec, thresholds = multilabel_specificity_at_sensitivity(preds, target, num_labels=2,
        ...                                                          min_sensitivity=0.5)
        >>> spec.tolist()
        [1.0, 1.0]
    """
    if validate_args:
        _multilabel_specificity_at_sensitivity_arg_validation(num_labels, min_sensitivity, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds_arr = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds_arr, ignore_index)
    return _multilabel_specificity_at_sensitivity_compute(
        state, num_labels, thresholds_arr, ignore_index, min_sensitivity
    )
