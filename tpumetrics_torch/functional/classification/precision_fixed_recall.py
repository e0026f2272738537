"""The best precision at a minimum recall, binary, multiclass and multilabel
(port of ``tpumetrics/functional/classification/precision_fixed_recall.py``):
the reduction of ``recall_fixed_precision`` with the roles swapped, batched
over the classes of a binned state in the same way."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from tpumetrics_torch.functional.classification.recall_fixed_precision import (
    _binary_recall_at_fixed_precision_arg_validation,
    _binary_recall_at_fixed_precision_compute,
    _lexmax_constrained,
    _multiclass_recall_at_fixed_precision_arg_validation,
    _multiclass_recall_at_fixed_precision_compute,
    _multilabel_recall_at_fixed_precision_arg_validation,
    _multilabel_recall_at_fixed_precision_compute,
    _zip_last,
)

Tensor = torch.Tensor


def _precision_at_recall(
    precision: Tensor, recall: Tensor, thresholds: Tensor, min_recall: float
) -> Tuple[Tensor, Tensor]:
    """The largest precision with recall >= ``min_recall``, and its threshold (1e6 when none)."""
    precision, recall, thresholds = _zip_last(precision, recall, thresholds)
    return _lexmax_constrained(precision, recall, thresholds, recall >= min_recall)


def binary_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """(max precision, its threshold) subject to recall >= ``min_recall``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_precision_at_fixed_recall
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> precision, threshold = binary_precision_at_fixed_recall(preds, target, min_recall=0.5)
        >>> (round(float(precision), 4), round(float(threshold), 4))
        (1.0, 0.8)
    """
    if validate_args:
        _binary_recall_at_fixed_precision_arg_validation(min_recall, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ignore_index)
    return _binary_recall_at_fixed_precision_compute(state, thresholds, min_recall, reduce_fn=_precision_at_recall)


def multiclass_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class (max precision, its threshold) subject to recall >= ``min_recall``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_precision_at_fixed_recall
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05], [0.05, 0.05, 0.9]])
        >>> target = torch.tensor([0, 1, 2])
        >>> precision, thresholds = multiclass_precision_at_fixed_recall(preds, target, num_classes=3,
        ...                                                              min_recall=0.5)
        >>> precision.tolist()
        [1.0, 1.0, 1.0]
    """
    if validate_args:
        _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_recall, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds_arr = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds_arr, None, ignore_index)
    return _multiclass_recall_at_fixed_precision_compute(
        state, num_classes, thresholds_arr, min_recall, reduce_fn=_precision_at_recall
    )


def multilabel_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label (max precision, its threshold) subject to recall >= ``min_recall``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_precision_at_fixed_recall
        >>> preds = torch.tensor([[0.75, 0.05], [0.05, 0.75], [0.05, 0.05], [0.75, 0.75]])
        >>> target = torch.tensor([[1, 0], [0, 1], [0, 0], [1, 1]])
        >>> precision, thresholds = multilabel_precision_at_fixed_recall(preds, target, num_labels=2,
        ...                                                              min_recall=0.5)
        >>> precision.tolist()
        [1.0, 1.0]
    """
    if validate_args:
        _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_recall, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds_arr = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds_arr, ignore_index)
    return _multilabel_recall_at_fixed_precision_compute(
        state, num_labels, thresholds_arr, ignore_index, min_recall, reduce_fn=_precision_at_recall
    )
