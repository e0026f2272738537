"""The best recall at a minimum precision, binary, multiclass and multilabel
(port of ``tpumetrics/functional/classification/recall_fixed_precision.py``):
a reduction of the precision-recall curve.

On a binned state every class's curve is one row of a ``(C, T + 1)``
tensor, so the constrained maximum runs over the last dimension for all
classes at once (masked maxima and selects, no loop and no host read); the
exact curves of ``thresholds=None`` differ in length per class and are
reduced one class at a time, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    CurveState,
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)

Tensor = torch.Tensor
Reduce = Callable[[Tensor, Tensor, Tensor, float], Tuple[Tensor, Tensor]]


def _lexmax_constrained(
    primary: Tensor, secondary: Tensor, thresholds: Tensor, valid: Tensor
) -> Tuple[Tensor, Tensor]:
    """Over the last dimension, among the ``valid`` entries, the
    lexicographic maximum of (primary, secondary, threshold): the largest
    primary and its threshold, for every leading index at once. With no
    valid entry the value is 0; with a value of 0 the threshold is 1e6."""
    neg = float("-inf")
    max_p = torch.where(valid, primary, neg).amax(dim=-1, keepdim=True)
    v2 = valid & (primary == max_p)
    max_s = torch.where(v2, secondary, neg).amax(dim=-1, keepdim=True)
    v3 = v2 & (secondary == max_s)
    best_t = torch.where(v3, thresholds, neg).amax(dim=-1)
    any_valid = valid.any(dim=-1)
    max_primary = torch.where(any_valid, max_p.squeeze(-1), 0.0)
    best_t = torch.where(any_valid, best_t, 0.0)
    best_t = torch.where(max_primary == 0.0, 1e6, best_t)
    return max_primary.to(primary.dtype), best_t.to(thresholds.dtype)


def _zip_last(*curves: Tensor) -> Tuple[Tensor, ...]:
    """The curves cut to their shortest length along the last dimension
    (the thresholds lack the curves' appended endpoint)."""
    n = min(c.shape[-1] for c in curves)
    return tuple(c[..., :n] for c in curves)


def _recall_at_precision(
    precision: Tensor, recall: Tensor, thresholds: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """The largest recall with precision >= ``min_precision``, and its threshold (1e6 when none)."""
    precision, recall, thresholds = _zip_last(precision, recall, thresholds)
    return _lexmax_constrained(recall, precision, thresholds, precision >= min_precision)


def _check_min_value(name: str, value: float) -> None:
    if not isinstance(value, float) or not (0 <= value <= 1):
        raise ValueError(f"Expected argument `{name}` to be an float in the [0,1] range, but got {value}")


def _binary_recall_at_fixed_precision_arg_validation(
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _check_min_value("min_precision", min_precision)


def _binary_recall_at_fixed_precision_compute(
    state: CurveState,
    thresholds: Optional[Tensor],
    min_precision: float,
    pos_label: int = 1,
    reduce_fn: Reduce = _recall_at_precision,
) -> Tuple[Tensor, Tensor]:
    precision, recall, thresholds = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
    return reduce_fn(precision, recall, thresholds, min_precision)


def _per_class(curves, num_classes: int, min_value: float, reduce_fn: Reduce) -> Tuple[Tensor, Tensor]:
    """Per-class (value, threshold): binned ``(C, T + 1)`` curves in one
    batched reduction; exact per-class lists one class at a time."""
    precision, recall, thresholds = curves
    if isinstance(precision, Tensor):
        return reduce_fn(precision, recall, thresholds, min_value)
    res = [reduce_fn(precision[i], recall[i], thresholds[i], min_value) for i in range(num_classes)]
    return torch.stack([r[0] for r in res]), torch.stack([r[1] for r in res])


def binary_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """(max recall, its threshold) subject to precision >= ``min_precision``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_recall_at_fixed_precision
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> recall, threshold = binary_recall_at_fixed_precision(preds, target, min_precision=0.5)
        >>> (round(float(recall), 4), round(float(threshold), 4))
        (1.0, 0.35)
    """
    if validate_args:
        _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ignore_index)
    return _binary_recall_at_fixed_precision_compute(state, thresholds, min_precision)


def _multiclass_recall_at_fixed_precision_arg_validation(
    num_classes: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _check_min_value("min_precision", min_precision)


def _multiclass_recall_at_fixed_precision_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    min_precision: float,
    reduce_fn: Reduce = _recall_at_precision,
) -> Tuple[Tensor, Tensor]:
    curves = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds, average=None)
    return _per_class(curves, num_classes, min_precision, reduce_fn)


def multiclass_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class (max recall, its threshold) subject to precision >= ``min_precision``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_recall_at_fixed_precision
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05], [0.05, 0.05, 0.9]])
        >>> target = torch.tensor([0, 1, 2])
        >>> recall, thresholds = multiclass_recall_at_fixed_precision(preds, target, num_classes=3,
        ...                                                           min_precision=0.5)
        >>> recall.tolist()
        [1.0, 1.0, 1.0]
    """
    if validate_args:
        _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds_arr = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds_arr, None, ignore_index)
    return _multiclass_recall_at_fixed_precision_compute(state, num_classes, thresholds_arr, min_precision)


def _multilabel_recall_at_fixed_precision_arg_validation(
    num_labels: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _check_min_value("min_precision", min_precision)


def _multilabel_recall_at_fixed_precision_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int],
    min_precision: float,
    reduce_fn: Reduce = _recall_at_precision,
) -> Tuple[Tensor, Tensor]:
    curves = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    return _per_class(curves, num_labels, min_precision, reduce_fn)


def multilabel_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label (max recall, its threshold) subject to precision >= ``min_precision``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_recall_at_fixed_precision
        >>> preds = torch.tensor([[0.75, 0.05], [0.05, 0.75], [0.05, 0.05], [0.75, 0.75]])
        >>> target = torch.tensor([[1, 0], [0, 1], [0, 0], [1, 1]])
        >>> recall, thresholds = multilabel_recall_at_fixed_precision(preds, target, num_labels=2,
        ...                                                           min_precision=0.5)
        >>> recall.tolist()
        [1.0, 1.0]
    """
    if validate_args:
        _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds_arr = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds_arr, ignore_index)
    return _multilabel_recall_at_fixed_precision_compute(
        state, num_labels, thresholds_arr, ignore_index, min_precision
    )
