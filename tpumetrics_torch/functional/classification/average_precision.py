"""Average precision: the area under the precision-recall curve by step
interpolation, ``-Σ (recall[i+1] - recall[i]) * precision[i]``, binary,
multiclass and multilabel (port of
``tpumetrics/functional/classification/average_precision.py``).

It reads the curve state of ``precision_recall_curve``: binned (the
``binned_confusion`` kernel on a card) or exact (``thresholds=None``).
"""

from __future__ import annotations

from typing import List, Optional, Union

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
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.compute import _safe_divide
from tpumetrics_torch.utils.data import _bincount
from tpumetrics_torch.utils.enums import ClassificationTask
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _average_precision_step_sum(precision: Tensor, recall: Tensor) -> Tensor:
    return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])


def _reduce_average_precision(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Reduce per-class APs (of ``(C, T + 1)`` curves or of per-class lists):
    macro mean over non-nan classes, or support-weighted mean. The nan
    warning reads one flag on the host."""
    if isinstance(precision, Tensor) and isinstance(recall, Tensor):
        res = -torch.sum((recall[:, 1:] - recall[:, :-1]) * precision[:, :-1], dim=1)
    else:
        res = torch.stack([_average_precision_step_sum(p, r) for p, r in zip(precision, recall)])
    if average is None or average == "none":
        return res
    idx = ~torch.isnan(res)
    if not bool(idx.all()):
        rank_zero_warn(
            f"Average precision score for one or more classes was `nan`. Ignoring these classes in {average}-average",
            UserWarning,
        )
    if average == "macro":
        return torch.sum(torch.where(idx, res, 0.0)) / torch.sum(idx)
    if average == "weighted" and weights is not None:
        weights = torch.where(idx, weights, 0.0)
        weights = _safe_divide(weights, torch.sum(weights))
        return torch.sum(torch.where(idx, res * weights, 0.0))
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


def _binary_average_precision_compute(
    state: CurveState,
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tensor:
    precision, recall, _ = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
    return _average_precision_step_sum(precision, recall)


def binary_average_precision(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Average precision for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_average_precision
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> round(float(binary_average_precision(preds, target)), 4)
        0.8333
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ignore_index)
    return _binary_average_precision_compute(state, thresholds)


def _multiclass_average_precision_arg_validation(
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if average not in ("macro", "weighted", "none", None):
        raise ValueError(f"Expected argument `average` to be one of ('macro', 'weighted', 'none', None)"
                         f" but got {average}")
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)


def _multiclass_average_precision_compute(
    state: CurveState,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    """AP of the per-class curves. The per-class support for ``weighted`` is
    the label count (exact) or tp + fn of the first threshold (binned)."""
    precision, recall, _ = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    if thresholds is None:
        weights = _bincount(state[1], minlength=num_classes).to(torch.float32)
    else:
        weights = state[0][:, 1, :].sum(-1).to(torch.float32)
    return _reduce_average_precision(precision, recall, average, weights=weights)


def multiclass_average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Average precision over one-vs-rest precision-recall curves for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_average_precision
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05], [0.05, 0.05, 0.9], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> round(float(multiclass_average_precision(preds, target, num_classes=3)), 4)
        1.0
    """
    if validate_args:
        _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds_arr = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(
        preds, target, num_classes, thresholds_arr, None, ignore_index
    )
    return _multiclass_average_precision_compute(state, num_classes, average, thresholds_arr)


def _multilabel_average_precision_arg_validation(
    num_labels: int,
    average: Optional[str],
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None)"
            f" but got {average}"
        )
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)


def _multilabel_average_precision_compute(
    state: CurveState,
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    """AP of the per-label curves; ``micro`` is the binary AP of every entry
    (binned: the label-summed state; exact: ignored entries dropped)."""
    if average == "micro":
        if thresholds is not None:
            return _binary_average_precision_compute(state.sum(1, dtype=torch.int32), thresholds)
        preds = state[0].reshape(-1)
        target = state[1].reshape(-1)
        if ignore_index is not None:
            keep = target != ignore_index
            preds, target = preds[keep], target[keep]
        return _binary_average_precision_compute((preds, target), None)

    precision, recall, _ = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    if thresholds is None:
        weights = (state[1] == 1).sum(0).to(torch.float32)
    else:
        weights = state[0][:, 1, :].sum(-1).to(torch.float32)
    return _reduce_average_precision(precision, recall, average, weights=weights)


def multilabel_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Average precision over per-label precision-recall curves for multilabel tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_average_precision
        >>> preds = torch.tensor([[0.75, 0.05], [0.05, 0.75], [0.05, 0.05], [0.75, 0.75]])
        >>> target = torch.tensor([[1, 0], [0, 1], [0, 0], [1, 1]])
        >>> round(float(multilabel_average_precision(preds, target, num_labels=2)), 4)
        1.0
    """
    if validate_args:
        _multilabel_average_precision_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds_arr = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds_arr, ignore_index)
    return _multilabel_average_precision_compute(state, num_labels, average, thresholds_arr, ignore_index)


def average_precision(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for average precision.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import average_precision
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> round(float(average_precision(preds, target, task="binary")), 4)
        0.8333
    """
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_average_precision(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_average_precision(
            preds, target, _check_task_size("num_classes", num_classes), average, thresholds, ignore_index,
            validate_args,
        )
    return multilabel_average_precision(
        preds, target, _check_task_size("num_labels", num_labels), average, thresholds, ignore_index, validate_args
    )
