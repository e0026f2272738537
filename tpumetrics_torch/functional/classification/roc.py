"""ROC curves, binary, multiclass and multilabel (port of
``tpumetrics/functional/classification/roc.py``).

State handling is shared with the precision-recall curves: the same binned
confusion tensor, or the exact path's preds and targets.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    Curves,
    CurveState,
    Thresholds,
    _binary_clf_curve,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _macro_curve,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_exact_columns,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.compute import _safe_divide
from tpumetrics_torch.utils.enums import ClassificationTask
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _binary_roc_compute(
    state: CurveState, thresholds: Optional[Tensor], pos_label: int = 1
) -> Tuple[Tensor, Tensor, Tensor]:
    """(fpr, tpr, thresholds), curves in increasing order. Binned: from a
    (T, 2, 2) state; exact: at every distinct pred, after an extra threshold
    of 1 so the curve starts at (0, 0). With no negatives (positives) the
    exact fpr (tpr) is zero, with a warning; reading the counts syncs."""
    if thresholds is not None:
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        tns = state[:, 0, 0]
        tpr = torch.flip(_safe_divide(tps, tps + fns), [0])
        fpr = torch.flip(_safe_divide(fps, fps + tns), [0])
        return fpr, tpr, torch.flip(thresholds, [0])

    fps, tps, thres = _binary_clf_curve(preds=state[0], target=state[1], pos_label=pos_label)
    tps = torch.cat([torch.zeros(1, dtype=tps.dtype, device=tps.device), tps])
    fps = torch.cat([torch.zeros(1, dtype=fps.dtype, device=fps.device), fps])
    thres = torch.cat([torch.ones(1, dtype=thres.dtype, device=thres.device), thres])

    if fps[-1] <= 0:
        rank_zero_warn(
            "No negative samples in targets, false positive value should be meaningless."
            " Returning zero tensor in false positive score",
            UserWarning,
        )
        fpr = torch.zeros_like(thres)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        rank_zero_warn(
            "No positive samples in targets, true positive value should be meaningless."
            " Returning zero tensor in true positive score",
            UserWarning,
        )
        tpr = torch.zeros_like(thres)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thres


def binary_roc(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Receiver operating characteristic for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_roc
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> fpr, tpr, thresholds = binary_roc(preds, target)
        >>> fpr.tolist()
        [0.0, 0.0, 0.5, 0.5, 1.0]
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ignore_index)
    return _binary_roc_compute(state, thresholds)


def _binned_roc(state: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-class ``(C, T)`` fpr and tpr of a ``(T, C, 2, 2)`` state, in
    increasing order, and the thresholds in decreasing order."""
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    tns = state[:, :, 0, 0]
    tpr = torch.flip(_safe_divide(tps, tps + fns), [0]).T
    fpr = torch.flip(_safe_divide(fps, fps + tns), [0]).T
    return fpr, tpr, torch.flip(thresholds, [0])


def _multiclass_roc_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Curves:
    """Per-class one-vs-rest ROC (binned: ``(C, T)`` tensors; exact: lists
    of per-class tensors); optional macro interpolation onto a shared fpr
    grid; micro is the binary curve of the flattened state."""
    if average == "micro":
        return _binary_roc_compute(state, thresholds)
    if thresholds is not None:
        fpr, tpr, thres = _binned_roc(state, thresholds)
        if average == "macro":
            return _macro_curve(list(fpr), list(tpr), [thres] * num_classes, descending=True)
        return fpr, tpr, thres

    curves = [_binary_roc_compute((state[0][:, i], state[1]), None, pos_label=i) for i in range(num_classes)]
    fpr_list, tpr_list, thres_list = (list(c) for c in zip(*curves))
    if average == "macro":
        return _macro_curve(fpr_list, tpr_list, thres_list, descending=True)
    return fpr_list, tpr_list, thres_list


def multiclass_roc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """Per-class one-vs-rest ROC curves.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_roc
        >>> preds = torch.tensor([[0.75, 0.05, 0.05], [0.05, 0.75, 0.05], [0.05, 0.05, 0.75]])
        >>> target = torch.tensor([0, 1, 2])
        >>> fpr, tpr, thresholds = multiclass_roc(preds, target, num_classes=3, thresholds=5)
        >>> tuple(fpr.shape), tuple(tpr.shape), tuple(thresholds.shape)
        ((3, 5), (3, 5), (5,))
    """
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds_arr = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(
        preds, target, num_classes, thresholds_arr, average, ignore_index
    )
    return _multiclass_roc_compute(state, num_classes, thresholds_arr, average)


def _multilabel_roc_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Curves:
    """Per-label ROC: binned ``(L, T)`` tensors, or exact lists with each
    label's ignored entries dropped."""
    if thresholds is not None:
        return _binned_roc(state, thresholds)
    curves = [_binary_roc_compute(col, None) for col in _multilabel_exact_columns(state, ignore_index)]
    fpr_list, tpr_list, thres_list = (list(c) for c in zip(*curves))
    return fpr_list, tpr_list, thres_list


def multilabel_roc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """Per-label ROC curves.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_roc
        >>> preds = torch.tensor([[0.75, 0.05], [0.05, 0.75], [0.05, 0.05], [0.75, 0.75]])
        >>> target = torch.tensor([[1, 0], [0, 1], [0, 0], [1, 1]])
        >>> fpr, tpr, thresholds = multilabel_roc(preds, target, num_labels=2, thresholds=5)
        >>> tuple(fpr.shape), tuple(tpr.shape), tuple(thresholds.shape)
        ((2, 5), (2, 5), (5,))
    """
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds_arr = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds_arr, ignore_index)
    return _multilabel_roc_compute(state, num_labels, thresholds_arr, ignore_index)


def roc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """Task-string dispatcher; ``average`` merges the multiclass per-class curves (micro/macro)."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_roc(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_roc(
            preds, target, _check_task_size("num_classes", num_classes), thresholds, average, ignore_index,
            validate_args,
        )
    return multilabel_roc(
        preds, target, _check_task_size("num_labels", num_labels), thresholds, ignore_index, validate_args
    )
