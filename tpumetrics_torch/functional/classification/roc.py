"""ROC curves, binned binary and multiclass compute (port of
``tpumetrics/functional/classification/roc.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    _EXACT_PATH_TODO,
    Thresholds,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
)
from tpumetrics_torch.utils.compute import _safe_divide, interp

Tensor = torch.Tensor


def _binary_roc_compute(state: Tensor, thresholds: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    """(fpr, tpr, thresholds) from a (T, 2, 2) state, curves in increasing order."""
    if thresholds is None:
        raise NotImplementedError(_EXACT_PATH_TODO)
    tps = state[:, 1, 1]
    fps = state[:, 0, 1]
    fns = state[:, 1, 0]
    tns = state[:, 0, 0]
    tpr = torch.flip(_safe_divide(tps, tps + fns), [0])
    fpr = torch.flip(_safe_divide(fps, fps + tns), [0])
    return fpr, tpr, torch.flip(thresholds, [0])


def _multiclass_roc_compute(
    state: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-class one-vs-rest ROC ``(C, T)``; optional macro interpolation onto
    a shared fpr grid; micro is the binary curve of the flattened state."""
    if average == "micro":
        return _binary_roc_compute(state, thresholds)
    if thresholds is None:
        raise NotImplementedError(_EXACT_PATH_TODO)
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    tns = state[:, :, 0, 0]
    tpr = torch.flip(_safe_divide(tps, tps + fns), [0]).T
    fpr = torch.flip(_safe_divide(fps, fps + tns), [0]).T
    thres = torch.flip(thresholds, [0])

    if average == "macro":
        thres = torch.flip(torch.sort(thres.repeat(num_classes)).values, [0])
        mean_fpr = torch.sort(fpr.reshape(-1)).values
        mean_tpr = torch.zeros_like(mean_fpr)
        for i in range(num_classes):
            mean_tpr = mean_tpr + interp(mean_fpr, fpr[i], tpr[i])
        return mean_fpr, mean_tpr / num_classes, thres
    return fpr, tpr, thres


def multiclass_roc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-class one-vs-rest ROC curves over binned thresholds.

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
