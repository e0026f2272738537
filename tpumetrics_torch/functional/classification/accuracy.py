"""Accuracy, multiclass part (port of ``tpumetrics/functional/classification/accuracy.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
)
from tpumetrics_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide

Tensor = torch.Tensor


def _accuracy_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> Tensor:
    """Reduce stat-score counts into accuracy."""
    if average == "binary":
        return _safe_divide(tp + tn, tp + fp + tn + fn)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = torch.sum(tp, dim=dim)
        fn = torch.sum(fn, dim=dim)
        if multilabel:
            fp = torch.sum(fp, dim=dim)
            tn = torch.sum(tn, dim=dim)
            return _safe_divide(tp + tn, tp + fp + tn + fn)
        return _safe_divide(tp, tp + fn)

    score = _safe_divide(tp + tn, tp + fp + tn + fn) if multilabel else _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def multiclass_accuracy(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass accuracy.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_accuracy
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> float(multiclass_accuracy(preds, target, num_classes=3, average='micro'))
        0.75
    """
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target, mask = _multiclass_stat_scores_format(preds, target, num_classes, ignore_index, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, mask, num_classes, top_k, average, multidim_average
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average)
