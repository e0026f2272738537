"""Accuracy, binary, multiclass and multilabel (port of ``tpumetrics/functional/classification/accuracy.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide
from tpumetrics_torch.utils.enums import ClassificationTask

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


def binary_accuracy(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary accuracy.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_accuracy
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> round(float(binary_accuracy(preds, target)), 4)
        0.6667
    """
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, mask = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, mask, multidim_average)
    return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


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


def multilabel_accuracy(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel accuracy.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_accuracy
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> round(float(multilabel_accuracy(preds, target, num_labels=3, average='micro')), 4)
        0.6667
    """
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, mask = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, mask, multidim_average)
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True)


def accuracy(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for accuracy.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import accuracy
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> float(accuracy(preds, target, task="multiclass", num_classes=4))
        0.5
    """
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_accuracy(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_accuracy(
            preds, target, _check_task_size("num_classes", num_classes), average, top_k, multidim_average,
            ignore_index, validate_args,
        )
    return multilabel_accuracy(
        preds, target, _check_task_size("num_labels", num_labels), threshold, average, multidim_average,
        ignore_index, validate_args,
    )
