"""Precision and recall, binary, multiclass and multilabel (port of
``tpumetrics/functional/classification/precision_recall.py``): reductions
of the stat scores, ``tp / (tp + fp)`` and ``tp / (tp + fn)``."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.classification.stat_scores import (
    _binary_counts,
    _multiclass_counts,
    _multilabel_counts,
)
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _precision_recall_reduce(
    stat: str,
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    zero_division: float = 0.0,
) -> Tensor:
    """precision = tp / (tp + fp), recall = tp / (tp + fn), with ``average``
    applied; 0/0 gives ``zero_division``."""
    different_stat = fp if stat == "precision" else fn
    if average == "binary":
        return _safe_divide(tp, tp + different_stat, zero_division)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = torch.sum(tp, dim=dim)
        different_stat = torch.sum(different_stat, dim=dim)
        return _safe_divide(tp, tp + different_stat, zero_division)
    score = _safe_divide(tp, tp + different_stat, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def binary_precision(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary precision: tp / (tp + fp).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_precision
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> round(float(binary_precision(preds, target)), 4)
        0.6667
    """
    tp, fp, tn, fn = _binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _precision_recall_reduce("precision", tp, fp, tn, fn, "binary", multidim_average)


def multiclass_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass precision.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_precision
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> round(float(multiclass_precision(preds, target, num_classes=3)), 4)
        0.8333
    """
    tp, fp, tn, fn = _multiclass_counts(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce("precision", tp, fp, tn, fn, average, multidim_average)


def multilabel_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel precision.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_precision
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> round(float(multilabel_precision(preds, target, num_labels=3)), 4)
        0.5
    """
    tp, fp, tn, fn = _multilabel_counts(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce("precision", tp, fp, tn, fn, average, multidim_average, multilabel=True)


def binary_recall(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary recall: tp / (tp + fn).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_recall
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> round(float(binary_recall(preds, target)), 4)
        0.6667
    """
    tp, fp, tn, fn = _binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _precision_recall_reduce("recall", tp, fp, tn, fn, "binary", multidim_average)


def multiclass_recall(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass recall.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_recall
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> round(float(multiclass_recall(preds, target, num_classes=3)), 4)
        0.8333
    """
    tp, fp, tn, fn = _multiclass_counts(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce("recall", tp, fp, tn, fn, average, multidim_average)


def multilabel_recall(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel recall.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_recall
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> round(float(multilabel_recall(preds, target, num_labels=3)), 4)
        0.6667
    """
    tp, fp, tn, fn = _multilabel_counts(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce("recall", tp, fp, tn, fn, average, multidim_average, multilabel=True)


def _dispatch(
    stat: str,
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float,
    num_classes: Optional[int],
    num_labels: Optional[int],
    average: Optional[str],
    multidim_average: str,
    top_k: int,
    ignore_index: Optional[int],
    validate_args: bool,
) -> Tensor:
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        fn = binary_precision if stat == "precision" else binary_recall
        return fn(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        fn = multiclass_precision if stat == "precision" else multiclass_recall
        return fn(
            preds, target, _check_task_size("num_classes", num_classes), average, top_k, multidim_average,
            ignore_index, validate_args,
        )
    fn = multilabel_precision if stat == "precision" else multilabel_recall
    return fn(
        preds, target, _check_task_size("num_labels", num_labels), threshold, average, multidim_average,
        ignore_index, validate_args,
    )


def precision(
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
    """Task-string dispatcher for precision.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import precision
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> preds = torch.tensor([0, 2, 2, 1])
        >>> round(float(precision(preds, target, task="multiclass", num_classes=3, average="macro")), 4)
        0.8333
    """
    return _dispatch(
        "precision", preds, target, task, threshold, num_classes, num_labels, average, multidim_average, top_k,
        ignore_index, validate_args,
    )


def recall(
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
    """Task-string dispatcher for recall.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import recall
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> preds = torch.tensor([0, 2, 2, 1])
        >>> round(float(recall(preds, target, task="multiclass", num_classes=3, average="macro")), 4)
        0.8333
    """
    return _dispatch(
        "recall", preds, target, task, threshold, num_classes, num_labels, average, multidim_average, top_k,
        ignore_index, validate_args,
    )
