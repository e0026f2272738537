"""Specificity, binary, multiclass and multilabel (port of
``tpumetrics/functional/classification/specificity.py``): the stat scores
reduced to ``tn / (tn + fp)``."""

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


def _specificity_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> Tensor:
    """tn / (tn + fp) with ``average`` applied."""
    if average == "binary":
        return _safe_divide(tn, tn + fp)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tn = torch.sum(tn, dim=dim)
        fp = torch.sum(fp, dim=dim)
        return _safe_divide(tn, tn + fp)
    score = _safe_divide(tn, tn + fp)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def binary_specificity(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary specificity.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_specificity
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> round(float(binary_specificity(preds, target)), 4)
        0.6667
    """
    tp, fp, tn, fn = _binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _specificity_reduce(tp, fp, tn, fn, "binary", multidim_average)


def multiclass_specificity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass specificity.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_specificity
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> round(float(multiclass_specificity(preds, target, num_classes=3)), 4)
        0.8889
    """
    tp, fp, tn, fn = _multiclass_counts(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _specificity_reduce(tp, fp, tn, fn, average, multidim_average)


def multilabel_specificity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel specificity.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_specificity
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> round(float(multilabel_specificity(preds, target, num_labels=3)), 4)
        0.6667
    """
    tp, fp, tn, fn = _multilabel_counts(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _specificity_reduce(tp, fp, tn, fn, average, multidim_average, multilabel=True)


def specificity(
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
    """Task-string dispatcher for specificity.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import specificity
        >>> target = torch.tensor([0, 1, 0, 1])
        >>> preds = torch.tensor([0.2, 0.8, 0.6, 0.9])
        >>> round(float(specificity(preds, target, task="binary")), 4)
        0.5
    """
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_specificity(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_specificity(
            preds, target, _check_task_size("num_classes", num_classes), average, top_k, multidim_average,
            ignore_index, validate_args,
        )
    return multilabel_specificity(
        preds, target, _check_task_size("num_labels", num_labels), threshold, average, multidim_average,
        ignore_index, validate_args,
    )
