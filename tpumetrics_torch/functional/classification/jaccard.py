"""Jaccard index (IoU), binary, multiclass and multilabel (port of
``tpumetrics/functional/classification/jaccard.py``): a reduction of the
confusion matrix."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.compute import _safe_divide
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor

_ALLOWED_AVERAGE = ("binary", "micro", "macro", "weighted", "none", None)


def _jaccard_index_reduce(confmat: Tensor, average: Optional[str], ignore_index: Optional[int] = None) -> Tensor:
    """Intersection over union per class of a ``(C, C)`` or ``(L, 2, 2)``
    confusion matrix, then ``average``. An ``ignore_index`` inside ``[0, C)``
    leaves the micro denominator and the macro weights; ``macro`` also
    leaves out classes absent from both targets and preds (multiclass)."""
    if average not in _ALLOWED_AVERAGE:
        raise ValueError(f"The `average` has to be one of {_ALLOWED_AVERAGE}, got {average}.")
    confmat = confmat.to(torch.float32)
    if average == "binary":
        return confmat[1, 1] / (confmat[0, 1] + confmat[1, 0] + confmat[1, 1])
    ignore_index_cond = ignore_index is not None and 0 <= ignore_index < confmat.shape[0]
    multilabel = confmat.ndim == 3
    if multilabel:
        num = confmat[:, 1, 1]
        denom = confmat[:, 1, 1] + confmat[:, 0, 1] + confmat[:, 1, 0]
    else:
        num = torch.diagonal(confmat)
        denom = confmat.sum(0) + confmat.sum(1) - num
    if average == "micro":
        num = num.sum()
        denom = denom.sum() - (denom[ignore_index] if ignore_index_cond else 0.0)
    jaccard = _safe_divide(num, denom)
    if average is None or average in ("none", "micro"):
        return jaccard
    if average == "weighted":
        weights = confmat[:, 1, 1] + confmat[:, 1, 0] if multilabel else confmat.sum(1)
    else:
        weights = torch.ones_like(jaccard)
        if ignore_index_cond:
            weights[ignore_index] = 0.0
        if not multilabel:
            weights = torch.where(confmat.sum(1) + confmat.sum(0) == 0, 0.0, weights)
    return ((weights * jaccard) / weights.sum()).sum()


def _check_average(average: Optional[str]) -> None:
    """The averages a multiclass or multilabel Jaccard index takes."""
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None) but got {average}"
        )


def binary_jaccard_index(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Jaccard index for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_jaccard_index
        >>> preds = torch.tensor([0.35, 0.85, 0.48, 0.01])
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> round(float(binary_jaccard_index(preds, target)), 4)
        0.5
    """
    confmat = binary_confusion_matrix(preds, target, threshold, None, ignore_index, validate_args)
    return _jaccard_index_reduce(confmat, average="binary")


def multiclass_jaccard_index(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Jaccard index for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_jaccard_index
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> round(float(multiclass_jaccard_index(preds, target, num_classes=3)), 4)
        0.6667
    """
    confmat = multiclass_confusion_matrix(preds, target, num_classes, None, ignore_index, validate_args)
    return _jaccard_index_reduce(confmat, average=average, ignore_index=ignore_index)


def multilabel_jaccard_index(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Jaccard index for multilabel tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_jaccard_index
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> round(float(multilabel_jaccard_index(preds, target, num_labels=3)), 4)
        0.5
    """
    confmat = multilabel_confusion_matrix(preds, target, num_labels, threshold, None, ignore_index, validate_args)
    return _jaccard_index_reduce(confmat, average=average, ignore_index=ignore_index)


def jaccard_index(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for the Jaccard index.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import jaccard_index
        >>> preds = torch.tensor([0.35, 0.85, 0.48, 0.01])
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> round(float(jaccard_index(preds, target, task="binary")), 4)
        0.5
    """
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_jaccard_index(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_jaccard_index(
            preds, target, _check_task_size("num_classes", num_classes), average, ignore_index, validate_args
        )
    return multilabel_jaccard_index(
        preds, target, _check_task_size("num_labels", num_labels), threshold, average, ignore_index, validate_args
    )
