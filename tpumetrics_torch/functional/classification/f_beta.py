"""F-beta and F1 scores, binary, multiclass and multilabel (port of
``tpumetrics/functional/classification/f_beta.py``)."""

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


def _fbeta_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> Tensor:
    """F-beta = (1+β²)·tp / ((1+β²)·tp + β²·fn + fp)."""
    beta2 = beta**2
    if average == "binary":
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = torch.sum(tp, dim=dim)
        fn = torch.sum(fn, dim=dim)
        fp = torch.sum(fp, dim=dim)
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)

    score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def _check_beta(beta: float) -> None:
    if not (isinstance(beta, float) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")


def binary_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary F-beta.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_fbeta_score
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> round(float(binary_fbeta_score(preds, target, beta=2.0)), 4)
        0.6667
    """
    if validate_args:
        _check_beta(beta)
    tp, fp, tn, fn = _binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average="binary", multidim_average=multidim_average)


def multiclass_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass F-beta.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_fbeta_score
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> float(multiclass_fbeta_score(preds, target, beta=1.0, num_classes=3, average='micro'))
        0.75
    """
    if validate_args:
        _check_beta(beta)
    tp, fp, tn, fn = _multiclass_counts(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _fbeta_reduce(tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average)


def multiclass_f1_score(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass F1 (F-beta with beta=1)."""
    return multiclass_fbeta_score(
        preds, target, 1.0, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )


def multilabel_fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel F-beta.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_fbeta_score
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> round(float(multilabel_fbeta_score(preds, target, beta=2.0, num_labels=3, average='micro')), 4)
        0.6667
    """
    if validate_args:
        _check_beta(beta)
    tp, fp, tn, fn = _multilabel_counts(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _fbeta_reduce(tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average, multilabel=True)


def binary_f1_score(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary F1 (F-beta with beta=1).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_f1_score
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> round(float(binary_f1_score(preds, target)), 4)
        0.6667
    """
    return binary_fbeta_score(preds, target, 1.0, threshold, multidim_average, ignore_index, validate_args)


def multilabel_f1_score(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel F1 (F-beta with beta=1)."""
    return multilabel_fbeta_score(
        preds, target, 1.0, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )


def fbeta_score(
    preds: Tensor,
    target: Tensor,
    task: str,
    beta: float = 1.0,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for F-beta."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_fbeta_score(preds, target, beta, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_fbeta_score(
            preds, target, beta, _check_task_size("num_classes", num_classes), average, top_k, multidim_average,
            ignore_index, validate_args,
        )
    return multilabel_fbeta_score(
        preds, target, beta, _check_task_size("num_labels", num_labels), threshold, average, multidim_average,
        ignore_index, validate_args,
    )


def f1_score(
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
    """Task-string dispatcher for F1.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import f1_score
        >>> target = torch.tensor([0, 1, 0, 1])
        >>> preds = torch.tensor([0.2, 0.8, 0.6, 0.9])
        >>> round(float(f1_score(preds, target, task="binary")), 4)
        0.8
    """
    return fbeta_score(
        preds, target, task, 1.0, threshold, num_classes, num_labels, average, multidim_average, top_k,
        ignore_index, validate_args,
    )
