"""Matthews correlation coefficient, binary, multiclass and multilabel (port
of ``tpumetrics/functional/classification/matthews_corrcoef.py``): the R_K
statistic of the confusion matrix, in float32 as in the JAX package.

The binary special cases (a zero denominator, all right, all wrong) are
``torch.where`` selects, so ``compute`` reads nothing on the host. The sums
of squared counts lose low bits in float32 (at a million samples ``s**2`` is
1e12, where one float32 step is 65,536), and torch sums in another order
than XLA, so the port agrees with the JAX package to a relative tolerance,
not bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpumetrics_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor

_EPS = float(torch.finfo(torch.float32).eps)


def _matthews_corrcoef_reduce(confmat: Tensor) -> Tensor:
    """A confusion matrix (``(L, 2, 2)`` multilabel ones summed to one
    binary matrix) to its MCC."""
    confmat = confmat.sum(0) if confmat.ndim == 3 else confmat
    tk = confmat.sum(-1).to(torch.float32)
    pk = confmat.sum(-2).to(torch.float32)
    c = torch.diagonal(confmat).sum().to(torch.float32)
    s = confmat.sum().to(torch.float32)
    cov_ytyp = c * s - torch.sum(tk * pk)
    cov_ypyp = s**2 - torch.sum(pk * pk)
    cov_ytyt = s**2 - torch.sum(tk * tk)
    denom = cov_ypyp * cov_ytyt
    zero = denom == 0
    standard = torch.where(zero, 0.0, cov_ytyp / torch.sqrt(torch.where(zero, 1.0, denom)))
    if confmat.numel() != 4:
        return standard
    tn, fp, fn, tp = confmat.reshape(-1).to(torch.float32)
    a = torch.where((tp == 0) | (tn == 0), tp + tn, 0.0)
    b = torch.where((fp == 0) | (fn == 0), fp + fn, 0.0)
    eps_num = math.sqrt(_EPS) * (a - b)
    eps_denom = (tp + fp + _EPS) * (tp + fn + _EPS) * (tn + fp + _EPS) * (tn + fn + _EPS)
    res = torch.where(zero, eps_num / torch.sqrt(eps_denom), standard)
    res = torch.where((tp + tn != 0) & (fp + fn == 0), 1.0, res)
    return torch.where((tp + tn == 0) & (fp + fn != 0), -1.0, res)


def binary_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """MCC for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_matthews_corrcoef
        >>> preds = torch.tensor([0.35, 0.85, 0.48, 0.01])
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> round(float(binary_matthews_corrcoef(preds, target)), 4)
        0.5774
    """
    confmat = binary_confusion_matrix(preds, target, threshold, None, ignore_index, validate_args)
    return _matthews_corrcoef_reduce(confmat)


def multiclass_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """MCC for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_matthews_corrcoef
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> round(float(multiclass_matthews_corrcoef(preds, target, num_classes=3)), 4)
        0.7
    """
    confmat = multiclass_confusion_matrix(preds, target, num_classes, None, ignore_index, validate_args)
    return _matthews_corrcoef_reduce(confmat)


def multilabel_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """MCC for multilabel tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_matthews_corrcoef
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> round(float(multilabel_matthews_corrcoef(preds, target, num_labels=3)), 4)
        0.3333
    """
    confmat = multilabel_confusion_matrix(preds, target, num_labels, threshold, None, ignore_index, validate_args)
    return _matthews_corrcoef_reduce(confmat)


def matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for MCC.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import matthews_corrcoef
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> round(float(matthews_corrcoef(preds, target, task="multiclass", num_classes=3)), 4)
        0.7
    """
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_matthews_corrcoef(
            preds, target, _check_task_size("num_classes", num_classes), ignore_index, validate_args
        )
    return multilabel_matthews_corrcoef(
        preds, target, _check_task_size("num_labels", num_labels), threshold, ignore_index, validate_args
    )
