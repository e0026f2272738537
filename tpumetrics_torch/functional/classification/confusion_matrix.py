"""Confusion matrices, binary, multiclass and multilabel (port of
``tpumetrics/functional/classification/confusion_matrix.py``).

The binary and multiclass matrices are one int32 count over the flat index
``target * n + pred`` (:func:`_masked_confmat`, which reads nothing on the
host); the multilabel ``(L, 2, 2)`` matrices are the four masked sums of the
stat scores. Ignored positions are masked, so no shape depends on the data.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _masked_confmat,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor

_ALLOWED_NORMALIZE = ("true", "pred", "all", "none", None)


def _validate_normalize(normalize: Optional[str]) -> None:
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_ALLOWED_NORMALIZE}")


def _confusion_matrix_reduce(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalize over the true labels (rows), the predictions (columns) or
    everything, in float32; an empty row or column gives zeros, not NaN."""
    _validate_normalize(normalize)
    if normalize is None or normalize == "none":
        return confmat
    confmat = confmat.to(torch.float32)
    if normalize == "true":
        confmat = confmat / confmat.sum(dim=-1, keepdim=True)
    elif normalize == "pred":
        confmat = confmat / confmat.sum(dim=-2, keepdim=True)
    else:
        confmat = confmat / confmat.sum(dim=(-2, -1), keepdim=True)
    return torch.nan_to_num(confmat)


def _multilabel_confmat(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """(num_labels, 2, 2) int32 per-label matrices ``[[tn, fp], [fn, tp]]``."""
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, mask, "global")
    return torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2).to(torch.int32)


def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
    _validate_normalize(normalize)


def _multiclass_confusion_matrix_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an int, but got {ignore_index}")
    _validate_normalize(normalize)


def _multilabel_confusion_matrix_arg_validation(
    num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    _multilabel_stat_scores_arg_validation(num_labels, threshold, None, "global", ignore_index)
    _validate_normalize(normalize)


def binary_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """2x2 confusion matrix for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_confusion_matrix
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> binary_confusion_matrix(preds, target).tolist()
        [[2, 0], [1, 1]]
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
    preds, target, mask = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    return _confusion_matrix_reduce(_masked_confmat(preds, target, mask, 2), normalize)


def multiclass_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """(C, C) confusion matrix for multiclass tasks, true labels in the rows.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_confusion_matrix
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> multiclass_confusion_matrix(preds, target, num_classes=3).tolist()
        [[1, 1, 0], [0, 1, 0], [0, 0, 1]]
    """
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)
    preds, target, mask = _multiclass_stat_scores_format(preds, target, num_classes, ignore_index, 1)
    return _confusion_matrix_reduce(_masked_confmat(preds, target, mask, num_classes), normalize)


def multilabel_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """(num_labels, 2, 2) per-label confusion matrices.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_confusion_matrix
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> multilabel_confusion_matrix(preds, target, num_labels=3).tolist()
        [[[1, 0], [0, 1]], [[1, 0], [1, 0]], [[0, 1], [0, 1]]]
    """
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, "global", ignore_index)
    preds, target, mask = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    return _confusion_matrix_reduce(_multilabel_confmat(preds, target, mask), normalize)


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for the confusion matrix.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import confusion_matrix
        >>> confusion_matrix(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]), task="binary").tolist()
        [[2, 0], [1, 1]]
    """
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_confusion_matrix(
            preds, target, _check_task_size("num_classes", num_classes), normalize, ignore_index, validate_args
        )
    return multilabel_confusion_matrix(
        preds, target, _check_task_size("num_labels", num_labels), threshold, normalize, ignore_index, validate_args
    )
