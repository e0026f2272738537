"""Cohen's kappa, binary and multiclass (port of
``tpumetrics/functional/classification/cohen_kappa.py``): agreement beyond
chance of the confusion matrix, with no, linear or quadratic weights, in
float32 as in the JAX package."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
)
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


def _cohen_kappa_reduce(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    """1 - (weighted disagreement) / (weighted disagreement expected by
    chance). Unknown ``weights`` raise here, with or without
    ``validate_args``, as in the JAX package. The expected matrix is the
    outer product of the row and column sums, taken elementwise: one float32
    product per entry, as the JAX package's one-term matmul gives, and
    immune to TF32."""
    _cohen_kappa_weights_validation(weights)
    confmat = confmat.to(torch.float32)
    num_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    expected = sum1 * sum0 / sum0.sum()
    if weights is None or weights == "none":
        w_mat = 1 - torch.eye(num_classes, dtype=confmat.dtype, device=confmat.device)
    else:
        grid = torch.arange(num_classes, dtype=confmat.dtype, device=confmat.device)
        diff = grid[None, :] - grid[:, None]
        w_mat = diff.abs() if weights == "linear" else diff**2
    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def _cohen_kappa_weights_validation(weights: Optional[str]) -> None:
    if weights not in (None, "none", "linear", "quadratic"):
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )


def binary_cohen_kappa(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Cohen's kappa for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_cohen_kappa
        >>> preds = torch.tensor([0.35, 0.85, 0.48, 0.01])
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> round(float(binary_cohen_kappa(preds, target)), 4)
        0.5
    """
    confmat = binary_confusion_matrix(preds, target, threshold, None, ignore_index, validate_args)
    return _cohen_kappa_reduce(confmat, weights)


def multiclass_cohen_kappa(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Cohen's kappa for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_cohen_kappa
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> round(float(multiclass_cohen_kappa(preds, target, num_classes=3)), 4)
        0.6364
    """
    confmat = multiclass_confusion_matrix(preds, target, num_classes, None, ignore_index, validate_args)
    return _cohen_kappa_reduce(confmat, weights)


def cohen_kappa(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for Cohen's kappa (binary or multiclass).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import cohen_kappa
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> round(float(cohen_kappa(preds, target, task="multiclass", num_classes=3)), 4)
        0.6364
    """
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args)
    return multiclass_cohen_kappa(
        preds, target, _check_task_size("num_classes", num_classes), weights, ignore_index, validate_args
    )
