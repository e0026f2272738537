"""Exact match (subset accuracy), multiclass with extra dimensions and
multilabel (port of ``tpumetrics/functional/classification/exact_match.py``):
a sample scores 1 only when every position or label is right. Ignored
positions (``ignore_index``) count as right."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.compute import _safe_divide
from tpumetrics_torch.utils.enums import ClassificationTaskNoBinary

Tensor = torch.Tensor


def _exact_match_reduce(correct: Tensor, total: Tensor) -> Tensor:
    return _safe_divide(correct, total)


def _exact_match_update(
    preds: Tensor, target: Tensor, mask: Tensor, multidim_average: str = "global"
) -> Tuple[Tensor, Tensor]:
    """Formatted multiclass ``(N, X)`` labels or multilabel ``(N, L, X)``
    bits to int32 (correct, total): summed over the batch (global), or per
    sample (samplewise). The batch size goes from the shape into a tensor
    filled on the device, so the update copies nothing from the host and a
    CUDA graph can hold it."""
    position_ok = (preds == target) | (mask == 0)
    correct = position_ok.flatten(1).all(dim=1).to(torch.int32)
    if multidim_average == "global":
        total = torch.full((), correct.shape[0], dtype=torch.int32, device=correct.device)
        return torch.sum(correct, dtype=torch.int32), total
    return correct, torch.ones_like(correct)


def _exact_match_value(correct: Tensor, total: Tensor, multidim_average: str) -> Tensor:
    if multidim_average == "global":
        return _exact_match_reduce(correct, total)
    return correct.to(torch.float32)


def multiclass_exact_match(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Exact-match ratio of multiclass inputs with extra dimensions.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_exact_match
        >>> target = torch.tensor([[0, 1], [2, 2]])
        >>> preds = torch.tensor([[0, 1], [2, 1]])
        >>> float(multiclass_exact_match(preds, target, num_classes=3))
        0.5
    """
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target, mask = _multiclass_stat_scores_format(preds, target, num_classes, ignore_index, 1)
    correct, total = _exact_match_update(preds, target, mask, multidim_average)
    return _exact_match_value(correct, total, multidim_average)


def multilabel_exact_match(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Exact-match ratio of multilabel inputs.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_exact_match
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> preds = torch.tensor([[0, 1, 0], [1, 0, 0]])
        >>> float(multilabel_exact_match(preds, target, num_labels=3))
        0.5
    """
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, mask = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    correct, total = _exact_match_update(preds, target, mask, multidim_average)
    return _exact_match_value(correct, total, multidim_average)


def exact_match(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for exact match (multiclass or multilabel).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import exact_match
        >>> target = torch.tensor([[0, 1], [2, 2], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [2, 0], [1, 1]])
        >>> round(float(exact_match(preds, target, task="multiclass", num_classes=3)), 4)
        0.6667
    """
    task = ClassificationTaskNoBinary.from_str(task)
    if task == ClassificationTaskNoBinary.MULTICLASS:
        return multiclass_exact_match(
            preds, target, _check_task_size("num_classes", num_classes), multidim_average, ignore_index,
            validate_args,
        )
    return multilabel_exact_match(
        preds, target, _check_task_size("num_labels", num_labels), threshold, multidim_average, ignore_index,
        validate_args,
    )
