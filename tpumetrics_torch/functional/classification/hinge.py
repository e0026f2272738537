"""Hinge loss, binary and multiclass (port of
``tpumetrics/functional/classification/hinge.py``), with the crammer-singer
and one-vs-all multiclass modes.

Entries at ``ignore_index`` are masked rather than dropped: they add a zero
measure, and the total counts the kept entries from the mask. The states
are sums, so the values equal the JAX package's, which drops them by
boolean indexing; the update keeps static shapes, reads nothing on the
host, and a CUDA graph can hold it. Without ``ignore_index`` the batch size
is a tensor filled on the device, for the same reason.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_tensor_validation,
)
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.compute import normalize_logits_if_needed
from tpumetrics_torch.utils.data import _one_hot
from tpumetrics_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


def _hinge_loss_compute(measure: Tensor, total: Tensor) -> Tensor:
    return measure / total


def _binary_hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    if not isinstance(squared, bool):
        raise ValueError(f"Expected argument `squared` to be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an int, but got {ignore_index}")


def _multiclass_hinge_loss_arg_validation(
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_hinge_loss_arg_validation(squared, ignore_index)
    if multiclass_mode not in ("crammer-singer", "one-vs-all"):
        raise ValueError(
            f"Expected argument `multiclass_mode` to be one of ('crammer-singer', 'one-vs-all'),"
            f" but got {multiclass_mode}"
        )


def _keep_mask(target: Tensor, ignore_index: Optional[int]) -> Optional[Tensor]:
    return None if ignore_index is None else target != ignore_index


def _binary_hinge_loss_format(
    preds: Tensor, target: Tensor, ignore_index: Optional[int]
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Flat preds (a sigmoid applied when they look like logits), flat
    targets and the mask of kept entries (None without ``ignore_index``).
    Ignored preds are set to 0 first, so they take no part in the
    is-probability test, as dropped entries take none in the JAX package."""
    preds, target = preds.reshape(-1), target.reshape(-1)
    keep = _keep_mask(target, ignore_index)
    if keep is not None:
        preds = torch.where(keep, preds, 0.0)
    return normalize_logits_if_needed(preds, "sigmoid"), target, keep


def _multiclass_hinge_loss_format(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int]
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """``(N, C, ...)`` scores to ``(N', C)`` rows (a softmax applied when
    they look like logits), flat targets and the mask of kept rows."""
    preds = preds.movedim(1, -1).reshape(-1, num_classes)
    target = target.reshape(-1)
    keep = _keep_mask(target, ignore_index)
    if keep is not None:
        preds = torch.where(keep[:, None], preds, 0.0)
    return normalize_logits_if_needed(preds, "softmax"), target, keep


def _masked_total(measures: Tensor, keep: Optional[Tensor], n: int) -> Tuple[Tensor, Tensor]:
    """The measures with the ignored entries zeroed, and the int32 count of the kept ones."""
    if keep is None:
        return measures, torch.full((), n, dtype=torch.int32, device=measures.device)
    keep = keep.reshape(keep.shape + (1,) * (measures.ndim - keep.ndim))
    return torch.where(keep, measures, 0.0), keep.sum(dtype=torch.int32)


def _binary_hinge_loss_update(
    preds: Tensor, target: Tensor, squared: bool, keep: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """(sum of the measures, count): margin = preds where positive, -preds where negative."""
    margin = torch.where(target == 1, preds, -preds)
    measures = torch.clamp(1 - margin, min=0.0)
    if squared:
        measures = measures**2
    measures, total = _masked_total(measures, keep, target.shape[0])
    return measures.sum(), total


def _multiclass_hinge_loss_update(
    preds: Tensor,
    target: Tensor,
    squared: bool,
    multiclass_mode: str = "crammer-singer",
    keep: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """(sum of the measures, count); the sum is a scalar in crammer-singer
    mode (the true class's score against the best other one) and per class
    in one-vs-all mode."""
    target_oh = _one_hot(target, preds.shape[1]).bool()
    if multiclass_mode == "crammer-singer":
        margin = torch.where(target_oh, preds, 0.0).sum(dim=1)
        margin = margin - torch.where(target_oh, float("-inf"), preds).amax(dim=1)
    else:
        margin = torch.where(target_oh, preds, -preds)
    measures = torch.clamp(1 - margin, min=0.0)
    if squared:
        measures = measures**2
    measures, total = _masked_total(measures, keep, target.shape[0])
    return measures.sum(dim=0), total


def binary_hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Mean hinge loss for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_hinge_loss
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> round(float(binary_hinge_loss(preds, target)), 4)
        0.69
    """
    if validate_args:
        _binary_hinge_loss_arg_validation(squared, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, keep = _binary_hinge_loss_format(preds, target, ignore_index)
    return _hinge_loss_compute(*_binary_hinge_loss_update(preds, target, squared, keep))


def multiclass_hinge_loss(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Mean hinge loss for multiclass tasks: a scalar (crammer-singer) or per class (one-vs-all).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_hinge_loss
        >>> preds = torch.tensor([[0.25, 0.20, 0.55], [0.55, 0.05, 0.40], [0.10, 0.30, 0.60], [0.90, 0.05, 0.05]])
        >>> target = torch.tensor([0, 1, 2, 0])
        >>> round(float(multiclass_hinge_loss(preds, target, num_classes=3)), 4)
        0.9125
    """
    if validate_args:
        _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, keep = _multiclass_hinge_loss_format(preds, target, num_classes, ignore_index)
    return _hinge_loss_compute(*_multiclass_hinge_loss_update(preds, target, squared, multiclass_mode, keep))


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for the hinge loss (binary or multiclass).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import hinge_loss
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> round(float(hinge_loss(preds, target, task="binary")), 4)
        0.69
    """
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args)
    return multiclass_hinge_loss(
        preds, target, _check_task_size("num_classes", num_classes), squared, multiclass_mode, ignore_index,
        validate_args,
    )
