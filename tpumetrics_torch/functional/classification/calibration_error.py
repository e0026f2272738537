"""Top-label calibration error, binary and multiclass (port of
``tpumetrics/functional/classification/calibration_error.py``), with the
``l1`` (expected), ``l2`` (root mean square, optionally debiased) and
``max`` norms.

The confidences fall into ``n_bins`` equal-width bins whose edges are
``jnp.linspace(0, 1, n_bins + 1)`` rebuilt bit for bit (one ulp off would
move confidences across an edge), bucketed as ``searchsorted(...,
side="right")`` into the inner edges, clipped. The per-bin sums are the
column sums of an ``(N, n_bins)`` masked copy of the values, not a scatter-add
(``index_add_``): a card adds floats in ``index_add_`` in whatever order its
atomics land, so two computes of the same state could differ in the last
bit, where a reduction sums in a fixed order. The sums run in another order
than XLA's, so values agree with the JAX package to rounding (1e-6 absolute
at the test sizes).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from tpumetrics_torch.functional.classification.confusion_matrix import _multiclass_confusion_matrix_arg_validation
from tpumetrics_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _binary_precision_recall_curve_tensor_validation,
)
from tpumetrics_torch.functional.classification.stat_scores import _multiclass_stat_scores_tensor_validation
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.compute import _safe_divide, normalize_logits_if_needed
from tpumetrics_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor

_NORMS = ("l1", "l2", "max")


def _bucket_sum(values: Tensor, indices: Tensor, n_bins: int) -> Tensor:
    """Per-bucket sums of ``values``, each bucket summed in a fixed order."""
    in_bin = indices[:, None] == torch.arange(n_bins, device=indices.device)
    return torch.where(in_bin, values[:, None], 0.0).sum(dim=0)


def _binning_bucketize(
    confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin mean accuracy, mean confidence and share of the samples."""
    n_bins = bin_boundaries.shape[0] - 1
    inner = bin_boundaries[1:-1].contiguous()
    indices = torch.clamp(torch.searchsorted(inner, confidences, right=True), 0, n_bins - 1)
    count_bin = _bucket_sum(torch.ones_like(confidences), indices, n_bins)
    conf_bin = _safe_divide(_bucket_sum(confidences, indices, n_bins), count_bin)
    acc_bin = _safe_divide(_bucket_sum(accuracies.to(confidences.dtype), indices, n_bins), count_bin)
    prop_bin = count_bin / count_bin.sum()
    return acc_bin, conf_bin, prop_bin


def _ce_compute(
    confidences: Tensor,
    accuracies: Tensor,
    bin_boundaries: Union[Tensor, int],
    norm: str = "l1",
    debias: bool = False,
) -> Tensor:
    """The calibration error of the norm from flat confidences and 0/1 accuracies."""
    if isinstance(bin_boundaries, int):
        bin_boundaries = _adjust_threshold_arg(bin_boundaries + 1, confidences.device).to(confidences.dtype)
    if norm not in _NORMS:
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")

    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)

    if norm == "l1":
        return torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    if norm == "max":
        return torch.amax(torch.abs(acc_bin - conf_bin))
    ce = torch.sum(torch.pow(acc_bin - conf_bin, 2) * prop_bin)
    if debias:
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * accuracies.shape[0] - 1)
        ce = ce + torch.sum(torch.nan_to_num(debias_bins))
    return torch.where(ce > 0, torch.sqrt(torch.clamp(ce, min=0.0)), 0.0)


def _binary_calibration_error_arg_validation(
    n_bins: int,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    if norm not in _NORMS:
        raise ValueError(f"Expected argument `norm` to be one of {_NORMS}, but got {norm}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multiclass_calibration_error_arg_validation(
    num_classes: int,
    n_bins: int,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, None)
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    if norm not in _NORMS:
        raise ValueError(f"Expected argument `norm` to be one of {_NORMS}, but got {norm}.")


def _drop_ignored(preds: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor]:
    """The entries (rows) whose target is not ``ignore_index``, by boolean
    indexing as in the JAX package: the list states keep only those, element
    for element the JAX package's (the index reads the mask on the host)."""
    if ignore_index is None:
        return preds, target
    keep = target != ignore_index
    return preds[keep], target[keep]


def _binary_calibration_error_format(
    preds: Tensor, target: Tensor, ignore_index: Optional[int]
) -> Tuple[Tensor, Tensor]:
    """Float32 confidences (the positive-class probabilities, a sigmoid
    applied when they look like logits) and float32 accuracies (the targets)."""
    preds, target = _drop_ignored(preds.reshape(-1), target.reshape(-1), ignore_index)
    preds = normalize_logits_if_needed(preds, "sigmoid")
    return preds.to(torch.float32), target.to(torch.float32)


def _multiclass_calibration_error_format(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int]
) -> Tuple[Tensor, Tensor]:
    """Float32 top-1 confidences (after a softmax when the scores look like
    logits) and float32 0/1 top-1 correctness, one per kept row."""
    preds = preds.movedim(1, -1).reshape(-1, num_classes)
    preds, target = _drop_ignored(preds, target.reshape(-1), ignore_index)
    preds = normalize_logits_if_needed(preds, "softmax")
    confidences = torch.amax(preds, dim=1)
    accuracies = torch.argmax(preds, dim=1) == target  # the first of tied maxima, as jnp.argmax
    return confidences.to(torch.float32), accuracies.to(torch.float32)


def binary_calibration_error(
    preds: Tensor,
    target: Tensor,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Top-label calibration error for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_calibration_error
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> round(float(binary_calibration_error(preds, target, n_bins=2, norm='l1')), 4)
        0.29
    """
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    confidences, accuracies = _binary_calibration_error_format(preds, target, ignore_index)
    return _ce_compute(confidences, accuracies, n_bins, norm)


def multiclass_calibration_error(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Top-label calibration error for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_calibration_error
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1]])
        >>> target = torch.tensor([0, 1])
        >>> round(float(multiclass_calibration_error(preds, target, num_classes=3)), 4)
        0.15
    """
    if validate_args:
        _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)
    confidences, accuracies = _multiclass_calibration_error_format(preds, target, num_classes, ignore_index)
    return _ce_compute(confidences, accuracies, n_bins, norm)


def calibration_error(
    preds: Tensor,
    target: Tensor,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for the calibration error (binary or multiclass).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import calibration_error
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> round(float(calibration_error(preds, target, task="binary", n_bins=2)), 4)
        0.29
    """
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args)
    return multiclass_calibration_error(
        preds, target, _check_task_size("num_classes", num_classes), n_bins, norm, ignore_index, validate_args
    )
