"""Area under the ROC curve, binned multiclass path (port of
``tpumetrics/functional/classification/auroc.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
)
from tpumetrics_torch.functional.classification.roc import _multiclass_roc_compute
from tpumetrics_torch.utils.compute import _auc_compute_without_check, _safe_divide
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _reduce_auroc(
    fpr: Tensor,
    tpr: Tensor,
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Reduce per-class AUCs: macro mean over non-nan classes, or
    support-weighted mean. The nan warning reads one flag on the host."""
    res = _auc_compute_without_check(fpr, tpr, 1.0, axis=1)
    if average is None or average == "none":
        return res
    idx = ~torch.isnan(res)
    if not bool(idx.all()):
        rank_zero_warn(
            f"Average precision score for one or more classes was `nan`. Ignoring these classes in {average}-average",
            UserWarning,
        )
    if average == "macro":
        return torch.sum(torch.where(idx, res, 0.0)) / torch.sum(idx)
    if average == "weighted" and weights is not None:
        weights = torch.where(idx, weights, 0.0)
        weights = _safe_divide(weights, torch.sum(weights))
        return torch.sum(torch.where(idx, res * weights, 0.0))
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


def _multiclass_auroc_arg_validation(
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if average not in ("macro", "weighted", "none", None):
        raise ValueError(f"Expected argument `average` to be one of ('macro', 'weighted', 'none', None)"
                         f" but got {average}")
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)


def _multiclass_auroc_compute(
    state: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    """AUROC from the (T, C, 2, 2) binned state; the per-class support for
    ``weighted`` is tp + fn of the first threshold."""
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    return _reduce_auroc(fpr, tpr, average, weights=state[0][:, 1, :].sum(-1).to(torch.float32))


def multiclass_auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Area under the one-vs-rest ROC curves for multiclass tasks, over
    binned thresholds.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_auroc
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05], [0.05, 0.05, 0.9], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> round(float(multiclass_auroc(preds, target, num_classes=3, thresholds=11)), 4)
        1.0
    """
    if validate_args:
        _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds_arr = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(
        preds, target, num_classes, thresholds_arr, None, ignore_index
    )
    return _multiclass_auroc_compute(state, num_classes, average, thresholds_arr)
