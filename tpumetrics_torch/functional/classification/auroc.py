"""Area under the ROC curve, binary, multiclass and multilabel (port of
``tpumetrics/functional/classification/auroc.py``)."""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    CurveState,
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from tpumetrics_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from tpumetrics_torch.utils.checks import _check_task_size
from tpumetrics_torch.utils.compute import _auc_compute_without_check, _safe_divide, interp
from tpumetrics_torch.utils.data import _bincount
from tpumetrics_torch.utils.enums import ClassificationTask
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _reduce_auroc(
    fpr: Union[Tensor, List[Tensor]],
    tpr: Union[Tensor, List[Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Reduce per-class AUCs (of ``(C, T)`` curves or of per-class lists):
    macro mean over non-nan classes, or support-weighted mean. The nan
    warning reads one flag on the host."""
    if isinstance(fpr, Tensor):
        res = _auc_compute_without_check(fpr, tpr, 1.0, axis=1)
    else:
        res = torch.stack([_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)])
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


def _binary_auroc_arg_validation(
    max_fpr: Optional[float] = None,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Arguments `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _binary_auroc_compute(
    state: CurveState,
    thresholds: Optional[Tensor],
    max_fpr: Optional[float] = None,
    pos_label: int = 1,
) -> Tensor:
    """Trapezoidal AUC, with the McClish correction of the partial AUC up to
    ``max_fpr``: the curve is clipped at ``max_fpr`` with an interpolated
    endpoint, so no shape depends on the data."""
    fpr, tpr, _ = _binary_roc_compute(state, thresholds, pos_label)
    full_auc = _auc_compute_without_check(fpr, tpr, 1.0)
    if max_fpr is None or max_fpr == 1:
        return full_auc

    max_area = torch.tensor(max_fpr, dtype=fpr.dtype, device=fpr.device)
    tpr_at_max = interp(max_area, fpr, tpr)
    fpr_c = torch.minimum(fpr, max_area)
    tpr_c = torch.where(fpr <= max_area, tpr, tpr_at_max)
    partial_auc = _auc_compute_without_check(fpr_c, tpr_c, 1.0)
    min_area = 0.5 * max_area**2
    mcclish = 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))
    degenerate = (torch.sum(fpr) == 0) | (torch.sum(tpr) == 0)
    return torch.where(degenerate, full_auc, mcclish)


def binary_auroc(
    preds: Tensor,
    target: Tensor,
    max_fpr: Optional[float] = None,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Area under the ROC curve for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_auroc
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> round(float(binary_auroc(preds, target)), 4)
        0.75
    """
    if validate_args:
        _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ignore_index)
    return _binary_auroc_compute(state, thresholds, max_fpr)


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
    state: CurveState,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    """AUROC of the per-class curves. The per-class support for ``weighted``
    is the label count (exact) or tp + fn of the first threshold (binned)."""
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    if thresholds is None:
        weights = _bincount(state[1], minlength=num_classes).to(torch.float32)
    else:
        weights = state[0][:, 1, :].sum(-1).to(torch.float32)
    return _reduce_auroc(fpr, tpr, average, weights=weights)


def multiclass_auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Area under the one-vs-rest ROC curves for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_auroc
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05], [0.05, 0.05, 0.9], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> round(float(multiclass_auroc(preds, target, num_classes=3)), 4)
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


def _multilabel_auroc_arg_validation(
    num_labels: int,
    average: Optional[str],
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None)"
            f" but got {average}"
        )
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)


def _multilabel_auroc_compute(
    state: CurveState,
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    """AUROC of the per-label curves; ``micro`` is the binary AUROC of every
    entry (binned: the label-summed state; exact: ignored entries dropped)."""
    if average == "micro":
        if thresholds is not None:
            return _binary_auroc_compute(state.sum(1, dtype=torch.int32), thresholds)
        preds = state[0].reshape(-1)
        target = state[1].reshape(-1)
        if ignore_index is not None:
            keep = target != ignore_index
            preds, target = preds[keep], target[keep]
        return _binary_auroc_compute((preds, target), None)

    fpr, tpr, _ = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    if thresholds is None:
        weights = (state[1] == 1).sum(0).to(torch.float32)
    else:
        weights = state[0][:, 1, :].sum(-1).to(torch.float32)
    return _reduce_auroc(fpr, tpr, average, weights=weights)


def multilabel_auroc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Area under the per-label ROC curves for multilabel tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_auroc
        >>> preds = torch.tensor([[0.75, 0.05], [0.05, 0.75], [0.05, 0.05], [0.75, 0.75]])
        >>> target = torch.tensor([[1, 0], [0, 1], [0, 0], [1, 1]])
        >>> round(float(multilabel_auroc(preds, target, num_labels=2)), 4)
        1.0
    """
    if validate_args:
        _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds_arr = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds_arr, ignore_index)
    return _multilabel_auroc_compute(state, num_labels, average, thresholds_arr, ignore_index)


def auroc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher for AUROC.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import auroc
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> round(float(auroc(preds, target, task="binary")), 4)
        0.75
    """
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_auroc(
            preds, target, _check_task_size("num_classes", num_classes), average, thresholds, ignore_index,
            validate_args,
        )
    return multilabel_auroc(
        preds, target, _check_task_size("num_labels", num_labels), average, thresholds, ignore_index, validate_args
    )
