"""F-beta and F1 scores, multiclass part (port of ``tpumetrics/functional/classification/f_beta.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
)
from tpumetrics_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide

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
        if not (isinstance(beta, float) and beta > 0):
            raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target, mask = _multiclass_stat_scores_format(preds, target, num_classes, ignore_index, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, mask, num_classes, top_k, average, multidim_average
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
