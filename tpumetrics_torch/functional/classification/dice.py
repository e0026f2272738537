"""Dice score, ``2 TP / (2 TP + FP + FN)`` (port of
``tpumetrics/functional/classification/dice.py``), over the legacy input
formats it detects itself: scores ``(N, C, ...)``, binary probabilities, or
integer labels.

Everything becomes ``(N', C)`` int32 one-hot rows through ``_one_hot``,
which gives an all-zero row to a label outside ``[0, C)`` as
``jax.nn.one_hot`` does (a void label such as 255 in segmentation counts as
no class), where ``torch.nn.functional.one_hot`` would raise. Per class,
``tp`` is the overlap and ``fp``/``fn`` the predicted/target counts less
``tp``: the same integers as the JAX package's three products.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.utils.compute import _safe_divide, normalize_logits_if_needed
from tpumetrics_torch.utils.data import _one_hot, select_topk

Tensor = torch.Tensor

_AVERAGES = ("micro", "macro", "weighted", "samples", "none", None)


def _dice_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int]:
    """Detect the input form; return ``(N', C)`` int32 one-hot preds and
    target and the class count. Integer labels without ``num_classes`` read
    the largest label on the host."""
    if preds.ndim == target.ndim + 1:  # (N, C, ...) scores
        n_cls = preds.shape[1]
        preds = preds.movedim(1, -1).reshape(-1, n_cls)
        target = target.reshape(-1)
        preds = normalize_logits_if_needed(preds, "softmax")
        if top_k is not None and top_k > 1:
            preds_oh = select_topk(preds, top_k, dim=1)
        else:
            preds_oh = _one_hot(torch.argmax(preds, dim=1), n_cls)
        return preds_oh, _one_hot(target, n_cls), n_cls
    if preds.is_floating_point():  # binary probabilities, thresholded inclusively as the legacy format did
        preds = normalize_logits_if_needed(preds.reshape(-1), "sigmoid")
        preds_lab = (preds >= threshold).to(torch.int32)
        target_lab = target.reshape(-1).to(torch.int32)
        n_cls = num_classes if num_classes is not None else 2
        return _one_hot(preds_lab, n_cls), _one_hot(target_lab, n_cls), n_cls
    preds_lab = preds.reshape(-1).to(torch.int32)
    target_lab = target.reshape(-1).to(torch.int32)
    n_cls = num_classes if num_classes is not None else int(torch.max(torch.maximum(preds_lab, target_lab))) + 1
    return _one_hot(preds_lab, n_cls), _one_hot(target_lab, n_cls), n_cls


def _drop_ignored_class(preds_oh: Tensor, target_oh: Tensor, n_cls: int, ignore_index: Optional[int]):
    """Zero the column of an in-range ``ignore_index`` in both one-hots."""
    if ignore_index is None or not 0 <= ignore_index < n_cls:
        return preds_oh, target_oh
    keep = torch.ones(n_cls, dtype=torch.int32, device=preds_oh.device)
    keep[ignore_index] = 0
    return preds_oh * keep, target_oh * keep


def _dice_counts(preds_oh: Tensor, target_oh: Tensor, dim: int) -> Tuple[Tensor, Tensor, Tensor]:
    """int32 tp, fp, fn of 0/1 one-hots summed over ``dim``."""
    tp = torch.sum(preds_oh * target_oh, dim=dim, dtype=torch.int32)
    fp = torch.sum(preds_oh, dim=dim, dtype=torch.int32) - tp
    fn = torch.sum(target_oh, dim=dim, dtype=torch.int32) - tp
    return tp, fp, fn


def _dice_score(tp: Tensor, fp: Tensor, fn: Tensor, zero_division: float) -> Tensor:
    return _safe_divide(2.0 * tp, 2.0 * tp + fp + fn, zero_division)


def _dice_samplewise(
    preds: Tensor,
    target: Tensor,
    preds_oh: Tensor,
    target_oh: Tensor,
    n_cls: int,
    average: str,
    zero_division: float,
    ignore_index: Optional[int],
) -> Tuple[Tensor, int]:
    """(sum of per-sample scores, sample count): each original sample's
    counts over its positions, the class average taken within the sample;
    inputs with no extra dimensions make each row a one-position sample. The
    macro mean leaves out the column of an in-range ``ignore_index``."""
    n_samples = preds.shape[0] if preds.ndim > 1 or target.ndim > 1 else preds_oh.shape[0]
    per = preds_oh.reshape(n_samples, -1, n_cls).to(torch.float32)
    tgt = target_oh.reshape(n_samples, -1, n_cls).to(torch.float32)
    tp = (per * tgt).sum(dim=1)
    fp = (per * (1 - tgt)).sum(dim=1)
    fn = ((1 - per) * tgt).sum(dim=1)
    if average == "micro":
        scores = _dice_score(tp.sum(-1), fp.sum(-1), fn.sum(-1), zero_division)
    else:
        keep_cls = torch.ones(n_cls, dtype=torch.float32, device=per.device)
        if ignore_index is not None and 0 <= ignore_index < n_cls:
            keep_cls[ignore_index] = 0.0
        per_class = _dice_score(tp, fp, fn, zero_division)
        scores = (per_class * keep_cls).sum(dim=-1) / torch.clamp(keep_cls.sum(), min=1.0)
    return scores.sum(), n_samples


def _dice_reduce(
    tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str], zero_division: float, ignore_index: Optional[int]
) -> Tensor:
    """The per-class scores of the counts, averaged: ``none``/None keeps
    them, ``weighted`` weighs by support, ``macro`` averages over the classes
    present in preds or target (an in-range ``ignore_index`` left out)."""
    scores = _dice_score(tp, fp, fn, zero_division)
    if average in ("none", None):
        return scores
    if average == "weighted":
        weights = tp + fn
        return torch.sum(scores * _safe_divide(weights, weights.sum()))
    present = ((tp + fp + fn) > 0).to(scores.dtype)
    if ignore_index is not None and 0 <= ignore_index < present.shape[0]:
        present[ignore_index] = 0.0
    return torch.sum(scores * present) / torch.clamp(present.sum(), min=1.0)


def _dice_arg_validation(average: Optional[str], mdmc_average: Optional[str], multiclass: Optional[bool]) -> None:
    if average not in _AVERAGES:
        raise ValueError(f"The `average` has to be one of {_AVERAGES}, got {average}.")
    if mdmc_average not in (None, "samplewise", "global"):
        raise ValueError(f"The `mdmc_average` {mdmc_average} is not valid.")
    if multiclass is False:
        raise NotImplementedError(
            "The deprecated `multiclass=False` binary reinterpretation is not supported;"
            " use binary_f1_score (dice == F1 for binary inputs) instead."
        )


def _check_mdmc(mdmc_average: Optional[str], target: Tensor) -> None:
    if mdmc_average is None and target.ndim > 1:
        raise ValueError(
            "When your inputs are multi-dimensional multi-class, you have to set the"
            " `mdmc_average` parameter ('global' or 'samplewise')."
        )


def dice(
    preds: Tensor,
    target: Tensor,
    zero_division: int = 0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Dice = 2 TP / (2 TP + FP + FN).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional import dice
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(dice(preds, target, average='micro')), 4)
        0.25
    """
    _dice_arg_validation(average, mdmc_average, multiclass)
    _check_mdmc(mdmc_average, target)
    preds_oh, target_oh, n_cls = _dice_format(preds, target, threshold, top_k, num_classes)
    preds_oh, target_oh = _drop_ignored_class(preds_oh, target_oh, n_cls, ignore_index)

    if mdmc_average == "samplewise":
        if average not in ("micro", "macro"):
            raise ValueError("mdmc_average='samplewise' supports average in ('micro', 'macro') here")
        score_sum, count = _dice_samplewise(
            preds, target, preds_oh, target_oh, n_cls, average, zero_division, ignore_index
        )
        return score_sum / count

    if average == "samples":
        return _dice_score(*_dice_counts(preds_oh, target_oh, dim=1), zero_division).mean()

    tp, fp, fn = _dice_counts(preds_oh, target_oh, dim=0)
    if average == "micro":
        return _dice_score(tp.sum(), fp.sum(), fn.sum(), zero_division)
    return _dice_reduce(tp, fp, fn, average, zero_division, ignore_index)
