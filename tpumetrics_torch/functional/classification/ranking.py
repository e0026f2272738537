"""Multilabel ranking metrics: coverage error, label ranking average
precision and label ranking loss (port of
``tpumetrics/functional/classification/ranking.py``).

The ranking average precision is the JAX package's batched form: one
``(N, L, L)`` comparison of every pair of labels of a sample ('max' ranks
for ties), no loop over samples. The ranking loss ranks with two stable
argsorts, as ``jnp.argsort`` is stable: the default unstable sort breaks
ties another way and changes the loss on tied preds. The batch size is a
tensor filled on the device, so no update reads anything on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.classification.precision_recall_curve import (
    _multilabel_precision_recall_curve_tensor_validation,
)
from tpumetrics_torch.utils.compute import normalize_logits_if_needed

Tensor = torch.Tensor


def _ranking_reduce(score: Tensor, num_elements: Tensor) -> Tensor:
    return score / num_elements


def _batch_count(x: Tensor) -> Tensor:
    return torch.full((), x.shape[0], dtype=torch.int32, device=x.device)


def _multilabel_ranking_format(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int]
) -> Tuple[Tensor, Tensor]:
    """``(N, L, ...)`` to ``(N', L)`` rows, a sigmoid applied when the preds
    look like logits. Ignored entries get ``-4 * num_labels`` in both preds
    and target, so they rank last and are never relevant."""
    preds = preds.reshape(preds.shape[0], num_labels, -1).movedim(1, -1).reshape(-1, num_labels)
    target = target.reshape(target.shape[0], num_labels, -1).movedim(1, -1).reshape(-1, num_labels)
    preds = normalize_logits_if_needed(preds, "sigmoid")
    if ignore_index is not None:
        idx = target == ignore_index
        preds = torch.where(idx, -4.0 * num_labels, preds)
        target = torch.where(idx, -4 * num_labels, target)
    return preds, target


def _multilabel_coverage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """(sum of the coverages, count): how many labels score at least the
    lowest-scored relevant label. Irrelevant labels are lifted above every
    pred by ``|min of the whole batch| + 10`` before the row minimum."""
    offset = torch.where(target == 0, torch.abs(preds.min()) + 10, 0.0)
    preds_min = (preds + offset).amin(dim=1)
    coverage = (preds >= preds_min[:, None]).sum(dim=1, dtype=torch.int32).to(torch.float32)
    return coverage.sum(), _batch_count(coverage)


def _multilabel_ranking_average_precision_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """(sum of the per-sample scores, count). A relevant label's score is its
    'max' rank among the relevant labels over its rank among all; a sample
    with no relevant label, or with every label relevant, scores 1."""
    neg_preds = -preds
    relevant = target == 1
    num_labels = preds.shape[1]
    # [n, i, j]: label j ranks at or above label i
    above = neg_preds[:, None, :] <= neg_preds[:, :, None]
    rank_all = above.sum(dim=-1, dtype=torch.int32).to(torch.float32)
    rank_rel = (above & relevant[:, None, :]).sum(dim=-1, dtype=torch.int32).to(torch.float32)
    n_rel = relevant.sum(dim=1, dtype=torch.int32)
    per_label = torch.where(relevant, rank_rel / rank_all, 0.0)
    score = torch.where(
        (n_rel > 0) & (n_rel < num_labels), per_label.sum(dim=1) / torch.clamp(n_rel, min=1), 1.0
    )
    return score.sum(), _batch_count(preds)


def _multilabel_ranking_loss_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """(sum of the per-sample losses, count): the share of (relevant,
    irrelevant) label pairs ordered wrongly; samples with no relevant label,
    or with every label relevant, add 0 and still count."""
    num_labels = preds.shape[1]
    relevant = target == 1
    num_relevant = relevant.sum(dim=1, dtype=torch.int32)
    mask = (num_relevant > 0) & (num_relevant < num_labels)
    inverse = torch.argsort(torch.argsort(preds, dim=1, stable=True), dim=1, stable=True)
    per_label_loss = ((num_labels - inverse) * relevant).to(torch.float32)
    correction = 0.5 * num_relevant * (num_relevant + 1)
    denom = num_relevant * (num_labels - num_relevant)
    loss = torch.where(mask, (per_label_loss.sum(dim=1) - correction) / torch.clamp(denom, min=1), 0.0)
    return loss.sum(), _batch_count(preds)


def _multilabel_ranking(update, preds, target, num_labels, ignore_index, validate_args) -> Tensor:
    if validate_args:
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    return _ranking_reduce(*update(preds, target))


def multilabel_coverage_error(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """How far down the ranking one must go to cover every relevant label.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_coverage_error
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 1], [0, 1, 1]])
        >>> round(float(multilabel_coverage_error(preds, target, num_labels=3)), 4)
        2.3333
    """
    return _multilabel_ranking(
        _multilabel_coverage_error_update, preds, target, num_labels, ignore_index, validate_args
    )


def multilabel_ranking_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Label ranking average precision of multilabel data.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_ranking_average_precision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 1], [0, 1, 1]])
        >>> round(float(multilabel_ranking_average_precision(preds, target, num_labels=3)), 4)
        0.7778
    """
    return _multilabel_ranking(
        _multilabel_ranking_average_precision_update, preds, target, num_labels, ignore_index, validate_args
    )


def multilabel_ranking_loss(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Label ranking loss of multilabel data (lower is better).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_ranking_loss
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 1], [0, 1, 1]])
        >>> round(float(multilabel_ranking_loss(preds, target, num_labels=3)), 4)
        0.3333
    """
    return _multilabel_ranking(
        _multilabel_ranking_loss_update, preds, target, num_labels, ignore_index, validate_args
    )
