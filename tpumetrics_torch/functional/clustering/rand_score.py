"""Rand score (port of ``tpumetrics/functional/clustering/rand_score.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.clustering.utils import (
    calculate_contingency_matrix,
    calculate_pair_cluster_confusion_matrix,
    check_cluster_labels,
)

Tensor = torch.Tensor


def _rand_score_update(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    check_cluster_labels(preds, target)
    return calculate_contingency_matrix(
        preds, target, num_classes_preds=num_classes_preds, num_classes_target=num_classes_target, mask=mask
    )


def _rand_score_compute(contingency: Tensor) -> Tensor:
    """Agreeing pairs over all pairs; 1.0 where no pair is split or every
    label is unique."""
    pair_matrix = calculate_pair_cluster_confusion_matrix(contingency=contingency)
    numerator = pair_matrix[0, 0] + pair_matrix[1, 1]
    denominator = pair_matrix.sum()
    degenerate = (numerator == denominator) | (denominator == 0)
    value = torch.where(degenerate, 1.0, numerator / torch.where(denominator == 0, 1.0, denominator))
    return value.to(torch.float32)


def rand_score(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Rand score between two clusterings.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import rand_score
        >>> float(rand_score(torch.tensor([0, 0, 1, 1]), torch.tensor([1, 1, 0, 0])))
        1.0
        >>> round(float(rand_score(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))), 4)
        0.8333
    """
    contingency = _rand_score_update(preds, target, num_classes_preds, num_classes_target, mask)
    return _rand_score_compute(contingency)
