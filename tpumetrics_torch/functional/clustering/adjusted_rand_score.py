"""Adjusted Rand score (port of
``tpumetrics/functional/clustering/adjusted_rand_score.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.clustering.utils import (
    calculate_contingency_matrix,
    calculate_pair_cluster_confusion_matrix,
    check_cluster_labels,
)

Tensor = torch.Tensor


def _adjusted_rand_score_update(
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


def _adjusted_rand_score_compute(contingency: Tensor) -> Tensor:
    """ARI from the 2x2 pair matrix; 1.0 where no pair disagrees."""
    pair_matrix = calculate_pair_cluster_confusion_matrix(contingency=contingency)
    tn, fp = pair_matrix[0, 0], pair_matrix[0, 1]
    fn, tp = pair_matrix[1, 0], pair_matrix[1, 1]
    denominator = (tp + fn) * (fn + tn) + (tp + fp) * (fp + tn)
    degenerate = (fn == 0) & (fp == 0)
    safe_den = torch.where(denominator == 0, 1.0, denominator)
    return torch.where(degenerate, 1.0, 2.0 * (tp * tn - fn * fp) / safe_den).to(torch.float32)


def adjusted_rand_score(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Adjusted Rand score between two clusterings.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import adjusted_rand_score
        >>> float(adjusted_rand_score(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1])))
        1.0
        >>> round(float(adjusted_rand_score(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))), 4)
        0.5714
    """
    contingency = _adjusted_rand_score_update(preds, target, num_classes_preds, num_classes_target, mask)
    return _adjusted_rand_score_compute(contingency)
