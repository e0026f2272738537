"""Mutual information score (port of
``tpumetrics/functional/clustering/mutual_info_score.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.clustering.utils import calculate_contingency_matrix, check_cluster_labels

Tensor = torch.Tensor


def _mutual_info_score_update(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Validate the labels and build the contingency table; ``mask`` drops
    the invalid rows of a fixed-capacity buffer."""
    check_cluster_labels(preds, target)
    return calculate_contingency_matrix(
        preds, target, num_classes_preds=num_classes_preds, num_classes_target=num_classes_target, mask=mask
    )


def _mutual_info_score_compute(contingency: Tensor) -> Tensor:
    """MI from a contingency table, every term where-masked: zero cells,
    rows and columns add exactly 0, and one cluster gives 0 (each cell
    equals its column marginal, so the log terms cancel)."""
    contingency = contingency.to(torch.float32)
    n = contingency.sum()
    u = contingency.sum(dim=1)
    v = contingency.sum(dim=0)

    nonzero = contingency > 0
    safe_c = torch.where(nonzero, contingency, 1.0)
    safe_u = torch.where(u > 0, u, 1.0)
    safe_v = torch.where(v > 0, v, 1.0)
    safe_n = torch.where(n > 0, n, 1.0)

    log_outer = torch.log(safe_u)[:, None] + torch.log(safe_v)[None, :]
    terms = contingency / safe_n * (torch.log(safe_n) + torch.log(safe_c) - log_outer)
    return torch.sum(torch.where(nonzero, terms, 0.0))


def mutual_info_score(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Mutual information between two clusterings.

    ``num_classes_*`` declare the class spaces (zero rows and columns do not
    change the value); without them the observed labels are relabelled on
    the host.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import mutual_info_score
        >>> target = torch.tensor([0, 3, 2, 2, 1])
        >>> preds = torch.tensor([1, 3, 2, 0, 1])
        >>> round(float(mutual_info_score(preds, target)), 4)
        1.0549
    """
    contingency = _mutual_info_score_update(preds, target, num_classes_preds, num_classes_target, mask)
    return _mutual_info_score_compute(contingency)
