"""Homogeneity, completeness and V-measure (port of
``tpumetrics/functional/clustering/homogeneity_completeness_v_measure.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.clustering.mutual_info_score import mutual_info_score
from tpumetrics_torch.functional.clustering.utils import calculate_entropy, check_cluster_labels, pair_valid_mask

Tensor = torch.Tensor


def _homogeneity_score_compute(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(homogeneity = MI / H(target), MI, H(preds), H(target)); 1.0 where
    H(target) is 0."""
    check_cluster_labels(preds, target)
    if preds.shape[0] == 0:
        zero = torch.zeros((), dtype=torch.float32, device=preds.device)
        return zero, zero, zero, zero

    valid = pair_valid_mask(preds, target, num_classes_preds, num_classes_target, mask)
    entropy_target = calculate_entropy(target, num_classes=num_classes_target, mask=valid)
    entropy_preds = calculate_entropy(preds, num_classes=num_classes_preds, mask=valid)
    mutual_info = mutual_info_score(
        preds, target, num_classes_preds=num_classes_preds, num_classes_target=num_classes_target, mask=mask
    )
    homogeneity = torch.where(
        entropy_target != 0, mutual_info / torch.where(entropy_target != 0, entropy_target, 1.0), 1.0
    )
    return homogeneity, mutual_info, entropy_preds, entropy_target


def _completeness_score_compute(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """(completeness = MI / H(preds), homogeneity)."""
    homogeneity, mutual_info, entropy_preds, _ = _homogeneity_score_compute(
        preds, target, num_classes_preds, num_classes_target, mask
    )
    completeness = torch.where(
        entropy_preds != 0, mutual_info / torch.where(entropy_preds != 0, entropy_preds, 1.0), 1.0
    )
    return completeness, homogeneity


def homogeneity_score(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Homogeneity: each predicted cluster holds members of one class only.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import homogeneity_score
        >>> round(float(homogeneity_score(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))), 4)
        1.0
    """
    homogeneity, _, _, _ = _homogeneity_score_compute(preds, target, num_classes_preds, num_classes_target, mask)
    return homogeneity


def completeness_score(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Completeness: all members of a class land in one predicted cluster.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import completeness_score
        >>> round(float(completeness_score(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))), 4)
        0.6667
    """
    completeness, _ = _completeness_score_compute(preds, target, num_classes_preds, num_classes_target, mask)
    return completeness


def v_measure_score(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """V-measure: the beta-weighted harmonic mean of homogeneity and
    completeness (1.0 where both are 0).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import v_measure_score
        >>> round(float(v_measure_score(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))), 4)
        0.8
    """
    completeness, homogeneity = _completeness_score_compute(
        preds, target, num_classes_preds, num_classes_target, mask
    )
    total = beta * homogeneity + completeness
    safe_total = torch.where(total != 0, total, 1.0)
    return torch.where(
        homogeneity + completeness == 0.0,
        1.0,
        (1 + beta) * homogeneity * completeness / safe_total,
    )
