"""Normalized mutual information (port of
``tpumetrics/functional/clustering/normalized_mutual_info_score.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.clustering.mutual_info_score import mutual_info_score
from tpumetrics_torch.functional.clustering.utils import (
    _validate_average_method_arg,
    calculate_entropy,
    calculate_generalized_mean,
    check_cluster_labels,
    pair_valid_mask,
)

Tensor = torch.Tensor


def _entropy_normalizer(
    preds: Tensor,
    target: Tensor,
    average_method: str,
    num_classes_preds: Optional[int],
    num_classes_target: Optional[int],
    mask: Optional[Tensor],
) -> Tensor:
    """Generalized mean of H(preds) and H(target) over the rows the
    contingency table keeps."""
    valid = pair_valid_mask(preds, target, num_classes_preds, num_classes_target, mask)
    entropies = torch.stack([
        calculate_entropy(preds, num_classes=num_classes_preds, mask=valid),
        calculate_entropy(target, num_classes=num_classes_target, mask=valid),
    ])
    return calculate_generalized_mean(entropies, average_method)


def normalized_mutual_info_score(
    preds: Tensor,
    target: Tensor,
    average_method: str = "arithmetic",
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """NMI = MI / generalized-mean(H(preds), H(target)); MI itself where it
    is within one float32 epsilon of 0.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import normalized_mutual_info_score
        >>> target = torch.tensor([0, 3, 2, 2, 1])
        >>> preds = torch.tensor([1, 3, 2, 0, 1])
        >>> round(float(normalized_mutual_info_score(preds, target, "arithmetic")), 4)
        0.7919
    """
    check_cluster_labels(preds, target)
    _validate_average_method_arg(average_method)
    mutual_info = mutual_info_score(
        preds, target, num_classes_preds=num_classes_preds, num_classes_target=num_classes_target, mask=mask
    )
    normalizer = _entropy_normalizer(preds, target, average_method, num_classes_preds, num_classes_target, mask)
    eps = torch.finfo(torch.float32).eps
    mi_is_zero = torch.abs(mutual_info) <= eps
    safe_normalizer = torch.where(normalizer != 0, normalizer, 1.0)
    return torch.where(mi_is_zero, mutual_info, mutual_info / safe_normalizer)
