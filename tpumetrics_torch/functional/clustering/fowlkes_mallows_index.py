"""Fowlkes-Mallows index (port of
``tpumetrics/functional/clustering/fowlkes_mallows_index.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.clustering.utils import calculate_contingency_matrix, check_cluster_labels

Tensor = torch.Tensor


def _fowlkes_mallows_index_update(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The contingency table and its sample count (the rows the table kept:
    dropped and masked rows do not count)."""
    check_cluster_labels(preds, target)
    contingency = calculate_contingency_matrix(
        preds, target, num_classes_preds=num_classes_preds, num_classes_target=num_classes_target, mask=mask
    )
    return contingency, torch.sum(contingency)


def _fowlkes_mallows_index_compute(contingency: Tensor, n: Tensor) -> Tensor:
    """sqrt(TP / (TP + FP)) * sqrt(TP / (TP + FN)) in pair counts; 0.0 where
    TP is close to 0."""
    contingency = contingency.to(torch.float32)
    tk = torch.sum(contingency**2) - n
    pk = torch.sum(contingency.sum(dim=0) ** 2) - n
    qk = torch.sum(contingency.sum(dim=1) ** 2) - n
    safe_pk = torch.where(pk == 0, 1.0, pk)
    safe_qk = torch.where(qk == 0, 1.0, qk)
    score = torch.sqrt(torch.clamp(tk / safe_pk, min=0.0)) * torch.sqrt(torch.clamp(tk / safe_qk, min=0.0))
    return torch.where(torch.isclose(tk, torch.zeros_like(tk)), 0.0, score)


def fowlkes_mallows_index(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Fowlkes-Mallows index between two clusterings.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import fowlkes_mallows_index
        >>> preds = torch.tensor([2, 2, 0, 1, 0])
        >>> target = torch.tensor([2, 2, 1, 1, 0])
        >>> round(float(fowlkes_mallows_index(preds, target)), 4)
        0.5
    """
    contingency, n = _fowlkes_mallows_index_update(preds, target, num_classes_preds, num_classes_target, mask)
    return _fowlkes_mallows_index_compute(contingency, n)
