"""Calinski-Harabasz score (port of
``tpumetrics/functional/clustering/calinski_harabasz_score.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.clustering.utils import (
    _cluster_centroids,
    _validate_intrinsic_cluster_data,
    _validate_intrinsic_labels_to_samples,
    _zero_index_labels,
)

Tensor = torch.Tensor


def calinski_harabasz_score(
    data: Tensor, labels: Tensor, num_labels: Optional[int] = None, mask: Optional[Tensor] = None
) -> Tensor:
    """Variance-ratio criterion of a clustering of embedded data: both
    dispersions from one set of per-cluster sums, declared-but-empty
    clusters not counted. With ``num_labels`` the labels are taken as
    zero-indexed.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import calinski_harabasz_score
        >>> data = torch.tensor([[0., 0], [1.1, 0], [0, 1], [2, 2], [2.2, 2.1], [2, 2.2]])
        >>> labels = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> round(float(calinski_harabasz_score(data, labels)), 2)
        23.73
    """
    _validate_intrinsic_cluster_data(data, labels)
    labels, k = _zero_index_labels(labels, num_labels)
    w = torch.ones((data.shape[0],), dtype=data.dtype, device=data.device) if mask is None else mask.to(data.dtype)
    num_samples = data.shape[0] if mask is None else torch.sum(mask)
    _validate_intrinsic_labels_to_samples(k, num_samples)

    mean = torch.sum(data * w[:, None], dim=0) / torch.sum(w)
    centroids, counts = _cluster_centroids(data, labels, k, mask=mask)
    k_eff = torch.sum(counts > 0).to(data.dtype)
    between = torch.sum(counts * torch.sum((centroids - mean[None, :]) ** 2, dim=1))
    within = torch.sum(w[:, None] * (data - centroids[torch.clamp(labels, 0, k - 1)]) ** 2)
    safe_within = torch.where(within == 0, 1.0, within)
    safe_k = torch.clamp(k_eff, min=2.0)
    score = between * (num_samples - safe_k) / (safe_within * (safe_k - 1.0))
    return torch.where(within == 0, 1.0, score).to(torch.float32)
