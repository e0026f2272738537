"""Davies-Bouldin score (port of
``tpumetrics/functional/clustering/davies_bouldin_score.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.clustering.utils import (
    _centroid_distances,
    _cluster_centroids,
    _mask_labels,
    _segment_sum,
    _validate_intrinsic_cluster_data,
    _validate_intrinsic_labels_to_samples,
    _zero_index_labels,
)

Tensor = torch.Tensor


def davies_bouldin_score(
    data: Tensor, labels: Tensor, num_labels: Optional[int] = None, mask: Optional[Tensor] = None
) -> Tensor:
    """Mean over clusters of the worst ratio of within-cluster to
    between-centroid distances. Intra-cluster means are a float64 one-hot
    product, centroid distances are taken in row chunks; empty clusters
    (phantom centroids at the origin) are masked out of both.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import davies_bouldin_score
        >>> data = torch.tensor([[0., 0], [1.1, 0], [0, 1], [2, 2], [2.2, 2.1], [2, 2.2]])
        >>> labels = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> round(float(davies_bouldin_score(data, labels)), 4)
        0.3311
    """
    _validate_intrinsic_cluster_data(data, labels)
    labels, k = _zero_index_labels(labels, num_labels)
    num_samples = data.shape[0] if mask is None else torch.sum(mask)
    _validate_intrinsic_labels_to_samples(k, num_samples)

    centroids, counts = _cluster_centroids(data, labels, k, mask=mask)
    seg_labels = _mask_labels(labels, k, mask)
    dists = torch.linalg.vector_norm(data - centroids[torch.clamp(labels, 0, k - 1)], dim=1)
    safe_counts = torch.where(counts > 0, counts, 1.0)
    intra = _segment_sum(dists, seg_labels, k).to(counts.dtype) / safe_counts

    valid_k = counts > 0
    k_eff = torch.sum(valid_k).to(torch.float32)
    pair_valid = valid_k[:, None] & valid_k[None, :]
    centroid_distances = _centroid_distances(centroids, p=2)

    degenerate = torch.all(torch.where(valid_k, torch.isclose(intra, torch.zeros_like(intra)), True)) | torch.all(
        torch.where(pair_valid, torch.isclose(centroid_distances, torch.zeros_like(centroid_distances)), True)
    )
    centroid_distances = torch.where(pair_valid & (centroid_distances != 0), centroid_distances, torch.inf)
    combined = intra[None, :] + intra[:, None]
    scores = torch.max(combined / centroid_distances, dim=1).values
    mean_score = torch.sum(torch.where(valid_k, scores, 0.0)) / torch.clamp(k_eff, min=1.0)
    return torch.where(degenerate, 0.0, mean_score).to(torch.float32)
