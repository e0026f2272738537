"""Dunn index (port of ``tpumetrics/functional/clustering/dunn_index.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.clustering.utils import (
    _centroid_distances,
    _cluster_centroids,
    _mask_labels,
    _zero_index_labels,
)

Tensor = torch.Tensor


def _dunn_index_update(
    data: Tensor, labels: Tensor, p: float, num_labels: Optional[int] = None, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Centroid p-norm distances over the pairs ``i < j`` (row chunks) and
    each cluster's largest point-to-centroid distance (a max, so a
    ``scatter_reduce`` in any order gives the same result); empty clusters
    give +inf pair distances and -inf maxima."""
    labels, k = _zero_index_labels(labels, num_labels)
    centroids, counts = _cluster_centroids(data, labels, k, mask=mask)
    seg_labels = _mask_labels(labels, k, mask)

    valid_k = counts > 0
    inter = _centroid_distances(centroids, p)
    pair_valid = valid_k[:, None] & valid_k[None, :]
    inter = torch.where(pair_valid, inter, torch.inf)
    iu = torch.triu_indices(k, k, 1, device=data.device)
    intercluster_distance = inter[iu[0], iu[1]]

    point_dist = torch.sum(torch.abs(data - centroids[torch.clamp(labels, 0, k - 1)]) ** p, dim=-1) ** (1.0 / p)
    seg_max = torch.full((k + 1,), -torch.inf, dtype=point_dist.dtype, device=data.device)
    seg_max = seg_max.scatter_reduce(0, seg_labels, point_dist, reduce="amax", include_self=False)
    max_intracluster_distance = torch.where(valid_k, seg_max[:k], -torch.inf)
    return intercluster_distance, max_intracluster_distance


def _dunn_index_compute(intercluster_distance: Tensor, max_intracluster_distance: Tensor) -> Tensor:
    """Smallest inter-cluster distance over the largest intra-cluster one."""
    return intercluster_distance.min() / max_intracluster_distance.max()


def dunn_index(
    data: Tensor, labels: Tensor, p: float = 2, num_labels: Optional[int] = None, mask: Optional[Tensor] = None
) -> Tensor:
    """Dunn index of a clustering of embedded data.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import dunn_index
        >>> data = torch.tensor([[0., 0], [0.5, 0], [1, 0], [0.5, 1]])
        >>> labels = torch.tensor([0, 0, 0, 1])
        >>> float(dunn_index(data, labels))
        2.0
    """
    intercluster_distance, max_intracluster_distance = _dunn_index_update(data, labels, p, num_labels, mask)
    return _dunn_index_compute(intercluster_distance, max_intracluster_distance)
