"""Pairwise euclidean distance (port of ``tpumetrics/functional/pairwise/euclidean.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from tpumetrics_torch.utils.compute import _safe_matmul

Tensor = torch.Tensor


def _pairwise_euclidean_distance_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """``|a|^2 + |b|^2 - 2<a, b>`` in float32, on rows centred on ``x``'s
    mean (the distance does not change; the cancellation of the expansion
    shrinks with the norms), clamped at zero before the square root. The
    product is full float32."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    center = x.mean(dim=0, keepdim=True)
    xc = x - center
    yc = y - center
    x_norm = (xc * xc).sum(dim=1, keepdim=True)
    y_norm = (yc * yc).sum(dim=1)
    distance = x_norm + y_norm - 2 * _safe_matmul(xc, yc)
    distance = torch.sqrt(torch.clamp(distance, min=0.0))
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_euclidean_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise euclidean (L2) distance between rows.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.pairwise import pairwise_euclidean_distance
        >>> x = torch.tensor([[2., 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1., 0], [2, 1]])
        >>> pairwise_euclidean_distance(x, y).double().round(decimals=4).tolist()
        [[3.1623, 2.0], [5.3852, 4.1231], [8.9443, 7.6158]]
    """
    return _reduce_distance_matrix(_pairwise_euclidean_distance_update(x, y, zero_diagonal), reduction)
