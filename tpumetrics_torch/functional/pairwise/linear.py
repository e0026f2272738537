"""Pairwise linear similarity (port of ``tpumetrics/functional/pairwise/linear.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from tpumetrics_torch.utils.compute import _safe_matmul

Tensor = torch.Tensor


def _pairwise_linear_similarity_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """The inner products, one full-float32 product."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _zero_diagonal(_safe_matmul(x, y), zero_diagonal)


def pairwise_linear_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise linear similarity ``<x_i, y_j>`` between rows.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.pairwise import pairwise_linear_similarity
        >>> x = torch.tensor([[2., 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1., 0], [2, 1]])
        >>> pairwise_linear_similarity(x, y).tolist()
        [[2.0, 7.0], [3.0, 11.0], [5.0, 18.0]]
    """
    return _reduce_distance_matrix(_pairwise_linear_similarity_update(x, y, zero_diagonal), reduction)
