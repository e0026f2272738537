"""Pairwise cosine similarity (port of ``tpumetrics/functional/pairwise/cosine.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from tpumetrics_torch.utils.compute import _safe_matmul

Tensor = torch.Tensor


def _pairwise_cosine_similarity_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Rows divided by their norms, then one full-float32 product."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    y = y / torch.linalg.norm(y, dim=1, keepdim=True)
    return _zero_diagonal(_safe_matmul(x, y), zero_diagonal)


def pairwise_cosine_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise cosine similarity between the rows of ``x`` and ``y`` (or of
    ``x`` with itself when ``y`` is omitted).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.pairwise import pairwise_cosine_similarity
        >>> x = torch.tensor([[2., 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1., 0], [2, 1]])
        >>> pairwise_cosine_similarity(x, y).double().round(decimals=4).tolist()
        [[0.5547, 0.8682], [0.5145, 0.8437], [0.53, 0.8533]]
    """
    return _reduce_distance_matrix(_pairwise_cosine_similarity_update(x, y, zero_diagonal), reduction)
