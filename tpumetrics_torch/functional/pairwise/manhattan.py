"""Pairwise manhattan distance (port of ``tpumetrics/functional/pairwise/manhattan.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.pairwise.helpers import (
    _check_input,
    _reduce_distance_matrix,
    _rowwise_chunks,
    _zero_diagonal,
)

Tensor = torch.Tensor

def _pairwise_manhattan_distance_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """``sum |x_i - y_j|`` over the features, in row chunks of bounded scratch."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distance = _rowwise_chunks(x.to(torch.float32), y.to(torch.float32), lambda diff: diff.abs().sum(dim=-1))
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_manhattan_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise manhattan (L1) distance between rows.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.pairwise import pairwise_manhattan_distance
        >>> x = torch.tensor([[2., 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1., 0], [2, 1]])
        >>> pairwise_manhattan_distance(x, y).tolist()
        [[4.0, 2.0], [7.0, 5.0], [12.0, 10.0]]
    """
    return _reduce_distance_matrix(_pairwise_manhattan_distance_update(x, y, zero_diagonal), reduction)
