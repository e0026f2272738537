"""Pairwise minkowski distance (port of ``tpumetrics/functional/pairwise/minkowski.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.pairwise.helpers import (
    _check_input,
    _reduce_distance_matrix,
    _rowwise_chunks,
    _zero_diagonal,
)
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

Tensor = torch.Tensor


def _pairwise_minkowski_distance_update(
    x: Tensor, y: Optional[Tensor] = None, exponent: float = 2, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """``(sum |x_i - y_j|^p)^(1/p)`` in float32, in row chunks of bounded
    scratch (the direct difference has no cancellation to hide)."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    if not (isinstance(exponent, (float, int)) and exponent >= 1):
        raise TPUMetricsUserError(
            f"Argument ``exponent`` must be a float or int greater than or equal to 1, but got {exponent}"
        )
    distance = _rowwise_chunks(
        x.to(torch.float32), y.to(torch.float32),
        lambda diff: torch.pow(torch.pow(diff.abs(), exponent).sum(dim=-1), 1.0 / exponent),
    )
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_minkowski_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    exponent: float = 2,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise minkowski (Lp) distance between rows.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.pairwise import pairwise_minkowski_distance
        >>> x = torch.tensor([[2., 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1., 0], [2, 1]])
        >>> pairwise_minkowski_distance(x, y, exponent=4).double().round(decimals=4).tolist()
        [[3.0092, 2.0], [5.0317, 4.0039], [8.1222, 7.0583]]
    """
    return _reduce_distance_matrix(_pairwise_minkowski_distance_update(x, y, exponent, zero_diagonal), reduction)
