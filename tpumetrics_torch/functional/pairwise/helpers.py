"""Shared helpers of the pairwise functions (port of
``tpumetrics/functional/pairwise/helpers.py``)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor

# the most bytes of ``(rows, M, D)`` float32 difference one chunk of rows may hold
_DIFF_BUDGET_BYTES = 1 << 30


def _rowwise_chunks(x: Tensor, y: Tensor, per_chunk: Callable[[Tensor], Tensor]) -> Tensor:
    """``(N, M)`` results of ``per_chunk(diff)``, where ``diff`` is the
    ``(rows, M, D)`` difference ``x[lo:lo + rows, None] - y[None]``: rows at a
    time, so that no difference holds more than ``_DIFF_BUDGET_BYTES``."""
    n, d = x.shape
    m = y.shape[0]
    rows = max(1, _DIFF_BUDGET_BYTES // max(1, m * d * 4))
    out = [per_chunk(x[lo : lo + rows, None, :] - y[None, :, :]) for lo in range(0, n, rows)]
    return torch.cat(out) if out else x.new_zeros((0, m))


def _check_input(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tuple[Tensor, Tensor, bool]:
    """Validate shapes and resolve the ``zero_diagonal`` default: ``True``
    for the self case (``y is None``), else ``False``."""
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _zero_diagonal(distance: Tensor, zero_diagonal: bool) -> Tensor:
    """``distance`` with its diagonal set to zero, through a mask (a new
    tensor; nothing is changed in place)."""
    if not zero_diagonal:
        return distance
    n, m = distance.shape
    eye = torch.eye(n, m, dtype=torch.bool, device=distance.device)
    return torch.where(eye, torch.zeros((), dtype=distance.dtype, device=distance.device), distance)


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    """Row-wise mean, sum or no reduction of an ``[N, M]`` distance matrix."""
    if reduction == "mean":
        return distmat.mean(dim=-1)
    if reduction == "sum":
        return distmat.sum(dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")
