"""Spearman rank correlation (port of ``tpumetrics/functional/regression/spearman.py``).

Tied values get the average of their ordinal ranks. The JAX package sums
each tie group's ranks with a float32 ``segment_sum``, which rounds once a
group's rank sum passes 2^24 (a rating scale of ten values over two million
ratings puts some 2e11 in one group), and a float ``index_add_`` on a card
would add in atomic order. Here the average comes in closed form from the
run boundaries of the sorted data, ``(first + last) / 2 + 1`` (0-based
positions), with no sum and no atomics: exact in float32 for ranks up to
2^23, and equal to the JAX ranks bit for bit wherever the JAX sums are exact.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpumetrics_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _run_bounds(sorted_data: Tensor) -> Tuple[Tensor, Tensor]:
    """For each position of 1-D sorted data, the first and the last position
    of its run of equal values, by binary search of the data in itself (a
    parallel search: no scan, no atomics). NaNs, sorted last, are each their
    own run, as ``!=`` makes them; they are searched as +inf, so the search
    stays monotone, and the runs are cut at the first NaN."""
    n = sorted_data.shape[0]
    idx = torch.arange(n, device=sorted_data.device)
    keys = sorted_data
    if sorted_data.is_floating_point():
        nan = torch.isnan(sorted_data)
        keys = torch.where(nan, torch.inf, sorted_data)
        n_valid = n - nan.sum()
    first = torch.searchsorted(keys, keys, side="left")
    last = torch.searchsorted(keys, keys, side="right") - 1
    if sorted_data.is_floating_point():
        first = torch.where(nan, idx, first)
        last = torch.where(nan, idx, torch.minimum(last, n_valid - 1))
    return first, last


def _rank_data(data: Tensor) -> Tensor:
    """Average-tie ranks (1-based, float32) of 1-D data, in O(n log n)."""
    n = data.shape[0]
    if n == 0:
        return torch.zeros(0, device=data.device)
    order = torch.argsort(data, stable=True)
    first, last = _run_bounds(data[order])
    avg_rank_sorted = (first + last).to(torch.float32) / 2 + 1
    return torch.empty(n, device=data.device).scatter_(0, order, avg_rank_sorted)


def _spearman_corrcoef_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    if not (preds.is_floating_point() and target.is_floating_point()):
        raise ValueError(
            "Expected `preds` and `target` both to be floating point tensors, but got"
            f" {preds.dtype} and {target.dtype}"
        )
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    return preds, target


def _rank_columns(x: Tensor) -> Tensor:
    if x.ndim == 1:
        return _rank_data(x)
    return torch.stack([_rank_data(x[:, i]) for i in range(x.shape[1])], dim=1)


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    """Rank each column, then the Pearson correlation of the ranks."""
    preds = _rank_columns(preds)
    target = _rank_columns(target)
    preds_diff = preds - preds.mean(dim=0)
    target_diff = target - target.mean(dim=0)
    cov = (preds_diff * target_diff).mean(dim=0)
    preds_std = torch.sqrt((preds_diff * preds_diff).mean(dim=0))
    target_std = torch.sqrt((target_diff * target_diff).mean(dim=0))
    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman rank correlation.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import spearman_corrcoef
        >>> round(float(spearman_corrcoef(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))), 4)
        1.0
    """
    preds, target = _spearman_corrcoef_update(preds, target, num_outputs=1 if preds.ndim == 1 else preds.shape[1])
    return _spearman_corrcoef_compute(preds, target)
