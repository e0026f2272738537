"""Pearson correlation coefficient (port of
``tpumetrics/functional/regression/pearson.py``).

The update keeps streaming moments (means, sums of squared deviations and
of co-deviations, the count); ``_final_aggregation`` merges per-rank
moments with the Chan et al. parallel formulas, folding the ranks one by
one in rank order, as the JAX package's ``lax.scan`` does.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from tpumetrics_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from tpumetrics_torch.utils.checks import _check_same_shape
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    num_prior: Tensor,
    num_outputs: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Streaming update of the moments, free of branches on the data (the
    first batch folds into the same formulas because the priors start at
    zero), so it reads nothing on the host."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    num_obs = preds.shape[0]

    mx_new = (num_prior * mean_x + preds.sum(dim=0)) / (num_prior + num_obs)
    my_new = (num_prior * mean_y + target.sum(dim=0)) / (num_prior + num_obs)
    num_prior = num_prior + num_obs
    var_x = var_x + ((preds - mx_new) * (preds - mean_x)).sum(dim=0)
    var_y = var_y + ((target - my_new) * (target - mean_y)).sum(dim=0)
    corr_xy = corr_xy + ((preds - mx_new) * (target - mean_y)).sum(dim=0)
    return mx_new, my_new, var_x, var_y, corr_xy, num_prior


def _final_aggregation(
    means_x: Tensor,
    means_y: Tensor,
    vars_x: Tensor,
    vars_y: Tensor,
    corrs_xy: Tensor,
    nbs: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Merge rank-stacked moments (dim 0 is the rank), rank 0 first."""
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb

        element_x1 = (n1 + 1) * mean_x - n1 * mx1
        vx1 = vx1 + (element_x1 - mx1) * (element_x1 - mean_x) - (element_x1 - mean_x) ** 2
        element_x2 = (n2 + 1) * mean_x - n2 * mx2
        vx2 = vx2 + (element_x2 - mx2) * (element_x2 - mean_x) - (element_x2 - mean_x) ** 2
        var_x = vx1 + vx2

        element_y1 = (n1 + 1) * mean_y - n1 * my1
        vy1 = vy1 + (element_y1 - my1) * (element_y1 - mean_y) - (element_y1 - mean_y) ** 2
        element_y2 = (n2 + 1) * mean_y - n2 * my2
        vy2 = vy2 + (element_y2 - my2) * (element_y2 - mean_y) - (element_y2 - mean_y) ** 2
        var_y = vy1 + vy2

        cxy1 = cxy1 + (element_x1 - mx1) * (element_y1 - mean_y) - (element_x1 - mean_x) * (element_y1 - mean_y)
        cxy2 = cxy2 + (element_x2 - mx2) * (element_y2 - mean_y) - (element_x2 - mean_x) * (element_y2 - mean_y)
        corr_xy = cxy1 + cxy2

        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return mx1, my1, vx1, vy1, cxy1, n1


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    """The correlation from accumulated moments, clipped to [-1, 1]; warns
    (a host read) when a variance is close to zero."""
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)

    bound = math.sqrt(torch.finfo(var_x.dtype).eps)
    if bool(torch.any(var_x < bound)) or bool(torch.any(var_y < bound)):
        rank_zero_warn(
            "The variance of predictions or target is close to zero. This can cause instability in Pearson"
            " correlation coefficient, leading to wrong results. Consider re-scaling the input if possible or"
            f" computing using a larger dtype (currently using {var_x.dtype}).",
            UserWarning,
        )
    corrcoef = (corr_xy / torch.sqrt(var_x * var_y)).squeeze()
    return torch.clamp(corrcoef, -1.0, 1.0)


def _zero_moments(preds: Tensor) -> Tuple[Tensor, ...]:
    d = preds.shape[1] if preds.ndim == 2 else 1
    return tuple(torch.zeros(d, dtype=preds.dtype, device=preds.device) for _ in range(6))


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import pearson_corrcoef
        >>> round(float(pearson_corrcoef(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))), 4)
        0.9849
    """
    d = preds.shape[1] if preds.ndim == 2 else 1
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, *_zero_moments(preds), num_outputs=d)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
