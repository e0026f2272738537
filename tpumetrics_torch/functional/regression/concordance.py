"""Concordance correlation coefficient (port of
``tpumetrics/functional/regression/concordance.py``), built on Pearson's
moment states."""

from __future__ import annotations

import torch

from tpumetrics_torch.functional.regression.pearson import (
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
    _zero_moments,
)

Tensor = torch.Tensor


def _concordance_corrcoef_compute(
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    nb: Tensor,
) -> Tensor:
    pearson = _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    return 2.0 * pearson * torch.sqrt(var_x) * torch.sqrt(var_y) / (var_x + var_y + (mean_x - mean_y) ** 2)


def concordance_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Concordance correlation coefficient.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import concordance_corrcoef
        >>> round(float(concordance_corrcoef(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))), 4)
        0.9777
    """
    d = preds.shape[1] if preds.ndim == 2 else 1
    moments = _pearson_corrcoef_update(preds, target, *_zero_moments(preds), num_outputs=d)
    return _concordance_corrcoef_compute(*moments).squeeze()
