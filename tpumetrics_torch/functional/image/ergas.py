"""ERGAS (port of ``tpumetrics/functional/image/ergas.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.image.helper import _reduce
from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _ergas_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Same dtype, same shape, ``BxCxHxW``."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _ergas_compute(
    preds: Tensor, target: Tensor, ratio: float = 4, reduction: Optional[str] = "elementwise_mean"
) -> Tensor:
    """``100 * ratio`` times the root mean square over bands of each band's RMSE over its mean."""
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)

    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target, dim=2)

    ergas_score = 100 * ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return _reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: Tensor, target: Tensor, ratio: float = 4, reduction: Optional[str] = "elementwise_mean"
) -> Tensor:
    """Erreur Relative Globale Adimensionnelle de Synthèse.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import error_relative_global_dimensionless_synthesis
        >>> preds = torch.rand(16, 1, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> bool(150.0 < float(error_relative_global_dimensionless_synthesis(preds, target)) < 160.0)
        True
    """
    preds, target = _ergas_update(preds, target)
    return _ergas_compute(preds, target, ratio, reduction)
