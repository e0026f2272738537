"""RASE (port of ``tpumetrics/functional/image/rase.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from tpumetrics_torch.functional.image.helper import _uniform_filter
from tpumetrics_torch.functional.image.rmse_sw import _rmse_sw_compute, _rmse_sw_update

Tensor = torch.Tensor


def _rase_update(
    preds: Tensor, target: Tensor, window_size: int, rmse_map: Tensor, target_sum: Tensor, total_images: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Add a batch's RMSE map and locally averaged target (the target goes
    through the same uniform filter as the error, then over window_size²
    once more, as in the JAX package and the reference)."""
    _, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images
    )
    filtered = _uniform_filter(torch.as_tensor(target).to(torch.float32), window_size) / (window_size**2)
    target_sum = target_sum + filtered.sum(0)
    return rmse_map, target_sum, total_images


def _rase_compute(rmse_map: Tensor, target_sum: Tensor, total_images: Tensor, window_size: int) -> Tensor:
    """``100 / mean(target)`` times the RMS over bands of the RMSE map, border-cropped, averaged."""
    _, rmse_map = _rmse_sw_compute(rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images)
    target_mean = target_sum / total_images
    target_mean = target_mean.mean(0)  # the mean over the bands
    rase_map = 100 / target_mean * torch.sqrt(torch.mean(rmse_map**2, dim=0))
    crop_slide = round(window_size / 2)
    return torch.mean(rase_map[crop_slide:-crop_slide, crop_slide:-crop_slide])


def relative_average_spectral_error(preds: Tensor, target: Tensor, window_size: int = 8) -> Tensor:
    """Relative Average Spectral Error.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import relative_average_spectral_error
        >>> preds = torch.rand(4, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> float(relative_average_spectral_error(preds, target)) > 0
        True
    """
    if not (isinstance(window_size, int) and window_size >= 1):
        raise ValueError(f"Argument `window_size` is expected to be a positive integer. Got {window_size}")
    target = torch.as_tensor(target)
    img_shape = target.shape[1:]
    rmse_map = torch.zeros(img_shape, dtype=torch.float32, device=target.device)
    target_sum = torch.zeros(img_shape, dtype=torch.float32, device=target.device)
    total_images = torch.zeros((), dtype=torch.float32, device=target.device)
    rmse_map, target_sum, total_images = _rase_update(preds, target, window_size, rmse_map, target_sum, total_images)
    return _rase_compute(rmse_map, target_sum, total_images, window_size)
