"""RMSE over sliding windows (port of ``tpumetrics/functional/image/rmse_sw.py``)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from tpumetrics_torch.functional.image.helper import _uniform_filter
from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _rmse_sw_update(
    preds: Tensor,
    target: Tensor,
    window_size: int,
    rmse_val_sum: Optional[Tensor],
    rmse_map: Optional[Tensor],
    total_images: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor]:
    """Add a batch's windowed RMSE: the border-cropped mean summed over images,
    the RMSE map summed over images, and the image count (float32)."""
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. But got {tuple(preds.shape)}.")
    if round(window_size / 2) >= target.shape[2] or round(window_size / 2) >= target.shape[3]:
        raise ValueError(
            f"Parameter `round(window_size / 2)` is expected to be smaller than"
            f" {min(target.shape[2], target.shape[3])} but got {round(window_size / 2)}."
        )

    if total_images is None:
        total = torch.full((), float(target.shape[0]), dtype=torch.float32, device=target.device)
    else:
        total = total_images + target.shape[0]
    error = (target - preds) ** 2
    error = _uniform_filter(error, window_size)
    _rmse_map = torch.sqrt(error)
    crop_slide = round(window_size / 2)

    val = _rmse_map[:, :, crop_slide:-crop_slide, crop_slide:-crop_slide].sum(0).mean()
    rmse_val_sum = val if rmse_val_sum is None else rmse_val_sum + val
    batch_map = _rmse_map.sum(0)
    rmse_map = batch_map if rmse_map is None else rmse_map + batch_map
    return rmse_val_sum, rmse_map, total


def _rmse_sw_compute(
    rmse_val_sum: Optional[Tensor], rmse_map: Tensor, total_images: Tensor
) -> Tuple[Optional[Tensor], Tensor]:
    """The sums over the image count."""
    rmse = rmse_val_sum / total_images if rmse_val_sum is not None else None
    rmse_map = rmse_map / total_images
    return rmse, rmse_map


def root_mean_squared_error_using_sliding_window(
    preds: Tensor, target: Tensor, window_size: int = 8, return_rmse_map: bool = False
) -> Union[Optional[Tensor], Tuple[Optional[Tensor], Tensor]]:
    """RMSE over sliding windows, bordered as ``scipy.ndimage.uniform_filter``
    is; ``return_rmse_map=True`` also returns the per-window RMSE image.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import root_mean_squared_error_using_sliding_window
        >>> preds = torch.rand(4, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> float(root_mean_squared_error_using_sliding_window(preds, target)) > 0
        True
    """
    if not (isinstance(window_size, int) and window_size >= 1):
        raise ValueError(f"Argument `window_size` is expected to be a positive integer. Got {window_size}")
    rmse_val_sum, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=None, total_images=None
    )
    rmse, rmse_map = _rmse_sw_compute(rmse_val_sum, rmse_map, total_images)
    if return_rmse_map:
        return rmse, rmse_map
    return rmse
