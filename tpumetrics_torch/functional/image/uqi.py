"""Universal Image Quality Index (port of ``tpumetrics/functional/image/uqi.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tpumetrics_torch.functional.image.helper import (
    _depthwise_conv2d,
    _gaussian_kernel_2d,
    _reduce,
    _reflect_pad_2d,
)
from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _uqi_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
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


def _uqi_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """UQI from the five Gaussian-weighted moments of one depthwise
    convolution over the 5-stacked batch, as SSIM takes them."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    channel = preds.shape[1]
    kernel = _gaussian_kernel_2d(channel, kernel_size, sigma, preds.dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2

    preds = _reflect_pad_2d(preds, pad_h, pad_w)
    target = _reflect_pad_2d(target, pad_h, pad_w)

    outputs = _depthwise_conv2d(torch.cat((preds, target, preds * preds, target * target, preds * target)), kernel)
    mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = outputs.split(preds.shape[0])

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pred_sq - mu_pred_sq
    sigma_target_sq = e_target_sq - mu_target_sq
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq + torch.finfo(sigma_pred_sq.dtype).eps

    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower)
    uqi_idx = uqi_idx[..., pad_h:-pad_h, pad_w:-pad_w]
    return _reduce(uqi_idx, reduction)


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Universal Image Quality Index.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import universal_image_quality_index
        >>> preds = torch.rand(16, 1, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> round(float(universal_image_quality_index(preds, target)), 2)
        0.92
    """
    preds, target = _uqi_update(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction)
