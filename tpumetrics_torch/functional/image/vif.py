"""Pixel-based Visual Information Fidelity (port of ``tpumetrics/functional/image/vif.py``).

The JAX package maps its per-channel function over the channels; here each
scale's convolutions run once over every channel of every image as one
depthwise convolution (``groups=C``), and the per-channel sums are taken
over each channel's pixels. On an H100 that is several times faster than
folding the channels into the batch for a single-channel convolution
(cuDNN's implicit GEMM for the 17 x 17 window; ``scripts/time_image_convs.py``).
"""

from __future__ import annotations

import torch

from tpumetrics_torch.functional.image.helper import _depthwise_conv2d

Tensor = torch.Tensor


def _filter(win_size: int, sigma: float, dtype: torch.dtype = torch.float32, device=None) -> Tensor:
    """2D Gaussian window normalized to sum 1, built on ``device``."""
    coords = torch.arange(win_size, dtype=dtype, device=device) - (win_size - 1) / 2
    g = coords**2
    g = torch.exp(-(g[None, :] + g[:, None]) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _vif_per_channel(preds: Tensor, target: Tensor, sigma_n_sq: float) -> Tensor:
    """Four-scale VIF of each channel of ``(B, C, H, W)`` images: ``(B, C)``."""
    eps = 1e-10
    channels = preds.shape[1]
    preds_vif = torch.zeros(preds.shape[:2], dtype=preds.dtype, device=preds.device)
    target_vif = torch.zeros(preds.shape[:2], dtype=preds.dtype, device=preds.device)
    for scale in range(4):
        n = int(2.0 ** (4 - scale) + 1)
        kernel = _filter(n, n / 5, dtype=preds.dtype, device=preds.device).expand(channels, 1, n, n)

        if scale > 0:
            target = _depthwise_conv2d(target, kernel)[:, :, ::2, ::2]
            preds = _depthwise_conv2d(preds, kernel)[:, :, ::2, ::2]

        mu_target = _depthwise_conv2d(target, kernel)
        mu_preds = _depthwise_conv2d(preds, kernel)
        mu_target_sq = mu_target**2
        mu_preds_sq = mu_preds**2
        mu_target_preds = mu_target * mu_preds

        sigma_target_sq = torch.clamp(_depthwise_conv2d(target**2, kernel) - mu_target_sq, min=0.0)
        sigma_preds_sq = torch.clamp(_depthwise_conv2d(preds**2, kernel) - mu_preds_sq, min=0.0)
        sigma_target_preds = _depthwise_conv2d(target * preds, kernel) - mu_target_preds

        g = sigma_target_preds / (sigma_target_sq + eps)
        sigma_v_sq = sigma_preds_sq - g * sigma_target_preds

        mask = sigma_target_sq < eps
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        sigma_target_sq = torch.where(mask, 0.0, sigma_target_sq)

        mask = sigma_preds_sq < eps
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.where(mask, 0.0, sigma_v_sq)

        mask = g < 0
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.clamp(sigma_v_sq, min=eps)

        preds_vif_scale = torch.log10(1.0 + (g**2.0) * sigma_target_sq / (sigma_v_sq + sigma_n_sq))
        preds_vif = preds_vif + torch.sum(preds_vif_scale, dim=(2, 3))
        target_vif = target_vif + torch.sum(torch.log10(1.0 + sigma_target_sq / sigma_n_sq), dim=(2, 3))
    return preds_vif / target_vif


def visual_information_fidelity(preds: Tensor, target: Tensor, sigma_n_sq: float = 2.0) -> Tensor:
    """Pixel-based Visual Information Fidelity: the mean over images and
    channels of each one's four-scale VIF.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import visual_information_fidelity
        >>> g = torch.Generator().manual_seed(0)
        >>> preds, target = torch.rand(8, 3, 41, 41, generator=g), torch.rand(8, 3, 41, 41, generator=g)
        >>> float(visual_information_fidelity(preds, target)) > 0
        True
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    if preds.shape[-1] < 41 or preds.shape[-2] < 41:
        raise ValueError(
            f"Invalid size of preds. Expected at least 41x41, but got {preds.shape[-1]}x{preds.shape[-2]}!"
        )
    if target.shape[-1] < 41 or target.shape[-2] < 41:
        raise ValueError(
            f"Invalid size of target. Expected at least 41x41, but got {target.shape[-1]}x{target.shape[-2]}!"
        )
    return torch.mean(_vif_per_channel(preds, target, sigma_n_sq))
