"""PSNR-B, PSNR with the blocked effect (port of ``tpumetrics/functional/image/psnrb.py``)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _compute_bef(x: Tensor, block_size: int = 8) -> Tensor:
    """Blocked-effect factor of a grayscale batch: the mean squared
    difference across block boundaries against the one inside blocks,
    log-weighted when the boundaries' dominate.

    The boundary columns (rows) are those whose index is ``block_size - 1``
    modulo ``block_size``; they are picked by a mask made on the device from
    ``arange``, so no index list is copied from the host.
    """
    _, channels, height, width = x.shape
    if channels > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {channels} channels.")

    h_sq = (x[:, :, :, :-1] - x[:, :, :, 1:]) ** 2  # (B, 1, H, W - 1): the difference right of each column
    v_sq = (x[:, :, :-1, :] - x[:, :, 1:, :]) ** 2  # (B, 1, H - 1, W): the difference below each row
    h_on = torch.arange(width - 1, device=x.device) % block_size == block_size - 1
    v_on = (torch.arange(height - 1, device=x.device) % block_size == block_size - 1)[:, None]

    d_b = torch.sum(torch.where(h_on, h_sq, 0.0))
    d_bc = torch.sum(torch.where(h_on, 0.0, h_sq))
    d_b = d_b + torch.sum(torch.where(v_on, v_sq, 0.0))
    d_bc = d_bc + torch.sum(torch.where(v_on, 0.0, v_sq))

    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t_const = math.log2(block_size) / math.log2(min(height, width))
    t = torch.where(d_b > d_bc, t_const, 0.0)
    return t * (d_b - d_bc)


def _psnrb_update(preds: Tensor, target: Tensor, block_size: int = 8) -> Tuple[Tensor, Tensor, Tensor]:
    """Squared-error sum, blocked-effect factor of ``preds``, observation count."""
    _check_same_shape(preds, target)
    sum_squared_error = torch.sum(torch.pow(preds - target, 2))
    bef = _compute_bef(preds, block_size=block_size)
    num_obs = torch.full((), float(target.numel()), dtype=torch.float32, device=target.device)
    return sum_squared_error, bef, num_obs


def _psnrb_compute(sum_squared_error: Tensor, bef: Tensor, num_obs: Tensor, data_range: Tensor) -> Tensor:
    """PSNR with the blocked-effect factor added to the noise."""
    mse = sum_squared_error / num_obs + bef
    return torch.where(
        data_range > 2,
        10 * torch.log10(data_range**2 / mse),
        10 * torch.log10(1.0 / mse),
    )


def peak_signal_noise_ratio_with_blocked_effect(preds: Tensor, target: Tensor, block_size: int = 8) -> Tensor:
    """PSNR with a DCT-blockiness penalty, for grayscale images.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import peak_signal_noise_ratio_with_blocked_effect
        >>> g = torch.Generator().manual_seed(0)
        >>> preds, target = torch.rand(1, 1, 16, 16, generator=g), torch.rand(1, 1, 16, 16, generator=g)
        >>> float(peak_signal_noise_ratio_with_blocked_effect(preds, target)) > 0
        True
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    data_range = target.max() - target.min()
    sum_squared_error, bef, num_obs = _psnrb_update(preds, target, block_size=block_size)
    return _psnrb_compute(sum_squared_error, bef, num_obs, data_range)
