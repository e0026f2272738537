"""Shared image-metric helpers (port of ``tpumetrics/functional/image/helper.py``):
Gaussian and uniform windows, reflection padding, depthwise convolutions.

The windows are built on the metric's device with torch ops from
``kernel_size`` and ``sigma`` on every call, as the JAX package builds them:
nothing is copied from the host, so an update that builds one can be
captured in a CUDA graph. Every convolution runs in full float32
(``_ieee_float32``), never TF32, whatever ``torch.backends.cudnn.allow_tf32``
says: the moment maps (``E[x²] - mu²``) cancel, and TF32's 10-bit mantissa
would leave nothing of a small variance.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from tpumetrics_torch.utils.compute import _ieee_float32

Tensor = torch.Tensor


def _gaussian(
    kernel_size: int, sigma: float, dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None
) -> Tensor:
    """1D Gaussian window ``(1, kernel_size)``, normalized to sum 1."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-torch.pow(dist / sigma, 2) / 2)
    return (gauss / gauss.sum())[None, :]


def _gaussian_kernel_2d(
    channel: int,
    kernel_size: Sequence[int],
    sigma: Sequence[float],
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Tensor:
    """``(C, 1, kh, kw)`` separable Gaussian window (the outer product of two 1D ones)."""
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype, device)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kernel = kernel_x.T * kernel_y  # an outer product: one rounding per tap, as the JAX matmul's
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1])


def _gaussian_kernel_3d(
    channel: int,
    kernel_size: Sequence[int],
    sigma: Sequence[float],
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Tensor:
    """``(C, 1, kd, kh, kw)`` separable Gaussian window."""
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype, device)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kernel_z = _gaussian(kernel_size[2], sigma[2], dtype, device)
    kernel_xy = kernel_x.T * kernel_y
    kernel = kernel_xy[:, :, None] * kernel_z.reshape(1, 1, -1)
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1], kernel_size[2])


def _depthwise_conv2d(x: Tensor, kernel: Tensor) -> Tensor:
    """Valid-mode depthwise correlation: x ``(B, C, H, W)``, kernel ``(C, 1, kh, kw)``."""
    with _ieee_float32(torch.backends.cudnn.conv, torch.backends.mkldnn.conv):
        return F.conv2d(x, kernel.to(x.dtype).contiguous(), groups=x.shape[1])


def _depthwise_conv3d(x: Tensor, kernel: Tensor) -> Tensor:
    """Valid-mode depthwise correlation: x ``(B, C, D, H, W)``, kernel ``(C, 1, kd, kh, kw)``."""
    with _ieee_float32(torch.backends.cudnn.conv, torch.backends.mkldnn.conv):
        return F.conv3d(x, kernel.to(x.dtype).contiguous(), groups=x.shape[1])


def _reflect_pad_2d(x: Tensor, pad_h: int, pad_w: int) -> Tensor:
    """Reflection padding of the two trailing dims (the edge row is not repeated)."""
    return F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")


def _reflect_pad_3d(x: Tensor, pad_d: int, pad_h: int, pad_w: int) -> Tensor:
    return F.pad(x, (pad_w, pad_w, pad_h, pad_h, pad_d, pad_d), mode="reflect")


def _single_dimension_pad(x: Tensor, dim: int, pad: int, outer_pad: int = 0) -> Tensor:
    """scipy's asymmetric border over one dim: ``pad`` mirrored rows before
    (the edge row repeated), ``pad + outer_pad - 1`` after, as
    ``scipy.ndimage.uniform_filter`` pads. Flipped slices, no index tensor."""
    size = x.shape[dim]
    before = torch.flip(x.narrow(dim, 0, pad), (dim,))
    n_after = pad + outer_pad - 1
    after = torch.flip(x.narrow(dim, size - n_after, n_after), (dim,))
    return torch.cat((before, x, after), dim=dim)


def _uniform_filter(x: Tensor, window_size: int) -> Tensor:
    """Mean filter matching ``scipy.ndimage.uniform_filter``: one depthwise
    correlation over all channels after scipy's border."""
    for dim in (2, 3):
        x = _single_dimension_pad(x, dim, window_size // 2, window_size % 2)
    channels = x.shape[1]
    kernel = torch.ones((channels, 1, window_size, window_size), dtype=x.dtype, device=x.device) / (window_size**2)
    return _depthwise_conv2d(x, kernel)


def _reduce(x: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """``elementwise_mean``, ``sum`` or ``none``/None."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction is None or reduction == "none":
        return x
    raise ValueError("Expected reduction to be one of `['elementwise_mean', 'sum', 'none', None]`")
