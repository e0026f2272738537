"""Signal-to-noise ratios (port of ``tpumetrics/functional/audio/snr.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SNR = 10 log10(P_target / P_noise) per sample, in float32.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.audio import signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(signal_noise_ratio(preds, target)), 3)
        16.18
    """
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    eps = torch.finfo(torch.float32).eps

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR: SI-SDR of zero-mean inputs.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_noise_ratio(preds, target)), 4)
        15.0918
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)


def complex_scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """C-SI-SNR over complex spectrograms ``(..., freq, time)``, or real ones
    with the real and imaginary parts stacked last, ``(..., freq, time, 2)``.
    The shape check reads nothing on the host.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.audio import complex_scale_invariant_signal_noise_ratio
        >>> g = torch.randn(1, 257, 100, 2, generator=torch.Generator().manual_seed(1))
        >>> preds = g + 0.05 * torch.randn(1, 257, 100, 2, generator=torch.Generator().manual_seed(2))
        >>> float(complex_scale_invariant_signal_noise_ratio(preds, g)[0]) > 20
        True
    """
    if torch.is_complex(preds):
        preds = torch.view_as_real(preds)
    if torch.is_complex(target):
        target = torch.view_as_real(target)

    if (preds.ndim < 3 or preds.shape[-1] != 2) or (target.ndim < 3 or target.shape[-1] != 2):
        raise RuntimeError(
            "Predictions and targets are expected to have the shape (..., frequency, time, 2),"
            f" but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )

    preds = preds.reshape(*preds.shape[:-3], -1)
    target = target.reshape(*target.shape[:-3], -1)
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=zero_mean)
