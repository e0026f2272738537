"""Signal distortion ratios (port of ``tpumetrics/functional/audio/sdr.py``).

SDR's optimal distortion filter comes from FFT auto- and cross-correlations
and a symmetric Toeplitz system, solved by LU with partial pivoting
(``torch.linalg.solve_ex``, as ``jnp.linalg.solve`` does). ``solve_ex``
leaves its error code on the device, so the update reads nothing on the
host. The system is solved in float32 with the JAX package's diagonal
loading, whatever the input dtype: the JAX package's default (no
``jax_enable_x64``) followed exactly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tpumetrics_torch.utils.checks import _check_same_shape
from tpumetrics_torch.utils.compute import _ieee_float32_matmul

Tensor = torch.Tensor


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """The symmetric Toeplitz matrix of a (batched) first row, by one gather."""
    length = vector.shape[-1]
    pos = torch.arange(length, device=vector.device)
    return vector[..., (pos[:, None] - pos[None, :]).abs()]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int) -> Tuple[Tensor, Tensor]:
    """FFT auto-correlation of ``target`` and its cross-correlation with
    ``preds``, the first ``corr_len`` lags, with the JAX package's FFT length
    ``2**ceil(log2(2T - 1))``."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """SDR of the BSS eval family: the coherence of ``preds`` with the best
    ``filter_length``-tap filtering of ``target``, per sample.

    The inputs are cast to float32 and the Toeplitz system is solved in
    float32 with ``load_diag`` (default 1e-6) added to its diagonal, as the
    JAX package does without ``jax_enable_x64``, also for float64 inputs.
    The float32 solve is ill-conditioned when ``filter_length`` exceeds the
    signal length; keep ``filter_length <= T``.

    Args:
        preds: float tensor of shape ``(..., time)``.
        target: float tensor of shape ``(..., time)``.
        use_cg_iter: unused, kept for the JAX package's signature.
        filter_length: length of the distortion filter.
        zero_mean: zero-mean both signals first.
        load_diag: diagonal loading of the Toeplitz system (1e-6 when None).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.audio import signal_distortion_ratio
        >>> g = torch.randn(8000, generator=torch.Generator().manual_seed(1))
        >>> preds = g + 0.1 * torch.randn(8000, generator=torch.Generator().manual_seed(2))
        >>> float(signal_distortion_ratio(preds, g)) > 15
        True
    """
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    # unit norm along time, to stabilise the solve
    target = target / torch.clamp(torch.linalg.vector_norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)

    if load_diag is None:
        load_diag = 1e-6  # float32 Toeplitz systems of unit-power signals need mild conditioning
    r_0 = torch.cat([r_0[..., :1] + load_diag, r_0[..., 1:]], dim=-1)

    r = _symmetric_toeplitz(r_0)
    with _ieee_float32_matmul():  # the LU's trailing updates in full float32, never TF32
        sol = torch.linalg.solve_ex(r, b[..., None]).result[..., 0]

    coh = torch.sum(b * sol, dim=-1)
    ratio = coh / (1 - coh)
    return 10.0 * torch.log10(ratio)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR (Le Roux et al. 2019): project ``preds`` onto ``target`` and
    compare the signal's power with the residual's, per sample, in float32.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 4)
        18.403
    """
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    eps = torch.finfo(torch.float32).eps

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (
        torch.sum(target**2, dim=-1, keepdim=True) + eps
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(val)


def source_aggregated_signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    scale_invariant: bool = True,
    zero_mean: bool = False,
) -> Tensor:
    """SA-SDR (Mehrish et al.): one SDR over all sources of a sample jointly,
    inputs ``(..., spk, time)``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.audio import source_aggregated_signal_distortion_ratio
        >>> g = torch.randn(2, 8000, generator=torch.Generator().manual_seed(1))
        >>> preds = g + 0.1 * torch.randn(2, 8000, generator=torch.Generator().manual_seed(2))
        >>> float(source_aggregated_signal_distortion_ratio(preds, g)) > 15
        True
    """
    _check_same_shape(preds, target)
    if preds.ndim < 2:
        raise RuntimeError(
            f"The preds and target should have the shape (..., spk, time), but {tuple(preds.shape)} found"
        )
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    eps = torch.finfo(torch.float32).eps

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    if scale_invariant:
        alpha = (torch.sum(preds * target, dim=-1, keepdim=True).sum(dim=-2, keepdim=True) + eps) / (
            torch.sum(target**2, dim=-1, keepdim=True).sum(dim=-2, keepdim=True) + eps
        )
        target = alpha * target

    distortion = target - preds
    val = (torch.sum(target**2, dim=(-2, -1)) + eps) / (torch.sum(distortion**2, dim=(-2, -1)) + eps)
    return 10 * torch.log10(val)
