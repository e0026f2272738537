"""SSIM and MS-SSIM (port of ``tpumetrics/functional/image/ssim.py``).

The five moment maps (mu_p, mu_t, E[p²], E[t²], E[pt]) come from one
depthwise convolution over the 5-stacked batch, in full float32. MS-SSIM's
pyramid halves each scale with ``avg_pool2d`` / ``avg_pool3d`` (kernel 2,
stride 2), the JAX package's window sum over 2^d. A ``data_range`` of None
is the larger of the two inputs' ranges, kept on the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tpumetrics_torch.functional.image.helper import (
    _depthwise_conv2d,
    _depthwise_conv3d,
    _gaussian_kernel_2d,
    _gaussian_kernel_3d,
    _reduce,
    _reflect_pad_2d,
    _reflect_pad_3d,
)
from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _ssim_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """``target`` in ``preds``' dtype; same shape, ``BxCxHxW`` or ``BxCxDxHxW``."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target).to(preds.dtype)
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _data_range(
    preds: Tensor, target: Tensor, data_range: Optional[Union[float, Tuple[float, float]]]
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(preds, target, range)``: the inputs clamped to a tuple range, and the
    range as a 0-d tensor on their device (the larger input range for None)."""
    if data_range is None:
        return preds, target, torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    if isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = data_range[1] - data_range[0]
    return preds, target, torch.full((), data_range, dtype=preds.dtype, device=preds.device)


def _ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Per-image SSIM ``(B,)``, with the full SSIM map or the per-image
    contrast sensitivity when asked.

    A 3-D input is padded and cropped as the JAX package (and the reference)
    does: H padded by the W border and W by the H one, and the map cropped by
    the H border in D, the W border in H and the D border in W. With equal
    sigmas none of that shows; with unequal ones a crop can come out empty,
    and the score is then NaN, as there.
    """
    is_3d = preds.ndim == 5

    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]

    if len(kernel_size) != preds.ndim - 2 or len(kernel_size) not in (2, 3):
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less that target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if len(sigma) != preds.ndim - 2 or len(sigma) not in (2, 3):
        raise ValueError(
            f"`sigma` has dimension {len(sigma)}, but expected to be two less that target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if return_full_image and return_contrast_sensitivity:
        raise ValueError("Arguments `return_full_image` and `return_contrast_sensitivity` are mutually exclusive.")
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    preds, target, data_range_t = _data_range(preds, target, data_range)
    c1 = (k1 * data_range_t) ** 2
    c2 = (k2 * data_range_t) ** 2

    channel = preds.shape[1]
    dtype, device = preds.dtype, preds.device
    # the Gaussian support follows sigma and sets the border cropped off
    gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
    pad_h = (gauss_kernel_size[0] - 1) // 2
    pad_w = (gauss_kernel_size[1] - 1) // 2

    if is_3d:
        pad_d = (gauss_kernel_size[2] - 1) // 2
        preds = _reflect_pad_3d(preds, pad_d, pad_w, pad_h)
        target = _reflect_pad_3d(target, pad_d, pad_w, pad_h)
        if gaussian_kernel:
            kernel = _gaussian_kernel_3d(channel, gauss_kernel_size, sigma, dtype, device)
        conv = _depthwise_conv3d
    else:
        preds = _reflect_pad_2d(preds, pad_h, pad_w)
        target = _reflect_pad_2d(target, pad_h, pad_w)
        if gaussian_kernel:
            kernel = _gaussian_kernel_2d(channel, gauss_kernel_size, sigma, dtype, device)
        conv = _depthwise_conv2d
    if not gaussian_kernel:
        numel = 1
        for k in kernel_size:
            numel *= k
        kernel = torch.ones((channel, 1, *kernel_size), dtype=dtype, device=device) / numel

    # one convolution over the 5-stacked moment inputs
    outputs = conv(torch.cat((preds, target, preds * preds, target * target, preds * target)), kernel)
    b = preds.shape[0]
    mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = outputs.split(b)

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pred_sq - mu_pred_sq
    sigma_target_sq = e_target_sq - mu_target_sq
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2

    ssim_idx_full_image = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    def crop(x: Tensor) -> Tensor:
        if is_3d:
            return x[..., pad_h:-pad_h, pad_w:-pad_w, pad_d:-pad_d]
        return x[..., pad_h:-pad_h, pad_w:-pad_w]

    ssim_idx = crop(ssim_idx_full_image)
    if return_contrast_sensitivity:
        contrast_sensitivity = crop(upper / lower)
        return ssim_idx.reshape(b, -1).mean(-1), contrast_sensitivity.reshape(b, -1).mean(-1)
    if return_full_image:
        return ssim_idx.reshape(b, -1).mean(-1), ssim_idx_full_image
    return ssim_idx.reshape(b, -1).mean(-1)


def _ssim_compute(similarities: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    return _reduce(similarities, reduction)


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Structural Similarity Index Measure.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import structural_similarity_index_measure
        >>> preds = torch.rand(4, 3, 32, 32, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> round(float(structural_similarity_index_measure(preds, target, data_range=1.0)), 4)
        0.9219
    """
    preds, target = _ssim_check_inputs(preds, target)
    similarity_pack = _ssim_update(
        preds,
        target,
        gaussian_kernel,
        sigma,
        kernel_size,
        data_range,
        k1,
        k2,
        return_full_image,
        return_contrast_sensitivity,
    )
    if isinstance(similarity_pack, tuple):
        similarity, image = similarity_pack
        return _ssim_compute(similarity, reduction), image
    return _ssim_compute(similarity_pack, reduction)


def _get_normalized_sim_and_cs(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    normalize: Optional[str] = None,
) -> Tuple[Tensor, Tensor]:
    sim, contrast_sensitivity = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, return_contrast_sensitivity=True
    )
    if normalize == "relu":
        sim = torch.relu(sim)
        contrast_sensitivity = torch.relu(contrast_sensitivity)
    return sim, contrast_sensitivity


def _multiscale_ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """Per-image MS-SSIM ``(B,)`` over a 2x-downsampling pyramid of ``len(betas)`` scales."""
    is_3d = preds.ndim == 5

    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]

    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    pool = F.avg_pool3d if is_3d else F.avg_pool2d
    mcs_list: List[Tensor] = []
    sim = None
    for _ in range(len(betas)):
        sim, contrast_sensitivity = _get_normalized_sim_and_cs(
            preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, normalize=normalize
        )
        mcs_list.append(contrast_sensitivity)
        preds = pool(preds, kernel_size=2, stride=2)
        target = pool(target, kernel_size=2, stride=2)

    mcs_list[-1] = sim
    mcs_stack = torch.stack(mcs_list)
    if normalize == "simple":
        mcs_stack = (mcs_stack + 1) / 2
    # each scale to its own power (a Python float each: no host-to-device copy)
    mcs_weighted = torch.stack([mcs_stack[i] ** beta for i, beta in enumerate(betas)])
    return torch.prod(mcs_weighted, dim=0)


def _multiscale_ssim_compute(mcs_per_image: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    return _reduce(mcs_per_image, reduction)


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> Tensor:
    """Multi-scale SSIM.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import multiscale_structural_similarity_index_measure
        >>> preds = torch.rand(4, 3, 64, 64, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> round(float(multiscale_structural_similarity_index_measure(
        ...     preds, target, data_range=1.0, betas=(0.3, 0.3, 0.4))), 4)
        0.9466
    """
    if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be of a tuple of floats.")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None`, `relu` or `simple`")

    preds, target = _ssim_check_inputs(preds, target)
    mcs_per_image = _multiscale_ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas, normalize
    )
    return _multiscale_ssim_compute(mcs_per_image, reduction)
