"""Spectral Distortion Index, D_lambda (port of ``tpumetrics/functional/image/d_lambda.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.image.helper import _reduce
from tpumetrics_torch.functional.image.uqi import universal_image_quality_index

Tensor = torch.Tensor


def _spectral_distortion_index_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Same dtype, ``BxCxHxW``, the same batch and band counts; the spatial
    sizes may differ (a fused pan-sharpened image against its low-resolution
    multispectral input: the band-pair indices never mix the two)."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    if preds.ndim != 4 or target.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            "Expected `preds` and `target` to have same batch and channel sizes."
            f"Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _pairwise_band_uqi(x: Tensor) -> Tensor:
    """``(C, C)`` symmetric matrix of the mean UQI of every pair of bands: the
    C(C-1)/2 pairs batched into one UQI call of ``(P*B, 1, H, W)``, the pair
    indices made on the device, their scores written by ``index_put_`` (the
    indices are unique, so the write is deterministic)."""
    b, c, h, w = x.shape
    ii, jj = torch.triu_indices(c, c, 1, device=x.device)
    stack1 = x.index_select(1, ii).transpose(0, 1).reshape(-1, 1, h, w)  # (P, B) -> (P*B, 1, H, W)
    stack2 = x.index_select(1, jj).transpose(0, 1).reshape(-1, 1, h, w)
    maps = universal_image_quality_index(stack1, stack2, reduction="none")
    pair_scores = maps.reshape(ii.shape[0], -1).mean(dim=1)
    m = torch.zeros((c, c), dtype=x.dtype, device=x.device).index_put_((ii, jj), pair_scores)
    return m + m.T


def _spectral_distortion_index_compute(
    preds: Tensor, target: Tensor, p: int = 1, reduction: Optional[str] = "elementwise_mean"
) -> Tensor:
    """``(mean over band pairs of |Q_target - Q_preds|^p)^(1/p)``; a single band has no pairs and scores 0."""
    length = preds.shape[1]
    if length == 1:
        return _reduce(torch.zeros((), device=preds.device), reduction)
    m1 = _pairwise_band_uqi(target)
    m2 = _pairwise_band_uqi(preds)

    diff = torch.abs(m1 - m2) ** p
    # the off-diagonal entries: (sum - trace) over length * (length - 1)
    output = (torch.sum(diff) - torch.trace(diff)) / (length * (length - 1))
    return _reduce(output ** (1.0 / p), reduction)


def spectral_distortion_index(
    preds: Tensor, target: Tensor, p: int = 1, reduction: Optional[str] = "elementwise_mean"
) -> Tensor:
    """Spectral Distortion Index (D_lambda) of pan-sharpened images.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import spectral_distortion_index
        >>> preds = torch.rand(16, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> float(spectral_distortion_index(preds, target)) < 0.1
        True
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds, target = _spectral_distortion_index_update(preds, target)
    return _spectral_distortion_index_compute(preds, target, p, reduction)
