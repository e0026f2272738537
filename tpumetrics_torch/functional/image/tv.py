"""Total variation (port of ``tpumetrics/functional/image/tv.py``)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Tensor = torch.Tensor


def _total_variation_update(img: Tensor) -> Tuple[Tensor, int]:
    """Per-image anisotropic TV ``(B,)`` and the image count."""
    img = torch.as_tensor(img)
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {tuple(img.shape)}")
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    res1 = torch.abs(diff1).sum(dim=(1, 2, 3))
    res2 = torch.abs(diff2).sum(dim=(1, 2, 3))
    return res1 + res2, img.shape[0]


def _total_variation_compute(score: Tensor, num_elements: Union[int, Tensor], reduction: Optional[str]) -> Tensor:
    """``sum``, ``mean`` or ``none``/None."""
    if reduction == "mean":
        return score.sum() / num_elements
    if reduction == "sum":
        return score.sum()
    if reduction is None or reduction == "none":
        return score
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def total_variation(img: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Total variation of a batch of images.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import total_variation
        >>> img = torch.tensor([[[[0.0, 1.0], [3.0, 1.0]]]])
        >>> float(total_variation(img))
        6.0
    """
    score, num_elements = _total_variation_update(img)
    return _total_variation_compute(score, num_elements, reduction)
