"""Image gradients (port of ``tpumetrics/functional/image/gradients.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _image_gradients_validate(img: Tensor) -> None:
    if not isinstance(img, Tensor):
        raise TypeError(f"The `img` expects a value of <Tensor> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Forward differences, zero-padded at the far edge to the input's shape."""
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    dy = torch.nn.functional.pad(dy, (0, 0, 0, 1))
    dx = torch.nn.functional.pad(dx, (0, 1))
    return dy, dx


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """``(dy, dx)`` forward-difference gradients of an image batch.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.image import image_gradients
        >>> image = torch.arange(0, 1 * 1 * 5 * 5, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(image)
        >>> dy[0, 0, :, :].tolist()[0]
        [5.0, 5.0, 5.0, 5.0, 5.0]
    """
    img = torch.as_tensor(img)
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
