"""Cosine similarity (port of ``tpumetrics/functional/regression/cosine_similarity.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Row-wise dot product over the norms, then a sum, a mean or none."""
    dot_product = (preds * target).sum(dim=-1)
    preds_norm = torch.linalg.vector_norm(preds, dim=-1)
    target_norm = torch.linalg.vector_norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    if reduction == "sum":
        return torch.sum(similarity)
    if reduction == "mean":
        return torch.mean(similarity)
    if reduction in ("none", None):
        return similarity
    raise KeyError(reduction)


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Cosine similarity between row vectors.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import cosine_similarity
        >>> target = torch.tensor([[1., 2, 3, 4], [1, 2, 3, 4]])
        >>> preds = torch.tensor([[1., 2, 3, 4], [-1, -2, -3, -4]])
        >>> [round(v, 4) for v in cosine_similarity(preds, target, reduction='none').tolist()]
        [1.0, -1.0]
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
