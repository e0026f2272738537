"""Distributed reduce and gather helpers (counterpart of
``tpumetrics/utils/distributed.py``), with the wire op delegated to the
ambient backend of :mod:`tpumetrics_torch.parallel.backend`."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from tpumetrics_torch.parallel.backend import get_default_backend
from tpumetrics_torch.utils.compute import _safe_divide

Tensor = torch.Tensor


def reduce(x: Tensor, reduction: str) -> Tensor:
    """Reduce a tensor: ``"elementwise_mean"`` | ``"sum"`` | ``"none"`` (or ``None``)."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction is None or reduction == "none":
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Per-class fraction ``num / denom`` reduced: micro / macro / weighted / none."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    if class_reduction == "micro":
        return _safe_divide(torch.sum(num), torch.sum(denom))
    fraction = _safe_divide(num, denom)
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights.to(fraction.dtype) / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")


def gather_all_tensors(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """Gather a tensor from every rank through the ambient backend, one
    tensor per rank in rank order; ranks may differ in their dim-0 sizes."""
    return get_default_backend().all_gather(torch.as_tensor(result), group=group)


__all__ = ["class_reduce", "gather_all_tensors", "reduce"]
