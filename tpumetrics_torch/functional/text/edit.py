"""Edit distance (port of ``tpumetrics/functional/text/edit.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from tpumetrics_torch.functional.text.helper import _edit_distance, _normalize_inputs, _validate_all_str
from tpumetrics_torch.metric import _resolve_device

Tensor = torch.Tensor


def _edit_distance_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    device: Optional[torch.device] = None,
) -> Tensor:
    """Per-pair character distances, int32."""
    preds, target = _normalize_inputs(preds, target)
    _validate_all_str("preds", preds)
    _validate_all_str("target", target)
    distances = [_edit_distance(list(p), list(t), substitution_cost) for p, t in zip(preds, target)]
    return torch.tensor(distances, dtype=torch.int32, device=device)


def _edit_distance_compute(
    edit_scores: Tensor, num_elements: Union[Tensor, int], reduction: Optional[str] = "mean"
) -> Tensor:
    """The mean, sum or none reduction of the distances."""
    if edit_scores.numel() == 0:
        if reduction != "none" and reduction is not None:
            return torch.zeros((), dtype=torch.int32, device=edit_scores.device)
        return torch.zeros((0,), dtype=torch.int32, device=edit_scores.device)
    if reduction == "mean":
        return edit_scores.sum(dtype=torch.int32).to(torch.float32) / num_elements
    if reduction == "sum":
        return edit_scores.sum(dtype=torch.int32)
    if reduction is None or reduction == "none":
        return edit_scores
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def edit_distance(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    reduction: Optional[str] = "mean",
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Character-level Levenshtein edit distance.

    Example:
        >>> from tpumetrics_torch.functional.text import edit_distance
        >>> float(edit_distance(["rain"], ["shine"], device="cpu"))
        3.0
        >>> edit_distance(["rain", "lnaguaeg"], ["shine", "language"], reduction=None, device="cpu").tolist()
        [3, 4]
    """
    distances = _edit_distance_update(preds, target, substitution_cost, _resolve_device(device))
    return _edit_distance_compute(distances, num_elements=distances.numel(), reduction=reduction)
