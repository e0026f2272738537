"""Retrieval precision-recall curve (port of
``tpumetrics/functional/retrieval/precision_recall_curve.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.retrieval._grouped import grouped_precision_recall_curve, sort_queries
from tpumetrics_torch.utils.checks import _check_retrieval_functional_inputs

Tensor = torch.Tensor


def _retrieval_recall_at_fixed_precision(
    precision: Tensor, recall: Tensor, top_k: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """The largest recall whose precision is at least ``min_precision``, and
    its k (the largest k on a recall tie), as where-masks: with no
    qualifying point, or a zero largest recall, ``best_k`` is ``len(top_k)``."""
    qualifying = precision >= min_precision
    masked_recall = torch.where(qualifying, recall, torch.full_like(recall, -float("inf")))
    max_recall = masked_recall.max()
    at_max = qualifying & (masked_recall == max_recall)
    best_k = torch.where(at_max, top_k, torch.full_like(top_k, -1)).max()
    none_qualify = ~qualifying.any()
    max_recall = torch.where(none_qualify, torch.zeros_like(max_recall), max_recall)
    fallback_k = torch.full_like(best_k, top_k.shape[0])
    best_k = torch.where(none_qualify | (max_recall == 0.0), fallback_k, best_k)
    return max_recall.to(torch.float32), best_k


def retrieval_precision_recall_curve(
    preds: Tensor, target: Tensor, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision and recall at every k in ``1..max_k`` for a single query.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.retrieval import retrieval_precision_recall_curve
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> precision, recall, top_k = retrieval_precision_recall_curve(preds, target)
        >>> [round(v, 4) for v in precision.tolist()]
        [1.0, 0.5, 0.6667]
        >>> recall.tolist()
        [0.5, 0.5, 1.0]
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if max_k is None:
        max_k = preds.shape[-1]
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")

    n = preds.shape[-1]
    dev = preds.device
    if adaptive_k and max_k > n:
        topk = torch.cat(
            [torch.arange(1, n + 1, dtype=torch.float32, device=dev), torch.full((max_k - n,), float(n), device=dev)]
        )
    else:
        topk = torch.arange(1, max_k + 1, dtype=torch.float32, device=dev)

    sq = sort_queries(torch.zeros(preds.shape, dtype=torch.int32, device=dev), preds, target, 1)
    precision, recall, computable = grouped_precision_recall_curve(sq, max_k, adaptive_k)
    zeros = torch.zeros((max_k,), device=dev)
    return torch.where(computable[0], precision[0], zeros), torch.where(computable[0], recall[0], zeros), topk
