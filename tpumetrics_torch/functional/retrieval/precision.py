"""Retrieval precision (port of ``tpumetrics/functional/retrieval/precision.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.retrieval._grouped import SortedQueries, grouped_precision, sort_queries
from tpumetrics_torch.utils.checks import _check_retrieval_functional_inputs

Tensor = torch.Tensor


def _validate_top_k(top_k: Optional[int]) -> None:
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")


def _single_query(preds: Tensor, target: Tensor) -> SortedQueries:
    return sort_queries(torch.zeros(preds.shape, dtype=torch.int32, device=preds.device), preds, target, 1)


def _first_or_zero(values: Tensor, computable: Tensor) -> Tensor:
    """The single query's value, 0.0 when it lacks the required target."""
    return torch.where(computable[0], values[0], torch.zeros_like(values[0]))


def retrieval_precision(
    preds: Tensor, target: Tensor, top_k: Optional[int] = None, adaptive_k: bool = False
) -> Tensor:
    """Precision@k for a single query: the fraction of the top-k retrieved
    documents that are relevant; 0.0 when the query has no positive target.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.retrieval import retrieval_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> float(retrieval_precision(preds, target, top_k=2))
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    _validate_top_k(top_k)
    return _first_or_zero(*grouped_precision(_single_query(preds, target), top_k, adaptive_k))
