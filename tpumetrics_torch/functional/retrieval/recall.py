"""Retrieval recall (port of ``tpumetrics/functional/retrieval/recall.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.retrieval._grouped import grouped_recall
from tpumetrics_torch.functional.retrieval.precision import _first_or_zero, _single_query, _validate_top_k
from tpumetrics_torch.utils.checks import _check_retrieval_functional_inputs

Tensor = torch.Tensor


def retrieval_recall(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Recall@k for a single query: the fraction of the relevant documents
    retrieved in the top k.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.retrieval import retrieval_recall
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> float(retrieval_recall(preds, target, top_k=2))
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_top_k(top_k)
    return _first_or_zero(*grouped_recall(_single_query(preds, target), top_k))
