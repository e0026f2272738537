"""Retrieval normalized DCG (port of ``tpumetrics/functional/retrieval/ndcg.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.retrieval._grouped import grouped_ndcg, sort_queries
from tpumetrics_torch.functional.retrieval.precision import _validate_top_k
from tpumetrics_torch.utils.checks import _check_retrieval_functional_inputs

Tensor = torch.Tensor


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Tie-averaged nDCG@k for a single query (sklearn's dcg machinery);
    the relevance may be graded.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.retrieval import retrieval_normalized_dcg
        >>> preds = torch.tensor([.1, .2, .3, 4., 70.])
        >>> target = torch.tensor([10, 0, 0, 1, 5])
        >>> round(float(retrieval_normalized_dcg(preds, target)), 4)
        0.6957
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)
    _validate_top_k(top_k)
    zeros = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    values, _ = grouped_ndcg(sort_queries(zeros, preds, target, 1), sort_queries(zeros, target, target, 1), top_k)
    return values[0]
