"""Retrieval reciprocal rank (port of ``tpumetrics/functional/retrieval/reciprocal_rank.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.retrieval._grouped import grouped_reciprocal_rank
from tpumetrics_torch.functional.retrieval.precision import _first_or_zero, _single_query, _validate_top_k
from tpumetrics_torch.utils.checks import _check_retrieval_functional_inputs

Tensor = torch.Tensor


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Reciprocal rank of the first relevant document in the top k of a
    single query.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.retrieval import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, False])
        >>> float(retrieval_reciprocal_rank(preds, target))
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_top_k(top_k)
    return _first_or_zero(*grouped_reciprocal_rank(_single_query(preds, target), top_k))
