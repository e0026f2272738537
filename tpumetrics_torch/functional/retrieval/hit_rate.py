"""Retrieval hit rate (port of ``tpumetrics/functional/retrieval/hit_rate.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.retrieval._grouped import grouped_hit_rate
from tpumetrics_torch.functional.retrieval.precision import _first_or_zero, _single_query, _validate_top_k
from tpumetrics_torch.utils.checks import _check_retrieval_functional_inputs

Tensor = torch.Tensor


def retrieval_hit_rate(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Hit rate@k for a single query: 1.0 when any relevant document
    appears in the top k.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.retrieval import retrieval_hit_rate
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> float(retrieval_hit_rate(preds, target, top_k=2))
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_top_k(top_k)
    return _first_or_zero(*grouped_hit_rate(_single_query(preds, target), top_k))
