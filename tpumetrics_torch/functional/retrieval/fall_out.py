"""Retrieval fall-out (port of ``tpumetrics/functional/retrieval/fall_out.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.retrieval._grouped import grouped_fall_out
from tpumetrics_torch.functional.retrieval.precision import _first_or_zero, _single_query, _validate_top_k
from tpumetrics_torch.utils.checks import _check_retrieval_functional_inputs

Tensor = torch.Tensor


def retrieval_fall_out(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Fall-out@k for a single query: the fraction of the non-relevant
    documents retrieved in the top k; 0.0 when the query has no negative
    target.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.retrieval import retrieval_fall_out
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> float(retrieval_fall_out(preds, target, top_k=2))
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_top_k(top_k)
    return _first_or_zero(*grouped_fall_out(_single_query(preds, target), top_k))
