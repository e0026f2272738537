"""Retrieval average precision (port of ``tpumetrics/functional/retrieval/average_precision.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpumetrics_torch.functional.retrieval._grouped import grouped_average_precision
from tpumetrics_torch.functional.retrieval.precision import _first_or_zero, _single_query, _validate_top_k
from tpumetrics_torch.utils.checks import _check_retrieval_functional_inputs

Tensor = torch.Tensor


def retrieval_average_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Average precision over the top k of a single query.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.retrieval import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_average_precision(preds, target)), 4)
        0.8333
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_top_k(top_k)
    return _first_or_zero(*grouped_average_precision(_single_query(preds, target), top_k))
