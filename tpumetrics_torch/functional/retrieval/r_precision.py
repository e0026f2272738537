"""Retrieval R-precision (port of ``tpumetrics/functional/retrieval/r_precision.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.functional.retrieval._grouped import grouped_r_precision
from tpumetrics_torch.functional.retrieval.precision import _first_or_zero, _single_query
from tpumetrics_torch.utils.checks import _check_retrieval_functional_inputs

Tensor = torch.Tensor


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """R-precision for a single query: precision at R, where R is the
    query's number of relevant documents.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.retrieval import retrieval_r_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> float(retrieval_r_precision(preds, target))
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    return _first_or_zero(*grouped_r_precision(_single_query(preds, target)))
