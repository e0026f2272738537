"""RetrievalRPrecision (port of ``tpumetrics/retrieval/r_precision.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from tpumetrics_torch.functional.retrieval._grouped import SortedQueries, grouped_r_precision
from tpumetrics_torch.retrieval.base import RetrievalMetric

Tensor = torch.Tensor


class RetrievalRPrecision(RetrievalMetric):
    """Mean R-precision over queries.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.retrieval import RetrievalRPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRPrecision(device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        0.75
    """

    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def _grouped_metric(self, sq: SortedQueries) -> Tuple[Tensor, Tensor]:
        return grouped_r_precision(sq)
