"""RetrievalMAP (port of ``tpumetrics/retrieval/average_precision.py``)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from tpumetrics_torch.functional.retrieval._grouped import SortedQueries, grouped_average_precision
from tpumetrics_torch.functional.retrieval.precision import _validate_top_k
from tpumetrics_torch.retrieval.base import RetrievalMetric

Tensor = torch.Tensor


class RetrievalMAP(RetrievalMetric):
    """Mean average precision over queries.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.retrieval import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalMAP(device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        0.7917
    """

    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        top_k: Optional[int] = None,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        num_queries: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            empty_target_action=empty_target_action, ignore_index=ignore_index, num_queries=num_queries, **kwargs
        )
        _validate_top_k(top_k)
        self.top_k = top_k

    def _grouped_metric(self, sq: SortedQueries) -> Tuple[Tensor, Tensor]:
        return grouped_average_precision(sq, self.top_k)
