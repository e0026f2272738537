"""RetrievalMRR (port of ``tpumetrics/retrieval/reciprocal_rank.py``)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from tpumetrics_torch.functional.retrieval._grouped import SortedQueries, grouped_reciprocal_rank
from tpumetrics_torch.functional.retrieval.precision import _validate_top_k
from tpumetrics_torch.retrieval.base import RetrievalMetric

Tensor = torch.Tensor


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank over queries.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.retrieval import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalMRR(device="cpu")
        >>> float(metric(preds, target, indexes=indexes))
        0.75
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
        return grouped_reciprocal_rank(sq, self.top_k)
