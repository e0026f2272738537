"""RetrievalNormalizedDCG (port of ``tpumetrics/retrieval/ndcg.py``)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from tpumetrics_torch.functional.retrieval._grouped import SortedQueries, grouped_ndcg, reduce_queries, sort_queries
from tpumetrics_torch.functional.retrieval.precision import _validate_top_k
from tpumetrics_torch.retrieval.base import RetrievalMetric

Tensor = torch.Tensor


class RetrievalNormalizedDCG(RetrievalMetric):
    """Mean (tie-averaged) nDCG@k over queries; targets may be graded.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.retrieval import RetrievalNormalizedDCG
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalNormalizedDCG(device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        0.8467
    """

    allow_non_binary_target: bool = True
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

    def _grouped_metric(self, sq: SortedQueries) -> Tuple[Tensor, Tensor]:  # pragma: no cover - compute overridden
        raise NotImplementedError

    def compute(self) -> Tensor:
        """nDCG needs a second (ideal) ranking, by target: two sorts each,
        then the tie-averaged gains reduce per query."""
        idx, preds, target, mask, num_queries = self._flat_state()
        if idx.shape[0] == 0:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        sq_pred = sort_queries(idx, preds, target, num_queries, mask)
        sq_tgt = sort_queries(idx, target, target, num_queries, mask)
        values, computable = grouped_ndcg(sq_pred, sq_tgt, self.top_k)
        return reduce_queries(
            values, computable, sq_pred.counts > 0, self.empty_target_action, self._empty_requirement
        )
