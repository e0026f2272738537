"""RetrievalPrecisionRecallCurve and RetrievalRecallAtFixedPrecision (port of
``tpumetrics/retrieval/precision_recall_curve.py``)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from tpumetrics_torch.functional.retrieval._grouped import grouped_precision_recall_curve, sort_queries
from tpumetrics_torch.functional.retrieval.precision_recall_curve import _retrieval_recall_at_fixed_precision
from tpumetrics_torch.retrieval.base import RetrievalMetric
from tpumetrics_torch.utils.checks import _is_capturing

Tensor = torch.Tensor


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Mean precision and recall at every k in ``1..max_k`` over queries.

    The whole ``(num_queries, max_k)`` grid is one gather and one cumulative
    sum, and the empty-target policy is a row mask. ``max_k=None`` reads the
    largest query's size on the host in ``compute()``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.retrieval import RetrievalPrecisionRecallCurve
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([True, False, True, False, True, False, True])
        >>> curve = RetrievalPrecisionRecallCurve(max_k=2, device="cpu")
        >>> precisions, recalls, top_k = curve(preds, target, indexes=indexes)
        >>> precisions.tolist()
        [0.5, 0.5]
        >>> recalls.tolist()
        [0.25, 0.5]
        >>> top_k.tolist()
        [1, 2]
    """

    higher_is_better: bool = True

    def __init__(
        self,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        num_queries: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            empty_target_action=empty_target_action, ignore_index=ignore_index, num_queries=num_queries, **kwargs
        )
        if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.max_k = max_k
        self.adaptive_k = adaptive_k

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        idx, preds, target, mask, num_queries = self._flat_state()
        sq = sort_queries(idx, preds, target, num_queries, mask)
        max_k = self.max_k
        if max_k is None:
            if _is_capturing():
                raise ValueError("Pass `max_k` to compute the retrieval PR curve in a CUDA graph capture.")
            max_k = max(int(sq.counts.max()), 1)
        precision_qk, recall_qk, computable = grouped_precision_recall_curve(sq, max_k, self.adaptive_k)
        observed = sq.counts > 0

        if self.empty_target_action == "error":
            bad = observed & ~computable
            if _is_capturing():
                raise NotImplementedError(
                    "empty_target_action='error' cannot run in a CUDA graph capture; use 'skip'/'neg'/'pos'."
                )
            if bool(bad.any()):
                raise ValueError("`compute` method was provided with a query with no positive target.")

        if self.empty_target_action == "skip":
            used = observed & computable
            fill = torch.zeros_like(precision_qk)
        elif self.empty_target_action == "pos":
            used = observed
            fill = torch.ones_like(precision_qk)
        else:
            used = observed
            fill = torch.zeros_like(precision_qk)

        precision_qk = torch.where(computable[:, None], precision_qk, fill)
        recall_qk = torch.where(computable[:, None], recall_qk, fill)
        n_used = used.sum()
        denom = torch.clamp(n_used, min=1)
        any_used = n_used > 0
        zero = torch.zeros((), device=precision_qk.device)
        precision = torch.where(any_used, torch.where(used[:, None], precision_qk, zero).sum(0) / denom, zero)
        recall = torch.where(any_used, torch.where(used[:, None], recall_qk, zero).sum(0) / denom, zero)
        top_k = torch.arange(1, max_k + 1, dtype=torch.int32, device=precision.device)
        return precision, recall, top_k

    def _grouped_metric(self, sq):  # pragma: no cover - compute overridden
        raise NotImplementedError


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The highest recall whose mean precision@k clears ``min_precision``,
    and the k that reaches it.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.retrieval import RetrievalRecallAtFixedPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([True, False, True, False, True, False, True])
        >>> metric = RetrievalRecallAtFixedPrecision(min_precision=0.5, device="cpu")
        >>> max_recall, best_k = metric(preds, target, indexes=indexes)
        >>> (round(float(max_recall), 4), int(best_k))
        (1.0, 4)
    """

    def __init__(
        self,
        min_precision: float = 0.0,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        num_queries: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            max_k=max_k, adaptive_k=adaptive_k, empty_target_action=empty_target_action,
            ignore_index=ignore_index, num_queries=num_queries, **kwargs,
        )
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a positive float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        precisions, recalls, top_k = super().compute()
        return _retrieval_recall_at_fixed_precision(precisions, recalls, top_k, self.min_precision)
