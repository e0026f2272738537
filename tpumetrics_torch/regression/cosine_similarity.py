"""CosineSimilarity (port of ``tpumetrics/regression/cosine_similarity.py``)."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from tpumetrics_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class CosineSimilarity(Metric):
    """Cosine similarity of the accumulated rows (list states, cat-synced).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import CosineSimilarity
        >>> metric = CosineSimilarity(reduction='mean', device="cpu")
        >>> metric.update(torch.tensor([[1., 2, 3, 4]]), torch.tensor([[1., 2, 3, 4]]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    preds: List[Tensor]
    target: List[Tensor]

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _cosine_similarity_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return _cosine_similarity_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)
