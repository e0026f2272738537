"""EditDistance (port of ``tpumetrics/text/edit.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch

from tpumetrics_torch.functional.text.edit import _edit_distance_compute, _edit_distance_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class EditDistance(Metric):
    """Character-level Levenshtein distance accumulated over batches: an
    int32 sum and count, or the int32 distances of every pair as a cat state
    with ``reduction="none"``. The update reads host strings.

    Args:
        substitution_cost: cost of a substitution.
        reduction: ``mean``, ``sum`` or ``none`` over the pairs' distances.

    Example:
        >>> from tpumetrics_torch.text import EditDistance
        >>> metric = EditDistance(device="cpu")
        >>> float(metric(["rain"], ["shine"]))
        3.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    _update_reads_host = True

    def __init__(self, substitution_cost: int = 1, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(substitution_cost, int) and substitution_cost >= 0):
            raise ValueError(
                f"Expected argument `substitution_cost` to be a positive integer, but got {substitution_cost}"
            )
        self.substitution_cost = substitution_cost
        allowed_reduction = (None, "mean", "sum", "none")
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction}, but got {reduction}")
        self.reduction = reduction

        if self.reduction == "none" or self.reduction is None:
            self.add_state("edit_scores_list", default=[], dist_reduce_fx="cat", feature_dtype=torch.int32)
        else:
            self.add_state("edit_scores", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("num_elements", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        """Accumulate the pairs' edit distances."""
        distances = _edit_distance_update(preds, target, self.substitution_cost, self.device)
        if self.reduction == "none" or self.reduction is None:
            self.edit_scores_list.append(distances)
        else:
            self.edit_scores = self.edit_scores + distances.sum(dtype=torch.int32)
            self.num_elements = self.num_elements + distances.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "none" or self.reduction is None:
            return dim_zero_cat(self.edit_scores_list)
        return _edit_distance_compute(self.edit_scores.reshape(1), self.num_elements, self.reduction)
