"""TotalVariation (port of ``tpumetrics/image/tv.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.image.tv import _total_variation_compute, _total_variation_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class TotalVariation(Metric):
    """Total variation over batches of images (``update(img)``): a float32
    sum, an int32 image count, and per-image scores in a list state under
    ``reduction`` ``"none"``/None.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import TotalVariation
        >>> tv = TotalVariation(device="cpu")
        >>> img = torch.tensor([[[[0.0, 1.0], [3.0, 1.0]]]])
        >>> float(tv(img))
        6.0
    """

    full_state_update: bool = False
    is_differentiable: bool = True
    higher_is_better: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        self.add_state("score_list", default=[], dist_reduce_fx="cat")
        self.add_state("score", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("num_elements", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, img: Tensor) -> None:
        score, num_elements = _total_variation_update(img)
        if self.reduction is None or self.reduction == "none":
            self.score_list.append(score)
        else:
            self.score = self.score + score.sum()
        self.num_elements = self.num_elements + num_elements

    def compute(self) -> Tensor:
        if self.reduction is None or self.reduction == "none":
            return dim_zero_cat(self.score_list)
        return _total_variation_compute(self.score, self.num_elements, self.reduction)
