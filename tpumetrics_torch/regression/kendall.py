"""KendallRankCorrCoef (port of ``tpumetrics/regression/kendall.py``)."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from tpumetrics_torch.functional.regression.kendall import (
    _ALLOWED_ALTERNATIVES,
    _ALLOWED_VARIANTS,
    kendall_rank_corrcoef,
)
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class KendallRankCorrCoef(Metric):
    """Kendall's tau of the accumulated data (list states, cat-synced), and
    its p-value with ``t_test=True``.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import KendallRankCorrCoef
        >>> metric = KendallRankCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 1.0, 4.0, 3.0]), torch.tensor([3.0, 2.0, 1.0, 4.0]))
        >>> round(float(metric.compute()), 4)
        0.0
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = True

    preds: List[Tensor]
    target: List[Tensor]

    def __init__(
        self,
        variant: str = "b",
        t_test: bool = False,
        alternative: Optional[str] = "two-sided",
        num_outputs: int = 1,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if variant not in _ALLOWED_VARIANTS:
            raise ValueError(f"Argument `variant` is expected to be one of {_ALLOWED_VARIANTS}, but got {variant!r}")
        if not isinstance(t_test, bool):
            raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {t_test}.")
        if t_test and alternative is None:
            raise ValueError("Argument `alternative` is required if `t_test=True` but got `None`.")
        if alternative not in _ALLOWED_ALTERNATIVES:
            raise ValueError(
                f"Argument `alternative` is expected to be one of {_ALLOWED_ALTERNATIVES}, but got {alternative!r}"
            )
        self.variant = variant
        self.t_test = t_test
        self.alternative = alternative
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.preds.append(preds)
        self.target.append(target)

    def compute(self):
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return kendall_rank_corrcoef(preds, target, self.variant, self.t_test, self.alternative)
