"""SpearmanCorrCoef (port of ``tpumetrics/regression/spearman.py``)."""

from __future__ import annotations

from typing import Any, List

import torch

from tpumetrics_torch.functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation of the accumulated data (list states,
    cat-synced; ranked in ``compute``).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import SpearmanCorrCoef
        >>> metric = SpearmanCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    preds: List[Tensor]
    target: List[Tensor]

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _spearman_corrcoef_update(preds, target, self.num_outputs)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))
