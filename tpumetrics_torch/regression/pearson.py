"""PearsonCorrCoef (port of ``tpumetrics/regression/pearson.py``).

The states are streaming moments with ``dist_reduce_fx=None``: a sync
stacks them per rank, and ``compute`` merges the stack with
``_final_aggregation`` (the Chan et al. parallel merge, rank by rank).
"""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.pearson import (
    _final_aggregation,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor

_MOMENTS = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


class PearsonCorrCoef(Metric):
    """Pearson correlation per output.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import PearsonCorrCoef
        >>> metric = PearsonCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))
        >>> round(float(metric.compute()), 4)
        0.9849
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True

    mean_x: Tensor
    mean_y: Tensor
    var_x: Tensor
    var_y: Tensor
    corr_xy: Tensor
    n_total: Tensor

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        for name in _MOMENTS:
            self.add_state(name, torch.zeros(num_outputs), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total,
            self.num_outputs,
        )

    def _aggregated(self) -> tuple:
        moments = tuple(getattr(self, name) for name in _MOMENTS)
        if self.mean_x.ndim > 1:  # rank-stacked by a sync
            return _final_aggregation(*moments)
        return moments

    def compute(self) -> Tensor:
        _, _, var_x, var_y, corr_xy, n_total = self._aggregated()
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)
