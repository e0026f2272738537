"""ExplainedVariance (port of ``tpumetrics/regression/explained_variance.py``).

The states start as float32 scalars, ``num_obs`` too, as in the JAX
package; a 2-D update broadcasts them to one entry per output.
"""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.explained_variance import (
    ALLOWED_MULTIOUTPUT,
    _explained_variance_compute,
    _explained_variance_update,
)
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class ExplainedVariance(Metric):
    """Explained variance.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import ExplainedVariance
        >>> metric = ExplainedVariance(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))
        >>> round(float(metric.compute()), 4)
        0.9572
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    num_obs: Tensor
    sum_error: Tensor
    sum_squared_error: Tensor
    sum_target: Tensor
    sum_squared_target: Tensor

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if multioutput not in ALLOWED_MULTIOUTPUT:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}"
            )
        self.multioutput = multioutput
        for name in ("num_obs", "sum_error", "sum_squared_error", "sum_target", "sum_squared_target"):
            self.add_state(name, torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        num_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(
            preds, target
        )
        self.num_obs = self.num_obs + num_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> Tensor:
        return _explained_variance_compute(
            self.num_obs,
            self.sum_error,
            self.sum_squared_error,
            self.sum_target,
            self.sum_squared_target,
            self.multioutput,
        )
