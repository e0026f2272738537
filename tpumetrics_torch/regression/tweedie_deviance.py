"""TweedieDevianceScore (port of ``tpumetrics/regression/tweedie_deviance.py``).

An eager update checks the inputs against the power's domain on the host;
a captured one skips the checks (see the functional module).
"""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class TweedieDevianceScore(Metric):
    """Tweedie deviance at ``power``: a float32 sum and an int32 count.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import TweedieDevianceScore
        >>> metric = TweedieDevianceScore(power=2, device="cpu")
        >>> metric.update(torch.tensor([4.0, 3.0, 2.0, 1.0]), torch.tensor([1.0, 2.0, 3.0, 4.0]))
        >>> round(float(metric.compute()), 4)
        1.2083
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    sum_deviance_score: Tensor
    num_observations: Tensor

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("num_observations", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)
