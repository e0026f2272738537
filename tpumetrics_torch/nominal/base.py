"""Shared base of the port's contingency-table association metrics
(``CramersV``, ``TschuprowsT``, ``PearsonsContingencyCoefficient``,
``TheilsU``): one float32 ``(C, C)`` sum state, as the JAX package's
``jnp.zeros((C, C))`` default, advanced by the int32 table of each batch.

With ``nan_strategy="replace"`` an update reads nothing on the host and a
fused collection captures it; ``"drop"`` selects the rows without a NaN by
a boolean index, which reads the host, so the update stays eager
(``_update_reads_host``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.nominal.utils import _nominal_confmat, _nominal_input_validation
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class _NominalAssociationMetric(Metric):
    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    confmat: Tensor

    def __init__(
        self,
        num_classes: int,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_classes, int) or num_classes < 2:
            raise ValueError(f"Argument `num_classes` is expected to be an integer >= 2, but got {num_classes}")
        self.num_classes = num_classes
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self._update_reads_host = nan_strategy == "drop"
        self.add_state("confmat", torch.zeros((num_classes, num_classes)), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the contingency table."""
        confmat = _nominal_confmat(preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value)
        self.confmat = self.confmat + confmat
