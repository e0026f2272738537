"""AdjustedMutualInfoScore (port of
``tpumetrics/clustering/adjusted_mutual_info_score.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.clustering.base import _LabelPairClusterMetric
from tpumetrics_torch.functional.clustering.adjusted_mutual_info_score import adjusted_mutual_info_score
from tpumetrics_torch.functional.clustering.utils import _validate_average_method_arg

Tensor = torch.Tensor


class AdjustedMutualInfoScore(_LabelPairClusterMetric):
    """Chance-adjusted mutual information between cluster assignments; the
    expected MI is a float64 grid on the states' device.

    Args:
        average_method: the normalizer's mean of the two entropies
            (``min``/``geometric``/``arithmetic``/``max``).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.clustering import AdjustedMutualInfoScore
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = AdjustedMutualInfoScore(average_method="arithmetic", device="cpu")
        >>> round(float(metric(preds, target)), 2)
        -0.25
    """

    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method

    def compute(self) -> Tensor:
        preds, target, mask = self._catted()
        return adjusted_mutual_info_score(preds, target, self.average_method, mask=mask, **self._class_spaces())
