"""ConcordanceCorrCoef (port of ``tpumetrics/regression/concordance.py``),
on Pearson's moment states."""

from __future__ import annotations

import torch

from tpumetrics_torch.functional.regression.concordance import _concordance_corrcoef_compute
from tpumetrics_torch.regression.pearson import PearsonCorrCoef

Tensor = torch.Tensor


class ConcordanceCorrCoef(PearsonCorrCoef):
    """Concordance correlation per output.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.regression import ConcordanceCorrCoef
        >>> metric = ConcordanceCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2, 8]), torch.tensor([3., -0.5, 2, 7]))
        >>> round(float(metric.compute()), 4)
        0.9777
    """

    def compute(self) -> Tensor:
        return _concordance_corrcoef_compute(*self._aggregated()).squeeze()
