"""VisualInformationFidelity (port of ``tpumetrics/image/vif.py``)."""

from __future__ import annotations

from typing import Any

import torch

from tpumetrics_torch.functional.image.vif import visual_information_fidelity
from tpumetrics_torch.metric import Metric

Tensor = torch.Tensor


class VisualInformationFidelity(Metric):
    """Pixel-based VIF over batches: each batch's mean times its size, summed, and the image count.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.image import VisualInformationFidelity
        >>> g = torch.Generator().manual_seed(0)
        >>> preds, target = torch.rand(8, 3, 41, 41, generator=g), torch.rand(8, 3, 41, 41, generator=g)
        >>> vif = VisualInformationFidelity(device="cpu")
        >>> float(vif(preds, target)) > 0
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, sigma_n_sq: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(sigma_n_sq, (float, int)) or sigma_n_sq < 0:
            raise ValueError(f"Argument `sigma_n_sq` is expected to be a positive float or int, but got {sigma_n_sq}")
        self.add_state("vif_score", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")
        self.sigma_n_sq = sigma_n_sq

    def update(self, preds: Tensor, target: Tensor) -> None:
        batch_vif = visual_information_fidelity(preds, target, self.sigma_n_sq)
        self.vif_score = self.vif_score + batch_vif * preds.shape[0]
        self.total = self.total + preds.shape[0]

    def compute(self) -> Tensor:
        return self.vif_score / self.total
