"""FleissKappa (port of ``tpumetrics/nominal/fleiss_kappa.py``)."""

from __future__ import annotations

from typing import Any, List

import torch

from tpumetrics_torch.buffers import _BufferList
from tpumetrics_torch.functional.nominal.fleiss_kappa import _fleiss_kappa_compute, _fleiss_kappa_update
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class FleissKappa(Metric):
    """Fleiss kappa: agreement of many raters, from an int32 list state of
    per-sample rating counts.

    Args:
        mode: ``counts``, an integer ``[n_samples, n_categories]`` count
            matrix; ``probs``, a float ``[n_samples, n_categories, n_raters]``
            tensor, argmaxed per rater.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.nominal import FleissKappa
        >>> metric = FleissKappa(mode='counts', device="cpu")
        >>> ratings = torch.tensor([[5, 0, 0], [2, 3, 0], [1, 1, 3], [0, 5, 0]])
        >>> round(float(metric(ratings)), 4)
        0.4715
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    counts: List[Tensor]

    def __init__(self, mode: str = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ["counts", "probs"]:
            raise ValueError("Argument ``mode`` must be one of ['counts', 'probs'].")
        self.mode = mode
        self.add_state("counts", default=[], dist_reduce_fx="cat", feature_dtype=torch.int32)

    def update(self, ratings: Tensor) -> None:
        """Accumulate a batch of rating counts or probabilities."""
        self.counts.append(_fleiss_kappa_update(ratings, self.mode))

    def compute(self) -> Tensor:
        if isinstance(self.counts, _BufferList):
            buf = self.counts.buffer
            valid = buf.valid_mask()
            # invalid rows hold zero counts: weighted out of the sample mean
            c = buf.values.to(torch.float32)
            num_raters = torch.where(valid, c.sum(dim=1), 0.0).max()
            total = torch.sum(valid)
            p_i = c.sum(dim=0) / (total * num_raters)
            p_j = ((c**2).sum(dim=1) - num_raters) / (num_raters * (num_raters - 1))
            p_bar = torch.sum(torch.where(valid, p_j, 0.0)) / total
            pe_bar = (p_i**2).sum()
            return (p_bar - pe_bar) / (1 - pe_bar + 1e-5)
        return _fleiss_kappa_compute(dim_zero_cat(self.counts))
