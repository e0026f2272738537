"""Fleiss kappa (port of ``tpumetrics/functional/nominal/fleiss_kappa.py``)."""

from __future__ import annotations

import torch

from tpumetrics_torch.utils.data import _one_hot

Tensor = torch.Tensor


def _fleiss_kappa_update(ratings: Tensor, mode: str = "counts") -> Tensor:
    """int32 ``(n_samples, n_categories)`` rating counts: ``counts`` input as
    given, ``probs`` input ``(n, C, raters)`` argmaxed per rater and
    counted with an int32 one-hot sum."""
    if mode == "probs":
        if ratings.ndim != 3 or not ratings.is_floating_point():
            raise ValueError(
                "If argument ``mode`` is 'probs', ratings must have 3 dimensions with the format"
                " [n_samples, n_categories, n_raters] and be floating point."
            )
        choices = ratings.argmax(dim=1)  # (n_samples, n_raters)
        return _one_hot(choices, ratings.shape[1]).sum(dim=1, dtype=torch.int32)
    if mode == "counts" and (ratings.ndim != 2 or ratings.is_floating_point()):
        raise ValueError(
            "If argument ``mode`` is `counts`, ratings must have 2 dimensions with the format"
            " [n_samples, n_categories] and be none floating point."
        )
    return ratings.to(torch.int32)


def _fleiss_kappa_compute(counts: Tensor) -> Tensor:
    """kappa = (p_bar - pe_bar) / (1 - pe_bar)."""
    counts = counts.to(torch.float32)
    total = counts.shape[0]
    num_raters = counts.sum(dim=1).max()

    p_i = counts.sum(dim=0) / (total * num_raters)
    p_j = ((counts**2).sum(dim=1) - num_raters) / (num_raters * (num_raters - 1))
    p_bar = p_j.mean()
    pe_bar = (p_i**2).sum()
    return (p_bar - pe_bar) / (1 - pe_bar + 1e-5)


def fleiss_kappa(ratings: Tensor, mode: str = "counts") -> Tensor:
    """Fleiss kappa: chance-adjusted agreement of many raters.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.nominal import fleiss_kappa
        >>> # 4 samples, 3 categories, 5 raters (as per-category counts)
        >>> ratings = torch.tensor([[5, 0, 0], [2, 3, 0], [1, 1, 3], [0, 5, 0]])
        >>> round(float(fleiss_kappa(ratings)), 4)
        0.4715
    """
    if mode not in ["counts", "probs"]:
        raise ValueError("Argument ``mode`` must be one of ['counts', 'probs'].")
    counts = _fleiss_kappa_update(ratings, mode)
    return _fleiss_kappa_compute(counts)
