"""Kendall rank correlation, tau-a/b/c with an optional significance test
(port of ``tpumetrics/functional/regression/kendall.py``).

- **The pair count** is a row-chunked pairwise sign contraction: rows come
  ``_PAIR_CHUNK`` = 512 at a time against every column, so memory stays
  O(512 n) and the ``(n, n)`` matrix is never built. Each chunk's sum of
  +-1 is an exact integer in float32 (below 2^24 while 512 n is), whatever
  order the device adds in; the chunk sums are then added to a float32
  total one by one in chunk order, as the JAX package's ``lax.scan`` adds
  them, so the total equals the JAX one bit for bit, also past 2^24.
- **The tie statistics** come from the run lengths ``t`` of the sorted
  data (exact integers); the sums of ``t(t-1)/2``, ``t(t-1)(t-2)`` and
  ``t(t-1)(2t+5)`` are taken in float64 and rounded to float32 once. The
  JAX package sums them in float32, which is exact below 2^24 and rounds
  (in its own order) past it.
- **The p-value** uses the normal distribution's ``torch.special.ndtr``
  where the JAX package uses ``jax.scipy.stats.norm``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.regression.spearman import _run_bounds
from tpumetrics_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from tpumetrics_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor

_ALLOWED_VARIANTS = ("a", "b", "c")
_ALLOWED_ALTERNATIVES = ("two-sided", "less", "greater", None)

_PAIR_CHUNK = 512  # rows per block of the pairwise contraction: memory O(chunk * n)


def _tie_stats(x: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(tie_pairs, p1, p2, n_distinct)`` of one variable, with ``t`` the
    size of each group of equal values: ``Σ t(t-1)/2``, ``Σ t(t-1)(t-2)``,
    ``Σ t(t-1)(2t+5)`` (float32) and the number of groups (int64)."""
    first, last = _run_bounds(torch.sort(x).values)
    starts = first == torch.arange(x.shape[0], device=x.device)
    # one t per group, at its first position; zeros elsewhere add nothing to the sums
    t = torch.where(starts, last - first + 1, 0).to(torch.float64)
    tie_pairs = torch.sum(t * (t - 1) / 2).to(torch.float32)
    p1 = torch.sum(t * (t - 1) * (t - 2)).to(torch.float32)
    p2 = torch.sum(t * (t - 1) * (2 * t + 5)).to(torch.float32)
    return tie_pairs, p1, p2, torch.sum(starts)


def _pair_stats(preds: Tensor, target: Tensor) -> Tensor:
    """Concordant minus discordant pairs (float32). The differences are
    taken in the inputs' dtype, so a tie here is a tie in ``_tie_stats``."""
    n = preds.shape[0]
    chunk = min(_PAIR_CHUNK, n)
    cols = torch.arange(n, device=preds.device)
    cmd = torch.zeros((), dtype=torch.float32, device=preds.device)
    for start in range(0, n, chunk):
        rows = slice(start, start + chunk)
        sx = torch.sign((preds[rows, None] - preds[None, :]).to(torch.float32))
        sy = torch.sign((target[rows, None] - target[None, :]).to(torch.float32))
        upper = cols[None, :] > cols[rows, None]  # the strict upper triangle of the pair matrix
        cmd = cmd + torch.sum(sx * sy * upper)
    return cmd


def _kendall_tau_1d(preds: Tensor, target: Tensor, variant: str) -> Tuple[Tensor, Tensor, tuple, tuple]:
    """``(tau, concordant - discordant, x tie stats, y tie stats)`` of one column."""
    n = preds.shape[0]
    con_min_dis = _pair_stats(preds, target)
    n0 = n * (n - 1) / 2.0
    x_stats = _tie_stats(preds)
    y_stats = _tie_stats(target)
    if variant == "a":
        tau = con_min_dis / n0
    elif variant == "b":
        tau = con_min_dis / torch.sqrt((n0 - x_stats[0]) * (n0 - y_stats[0]))
    else:  # "c"
        m = torch.minimum(x_stats[3], y_stats[3]).to(torch.float32)
        tau = 2.0 * con_min_dis / (n**2 * (m - 1) / m)
    return torch.clamp(tau, -1.0, 1.0), con_min_dis, x_stats, y_stats


def _kendall_pvalue_1d(
    x_stats: tuple, y_stats: tuple, con_min_dis: Tensor, n: int, variant: str, alternative: str
) -> Tensor:
    """The normal approximation's p-value, with the tie corrections of
    variants "b" and "c"."""
    base = n * (n - 1) * (2.0 * n + 5.0)
    if variant == "a" or n <= 2:
        # n <= 2: the tie corrections are 0/0, so the untied form stands
        z = con_min_dis / torch.sqrt(torch.tensor(base / 18.0, dtype=torch.float32, device=con_min_dis.device))
    else:
        x_tie, x_p1, x_p2, _ = x_stats
        y_tie, y_p1, y_p2, _ = y_stats
        m = n * (n - 1.0)
        var = (base - x_p2 - y_p2) / 18.0
        var = var + (2.0 * x_tie * y_tie) / m
        var = var + x_p1 * y_p1 / (9.0 * m * (n - 2.0))
        z = con_min_dis / torch.sqrt(var)
    if alternative == "two-sided":
        return 2 * torch.special.ndtr(-torch.abs(z))
    if alternative == "greater":
        return torch.special.ndtr(-z)
    return torch.special.ndtr(z)


def kendall_rank_corrcoef(
    preds: Tensor,
    target: Tensor,
    variant: str = "b",
    t_test: bool = False,
    alternative: Optional[str] = "two-sided",
):
    """Kendall's tau, and with ``t_test=True`` also its p-value.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import kendall_rank_corrcoef
        >>> preds = torch.tensor([2.5, 1.0, 4.0, 3.0])
        >>> target = torch.tensor([3.0, 2.0, 1.0, 4.0])
        >>> round(float(kendall_rank_corrcoef(preds, target)), 4)
        0.0
    """
    if variant not in _ALLOWED_VARIANTS:
        raise ValueError(f"Argument `variant` is expected to be one of {_ALLOWED_VARIANTS}, but got {variant!r}")
    if not isinstance(t_test, bool):
        raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {t_test}.")
    if t_test and alternative is None:
        raise ValueError("Argument `alternative` is required if `t_test=True` but got `None`.")
    if alternative not in _ALLOWED_ALTERNATIVES:
        raise ValueError(
            f"Argument `alternative` is expected to be one of {_ALLOWED_ALTERNATIVES}, but got {alternative!r}"
        )
    _check_same_shape(preds, target)
    num_outputs = 1 if preds.ndim == 1 else preds.shape[1]
    _check_data_shape_to_num_outputs(preds, target, num_outputs, allow_1d_reshape=True)

    if preds.ndim == 1:
        tau, cmd, xs, ys = _kendall_tau_1d(preds, target, variant)
        if t_test:
            return tau, _kendall_pvalue_1d(xs, ys, cmd, preds.shape[0], variant, alternative)
        return tau
    taus, pvals = [], []
    for i in range(num_outputs):
        tau, cmd, xs, ys = _kendall_tau_1d(preds[:, i], target[:, i], variant)
        taus.append(tau)
        if t_test:
            pvals.append(_kendall_pvalue_1d(xs, ys, cmd, preds.shape[0], variant, alternative))
    if t_test:
        return torch.stack(taus), torch.stack(pvals)
    return torch.stack(taus)
