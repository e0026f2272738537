"""Theil's U (port of ``tpumetrics/functional/nominal/theils_u.py``)."""

from __future__ import annotations

import itertools
from typing import Optional

import torch

from tpumetrics_torch.functional.nominal.utils import _infer_num_classes, _nominal_confmat, _nominal_input_validation

Tensor = torch.Tensor


def _conditional_entropy_compute(confmat: Tensor) -> Tensor:
    """H(X|Y) from the contingency table, zero cells masked."""
    confmat = confmat.to(torch.float32)
    total = confmat.sum()
    safe_total = torch.where(total > 0, total, 1.0)
    p_xy = confmat / safe_total
    p_y = confmat.sum(dim=1) / safe_total  # row marginals
    nonzero = p_xy > 0
    safe_p_xy = torch.where(nonzero, p_xy, 1.0)
    safe_p_y = torch.where(p_y > 0, p_y, 1.0)
    terms = p_xy * (torch.log(safe_p_y)[:, None] - torch.log(safe_p_xy))
    return torch.sum(torch.where(nonzero, terms, 0.0))


def _theils_u_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """The int32 contingency table."""
    return _nominal_confmat(preds, target, num_classes, nan_strategy, nan_replace_value)


def _theils_u_compute(confmat: Tensor) -> Tensor:
    """U = (H(X) - H(X|Y)) / H(X); 0 where H(X) is 0."""
    confmat = confmat.to(torch.float32)
    s_xy = _conditional_entropy_compute(confmat)

    total = confmat.sum()
    safe_total = torch.where(total > 0, total, 1.0)
    p_x = confmat.sum(dim=0) / safe_total  # column marginals
    safe_p_x = torch.where(p_x > 0, p_x, 1.0)
    s_x = -torch.sum(torch.where(p_x > 0, p_x * torch.log(safe_p_x), 0.0))

    return torch.where(s_x == 0, 0.0, (s_x - s_xy) / torch.where(s_x == 0, 1.0, s_x))


def theils_u(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
    num_classes: Optional[int] = None,
) -> Tensor:
    """Theil's uncertainty coefficient U(X|Y), an asymmetric association
    between two categorical series.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.nominal import theils_u
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 0])
        >>> round(float(theils_u(preds, target)), 3)
        0.494
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    if num_classes is None:
        num_classes = _infer_num_classes(preds, target, nan_strategy, nan_replace_value)
    confmat = _theils_u_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _theils_u_compute(confmat)


def theils_u_matrix(
    matrix: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Theil's U between every ordered pair of columns: entry (i, j) is
    U(x_i | x_j); each pair's class space is read on the host.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.nominal import theils_u_matrix
        >>> matrix = torch.tensor([[0, 0, 0], [1, 1, 1], [2, 2, 2], [1, 2, 1]])
        >>> tuple(theils_u_matrix(matrix).shape)
        (3, 3)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    num_variables = matrix.shape[1]
    value = torch.ones((num_variables, num_variables), dtype=torch.float32, device=matrix.device)
    for i, j in itertools.permutations(range(num_variables), 2):
        x, y = matrix[:, i], matrix[:, j]
        num_classes = _infer_num_classes(x, y, nan_strategy, nan_replace_value)
        confmat = _theils_u_update(x, y, num_classes, nan_strategy, nan_replace_value)
        value[i, j] = _theils_u_compute(confmat)
    return value
