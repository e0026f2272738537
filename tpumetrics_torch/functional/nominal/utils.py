"""Shared nominal-association helpers (port of
``tpumetrics/functional/nominal/utils.py``).

Empty rows and columns stay in the contingency table, and every statistic
is where-masked arithmetic over the *effective* (non-empty) row and column
counts, held as tensors: shapes never depend on the data.

The table is the port's int32 ``_masked_confmat`` (rows: target, columns:
preds). Host reads, never in a ``nan_strategy="replace"`` update:
``nan_strategy="drop"``'s boolean index (eager by its semantics, never
captured), ``_infer_num_classes``, which runs in the functional calls
without ``num_classes`` and once per column pair in the ``*_matrix``
functions, and the bias correction's degenerate flag, which Cramer's V and
Tschuprow's T read in their compute to warn, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.functional.classification.stat_scores import _masked_confmat
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[float]) -> None:
    if nan_strategy not in ["replace", "drop"]:
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (float, int)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _handle_nan_in_data(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tuple[Tensor, Tensor]:
    """Replace NaNs (no host read), or drop the rows holding one (a boolean
    index, which reads the host)."""
    if nan_strategy == "replace":
        if preds.is_floating_point():
            preds = torch.nan_to_num(preds, nan=nan_replace_value)
        if target.is_floating_point():
            target = torch.nan_to_num(target, nan=nan_replace_value)
        return preds, target
    p_nan = torch.isnan(preds) if preds.is_floating_point() else torch.zeros_like(preds, dtype=torch.bool)
    t_nan = torch.isnan(target) if target.is_floating_point() else torch.zeros_like(target, dtype=torch.bool)
    keep = ~(p_nan | t_nan)
    return preds[keep], target[keep]


def _effective_shape(confmat: Tensor) -> Tuple[Tensor, Tensor]:
    """Numbers of non-empty rows and columns, as float32 tensors."""
    rows = torch.sum(confmat.sum(dim=1) > 0)
    cols = torch.sum(confmat.sum(dim=0) > 0)
    return rows.to(torch.float32), cols.to(torch.float32)


def _compute_expected_freqs(confmat: Tensor) -> Tensor:
    """Outer product of the marginals over the total."""
    margin_rows = confmat.sum(dim=1)
    margin_cols = confmat.sum(dim=0)
    total = confmat.sum()
    return margin_rows[:, None] * margin_cols[None, :] / torch.where(total > 0, total, 1.0)


def _compute_chi_squared(confmat: Tensor, bias_correction: bool) -> Tensor:
    """Chi-squared independence statistic, with Yates' continuity
    correction at one (effective) degree of freedom when asked; cells of
    zero expected frequency add exactly zero."""
    confmat = confmat.to(torch.float32)
    expected = _compute_expected_freqs(confmat)
    rows_eff, cols_eff = _effective_shape(confmat)
    df = (rows_eff - 1) * (cols_eff - 1)

    if bias_correction:
        diff = expected - confmat
        direction = torch.sign(diff)
        corrected = confmat + direction * torch.clamp(torch.abs(diff), max=0.5)
        confmat = torch.where(df == 1, corrected, confmat)

    positive = expected > 0
    safe_expected = torch.where(positive, expected, 1.0)
    chi = torch.sum(torch.where(positive, (confmat - expected) ** 2 / safe_expected, 0.0))
    return torch.where(df == 0, 0.0, chi)


def _compute_phi_squared_corrected(
    phi_squared: Tensor, num_rows: Tensor, num_cols: Tensor, confmat_sum: Tensor
) -> Tensor:
    """Bias-corrected phi squared."""
    return torch.clamp(phi_squared - ((num_rows - 1) * (num_cols - 1)) / (confmat_sum - 1), min=0.0)


def _compute_rows_and_cols_corrected(
    num_rows: Tensor, num_cols: Tensor, confmat_sum: Tensor
) -> Tuple[Tensor, Tensor]:
    """Bias-corrected row and column counts."""
    rows_corrected = num_rows - (num_rows - 1) ** 2 / (confmat_sum - 1)
    cols_corrected = num_cols - (num_cols - 1) ** 2 / (confmat_sum - 1)
    return rows_corrected, cols_corrected


def _compute_bias_corrected_values(
    phi_squared: Tensor, num_rows: Tensor, num_cols: Tensor, confmat_sum: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Bias-corrected phi squared and effective row and column counts."""
    phi_squared_corrected = _compute_phi_squared_corrected(phi_squared, num_rows, num_cols, confmat_sum)
    rows_corrected, cols_corrected = _compute_rows_and_cols_corrected(num_rows, num_cols, confmat_sum)
    return phi_squared_corrected, rows_corrected, cols_corrected


def _infer_num_classes(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> int:
    """The class space sized from the data: the largest label after NaN
    handling, plus one, at least 2. Reads the host once."""
    preds, target = _handle_nan_in_data(preds, target, nan_strategy, nan_replace_value)
    return max(int(torch.maximum(preds.max(), target.max())) + 1, 2)


def _unable_to_use_bias_correction_warning(metric_name: str) -> None:
    rank_zero_warn(
        f"Unable to compute {metric_name} using bias correction. Please consider to set `bias_correction=False`."
    )


def _nominal_confmat(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """int32 contingency table of two nominal series (2-D inputs are
    argmaxed first); labels outside ``[0, num_classes)`` drop their row."""
    preds = preds.argmax(1) if preds.ndim == 2 else preds
    target = target.argmax(1) if target.ndim == 2 else target
    preds, target = _handle_nan_in_data(preds, target, nan_strategy, nan_replace_value)
    p = preds.to(torch.int64)
    t = target.to(torch.int64)
    return _masked_confmat(p, t, torch.ones_like(p, dtype=torch.int32), num_classes)
