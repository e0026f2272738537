"""Group fairness: per-group rates of tp/fp/tn/fn, demographic parity and
equal opportunity (port of
``tpumetrics/functional/classification/group_fairness.py``).

The per-group counts are one int32 histogram: each valid sample falls into
bucket ``4 * group + kind`` (kind 0..3 for tp, fp, tn, fn) of a fixed
``(4 * num_groups + 1,)`` buffer through ``_bincount(..., minlength=...)``,
an ``index_add_`` with no host read. The JAX package counts them as the
int32 product ``one_hot(groups).T @ indicators``; torch has no CUDA kernel
for an int32 matmul, so that form would run on the CPU and fail on a card.
A group id outside ``[0, num_groups)`` has an all-zero one-hot row there and
goes to the dropped sentinel bucket here: neither counts it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tpumetrics_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
)
from tpumetrics_torch.utils.checks import _is_capturing
from tpumetrics_torch.utils.compute import _safe_divide
from tpumetrics_torch.utils.data import _bincount
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

_STATS = ("tp", "fp", "tn", "fn")
_FAIRNESS_TASKS = ("demographic_parity", "equal_opportunity", "all")


def _groups_validation(groups: Tensor, num_groups: int) -> None:
    """The largest group id (read on the host; skipped inside a CUDA graph
    capture) and an integer dtype."""
    if _is_capturing():
        return
    if int(torch.max(groups)) > num_groups:
        raise ValueError(
            f"The largest number in the groups tensor is {int(torch.max(groups))}, which is larger than the specified"
            f" number of groups {num_groups}. The group identifiers should be ``0, 1, ..., (num_groups - 1)``."
        )
    if groups.is_floating_point() or groups.is_complex() or groups.dtype == torch.bool:
        raise ValueError(f"Expected dtype of argument groups to be int, not {groups.dtype}.")


def _fairness_task_validation(task: str) -> None:
    if task not in _FAIRNESS_TASKS:
        raise ValueError(
            f"Expected argument `task` to either be ``demographic_parity``,"
            f"``equal_opportunity`` or ``all`` but got {task}."
        )


def _binary_groups_stat_scores(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Per-group int32 counts, ``(num_groups, 4)``: columns tp, fp, tn, fn."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    preds, target, mask = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    p, t, m = preds.reshape(-1), target.reshape(-1), mask.reshape(-1)
    g = groups.reshape(-1).long()
    kind = torch.where(p == 1, 1 - t, 2 + t)  # tp 0, fp 1 | tn 2, fn 3
    counted = (m == 1) & ((p == 0) | (p == 1)) & ((t == 0) | (t == 1))
    key = torch.where(counted, 4 * g + kind, -1)
    key = torch.where((g >= 0) & (g < num_groups), key, -1)
    return _bincount(key, minlength=4 * num_groups).reshape(num_groups, 4)


def _groups_reduce(stats: Tensor) -> Dict[str, Tensor]:
    """Each group's tp/fp/tn/fn over its own total (0/0 is NaN, as in the JAX package)."""
    rates = stats / stats.sum(dim=1, keepdim=True)
    return {f"group_{group}": rates[group] for group in range(stats.shape[0])}


def _groups_stat_transform(stats: Tensor) -> Dict[str, Tensor]:
    """The ``(num_groups, 4)`` counts as ``{"tp": (G,), "fp": ..., "tn": ..., "fn": ...}``."""
    return {name: stats[:, i] for i, name in enumerate(_STATS)}


def binary_groups_stat_rates(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """tp/fp/tn/fn rates by group.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_groups_stat_rates
        >>> preds = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> groups = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> {k: v.tolist() for k, v in binary_groups_stat_rates(preds, target, groups, 2).items()}
        {'group_0': [0.0, 0.0, 1.0, 0.0], 'group_1': [1.0, 0.0, 0.0, 0.0]}
    """
    stats = _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    return _groups_reduce(stats)


def _infer_num_groups(groups: Tensor) -> int:
    """``max(groups) + 1``, read on the host."""
    return int(torch.max(groups)) + 1


def _min_max_ratio_entry(prefix: str, rates: Tensor) -> Dict[str, Tensor]:
    """``{f"{prefix}_{argmin}_{argmax}": min / max}``; the key is read on the host."""
    min_id = int(torch.argmin(rates))
    max_id = int(torch.argmax(rates))
    return {f"{prefix}_{min_id}_{max_id}": _safe_divide(rates[min_id], rates[max_id])}


def _compute_binary_demographic_parity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """The lowest over the highest positive rate of the groups."""
    return _min_max_ratio_entry("DP", _safe_divide(tp + fp, tp + fp + tn + fn))


def _compute_binary_equal_opportunity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """The lowest over the highest true positive rate of the groups."""
    return _min_max_ratio_entry("EO", _safe_divide(tp, tp + fn))


def _fairness_compute(stats: Tensor, task: str) -> Dict[str, Tensor]:
    """The entries of ``task`` from the per-group counts."""
    transformed = _groups_stat_transform(stats)
    out: Dict[str, Tensor] = {}
    if task in ("demographic_parity", "all"):
        out.update(_compute_binary_demographic_parity(**transformed))
    if task in ("equal_opportunity", "all"):
        out.update(_compute_binary_equal_opportunity(**transformed))
    return out


def demographic_parity(
    preds: Tensor,
    groups: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Positive-rate parity between groups.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import demographic_parity
        >>> preds = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> groups = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> {k: round(float(v), 4) for k, v in demographic_parity(preds, groups).items()}
        {'DP_0_1': 0.0}
    """
    target = torch.zeros_like(preds, dtype=torch.int32)
    stats = _binary_groups_stat_scores(
        preds, target, groups, _infer_num_groups(groups), threshold, ignore_index, validate_args
    )
    return _fairness_compute(stats, "demographic_parity")


def equal_opportunity(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """True-positive-rate parity between groups.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import equal_opportunity
        >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> groups = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> {k: round(float(v), 4) for k, v in equal_opportunity(preds, target, groups).items()}
        {'EO_0_1': 0.0}
    """
    stats = _binary_groups_stat_scores(
        preds, target, groups, _infer_num_groups(groups), threshold, ignore_index, validate_args
    )
    return _fairness_compute(stats, "equal_opportunity")


def binary_fairness(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    task: str = "all",
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    num_groups: Optional[int] = None,
) -> Dict[str, Tensor]:
    """Demographic parity and/or equal opportunity; ``num_groups`` defaults
    to ``max(groups) + 1``, read on the host.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_fairness
        >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> groups = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> sorted(binary_fairness(preds, target, groups).keys())
        ['DP_0_1', 'EO_0_1']
    """
    _fairness_task_validation(task)
    if task == "demographic_parity":
        if target is not None:
            rank_zero_warn("The task demographic_parity does not require a target.", UserWarning)
        target = torch.zeros_like(preds, dtype=torch.int32)
    num_groups = _infer_num_groups(groups) if num_groups is None else num_groups
    stats = _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    return _fairness_compute(stats, task)
