"""Permutation invariant training (port of ``tpumetrics/functional/audio/pit.py``).

The best speaker permutation comes from an exhaustive search over all
permutations on the device (gathers of the metric matrix, no host read) or,
for 3 speakers and more outside a CUDA graph capture, from the Hungarian
assignment on the host (``scipy.optimize.linear_sum_assignment``), which
reads the metric matrix back by its semantics. Under capture the search is
exhaustive up to 6 speakers, and more raise, as under ``jit`` in the JAX
package. The two searches may pick different permutations on ties; the
best metric is the same.
"""

from __future__ import annotations

import math
from itertools import permutations
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from tpumetrics_torch.utils.checks import _is_capturing

Tensor = torch.Tensor

_ps_dict: Dict[int, np.ndarray] = {}  # host cache of the permutations, per speaker count
_ps_device: Dict[Tuple[int, torch.device], Tensor] = {}  # their device copies, made outside a capture


def _perm_array(spk_num: int) -> np.ndarray:
    if spk_num not in _ps_dict:
        _ps_dict[spk_num] = np.asarray(list(permutations(range(spk_num))), np.int64).reshape(-1, spk_num)
    return _ps_dict[spk_num]


def _decode_permutations(spk_num: int, device: torch.device) -> Tensor:
    """All permutations in ``itertools.permutations`` order, decoded from
    their index (its factorial-base digits pick among the unused speakers)
    with device ops only: what a capture can record, where a copy from the
    host cannot be."""
    num = math.factorial(spk_num)
    idx = torch.arange(num, device=device)
    unused = torch.ones(num, spk_num, dtype=torch.int64, device=device)
    cols = []
    for k in range(spk_num):
        digit = (idx // math.factorial(spk_num - 1 - k)) % (spk_num - k)
        # the (digit + 1)-th unused speaker: the first position whose running count of unused ones reaches it
        pick = torch.argmax(((torch.cumsum(unused, dim=1) == (digit + 1)[:, None]) & (unused == 1)).to(torch.int32), dim=1)
        cols.append(pick)
        unused = unused.scatter(1, pick[:, None], 0)
    return torch.stack(cols, dim=1)


def _gen_permutations(spk_num: int, device: torch.device) -> Tensor:
    """All speaker permutations, ``(spk_num!, spk_num)`` int64 on ``device``:
    copied from the host cache once per device outside a capture, and
    decoded on the device under one."""
    key = (spk_num, torch.device(device))
    if key in _ps_device:
        return _ps_device[key]
    if _is_capturing():
        return _decode_permutations(spk_num, device)
    _ps_device[key] = torch.from_numpy(_perm_array(spk_num)).to(device)
    return _ps_device[key]


def _find_best_perm_by_linear_sum_assignment(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """Hungarian assignment on the host: it reads the metric matrix back."""
    from scipy.optimize import linear_sum_assignment

    mmtx = metric_mtx.detach().cpu().numpy()
    best_perm = np.asarray([linear_sum_assignment(pwm, eval_func == "max")[1] for pwm in mmtx], np.int64)
    best_perm_t = torch.from_numpy(best_perm).to(metric_mtx.device)
    best_metric = torch.take_along_dim(metric_mtx, best_perm_t[:, :, None], dim=2).mean(dim=(-1, -2))
    return best_metric, best_perm_t


def _find_best_perm_by_exhaustive_method(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """Exhaustive search over all permutations, by gathers on the device."""
    batch_size, spk_num = metric_mtx.shape[:2]
    ps = _gen_permutations(spk_num, metric_mtx.device)  # (perm_num, spk)
    perm_num = ps.shape[0]
    bps = ps.T[None, ...].expand(batch_size, spk_num, perm_num)
    metric_of_ps = torch.gather(metric_mtx, 2, bps).mean(dim=1)  # (batch, perm_num)
    if eval_func == "max":
        best_metric, best_indexes = torch.max(metric_of_ps, dim=1)
    else:
        best_metric, best_indexes = torch.min(metric_of_ps, dim=1)
    return best_metric, ps[best_indexes, :]


def permutation_invariant_training(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """Evaluate ``metric_func`` under the best speaker permutation: returns
    the best metric per sample and the permutation, ``(batch, spk)`` int64.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.audio import permutation_invariant_training
        >>> from tpumetrics_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> target = torch.randn(2, 2, 100, generator=torch.Generator().manual_seed(1))
        >>> preds = target.flip(1) + 0.1 * torch.randn(2, 2, 100, generator=torch.Generator().manual_seed(2))
        >>> best_metric, best_perm = permutation_invariant_training(
        ...     preds, target, scale_invariant_signal_distortion_ratio)
        >>> best_perm.tolist()  # swapped speakers are recovered
        [[1, 0], [1, 0]]
    """
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ["speaker-wise", "permutation-wise"]:
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    spk_num = target.shape[1]

    if mode == "permutation-wise":
        perms = _gen_permutations(spk_num, preds.device)
        # each permutation's speakers by slices: no index copied to the device
        metric_of_ps = torch.stack(
            [
                metric_func(torch.stack([preds[:, j] for j in perm], dim=1), target, **kwargs)
                for perm in _perm_array(spk_num).tolist()
            ],
            dim=1,
        )
        if eval_func == "max":
            best_metric, best_indexes = torch.max(metric_of_ps, dim=1)
        else:
            best_metric, best_indexes = torch.min(metric_of_ps, dim=1)
        return best_metric, perms[best_indexes, :]

    # speaker-wise: the (batch, target_spk, pred_spk) metric matrix
    metric_mtx = torch.stack(
        [
            torch.stack([metric_func(preds[:, p, ...], target[:, t, ...], **kwargs) for p in range(spk_num)], dim=1)
            for t in range(spk_num)
        ],
        dim=1,
    )

    if spk_num < 3:
        return _find_best_perm_by_exhaustive_method(metric_mtx, eval_func)
    if _is_capturing():
        # the Hungarian assignment reads the host; under capture the exhaustive search stands in while tractable
        if spk_num <= 6:
            return _find_best_perm_by_exhaustive_method(metric_mtx, eval_func)
        raise ValueError(
            "permutation_invariant_training with more than 6 speakers uses a host-side Hungarian"
            " assignment and cannot run under a CUDA graph capture; call it eagerly."
        )
    return _find_best_perm_by_linear_sum_assignment(metric_mtx, eval_func)


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """Reorder ``preds`` ``(batch, spk, ...)`` by the best permutation from
    :func:`permutation_invariant_training`."""
    index = perm.to(torch.int64).reshape(perm.shape + (1,) * (preds.ndim - 2))
    return torch.take_along_dim(preds, index, dim=1)
