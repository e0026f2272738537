"""Tweedie deviance score (port of
``tpumetrics/functional/regression/tweedie_deviance.py``).

The domain checks of each power regime read the inputs on the host. They
run in an eager update and are skipped while a CUDA graph is being
captured, as the JAX package skips them under ``jit``: a captured (and
replayed) update reads nothing on the host.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from tpumetrics_torch.utils.checks import _check_same_shape, _is_capturing
from tpumetrics_torch.utils.compute import _safe_xlogy

Tensor = torch.Tensor


def _check_power_domain(preds: Tensor, targets: Tensor, power: float) -> None:
    """The inputs each power regime needs (reads the inputs on the host)."""
    preds_nonpositive = bool(torch.any(preds <= 0))
    if power == 1 and (preds_nonpositive or bool(torch.any(targets < 0))):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
    if power == 2 and (preds_nonpositive or bool(torch.any(targets <= 0))):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
    if power < 0 and preds_nonpositive:
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
    if 1 < power < 2 and (preds_nonpositive or bool(torch.any(targets < 0))):
        raise ValueError(f"For power={power}, 'targets' has to be strictly positive and 'preds' cannot be negative.")
    if power > 2 and (preds_nonpositive or bool(torch.any(targets <= 0))):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")


def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, Tensor]:
    """Sum of the unit deviances and the element count (an int32 tensor)."""
    _check_same_shape(preds, targets)
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")
    if power != 0 and not _is_capturing():
        _check_power_domain(preds, targets, power)

    if power == 0:
        deviance_score = torch.pow(targets - preds, 2)
    elif power == 1:  # Poisson
        deviance_score = 2 * (_safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:  # Gamma
        deviance_score = 2 * (torch.log(preds / targets) + (targets / preds) - 1)
    else:
        term_1 = torch.pow(torch.clamp(targets, min=0), 2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * torch.pow(preds, 1 - power) / (1 - power)
        term_3 = torch.pow(preds, 2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)
    # the count filled on the device: a kernel a CUDA graph can capture (a
    # tensor made from a host value would be a copy from pageable memory)
    return torch.sum(deviance_score), torch.full((), targets.numel(), dtype=torch.int32, device=targets.device)


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Union[int, Tensor]) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tensor:
    """Tweedie deviance score at the given power.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.regression import tweedie_deviance_score
        >>> targets = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([4.0, 3.0, 2.0, 1.0])
        >>> round(float(tweedie_deviance_score(preds, targets, power=2)), 4)
        1.2083
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
