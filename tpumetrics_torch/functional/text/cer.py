"""Character error rate (port of ``tpumetrics/functional/text/cer.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from tpumetrics_torch.functional.text.helper import _edit_distance, _normalize_inputs
from tpumetrics_torch.metric import _resolve_device

Tensor = torch.Tensor


def _cer_update(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor]:
    """Character-level edit distances and reference character counts, summed (float32)."""
    preds, target = _normalize_inputs(preds, target)
    errors = 0
    total = 0
    for pred, tgt in zip(preds, target):
        errors += _edit_distance(list(pred), list(tgt))
        total += len(tgt)
    return (
        torch.tensor(errors, dtype=torch.float32, device=device),
        torch.tensor(total, dtype=torch.float32, device=device),
    )


def _cer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def char_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """Character error rate of transcriptions.

    Example:
        >>> from tpumetrics_torch.functional.text import char_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(char_error_rate(preds, target, device="cpu")), 4)
        0.3415
    """
    errors, total = _cer_update(preds, target, _resolve_device(device))
    return _cer_compute(errors, total)
