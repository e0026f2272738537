"""Word error rate (port of ``tpumetrics/functional/text/wer.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from tpumetrics_torch.functional.text.helper import _edit_distance, _normalize_inputs
from tpumetrics_torch.metric import _resolve_device

Tensor = torch.Tensor


def _wer_update(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor]:
    """Word-level edit distances and reference word counts, summed (float32)."""
    preds, target = _normalize_inputs(preds, target)
    errors = 0
    total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = pred.split()
        tgt_tokens = tgt.split()
        errors += _edit_distance(pred_tokens, tgt_tokens)
        total += len(tgt_tokens)
    return (
        torch.tensor(errors, dtype=torch.float32, device=device),
        torch.tensor(total, dtype=torch.float32, device=device),
    )


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def word_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """Word error rate of transcriptions.

    Example:
        >>> from tpumetrics_torch.functional.text import word_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_error_rate(preds, target, device="cpu")), 4)
        0.5
    """
    errors, total = _wer_update(preds, target, _resolve_device(device))
    return _wer_compute(errors, total)
