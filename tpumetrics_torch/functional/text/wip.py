"""Word information preserved (port of ``tpumetrics/functional/text/wip.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from tpumetrics_torch.functional.text.helper import _edit_distance, _normalize_inputs
from tpumetrics_torch.metric import _resolve_device

Tensor = torch.Tensor


def _wip_update(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """The sum of (edit distance - longer length), minus the word hits, and
    the reference and prediction word totals (float32)."""
    preds, target = _normalize_inputs(preds, target)
    errors = 0
    total = 0
    target_total = 0
    preds_total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = pred.split()
        target_tokens = tgt.split()
        errors += _edit_distance(pred_tokens, target_tokens)
        target_total += len(target_tokens)
        preds_total += len(pred_tokens)
        total += max(len(target_tokens), len(pred_tokens))
    return (
        torch.tensor(errors - total, dtype=torch.float32, device=device),
        torch.tensor(target_total, dtype=torch.float32, device=device),
        torch.tensor(preds_total, dtype=torch.float32, device=device),
    )


def _wip_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    """WIP = (H / N_target)(H / N_preds)."""
    return (errors / target_total) * (errors / preds_total)


def word_information_preserved(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """Word information preserved of transcriptions.

    Example:
        >>> from tpumetrics_torch.functional.text import word_information_preserved
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_preserved(preds, target, device="cpu")), 4)
        0.3472
    """
    errors, target_total, preds_total = _wip_update(preds, target, _resolve_device(device))
    return _wip_compute(errors, target_total, preds_total)
