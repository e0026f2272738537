"""Input checks (counterpart of ``tpumetrics/utils/checks.py``)."""

from __future__ import annotations

import torch


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Check that predictions and target have the same shape."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
