"""Input checks (counterpart of ``tpumetrics/utils/checks.py``).

The value checks copy to the host by design; callers skip them with
``validate_args=False``. Inside a CUDA graph capture they are skipped as the
JAX package skips them under ``jit`` (``_is_capturing`` stands for its
``_is_tracer``); the shape and dtype checks still run.
"""

from __future__ import annotations

from typing import Optional

import torch


def _is_capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph, where nothing may
    be read on the host."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Check that predictions and target have the same shape."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _check_binary_values(x: torch.Tensor, name: str, ignore_index: Optional[int] = None) -> None:
    """Check that ``x`` holds only 0, 1 and ``ignore_index`` (binary and multilabel targets and label preds)."""
    if _is_capturing():
        return
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    bad = [v for v in torch.unique(x).tolist() if v not in allowed]
    if bad:
        raise RuntimeError(
            f"Detected the following values in `{name}`: {bad} but expected only"
            f" the following values {sorted(allowed)}."
        )


def _check_task_size(name: str, value: Optional[int]) -> int:
    """The ``num_classes`` / ``num_labels`` a task-string dispatcher needs."""
    if not isinstance(value, int):
        raise ValueError(f"`{name}` is expected to be `int` but `{type(value)} was passed.`")
    return value
