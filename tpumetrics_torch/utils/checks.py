"""Input checks (counterpart of ``tpumetrics/utils/checks.py``).

The value checks copy to the host by design; callers skip them with
``validate_args=False``. Inside a CUDA graph capture they are skipped as the
JAX package skips them under ``jit`` (``_is_capturing`` stands for its
``_is_tracer``); the shape and dtype checks still run.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor


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


def check_forward_full_state_property(
    metric_class: type,
    init_args: Optional[Dict[str, Any]] = None,
    input_args: Optional[Dict[str, Any]] = None,
    num_update_to_compare: Sequence[int] = (10, 100, 1000),
    reps: int = 5,
) -> None:
    """Time ``forward`` with ``full_state_update=True`` against ``False``.

    A developer's profiling tool: runs both variants for each update count,
    prints the timings and a recommendation for the class's
    ``full_state_update`` flag (the same recommendation when the two
    variants' outputs differ: ``True``).

    Example:
        >>> from tpumetrics_torch.regression import MeanSquaredError
        >>> import torch
        >>> check_forward_full_state_property(
        ...     MeanSquaredError, init_args={"device": "cpu"},
        ...     input_args={"preds": torch.ones(4), "target": torch.zeros(4)},
        ...     num_update_to_compare=(2,), reps=1,
        ... )  # doctest: +ELLIPSIS
        Timings using full_state_update=True / False:
          2 updates: full=...
        Recommended setting: `full_state_update=...`
    """
    init_args = init_args or {}
    input_args = input_args or {}

    class FullState(metric_class):  # type: ignore[misc,valid-type]
        full_state_update = True

    class PartState(metric_class):  # type: ignore[misc,valid-type]
        full_state_update = False

    fullstate = FullState(**init_args)
    partstate = PartState(**init_args)

    equal = True
    try:
        for _ in range(num_update_to_compare[0]):
            out1 = fullstate(**input_args)
            out2 = partstate(**input_args)
        equal = equal and bool(torch.allclose(torch.as_tensor(out1), torch.as_tensor(out2)))
    except Exception:  # any failure of either variant means the two cannot be compared
        equal = False

    res = torch.zeros((2, len(num_update_to_compare), reps), dtype=torch.float64)
    for i, metric in enumerate([fullstate, partstate]):
        for j, t in enumerate(num_update_to_compare):
            for r in range(reps):
                metric.reset()
                start = time.perf_counter()
                for _ in range(t):
                    _ = metric(**input_args)
                metric.compute()
                if metric.device.type == "cuda":
                    torch.cuda.synchronize(metric.device)
                res[i, j, r] = time.perf_counter() - start

    mean = res.mean(dim=-1)
    std = res.std(dim=-1) if reps > 1 else torch.zeros_like(mean)
    print("Timings using full_state_update=True / False:")
    for j, t in enumerate(num_update_to_compare):
        print(
            f"  {t} updates: full={float(mean[0, j]):.4f}s±{float(std[0, j]):.4f} "
            f"partial={float(mean[1, j]):.4f}s±{float(std[1, j]):.4f}"
        )
    faster = bool(mean[1, -1] < mean[0, -1])
    if not equal:
        print(
            "Output of the metric differs between full_state_update=True and False; "
            "the recommendation is to set the flag to True."
        )
    else:
        print(f"Recommended setting: `full_state_update={not faster}`")


# ------------------------------------------------------- retrieval inputs


def _check_retrieval_target_and_prediction_types(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Dtype checks, then float32 and flat. The binary-values check reads
    the host once (one ``bool`` of the batch); it is skipped while a CUDA
    graph is captured, as the JAX package skips it under ``jit``."""
    if target.is_complex():
        raise ValueError("`target` must be a tensor of booleans, integers or floats")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    target = target.to(torch.float32)
    if not allow_non_binary_target and not _is_capturing() and bool(((target > 1) | (target < 0)).any()):
        raise ValueError("`target` must contain `binary` values")
    return preds.to(torch.float32).reshape(-1), target.reshape(-1)


def _check_retrieval_functional_inputs(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Shape and dtype checks of the single-query retrieval functions."""
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.numel() == 0 or preds.ndim == 0:
        raise ValueError("`preds` and `target` must be non-empty and non-scalar tensors")
    return _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)


def _check_retrieval_inputs(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """Shape and dtype checks of a batched retrieval update.

    Returns ``(indexes, preds, target, keep)``: flat int32 indexes, float32
    preds and targets, and, with ``ignore_index``, the mask of the rows to
    keep (rows whose target is ``ignore_index`` are not dropped here: a list
    state's append drops them, a MaskedBuffer routes them to its dump row).
    """
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if indexes.is_floating_point() or indexes.is_complex() or indexes.dtype == torch.bool:
        raise ValueError("`indexes` must be a tensor of long integers")
    if indexes.numel() == 0 or indexes.ndim == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")

    keep = None
    if ignore_index is not None:
        ignored = target == ignore_index
        keep = (~ignored).reshape(-1)
        # the binary-values check sees the kept rows only (ignore_index itself may lie outside [0, 1])
        target = torch.where(ignored, torch.zeros_like(target), target)

    preds, target = _check_retrieval_target_and_prediction_types(
        preds, target, allow_non_binary_target=allow_non_binary_target
    )
    return indexes.reshape(-1).to(torch.int32), preds, target, keep
