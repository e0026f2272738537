"""Precision-recall curves, binned multiclass path (port of
``tpumetrics/functional/classification/precision_recall_curve.py``).

The binned state (``thresholds`` = int, list or tensor) is a ``(T, [C,] 2,
2)`` int32 confusion tensor. Its update dispatches on the device: on a CUDA
tensor the hand-written kernel ``binned_confusion_counts`` computes the
threshold-by-class counts; on a CPU tensor the JAX package's choice between
the contraction and the bucketed histogram stands. The exact path
(``thresholds=None``) needs list states and is not in the port yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from tpumetrics_torch.ops.binned_confusion import binned_confusion_counts
from tpumetrics_torch.utils.compute import EXACT_F32_COUNT, _safe_divide, interp, normalize_logits_if_needed
from tpumetrics_torch.utils.data import _bincount, _one_hot

Tensor = torch.Tensor
Thresholds = Optional[Union[int, List[float], Tensor]]

_EXACT_PATH_TODO = (
    "thresholds=None (the exact curve over list states) is not ported yet: see ROADMAP.md, Queue 1, "
    "'thresholds=None and MaskedBuffer'. Pass an int, a list or a tensor of thresholds."
)


def _adjust_threshold_arg(thresholds: Thresholds = None, device: Optional[torch.device] = None) -> Optional[Tensor]:
    """int -> the ``jnp.linspace(0, 1, T)`` grid bit for bit; list -> float32
    tensor; tensor -> float32 on ``device``; None passes through.

    ``torch.linspace`` differs from ``jnp.linspace`` in the last bit of many
    values, and ties with a threshold count as positive, so the grid is
    ``arange(T) * (1 / (T - 1))`` in float32 with the last value set to 1,
    which is how ``jnp.linspace`` rounds.
    """
    if isinstance(thresholds, int):
        if thresholds == 1:
            return torch.zeros(1, dtype=torch.float32, device=device)
        one = torch.tensor(1.0, dtype=torch.float32, device=device)
        grid = torch.arange(thresholds, dtype=torch.float32, device=device) * (one / (thresholds - 1))
        grid[-1] = 1.0
        return grid
    if isinstance(thresholds, list):
        return torch.tensor(thresholds, dtype=torch.float32, device=device)
    if isinstance(thresholds, Tensor):
        return thresholds.to(device=device, dtype=torch.float32)
    return thresholds


def _binary_precision_recall_curve_arg_validation(
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if thresholds is not None and not isinstance(thresholds, (list, int, Tensor)):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or"
            f" tensor of floats, but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(
            f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}"
        )
    if isinstance(thresholds, list) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(
            "If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range,"
            f" but got {thresholds}"
        )
    if isinstance(thresholds, Tensor) and thresholds.ndim != 1:
        raise ValueError("If argument `thresholds` is an tensor, expected the tensor to be 1d")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _confusion_from_counts(tp: Tensor, predpos: Tensor, npos: Tensor, nvalid: Union[Tensor, float]) -> Tensor:
    """(T, C, 2, 2) int32 confusion tensor ``[t, c, y, p]`` from the
    threshold-by-class counts: the fp/fn/tn derivation shared by the kernel
    and the contraction path (float counts are rounded first)."""
    fp = predpos - tp
    fn = npos[None, :] - tp
    tn = nvalid - predpos - fn
    conf = torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)
    if conf.is_floating_point():
        conf = torch.round(conf)
    return conf.to(torch.int32)


def _binned_confusion_tensor(
    preds: Tensor,
    target_bits: Tensor,
    thresholds: Tensor,
    invalid: Optional[Tensor] = None,
) -> Tensor:
    """Multi-threshold confusion tensor.

    ``preds``/``target_bits`` are ``(N,)`` or ``(N, C)``; ``invalid`` (same
    shape) masks positions out of every count. Returns ``(T, 2, 2)`` or
    ``(T, C, 2, 2)`` int32 indexed ``[t, (c,) y, p]`` in the caller's
    threshold order.

    On a CUDA tensor the kernel computes ``tp`` and ``predpos`` whatever the
    shape; it never builds the ``(N, C, T)`` comparison. On a CPU tensor the
    JAX package's branch stands: the contraction below 2^24 samples and 2^26
    comparison elements, else the O(N·C)-memory histogram.
    """
    squeeze = preds.ndim == 1
    if squeeze:
        preds = preds[:, None]
        target_bits = target_bits[:, None]
        if invalid is not None:
            invalid = invalid[:, None]
    n = preds.shape[0]
    if preds.device.type == "cuda":
        conf = _binned_confusion_kernel(preds, target_bits, thresholds, invalid)
    elif n < EXACT_F32_COUNT and n * preds.shape[1] * thresholds.shape[0] <= (1 << 26):
        conf = _binned_confusion_contract(preds, target_bits, thresholds, invalid)
    else:
        conf = _binned_confusion_hist(preds, target_bits, thresholds, invalid)
    return conf[:, 0] if squeeze else conf


def _binned_confusion_kernel(
    preds: Tensor,
    target_bits: Tensor,
    thresholds: Tensor,
    invalid: Optional[Tensor],
) -> Tensor:
    """CUDA path: ``tp``/``predpos`` from the kernel, exact int32."""
    if invalid is None:
        v = torch.ones(preds.shape, dtype=torch.float32, device=preds.device)
    else:
        v = (~invalid).to(torch.float32)
    y = target_bits.to(torch.float32) * v
    tp, predpos = binned_confusion_counts(
        preds.to(torch.float32).contiguous(), y, v, thresholds.to(torch.float32).contiguous()
    )
    npos = y.sum(dim=0, dtype=torch.int64)
    nvalid = v.sum(dim=0, dtype=torch.int64)[None, :]
    return _confusion_from_counts(tp.to(torch.int64), predpos.to(torch.int64), npos, nvalid)


def _binned_confusion_contract(
    preds: Tensor,
    target_bits: Tensor,
    thresholds: Tensor,
    invalid: Optional[Tensor],
) -> Tensor:
    """tp/fp/fn/tn as one batched contraction over the sample axis; exact
    because every partial sum is an integer below 2^24 in float32. Autocast
    is off so a bf16 autocast region cannot round the counts."""
    n = preds.shape[0]
    with torch.autocast(device_type=preds.device.type, enabled=False):
        pos = (preds[:, :, None] >= thresholds[None, None, :]).to(torch.float32)  # (N, C, T)
        y = target_bits.to(torch.float32)
        if invalid is not None:
            v = 1.0 - invalid.to(torch.float32)
            y = y * v
            predpos = torch.einsum("nct,nc->tc", pos, v)
            nvalid: Union[Tensor, float] = torch.sum(v, dim=0)[None, :]
        else:
            predpos = torch.sum(pos, dim=0).T  # (T, C)
            nvalid = float(n)
        tp = torch.einsum("nct,nc->tc", pos, y)
        npos = torch.sum(y, dim=0)
    return _confusion_from_counts(tp, predpos, npos, nvalid)


def _binned_confusion_hist(
    preds: Tensor,
    target_bits: Tensor,
    thresholds: Tensor,
    invalid: Optional[Tensor],
) -> Tensor:
    """O(N·C)-memory path: bucket each pred into the sorted threshold grid
    (``pred >= thr[t]`` ⇔ ``bucket > t`` when buckets count thresholds
    ``<= pred``), histogram per (class, target bit), one cumulative sum."""
    len_t = thresholds.shape[0]
    num_cols = preds.shape[1]
    order = torch.argsort(thresholds, stable=True)
    sorted_thr = thresholds[order].contiguous()
    idx = torch.searchsorted(sorted_thr, preds.contiguous(), right=True)
    # `NaN >= thr` is False: NaN preds go below every threshold
    idx = torch.where(torch.isnan(preds), 0, idx)
    col = torch.arange(num_cols, device=preds.device)[None, :]
    key = idx + (len_t + 1) * (target_bits.to(torch.int64) + 2 * col)
    nbins = (len_t + 1) * 2 * num_cols
    if invalid is not None:
        key = torch.where(invalid, nbins, key)
    hist = _bincount(key, minlength=nbins + 1)[:nbins].reshape(num_cols, 2, len_t + 1)
    cum = torch.cumsum(hist, dim=-1)
    neg = cum[..., :len_t]  # #{pred < thr_sorted[t]} per (class, target bit)
    pos = cum[..., len_t:] - neg  # #{pred >= thr_sorted[t]}
    conf = torch.stack([neg, pos], dim=-1)  # (C, 2, T, 2) = [c, y, t, p]
    return conf.movedim(2, 0)[torch.argsort(order)].to(torch.int32)  # (T, C, 2, 2), caller's order


def _binary_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    """(T, 2, 2) multi-threshold confusion tensor."""
    if thresholds is None:
        raise NotImplementedError(_EXACT_PATH_TODO)
    invalid = None
    if ignore_index is not None:
        invalid = target == ignore_index
        target = torch.where(invalid, 0, target)
    return _binned_confusion_tensor(preds, target, thresholds, invalid)


def _binary_precision_recall_curve_compute(
    state: Tensor,
    thresholds: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor]:
    """(precision, recall, thresholds); precision/recall get the (1, 0) endpoint appended."""
    if thresholds is None:
        raise NotImplementedError(_EXACT_PATH_TODO)
    tps = state[:, 1, 1]
    fps = state[:, 0, 1]
    fns = state[:, 1, 0]
    precision = _safe_divide(tps, tps + fps)
    recall = _safe_divide(tps, tps + fns)
    precision = torch.cat([precision, torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall, torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    return precision, recall, thresholds


def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if average not in (None, "micro", "macro"):
        raise ValueError(f"Expected argument `average` to be one of None, 'micro' or 'macro', but got {average}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Shape and value checks; the value check copies to the host by design."""
    if preds.ndim != target.ndim + 1:
        raise ValueError("Expected `preds` to have one more dimension than `target`")
    if target.is_floating_point():
        raise ValueError("Expected argument `target` to be an int tensor with ground truth labels")
    if not preds.is_floating_point():
        raise ValueError("Expected `preds` to contain floating point values")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to be equal to the number of classes")
    if preds.shape[2:] != target.shape[1:]:
        raise ValueError("Expected the shape of `preds` should be (N, C, ...) and the shape of `target` (N, ...)")
    if target.numel():
        unique_values = torch.unique(target).tolist()
        bad = [v for v in unique_values if (v < 0 or v >= num_classes) and v != ignore_index]
        if bad:
            raise RuntimeError(
                f"Detected the following values in `target`: {bad} but expected only values in [0, {num_classes})"
                f" (ignore_index={ignore_index})."
            )


def _multiclass_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """(N, C, ...) -> (N', C) float32; softmax-if-logits; micro flattens
    one-vs-all. Thresholds land on the device of ``preds``."""
    preds = preds.movedim(1, -1).reshape(-1, num_classes).to(torch.float32)
    target = target.reshape(-1)
    thresholds = _adjust_threshold_arg(thresholds, preds.device)
    if thresholds is None:
        raise NotImplementedError(_EXACT_PATH_TODO)
    preds = normalize_logits_if_needed(preds, "softmax")
    if average == "micro":
        preds = preds.reshape(-1)
        if ignore_index is not None:
            # one-hot with ignored samples marked -1, so the binned update
            # sends all their entries out of every count
            valid = target != ignore_index
            onehot = _one_hot(torch.where(valid, target, 0), num_classes)
            target = torch.where(valid[:, None], onehot, -1).reshape(-1)
        else:
            target = _one_hot(target, num_classes).reshape(-1)
    return preds, target, thresholds


def _multiclass_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """(T, C, 2, 2) confusion tensor ((T, 2, 2) for micro)."""
    if thresholds is None:
        raise NotImplementedError(_EXACT_PATH_TODO)
    if average == "micro":
        # ignored samples were marked -1 by the micro format path
        return _binary_precision_recall_curve_update(
            preds, target, thresholds, -1 if ignore_index is not None else None
        )
    invalid = None
    if ignore_index is not None:
        inv = target == ignore_index
        target = torch.where(inv, 0, target)
        invalid = inv[:, None].expand(preds.shape)
    target_t = _one_hot(target, num_classes)  # (N, C)
    return _binned_confusion_tensor(preds, target_t, thresholds, invalid)


def _multiclass_precision_recall_curve_compute(
    state: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-class curves ``(C, T + 1)``, or one macro curve interpolated onto
    a shared precision grid, or the micro curve."""
    if average == "micro":
        return _binary_precision_recall_curve_compute(state, thresholds)
    if thresholds is None:
        raise NotImplementedError(_EXACT_PATH_TODO)
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    precision = _safe_divide(tps, tps + fps)
    recall = _safe_divide(tps, tps + fns)
    precision = torch.cat([precision, torch.ones((1, num_classes), dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall, torch.zeros((1, num_classes), dtype=recall.dtype, device=recall.device)])
    precision = precision.T
    recall = recall.T

    if average == "macro":
        thres = torch.sort(thresholds.repeat(num_classes)).values
        mean_precision = torch.sort(precision.reshape(-1)).values
        mean_recall = torch.zeros_like(mean_precision)
        for i in range(num_classes):
            mean_recall = mean_recall + interp(mean_precision, precision[i], recall[i])
        return mean_precision, mean_recall / num_classes, thres
    return precision, recall, thresholds


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-class one-vs-rest precision-recall curves over binned thresholds.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_precision_recall_curve
        >>> preds = torch.tensor([[0.75, 0.05, 0.05], [0.05, 0.75, 0.05], [0.05, 0.05, 0.75]])
        >>> target = torch.tensor([0, 1, 2])
        >>> precision, recall, thresholds = multiclass_precision_recall_curve(
        ...     preds, target, num_classes=3, thresholds=5)
        >>> tuple(precision.shape), tuple(recall.shape), tuple(thresholds.shape)
        ((3, 6), (3, 6), (5,))
    """
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds_arr = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(
        preds, target, num_classes, thresholds_arr, average, ignore_index
    )
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds_arr, average)
