"""Precision-recall curves, binary, multiclass and multilabel (port of
``tpumetrics/functional/classification/precision_recall_curve.py``).

Two state modes, as in the JAX package:

- **Binned** (``thresholds`` = int, list or tensor): a ``(T, [C,] 2, 2)``
  int32 confusion tensor. Its update dispatches on the device: on a CUDA
  tensor the hand-written kernel ``binned_confusion_counts`` computes the
  threshold-by-class counts (binary preds as one column, multilabel preds
  with a per-entry valid mask); on a CPU tensor the JAX package's choice
  between the contraction and the bucketed histogram stands. Ignored
  positions are masked, so no update syncs with the host.
- **Exact** (``thresholds=None``): the update passes the raw preds and
  targets through (list states in the modular classes) and ``compute``
  builds the curve at every distinct pred (``_binary_clf_curve``). Ignored
  positions are dropped by boolean indexing, which syncs with the host, as
  the JAX package's eager-only exact path does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from tpumetrics_torch.ops.binned_confusion import binned_confusion_counts
from tpumetrics_torch.utils.checks import _check_binary_values, _check_same_shape, _check_task_size, _is_capturing
from tpumetrics_torch.utils.compute import EXACT_F32_COUNT, _safe_divide, interp, normalize_logits_if_needed
from tpumetrics_torch.utils.data import _bincount, _cumsum, _one_hot
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor
Thresholds = Optional[Union[int, List[float], Tensor]]
#: a binned ``(T, [C,] 2, 2)`` confusion tensor, or the exact path's ``(preds, target)``
CurveState = Union[Tensor, Tuple[Tensor, Tensor]]
Curves = Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Tensor] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(fps, tps, thresholds) at every distinct pred, in descending pred order
    (sklearn's ``_binary_clf_curve`` contract).

    The sort is stable, as ``jnp.argsort`` is, so ties and NaN preds (last)
    fall where they fall in the JAX package. Without weights the counts are
    int32 (``fps = 1 + index - tps``); divide them in float32.
    """
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc_score_indices = torch.argsort(-preds, stable=True)
    preds = preds[desc_score_indices]
    target = target[desc_score_indices]

    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1]).reshape(-1).to(torch.int32)
    last = torch.tensor([target.shape[0] - 1], dtype=torch.int32, device=preds.device)
    threshold_idxs = torch.cat([distinct_value_indices, last])
    target = (target == pos_label).to(torch.int32)
    if sample_weights is None:
        tps = _cumsum(target, dim=0, dtype=torch.int32)[threshold_idxs]
        fps = 1 + threshold_idxs - tps
    else:
        weight = sample_weights[desc_score_indices]
        tps = _cumsum(target * weight, dim=0)[threshold_idxs]
        fps = _cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    return fps, tps, preds[threshold_idxs]


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


def _binary_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    """Shape and dtype checks, then the target values (a host copy by design)."""
    _check_same_shape(preds, target)
    _check_curve_dtypes(preds, target)
    _check_binary_values(target, "target", ignore_index)


def _check_curve_dtypes(preds: Tensor, target: Tensor) -> None:
    if target.is_floating_point():
        raise ValueError(
            "Expected argument `target` to be an int or long tensor with ground truth labels"
            f" but got tensor with dtype {target.dtype}"
        )
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be an floating tensor with probability/logit scores,"
            f" but got tensor with dtype {preds.dtype}"
        )


def _binary_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Flatten to float32 preds, sigmoid-if-logits; thresholds land on the
    device of ``preds``. The exact path drops ignored positions here (a host
    sync); the binned path keeps them and masks them in the update."""
    preds = preds.reshape(-1).to(torch.float32)
    target = target.reshape(-1)
    thresholds = _adjust_threshold_arg(thresholds, preds.device)
    if ignore_index is not None and thresholds is None:
        keep = target != ignore_index
        preds = preds[keep]
        target = target[keep]
    preds = normalize_logits_if_needed(preds, "sigmoid")
    return preds, target, thresholds


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


def _exact_state(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """What the exact path keeps of a batch: float32 preds and int32 targets,
    the JAX package's dtypes."""
    return preds, target.to(torch.int32)


def _binary_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> CurveState:
    """Binned: the (T, 2, 2) multi-threshold confusion tensor; exact: the
    batch's preds and targets."""
    if thresholds is None:
        return _exact_state(preds, target)
    invalid = None
    if ignore_index is not None:
        invalid = target == ignore_index
        target = torch.where(invalid, 0, target)
    return _binned_confusion_tensor(preds, target, thresholds, invalid)


def _binary_precision_recall_curve_compute(
    state: CurveState,
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(precision, recall, thresholds), with the (1, 0) endpoint appended to
    precision/recall. Binned: at the caller's thresholds; exact: at every
    distinct pred, in increasing threshold order."""
    if thresholds is not None:
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        return _append_endpoint(precision, 1.0), _append_endpoint(recall, 0.0), thresholds

    fps, tps, thresh = _binary_clf_curve(state[0], state[1], pos_label=pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return _append_endpoint(precision.flip(0), 1.0), _append_endpoint(recall.flip(0), 0.0), thresh.flip(0)


def _append_endpoint(curve: Tensor, value: float) -> Tensor:
    """``curve`` with ``value`` appended along its last axis."""
    end = torch.full((*curve.shape[:-1], 1), value, dtype=curve.dtype, device=curve.device)
    return torch.cat([curve, end], dim=-1)


def binary_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision-recall pairs at decision thresholds, binary task.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_precision_recall_curve
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> precision, recall, thresholds = binary_precision_recall_curve(preds, target)
        >>> [round(v, 4) for v in precision.tolist()]
        [0.5, 0.6667, 0.5, 1.0, 1.0]
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ignore_index)
    return _binary_precision_recall_curve_compute(state, thresholds)


# ----------------------------------------------------------------- multiclass


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
    """Shape and value checks; the value check copies to the host by design
    (skipped inside a CUDA graph capture)."""
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
    if _is_capturing():
        return
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
    one-vs-all. Thresholds land on the device of ``preds``. The exact path
    drops ignored samples here (a host sync)."""
    preds = preds.movedim(1, -1).reshape(-1, num_classes).to(torch.float32)
    target = target.reshape(-1)
    thresholds = _adjust_threshold_arg(thresholds, preds.device)
    if ignore_index is not None and thresholds is None:
        keep = target != ignore_index
        preds = preds[keep]
        target = target[keep]
    preds = normalize_logits_if_needed(preds, "softmax")
    if average == "micro":
        preds = preds.reshape(-1)
        if ignore_index is not None and thresholds is not None:
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
) -> CurveState:
    """Binned: the (T, C, 2, 2) confusion tensor ((T, 2, 2) for micro);
    exact: the batch's preds and targets."""
    if thresholds is None:
        return _exact_state(preds, target)
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


def _binned_curves(state: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-class ``(C, T + 1)`` precision and recall of a ``(T, C, 2, 2)``
    state, each with the (1, 0) endpoint appended."""
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    precision = _append_endpoint(_safe_divide(tps, tps + fps).T, 1.0)
    recall = _append_endpoint(_safe_divide(tps, tps + fns).T, 0.0)
    return precision, recall


def _macro_curve(
    xs: List[Tensor], ys: List[Tensor], thresholds: List[Tensor], descending: bool
) -> Tuple[Tensor, Tensor, Tensor]:
    """One curve from per-class curves: the sorted union of their x values,
    the mean of each class's y interpolated there, and the sorted union of
    their thresholds (``descending`` for ROC)."""
    thres = torch.sort(torch.cat(thresholds)).values
    mean_x = torch.sort(torch.cat(xs)).values
    mean_y = torch.zeros_like(mean_x)
    for x, y in zip(xs, ys):
        mean_y = mean_y + interp(mean_x, x, y)
    return mean_x, mean_y / len(xs), thres.flip(0) if descending else thres


def _multiclass_precision_recall_curve_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Curves:
    """Per-class curves (binned: ``(C, T + 1)`` tensors; exact: lists of
    per-class tensors), or one macro curve interpolated onto a shared
    precision grid, or the micro curve."""
    if average == "micro":
        return _binary_precision_recall_curve_compute(state, thresholds)
    if thresholds is not None:
        precision, recall = _binned_curves(state)
        if average == "macro":
            return _macro_curve(list(precision), list(recall), [thresholds] * num_classes, descending=False)
        return precision, recall, thresholds

    curves = [
        _binary_precision_recall_curve_compute((state[0][:, i], state[1]), None, pos_label=i)
        for i in range(num_classes)
    ]
    precision_list, recall_list, thres_list = (list(c) for c in zip(*curves))
    if average == "macro":
        return _macro_curve(precision_list, recall_list, thres_list, descending=False)
    return precision_list, recall_list, thres_list


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """Per-class one-vs-rest precision-recall curves.

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


# ----------------------------------------------------------------- multilabel


def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    """Shape and dtype checks, then the target values (a host copy by design)."""
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            f"Expected `preds.shape[1]={preds.shape[1]}` to be equal to the number of labels {num_labels}"
        )
    _check_curve_dtypes(preds, target)
    _check_binary_values(target, "target", ignore_index)


def _multilabel_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """(N, L, ...) -> (N', L) float32; sigmoid-if-logits. Ignored entries
    stay: the binned update masks them, the exact compute drops them per label."""
    preds = preds.reshape(preds.shape[0], num_labels, -1).movedim(1, -1).reshape(-1, num_labels)
    target = target.reshape(target.shape[0], num_labels, -1).movedim(1, -1).reshape(-1, num_labels)
    preds = normalize_logits_if_needed(preds.to(torch.float32), "sigmoid")
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _multilabel_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> CurveState:
    """Binned: the (T, L, 2, 2) confusion tensor, ignored entries (not rows)
    out of every count; exact: the batch's preds and targets."""
    if thresholds is None:
        return _exact_state(preds, target)
    invalid = None
    if ignore_index is not None:
        invalid = target == ignore_index
        target = torch.where(invalid, 0, target)
    return _binned_confusion_tensor(preds, target, thresholds, invalid)


def _multilabel_exact_columns(state: Tuple[Tensor, Tensor], ignore_index: Optional[int]) -> List[Tuple[Tensor, Tensor]]:
    """Each label's (preds, target) of an exact multilabel state, its ignored entries dropped."""
    columns = []
    for i in range(state[0].shape[1]):
        preds_i, target_i = state[0][:, i], state[1][:, i]
        if ignore_index is not None:
            keep = target_i != ignore_index
            preds_i, target_i = preds_i[keep], target_i[keep]
        columns.append((preds_i, target_i))
    return columns


def _multilabel_precision_recall_curve_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Curves:
    """Per-label curves: binned ``(L, T + 1)`` tensors, or exact lists."""
    if thresholds is not None:
        precision, recall = _binned_curves(state)
        return precision, recall, thresholds
    curves = [_binary_precision_recall_curve_compute(col, None) for col in _multilabel_exact_columns(state, ignore_index)]
    precision_list, recall_list, thres_list = (list(c) for c in zip(*curves))
    return precision_list, recall_list, thres_list


def multilabel_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """Per-label precision-recall curves.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_precision_recall_curve
        >>> preds = torch.tensor([[0.75, 0.05], [0.05, 0.75], [0.05, 0.05], [0.75, 0.75]])
        >>> target = torch.tensor([[1, 0], [0, 1], [0, 0], [1, 1]])
        >>> precision, recall, thresholds = multilabel_precision_recall_curve(
        ...     preds, target, num_labels=2, thresholds=5)
        >>> tuple(precision.shape), tuple(recall.shape), tuple(thresholds.shape)
        ((2, 6), (2, 6), (5,))
    """
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds_arr = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds_arr, ignore_index)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds_arr, ignore_index)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Curves:
    """Task-string dispatcher; ``average`` merges the multiclass per-class curves (micro/macro)."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_precision_recall_curve(
            preds, target, _check_task_size("num_classes", num_classes), thresholds, average, ignore_index,
            validate_args,
        )
    return multilabel_precision_recall_curve(
        preds, target, _check_task_size("num_labels", num_labels), thresholds, ignore_index, validate_args
    )
