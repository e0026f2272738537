"""Stat scores (tp/fp/tn/fn), binary, multiclass and multilabel (port of
``tpumetrics/functional/classification/stat_scores.py``).

``ignore_index`` is handled with a validity mask carried beside the data, as
in the JAX package, so shapes never depend on the data. Counts are int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpumetrics_torch.utils.checks import _check_binary_values, _check_same_shape, _check_task_size, _is_capturing
from tpumetrics_torch.utils.compute import normalize_logits_if_needed
from tpumetrics_torch.utils.data import _bincount, _one_hot, select_topk
from tpumetrics_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _masked_confmat(preds: Tensor, target: Tensor, mask: Tensor, n: int) -> Tensor:
    """(n, n) int32 confusion matrix over valid positions only.

    One int32 count over the flat index ``target * n + preds`` into a fixed
    ``(n * n + 1,)`` buffer (``_bincount`` with ``minlength``), with masked
    positions and labels outside ``[0, n)`` sent to a sentinel bucket that is
    dropped: the same counts as the JAX package's one-hot matmul (where an
    out-of-range label one-hots to a zero row), exact at any size, unaffected
    by autocast, and read nowhere on the host, so a CUDA graph can hold it.
    """
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    valid = (mask.reshape(-1) == 1) & (target >= 0) & (target < n) & (preds >= 0) & (preds < n)
    idx = torch.where(valid, target.to(torch.int64) * n + preds, n * n)
    return _bincount(idx, minlength=n * n + 1)[:-1].reshape(n, n)


# --------------------------------------------------------------------- binary


def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an int, but got {ignore_index}")


def _binary_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    _check_binary_values(target, "target", ignore_index)
    if not preds.is_floating_point():
        _check_binary_values(preds, "preds")
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")


def _binarize(preds: Tensor, threshold: float) -> Tensor:
    """int32 0/1 preds: probabilities (or logits, through a sigmoid) above
    ``threshold``, or label preds as they are."""
    if preds.is_floating_point():
        return (normalize_logits_if_needed(preds, "sigmoid") > threshold).to(torch.int32)
    return preds.to(torch.int32)


def _target_and_mask(target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor]:
    """int32 target with ignored positions set to 0, and the int32 validity mask."""
    if ignore_index is None:
        return target.to(torch.int32), torch.ones_like(target, dtype=torch.int32)
    ignored = target == ignore_index
    return torch.where(ignored, 0, target).to(torch.int32), (~ignored).to(torch.int32)


def _binary_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Binarize and flatten to ``(N, X)``; returns (preds, target, valid mask)."""
    preds = _binarize(preds, threshold)
    target, mask = _target_and_mask(target, ignore_index)
    return preds.reshape(preds.shape[0], -1), target.reshape(target.shape[0], -1), mask.reshape(mask.shape[0], -1)


def _confusion_sums(preds: Tensor, target: Tensor, mask: Tensor, dim) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Mask-weighted int32 tp/fp/tn/fn of 0/1 preds and targets, summed over ``dim``."""
    valid = mask == 1
    p1, p0 = preds == 1, preds == 0
    t1, t0 = target == 1, target == 0
    return (
        _sum32(p1 & t1 & valid, dim),
        _sum32(p1 & t0 & valid, dim),
        _sum32(p0 & t0 & valid, dim),
        _sum32(p0 & t1 & valid, dim),
    )


def _binary_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    mask: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Counts over everything (global, 0-d) or per sample (samplewise, ``(N,)``)."""
    return _confusion_sums(preds, target, mask, (0, 1) if multidim_average == "global" else 1)


def _binary_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, multidim_average: str = "global"
) -> Tensor:
    """Stack into ``[tp, fp, tn, fn, support]`` (per sample for samplewise)."""
    return torch.stack([tp, fp, tn, fn, tp + fn], dim=0 if multidim_average == "global" else -1).squeeze()


def binary_stat_scores(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """tp/fp/tn/fn for binary tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import binary_stat_scores
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_stat_scores(preds, target).tolist()
        [2, 1, 2, 1, 3]
    """
    tp, fp, tn, fn = _binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


def _binary_counts(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """A binary batch checked (with ``validate_args``), formatted and counted:
    the int32 (tp, fp, tn, fn) every binary stat-score function reduces."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, mask = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    return _binary_stat_scores_update(preds, target, mask, multidim_average)


# ----------------------------------------------------------------- multiclass


def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not (isinstance(top_k, int) and top_k >= 1):
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an int, but got {ignore_index}")


def _multiclass_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    """Shape and value checks. The value checks copy to the host by design
    (``validate_args=False`` skips them, and so does a CUDA graph capture)."""
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError("If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                             " equal to number of classes.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        if multidim_average != "global" and preds.ndim < 3:
            raise ValueError("Expected input to be at least 3D when multidim_average is set to `samplewise`")
    elif preds.ndim == target.ndim:
        _check_same_shape(preds, target)
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    if _is_capturing():
        return
    if target.numel():
        unique_values = torch.unique(target).tolist()
        bad = [v for v in unique_values if (v < 0 or v >= num_classes) and v != ignore_index]
        if bad:
            raise RuntimeError(
                f"Detected the following values in `target`: {bad} but expected only values in"
                f" [0, {num_classes}) (ignore_index={ignore_index})."
            )
    if preds.ndim == target.ndim and not preds.is_floating_point() and preds.numel():
        if int(preds.max()) >= num_classes or int(preds.min()) < 0:
            raise RuntimeError(f"Detected more unique values in `preds` than expected. Expected only {num_classes}.")


def _multiclass_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    top_k: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Probabilities/logits to labels (top_k=1) or kept scores (top_k>1);
    flatten extra dims; build the int32 validity mask."""
    if preds.ndim == target.ndim + 1 and top_k == 1:
        preds = torch.argmax(preds, dim=1)
    target, mask = _target_and_mask(target, ignore_index)
    if preds.ndim == target.ndim + 1:  # top_k > 1: scores retained
        preds = preds.reshape(preds.shape[0], num_classes, -1)
    else:
        preds = preds.to(torch.int32).reshape(preds.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    mask = mask.reshape(mask.shape[0], -1)
    return preds, target, mask


def _sum32(x: Tensor, dim) -> Tensor:
    return torch.sum(x, dim=dim, dtype=torch.int32)


def _multiclass_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    mask: Tensor,
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class int32 tp/fp/tn/fn.

    Label path (top_k == 1, global): one masked confusion matrix. Score path
    (top_k > 1) and samplewise: one-hot products summed over the samples.
    """
    if preds.ndim == target.ndim + 1:  # top_k > 1 score path
        preds_oh = select_topk(preds, top_k, dim=1)  # (N, C, X)
        target_oh = _one_hot(target, num_classes).movedim(-1, 1)  # (N, C, X)
        m = mask[:, None, :]
        dims = (0, 2) if multidim_average == "global" else 2
        tp = _sum32(preds_oh * target_oh * m, dims)
        fp = _sum32(preds_oh * (1 - target_oh) * m, dims)
        fn = _sum32((1 - preds_oh) * target_oh * m, dims)
        tn = _sum32((1 - preds_oh) * (1 - target_oh) * m, dims)
        return tp, fp, tn, fn

    if multidim_average == "global":
        confmat = _masked_confmat(preds, target, mask, num_classes)
        tp = torch.diagonal(confmat)
        fp = _sum32(confmat, 0) - tp
        fn = _sum32(confmat, 1) - tp
        tn = _sum32(confmat, (0, 1)) - tp - fp - fn
        return tp, fp, tn, fn

    # samplewise label path: one-hot products per sample
    preds_oh = _one_hot(preds, num_classes)  # (N, X, C)
    target_oh = _one_hot(target, num_classes)
    m = mask[..., None]
    tp = _sum32(preds_oh * target_oh * m, 1)
    fp = _sum32(preds_oh * (1 - target_oh) * m, 1)
    fn = _sum32((1 - preds_oh) * target_oh * m, 1)
    tn = _sum32((1 - preds_oh) * (1 - target_oh) * m, 1)
    return tp, fp, tn, fn


def _multiclass_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str] = "macro", multidim_average: str = "global"
) -> Tensor:
    """Apply micro-sum if requested and stack [tp, fp, tn, fn, support]."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    if average == "micro":
        return _sum32(res, -2)
    return res


def multiclass_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Per-class tp/fp/tn/fn for multiclass tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multiclass_stat_scores
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> multiclass_stat_scores(preds, target, num_classes=3, average='micro').tolist()
        [3, 1, 7, 1, 4]
    """
    tp, fp, tn, fn = _multiclass_counts(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


def _multiclass_counts(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str],
    top_k: int,
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """A multiclass batch checked (with ``validate_args``), formatted and
    counted: the per-class int32 (tp, fp, tn, fn)."""
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target, mask = _multiclass_stat_scores_format(preds, target, num_classes, ignore_index, top_k)
    return _multiclass_stat_scores_update(preds, target, mask, num_classes, top_k, average, multidim_average)


# ----------------------------------------------------------------- multilabel


def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float, but got {threshold}.")
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an int, but got {ignore_index}")


def _multilabel_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            f"Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be at least 3D when multidim_average is set to `samplewise`")
    _check_binary_values(target, "target", ignore_index)


def _multilabel_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Binarize and reshape to ``(N, L, X)``; returns (preds, target, valid mask)."""
    preds = _binarize(preds, threshold)
    target, mask = _target_and_mask(target, ignore_index)
    return (
        preds.reshape(preds.shape[0], num_labels, -1),
        target.reshape(target.shape[0], num_labels, -1),
        mask.reshape(mask.shape[0], num_labels, -1),
    )


def _multilabel_stat_scores_update(
    preds: Tensor, target: Tensor, mask: Tensor, multidim_average: str = "global"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-label counts ``(L,)``, or per sample and label ``(N, L)`` for samplewise."""
    return _confusion_sums(preds, target, mask, (0, 2) if multidim_average == "global" else 2)


def _multilabel_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str] = "macro", multidim_average: str = "global"
) -> Tensor:
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    if average == "micro":
        return _sum32(res, -2)
    return res


def multilabel_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Per-label tp/fp/tn/fn for multilabel tasks.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.classification import multilabel_stat_scores
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> preds = torch.tensor([[0, 0, 1], [1, 0, 1]])
        >>> multilabel_stat_scores(preds, target, num_labels=3, average='micro').tolist()
        [2, 1, 2, 1, 3]
    """
    tp, fp, tn, fn = _multilabel_counts(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


def _multilabel_counts(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float,
    average: Optional[str],
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """A multilabel batch checked (with ``validate_args``), formatted and
    counted: the per-label int32 (tp, fp, tn, fn)."""
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, mask = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    return _multilabel_stat_scores_update(preds, target, mask, multidim_average)


# --------------------------------------------------------------- task dispatch


def stat_scores(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-string dispatcher over the binary, multiclass and multilabel stat scores."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_stat_scores(
            preds, target, _check_task_size("num_classes", num_classes), average, top_k, multidim_average,
            ignore_index, validate_args,
        )
    return multilabel_stat_scores(
        preds, target, _check_task_size("num_labels", num_labels), threshold, average, multidim_average,
        ignore_index, validate_args,
    )
