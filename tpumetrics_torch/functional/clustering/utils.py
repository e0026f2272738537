"""Shared clustering helpers (port of
``tpumetrics/functional/clustering/utils.py``).

- The contingency table is an int32 count over the flat pair index
  ``target * C + preds`` (``_bincount`` with ``minlength``), cast to
  float32: the JAX package's float32 one-hot product bit for bit below
  2^24 per cell, with no float atomics. Rows outside either class space,
  negative ones included, are dropped.
- Entropy and MI terms are where-masked, so zero rows and columns add
  exactly zero and shapes never depend on the data.
- Per-cluster sums (centroids, Davies-Bouldin's intra distances) are a
  float64 one-hot product: deterministic on a card (no float
  ``index_add_``, whose atomics add in any order) and untouched by the TF32
  settings, which apply to float32 products only.
- Centroid distances are taken ``rows`` at a time, so the ``(rows, K, D)``
  difference stays within 1 GiB; no ``|a|² + |b|² - 2ab`` form, which
  cancels where centroids are close.

Host reads, all in ``compute()`` or a functional call and never in an
``update()``: ``_relabel``'s ``torch.unique`` when no class space is
declared, ``calculate_generalized_mean``'s nonnegativity check and
``_validate_intrinsic_labels_to_samples``, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from tpumetrics_torch.utils.checks import _check_same_shape
from tpumetrics_torch.utils.data import _bincount

Tensor = torch.Tensor

_DIFF_BUDGET = 1 << 28  # float32 elements of one (rows, K, D) centroid difference: 1 GiB


def is_nonnegative(x: Tensor, atol: float = 1e-5) -> Tensor:
    """True when all elements are nonnegative within tolerance."""
    return torch.all((x > 0.0) | (torch.abs(x) < atol))


def _validate_average_method_arg(average_method: str = "arithmetic") -> None:
    if average_method not in ("min", "geometric", "arithmetic", "max"):
        raise ValueError(
            "Expected argument `average_method` to be one of  `min`, `geometric`, `arithmetic`, `max`,"
            f"but got {average_method}"
        )


def _relabel(x: Tensor) -> Tuple[Tensor, int]:
    """Observed labels mapped to ``0..K-1`` and K. Reads the host (a CUDA
    ``torch.unique`` syncs): ``compute()`` and functional calls only."""
    classes, idx = torch.unique(x, return_inverse=True)
    return idx.reshape(x.shape), int(classes.numel())


def counts_per_class(x: Tensor, num_classes: Optional[int] = None, mask: Optional[Tensor] = None) -> Tensor:
    """float32 occurrences of each label (an int32 count cast once); labels
    outside ``[0, num_classes)`` and masked rows are dropped. Without
    ``num_classes`` the observed classes are found with ``_relabel``."""
    if num_classes is None:
        x, num_classes = _relabel(x)
    x = x.to(torch.int64)
    if mask is not None:
        x = torch.where(mask, x, num_classes)
    return _bincount(x, minlength=num_classes).to(torch.float32)


def calculate_entropy(x: Tensor, num_classes: Optional[int] = None, mask: Optional[Tensor] = None) -> Tensor:
    """Entropy of a label tensor (natural log); 1.0 for an empty input and
    0.0 for one observed class, as in the JAX package."""
    if x.numel() == 0:
        return torch.tensor(1.0, dtype=torch.float32, device=x.device)
    p = counts_per_class(x, num_classes=num_classes, mask=mask)
    n = torch.sum(p)
    safe_p = torch.where(p > 0, p, 1.0)
    safe_n = torch.where(n > 0, n, 1.0)
    return -torch.sum(torch.where(p > 0, (p / safe_n) * (torch.log(safe_p) - torch.log(safe_n)), 0.0))


def calculate_generalized_mean(x: Tensor, p: Union[int, float, str]) -> Tensor:
    """Generalized (power) mean of a nonnegative tensor. The nonnegativity
    check reads the host, as the JAX package's eager check does."""
    if x.is_complex() or not bool(is_nonnegative(x)):
        raise ValueError("`x` must contain positive real numbers")
    if isinstance(p, str):
        if p == "min":
            return x.min()
        if p == "geometric":
            safe_x = torch.where(x > 0, x, 1.0)
            # an exact 0 entry drives a geometric mean to 0
            return torch.where(torch.any(x <= 0), 0.0, torch.exp(torch.mean(torch.log(safe_x))))
        if p == "arithmetic":
            return x.mean()
        if p == "max":
            return x.max()
        raise ValueError("Argument `p` must be 'min', 'geometric', 'arithmetic', or 'max', or a numeric power")
    return torch.mean(torch.pow(x, p)) ** (1.0 / p)


def calculate_contingency_matrix(
    preds: Tensor,
    target: Tensor,
    eps: Optional[float] = None,
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Dense float32 contingency table ``(num_classes_target, num_classes_preds)``.

    With declared class counts nothing is read on the host; without, each
    side's observed labels are relabelled first. ``mask`` drops rows (the
    invalid rows of a fixed-capacity buffer).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering.utils import calculate_contingency_matrix
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> calculate_contingency_matrix(preds, target).int().tolist()
        [[1, 0, 1], [1, 1, 0], [0, 1, 0]]
    """
    if preds.ndim != 1 or target.ndim != 1:
        raise ValueError(f"Expected 1d `preds` and `target` but got {preds.ndim} and {target.ndim}.")
    if num_classes_preds is None:
        preds, num_classes_preds = _relabel(preds)
    if num_classes_target is None:
        target, num_classes_target = _relabel(target)
    t = target.to(torch.int64)
    p = preds.to(torch.int64)
    in_range = (t >= 0) & (t < num_classes_target) & (p >= 0) & (p < num_classes_preds)
    if mask is not None:
        in_range = in_range & mask
    cells = num_classes_target * num_classes_preds
    pair = torch.where(in_range, t * num_classes_preds + p, cells)
    contingency = _bincount(pair, minlength=cells).to(torch.float32).reshape(num_classes_target, num_classes_preds)
    if eps is not None:
        contingency = contingency + eps
    return contingency


def _is_real_discrete_label(x: Tensor) -> bool:
    if x.ndim != 1:
        raise ValueError(f"Expected arguments to be 1-d tensors but got {x.ndim}-d tensors.")
    return not (x.is_floating_point() or x.is_complex())


def check_cluster_labels(preds: Tensor, target: Tensor) -> None:
    """Same shape and integer dtypes."""
    _check_same_shape(preds, target)
    if not (_is_real_discrete_label(preds) and _is_real_discrete_label(target)):
        raise ValueError(f"Expected real, discrete values for x but received {preds.dtype} and {target.dtype}.")


def pair_valid_mask(
    preds: Tensor,
    target: Tensor,
    num_classes_preds: Optional[int],
    num_classes_target: Optional[int],
    mask: Optional[Tensor],
) -> Optional[Tensor]:
    """Rows that survive the contingency build: in both declared class
    spaces and not masked out. Entropies use exactly these rows, so MI and
    its normalizers stay consistent."""
    valid = None
    if num_classes_preds is not None:
        valid = (preds >= 0) & (preds < num_classes_preds)
    if num_classes_target is not None:
        v_t = (target >= 0) & (target < num_classes_target)
        valid = v_t if valid is None else valid & v_t
    if mask is not None:
        valid = mask if valid is None else valid & mask
    return valid


def _validate_intrinsic_cluster_data(data: Tensor, labels: Tensor) -> None:
    if data.ndim != 2:
        raise ValueError(f"Expected 2D data, got {data.ndim}D data instead")
    if not data.is_floating_point():
        raise ValueError(f"Expected floating point data, got {data.dtype} data instead")
    if labels.ndim != 1:
        raise ValueError(f"Expected 1D labels, got {labels.ndim}D labels instead")


def _validate_intrinsic_labels_to_samples(num_labels: int, num_samples: Any) -> None:
    """``1 < num_labels < num_samples``; a tensor count (a buffer's valid
    rows) is read on the host, as in the JAX package's eager compute."""
    if not 1 < num_labels < int(num_samples):
        raise ValueError(
            "Number of detected clusters must be greater than one and less than the number of samples."
            f"Got {num_labels} clusters and {num_samples} samples."
        )


def _zero_index_labels(labels: Tensor, num_labels: Optional[int]) -> Tuple[Tensor, int]:
    """Labels as ``0..K-1``: as given when ``num_labels`` is declared, else
    relabelled by the observed classes."""
    if num_labels is not None:
        return labels.to(torch.int64), int(num_labels)
    idx, k = _relabel(labels)
    return idx.to(torch.int64), k


def _mask_labels(labels: Tensor, num_labels: int, mask: Optional[Tensor]) -> Tensor:
    """Invalid rows (masked out, or outside ``[0, num_labels)``) routed to
    segment ``num_labels``, which every segment reduction drops."""
    out_of_range = (labels < 0) | (labels >= num_labels)
    if mask is not None:
        out_of_range = out_of_range | ~mask
    return torch.where(out_of_range, num_labels, labels)


def _segment_sum(values: Tensor, seg_labels: Tensor, num_segments: int) -> Tensor:
    """float64 per-segment sums of ``values`` rows (``(N,)`` or ``(N, D)``)
    as a one-hot product; segment ``num_segments`` (invalid rows) is
    dropped. Deterministic on any device, and float64 products never use
    TF32."""
    onehot = torch.zeros((num_segments + 1, seg_labels.shape[0]), dtype=torch.float64, device=values.device)
    onehot.scatter_(0, seg_labels[None, :], 1.0)
    return onehot[:num_segments] @ values.to(torch.float64)


def _cluster_centroids(
    data: Tensor, labels: Tensor, num_labels: int, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Per-cluster centroids and sizes in at least float32 (the JAX
    package's accumulator dtype): sums as a float64 one-hot product, sizes
    as an exact int32 count; ``mask`` excludes invalid buffer rows."""
    labels = _mask_labels(labels, num_labels, mask)
    acc_dtype = data.dtype if torch.finfo(data.dtype).bits >= 32 else torch.float32
    counts = _bincount(labels, minlength=num_labels)
    sums = _segment_sum(data, labels, num_labels)
    centroids = sums / torch.clamp(counts, min=1).to(torch.float64)[:, None]
    return centroids.to(acc_dtype), counts.to(acc_dtype)


def _centroid_distances(centroids: Tensor, p: float = 2.0) -> Tensor:
    """``(K, K)`` p-norm distances between centroids, ``rows`` at a time so
    one ``(rows, K, D)`` difference stays within 1 GiB. ``p=2`` takes the
    square root of the summed squares, as Davies-Bouldin does."""
    k, d = centroids.shape
    rows = max(1, _DIFF_BUDGET // max(1, k * d))
    out = []
    for lo in range(0, k, rows):
        diff = centroids[lo : lo + rows, None, :] - centroids[None, :, :]
        if p == 2:
            out.append(torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0)))
        else:
            out.append(torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p))
    return torch.cat(out) if out else centroids.new_zeros((0, 0))


def calculate_pair_cluster_confusion_matrix(
    preds: Optional[Tensor] = None,
    target: Optional[Tensor] = None,
    contingency: Optional[Tensor] = None,
) -> Tensor:
    """2x2 pair-counting confusion matrix of two clusterings.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering.utils import calculate_pair_cluster_confusion_matrix
        >>> preds = torch.tensor([0, 0, 1, 2])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> calculate_pair_cluster_confusion_matrix(preds, target).int().tolist()
        [[8, 2], [0, 2]]
    """
    if preds is None and target is None and contingency is None:
        raise ValueError("Must provide either `preds` and `target` or `contingency`.")
    if preds is not None and target is not None and contingency is not None:
        raise ValueError("Must provide either `preds` and `target` or `contingency`, not both.")
    if preds is not None and target is not None:
        contingency = calculate_contingency_matrix(preds, target)
    if contingency is None:
        raise ValueError("Must provide `contingency` if `preds` and `target` are not provided.")

    num_samples = contingency.sum()
    sum_c = contingency.sum(dim=1)
    sum_k = contingency.sum(dim=0)
    sum_squared = (contingency**2).sum()

    same_same = sum_squared - num_samples
    same_diff = (contingency * sum_k[None, :]).sum() - sum_squared
    diff_same = (contingency.T * sum_c[None, :]).sum() - sum_squared
    diff_diff = num_samples**2 - diff_same - same_diff - sum_squared
    return torch.stack([torch.stack([diff_diff, diff_same]), torch.stack([same_diff, same_same])]).to(
        contingency.dtype
    )
