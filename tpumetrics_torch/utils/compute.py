"""Numerically-safe compute helpers (counterpart of ``tpumetrics/utils/compute.py``)."""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

# largest sample count whose partial sums stay exactly representable in an
# f32 accumulator: a 0/1-weighted f32 contraction over fewer samples is an
# exact count
EXACT_F32_COUNT = 1 << 24


def _as_float(x: Tensor) -> Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _safe_xlogy(x: Tensor, y: Tensor) -> Tensor:
    """``x * log(y)`` with ``0 * log(0) := 0``."""
    return torch.where(x == 0.0, 0.0, x * torch.log(torch.where(x == 0.0, 1.0, y)))


def _safe_divide(num: Tensor, denom: Tensor, zero_division: float = 0.0) -> Tensor:
    """Division with 0/0 := zero_division; integer operands divide in float32."""
    num = _as_float(num)
    denom = _as_float(denom)
    zero_mask = denom == 0
    return torch.where(zero_mask, zero_division, num / torch.where(zero_mask, 1.0, denom))


def _adjust_weights_safe_divide(
    score: Tensor, average: Optional[str], multilabel: bool, tp: Tensor, fp: Tensor, fn: Tensor
) -> Tensor:
    """Apply micro/macro/weighted/none weighting to per-class scores."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(torch.float32)
    else:
        weights = torch.ones_like(score)
        if not multilabel:
            # macro: classes absent from both preds & target are excluded
            weights = torch.where((tp + fp + fn) == 0, 0.0, weights)
    return torch.sum(_safe_divide(weights, torch.sum(weights, dim=-1, keepdim=True)) * score, dim=-1)


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float, axis: int = -1) -> Tensor:
    """Trapezoidal area under (x, y) assuming sorted x."""
    dx = torch.diff(x, dim=axis)
    n = y.shape[axis]
    mean_y = (y.narrow(axis, 1, n - 1) + y.narrow(axis, 0, n - 1)) / 2.0
    return torch.sum(mean_y * dx, dim=axis) * direction


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """1-D linear interpolation with the JAX package's conventions (NOT
    ``np.interp``): out-of-range points extrapolate along the edge segments,
    the segment of ``x`` is the count of ``xp`` values ``<= x`` (``xp`` need
    not be monotonic), and zero-width segments get slope 0."""
    scalar = x.ndim == 0
    x1 = torch.atleast_1d(x)
    m = _safe_divide(fp[1:] - fp[:-1], xp[1:] - xp[:-1])
    b = fp[:-1] - m * xp[:-1]
    if x1.shape[0] == 0:
        return x1.to(torch.result_type(fp, x1))
    # the (x, xp) comparison counts are taken in bounded chunks so the
    # macro paths (x is the concatenated per-class grid) stay linear in memory
    chunk = 4096
    idx = torch.cat(
        [(x1[lo : lo + chunk, None] >= xp[None, :]).sum(dim=1) - 1 for lo in range(0, x1.shape[0], chunk)]
    )
    indices = torch.clamp(idx, 0, m.shape[0] - 1)
    out = m[indices] * x1 + b[indices]
    return out[0] if scalar else out


def normalize_logits_if_needed(tensor: Tensor, normalization: str) -> Tensor:
    """Apply sigmoid/softmax only when the input looks like logits (outside [0,1]).

    The global is-probability predicate stays a ``torch.where`` on the
    device, so no host sync happens here. The sigmoid is ``1 / (1 + exp(-x))``:
    ``torch.sigmoid`` on the CPU rounds the elements past the last full
    vector of a call differently, which would split tied logits into distinct
    probabilities on the exact curve path.
    """
    is_prob = torch.logical_and(torch.amin(tensor) >= 0, torch.amax(tensor) <= 1)
    if normalization == "sigmoid":
        return torch.where(is_prob, tensor, torch.reciprocal(1 + torch.exp(-tensor)))
    if normalization == "softmax":
        return torch.where(is_prob, tensor, torch.softmax(tensor, dim=1))
    return tensor
