"""Tensor helpers for metric state handling (counterpart of ``tpumetrics/utils/data.py``).

Counts are int32, as in the JAX package without x64: ``torch.bincount`` and
integer ``sum`` return int64, so the helpers here cast back.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from tpumetrics_torch.buffers import MaskedBuffer, _BufferList, materialize

Tensor = torch.Tensor


def dim_zero_cat(x: Union[Tensor, List[Tensor], MaskedBuffer]) -> Tensor:
    """Concatenate a (possibly listed) state along dim 0. MaskedBuffer
    states materialize to their valid rows."""
    if isinstance(x, _BufferList):
        x = x.buffer
    if isinstance(x, MaskedBuffer):
        return materialize(x)
    if isinstance(x, Tensor):
        return x
    if not x:
        raise ValueError("No samples to concatenate")
    x = [y.buffer if isinstance(y, _BufferList) else y for y in x]
    x = [materialize(y) if isinstance(y, MaskedBuffer) else y for y in x]
    return torch.cat([y.reshape(1) if y.ndim == 0 else y for y in x], dim=0)


def dim_zero_sum(x: Tensor) -> Tensor:
    """Sum over dim 0, keeping an integer dtype (``torch.sum`` would widen
    int32 to int64; ``jnp.sum`` keeps it), bool summed as int32."""
    if x.is_floating_point():
        return torch.sum(x, dim=0)
    return torch.sum(x, dim=0, dtype=torch.int32 if x.dtype == torch.bool else x.dtype)


def dim_zero_mean(x: Tensor) -> Tensor:
    """Mean over dim 0; an integer mean is float32, as ``jnp.mean``'s."""
    return torch.mean(x if x.is_floating_point() else x.to(torch.float32), dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.amax(x, dim=0)


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.amin(x, dim=0)


def _flatten(x: Sequence) -> list:
    """Flatten list of lists into one list."""
    return [item for sublist in x for item in sublist]


def _flatten_dict(x: Dict) -> Tuple[Dict, bool]:
    """Flatten dict of dicts into one level; returns (flat_dict, any_key_collided)."""
    new_dict = {}
    duplicates = False
    for key, value in x.items():
        if isinstance(value, dict):
            for k, v in value.items():
                if k in new_dict:
                    duplicates = True
                new_dict[k] = v
        else:
            if key in new_dict:
                duplicates = True
            new_dict[key] = value
    return new_dict, duplicates


def _one_hot(labels: Tensor, num_classes: int) -> Tensor:
    """int32 one-hot with the class axis last, like ``jax.nn.one_hot``:
    labels outside ``[0, num_classes)`` (negative ones included) give an
    all-zero row, where ``torch.nn.functional.one_hot`` would raise."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.unsqueeze(-1) == classes).to(torch.int32)


def to_onehot(label_tensor: Tensor, num_classes: Optional[int] = None) -> Tensor:
    """Dense labels ``(N, d1, ...)`` to one-hot ``(N, C, d1, ...)`` (class axis at 1)."""
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1
    return _one_hot(label_tensor, num_classes).movedim(-1, 1)


def to_categorical(x: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities or logits to dense labels, the argmax along ``argmax_dim``."""
    return torch.argmax(x, dim=argmax_dim)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """int32 mask of the top-k entries along ``dim``."""
    if topk == 1:
        idx = torch.argmax(prob_tensor, dim=dim)
        return _one_hot(idx, prob_tensor.shape[dim]).movedim(-1, dim)
    idx = torch.topk(prob_tensor, topk, dim=dim).indices
    return torch.zeros_like(prob_tensor, dtype=torch.int32).scatter_(dim, idx, 1)


def _cumsum(x: Tensor, dim: int = 0, dtype: Optional[torch.dtype] = None) -> Tensor:
    """Cumulative sum along ``dim``. Pass ``dtype`` to keep integer counts
    in int32: ``torch.cumsum`` of an int32 tensor returns int64 otherwise."""
    return torch.cumsum(x, dim=dim, dtype=dtype)


def _count_dtype() -> torch.dtype:
    """Integer dtype of count accumulators: int32, the JAX package's default
    (it wraps past ~2.1B accumulated samples, as there)."""
    return torch.int32


def _bincount(x: Tensor, minlength: Optional[int] = None) -> Tensor:
    """int32 counts of the ints in ``x``; negative values and values
    ``>= minlength`` are DROPPED (they go to a sentinel bucket that is sliced
    off).

    With ``minlength`` given, the counts are an int32 ``index_add_`` of ones
    into a fixed ``(minlength + 1,)`` buffer: exact, and nothing is read on
    the host, so the call can run inside a CUDA graph (CUDA ``torch.bincount``
    reads its input's maximum on the host even when ``minlength`` is given).
    Without it, the length is read from the data on the host.
    """
    x = x.reshape(-1)
    if minlength is None:
        minlength = int(x.max()) + 1 if x.numel() else 0
    x = torch.where((x < 0) | (x >= minlength), minlength, x).long()
    counts = torch.zeros((minlength + 1,), dtype=torch.int32, device=x.device)
    counts.index_add_(0, x, torch.ones_like(x, dtype=torch.int32))
    return counts[:minlength]
