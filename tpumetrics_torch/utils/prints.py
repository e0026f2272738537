"""Rank-zero-only printing / warning helpers (counterpart of ``tpumetrics/utils/prints.py``).

The rank is the ``torch.distributed`` rank when a process group is
initialized, else 0.
"""

from __future__ import annotations

import warnings
from functools import wraps
from typing import Any, Callable

import torch.distributed as dist


def _get_rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Decorate ``fn`` so it only runs on rank 0."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _get_rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, *args: Any, **kwargs: Any) -> None:
    kwargs.setdefault("stacklevel", 5)
    warnings.warn(message, *args, **kwargs)

