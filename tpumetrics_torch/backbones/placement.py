"""Placement layer: backbone weights as long-lived tensors on one device
(port of ``tpumetrics/backbones/placement.py``).

A backbone parameter pytree (dicts, lists and tuples of numpy arrays or
tensors) is cast to the dtype policy and copied to the device ONCE; the
forwards in ``image/_backbones.py`` and ``image/_inception.py`` then consume
the parameters as they are, so a bfloat16 run carries no float32 weights.

The JAX package's regex rules that shard weights over a mesh
(``backbone_partition_rules``) wait for the port of ``parallel/sharding.py``:
``mesh=`` raises here.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

Tensor = torch.Tensor

__all__ = ["DTYPE_POLICIES", "cast_params", "place_backbone"]

# the two supported forward precisions: fp32 is the default AND the oracle;
# bf16 is opt-in behind the per-metric error-bound gates
DTYPE_POLICIES = ("float32", "bfloat16")


def _check_policy(dtype_policy: str) -> torch.dtype:
    if dtype_policy not in DTYPE_POLICIES:
        raise TPUMetricsUserError(
            f"Backbone dtype policy must be one of {DTYPE_POLICIES}, got {dtype_policy!r}."
        )
    return getattr(torch, dtype_policy)


def _refuse_mesh(mesh: Optional[Any]) -> None:
    if mesh is not None:
        raise TPUMetricsUserError(
            "A backbone mesh (`mesh=`) needs the port of parallel/sharding.py, which is not done yet;"
            " pass mesh=None for one device."
        )


def _map_leaves(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """Structure-preserving map over dicts, lists and tuples; paths are
    slash-joined dict keys and list indices, as the JAX package's
    ``state_paths``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def param_paths(tree: Any) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of a parameter pytree, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from ((f"{k}/{p}" if p else str(k), leaf) for p, leaf in param_paths(v))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from ((f"{i}/{p}" if p else str(i), leaf) for p, leaf in param_paths(v))
    else:
        yield "", tree


def _place_leaf(leaf: Any, dtype: torch.dtype, device: Optional[torch.device]) -> Tensor:
    """A copy of ``leaf`` as a tensor: floating leaves in ``dtype``, others
    as they are, on ``device`` (where it already is when None). Always a
    copy, so the caller's arrays never alias the placed weights."""
    t = torch.as_tensor(np.asarray(leaf) if not isinstance(leaf, Tensor) else leaf)
    target = dtype if t.is_floating_point() else t.dtype
    return t.detach().to(device=device if device is not None else t.device, dtype=target, copy=True)


def cast_params(params: Any, dtype_policy: str = "float32") -> Any:
    """Cast every floating leaf of a parameter pytree to the policy dtype,
    ONCE, so no forward casts its weights per call. Integer and boolean
    leaves pass through; every leaf comes back as a tensor copy."""
    dtype = _check_policy(dtype_policy)
    return _map_leaves(lambda _path, leaf: _place_leaf(leaf, dtype, None), params)


def place_backbone(
    arch: str,
    params: Any,
    *,
    mesh: Optional[Any] = None,
    dtype_policy: str = "float32",
    device: Union[str, torch.device, None] = None,
) -> Any:
    """Cast and place a backbone parameter pytree: one copy of every leaf on
    ``device`` (the current card when omitted), floating leaves in the
    policy dtype. ``arch`` names the architecture, as in the JAX package,
    where it selects the weights' sharding rules; ``mesh=`` raises."""
    from tpumetrics_torch.metric import _resolve_device

    _refuse_mesh(mesh)
    dtype = _check_policy(dtype_policy)
    device = _resolve_device(device)
    return _map_leaves(lambda _path, leaf: _place_leaf(leaf, dtype, device), params)
