"""Shared backbone runtime of the port (counterpart of ``tpumetrics/backbones``).

The model-bound metrics (FID/KID/MiFID/IS, LPIPS/PPL) are small inference
services wearing a metric API; this package gives them ONE process-global
runtime instead of a private backbone per instance:

- :mod:`~tpumetrics_torch.backbones.registry`: :func:`get_backbone` returns
  one refcounted resident :class:`BackboneHandle` per (architecture,
  weights digest, device, dtype policy);
- :mod:`~tpumetrics_torch.backbones.placement`: the one-time dtype-policy
  cast and copy to the device;
- :mod:`~tpumetrics_torch.backbones.engine`: the bucketed, staged forward
  every sharing instance dispatches through, one CUDA graph per bucket.

``backbone_partition_rules`` (the JAX package's sharded weight placement)
waits for the port of ``parallel/sharding.py``.
"""

from tpumetrics_torch.backbones.engine import BackboneEngine
from tpumetrics_torch.backbones.placement import DTYPE_POLICIES, cast_params, place_backbone
from tpumetrics_torch.backbones.registry import (
    BackboneHandle,
    get_backbone,
    registry_stats,
    resident_bytes,
)

__all__ = [
    "BackboneEngine",
    "BackboneHandle",
    "DTYPE_POLICIES",
    "cast_params",
    "get_backbone",
    "place_backbone",
    "registry_stats",
    "resident_bytes",
]
