"""Cross-rank sync of metric states over ``torch.distributed`` (counterpart
of ``tpumetrics/parallel``): backends, the fused reducer, pure state
merging, and the fused collection update captured as CUDA graphs."""

from tpumetrics_torch.parallel.backend import (
    DistributedBackend,
    NoOpBackend,
    TorchDistBackend,
    distributed_available,
    get_default_backend,
    set_default_backend,
)
from tpumetrics_torch.parallel.fuse import FusedReducer
from tpumetrics_torch.parallel.fuse_update import FusedCollectionStep, UnhashableKwargsError
from tpumetrics_torch.parallel.merge import AssociativeMerge, merge_metric_states, reshard_metric_states

__all__ = [
    "AssociativeMerge",
    "DistributedBackend",
    "FusedCollectionStep",
    "FusedReducer",
    "NoOpBackend",
    "TorchDistBackend",
    "UnhashableKwargsError",
    "distributed_available",
    "get_default_backend",
    "merge_metric_states",
    "reshard_metric_states",
    "set_default_backend",
]
