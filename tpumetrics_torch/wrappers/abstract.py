"""Abstract base for wrapper metrics (counterpart of ``tpumetrics/wrappers/abstract.py``).

A wrapper forwards its calls to the metric it wraps, which owns the sync and
the counters, so the base class's update/compute wrapping is turned off here.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from tpumetrics_torch.metric import Metric
from tpumetrics_torch.parallel.fuse import FusedReducer
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError


class WrapperMetric(Metric):
    """Base class for metrics that wrap other metrics.

    The wrapped metric syncs its own states in its own ``compute``; the
    wrapper neither wraps ``update``/``compute`` nor syncs its registered
    states, so nothing is synced twice.
    """

    def _wrap_update(self, update: Callable) -> Callable:
        return update

    def _wrap_compute(self, compute: Callable) -> Callable:
        return compute

    def _sync_dist(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        _reducer: Optional[FusedReducer] = None,
    ) -> None:
        pass  # the wrapped metric syncs in its own compute

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Each wrapper defines its own forward protocol."""
        raise NotImplementedError

    # The wrapper's state lives in the wrapped children, so the base
    # functional bridge (which borrows registered states only) does not apply.

    def _no_functional_bridge(self) -> None:
        raise TPUMetricsUserError(
            f"{type(self).__name__} does not support the functional bridge: its state lives in wrapped child"
            " metrics with order- or sampling-dependent update semantics. Use the eager API (update/compute)."
        )

    def init_state(self) -> Any:
        self._no_functional_bridge()

    def functional_update(self, state: Any, *args: Any, **kwargs: Any) -> Any:
        self._no_functional_bridge()

    def functional_compute(self, state: Any, axis_name: Any = None, backend: Any = None) -> Any:
        self._no_functional_bridge()

    def functional_forward(self, state: Any, *args: Any, **kwargs: Any) -> Any:
        self._no_functional_bridge()

    def sync_state(self, state: Any, backend: Any) -> Any:
        self._no_functional_bridge()

    def _sync_state_collect(self, state: Any, backend: Any, reducer: Any, group: Any = None) -> Any:
        self._no_functional_bridge()
