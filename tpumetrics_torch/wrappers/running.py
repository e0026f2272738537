"""Sliding-window wrapper metric (counterpart of ``tpumetrics/wrappers/running.py``).

Keeps ``window`` copies of the wrapped metric's state (one per recent
update) and computes the metric over their merge. The wrapped metric must
have ``full_state_update=False``.
"""

from __future__ import annotations

from typing import Any

from tpumetrics_torch.metric import Metric
from tpumetrics_torch.wrappers.abstract import WrapperMetric


class Running(WrapperMetric):
    """Compute a metric over a running window of the last ``window`` updates.

    ``forward`` returns the current batch's value; ``compute`` the windowed
    value, synced across ranks by the wrapped metric. The wrapper's states
    live on the wrapped metric's device.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.wrappers import Running
        >>> from tpumetrics_torch.aggregation import SumMetric
        >>> metric = Running(SumMetric(device="cpu"), window=3)
        >>> for i in range(6):
        ...     _ = metric.update(torch.tensor([float(i)]))
        >>> float(metric.compute())  # 3 + 4 + 5
        12.0
    """

    def __init__(self, base_metric: Metric, window: int = 5) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected argument `metric` to be an instance of `tpumetrics_torch.Metric` but got {base_metric}"
            )
        super().__init__(device=base_metric.device)
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Expected argument `window` to be a positive integer but got {window}")
        self.base_metric = base_metric
        self.window = window
        if base_metric.full_state_update is not False:
            raise ValueError(
                f"Expected attribute `full_state_update` set to `False` but got {base_metric.full_state_update}"
            )
        self._num_vals_seen = 0

        for key in base_metric._defaults:
            for i in range(window):
                self.add_state(
                    name=f"{key}_{i}", default=base_metric._defaults[key], dist_reduce_fx=base_metric._reductions[key]
                )

    def _store_slot(self) -> None:
        slot = self._num_vals_seen % self.window
        for key in self.base_metric._defaults:
            setattr(self, f"{key}_{slot}", getattr(self.base_metric, key))

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the wrapped metric, keep its state in the current slot, reset it."""
        self.base_metric.update(*args, **kwargs)
        self._store_slot()
        self.base_metric.reset()
        self._num_vals_seen += 1

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The wrapped metric's batch value; its state goes into the current slot."""
        res = self.base_metric.forward(*args, **kwargs)
        self._store_slot()
        self.base_metric.reset()
        self._num_vals_seen += 1
        self._computed = None
        return res

    def compute(self) -> Any:
        """Merge every window slot into the wrapped metric and compute it."""
        for i in range(self.window):
            self.base_metric._reduce_states({key: getattr(self, f"{key}_{i}") for key in self.base_metric._defaults})
        # the wrapped compute must not warn about a missing update
        self.base_metric._update_count = max(self._num_vals_seen, 1)
        val = self.base_metric.compute()
        self.base_metric.reset()
        return val

    def reset(self) -> None:
        super().reset()
        self.base_metric.reset()
        self._num_vals_seen = 0
