"""MinMaxMetric (port of ``tpumetrics/wrappers/minmax.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import torch

from tpumetrics_torch.metric import Metric
from tpumetrics_torch.wrappers.abstract import WrapperMetric

Tensor = torch.Tensor


class MinMaxMetric(WrapperMetric):
    """The running minimum and maximum of a metric's computed value.

    The extrema are registered states (``"min"``/``"max"`` reduce), so they
    sync across ranks through the functional bridge and persist through
    ``state_dict``. ``forward`` accumulates into the wrapped metric and
    returns the refreshed statistics. The states live on the wrapped
    metric's device.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.wrappers import MinMaxMetric
        >>> from tpumetrics_torch.classification import BinaryAccuracy
        >>> metric = MinMaxMetric(BinaryAccuracy(device="cpu"))
        >>> _ = metric(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 0, 1, 1]))
        >>> {k: float(v) for k, v in metric.compute().items()}
        {'raw': 1.0, 'max': 1.0, 'min': 1.0}
    """

    full_state_update = True

    min_val: Tensor
    max_val: Tensor

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `tpumetrics_torch.Metric` but received {base_metric}"
            )
        super().__init__(**{"device": base_metric.device, **kwargs})
        self._base_metric = base_metric
        self.add_state("min_val", default=torch.tensor(float("inf")), dist_reduce_fx="min", persistent=True)
        self.add_state("max_val", default=torch.tensor(float("-inf")), dist_reduce_fx="max", persistent=True)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        """``{raw, max, min}``; the extrema refresh on every compute."""
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}.")
        val = torch.as_tensor(val, device=self.device).reshape(())
        self.max_val = torch.maximum(self.max_val, val)
        self.min_val = torch.minimum(self.min_val, val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        """Accumulate the batch into the wrapped metric and return the
        refreshed running statistics."""
        self.update(*args, **kwargs)
        return self.compute()

    def reset(self) -> None:
        super().reset()
        self._base_metric.reset()

    @staticmethod
    def _is_suitable_val(val: Union[float, Tensor]) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False

    # ------------------------------------------------------ functional bridge
    # state = {"base": <wrapped state>, "min_val", "max_val"}. The extrema
    # refresh when a value is observed: ``functional_forward`` returns the
    # refreshed state, while ``functional_compute`` is a pure read that
    # reports the extrema as of the current value without keeping them.

    def init_state(self) -> Dict[str, Any]:
        return {
            "base": self._base_metric.init_state(),
            "min_val": self._defaults["min_val"].clone(),
            "max_val": self._defaults["max_val"].clone(),
        }

    def functional_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return {**state, "base": self._base_metric.functional_update(state["base"], *args, **kwargs)}

    def functional_compute(self, state: Dict[str, Any], axis_name: Any = None, backend: Any = None) -> Dict[str, Tensor]:
        val = self._base_metric.functional_compute(state["base"], axis_name=axis_name, backend=backend)
        val = torch.as_tensor(val, device=self.device).reshape(())
        return {"raw": val, "max": torch.maximum(state["max_val"], val), "min": torch.minimum(state["min_val"], val)}

    def functional_forward(
        self, state: Dict[str, Any], *args: Any, axis_name: Any = None, backend: Any = None, **kwargs: Any
    ) -> tuple:
        new_state = self.functional_update(state, *args, **kwargs)
        stats = self.functional_compute(new_state, axis_name=axis_name, backend=backend)
        return {**new_state, "min_val": stats["min"], "max_val": stats["max"]}, stats

    def _sync_state_collect(
        self, state: Dict[str, Any], backend: Any, reducer: Any, group: Any = None
    ) -> Callable[[], Dict[str, Any]]:
        h_min = reducer.add(state["min_val"], "min")
        h_max = reducer.add(state["max_val"], "max")
        base_fin = self._base_metric._sync_state_collect(state["base"], backend, reducer, group)
        return lambda: {"base": base_fin(), "min_val": reducer.result(h_min), "max_val": reducer.result(h_max)}

    sync_state = Metric.sync_state
