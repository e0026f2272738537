"""MultitaskWrapper (port of ``tpumetrics/wrappers/multitask.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import torch

from tpumetrics_torch.collections import MetricCollection
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.telemetry import ledger as _telemetry
from tpumetrics_torch.wrappers.abstract import WrapperMetric

Tensor = torch.Tensor


class MultitaskWrapper(WrapperMetric):
    """Route each task's predictions and targets to that task's metric (or
    collection). The wrapper lives on the first task's device.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.wrappers import MultitaskWrapper
        >>> from tpumetrics_torch.classification import BinaryAccuracy
        >>> from tpumetrics_torch.regression import MeanSquaredError
        >>> metrics = MultitaskWrapper(
        ...     {"Classification": BinaryAccuracy(device="cpu"), "Regression": MeanSquaredError(device="cpu")}
        ... )
        >>> preds = {"Classification": torch.tensor([0, 1, 1]), "Regression": torch.tensor([127.5, 87.1, 25.6])}
        >>> target = {"Classification": torch.tensor([0, 1, 0]), "Regression": torch.tensor([120.0, 85.0, 30.0])}
        >>> metrics.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in metrics.compute().items()}
        {'Classification': 0.6667, 'Regression': 26.6733}
    """

    is_differentiable = False

    def __init__(self, task_metrics: Dict[str, Union[Metric, MetricCollection]]) -> None:
        self._check_task_metrics_type(task_metrics)
        super().__init__(device=next(iter(task_metrics.values())).device if task_metrics else None)
        self.task_metrics = dict(task_metrics)

    @staticmethod
    def _check_task_metrics_type(task_metrics: Dict[str, Union[Metric, MetricCollection]]) -> None:
        if not isinstance(task_metrics, dict):
            raise TypeError(f"Expected argument `task_metrics` to be a dict. Found task_metrics = {task_metrics}")
        for metric in task_metrics.values():
            if not isinstance(metric, (Metric, MetricCollection)):
                raise TypeError(
                    "Expected each task's metric to be a Metric or a MetricCollection. "
                    f"Found a metric of type {type(metric)}"
                )

    def _check_keys(self, task_preds: Dict[str, Tensor], task_targets: Dict[str, Tensor]) -> None:
        if not self.task_metrics.keys() == task_preds.keys() == task_targets.keys():
            raise ValueError(
                "Expected arguments `task_preds` and `task_targets` to have the same keys as the wrapped"
                f" `task_metrics`. Found task_preds.keys() = {task_preds.keys()},"
                f" task_targets.keys() = {task_targets.keys()}"
                f" and self.task_metrics.keys() = {self.task_metrics.keys()}"
            )

    def update(self, task_preds: Dict[str, Tensor], task_targets: Dict[str, Tensor]) -> None:
        """Route each task's batch to its metric."""
        self._check_keys(task_preds, task_targets)
        for task_name, metric in self.task_metrics.items():
            metric.update(task_preds[task_name], task_targets[task_name])

    def compute(self) -> Dict[str, Any]:
        return {task_name: metric.compute() for task_name, metric in self.task_metrics.items()}

    def forward(self, task_preds: Dict[str, Tensor], task_targets: Dict[str, Tensor]) -> Dict[str, Any]:
        """Per-task forwards; each task's metric accumulates itself."""
        return {
            task_name: metric(task_preds[task_name], task_targets[task_name])
            for task_name, metric in self.task_metrics.items()
        }

    def reset(self) -> None:
        for metric in self.task_metrics.values():
            metric.reset()
        super().reset()

    # ------------------------------------------------------ functional bridge
    # the tasks' states as one dict (a collection task nests its own)

    def init_state(self) -> Dict[str, Any]:
        return {name: m.init_state() for name, m in self.task_metrics.items()}

    def functional_update(
        self, state: Dict[str, Any], task_preds: Dict[str, Tensor], task_targets: Dict[str, Tensor]
    ) -> Dict[str, Any]:
        self._check_keys(task_preds, task_targets)
        return {
            name: m.functional_update(state[name], task_preds[name], task_targets[name])
            for name, m in self.task_metrics.items()
        }

    def functional_compute(self, state: Dict[str, Any], axis_name: Any = None, backend: Any = None) -> Dict[str, Any]:
        out = {}
        for name, m in self.task_metrics.items():
            if isinstance(m, Metric):
                out[name] = m.functional_compute(state[name], axis_name=axis_name, backend=backend)
            else:  # a collection syncs its whole state first, once
                task_state = m.sync_states(state[name], backend) if backend is not None else state[name]
                out[name] = m.functional_compute(task_state, axis_name=axis_name)
        return out

    def _sync_state_collect(
        self, state: Dict[str, Any], backend: Any, reducer: Any, group: Any = None
    ) -> Callable[[], Dict[str, Any]]:
        finalizers = {}
        for name, m in self.task_metrics.items():
            with _telemetry.attribution(name):  # the task's name tags its collectives in the ledger
                finalizers[name] = m._sync_state_collect(state[name], backend, reducer, group)
        return lambda: {name: fin() for name, fin in finalizers.items()}

    sync_state = Metric.sync_state

    def functional_forward(
        self,
        state: Dict[str, Any],
        task_preds: Dict[str, Tensor],
        task_targets: Dict[str, Tensor],
        axis_name: Any = None,
        backend: Any = None,
    ) -> tuple:
        new_state = self.functional_update(state, task_preds, task_targets)
        batch_state = self.functional_update(self.init_state(), task_preds, task_targets)
        return new_state, self.functional_compute(batch_state, axis_name=axis_name, backend=backend)
