"""MetricTracker (port of ``tpumetrics/wrappers/tracker.py``).

``best_metric`` reads the tracked values on the host; updates read nothing.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, List, Union

import torch

from tpumetrics_torch.collections import MetricCollection
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class MetricTracker:
    """Track a metric (or a collection) over a sequence of steps: one fresh
    copy per ``increment()``; ``compute_all``/``best_metric`` sum up the
    history.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.wrappers import MetricTracker
        >>> from tpumetrics_torch.classification import BinaryAccuracy
        >>> tracker = MetricTracker(BinaryAccuracy(device="cpu"))
        >>> for step in range(3):
        ...     tracker.increment()
        ...     tracker.update(torch.tensor([1, 0, 1, int(step > 0)]), torch.tensor([1, 0, 1, 1]))
        >>> float(tracker.best_metric())
        1.0
        >>> tracker.n_steps
        3
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a tpumetrics_torch `Metric` or `MetricCollection`"
                f" but got {metric}"
            )
        self._base_metric = metric
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list):
            if not all(isinstance(m, bool) for m in maximize):
                raise ValueError("Argument `maximize` should either be a single bool or list of bool")
            if isinstance(metric, Metric):
                raise ValueError("Argument `maximize` should be a single bool when `metric` is a single Metric")
            if len(maximize) != len(metric):
                raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        self.maximize = maximize
        self._steps: List[Union[Metric, MetricCollection]] = []
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        """Number of steps tracked so far."""
        return len(self._steps)

    def increment(self) -> None:
        """Start a fresh tracked step (a new copy of the base metric)."""
        self._increment_called = True
        self._steps.append(deepcopy(self._base_metric))
        self._steps[-1].reset()

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the current step."""
        self._check_for_increment("update")
        self._steps[-1].update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Forward on the current step."""
        self._check_for_increment("forward")
        return self._steps[-1](*args, **kwargs)

    __call__ = forward

    def compute(self) -> Any:
        """Compute of the current step."""
        self._check_for_increment("compute")
        return self._steps[-1].compute()

    def compute_all(self) -> Any:
        """Per-step values, stacked (a dict of stacks for a collection)."""
        self._check_for_increment("compute_all")
        res = [step.compute() for step in self._steps]
        if isinstance(res[0], dict):
            return {k: torch.stack([r[k] for r in res]) for k in res[0]}
        if isinstance(res[0], list):
            return [torch.stack([r[i] for r in res], 0) for i in range(len(res[0]))]
        return torch.stack(res, dim=0)

    def reset(self) -> None:
        """Reset the current step."""
        if self._steps:
            self._steps[-1].reset()

    def reset_all(self) -> None:
        """Reset every tracked step."""
        for step in self._steps:
            step.reset()

    def best_metric(self, return_step: bool = False) -> Any:
        """The best value over the steps (and with ``return_step`` the step
        it was reached at), per key for a collection. A value with no single
        best (one of several elements) gives ``None`` and a warning."""
        res = self.compute_all()
        if isinstance(res, list):
            rank_zero_warn(
                "Encountered nested structure. You are probably using a metric collection inside a metric collection,"
                " or a metric wrapper inside a metric collection, which is not supported by `.best_metric()` method."
                " Returning `None` instead."
            )
            return (None, None) if return_step else None

        if isinstance(self._base_metric, Metric):
            fn = torch.argmax if self.maximize else torch.argmin
            try:
                idx = int(fn(res, 0))
                value = float(res[idx])
            except (ValueError, TypeError, RuntimeError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric: {error}"
                    " this is probably due to the 'best' not being defined for this metric."
                    " Returning `None` instead.",
                )
                return (None, None) if return_step else None
            return (value, idx) if return_step else value

        maximize = self.maximize if isinstance(self.maximize, list) else len(res) * [self.maximize]
        value, idx = {}, {}
        for i, (k, v) in enumerate(res.items()):
            try:
                fn = torch.argmax if maximize[i] else torch.argmin
                out = int(fn(v, 0))
                value[k], idx[k] = float(v[out]), out
            except (ValueError, TypeError, RuntimeError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric for metric {k}:"
                    f" {error} this is probably due to the 'best' not being defined for this metric."
                    " Returning `None` instead.",
                )
                value[k], idx[k] = None, None
        return (value, idx) if return_step else value

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise TPUMetricsUserError(f"`{method}` cannot be called before `.increment()` has been called.")
