"""ClasswiseWrapper (port of ``tpumetrics/wrappers/classwise.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from tpumetrics_torch.metric import Metric
from tpumetrics_torch.wrappers.abstract import WrapperMetric

Tensor = torch.Tensor


class ClasswiseWrapper(WrapperMetric):
    """A per-class (or per-output) result as a dict keyed by label.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.wrappers import ClasswiseWrapper
        >>> from tpumetrics_torch.classification import MulticlassAccuracy
        >>> metric = ClasswiseWrapper(
        ...     MulticlassAccuracy(num_classes=3, average=None, device="cpu"), labels=["horse", "fish", "dog"]
        ... )
        >>> out = metric(torch.tensor([0, 1, 2, 1, 0, 2]), torch.tensor([0, 1, 1, 1, 0, 0]))
        >>> sorted(out.keys())
        ['multiclassaccuracy_dog', 'multiclassaccuracy_fish', 'multiclassaccuracy_horse']
    """

    def __init__(
        self,
        metric: Metric,
        labels: Optional[List[str]] = None,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
    ) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(
                f"Expected argument `metric` to be an instance of `tpumetrics_torch.Metric` but got {metric}"
            )
        super().__init__(device=metric.device)
        self.metric = metric
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        self.labels = labels
        if prefix is not None and not isinstance(prefix, str):
            raise ValueError(f"Expected argument `prefix` to either be `None` or a string but got {prefix}")
        self._prefix = prefix
        if postfix is not None and not isinstance(postfix, str):
            raise ValueError(f"Expected argument `postfix` to either be `None` or a string but got {postfix}")
        self._postfix = postfix
        self._update_count = 1

    def _convert(self, x: Tensor) -> Dict[str, Tensor]:
        """Split a per-class vector into a dict keyed by label."""
        if not self._prefix and not self._postfix:
            prefix = f"{self.metric.__class__.__name__.lower()}_"
            postfix = ""
        else:
            prefix = self._prefix or ""
            postfix = self._postfix or ""
        if self.labels is None:
            return {f"{prefix}{i}{postfix}": val for i, val in enumerate(x)}
        if len(self.labels) != len(x):
            raise ValueError(
                f"Expected argument `labels` to have {len(x)} entries (one per class in the wrapped"
                f" metric's output), but got {len(self.labels)}"
            )
        return {f"{prefix}{lab}{postfix}": val for lab, val in zip(self.labels, x)}

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        return self._convert(self.metric(*args, **kwargs))

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def reset(self) -> None:
        self.metric.reset()

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self.metric._filter_kwargs(**kwargs)

    # ------------------------------------------------------ functional bridge
    # the wrapper's state is the wrapped metric's; only the computed value
    # becomes the labelled dict

    def init_state(self) -> Dict[str, Any]:
        return self.metric.init_state()

    def functional_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.metric.functional_update(state, *args, **kwargs)

    def functional_compute(self, state: Dict[str, Any], axis_name: Any = None, backend: Any = None) -> Dict[str, Tensor]:
        return self._convert(self.metric.functional_compute(state, axis_name=axis_name, backend=backend))

    def _sync_state_collect(
        self, state: Dict[str, Any], backend: Any, reducer: Any, group: Any = None
    ) -> Callable[[], Dict[str, Any]]:
        return self.metric._sync_state_collect(state, backend, reducer, group)

    functional_forward = Metric.functional_forward
    sync_state = Metric.sync_state
