"""Task-string dispatch base for the classification wrappers (port of
``tpumetrics/classification/base.py``).

``Accuracy(task="binary", ...)`` and the other wrappers build the binary,
multiclass or multilabel metric in ``__new__`` and return it, so the
wrapper class itself is never instantiated; its ``update`` and
``compute`` only raise.
"""

from __future__ import annotations

from typing import Any

from tpumetrics_torch.metric import Metric


class _ClassificationTaskWrapper(Metric):
    """Base class for the task-dispatching wrapper metrics."""

    def update(self, *args: Any, **kwargs: Any) -> None:
        raise TypeError(
            f"{self.__class__.__name__} metric does not have an `update` method. "
            "This is a wrapper class: construct it with a `task` argument to get a concrete metric."
        )

    def compute(self) -> None:
        raise TypeError(
            f"{self.__class__.__name__} metric does not have a `compute` method. "
            "This is a wrapper class: construct it with a `task` argument to get a concrete metric."
        )
