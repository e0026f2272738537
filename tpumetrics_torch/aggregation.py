"""Aggregation metrics: Max / Min / Sum / Cat / Mean and running variants
(counterpart of ``tpumetrics/aggregation.py``).

NaN handling: a float ``nan_strategy`` replaces NaNs on the device and
``"disable"`` skips the check; both leave the host out of ``update``.
``"error"``, ``"warn"`` and ``"ignore"`` read whether the batch holds a NaN
on the host in every ``update`` (as the JAX package's eager path does), and
``"warn"``/``"ignore"`` then drop those entries. Inside a CUDA graph capture
nothing may be read on the host: there, as under ``jit`` in the JAX package,
a NaN entry becomes the reduction's identity with a zero weight.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _is_capturing
from tpumetrics_torch.utils.data import dim_zero_cat
from tpumetrics_torch.utils.prints import rank_zero_warn
from tpumetrics_torch.wrappers.running import Running

Tensor = torch.Tensor


class BaseAggregator(Metric):
    """Base class for aggregation metrics: one state and its reduce function.

    Args:
        fn: the state's ``dist_reduce_fx``.
        default_value: the state's default (the reduction's identity).
        nan_strategy: ``"error"``, ``"warn"``, ``"ignore"``, ``"disable"``
            or a float that replaces every NaN.
        state_name: the state's name.
        kwargs: the base :class:`~tpumetrics_torch.metric.Metric`'s kwargs
            (``device=``, sync options).
    """

    is_differentiable = None
    higher_is_better = None
    full_state_update: bool = False
    #: what a NaN entry becomes inside a CUDA graph capture (the reduction's identity)
    _capture_nan_fill = 0.0

    def __init__(
        self,
        fn: str,
        default_value: Union[Tensor, list],
        nan_strategy: Union[str, float] = "error",
        state_name: str = "value",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore", "disable")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, float):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy} but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.add_state(state_name, default=default_value, dist_reduce_fx=fn)
        self.state_name = state_name

    def _cast_and_nan_check_input(
        self, x: Union[float, Tensor], weight: Optional[Union[float, Tensor]] = None
    ) -> Tuple[Tensor, Tensor]:
        """Cast to float tensors on the metric's device and apply the NaN policy."""
        x = torch.as_tensor(x, dtype=self._dtype, device=self.device)
        if weight is None:
            weight = torch.ones_like(x)
        elif isinstance(weight, (int, float)):
            weight = torch.full_like(x, weight)  # a fill, not a copy from the host
        else:
            weight = torch.as_tensor(weight, dtype=self._dtype, device=self.device)
        weight = weight.broadcast_to(x.shape)
        if self.nan_strategy == "disable":
            return x, weight
        nans = torch.isnan(x)
        wnans = torch.isnan(weight)
        if isinstance(self.nan_strategy, float):
            return torch.where(nans, self.nan_strategy, x), torch.where(wnans, self.nan_strategy, weight)
        anynan = nans | wnans
        if _is_capturing():
            return torch.where(anynan, self._capture_nan_fill, x), torch.where(anynan, 0.0, weight)
        if bool(anynan.any()):  # reads the device: the eager checks of these strategies
            if self.nan_strategy == "error":
                raise RuntimeError("Encountered `nan` values in tensor")
            if self.nan_strategy == "warn":
                rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
            keep = ~anynan
            return x[keep], weight[keep]
        return x, weight

    def update(self, value: Union[float, Tensor]) -> None:
        """Overridden by each aggregator."""

    def compute(self) -> Tensor:
        """The aggregated value."""
        return getattr(self, self.state_name)


class MaxMetric(BaseAggregator):
    """Running max of a stream of values.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.aggregation import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> float(metric.compute())
        3.0
    """

    full_state_update: bool = True
    _capture_nan_fill = float("-inf")

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", -torch.tensor(float("inf")), nan_strategy, state_name="max_value", **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():  # an empty (fully NaN-filtered) batch is a no-op
            self.max_value = torch.maximum(self.max_value, value.max())


class MinMetric(BaseAggregator):
    """Running min of a stream of values.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.aggregation import MinMetric
        >>> metric = MinMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> float(metric.compute())
        1.0
    """

    full_state_update: bool = True
    _capture_nan_fill = float("inf")

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, state_name="min_value", **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.min_value = torch.minimum(self.min_value, value.min())


class SumMetric(BaseAggregator):
    """Running sum of a stream of values.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.aggregation import SumMetric
        >>> metric = SumMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> float(metric.compute())
        6.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, state_name="sum_value", **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.sum_value = self.sum_value + value.sum()


class CatMetric(BaseAggregator):
    """Concatenate a stream of values. It keeps every value it is given, so
    its state grows with the stream.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.aggregation import CatMetric
        >>> metric = CatMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute().tolist()
        [1.0, 2.0, 3.0]
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value.append(value)

    def compute(self) -> Union[Tensor, list]:
        if isinstance(self.value, list) and self.value:
            return dim_zero_cat(self.value)
        return self.value


class MeanMetric(BaseAggregator):
    """(Weighted) running mean of a stream of values.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.aggregation import MeanMetric
        >>> metric = MeanMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> float(metric.compute())
        2.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, state_name="mean_value", **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        """Accumulate the weighted sum and the total weight."""
        value, weight = self._cast_and_nan_check_input(value, weight)
        if value.numel() == 0:
            return
        self.mean_value = self.mean_value + (value * weight).sum()
        self.weight = self.weight + weight.sum()

    def compute(self) -> Tensor:
        return self.mean_value / self.weight


class RunningMean(Running):
    """Mean over a running window of the last ``window`` updates.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.aggregation import RunningMean
        >>> metric = RunningMean(window=2, device="cpu")
        >>> for i in range(4):
        ...     _ = metric.update(torch.tensor(float(i)))
        >>> float(metric.compute())  # mean of [2, 3]
        2.5
    """

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(base_metric=MeanMetric(nan_strategy=nan_strategy, **kwargs), window=window)


class RunningSum(Running):
    """Sum over a running window of the last ``window`` updates.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.aggregation import RunningSum
        >>> metric = RunningSum(window=2, device="cpu")
        >>> for i in range(4):
        ...     _ = metric.update(torch.tensor(float(i)))
        >>> float(metric.compute())  # 2 + 3
        5.0
    """

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(base_metric=SumMetric(nan_strategy=nan_strategy, **kwargs), window=window)


__all__ = [
    "BaseAggregator",
    "CatMetric",
    "MaxMetric",
    "MeanMetric",
    "MinMetric",
    "RunningMean",
    "RunningSum",
    "SumMetric",
]
