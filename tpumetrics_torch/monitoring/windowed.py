"""Sliding-window and exponentially-decayed aggregators for unbounded streams
(counterpart of ``tpumetrics/monitoring/windowed.py``).

The run-to-completion aggregators (``tpumetrics_torch.aggregation``) answer
"what is the mean/sum/extremum of *everything* seen so far"; a monitoring
stream never ends, and "the metric" is the last N updates. Two fixed-shape
answers, both free of host reads in ``update`` (a fused collection captures
them):

- **Sliding window** (:class:`WindowedMean` / :class:`WindowedSum` /
  :class:`WindowedMax` / :class:`WindowedMin`): a ring of ``slots``
  **sub-window states**, each covering ``window // slots`` consecutive
  ``update()`` calls. An update folds the batch into the current slot;
  rotating into a slot resets just that slot (one ``index_copy``), state
  shapes are static (``(slots,)``), and the ring index is a device function
  of the ``count`` state. With ``slots == window`` (the default) the window
  is exact; coarser ``slots`` cover between ``window - pane + 1`` and
  ``window`` most recent updates (``pane = window // slots``).
- **Exponential decay** (:class:`DecayedMean`): every update multiplies the
  accumulated sum and weight by ``alpha = 2**(-1/half_life)`` before adding
  the batch. Two scalars of state.

Distribution contract: slot and decayed accumulators are per-rank shares
(``dist_reduce_fx="sum"``, extrema ``"max"``/``"min"``), and the ``count``
tick is identical across ranks (``"max"``, the idempotent fold).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple, Union

import torch

from tpumetrics_torch.metric import Metric
from tpumetrics_torch.monitoring.sketch import _as_values, _broadcast_rowmask, _require_static_int, ring_position
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

Tensor = torch.Tensor

__all__ = [
    "DecayedMean",
    "WindowedMax",
    "WindowedMean",
    "WindowedMin",
    "WindowedSum",
]


def _weights(metric: Metric, weight: Any, like: Tensor) -> Tensor:
    """``weight`` broadcast to ``like``: a Python number becomes a fill on the
    device (no host copy, so a capture may run it)."""
    if isinstance(weight, Tensor):
        return weight.to(metric._dtype).expand(like.shape)
    return torch.full_like(like, float(weight))


class _WindowedAggregator(Metric):
    """Ring-of-sub-window-states base: window bookkeeping and the pane
    rotation. Subclasses declare their slot states and fold batches via
    :meth:`_write_slot`."""

    is_differentiable = None
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        window: int,
        slots: Optional[int] = None,
        nan_strategy: Union[str, float] = "ignore",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.window = _require_static_int(window, "window")
        if self.window < 1:
            raise TPUMetricsUserError(f"window must be >= 1 update, got {self.window}")
        self.slots = _require_static_int(slots if slots is not None else self.window, "slots")
        if self.slots < 1 or self.slots > self.window or self.window % self.slots:
            raise TPUMetricsUserError(
                f"slots ({self.slots}) must evenly divide window ({self.window}): each "
                "slot covers window // slots consecutive updates."
            )
        if nan_strategy not in ("ignore", "disable") and not isinstance(nan_strategy, float):
            raise TPUMetricsUserError(
                "Windowed aggregators are trace-first: nan_strategy must be 'ignore', "
                f"'disable', or a float fill value, got {nan_strategy!r}"
            )
        self.nan_strategy = nan_strategy
        self._pane_updates = self.window // self.slots
        # the tick counter driving the ring; ranks hold identical values
        self.add_state("count", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")

    # ------------------------------------------------------------- ingestion

    def _prepare(self, value: Any, weight: Any, valid: Optional[Tensor], neutral: float) -> Tuple[Tensor, Tensor]:
        """Batch -> (values, weights) with the ``valid`` mask and the NaN
        policy applied as masking (masked rows carry zero weight and the
        reduction's neutral element)."""
        v = _as_values(self, value)
        w = _weights(self, weight, v)
        if valid is not None:
            w = w * _broadcast_rowmask(valid, v).to(v.dtype)
        if self.nan_strategy != "disable":
            nan = torch.isnan(v) | torch.isnan(w)
            if isinstance(self.nan_strategy, float):
                v = torch.where(nan, self.nan_strategy, v)
                w = torch.where(torch.isnan(w), 0.0, w)
            else:  # "ignore": masked out entirely
                v = torch.where(nan, neutral, v)
                w = torch.where(nan, 0.0, w)
        dead = w == 0
        return torch.where(dead, neutral, v), w

    def _write_slot(self, name: str, batch_value: Tensor, neutral: float, combine: Callable) -> None:
        """Fold ``batch_value`` into the current pane's slot of state
        ``name``; the first update of a pane resets (evicts) the slot first."""
        slots = getattr(self, name)
        idx, fresh = ring_position(self.count, self._pane_updates, self.slots)
        at = idx.reshape(1).long()
        current = slots.index_select(0, at)[0]
        base = torch.where(fresh, torch.full_like(current, neutral), current)
        setattr(self, name, slots.index_copy(0, at, combine(base, batch_value.to(slots.dtype)).reshape(1)))

    def _tick(self) -> None:
        self.count = self.count + 1


class WindowedMean(_WindowedAggregator):
    """(Weighted) mean over the last ``window`` updates.

    Example:
        >>> from tpumetrics_torch.monitoring import WindowedMean
        >>> m = WindowedMean(window=2, device="cpu")
        >>> for x in (1.0, 2.0, 3.0, 4.0):
        ...     m.update(x)
        >>> float(m.compute())  # mean of the last 2 updates
        3.5
    """

    def __init__(self, window: int, slots: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(window, slots=slots, **kwargs)
        self.add_state("slot_sum", default=torch.zeros((self.slots,)), dist_reduce_fx="sum")
        self.add_state("slot_weight", default=torch.zeros((self.slots,)), dist_reduce_fx="sum")

    def update(self, value: Any, weight: Any = 1.0, valid: Optional[Tensor] = None) -> None:
        v, w = self._prepare(value, weight, valid, neutral=0.0)
        self._write_slot("slot_sum", (v * w).sum(), 0.0, torch.add)
        self._write_slot("slot_weight", w.sum(), 0.0, torch.add)
        self._tick()

    def compute(self) -> Tensor:
        return self.slot_sum.sum() / self.slot_weight.sum()


class WindowedSum(_WindowedAggregator):
    """Sum over the last ``window`` updates.

    Example:
        >>> from tpumetrics_torch.monitoring import WindowedSum
        >>> m = WindowedSum(window=2, device="cpu")
        >>> for x in (1.0, 2.0, 3.0):
        ...     m.update(x)
        >>> float(m.compute())
        5.0
    """

    def __init__(self, window: int, slots: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(window, slots=slots, **kwargs)
        self.add_state("slot_sum", default=torch.zeros((self.slots,)), dist_reduce_fx="sum")

    def update(self, value: Any, valid: Optional[Tensor] = None) -> None:
        v, w = self._prepare(value, 1.0, valid, neutral=0.0)
        self._write_slot("slot_sum", (v * w).sum(), 0.0, torch.add)
        self._tick()

    def compute(self) -> Tensor:
        return self.slot_sum.sum()


def _extreme(v: Tensor, neutral: float, reduce: Callable[[Tensor], Tensor]) -> Tensor:
    """``reduce(v)``, or ``neutral`` for a zero-size batch (which still ticks)."""
    return reduce(v) if v.numel() else torch.full((), neutral, dtype=v.dtype, device=v.device)


class WindowedMax(_WindowedAggregator):
    """Max over the last ``window`` updates (``-inf`` before any data).

    Example:
        >>> from tpumetrics_torch.monitoring import WindowedMax
        >>> m = WindowedMax(window=2, device="cpu")
        >>> for x in (9.0, 1.0, 2.0):
        ...     m.update(x)
        >>> float(m.compute())  # the 9 has slid out
        2.0
    """

    def __init__(self, window: int, slots: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(window, slots=slots, **kwargs)
        self.add_state("slot_max", default=torch.full((self.slots,), -math.inf), dist_reduce_fx="max")

    def update(self, value: Any, valid: Optional[Tensor] = None) -> None:
        v, _w = self._prepare(value, 1.0, valid, neutral=-math.inf)
        self._write_slot("slot_max", _extreme(v, -math.inf, torch.amax), -math.inf, torch.maximum)
        self._tick()

    def compute(self) -> Tensor:
        return self.slot_max.amax()


class WindowedMin(_WindowedAggregator):
    """Min over the last ``window`` updates (``+inf`` before any data).

    Example:
        >>> from tpumetrics_torch.monitoring import WindowedMin
        >>> m = WindowedMin(window=2, device="cpu")
        >>> for x in (0.5, 3.0, 2.0):
        ...     m.update(x)
        >>> float(m.compute())
        2.0
    """

    def __init__(self, window: int, slots: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(window, slots=slots, **kwargs)
        self.add_state("slot_min", default=torch.full((self.slots,), math.inf), dist_reduce_fx="min")

    def update(self, value: Any, valid: Optional[Tensor] = None) -> None:
        v, _w = self._prepare(value, 1.0, valid, neutral=math.inf)
        self._write_slot("slot_min", _extreme(v, math.inf, torch.amin), math.inf, torch.minimum)
        self._tick()

    def compute(self) -> Tensor:
        return self.slot_min.amin()


class DecayedMean(Metric):
    """Exponentially-decayed (weighted) mean: each ``update()`` halves the
    influence of observations ``half_life`` updates old.

    Two scalars of state (the decayed sum and the decayed weight, both
    ``dist_reduce_fx="sum"``) and one multiply-add per update. ``half_life``
    is measured in ``update()`` calls and must be a Python number.

    Example:
        >>> from tpumetrics_torch.monitoring import DecayedMean
        >>> m = DecayedMean(half_life=1, device="cpu")
        >>> for x in (0.0, 0.0, 8.0):
        ...     m.update(x)
        >>> round(float(m.compute()), 4)  # (8 + 0/2 + 0/4) / (1 + 1/2 + 1/4)
        4.5714
    """

    is_differentiable = None
    higher_is_better = None
    full_state_update: bool = False

    def __init__(self, half_life: float = 100.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if isinstance(half_life, Tensor):
            raise TPUMetricsUserError(
                "half_life must be a static python number: it parameterizes the update, not a state."
            )
        self.half_life = float(half_life)
        if not self.half_life > 0:
            raise TPUMetricsUserError(f"half_life must be > 0 updates, got {half_life}")
        self._alpha = 2.0 ** (-1.0 / self.half_life)
        self.add_state("decayed_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("decayed_weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Any, weight: Any = 1.0, valid: Optional[Tensor] = None) -> None:
        v = _as_values(self, value)
        w = _weights(self, weight, v)
        if valid is not None:
            w = w * _broadcast_rowmask(valid, v).to(v.dtype)
        nan = torch.isnan(v) | torch.isnan(w)
        v = torch.where(nan, 0.0, v)
        w = torch.where(nan, 0.0, w)
        self.decayed_sum = self.decayed_sum * self._alpha + (v * w).sum()
        self.decayed_weight = self.decayed_weight * self._alpha + w.sum()

    def compute(self) -> Tensor:
        return self.decayed_sum / self.decayed_weight
