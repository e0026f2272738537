"""Mergeable quantile/histogram sketches as a metric state kind (counterpart
of ``tpumetrics/monitoring/sketch.py``).

The sketch is a **log-linear histogram**: ``levels`` geometric magnitude
ranges, each split into ``capacity`` linear buckets, one mirrored set per
sign, plus exact total/min/max slots, all packed into ONE flat float32
tensor, so the whole sketch is a single fixed-shape metric state:

======================= ==================================================
layout (last axis)      meaning
======================= ==================================================
``[0, L*k)``            positive-magnitude counts, level-major
``[L*k, 2*L*k)``        negative-magnitude counts, level-major
``[2*L*k]``             total observation count
``[2*L*k + 1]``         exact min (identity ``+inf``)
``[2*L*k + 2]``         exact max (identity ``-inf``)
======================= ==================================================

Level 0 covers magnitudes ``[0, unit)`` with linear buckets of width
``unit/capacity``; level ``l >= 1`` covers ``[unit*2**(l-1), unit*2**l)``
with ``capacity`` linear buckets each, every bucket ``[lo, hi)``. Quantile
estimates carry a **relative error <= 1/capacity** for magnitudes in
``[unit, unit*2**(levels-1))`` and an absolute error ``<= unit/capacity``
below ``unit``; values past the top level (``+-inf`` too) clip into the last
bucket, NaN and masked samples carry weight 0, and ``-0.0`` counts as
positive.

**The bucket index is exact.** :meth:`SketchLayout.bucket_index` takes the
level from the exponent bits of ``|x| / unit`` in float64 (an exact quotient
for a power-of-two unit, the default; for any other unit the level is
checked against its bounds, built as exact powers of two), so a value on a
level or bucket edge lands in the bucket that starts there, on the CPU and
on a card alike. The JAX package computes the level with a float32
``log2`` and the bounds with ``exp2``, which XLA's CPU backend does not
evaluate exactly at integers: it puts some edge values (the integers 3, 33,
34, ... under the default layout) one bucket low. The port follows the
documented math, not that rounding.

**Counts are exact as integers.** The update's weights are 0/1 (valid and
not NaN), so the float32 ``index_add`` of a batch is exact in any order,
atomic order on a card included, while a bucket holds fewer than ``2**24``
samples: the card's sketch is the CPU's bit for bit. A fractional ``valid``
mask is not covered. The total slot is a sequence of exact per-batch sums,
so it rounds past ``2**24`` alike on both devices. Readers take the
cumulative counts in float64 (exact for integer counts, in any order).

The merge of two sketches is an **elementwise sum of the count slots plus
min/max of the extrema slots**: associative, commutative and bit-identical
under any fold order, registered through ``add_state(...,
dist_reduce_fx=sketch_merge(layout))``, an
:class:`~tpumetrics_torch.parallel.merge.AssociativeMerge` whose identity
is the empty sketch.

**Windowing**: sketch-backed metrics optionally keep a ring of ``slots``
sub-sketches (shape ``(slots, N)``), each covering ``window/slots``
consecutive updates; rotating into a slot resets just that row. The ring
index is a device function of the ``count`` state, read and written with
``index_select``/``index_copy``, so an update never reads the host and a
fused collection captures it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpumetrics_torch.metric import Metric
from tpumetrics_torch.parallel.merge import AssociativeMerge
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

Tensor = torch.Tensor

__all__ = [
    "SketchLayout",
    "SketchQuantiles",
    "empty_sketch",
    "sketch_merge",
]


def _require_static_int(value: Any, name: str) -> int:
    """Sketch/window geometry is state SHAPE: it must be a Python int (a
    tensor would make shapes data-dependent). A non-integral float is
    rejected too, rather than truncated."""
    if isinstance(value, (Tensor, np.ndarray)) or isinstance(value, bool):
        raise TPUMetricsUserError(
            f"`{name}` must be a static python int (got {type(value).__name__}): "
            "it determines state shapes."
        )
    if int(value) != value:
        raise TPUMetricsUserError(f"`{name}` must be a static python int, got {value!r} (refusing to truncate).")
    return int(value)


def _pow2(k: Tensor) -> Tensor:
    """``2.0 ** k`` in float64, exactly, from the exponent bits (``k`` an
    int64 tensor within the normal range)."""
    return torch.bitwise_left_shift(k + 1023, 52).view(torch.float64)


class SketchLayout:
    """Static geometry of one sketch row: index math, representative values,
    and the merge/identity pair. Hash/eq by parameters.

    ``unit`` defaults to ``2**(24 - levels)``, anchoring the TOP of the
    covered range at ``unit * 2**(levels-1) = 2**23`` whatever ``levels``
    is, so fewer levels coarsen precision near zero instead of cutting the
    range off. Set ``unit`` explicitly when small magnitudes need relative
    precision."""

    def __init__(self, levels: int = 44, capacity: int = 64, unit: Optional[float] = None) -> None:
        self.levels = _require_static_int(levels, "levels")
        self.capacity = _require_static_int(capacity, "capacity")
        self.unit = float(unit) if unit is not None else 2.0 ** (24 - self.levels)
        if self.levels < 2 or self.capacity < 2:
            raise TPUMetricsUserError(
                f"Sketch needs levels >= 2 and capacity >= 2, got levels={self.levels}, capacity={self.capacity}"
            )
        if not (self.unit > 0.0 and math.isfinite(self.unit)):
            raise TPUMetricsUserError(f"Sketch unit must be a positive finite float, got {unit}")
        # a power-of-two unit divides exactly, so the level read from the quotient needs no check
        self._unit_is_pow2 = math.frexp(self.unit)[0] == 0.5
        self.side = self.levels * self.capacity  # buckets per sign
        self.total_index = 2 * self.side
        self.min_index = 2 * self.side + 1
        self.max_index = 2 * self.side + 2
        self.width = 2 * self.side + 3  # N: flat row length
        # representative (midpoint) magnitude per positive bucket, level-major
        lvl = np.repeat(np.arange(self.levels), self.capacity)
        j = np.tile(np.arange(self.capacity), self.levels)
        lo = np.where(lvl == 0, 0.0, self.unit * 2.0 ** (lvl - 1))
        width = np.where(lvl == 0, self.unit, self.unit * 2.0 ** (lvl - 1)) / self.capacity
        self._reps = (lo + (j + 0.5) * width).astype(np.float32)
        # canonical ascending value order: negatives (magnitude descending)
        # then positives (magnitude ascending)
        self._ordered_reps = np.concatenate([-self._reps[::-1], self._reps]).astype(np.float32)
        self._reps_on: Dict[torch.device, Tensor] = {}

    @property
    def params(self) -> dict:
        return {"levels": self.levels, "capacity": self.capacity, "unit": self.unit}

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, SketchLayout) and self.params == other.params

    def __hash__(self) -> int:
        return hash((self.levels, self.capacity, self.unit))

    def __repr__(self) -> str:
        return f"SketchLayout(levels={self.levels}, capacity={self.capacity}, unit={self.unit!r})"

    # ------------------------------------------------------------- ingestion

    def bucket_index(self, values: Tensor) -> Tensor:
        """Flat count-slot index per value (sign-mirrored, level-major), int64,
        on ``values``' device; no host read. A value lands in the bucket
        ``[lo, hi)`` that holds it exactly (see the module note); NaN bins
        like a masked zero."""
        a = values.to(torch.float64).abs()  # exact for float32 and narrower inputs
        a = torch.where(torch.isnan(a), 0.0, a)
        # the level: floor(log2(|x| / unit)) + 1, from the quotient's exponent bits (|x| clipped into the
        # covered range first, +inf to the top)
        safe = torch.clamp(a, min=self.unit * 2.0**-40, max=self.unit * 2.0 ** (self.levels + 1))
        lvl = torch.bitwise_right_shift((safe / self.unit).view(torch.int64), 52) - 1022
        if not self._unit_is_pow2:
            # the quotient rounds once, which moves it across at most one of the level's bounds
            # unit * 2**(lvl-1) and unit * 2**lvl: check it against both
            lvl = torch.clamp(lvl, 0, self.levels)
            lvl = lvl - (safe < self.unit * _pow2(lvl - 1)).long() + (safe >= self.unit * _pow2(lvl)).long()
        lvl = torch.clamp(lvl, 0, self.levels - 1)
        lo = torch.where(lvl == 0, 0.0, self.unit * _pow2(lvl - 1))
        width = torch.where(lvl == 0, self.unit, lo)
        # clip in float space before the int cast: +inf goes to the top bucket
        j = torch.clamp(torch.floor((a - lo) * self.capacity / width), 0, self.capacity - 1).long()
        flat = lvl * self.capacity + j
        return torch.where(values < 0, flat + self.side, flat)

    def update_row(self, row: Tensor, values: Tensor, weights: Tensor) -> Tensor:
        """One sketch-row transition: add ``weights`` at each value's bucket,
        bump the total, refresh the exact min/max (weight-0 samples are
        inert; a zero-size batch changes nothing). Out of place, static
        shapes."""
        values = values.reshape(-1)
        weights = weights.reshape(-1).to(row.dtype)
        counts = row[: self.total_index].index_add(0, self.bucket_index(values), weights)
        total = row[self.total_index] + weights.sum()
        minv, maxv = row[self.min_index], row[self.max_index]
        if values.numel():
            live = weights > 0
            minv = torch.minimum(minv, torch.where(live, values, math.inf).amin().to(row.dtype))
            maxv = torch.maximum(maxv, torch.where(live, values, -math.inf).amax().to(row.dtype))
        return torch.cat([counts, total[None], minv[None], maxv[None]])

    # ----------------------------------------------------------------- fold

    def empty(self, panes: int = 1, device: Any = None, dtype: torch.dtype = torch.float32) -> Tensor:
        """The merge identity: zero counts, ``+inf`` min, ``-inf`` max, as a
        ``(panes, N)`` ring of empty rows (``panes=1`` for an unwindowed
        sketch). Made on ``device`` with fills only, so a capture may build it."""
        def fill(n: int, value: float) -> Tensor:
            return torch.full((n,), value, dtype=dtype, device=device)

        row = torch.cat([fill(self.total_index + 1, 0.0), fill(1, math.inf), fill(1, -math.inf)])
        return row.expand(int(panes), self.width).clone()

    def merge(self, stacked: Tensor) -> Tensor:
        """Fold a rank-stacked sketch state ``(R, ..., N)`` along axis 0:
        counts (and the total slot) sum, min/max slots fold with min/max.
        Bit-identical under any fold order (the counts are integers)."""
        counts = stacked[..., : self.total_index + 1].sum(dim=0)
        minv = stacked[..., self.min_index : self.min_index + 1].amin(dim=0)
        maxv = stacked[..., self.max_index : self.max_index + 1].amax(dim=0)
        return torch.cat([counts, minv, maxv], dim=-1)

    def merge_panes(self, ring: Tensor) -> Tensor:
        """Collapse a ``(panes, N)`` ring into one logical sketch row."""
        return self.merge(ring)

    def identity_like(self, value: Any) -> Tensor:
        """The merge identity shaped like ``value`` (a method, not a
        closure, so sketch metrics stay picklable)."""
        shape = tuple(value.shape)
        panes = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return self.empty(panes, device=value.device, dtype=value.dtype).reshape(shape)

    # ---------------------------------------------------------------- reading

    def total(self, row: Tensor) -> Tensor:
        return row[..., self.total_index]

    def ordered_counts(self, row: Tensor) -> Tensor:
        """Counts in canonical ascending value order (most negative first)."""
        pos = row[..., : self.side]
        neg = row[..., self.side : self.total_index]
        return torch.cat([neg.flip(-1), pos], dim=-1)

    def cumulative_counts(self, row: Tensor) -> Tensor:
        """Cumulative ordered counts in float64: exact for integer counts,
        whatever order a card's scan adds them in."""
        return torch.cumsum(self.ordered_counts(row).to(torch.float64), dim=-1)

    def pmf(self, row: Tensor, eps: float = 0.0) -> Tensor:
        """Bucket probability masses in canonical order; an empty sketch
        yields all-zeros. ``eps`` floors each mass."""
        counts = self.ordered_counts(row)
        p = counts / torch.clamp(self.total(row), min=1.0)[..., None]
        return torch.clamp(p, min=eps) if eps else p

    def _ordered_reps_on(self, device: torch.device) -> Tensor:
        if device not in self._reps_on:
            self._reps_on[device] = torch.from_numpy(self._ordered_reps).to(device)
        return self._reps_on[device]

    def quantile(self, row: Tensor, q: Any) -> Tensor:
        """Quantile estimate(s) from one logical sketch row: bucket-midpoint
        lookup on the cumulative counts, clamped into the exact ``[min,
        max]`` envelope. ``q`` may be a scalar or a vector; an empty sketch
        returns NaN. The rank ``q * total`` is taken in float32, as the JAX
        package takes it, and the cumulative counts exactly (float64)."""
        qs = torch.as_tensor(q, dtype=torch.float32, device=row.device)
        total = self.total(row)
        rank = (qs * total).to(torch.float64)
        idx = torch.searchsorted(self.cumulative_counts(row), rank.reshape(-1), side="left").reshape(rank.shape)
        idx = torch.clamp(idx, 0, 2 * self.side - 1)
        est = self._ordered_reps_on(row.device)[idx]
        est = torch.minimum(torch.maximum(est, row[..., self.min_index]), row[..., self.max_index])
        return torch.where(total > 0, est, math.nan)


def empty_sketch(layout: SketchLayout, panes: int = 1, device: Any = None) -> Tensor:
    """The sketch state default: the merge identity (a non-identity default
    would count twice in every cross-rank fold)."""
    return layout.empty(panes, device=device)


def sketch_merge(layout: SketchLayout) -> AssociativeMerge:
    """The sketch's ``dist_reduce_fx``: an
    :class:`~tpumetrics_torch.parallel.merge.AssociativeMerge` wrapping
    :meth:`SketchLayout.merge` with the empty sketch as its identity, carrying
    the layout's parameters. Built from bound methods (no closures), so
    sketch metrics pickle and deep-copy."""
    return AssociativeMerge(layout.merge, layout.identity_like, name="sketch", params=layout.params)


def ring_position(count: Tensor, pane_updates: int, slots: int) -> Tuple[Tensor, Tensor]:
    """``(slot index, is-first-update-of-its-pane)`` for the ``count``-th
    update of a ``slots``-slot ring whose panes span ``pane_updates``
    updates each: THE one copy of the window rotation, which the windowed
    aggregators and the sketch ring share. Device tensors, no host read."""
    idx = torch.remainder(torch.div(count, pane_updates, rounding_mode="floor"), slots)
    fresh = torch.remainder(count, pane_updates) == 0
    return idx, fresh


def _broadcast_rowmask(mask: Any, like: Tensor) -> Tensor:
    """Expand a per-row ``valid`` mask to ``like``'s shape (the mask covers
    the leading dims; trailing feature dims broadcast)."""
    mask = torch.as_tensor(mask, device=like.device)
    extra = like.ndim - mask.ndim
    if extra > 0:
        mask = mask.reshape(tuple(mask.shape) + (1,) * extra)
    return mask.expand(like.shape)


def _as_values(metric: Metric, value: Any) -> Tensor:
    """A batch as a 1-d-or-more tensor of the metric's dtype on its device."""
    return torch.atleast_1d(torch.as_tensor(value, dtype=metric._dtype, device=metric.device))


class _SketchBacked(Metric):
    """Shared machinery for sketch-state metrics: the ``(slots, N)`` ring
    state, the pane-rotating update (with a ``valid`` mask), and the merged
    logical-row reader.

    ``window`` (in ``update()`` calls) splits into ``slots`` sub-sketches of
    ``window/slots`` updates each; rotation resets one ring row.
    ``window=None`` keeps one cumulative sketch.
    """

    full_state_update: bool = False

    def __init__(
        self,
        levels: int = 44,
        capacity: int = 64,
        unit: Optional[float] = None,
        window: Optional[int] = None,
        slots: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        layout = SketchLayout(levels=levels, capacity=capacity, unit=unit)
        self._sketch_layout = layout
        self.levels = layout.levels
        self.capacity = layout.capacity
        self.unit = layout.unit
        if window is None:
            self.window = None
            self.slots = 1
        else:
            self.window = _require_static_int(window, "window")
            if self.window < 1:
                raise TPUMetricsUserError(f"window must be >= 1 update, got {self.window}")
            if slots is None:
                # largest divisor of the window <= 8: any window constructs
                slots = max(s for s in range(1, min(self.window, 8) + 1) if self.window % s == 0)
            self.slots = _require_static_int(slots, "slots")
            if self.slots < 1 or self.window % self.slots:
                raise TPUMetricsUserError(
                    f"window ({self.window}) must divide evenly into slots ({self.slots}) "
                    "sub-windows (pane size = window // slots)."
                )
        self._pane_updates = (self.window // self.slots) if self.window else 1
        self.add_state("sketch", default=empty_sketch(layout, self.slots), dist_reduce_fx=sketch_merge(layout))
        # the tick counter driving the pane ring; ranks hold identical values,
        # so the idempotent max-fold is the merge
        self.add_state("count", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")

    def update(self, value: Any, valid: Optional[Tensor] = None) -> None:
        """Fold one batch of samples into the current sub-window's sketch.

        ``valid`` is a per-row mask; masked and NaN samples carry zero
        weight. Every call ticks the window by one update, whatever the mask."""
        v = _as_values(self, value)
        w = torch.ones_like(v)
        if valid is not None:
            w = w * _broadcast_rowmask(valid, v).to(v.dtype)
        nan = torch.isnan(v)
        w = torch.where(nan, 0.0, w)
        v = torch.where(nan, 0.0, v)

        layout = self._sketch_layout
        if self.window is None:
            self.sketch = layout.update_row(self.sketch[0], v, w)[None, :]
        else:
            idx, fresh = ring_position(self.count, self._pane_updates, self.slots)
            at = idx.reshape(1).long()
            current = self.sketch.index_select(0, at)[0]
            base = torch.where(fresh, layout.empty(1, device=current.device, dtype=current.dtype)[0], current)
            self.sketch = self.sketch.index_copy(0, at, layout.update_row(base, v, w)[None, :])
        self.count = self.count + 1

    def merged_row(self) -> Tensor:
        """The ring collapsed to one logical sketch row."""
        return self._sketch_layout.merge_panes(self.sketch)

    def compute(self) -> Any:  # pragma: no cover - abstract-ish
        raise NotImplementedError


class SketchQuantiles(_SketchBacked):
    """Streaming quantiles over an unbounded (optionally windowed) stream.

    ``compute()`` returns one estimate per requested quantile, with relative
    error ``<= 1/capacity`` inside the sketch's magnitude range (the module
    note has the exact bounds). State is a fixed-shape mergeable sketch:
    cross-rank sync and the fused update work as for any reduce-op metric.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.monitoring import SketchQuantiles
        >>> m = SketchQuantiles(quantiles=(0.5,), capacity=128, device="cpu")
        >>> m.update(torch.arange(1.0, 101.0))
        >>> bool(abs(float(m.compute()) - 50.0) < 1.0)
        True
    """

    def __init__(self, quantiles: Sequence[float] = (0.5, 0.9, 0.99), **kwargs: Any) -> None:
        super().__init__(**kwargs)
        qs = tuple(float(q) for q in quantiles)
        if not qs or any(not (0.0 <= q <= 1.0) for q in qs):
            raise TPUMetricsUserError(f"quantiles must be within [0, 1], got {quantiles}")
        self.quantiles = qs

    def compute(self) -> Tensor:
        return self._sketch_layout.quantile(self.merged_row(), self.quantiles)
