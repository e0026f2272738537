"""Pure cross-replica state merging, and its inverse, resharding
(counterpart of ``tpumetrics/parallel/merge.py``).

:func:`merge_metric_states` is the reduce step applied after gathering every
rank's state, as a pure function over state dicts (checkpoint merging, and
ranks emulated in one process). :func:`reshard_metric_states` splits one
merged global state back into per-rank states for a possibly different
world size, such that merging the resharded ranks again (plus whatever they
accumulate afterwards) reproduces the global result.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch

from tpumetrics_torch.buffers import MaskedBuffer, buffer_append, buffer_merge, create_buffer, materialize
from tpumetrics_torch.utils.data import dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError


def _state_label(owner: Optional[str], name: str) -> str:
    """``MetricClass.state`` when the owning class is known, else the state name."""
    return f"{owner}.{name}" if owner else name


class AssociativeMerge:
    """A custom ``dist_reduce_fx`` with a declared identity.

    - **fold**: ``fn(stacked)`` over a rank-stacked tensor; ``fn`` must be
      associative and commutative, so the order of the fold never matters.
    - **reshard**: the folded value lands whole on rank 0 and every other
      rank receives ``identity_like(value)``, so a later fold reproduces it.

    Args:
        fn: ``(stacked: (R, *state_shape)) -> (*state_shape)`` fold over the
            leading rank axis.
        identity_like: ``(value) -> identity`` with ``value``'s shape and
            dtype (what an empty rank contributes).
        name: short kind label.
        params: declaration parameters (e.g. a sketch's capacity), named in
            spec errors.
    """

    def __init__(
        self,
        fn: Callable[[Any], Any],
        identity_like: Callable[[Any], Any],
        name: str = "merge",
        params: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._fn = fn
        self._identity_like = identity_like
        self.name = str(name)
        self.params = dict(params or {})

    def __call__(self, stacked: Any) -> Any:
        return self._fn(stacked)

    def identity_like(self, value: Any) -> Any:
        """The merge identity shaped like ``value``: ``fn(stack([x, identity_like(x)])) == x``."""
        return self._identity_like(value)

    def describe(self) -> str:
        """Human label for spec errors: ``merge:<name>(k=v, ...)``."""
        inner = ", ".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return f"merge:{self.name}({inner})" if inner else f"merge:{self.name}"

    def __repr__(self) -> str:
        return f"AssociativeMerge({self.describe()})"


def merge_metric_states(
    states: List[Dict[str, Any]],
    reductions: Dict[str, Optional[Union[str, Callable]]],
    owner: Optional[str] = None,
) -> Dict[str, Any]:
    """Merge per-rank state dicts into one global state by each state's reduce op.

    ``reductions`` maps state name to registered reduce function (as in
    ``Metric._reductions``). List states are concatenated (reduce-None lists
    keep their items); ``None`` tensor states are stacked on a new leading
    rank axis. ``owner`` (the metric class name) only labels errors.
    """
    if not states:
        raise ValueError("need at least one state to merge")
    out: Dict[str, Any] = {}
    for name, reduction_fn in reductions.items():
        vals = [s[name] for s in states]
        if isinstance(vals[0], MaskedBuffer):
            out[name] = buffer_merge(vals)
            continue
        if isinstance(vals[0], list):
            flat = [v for sub in vals for v in sub]
            if reduction_fn is None:
                out[name] = flat
            else:
                out[name] = [dim_zero_cat(flat)] if flat else []
            continue
        if reduction_fn is dim_zero_cat:
            out[name] = dim_zero_cat([torch.atleast_1d(v) for v in vals])
        elif reduction_fn is None:
            out[name] = torch.stack(vals)
        elif callable(reduction_fn):
            out[name] = reduction_fn(torch.stack(vals))
        else:
            raise TypeError(f"reduction for state {_state_label(owner, name)!r} must be callable or None")
    return out


def _split_rows(n_rows: int, rank: int, world_size: int) -> slice:
    """The contiguous rows rank ``rank`` owns of ``n_rows`` (earlier ranks
    get the larger remainders, as ``np.array_split``)."""
    base, extra = divmod(n_rows, world_size)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (1 if rank < extra else 0))


def _placement_slice(n_rows: int, rank: int, world_size: int, cat_placement: str) -> slice:
    """The rows rank ``rank`` receives: all on rank 0 (``"rank0"``) or a
    near-even contiguous share (``"balanced"``)."""
    if cat_placement == "balanced":
        return _split_rows(n_rows, rank, world_size)
    return slice(0, n_rows) if rank == 0 else slice(0, 0)


def _reshard_buffer(buf: MaskedBuffer, rank: int, world_size: int, template: MaskedBuffer, cat_placement: str, label: str) -> MaskedBuffer:
    """Rank ``rank``'s share of a merged buffer, in a buffer of the
    template's capacity. More placed rows than that capacity raise."""
    rows = materialize(buf)
    mine = rows[_placement_slice(int(rows.shape[0]), rank, world_size, cat_placement)]
    capacity = int(template.values.shape[0])
    if int(mine.shape[0]) > capacity:
        raise TPUMetricsUserError(
            f"Resharding buffer state {label!r} would place {int(mine.shape[0])} rows on rank {rank} but the"
            f" per-rank capacity is {capacity}; refusing to drop restored rows. HINT: use"
            " cat_placement='balanced' to spread rows across ranks, or raise the state's declared capacity."
        )
    values = template.values
    out = create_buffer(capacity, tuple(values.shape[1:]), values.dtype, values.device)
    if mine.shape[0]:
        out = buffer_append(out, mine)
    if rank == 0:
        # rows the merged buffer had already dropped stay counted on rank 0
        out = out._replace(requested=out.requested + (buf.requested.to(torch.int32) - buf.count.to(torch.int32)))
    return out


def reshard_metric_states(
    global_state: Dict[str, Any],
    reductions: Dict[str, Optional[Union[str, Callable]]],
    rank: int,
    world_size: int,
    templates: Optional[Dict[str, Any]] = None,
    cat_placement: str = "rank0",
    owner: Optional[str] = None,
) -> Dict[str, Any]:
    """Split one merged global state into rank ``rank``'s share of a
    ``world_size``-rank world (the inverse of :func:`merge_metric_states`).

    - **sum**: rank 0 carries the value, every other rank zeros.
    - **max / min / mean**: every rank carries the value.
    - **cat / list / buffer**: rows are placed by ``cat_placement``,
      ``"rank0"`` (all on rank 0, which keeps the global row order) or
      ``"balanced"`` (contiguous shares).
    - :class:`AssociativeMerge`: the value on rank 0, the declared identity
      elsewhere.
    - reduce-``None`` tensor states and bare callables have no inverse and raise.

    ``templates`` gives the per-rank default leaves where the global value
    cannot (MaskedBuffer capacities): pass ``metric.init_state()``.
    """
    if not (0 <= rank < world_size):
        raise ValueError(f"rank must be in [0, {world_size}), got {rank}")
    if cat_placement not in ("rank0", "balanced"):
        raise ValueError(f"cat_placement must be 'rank0' or 'balanced', got {cat_placement!r}")
    out: Dict[str, Any] = {}
    for name, reduction_fn in reductions.items():
        label = _state_label(owner, name)
        val = global_state[name]
        if isinstance(val, MaskedBuffer):
            template = (templates or {}).get(name)
            if not isinstance(template, MaskedBuffer):
                raise TPUMetricsUserError(
                    f"Resharding buffer state {label!r} needs a MaskedBuffer template "
                    "(per-rank capacity); pass templates=metric.init_state()."
                )
            out[name] = _reshard_buffer(val, rank, world_size, template, cat_placement, label)
            continue
        if isinstance(val, list):
            if reduction_fn is None:
                # ragged per-item lists keep their items whole
                out[name] = list(val)[_placement_slice(len(val), rank, world_size, cat_placement)]
                continue
            if not val:
                out[name] = []
                continue
            rows = dim_zero_cat([torch.atleast_1d(v) for v in val])
            mine_rows = rows[_placement_slice(int(rows.shape[0]), rank, world_size, cat_placement)]
            out[name] = [mine_rows] if int(mine_rows.shape[0]) else []
            continue
        if reduction_fn is dim_zero_sum:
            out[name] = val if rank == 0 else torch.zeros_like(val)
        elif reduction_fn in (dim_zero_mean, dim_zero_max, dim_zero_min):
            out[name] = val
        elif reduction_fn is dim_zero_cat:
            rows = torch.atleast_1d(val)
            out[name] = rows[_placement_slice(int(rows.shape[0]), rank, world_size, cat_placement)]
        elif reduction_fn is None:
            raise TPUMetricsUserError(
                f"State {label!r} uses gather (dist_reduce_fx=None) semantics on a tensor: its global form is a"
                " per-rank stack with no world-size-independent meaning, so it cannot be resharded."
            )
        elif isinstance(reduction_fn, AssociativeMerge):
            out[name] = val if rank == 0 else reduction_fn.identity_like(val)
        elif callable(reduction_fn):
            raise TPUMetricsUserError(
                f"State {label!r} uses a custom reduce function; resharding has no generic inverse for it."
                " Register the state with one of 'sum'/'mean'/'max'/'min'/'cat', or wrap the merge in"
                " tpumetrics_torch.parallel.merge.AssociativeMerge (declared identity)."
            )
        else:
            raise TypeError(f"reduction for state {label!r} must be callable or None")
    return out
