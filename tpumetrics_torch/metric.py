"""The Metric base class of the port (counterpart of ``tpumetrics/metric.py``).

States are ``torch.Tensor``s (or Python lists of them for "cat"-style list
states) on one device, the metric's ``device``. A metric built without
``device=`` lives on CUDA, and raises if no card is present: it never falls
back to the CPU quietly. ``update`` refuses inputs on another device instead
of moving them.

An ``update`` changes its states by reassignment, never in place
(``self.tp = self.tp + tp``, not ``+=``), as the JAX package's immutable
arrays force. That keeps sharing a tensor between a default, a forward
cache, a functional state and the members of a compute group safe without
copies. The one exception is the fused collection update
(``MetricCollection(fused_update=True)``,
:class:`~tpumetrics_torch.parallel.fuse_update.FusedCollectionStep`): it
advances its leaders' states in place in buffers it owns, the torch form of
the JAX package's buffer donation, so a state tensor read before such an
update may change with it.

``compute`` syncs the states across ranks first (``sync_on_compute``)
through a :class:`~tpumetrics_torch.parallel.backend.DistributedBackend`:
the ambient one is ``torch.distributed`` when it is initialized with more
than one rank (NCCL for states on a card, gloo for states on the CPU).
Reduce-op states travel as one ``all_reduce`` per (op, dtype) class
(:class:`~tpumetrics_torch.parallel.fuse.FusedReducer`), list states as
gathers; ``unsync`` restores the local states afterwards.
"""

from __future__ import annotations

import copy
import functools
import inspect
from abc import ABC, abstractmethod
from contextlib import contextmanager
from typing import Any, Callable, Dict, Generator, List, Optional, Union

import torch

from tpumetrics_torch.buffers import MaskedBuffer, _BufferList, buffer_all_gather, create_buffer
from tpumetrics_torch.parallel.backend import DistributedBackend, get_default_backend
from tpumetrics_torch.parallel.backend import distributed_available as _default_distributed_available
from tpumetrics_torch.parallel.fuse import FusedReducer
from tpumetrics_torch.telemetry import ledger as _telemetry
from tpumetrics_torch.utils.data import (
    _flatten,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor
StateType = Union[Tensor, List[Tensor]]

_CONST_ATTRS = ("higher_is_better", "is_differentiable", "full_state_update")

_REDUCE_FNS = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "cat": dim_zero_cat,
    "min": dim_zero_min,
    "max": dim_zero_max,
}


def _resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device states live on: CUDA unless told otherwise. Raises when CUDA
    is asked for (or defaulted to) and no card is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is available; metrics default to device='cuda'. Pass device='cpu' to run on the CPU."
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _squeeze_if_scalar(value: Any) -> Any:
    """Collapse single-element tensors to 0-d tensors, through dicts, lists and tuples."""
    if isinstance(value, Tensor):
        return value.reshape(()) if value.ndim > 0 and value.numel() == 1 else value
    if isinstance(value, dict):
        return {k: _squeeze_if_scalar(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_squeeze_if_scalar(v) for v in value)
    return value


def _unaliased(value: Any, states: Any) -> Any:
    """``value`` with every tensor that shares storage with one of the
    ``states`` cloned, through dicts, lists and tuples. A computed value may
    be a state itself (a confusion matrix, a sum); a fused update changes its
    states in place, so a value the caller keeps must not be one of them."""
    ptrs = {t.untyped_storage().data_ptr() for t in states if isinstance(t, Tensor)}

    def fix(v: Any) -> Any:
        if isinstance(v, Tensor):
            return v.clone() if v.untyped_storage().data_ptr() in ptrs else v
        if isinstance(v, dict):
            return {k: fix(x) for k, x in v.items()}
        if isinstance(v, list) or (isinstance(v, tuple) and not hasattr(v, "_fields")):
            return type(v)(fix(x) for x in v)
        return v

    return fix(value) if ptrs else value


class Metric(ABC):
    """Base class for all metrics of the port.

    Subclasses implement :meth:`update` and :meth:`compute`; states are
    declared with :meth:`add_state` and accumulated across batches.

    Args (keyword-only):
        device: where the states live; ``"cuda"`` (the current card) when
            omitted. Raises ``RuntimeError`` when that needs a card and none
            is present.
        compute_on_cpu: move list states to the host after each update.
        dist_sync_on_step: synchronize states in every ``forward`` call.
        process_group: the ``torch.distributed`` group to sync over (the
            default group when omitted).
        dist_sync_fn: custom gather ``(tensor, group) -> list[tensor]``, used
            in place of the backend for every state.
        distributed_available_fn: predicate deciding whether to sync.
        sync_on_compute: synchronize states across ranks in ``compute``
            (default True).
        compute_with_cache: cache the ``compute`` result until the next update.
        sync_backend: an explicit
            :class:`~tpumetrics_torch.parallel.backend.DistributedBackend`;
            the ambient one (:func:`~tpumetrics_torch.parallel.backend.get_default_backend`)
            when omitted.
    """

    # every kwarg Metric.__init__ itself consumes (the JAX package's set and the
    # port's ``device``): wrappers that split base kwargs from passthrough
    # kwargs filter against it
    _BASE_KWARGS = frozenset(
        (
            "device",
            "compute_on_cpu",
            "dist_sync_on_step",
            "process_group",
            "dist_sync_fn",
            "distributed_available_fn",
            "sync_on_compute",
            "compute_with_cache",
            "sync_backend",
        )
    )

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None
    # an update that reads the host by its semantics (a boolean row selection),
    # or runs a library call that a CUDA graph cannot capture (SDR's batched
    # LU): a fused collection keeps it eager instead of capturing it
    _update_reads_host: bool = False

    def __init__(self, **kwargs: Any) -> None:
        self._device = _resolve_device(kwargs.pop("device", None))
        self._dtype = torch.float32

        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        if not isinstance(self.compute_on_cpu, bool):
            raise ValueError(f"Expected keyword argument `compute_on_cpu` to be a `bool` but got {self.compute_on_cpu}")
        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError(
                f"Expected keyword argument `dist_sync_on_step` to be a `bool` but got {self.dist_sync_on_step}"
            )
        self.process_group = kwargs.pop("process_group", None)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        if self.dist_sync_fn is not None and not callable(self.dist_sync_fn):
            raise ValueError(
                f"Expected keyword argument `dist_sync_fn` to be a callable or None but got {self.dist_sync_fn}"
            )
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or _default_distributed_available

        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError(
                f"Expected keyword argument `sync_on_compute` to be a `bool` but got {self.sync_on_compute}"
            )
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        if not isinstance(self.compute_with_cache, bool):
            raise ValueError(
                f"Expected keyword argument `compute_with_cache` to be a `bool` but got {self.compute_with_cache}"
            )
        self.sync_backend: Optional[DistributedBackend] = kwargs.pop("sync_backend", None)
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        self._defaults: Dict[str, StateType] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}
        self._buffer_specs: Dict[str, tuple] = {}  # name -> (capacity, feature_shape, dtype)
        self._state_spec_hints: Dict[str, tuple] = {}  # name -> (feature_shape, dtype) of list states

        self._update_signature = inspect.signature(self.update)
        self.update: Callable = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute: Callable = self._wrap_compute(self.compute)  # type: ignore[method-assign]
        self._computed: Any = None
        self._forward_cache: Any = None
        self._update_count = 0
        self._to_sync = self.sync_on_compute
        self._should_unsync = True
        self._cache: Optional[Dict[str, StateType]] = None
        self._is_synced = False

    # ------------------------------------------------------------------ state

    def add_state(
        self,
        name: str,
        default: Union[Tensor, list, int, float],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
        capacity: Optional[int] = None,
        feature_shape: tuple = (),
        feature_dtype: Optional[torch.dtype] = None,
    ) -> None:
        """Register an accumulator state on the metric's device.

        ``default`` is a tensor (scalar allowed) for tensor states or an empty
        list for "cat"-style list states; it must be the identity of
        ``dist_reduce_fx`` (zero for "sum", an empty list for "cat"). Floating
        defaults take the metric's dtype; integer defaults that are not
        tensors become int32, as in the JAX package. ``dist_reduce_fx`` is one
        of ``"sum" | "mean" | "max" | "min" | "cat" | None`` or a callable on
        a rank-stacked tensor. Update states by reassignment, never in place.

        For list states, ``capacity`` (with ``feature_shape`` and
        ``feature_dtype``, the metric's dtype when ``None``) declares a
        fixed-capacity :class:`~tpumetrics_torch.buffers.MaskedBuffer` used on
        the functional path (``init_state``): static shapes, appends without
        host syncs, and one gather of values and counts to sync. The eager
        path keeps its Python lists.
        """
        if not name.isidentifier():
            raise ValueError(f"Argument `name` must be a valid python identifier, got {name!r}")
        if not isinstance(default, list):
            was_tensor = isinstance(default, Tensor)
            default = torch.as_tensor(default, device=self._device)
            if default.is_floating_point():
                default = default.to(self._dtype)
            elif default.dtype == torch.int64 and not was_tensor:
                default = default.to(torch.int32)
        elif default:
            raise ValueError("state variable must be a tensor or an *empty* list (where you can append tensors)")

        if isinstance(default, list):
            self._state_spec_hints[name] = (tuple(feature_shape), feature_dtype)
        if capacity is not None:
            if not isinstance(default, list):
                raise ValueError("`capacity` is only valid for list ('cat'-style) states")
            self._buffer_specs[name] = (int(capacity), tuple(feature_shape), feature_dtype)

        if dist_reduce_fx is not None and not (dist_reduce_fx in _REDUCE_FNS or callable(dist_reduce_fx)):
            raise ValueError(
                "`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]"
            )
        reduce_fn = _REDUCE_FNS[dist_reduce_fx] if isinstance(dist_reduce_fx, str) else dist_reduce_fx

        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = reduce_fn
        object.__setattr__(self, name, [] if isinstance(default, list) else default)

    def set_state_capacity(
        self, name: str, capacity: int, feature_shape: tuple = (), feature_dtype: Optional[torch.dtype] = None
    ) -> None:
        """Declare (or change) the fixed capacity of a list state, so the
        functional path holds it in a MaskedBuffer. ``feature_shape`` and
        ``feature_dtype`` default to what ``add_state`` declared."""
        if name not in self._defaults or not isinstance(self._defaults[name], list):
            raise ValueError(f"State {name!r} is not a registered list state")
        hint_shape, hint_dtype = self._state_spec_hints.get(name, ((), None))
        if feature_shape == () and hint_shape != ():
            feature_shape = hint_shape
        if feature_dtype is None:
            feature_dtype = hint_dtype
        self._buffer_specs[name] = (int(capacity), tuple(feature_shape), feature_dtype)

    def _append_state(self, name: str, x: Tensor, valid: Optional[Tensor] = None) -> None:
        """Append a batch to a list state, only the rows where ``valid``.

        On the eager path (a Python list) the rows are dropped by boolean
        indexing, which reads the mask on the host; on a MaskedBuffer they go
        to the dump row, with static shapes and no host read.
        """
        val = getattr(self, name)
        if isinstance(val, _BufferList):
            val.append(x, valid=valid)
        else:
            val.append(x if valid is None else x[valid])

    @property
    def update_count(self) -> int:
        return self._update_count

    def metric_state(self) -> Dict[str, StateType]:
        """Current state values by name."""
        return {attr: getattr(self, attr) for attr in self._defaults}

    def _copy_state_dict(self) -> Dict[str, StateType]:
        """Snapshot of the states: tensors are shared, lists shallow-copied,
        buffer adapters unwrapped to their MaskedBuffer.

        An eager update rebinds states and never changes a tensor in place,
        so the snapshot keeps its values across one. A fused collection
        update (``fused_update=True``) changes its leaders' state buffers in
        place: a snapshot of a fused leader taken before it changes with it,
        unless a ``reset``, ``forward``, sync or assignment has put another
        tensor in the state in between. The snapshots kept here (``sync``'s
        ``_cache``, the forward caches, compute-group members) are all
        restored or refreshed before the next update reads them.
        """
        out: Dict[str, StateType] = {}
        for attr, val in self.metric_state().items():
            if isinstance(val, _BufferList):
                out[attr] = val.buffer
            elif isinstance(val, list):
                out[attr] = list(val)
            else:
                out[attr] = val
        return out

    def _set_states(self, state: Dict[str, Any]) -> None:
        """Install a state dict as the live states: lists shallow-copied (so
        appends never reach the caller's), MaskedBuffers wrapped in the
        list-like adapter that ``update`` code appends to."""
        for attr, val in state.items():
            if isinstance(val, MaskedBuffer):
                val = _BufferList(val)
            elif isinstance(val, list):
                val = list(val)
            object.__setattr__(self, attr, val)

    # ---------------------------------------------------------------- forward

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate into the global state AND return the batch-local value
        (synced across ranks when ``dist_sync_on_step``)."""
        if self._is_synced:
            raise TPUMetricsUserError(
                "The Metric shouldn't be synced when performing ``forward``. HINT: Did you forget to call ``unsync``?"
            )
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            self._forward_cache = self._forward_full_state_update(*args, **kwargs)
        else:
            self._forward_cache = self._forward_reduce_state_update(*args, **kwargs)
        return self._forward_cache

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two-pass forward: global update, then a fresh single-batch compute."""
        self.update(*args, **kwargs)
        update_count = self._update_count
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        compute_on_cpu, self.compute_on_cpu = self.compute_on_cpu, False
        cache = self._copy_state_dict()

        self.reset()
        self.update(*args, **kwargs)
        batch_val = self.compute()

        self._set_states(cache)
        self._update_count = update_count
        self._is_synced = False
        self._should_unsync = True
        self._to_sync = self.sync_on_compute
        self._computed = None
        self.compute_on_cpu = compute_on_cpu
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Single-pass forward: batch update on empty state, then merge the
        global state back in."""
        global_state = self._copy_state_dict()
        update_count = self._update_count
        self.reset()

        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        compute_on_cpu, self.compute_on_cpu = self.compute_on_cpu, False
        self.update(*args, **kwargs)
        batch_val = self.compute()

        self._update_count = update_count + 1
        self._reduce_states(global_state)
        self._is_synced = False
        self._should_unsync = True
        self._to_sync = self.sync_on_compute
        self._computed = None
        self.compute_on_cpu = compute_on_cpu
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()
        return batch_val

    def _reduce_states(self, incoming_state: Dict[str, StateType]) -> None:
        """Merge an incoming (global) state into the current (batch) state by
        each state's reduction."""
        for attr, reduction_fn in self._reductions.items():
            local_state = getattr(self, attr)
            global_state = incoming_state[attr]
            if reduction_fn == dim_zero_sum:
                reduced = global_state + local_state
            elif reduction_fn == dim_zero_mean:
                reduced = ((self._update_count - 1) * global_state + local_state) / self._update_count
            elif reduction_fn == dim_zero_max:
                reduced = torch.maximum(global_state, local_state)
            elif reduction_fn == dim_zero_min:
                reduced = torch.minimum(global_state, local_state)
            elif reduction_fn == dim_zero_cat:
                if isinstance(global_state, Tensor):
                    reduced = torch.cat([torch.atleast_1d(global_state), torch.atleast_1d(local_state)])
                else:
                    reduced = global_state + local_state
            elif reduction_fn is None and isinstance(global_state, Tensor):
                reduced = torch.stack([global_state, local_state])
            elif reduction_fn is None and isinstance(global_state, list):
                reduced = _flatten([global_state, local_state])
            else:
                reduced = reduction_fn(torch.stack([global_state, local_state]))
            object.__setattr__(self, attr, reduced)

    # ------------------------------------------------------------------- sync

    def _active_backend(self) -> DistributedBackend:
        return self.sync_backend if self.sync_backend is not None else get_default_backend()

    def _sync_dist(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        _reducer: Optional[FusedReducer] = None,
    ) -> Optional[Callable[[], None]]:
        """Gather and reduce every state across ranks.

        Without a ``dist_sync_fn``, "sum"/"mean"/"max"/"min" tensor states go
        through a :class:`FusedReducer` (one ``all_reduce`` per (op, dtype)
        class) and list states through the backend's gathers. With a shared
        ``_reducer`` (a collection syncing all its metrics in one flush) the
        reductions are deferred: this returns a callback that applies them
        after the caller's flush; gathers still run at once.
        """
        group = process_group or self.process_group
        if dist_sync_fn is None:
            backend = self._active_backend()
            reducer = FusedReducer(backend, group=group) if _reducer is None else _reducer
            # the BASE collect: eager sync moves this metric's registered states
            state_finalize = Metric._sync_state_collect(self, self._copy_state_dict(), backend, reducer, group=group)

            def finalize() -> None:
                self._set_states(state_finalize())

            if _reducer is None:
                finalize()
                return None
            return finalize

        # custom gather: every state through dist_sync_fn, reduced locally
        input_dict = self._copy_state_dict()
        for attr, reduction_fn in self._reductions.items():
            if reduction_fn == dim_zero_cat and isinstance(input_dict[attr], list) and len(input_dict[attr]) > 1:
                input_dict[attr] = [dim_zero_cat(input_dict[attr])]

        output_dict: Dict[str, Any] = {}
        for attr, val in input_dict.items():
            if isinstance(val, list):
                output_dict[attr] = [dist_sync_fn(v, group) for v in val]
            else:
                output_dict[attr] = dist_sync_fn(val, group)

        for attr, reduction_fn in self._reductions.items():
            if isinstance(output_dict[attr], list) and len(output_dict[attr]) == 0:
                object.__setattr__(self, attr, [])
                continue
            out = output_dict[attr]
            if isinstance(out[0], list):
                out = _flatten(out)
            if not (callable(reduction_fn) or reduction_fn is None):
                raise TypeError("reduction_fn must be callable or None")
            if reduction_fn is None:
                reduced: Any = out
            elif reduction_fn == dim_zero_cat:
                reduced = dim_zero_cat(out)
            else:
                reduced = reduction_fn(torch.stack(out))
            object.__setattr__(self, attr, reduced)
        return None

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
        _reducer: Optional[FusedReducer] = None,
    ) -> Optional[Callable[[], None]]:
        """Sync the states across ranks, keeping the local ones for :meth:`unsync`.

        With a shared ``_reducer`` (internal), the reductions wait for the
        reducer's flush and the returned callback applies them. Returns
        ``None`` when the sync was skipped or applied at once. An error in a
        collective restores the local states and propagates.
        """
        if self._is_synced and should_sync:
            raise TPUMetricsUserError("The Metric has already been synced.")
        if distributed_available is None and self.distributed_available_fn is not None:
            distributed_available = self.distributed_available_fn
        is_distributed = distributed_available() if callable(distributed_available) else None
        if not should_sync or not is_distributed:
            return None
        if dist_sync_fn is None:
            dist_sync_fn = self.dist_sync_fn

        self._cache = self._copy_state_dict()
        try:
            finalize = self._sync_dist(dist_sync_fn, process_group=process_group, _reducer=_reducer)
        except BaseException:
            self._set_states(self._cache)
            self._cache = None
            raise
        self._is_synced = True
        return finalize

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the local states kept by :meth:`sync`."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise TPUMetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise TPUMetricsUserError("The internal cache should exist to unsync the Metric.")
        self._set_states(self._cache)
        self._is_synced = False
        self._cache = None

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> Generator[None, None, None]:
        """Sync on entry, restore the local states on exit."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )
        yield
        self.unsync(should_unsync=self._is_synced and should_unsync)

    def sync_state(self, state: Dict[str, StateType], backend: DistributedBackend) -> Dict[str, StateType]:
        """Pure cross-rank merge of a state dict by each state's reduce op;
        the reduce states of one dtype travel as one collective."""
        reducer = FusedReducer(backend)
        finalize = self._sync_state_collect(state, backend, reducer)
        reducer.flush()
        return finalize()

    def _sync_schedule(self) -> List[tuple]:
        """The collectives this metric's eager sync issues, in order: one
        ``(state, op, dtype, shape)`` per reduce state and ``(state, "gather",
        "", ())`` per gathered one (their shapes may differ across ranks)."""
        entries = []
        for attr, reduction_fn in self._reductions.items():
            val = getattr(self, attr)
            op = _reduce_fn_to_op(reduction_fn)
            if op in ("sum", "mean", "max", "min") and isinstance(val, Tensor):
                entries.append((attr, op, str(val.dtype), tuple(val.shape)))
            else:
                entries.append((attr, "gather", "", ()))
        return entries

    def _sync_state_collect(
        self,
        state: Dict[str, StateType],
        backend: DistributedBackend,
        reducer: FusedReducer,
        group: Optional[Any] = None,
    ) -> Callable[[], Dict[str, StateType]]:
        """First phase of a (possibly multi-metric) fused sync: gathered
        states sync at once, reduce states register with the shared
        ``reducer``. Returns a closure to call after the reducer's one
        ``flush``, which gives the synced state.

        The collectives issued (or deferred to the reducer) here carry this
        metric's class name as their ledger attribution tag, under any
        enclosing collection or wrapper tag."""
        out: Dict[str, StateType] = {}
        pending: Dict[str, int] = {}
        with _telemetry.attribution(type(self).__name__):
            self._sync_state_collect_inner(state, backend, reducer, group, out, pending)

        def finalize() -> Dict[str, StateType]:
            out.update(reducer.resolve(pending))
            return out

        return finalize

    def _sync_state_collect_inner(
        self,
        state: Dict[str, StateType],
        backend: DistributedBackend,
        reducer: FusedReducer,
        group: Optional[Any],
        out: Dict[str, StateType],
        pending: Dict[str, int],
    ) -> None:
        for attr, reduction_fn in self._reductions.items():
            val = state[attr]
            op = _reduce_fn_to_op(reduction_fn)
            if isinstance(val, MaskedBuffer):
                out[attr] = buffer_all_gather(val, backend, group=group)
            elif isinstance(val, list):
                if reduction_fn is None:
                    # ragged per-item list: item boundaries travel as a shape matrix
                    out[attr] = _gather_ragged_list(backend, val, group, self._dtype, self._device)
                    continue
                # a locally empty list still takes part (a zero-length
                # contribution), so every rank issues the same collectives
                catted = dim_zero_cat(val) if val else torch.zeros((0,), dtype=self._dtype, device=self._device)
                merged = dim_zero_cat(backend.all_gather(catted, group=group))
                out[attr] = [merged] if merged.numel() else []
            elif op in ("sum", "mean", "max", "min"):
                pending[attr] = reducer.add(val, op)
            elif op == "cat":
                out[attr] = dim_zero_cat(backend.all_gather(val, group=group))
            elif reduction_fn is None:
                out[attr] = torch.stack(backend.all_gather(val, group=group))
            elif callable(reduction_fn):
                out[attr] = reduction_fn(torch.stack(backend.all_gather(val, group=group)))
            else:
                raise TypeError("reduction_fn must be callable or None")

    # ------------------------------------------------------------ wrap update

    def _check_input_devices(self, args: tuple, kwargs: Dict[str, Any]) -> None:
        for x in (*args, *kwargs.values()):
            if isinstance(x, Tensor) and x.device != self._device:
                raise RuntimeError(
                    f"{type(self).__name__} got an input on {x.device} but its states live on {self._device};"
                    " inputs are not moved implicitly"
                )

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            self._check_input_devices(args, kwargs)
            self._computed = None
            self._update_count += 1
            update(*args, **kwargs)
            if self.compute_on_cpu:
                self._move_list_states_to_cpu()

        return wrapped_func

    def _move_list_states_to_cpu(self) -> None:
        """Move list states to host memory."""
        for key in self._defaults:
            val = getattr(self, key)
            if isinstance(val, list):
                object.__setattr__(self, key, [v.cpu() for v in val])

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if self._update_count == 0:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                return self._computed
            with self.sync_context(
                dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync, should_unsync=self._should_unsync
            ):
                value = _unaliased(_squeeze_if_scalar(compute(*args, **kwargs)), self.metric_state().values())
            if self.compute_with_cache:
                self._computed = value
            return value

        return wrapped_func

    # --------------------------------------------------------------- abstract

    @abstractmethod
    def update(self, *_: Any, **__: Any) -> None:
        """Override to update the metric state (by reassignment, see add_state)."""

    @abstractmethod
    def compute(self) -> Any:
        """Override to compute the final value from state."""

    # ------------------------------------------------------- functional bridge

    def init_state(self) -> Dict[str, StateType]:
        """Fresh default state dict for the functional path (tensors are
        copies, so a caller may update them in place). List states declared
        with a ``capacity`` become empty MaskedBuffers."""
        out: Dict[str, StateType] = {}
        for attr, default in self._defaults.items():
            if attr in self._buffer_specs:
                cap, fshape, fdtype = self._buffer_specs[attr]
                out[attr] = create_buffer(cap, fshape, fdtype if fdtype is not None else self._dtype, self._device)
            else:
                out[attr] = [] if isinstance(default, list) else default.clone()
        return out

    @contextmanager
    def _borrowed_state(self, state: Dict[str, StateType]) -> Generator[None, None, None]:
        """Temporarily swap ``state`` in as the live state; list states are
        shallow-copied so appends never mutate the caller's dict, and
        MaskedBuffers are wrapped so ``update`` can ``.append`` to them."""
        saved = self._copy_state_dict()
        self._set_states(state)
        try:
            yield
        finally:
            self._set_states(saved)

    def functional_update(self, state: Dict[str, StateType], *args: Any, **kwargs: Any) -> Dict[str, StateType]:
        """Pure state transition: ``update(state, batch) -> new_state``."""
        self._check_input_devices(args, kwargs)
        with self._borrowed_state(state):
            type(self).update(self, *args, **kwargs)
            return self._copy_state_dict()

    def functional_compute(
        self,
        state: Dict[str, StateType],
        axis_name: Optional[str] = None,
        backend: Optional[DistributedBackend] = None,
    ) -> Any:
        """Pure compute from an explicit state dict, synced across ranks
        through ``backend`` first when one is given. ``axis_name`` (a named
        mesh axis, in the JAX package) has no torch counterpart and raises."""
        _refuse_axis_name(axis_name)
        if backend is not None:
            state = self.sync_state(state, backend)
        with self._borrowed_state(state):
            return _unaliased(_squeeze_if_scalar(type(self).compute(self)), state.values())

    def functional_forward(
        self,
        state: Dict[str, StateType],
        *args: Any,
        axis_name: Optional[str] = None,
        backend: Optional[DistributedBackend] = None,
        **kwargs: Any,
    ) -> tuple:
        """Pure ``forward``: ``(new_state, batch_value)``, the batch value
        synced through ``backend`` when one is given."""
        _refuse_axis_name(axis_name)
        new_state = self.functional_update(state, *args, **kwargs)
        batch_state = self.functional_update(self.init_state(), *args, **kwargs)
        return new_state, self.functional_compute(batch_state, backend=backend)

    # ------------------------------------------------------------------ reset

    def reset(self) -> None:
        """Reset state to defaults."""
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        for attr, default in self._defaults.items():
            object.__setattr__(self, attr, [] if isinstance(default, list) else default)
        self._cache = None
        self._is_synced = False

    def clone(self) -> "Metric":
        """Deep copy of the metric."""
        return copy.deepcopy(self)

    # ------------------------------------------------------- shared backbones

    @property
    def _backbone_share_ids(self) -> tuple:
        """Registry keys of the resident backbones this metric dispatches
        (``tpumetrics_torch.backbones``). Empty for metrics without a
        pretrained forward."""
        return tuple(h.key for h in getattr(self, "_backbone_handles", ()))

    def release_backbones(self) -> None:
        """Release this metric's references on shared backbone handles.

        Idempotent. Metrics that acquire a
        :class:`~tpumetrics_torch.backbones.registry.BackboneHandle` in
        ``__init__`` (LPIPS, the FID family, PPL with a named net) record it
        in ``self._backbone_handles``; the last release across all instances
        frees the resident weights. (The JAX package's tenant hibernation,
        which parks references, waits for the port of the serving planes.)"""
        handles, self._backbone_handles = getattr(self, "_backbone_handles", ()), ()
        for h in handles:
            h.close()

    # ------------------------------------------------------------ persistence

    def persistent(self, mode: bool = False) -> None:
        """Toggle persistence for all states."""
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "") -> Dict[str, Any]:
        """States marked persistent, as tensors on the metric's device."""
        destination = {} if destination is None else destination
        for key in self._defaults:
            if self._persistent[key]:
                val = getattr(self, key)
                destination[prefix + key] = list(val) if isinstance(val, list) else val
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True) -> None:
        """Restore persistent states onto the metric's device, keeping their dtypes."""
        for key in self._defaults:
            name = prefix + key
            if name in state_dict:
                value = state_dict[name]
                if isinstance(value, list):
                    value = [torch.as_tensor(v, device=self._device) for v in value]
                else:
                    value = torch.as_tensor(value, device=self._device)
                object.__setattr__(self, key, value)
            elif strict and self._persistent[key]:
                raise KeyError(f"Missing key {name!r} in state_dict")
        self._computed = None

    # ------------------------------------------------------------ dev / dtype

    @property
    def device(self) -> torch.device:
        """Device of the metric states."""
        return self._device

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move all states (and defaults) to ``device``."""
        device = _resolve_device(device)
        for attr in self._defaults:
            val = getattr(self, attr)
            if isinstance(val, _BufferList):
                moved: Any = _BufferList(MaskedBuffer(*(t.to(device) for t in val.buffer)))
            else:
                moved = [v.to(device) for v in val] if isinstance(val, list) else val.to(device)
            object.__setattr__(self, attr, moved)
        self._defaults = {k: ([] if isinstance(v, list) else v.to(device)) for k, v in self._defaults.items()}
        self._device = device
        self._computed = None
        return self

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Convert the floating-point states, their defaults and a cached
        ``compute`` value to ``dst_type``; integer and boolean states keep
        their dtypes. Later floating defaults of ``add_state`` take it too."""
        self._dtype = dst_type

        def _convert(val: Any) -> Any:
            if isinstance(val, Tensor):
                return val.to(dst_type) if val.is_floating_point() else val
            if isinstance(val, dict):
                return {k: _convert(v) for k, v in val.items()}
            if isinstance(val, list) or (isinstance(val, tuple) and not hasattr(val, "_fields")):
                return type(val)(_convert(v) for v in val)
            return val

        for attr in self._defaults:
            val = getattr(self, attr)
            if isinstance(val, list):
                object.__setattr__(self, attr, [_convert(v) for v in val])
            else:
                object.__setattr__(self, attr, _convert(val))
        self._defaults = {k: ([] if isinstance(v, list) else _convert(v)) for k, v in self._defaults.items()}
        self._computed = _convert(self._computed)
        return self

    def float(self) -> "Metric":
        """Floating-point states in float32."""
        return self.set_dtype(torch.float32)

    def double(self) -> "Metric":
        """Floating-point states in float64."""
        return self.set_dtype(torch.float64)

    def half(self) -> "Metric":
        """Floating-point states in bfloat16, as the JAX package's ``half()``
        (not float16, torch's usual meaning of half)."""
        return self.set_dtype(torch.bfloat16)

    # --------------------------------------------------------------- plumbing

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep the kwargs this metric's ``update`` accepts (collection routing)."""
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        _sign_params = self._update_signature.parameters
        filtered_kwargs = {
            k: v for k, v in kwargs.items() if (k in _sign_params and _sign_params[k].kind not in _params)
        }
        exists_var_keyword = any(v.kind == inspect.Parameter.VAR_KEYWORD for v in _sign_params.values())
        if (not filtered_kwargs and not exists_var_keyword) or exists_var_keyword:
            filtered_kwargs = kwargs
        return filtered_kwargs

    def __getstate__(self) -> Dict[str, Any]:
        """Pickle/deepcopy support: drop the wrapped bound methods, which close over ``self``."""
        return {k: v for k, v in self.__dict__.items() if k not in ("update", "compute", "_update_signature")}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._update_signature = inspect.signature(self.update)
        self.update = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self.compute)  # type: ignore[method-assign]

    def __setattr__(self, name: str, value: Any) -> None:
        """Guard const class attributes against instance mutation."""
        if name in _CONST_ATTRS:
            raise RuntimeError(f"Can't change const `{name}`.")
        object.__setattr__(self, name, value)

    def __hash__(self) -> int:
        """Hash over the class and the identities of the current states."""
        hash_vals: List[Any] = [self.__class__.__name__]
        for key in self._defaults:
            val = getattr(self, key)
            if isinstance(val, list):
                hash_vals.extend(id(v) for v in val)
            else:
                hash_vals.append(id(val))
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(device={self._device})"

    # ---------------------------------------------------------- compositional
    # arithmetic on metrics builds a CompositionalMetric, computed lazily

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, self, other)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x, y: torch.bitwise_and(y, x), self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, other, self)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, other, self)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x, y: torch.bitwise_or(y, x), self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, other, self)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x, y: torch.bitwise_xor(y, x), self, other)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, self, other)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __inv__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_not, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return self.__inv__()

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)

    def __getnewargs__(self) -> tuple:
        return tuple()

    __iter__ = None


def _refuse_axis_name(axis_name: Optional[str]) -> None:
    if axis_name is not None:
        raise ValueError(
            f"axis_name={axis_name!r}: torch has no named mesh axes. Sync through a backend instead, e.g."
            " backend=tpumetrics_torch.parallel.TorchDistBackend(process_group)."
        )


def _neg(x: Tensor) -> Tensor:
    return -torch.abs(x)


def _gather_ragged_list(
    backend: DistributedBackend,
    items: List[Tensor],
    group: Optional[Any],
    fallback_dtype: torch.dtype,
    device: torch.device,
) -> List[Tensor]:
    """Gather a reduce-None ragged list across ranks, keeping its item
    boundaries, with two collectives: one of the per-item shape matrix and
    one of all the elements flattened, split and reshaped on receipt. Items
    may be ragged in every dimension and of any rank, 0-d included."""
    # each row is [ndim, d0, d1, ...] padded with 1s, so (3,) and (3, 1) stay apart
    rank_ndim = max((v.ndim for v in items), default=1)
    shapes = torch.tensor(
        [(v.ndim, *v.shape, *(1,) * (rank_ndim - v.ndim)) for v in items], dtype=torch.int32, device=device
    ).reshape(len(items), 1 + rank_ndim)
    data = torch.cat([v.reshape(-1) for v in items]) if items else torch.zeros((0,), dtype=fallback_dtype, device=device)

    gathered_shapes = backend.all_gather(shapes, group=group)
    gathered_data = backend.all_gather(data, group=group)

    out: List[Tensor] = []
    for rank_shapes, rank_data in zip(gathered_shapes, gathered_data):
        offset = 0
        for shape_row in rank_shapes.reshape(-1, rank_shapes.shape[-1]).tolist():
            shape = tuple(shape_row[1 : 1 + shape_row[0]])
            n = 1
            for d in shape:
                n *= d
            out.append(rank_data[offset : offset + n].reshape(shape))
            offset += n
    return out


def _reduce_fn_to_op(reduction_fn: Any) -> Optional[str]:
    """The wire-op name of a registered reduce function."""
    if reduction_fn == dim_zero_sum:
        return "sum"
    if reduction_fn == dim_zero_mean:
        return "mean"
    if reduction_fn == dim_zero_max:
        return "max"
    if reduction_fn == dim_zero_min:
        return "min"
    if reduction_fn == dim_zero_cat:
        return "cat"
    return None


class CompositionalMetric(Metric):
    """Lazy arithmetic composition of two metrics (or a metric and a constant).

    Example:
        >>> from tpumetrics_torch.aggregation import SumMetric
        >>> a, b = SumMetric(device="cpu"), SumMetric(device="cpu")
        >>> combined = a + b
        >>> a.update(2.0)
        >>> b.update(3.0)
        >>> float(combined.compute())
        5.0
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, Tensor, None],
        metric_b: Union[Metric, float, int, Tensor, None],
    ) -> None:
        device = next((m.device for m in (metric_a, metric_b) if isinstance(m, Metric)), None)
        super().__init__(device=device)
        self.op = operator
        self.metric_a = torch.as_tensor(metric_a, device=self.device) if isinstance(metric_a, (int, float)) else metric_a
        self.metric_b = torch.as_tensor(metric_b, device=self.device) if isinstance(metric_b, (int, float)) else metric_b

    def _sync_dist(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        _reducer: Optional[FusedReducer] = None,
    ) -> None:
        pass  # the children sync themselves in their own compute

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            self._forward_cache = None
        elif val_b is None:
            self._forward_cache = None if isinstance(self.metric_b, Metric) else self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    # functional bridge: the children's states as {"a": ..., "b": ...} (None for a constant)

    def init_state(self) -> Dict[str, Any]:
        return {
            "a": self.metric_a.init_state() if isinstance(self.metric_a, Metric) else None,
            "b": self.metric_b.init_state() if isinstance(self.metric_b, Metric) else None,
        }

    def functional_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        out = dict(state)
        if isinstance(self.metric_a, Metric):
            out["a"] = self.metric_a.functional_update(state["a"], *args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            out["b"] = self.metric_b.functional_update(state["b"], *args, **self.metric_b._filter_kwargs(**kwargs))
        return out

    def functional_compute(
        self, state: Dict[str, Any], axis_name: Optional[str] = None, backend: Optional[DistributedBackend] = None
    ) -> Any:
        _refuse_axis_name(axis_name)
        val_a = (
            self.metric_a.functional_compute(state["a"], backend=backend)
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b.functional_compute(state["b"], backend=backend)
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def _sync_state_collect(
        self, state: Dict[str, Any], backend: DistributedBackend, reducer: FusedReducer, group: Optional[Any] = None
    ) -> Callable[[], Dict[str, Any]]:
        fin_a = (
            self.metric_a._sync_state_collect(state["a"], backend, reducer, group)
            if isinstance(self.metric_a, Metric)
            else (lambda: state["a"])
        )
        fin_b = (
            self.metric_b._sync_state_collect(state["b"], backend, reducer, group)
            if isinstance(self.metric_b, Metric)
            else (lambda: state["b"])
        )
        return lambda: {"a": fin_a(), "b": fin_b()}

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def __repr__(self) -> str:
        op_name = self.op.__name__ if hasattr(self.op, "__name__") else self.op
        return f"{self.__class__.__name__}(\n  {op_name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"


__all__ = ["CompositionalMetric", "Metric"]
