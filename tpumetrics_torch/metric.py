"""The Metric base class of the port (counterpart of ``tpumetrics/metric.py``).

States are ``torch.Tensor``s (or Python lists of them for "cat"-style list
states) on one device, the metric's ``device``. A metric built without
``device=`` lives on CUDA, and raises if no card is present: it never falls
back to the CPU quietly. ``update`` refuses inputs on another device instead
of moving them.

States are updated by reassignment, never in place (``self.tp = self.tp +
tp``, not ``+=``), as the JAX package's immutable arrays force. That keeps
sharing a tensor between a default, a forward cache, a functional state and
the members of a compute group safe without copies.

This slice covers one process. Syncing states across ranks is ROADMAP.md
Queue 1 item 3: until then ``compute`` is a no-op sync when
``torch.distributed`` is not initialized or has one rank, and raises
otherwise rather than return a local-only value.
"""

from __future__ import annotations

import functools
import inspect
from abc import ABC, abstractmethod
from contextlib import contextmanager
from typing import Any, Callable, Dict, Generator, List, Optional, Union

import torch
import torch.distributed as dist

from tpumetrics_torch.utils.data import (
    _flatten,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
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


class Metric(ABC):
    """Base class for all metrics of the port.

    Subclasses implement :meth:`update` and :meth:`compute`; states are
    declared with :meth:`add_state` and accumulated across batches.

    Args (keyword-only):
        device: where the states live; ``"cuda"`` (the current card) when
            omitted. Raises ``RuntimeError`` when that needs a card and none
            is present.
        sync_on_compute: synchronize states across ranks in ``compute``
            (default True; see the module note on what this slice supports).
        compute_with_cache: cache the ``compute`` result until the next update.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None

    def __init__(self, **kwargs: Any) -> None:
        self._device = _resolve_device(kwargs.pop("device", None))
        self._dtype = torch.float32

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
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        self._defaults: Dict[str, StateType] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}

        self._update_signature = inspect.signature(self.update)
        self.update: Callable = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute: Callable = self._wrap_compute(self.compute)  # type: ignore[method-assign]
        self._computed: Any = None
        self._forward_cache: Any = None
        self._update_count = 0
        self._to_sync = self.sync_on_compute

    # ------------------------------------------------------------------ state

    def add_state(
        self,
        name: str,
        default: Union[Tensor, list, int, float],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register an accumulator state on the metric's device.

        ``default`` is a tensor (scalar allowed) for tensor states or an empty
        list for "cat"-style list states; it must be the identity of
        ``dist_reduce_fx`` (zero for "sum", an empty list for "cat"). Floating
        defaults take the metric's dtype; integer defaults that are not
        tensors become int32, as in the JAX package. ``dist_reduce_fx`` is one
        of ``"sum" | "mean" | "max" | "min" | "cat" | None`` or a callable on
        a rank-stacked tensor. Update states by reassignment, never in place.
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

        if dist_reduce_fx is not None and not (dist_reduce_fx in _REDUCE_FNS or callable(dist_reduce_fx)):
            raise ValueError(
                "`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]"
            )
        reduce_fn = _REDUCE_FNS[dist_reduce_fx] if isinstance(dist_reduce_fx, str) else dist_reduce_fx

        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = reduce_fn
        object.__setattr__(self, name, [] if isinstance(default, list) else default)

    @property
    def update_count(self) -> int:
        return self._update_count

    def _copy_state_dict(self) -> Dict[str, StateType]:
        """Snapshot of the states: tensors are shared (never mutated in
        place), lists shallow-copied."""
        out: Dict[str, StateType] = {}
        for attr in self._defaults:
            val = getattr(self, attr)
            out[attr] = list(val) if isinstance(val, list) else val
        return out

    # ---------------------------------------------------------------- forward

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate into the global state AND return the batch-local value."""
        if self.full_state_update or self.full_state_update is None:
            self._forward_cache = self._forward_full_state_update(*args, **kwargs)
        else:
            self._forward_cache = self._forward_reduce_state_update(*args, **kwargs)
        return self._forward_cache

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two-pass forward: global update, then a fresh single-batch compute."""
        self.update(*args, **kwargs)
        update_count = self._update_count
        self._to_sync = False
        cache = self._copy_state_dict()

        self.reset()
        self.update(*args, **kwargs)
        batch_val = self.compute()

        for attr, val in cache.items():
            object.__setattr__(self, attr, val)
        self._update_count = update_count
        self._to_sync = self.sync_on_compute
        self._computed = None
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Single-pass forward: batch update on empty state, then merge the
        global state back in."""
        global_state = self._copy_state_dict()
        update_count = self._update_count
        self.reset()

        self._to_sync = False
        self.update(*args, **kwargs)
        batch_val = self.compute()

        self._update_count = update_count + 1
        self._reduce_states(global_state)
        self._to_sync = self.sync_on_compute
        self._computed = None
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

    def _sync_dist(self) -> None:
        """Cross-rank state sync: nothing to do with one rank; more ranks are
        not supported in this slice (never a silent local-only value)."""
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        raise NotImplementedError(
            f"{type(self).__name__}: syncing metric states across {dist.get_world_size()} ranks is not ported yet"
            " (ROADMAP.md, Queue 1 item 3: main path across ranks). Pass sync_on_compute=False to compute"
            " per-rank values knowingly."
        )

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

        return wrapped_func

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
            if self._to_sync:
                self._sync_dist()
            value = _squeeze_if_scalar(compute(*args, **kwargs))
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
        copies, so a caller may update them in place)."""
        return {attr: [] if isinstance(d, list) else d.clone() for attr, d in self._defaults.items()}

    @contextmanager
    def _borrowed_state(self, state: Dict[str, StateType]) -> Generator[None, None, None]:
        """Temporarily swap ``state`` in as the live state; list states are
        shallow-copied so appends never mutate the caller's dict."""
        saved = self._copy_state_dict()
        for attr, val in state.items():
            object.__setattr__(self, attr, list(val) if isinstance(val, list) else val)
        try:
            yield
        finally:
            for attr, val in saved.items():
                object.__setattr__(self, attr, val)

    def functional_update(self, state: Dict[str, StateType], *args: Any, **kwargs: Any) -> Dict[str, StateType]:
        """Pure state transition: ``update(state, batch) -> new_state``."""
        self._check_input_devices(args, kwargs)
        with self._borrowed_state(state):
            type(self).update(self, *args, **kwargs)
            return self._copy_state_dict()

    def functional_compute(self, state: Dict[str, StateType], axis_name: Optional[str] = None) -> Any:
        """Pure compute from an explicit state dict. ``axis_name`` (a sync
        before computing, in the JAX package) is not ported yet."""
        if axis_name is not None:
            raise NotImplementedError("functional_compute(axis_name=...) syncs across ranks: ROADMAP.md Queue 1 item 3")
        with self._borrowed_state(state):
            return _squeeze_if_scalar(type(self).compute(self))

    def functional_forward(
        self, state: Dict[str, StateType], *args: Any, axis_name: Optional[str] = None, **kwargs: Any
    ) -> tuple:
        """Pure ``forward``: ``(new_state, batch_value)``."""
        new_state = self.functional_update(state, *args, **kwargs)
        batch_state = self.functional_update(self.init_state(), *args, **kwargs)
        return new_state, self.functional_compute(batch_state, axis_name=axis_name)

    # ------------------------------------------------------------------ reset

    def reset(self) -> None:
        """Reset state to defaults."""
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        for attr, default in self._defaults.items():
            object.__setattr__(self, attr, [] if isinstance(default, list) else default)

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
            moved = [v.to(device) for v in val] if isinstance(val, list) else val.to(device)
            object.__setattr__(self, attr, moved)
        self._defaults = {k: ([] if isinstance(v, list) else v.to(device)) for k, v in self._defaults.items()}
        self._device = device
        self._computed = None
        return self

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

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(device={self._device})"


__all__ = ["Metric"]
