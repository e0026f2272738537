"""Carry metric state between the JAX package and the port.

A state is what ``init_state()`` / ``functional_update()`` return, with
numpy arrays as leaves: ``{state_name: array}`` for a metric (a list of
arrays for a list state), ``{leader_name: {state_name: array}}`` for a
collection, keyed by compute-group leader. A fixed-capacity list state
(a MaskedBuffer) is a leaf with ``values``, ``count`` and ``requested``
fields: the JAX package's ``MaskedBuffer`` with numpy leaves loads as is,
and an exported one is the port's :class:`~tpumetrics_torch.buffers.MaskedBuffer`
with numpy leaves, whose fields are in the JAX one's order
(``tpumetrics.buffers.MaskedBuffer(*leaf)``). ``load_state`` puts such a
state into a port metric or collection on its device; ``export_state``
takes it out. Dtypes are kept (int32 counts, float32 values). This module
imports nothing of JAX: the JAX side converts with ``np.asarray`` /
``jnp.asarray``.

The wrappers with a functional bridge carry the state of that bridge:
``MinMaxMetric`` a dict ``{"base", "min_val", "max_val"}``,
``MultioutputWrapper`` a list with one state per output,
``ClasswiseWrapper`` the wrapped metric's state, and ``MultitaskWrapper`` a
dict with one state per task (a collection task's keyed by its leaders).
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from tpumetrics_torch.buffers import MaskedBuffer
from tpumetrics_torch.collections import MetricCollection
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.wrappers import ClasswiseWrapper, MinMaxMetric, MultioutputWrapper, MultitaskWrapper


def _is_buffer(value: Any) -> bool:
    return all(hasattr(value, f) for f in MaskedBuffer._fields)


def _load_metric(metric: Metric, state: Dict[str, Any]) -> None:
    if set(state) != set(metric._defaults):
        raise ValueError(f"{type(metric).__name__} has states {sorted(metric._defaults)}, got {sorted(state)}")

    def tensor(v: Any) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.detach().to(metric.device, copy=True)
        return torch.tensor(np.asarray(v), device=metric.device)

    loaded: Dict[str, Any] = {}
    for name, value in state.items():
        default = metric._defaults[name]
        if isinstance(default, list) and _is_buffer(value):
            value = MaskedBuffer(*(tensor(getattr(value, f)) for f in MaskedBuffer._fields))
        elif isinstance(default, list):
            value = [tensor(v) for v in value]
        else:
            value = tensor(value)
            if value.shape != default.shape or value.dtype != default.dtype:
                raise ValueError(
                    f"{type(metric).__name__}.{name}: expected {default.dtype}{tuple(default.shape)},"
                    f" got {value.dtype}{tuple(value.shape)}"
                )
        loaded[name] = value
    metric._set_states(loaded)
    metric._computed = None


def load_state(target: Union[Metric, MetricCollection], state: Any) -> None:
    """Put ``state`` (numpy or tensor leaves, keyed like ``init_state()``) into
    ``target``. A MaskedBuffer leaf stays a buffer: ``load_state(m,
    m.init_state())`` after ``set_state_capacity`` makes ``m``'s eager
    update append to fixed-capacity buffers.

    A collection's state is keyed by compute-group leader, so ``target`` must
    have the same groups: set them with ``compute_groups=[[...], ...]`` or
    establish them with one ``update`` first.
    """
    if isinstance(target, MinMaxMetric):
        load_state(target._base_metric, state["base"])
        _load_metric(target, {"min_val": state["min_val"], "max_val": state["max_val"]})
        return
    if isinstance(target, MultioutputWrapper):
        if len(state) != len(target.metrics):
            raise ValueError(f"MultioutputWrapper has {len(target.metrics)} outputs, got {len(state)} states")
        for metric, sub in zip(target.metrics, state):
            load_state(metric, sub)
        return
    if isinstance(target, ClasswiseWrapper):
        load_state(target.metric, state)
        return
    if isinstance(target, MultitaskWrapper):
        if set(state) != set(target.task_metrics):
            raise ValueError(f"MultitaskWrapper has tasks {sorted(target.task_metrics)}, got {sorted(state)}")
        for name, metric in target.task_metrics.items():
            load_state(metric, state[name])
        return
    if isinstance(target, Metric):
        _load_metric(target, state)
        return
    leaders = [cg[0] for cg in target.compute_groups.values()]
    if sorted(state) != sorted(leaders) or not target._groups_checked:
        raise ValueError(
            f"State is keyed by {sorted(state)} but the collection's compute-group leaders are {sorted(leaders)}"
            f"{'' if target._groups_checked else ' (groups not established yet)'}: pass compute_groups=... to match"
        )
    for name in leaders:
        load_state(target._modules[name], state[name])
    target._state_is_copy = False  # members pick the leaders' states up on next access


def export_state(source: Union[Metric, MetricCollection]) -> Any:
    """``source``'s state as numpy arrays, keyed like ``init_state()``."""
    if isinstance(source, MinMaxMetric):
        own = _export_plain(source)
        return {"base": export_state(source._base_metric), **own}
    if isinstance(source, MultioutputWrapper):
        return [export_state(m) for m in source.metrics]
    if isinstance(source, ClasswiseWrapper):
        return export_state(source.metric)
    if isinstance(source, MultitaskWrapper):
        return {name: export_state(m) for name, m in source.task_metrics.items()}
    return _export_plain(source)


def _export_plain(source: Union[Metric, MetricCollection]) -> Dict[str, Any]:
    """A metric's registered states, or a collection's leaders' states."""

    def _host(val: Any) -> Any:
        if isinstance(val, MaskedBuffer):
            return MaskedBuffer(*(_host(t) for t in val))
        if isinstance(val, list):
            return [v.detach().cpu().numpy() for v in val]
        return val.detach().cpu().numpy()

    if isinstance(source, Metric):
        return {name: _host(val) for name, val in source._copy_state_dict().items()}
    return {cg[0]: export_state(source._modules[cg[0]]) for cg in source.compute_groups.values()}
