"""Fused cross-rank reduction: ONE collective per (op, dtype) class
(counterpart of ``tpumetrics/parallel/fuse.py``).

Every "sum"/"mean"/"max"/"min" state that shares a dtype is flattened into
one buffer, reduced with one ``all_reduce`` and split back, so the number of
collectives in a sync is the number of distinct (op, dtype) classes, however
many metrics and states take part. Reducing across ranks is elementwise for
all four ops, so reducing a concatenation equals concatenating the
reductions.

Every ``flush`` reports to the collective ledger
(:mod:`tpumetrics_torch.telemetry.ledger`) while one records, as the JAX
package's does: one ``"reducer"`` record per (op, dtype) class, carrying the
attribution tags its members had when they were added, and a flush event.
Lockstep verification of the schedule waits for the port of
``telemetry.lockstep``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from tpumetrics_torch.parallel.backend import dtype_name
from tpumetrics_torch.telemetry import ledger as _telemetry

Tensor = torch.Tensor


class FusedReducer:
    """Collects reduce-states, then flushes them as fused collectives.

    ``add`` every state (it returns a handle), ``flush`` once, and read each
    result back with ``result(handle)``. Every rank must add the same states
    in the same order: iterating the metrics' ``_reductions`` dicts, whose
    order is that of registration, gives that.

    Args:
        backend: the :class:`~tpumetrics_torch.parallel.backend.DistributedBackend`
            carrying the collectives.
        group: process group forwarded to every collective.
    """

    def __init__(self, backend: Any, group: Optional[Any] = None) -> None:
        self._backend = backend
        self._group = group
        self._entries: List[Tuple[Tensor, str, str]] = []
        self._results: Optional[List[Tensor]] = None

    def add(self, val: Tensor, op: str, tag: Optional[str] = None) -> int:
        """Register one state; ``tag`` (the ledger's attribution, the
        enclosing :func:`~tpumetrics_torch.telemetry.ledger.attribution` when
        ``None``) names it in the flush's records."""
        if self._results is not None:
            raise RuntimeError("FusedReducer already flushed")
        self._entries.append((val, op, tag if tag is not None else _telemetry.current_tag()))
        return len(self._entries) - 1

    def schedule(self) -> List[Tuple[str, str, str, Tuple[int, ...]]]:
        """The intended collective schedule: (tag, op, dtype, shape) per entry."""
        return [(tag, op, str(val.dtype), tuple(val.shape)) for val, op, tag in self._entries]

    def flush(self) -> None:
        recording = _telemetry.recording()
        results: List[Optional[Tensor]] = [None] * len(self._entries)
        classes: Dict[Tuple[str, torch.dtype], List[int]] = {}
        for i, (val, op, _tag) in enumerate(self._entries):
            classes.setdefault((op, val.dtype), []).append(i)
        for (op, dtype), idxs in classes.items():
            # the class's attribution: its members' tags in order, each once
            tags = "+".join(dict.fromkeys(t for i in idxs if (t := self._entries[i][2])))
            if recording:
                total = sum(self._entries[i][0].numel() for i in idxs)
                _telemetry.record_collective(
                    self._backend, "fused_class", op, (total,), dtype_name(dtype), dtype.itemsize,
                    int(self._backend.world_size()), source="reducer", tag=tags, states=len(idxs),
                )
            with _telemetry.attribution(tags):
                if len(idxs) == 1:
                    results[idxs[0]] = self._backend.all_reduce(self._entries[idxs[0]][0], op, group=self._group)
                    continue
                vals = [self._entries[i][0] for i in idxs]
                reduced = self._backend.all_reduce(torch.cat([v.reshape(-1) for v in vals]), op, group=self._group)
            for i, part in zip(idxs, torch.split(reduced, [v.numel() for v in vals])):
                results[i] = part.reshape(self._entries[i][0].shape)
        if recording:
            _telemetry.record_flush(self._backend, len(self._entries), len(classes))
        self._results = results  # type: ignore[assignment]

    def result(self, handle: int) -> Tensor:
        if self._results is None:
            raise RuntimeError("FusedReducer.result before flush")
        return self._results[handle]

    def resolve(self, pending: Dict[str, int]) -> Dict[str, Tensor]:
        """Flush (once) and map a ``key -> handle`` dict to ``key -> result``."""
        if self._results is None:
            self.flush()
        return {key: self.result(handle) for key, handle in pending.items()}
