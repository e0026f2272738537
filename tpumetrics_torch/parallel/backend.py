"""Distributed sync backends (counterpart of ``tpumetrics/parallel/backend.py``).

A backend is the strategy object every cross-rank state sync goes through:

- :class:`TorchDistBackend` runs the collectives of ``torch.distributed``
  over the default process group or one passed in: NCCL for states on a
  CUDA card, gloo for states on the CPU. It takes the place of both of the
  JAX package's eager backends (``AxisBackend`` over a mesh axis and
  ``MultiHostBackend`` between processes): torch has one process per rank
  either way.
- :class:`NoOpBackend` is the single process, world size 1.

Callers that know a state's reduce op use :meth:`DistributedBackend.all_reduce`,
so that "sum"/"mean"/"max"/"min" states travel as one reduction instead of a
gather and a local reduce.

:class:`TorchDistBackend` reports every wire call to the collective ledger
(:mod:`tpumetrics_torch.telemetry.ledger`) while one records, as the JAX
package's eager backend does: each ``all_reduce``, each equal-shape gather
(an uneven ``all_gather`` is two or three of them) and each host-object
gather.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
import torch.distributed as dist

from tpumetrics_torch.telemetry import ledger as _telemetry

Tensor = torch.Tensor

# the device types each process-group backend carries
_BACKEND_DEVICES = {"nccl": {"cuda"}, "gloo": {"cpu"}}


class DistributedBackend:
    """Strategy interface for metric state synchronization."""

    def available(self) -> bool:
        raise NotImplementedError

    def world_size(self) -> int:
        raise NotImplementedError

    def rank(self) -> int:
        """This process's rank within the backend's world (0-based)."""
        return 0

    def all_gather(self, x: Tensor, group: Optional[Any] = None) -> List[Tensor]:
        """Gather ``x`` from every rank; returns a list of per-rank tensors.
        Ranks may differ in their shapes (pad-gather-trim)."""
        raise NotImplementedError

    def all_gather_object(self, obj: Any, group: Optional[Any] = None) -> List[Any]:
        """Gather a picklable host object from every rank."""
        raise NotImplementedError(f"{type(self).__name__} cannot gather host objects.")

    def all_reduce(self, x: Tensor, op: str, group: Optional[Any] = None) -> Tensor:
        """Reduction across ranks (op in sum/mean/max/min); by default a gather
        and a local reduce.

        Every rank contributes one equally weighted operand: ``"mean"``
        divides by the world size, never by row counts. Per-rank shapes must
        therefore be identical, and uneven shapes raise.
        """
        per_rank = self.all_gather(x, group)
        shapes = {tuple(g.shape) for g in per_rank}
        if len(shapes) > 1:
            from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

            raise TPUMetricsUserError(
                f"all_reduce[{op}] needs identical per-rank shapes, got {sorted(shapes)}. "
                "Reduce-op metric states are elementwise across ranks; a state whose "
                "shape is data-dependent must use 'cat' (gather) semantics instead."
            )
        gathered = torch.stack(per_rank)
        if op == "sum":
            return gathered.sum(dim=0, dtype=x.dtype)
        if op == "mean":
            return gathered.sum(dim=0, dtype=x.dtype) / len(per_rank)
        if op == "max":
            return gathered.amax(dim=0)
        if op == "min":
            return gathered.amin(dim=0)
        raise ValueError(f"Unsupported all_reduce op {op}")

    def barrier(self) -> None:  # noqa: B027
        """Synchronization barrier (no-op by default)."""


class NoOpBackend(DistributedBackend):
    """Single-process, single-replica backend."""

    def available(self) -> bool:
        return False

    def world_size(self) -> int:
        return 1

    def all_gather(self, x: Tensor, group: Optional[Any] = None) -> List[Tensor]:
        return [x]

    def all_gather_object(self, obj: Any, group: Optional[Any] = None) -> List[Any]:
        return [obj]

    def all_reduce(self, x: Tensor, op: str, group: Optional[Any] = None) -> Tensor:
        return x


_DTYPES = (
    torch.bool, torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
    torch.float16, torch.bfloat16, torch.float32, torch.float64, torch.complex64,
)
_MAX_NDIM = 8

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class TorchDistBackend(DistributedBackend):
    """Eager backend over ``torch.distributed``: one process per rank.

    ``process_group`` is the group every collective runs in (the default
    group when ``None``); a ``group`` passed to a call overrides it. The
    states must lie where the group's backend carries them (CUDA tensors for
    NCCL, CPU tensors for gloo): a state is never moved to make a collective
    fit, and a mismatch raises naming both.

    ``all_gather`` handles ranks whose shapes differ (the pad-gather-trim of
    the reference): one fixed-width gather of every rank's (ndim, shape,
    dtype) first, then each rank pads to the largest shape, one gather moves
    the data and the results are trimmed back. A rank with no data (size 0)
    adopts the dtype and ndim of the ranks that have some.
    """

    def __init__(self, process_group: Optional[Any] = None) -> None:
        self.process_group = process_group

    def _group(self, group: Optional[Any]) -> Optional[Any]:
        return self.process_group if group is None else group

    def available(self) -> bool:
        return dist.is_available() and dist.is_initialized() and self.world_size() > 1

    def world_size(self) -> int:
        return dist.get_world_size(self.process_group)

    def rank(self) -> int:
        return dist.get_rank(self.process_group)

    def _check_device(self, x: Tensor, group: Optional[Any]) -> None:
        name = str(dist.get_backend(group))
        # a combined backend reads like "cpu:gloo,cuda:nccl"
        devices = {part.split(":")[0] for part in name.split(",")} if ":" in name else _BACKEND_DEVICES.get(name)
        if devices is not None and x.device.type not in devices:
            raise RuntimeError(
                f"The {name!r} process group cannot carry a state on {x.device}: it carries"
                f" {sorted(devices)} tensors. Metric states are not moved to fit a collective; put the metric"
                " on a device the group carries, or sync it over a group of the state's device."
            )

    def _gather_equal(self, x: Tensor, group: Optional[Any]) -> List[Tensor]:
        """One ``all_gather`` of a tensor whose shape and dtype every rank shares."""
        world = dist.get_world_size(group)
        if _telemetry.recording():  # every gather on the wire funnels through here
            _telemetry.record_collective(
                self, "all_gather", "gather", tuple(x.shape), dtype_name(x.dtype), x.element_size(), world
            )
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x.contiguous(), group=group)
        return out

    def all_gather(self, x: Tensor, group: Optional[Any] = None) -> List[Tensor]:
        group = self._group(group)
        self._check_device(x, group)
        x = torch.atleast_1d(x)
        if x.ndim > _MAX_NDIM:
            raise ValueError(f"all_gather supports up to {_MAX_NDIM} dimensions, got {x.ndim}")
        spec = [x.ndim, *x.shape] + [-1] * (_MAX_NDIM - x.ndim) + [_DTYPES.index(x.dtype) if x.dtype in _DTYPES else -1]
        specs = [s.tolist() for s in self._gather_equal(torch.tensor(spec, dtype=torch.int64, device=x.device), group)]
        shapes = [tuple(s[1 : 1 + s[0]]) for s in specs]

        # a rank with no data adopts the dtype of the ranks that have data
        data_dtypes = [s[-1] for s, shape in zip(specs, shapes) if _numel(shape) > 0]
        if x.numel() == 0 and data_dtypes and data_dtypes[0] >= 0:
            x = x.to(_DTYPES[data_dtypes[0]])
        if all(_numel(shape) == 0 for shape in shapes):
            return [x.new_zeros(shape) for shape in shapes]  # nothing to move
        if all(shape == shapes[0] for shape in shapes):
            return self._gather_equal(x, group)

        # empty contributions take the ndim of the ranks that have data
        ref = max(shapes, key=lambda s: (len(s), _numel(s)))
        shapes = [s if len(s) == len(ref) else (0, *ref[1:]) for s in shapes]
        if x.numel() == 0 and x.ndim != len(ref):
            x = x.new_zeros((0, *ref[1:]))
        # pad-gather-trim
        max_shape = [max(dims) for dims in zip(*shapes)]
        padded = x.new_zeros(max_shape)
        padded[tuple(slice(0, d) for d in x.shape)] = x
        gathered = self._gather_equal(padded, group)
        return [g[tuple(slice(0, d) for d in shape)] for g, shape in zip(gathered, shapes)]

    def all_gather_object(self, obj: Any, group: Optional[Any] = None) -> List[Any]:
        group = self._group(group)
        if _telemetry.recording():
            import pickle

            _telemetry.record_event(self, "all_gather_object", pickled_bytes=len(pickle.dumps(obj)))
        out: List[Any] = [None] * dist.get_world_size(group)
        dist.all_gather_object(out, obj, group=group)
        return out

    def all_reduce(self, x: Tensor, op: str, group: Optional[Any] = None) -> Tensor:
        """One ``all_reduce`` into a copy of ``x`` (``x`` itself may be a
        shared state, never written in place). ``"mean"`` is a SUM divided by
        the world size, as ``pmean`` is (gloo has no AVG): int states come
        back as float32 means, as in the JAX package."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"Unsupported all_reduce op {op}")
        group = self._group(group)
        self._check_device(x, group)
        if _telemetry.recording():
            _telemetry.record_collective(
                self, "all_reduce", op, tuple(x.shape), dtype_name(x.dtype), x.element_size(),
                dist.get_world_size(group),
            )
        if op in ("max", "min") and x.is_floating_point():
            return self._all_reduce_nan_extreme(x, op, group)
        out = x.clone()
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=group)
        if op == "mean":
            out = out / dist.get_world_size(group)
        return out

    def _all_reduce_nan_extreme(self, x: Tensor, op: str, group: Optional[Any]) -> Tensor:
        """A float max or min in which a NaN on any rank wins, as it does in
        ``torch.maximum`` and in the JAX package's reductions (NCCL's and
        gloo's MAX and MIN let the number win instead). The NaNs travel as a
        flag beside the values, in the same collective."""
        nan = torch.isnan(x).reshape(-1)
        sign = 1.0 if op == "max" else -1.0
        packed = torch.cat([torch.where(nan, -sign * float("inf"), x.reshape(-1)), nan.to(x.dtype) * sign])
        dist.all_reduce(packed, op=_REDUCE_OPS[op], group=group)
        n = x.numel()
        return torch.where(packed[n:] != 0, float("nan"), packed[:n]).reshape(x.shape)

    def barrier(self) -> None:
        dist.barrier(group=self.process_group)


def dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's name of a dtype (``"float32"`` for ``torch.float32``),
    as the collective ledger records it."""
    return str(dtype).removeprefix("torch.")


def _numel(shape: tuple) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


_DEFAULT_BACKEND: Optional[DistributedBackend] = None


def get_default_backend() -> DistributedBackend:
    """The ambient backend: a :class:`TorchDistBackend` over the default
    group when ``torch.distributed`` is initialized with more than one rank,
    else :class:`NoOpBackend`; :func:`set_default_backend` overrides both."""
    if _DEFAULT_BACKEND is not None:
        return _DEFAULT_BACKEND
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return TorchDistBackend()
    return NoOpBackend()


def set_default_backend(backend: Optional[DistributedBackend]) -> None:
    """Override the ambient backend (``None`` restores the automatic choice)."""
    global _DEFAULT_BACKEND
    _DEFAULT_BACKEND = backend


def distributed_available() -> bool:
    """Default ``distributed_available_fn``: whether the ambient backend syncs."""
    return get_default_backend().available()
