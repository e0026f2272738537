"""The shared backbone forward engine: bucketed, staged, captured, policied
(port of ``tpumetrics/backbones/engine.py``).

One :class:`BackboneEngine` per resident
:class:`~tpumetrics_torch.backbones.registry.BackboneHandle` runs the
forward every metric instance sharing that backbone dispatches through:

- **bucketed**: inputs are padded to the next power of two along the batch
  (and optionally sequence) axes (:func:`pow2_at_least`), so the shapes the
  forward sees are bounded: log2(max batch) graphs, not one per batch size.
  Pad rows are zeros; the forward must be row-independent (every built-in
  backbone is), and the engine slices the pad rows back off the outputs.
- **staged**: the engine owns one static staging buffer per (bucket,
  signature). The call's tensors are copied into it and the rest zeroed;
  the forward reads only the staging buffers, the counterpart of the JAX
  package's donated staging copy, and the graph of that bucket reads them
  at fixed addresses.
- **captured**: each (bucket, signature) runs its forward over the staging
  buffers through one :class:`~tpumetrics_torch.utils.jit_fallback.
  JitWithEagerFallback`, which reads them in place: on a card the first
  call runs eagerly (the warm-up), the second captures the forward as a
  CUDA graph (in the card's one pool of backbone graphs), and later calls
  replay it and copy the outputs out; ``compile_count`` counts those
  captures. A bucket whose capture fails runs eagerly from then on, by that
  wrapper's latch. On the CPU the forward runs eagerly and
  ``compile_count`` counts first sightings.
  ``dispatch_count`` counts calls.
- **dtype policy**: the weights arrive already cast by
  :func:`~tpumetrics_torch.backbones.placement.place_backbone`; the engine
  casts floating inputs to the policy dtype and floating outputs back to
  float32, so downstream accumulators (Fréchet moments, cosine scores) keep
  float32 states whatever the forward's precision.
- **capture-transparent**: called while a stream captures a graph (a
  metric's captured update), the engine runs the forward inline: the
  caller's graph records it, with no padding, staging or graph of its own.

The JAX engine's ``mesh`` and its per-program profiles
(``telemetry/device.py``) wait for the port of ``parallel/sharding.py`` and
``telemetry/device.py``; ``mesh=`` raises.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from tpumetrics_torch.backbones.placement import _check_policy, _refuse_mesh
from tpumetrics_torch.utils.checks import _is_capturing
from tpumetrics_torch.utils.jit_fallback import JitWithEagerFallback, _tree_map

Tensor = torch.Tensor

__all__ = ["BackboneEngine"]


def pow2_at_least(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) (a copy of the JAX package's
    ``runtime/bucketing.py`` helper)."""
    e = max(int(floor), 1)
    while e < n:
        e *= 2
    return e


def _apply(forward: Callable[..., Any], dtype: Optional[torch.dtype], params: Any, *args: Tensor) -> Any:
    """The forward under a dtype policy: floating inputs cast to ``dtype``
    (None: as they are), floating outputs back to float32."""
    out = forward(params, *(a.to(dtype) if dtype is not None and a.is_floating_point() else a for a in args))
    return _tree_map(lambda t: t.float() if t.is_floating_point() and t.dtype != torch.float32 else t, out)


class _Program:
    """One (bucket, signature): its staging buffers and the forward over
    them (``run``, a :class:`JitWithEagerFallback` that captures it on a
    card and holds the bucket's eager latch)."""

    def __init__(self, staging: Tuple[Tensor, ...], run: JitWithEagerFallback) -> None:
        self.staging = staging
        self.run = run

    @property
    def eager(self) -> bool:
        """Latched to eager after a failed capture and an eager success."""
        return self.run.eager_mode


class BackboneEngine:
    """Bucketed, staged forward dispatch for one resident backbone.

    Args:
        forward: function ``(params, *tensors) -> pytree`` whose tensor
            leaves carry the batch on dim 0.
        label: the engine's name (``backbones/<key>``).
        dtype_policy: ``"float32"`` (default, the oracle) or ``"bfloat16"``.
        mesh: the JAX package's sharded placement; must be None here.
        pad_axes: input axes padded to the next power of two (dim 0 = batch;
            add dim 1 for token-id/mask sequence axes).
    """

    def __init__(
        self,
        forward: Callable[..., Any],
        *,
        label: str,
        dtype_policy: str = "float32",
        mesh: Optional[Any] = None,
        pad_axes: Sequence[int] = (0,),
    ) -> None:
        _refuse_mesh(mesh)
        self.forward = forward
        self.label = label
        self.dtype_policy = dtype_policy
        dtype = _check_policy(dtype_policy)
        self._cast = dtype if dtype_policy != "float32" else None  # the floating inputs' cast, if any
        self.mesh = mesh
        self.pad_axes = tuple(sorted(set(int(a) for a in pad_axes)))
        self.compile_count = 0  # graphs captured (a card) or signatures first seen (the CPU)
        self.dispatch_count = 0
        self._lock = threading.Lock()
        self._programs: Dict[Hashable, _Program] = {}
        self._bound: Any = None  # the params the programs' graphs read

    def _apply(self, params: Any, *args: Tensor) -> Any:
        return _apply(self.forward, self._cast, params, *args)

    # ----------------------------------------------------------- dispatch

    def _bucket_shape(self, t: Tensor) -> Tuple[int, ...]:
        shape = list(t.shape)
        for axis in self.pad_axes:
            if axis < t.ndim:
                shape[axis] = pow2_at_least(max(1, shape[axis]))
        return tuple(shape)

    def _stage(self, program: _Program, args: Tuple[Tensor, ...]) -> None:
        """Copy the call's tensors into the staging buffers and zero the pad
        region a call of another size in the same bucket may have left."""
        for buf, a in zip(program.staging, args):
            region = buf
            for axis in self.pad_axes:
                if axis < a.ndim and a.shape[axis] != buf.shape[axis]:
                    region.narrow(axis, a.shape[axis], buf.shape[axis] - a.shape[axis]).zero_()
                    region = region.narrow(axis, 0, a.shape[axis])
            region.copy_(a)

    def _program_for(self, params: Any, args: Tuple[Tensor, ...]) -> Tuple[_Program, bool]:
        """The program of this (bucket, signature), and whether it is new."""
        key = tuple((self._bucket_shape(a), a.dtype, a.device) for a in args)
        with self._lock:
            if params is not self._bound:  # new weights (a re-placement): no graph may read the old ones
                self._programs.clear()
                self._bound = params
            program = self._programs.get(key)
            fresh = program is None
            if fresh:
                staging = tuple(torch.zeros(shape, dtype=dt, device=dev) for shape, dt, dev in key)
                what = f"{self.label}: the forward of bucket {key[0][0] if key else ()}"
                # the forward closes over the weights and the policy, not the engine: an engine in a reference
                # cycle would keep its graphs until the garbage collector ran
                forward = functools.partial(_apply, self.forward, self._cast, params)
                run = JitWithEagerFallback(forward, what, own_inputs=False, pure=True)
                program = self._programs[key] = _Program(staging, run)
        return program, fresh

    def reset(self) -> None:
        """Drop every program (staging buffers and graphs)."""
        with self._lock:
            self._programs.clear()
            self._bound = None

    def __call__(self, params: Any, *args: Any) -> Any:
        """Run the forward. While a stream captures: inline (the caller's graph
        owns bucketing). Otherwise: stage into the bucket's buffers, run the
        forward (eagerly, or by replaying the bucket's graph on a card), and
        slice the pad rows off."""
        if _is_capturing():
            return self._apply(params, *args)
        args = tuple(torch.as_tensor(a) for a in args)
        n = int(args[0].shape[0]) if args and args[0].ndim else 0
        program, fresh = self._program_for(params, args)
        self._stage(program, args)
        device = program.staging[0].device if program.staging else torch.device("cpu")
        bucket = program.staging[0].shape[0] if program.staging and program.staging[0].ndim else 0

        def trim(leaf: Tensor) -> Tensor:
            if leaf.ndim and leaf.shape[0] == bucket and bucket != n:
                return leaf[:n]
            return leaf

        self.dispatch_count += 1
        captured = program.run.counts["captured"]
        out = program.run(*program.staging)
        if program.run.counts["captured"] != captured or (fresh and device.type != "cuda"):
            self.compile_count += 1
        return _tree_map(trim, out)
