"""The process-global backbone registry: ONE resident weight set per
(architecture, weights digest, device, dtype policy) (port of
``tpumetrics/backbones/registry.py``).

Every pretrained forward the metric families use (the LPIPS conv stacks,
the FID InceptionV3) would otherwise be loaded, cast and placed privately
per metric instance: two FID instances on one stream would hold two copies
of a ~95 MB weight tree and capture two sets of graphs.
:func:`get_backbone` collapses that to one :class:`BackboneHandle` per
registry key, refcounted across metric instances:

- weights are copied to the device once
  (:func:`~tpumetrics_torch.backbones.placement.place_backbone`);
- the forward runs in the handle's
  :class:`~tpumetrics_torch.backbones.engine.BackboneEngine`, so N
  instances share one set of staging buffers and graphs;
- :func:`resident_bytes` and :func:`registry_stats` say what is resident.

Handles are acquired in a metric's ``__init__`` and released by its
``release_backbones()``; never build weights in code that ``update()``
reaches.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.backbones.engine import BackboneEngine
from tpumetrics_torch.backbones.placement import (
    DTYPE_POLICIES,
    _refuse_mesh,
    _map_leaves,
    param_paths,
    place_backbone,
)
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

Tensor = torch.Tensor

__all__ = ["BackboneHandle", "get_backbone", "resident_bytes", "registry_stats"]


def _leaf_bytes(leaf: Any) -> Tuple[str, Tuple[int, ...], bytes]:
    if isinstance(leaf, Tensor):
        t = leaf.detach().cpu().contiguous()
        return str(t.dtype), tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()
    arr = np.ascontiguousarray(np.asarray(leaf))
    return str(arr.dtype), tuple(arr.shape), arr.tobytes()


def _weights_digest(params: Any) -> str:
    """Content digest of a parameter pytree: path + dtype + shape + bytes per
    leaf. Two metrics built from the same converted checkpoint hash
    identically even through separate ``np.load`` calls."""
    h = hashlib.sha1()
    for path, leaf in param_paths(params):
        dtype, shape, raw = _leaf_bytes(leaf)
        h.update(path.encode())
        h.update(str(shape).encode())
        h.update(dtype.encode())
        h.update(raw)
    return h.hexdigest()


def _builtin_forward(arch: str) -> Callable[..., Any]:
    """The forward for a built-in arch key (``lpips:<net>`` /
    ``inception:<tap>``); raises for unknown keys, so custom architectures
    pass ``forward=``."""
    family, _, variant = arch.partition(":")
    if family == "lpips":
        from tpumetrics_torch.image._backbones import _BACKBONE_BUILDERS

        if variant not in _BACKBONE_BUILDERS:
            raise TPUMetricsUserError(
                f"Unknown LPIPS backbone arch {arch!r}; expected lpips:alex/vgg/squeeze."
            )

        def forward(params: Any, x: Tensor) -> Any:
            return _BACKBONE_BUILDERS[variant](params)(x)

        return forward
    if family == "inception":
        from tpumetrics_torch.image._inception import inception_v3_features

        def forward(params: Any, x: Tensor) -> Tensor:
            return inception_v3_features(params, (variant,))(x)[0]

        return forward
    raise TPUMetricsUserError(
        f"Unknown backbone arch {arch!r} and no `forward=` given; built-in families"
        " are 'lpips:<alex|vgg|squeeze>' and 'inception:<tap>'."
    )


def _closed(key: str) -> TPUMetricsUserError:
    return TPUMetricsUserError(f"Backbone handle {key!r} is closed; re-acquire it via get_backbone().")


class BackboneHandle:
    """One resident backbone: placed params + shared engine + refcount.

    Instances come from :func:`get_backbone` only. ``close()`` drops one
    reference; the last close evicts the handle from the registry and frees
    the weights. ``generation`` counts the weights' placements: a graph
    captured around the forward reads the weights of one generation."""

    def __init__(
        self,
        reg_key: Tuple,
        key: str,
        arch: str,
        params: Any,
        engine: BackboneEngine,
        mesh: Optional[Any],
        dtype_policy: str,
        device: torch.device,
    ) -> None:
        self._reg_key = reg_key
        self.key = key
        self.arch = arch
        self.params = params
        self.engine = engine
        self.mesh = mesh
        self.dtype_policy = dtype_policy
        self.device = device
        self.refs = 0
        self.closed = False
        self.generation = 0
        # tenant-lifecycle parking: refs that moved resident -> parked (a
        # hibernated tenant still owns its reference, it just does not pin
        # device memory); when the LAST resident ref parks, the weights are
        # copied to a host stash and freed, and reacquire() re-places them
        self.parked = 0
        self._host_params: Any = None

    def __call__(self, *args: Any) -> Any:
        """Dispatch the shared forward (see :class:`BackboneEngine`)."""
        if self.closed:
            raise _closed(self.key)
        return self.engine(self.params, *args)

    def acquire(self) -> "BackboneHandle":
        """Take one more reference (e.g. a metric adopting a caller-supplied
        handle) and return self. Pair with :meth:`close`."""
        with _LOCK:
            if self.closed:
                raise _closed(self.key)
            self.refs += 1
        return self

    def resident_bytes(self) -> int:
        """Device bytes held by this handle's weights."""
        if self.params is None:
            return 0
        return sum(int(leaf.nbytes) for _path, leaf in param_paths(self.params) if isinstance(leaf, Tensor))

    def release_resident(self) -> bool:
        """Tenant hibernation: move one reference from resident to parked.
        When the last RESIDENT reference parks, the weights are copied to a
        host stash and freed, and the engine drops its programs; another
        resident holder keeps the weights where they are. Returns ``True``
        iff THIS call released the weights."""
        with _LOCK:
            if self.closed:
                raise _closed(self.key)
            self.refs -= 1
            self.parked += 1
            if self.refs > 0 or self.params is None:
                return False
            self._host_params = _map_leaves(lambda _path, t: t.detach().cpu(), self.params)
            self.params = None
        self.engine.reset()
        return True

    def reacquire(self) -> "BackboneHandle":
        """Tenant revival: move one parked reference back to resident,
        re-placing the weights from the host stash when this is the first
        resident holder since the park. Pair with :meth:`release_resident`."""
        with _LOCK:
            if self.closed:
                raise _closed(self.key)
            if self.parked > 0:
                self.parked -= 1
            self.refs += 1
            self._ensure_placed_locked()
        return self

    def _ensure_placed_locked(self) -> None:
        """Re-place a parked handle's weights from the host stash (registry lock held)."""
        if self.params is not None:
            return
        host, self._host_params = self._host_params, None
        if host is None:
            raise TPUMetricsUserError(
                f"Backbone handle {self.key!r} has neither resident nor parked "
                "weights; it was corrupted or reset mid-lifecycle."
            )
        self.params = place_backbone(self.arch, host, dtype_policy=self.dtype_policy, device=self.device)
        self.generation += 1

    def discard_parked(self) -> None:
        """Drop one PARKED reference without reviving: a hibernated tenant's
        metric released for good. The last reference (resident or parked)
        frees the handle entirely."""
        with _LOCK:
            if self.closed or self.parked <= 0:
                return
            self.parked -= 1
            if self.refs > 0 or self.parked > 0:
                return
            self.closed = True
            _HANDLES.pop(self._reg_key, None)
            self._host_params = None
        self.params = None
        self.engine.reset()

    def close(self) -> None:
        """Drop one reference; the last reference frees the weights. A
        parked reference (a hibernated tenant's claim) keeps the handle
        registered: its host stash must survive for the revival."""
        with _LOCK:
            if self.closed:
                return
            self.refs -= 1
            if self.refs > 0 or self.parked > 0:
                return
            self.closed = True
            _HANDLES.pop(self._reg_key, None)
            self._host_params = None
        self.params = None
        self.engine.reset()

    def __deepcopy__(self, memo: Dict) -> "BackboneHandle":
        """Handles are shared by reference: a cloned metric dispatches the
        same resident backbone and owns one more reference on it."""
        # memo ourselves: deepcopy only records y when y is not x, so without
        # this every encounter within one clone would bump the refcount again
        memo[id(self)] = self
        with _LOCK:
            if not self.closed:
                self.refs += 1
        return self

    def __repr__(self) -> str:
        return f"BackboneHandle({self.key!r}, refs={self.refs}, bytes={self.resident_bytes()})"


_LOCK = threading.Lock()
_HANDLES: Dict[Tuple, BackboneHandle] = {}


def get_backbone(
    arch: str,
    params: Any,
    *,
    mesh: Optional[Any] = None,
    dtype_policy: str = "float32",
    forward: Optional[Callable[..., Any]] = None,
    pad_axes: Sequence[int] = (0,),
    key: Optional[str] = None,
    acquire: bool = True,
    device: Union[str, torch.device, None] = None,
) -> BackboneHandle:
    """Acquire the resident :class:`BackboneHandle` for (arch, weights,
    device, dtype policy): placing the weights on first acquisition, bumping
    the refcount on every later one.

    Args:
        arch: built-in key (``"lpips:alex"``, ``"inception:2048"``) or any
            caller-chosen name for a custom ``forward=``.
        params: the weight pytree (dicts, lists and tuples of numpy arrays
            or tensors).
        mesh: the JAX package's sharded placement; must be None
            (``parallel/sharding.py`` is not ported yet).
        dtype_policy: ``"float32"`` (default, the oracle) or ``"bfloat16"``
            (opt-in; gate it with the per-metric error bounds).
        forward: ``(params, *tensors) -> pytree`` for custom architectures.
        pad_axes: engine bucketing axes (dim 0 batch; add dim 1 for
            token-id sequence axes).
        key: explicit weights identity, skipping the content digest, for
            callers that cannot afford the hash.
        acquire: ``True`` (default) bumps the refcount: the caller owns a
            reference and must ``close()`` it. ``False`` is the functional
            idiom: an existing handle is returned without a ref bump, and a
            freshly placed one keeps a single registry-owned reference (a
            process-lifetime cache).
        device: where the weights live; the current card when omitted.
    """
    from tpumetrics_torch.metric import _resolve_device

    _refuse_mesh(mesh)
    if dtype_policy not in DTYPE_POLICIES:
        raise TPUMetricsUserError(
            f"Backbone dtype policy must be one of {DTYPE_POLICIES}, got {dtype_policy!r}."
        )
    device = _resolve_device(device)
    digest = key if key is not None else _weights_digest(params)
    reg_key = (arch, digest, str(device), dtype_policy)
    with _LOCK:
        handle = _HANDLES.get(reg_key)
        if handle is not None:
            if acquire:
                handle.refs += 1
            # a parked handle (every holder hibernated) re-places from its
            # host stash before being handed out: the caller expects a
            # dispatchable backbone
            handle._ensure_placed_locked()
            return handle
    # placement (a copy of the whole tree) runs OUTSIDE the lock; the
    # setdefault below resolves the rare duplicate-placement race in favor
    # of the first publisher
    fwd = forward if forward is not None else _builtin_forward(arch)
    placed = place_backbone(arch, params, dtype_policy=dtype_policy, device=device)
    public = f"{arch}:{digest[:12]}:{dtype_policy}"
    engine = BackboneEngine(fwd, label=f"backbones/{public}", dtype_policy=dtype_policy, pad_axes=pad_axes)
    fresh = BackboneHandle(reg_key, public, arch, placed, engine, mesh, dtype_policy, device)
    with _LOCK:
        handle = _HANDLES.setdefault(reg_key, fresh)
        if acquire or handle.refs == 0:
            handle.refs += 1
    return handle


def resident_bytes() -> int:
    """Total device bytes held by every resident backbone."""
    with _LOCK:
        handles = list(_HANDLES.values())
    return sum(h.resident_bytes() for h in handles)


def registry_stats() -> Dict[str, Dict[str, Any]]:
    """Per-handle registry snapshot: refs, resident bytes, engine counters."""
    with _LOCK:
        handles = list(_HANDLES.values())
    return {
        h.key: {
            "arch": h.arch,
            "refs": h.refs,
            "parked": h.parked,
            "bytes": h.resident_bytes(),
            "compiles": h.engine.compile_count,
            "dispatches": h.engine.dispatch_count,
            "dtype_policy": h.dtype_policy,
        }
        for h in handles
    }


def _reset_backbones() -> None:
    """Drop every resident handle (tests only)."""
    with _LOCK:
        handles = list(_HANDLES.values())
        _HANDLES.clear()
    for h in handles:
        h.closed = True
        h.params = None
        h._host_params = None
        h.engine.reset()
