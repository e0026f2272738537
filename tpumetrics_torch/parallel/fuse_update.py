"""Whole-collection fused update: one CUDA graph per collection step (port of
``tpumetrics/parallel/fuse_update.py``).

A K-leader :class:`~tpumetrics_torch.collections.MetricCollection` runs K
Python-driven updates per ``update`` call, some 80 eagerly dispatched device
operations in all for the classification main path, so the host sets the
pace. :class:`FusedCollectionStep` composes every compute-group leader's
``functional_update`` into one state transition::

    {name: state} x batch  ->  {name: state}

and captures it as one ``torch.cuda.CUDAGraph`` per key: the per-call
keyword arguments and each positional tensor's (shape, dtype, device), or,
for a dict of tensors given positionally (a packed detection batch), its
sorted keys and each value's (shape, dtype, device). That is the counterpart
of one jitted program per static-kwargs key, specialised per trace
signature (a pytree's, in the JAX step). A replay relaunches every captured
kernel with no Python in between.

How a call runs:

- The step owns one buffer per state tensor, at a fixed address, and every
  graph reads and writes those buffers: the update happens in place, which
  stands in for the JAX package's buffer donation. A state tensor handed to
  the step that is not its own buffer (by identity: a stored default after
  ``__init__``/``reset()``, a state assigned from outside, a state that
  ``forward`` or ``unsync`` put back) is copied into the buffer first.
- The first sighting of a key runs the transition eagerly on the buffers.
  That is the warm-up: it builds the kernel library and fills the kernel's
  per-device cache, so the capture launches nothing but device work, and a
  ragged last batch, seen once, pays no capture. A state whose shape the
  warm-up changes (a scalar default that a 2-D batch broadcasts to one
  entry per output, as ``ExplainedVariance``'s after a ``reset``) gets a new
  buffer there; a captured transition keeps every shape.
- The second sighting captures the transition into a graph whose own input
  buffers the batch is copied into, and whose last operations copy the new
  state into the step's buffers; the graph then replays once to perform the
  update. Later sightings copy the batch in and replay.
- All graphs of one step share one memory pool. Their outputs are copied
  into the step's buffers, which live outside the pool, so no pool memory
  outlives a replay.
- A capture that fails (an operation that reads the device on the host, a
  copy from pageable host memory) raises: nothing falls back to eager
  silently. The calls that run eagerly are the documented ones: a first
  sighting, a call with a tensor anywhere in its keyword arguments or with
  a positional argument that is neither a tensor nor a dict of tensors
  (:class:`UnhashableKwargsError`;
  the collection then runs the whole call eagerly), and, on the
  collection's path, the leaders that :func:`fusable_oo_leaders` leaves out.
- On a CPU state the step takes the same path (keys, ownership, copy-in of
  the batch into the program's input buffers, write-back) and calls the
  transition eagerly where a CUDA state would replay a graph.

**Donation contract.** With ``donate=True`` (the default) the state the
step returns IS its buffers, and the next update changes them in place: a
state tensor read before a fused update (a member attribute, a snapshot
taken with ``_copy_state_dict``) may change with that update. Clone what
must stay. With ``donate=False`` the step returns copies and never changes a
tensor the caller holds.

Left out here (``masked_update``, ``megabatch_update``, a mesh, telemetry and
the health probe of the JAX step) belong to the streaming runtime.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Hashable, Iterator, List, Optional, Tuple

import torch

from tpumetrics_torch.buffers import MaskedBuffer
from tpumetrics_torch.ops import COUNTED_KERNELS
from tpumetrics_torch.utils.checks import _gc_paused
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError
from tpumetrics_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor
Path = Tuple[str, ...]

# one warning when a step holds this many programs: the signature of a
# per-batch-varying kwarg capturing a graph for every value
_PROGRAM_CACHE_WARN = 32


class UnhashableKwargsError(TypeError):
    """A call's arguments cannot key a captured graph.

    A deliberate fall-back signal: per-call keyword arguments must be
    hashable and hold no tensor (a tensor is hashable in torch, by identity,
    so it would key a new graph every call), and positional arguments must
    be tensors or dicts of tensors. Callers with such arguments catch exactly
    this class and run the unfused path. It stays distinct from other ``TypeError``s, which
    mean a member's ``update`` failed and must surface.
    """


def fusable_oo_leaders(collection: Any) -> List[str]:
    """Group-leader names whose attribute states can round-trip through one
    captured transition: every registered state is a tensor or holds a
    MaskedBuffer, the leader updates through the base functional bridge,
    and its update reads nothing on the host by its semantics.

    Leaders with list states keep their eager update: a list grows every
    step (a new structure each call), and routing it through a
    fixed-capacity MaskedBuffer would change eager semantics. A list state
    that already holds a MaskedBuffer (one installed with
    ``interop.load_state``, e.g. from ``init_state()`` after
    ``set_state_capacity``) appends at a fixed capacity in its eager update
    too, so the step changes nothing there. Wrappers (``Running``), whose
    state lives in child metrics and which have no functional bridge, stay
    eager, and so do metrics that mark ``_update_reads_host`` (a nominal
    metric with ``nan_strategy="drop"``).
    """
    from tpumetrics_torch.metric import Metric

    leaders = []
    for cg in collection._groups.values():
        m0 = collection._modules[cg[0]]
        if (
            m0._defaults
            and all(_holds_tensors(m0, name) for name in m0._defaults)
            and type(m0).functional_update is Metric.functional_update
            and not m0._update_reads_host
        ):
            leaders.append(cg[0])
    return leaders


def _holds_tensors(metric: Any, name: str) -> bool:
    """Whether state ``name`` of ``metric`` is a tensor or a MaskedBuffer
    now (a list state is neither; one that holds a buffer is the latter), or
    an empty list that the metric names in ``_idle_list_states`` (no update a
    step can key fills it; the step carries it as it is)."""
    val = getattr(metric, name)
    return not isinstance(val, list) or (not val and name in metric._idle_list_states)


def _leaves(state: Dict[str, Any], prefix: Path = ()) -> Iterator[Tuple[Path, Tensor]]:
    """``(path, tensor)`` of every tensor of a (nested) state dict, a
    MaskedBuffer's fields included. An empty list holds none (a pytree's
    empty node); a list that is not empty raises."""
    for key, val in state.items():
        path = (*prefix, key)
        if isinstance(val, list) and not val:
            continue
        if isinstance(val, dict):
            yield from _leaves(val, path)
        elif isinstance(val, MaskedBuffer):
            for field in val._fields:
                yield (*path, field), getattr(val, field)
        elif isinstance(val, Tensor):
            yield path, val
        else:
            raise TypeError(
                f"State {'/'.join(path)} is a {type(val).__name__}: a fused step holds tensor states and"
                " MaskedBuffers only. List states keep the eager update."
            )


def _rebuild(state: Dict[str, Any], leaf: Dict[Path, Tensor], prefix: Path = ()) -> Dict[str, Any]:
    """A state of the structure of ``state`` whose tensors are ``leaf[path]``."""
    out: Dict[str, Any] = {}
    for key, val in state.items():
        path = (*prefix, key)
        if isinstance(val, list) and not val:
            out[key] = []
        elif isinstance(val, dict):
            out[key] = _rebuild(val, leaf, path)
        elif isinstance(val, MaskedBuffer):
            out[key] = MaskedBuffer(*(leaf[(*path, field)] for field in val._fields))
        else:
            out[key] = leaf[path]
    return out


def gather_donatable_state(state: Dict[str, Any], owned: Dict[Path, Tensor]) -> Tuple[Dict[Path, Tensor], bool]:
    """Put every tensor of ``state`` in the buffer of ``owned`` that the fused
    step updates in place; returns ``{path: buffer}`` and whether a buffer
    was replaced (graphs that read the old one are stale).

    A tensor that is not its path's buffer (by identity) is copied into it: a
    state that still IS the metric's stored default (after
    ``__init__``/``reset``; updating it in place would change every later
    ``reset``), a state assigned from outside, one that ``forward`` or
    ``unsync`` put back, or the same tensor at two paths. A path seen for the
    first time, or whose shape, dtype or device changed, gets a new buffer (a
    contiguous copy).
    """
    out: Dict[Path, Tensor] = {}
    replaced = False
    for path, val in _leaves(state):
        buf = owned.get(path)
        if buf is None or buf.shape != val.shape or buf.dtype != val.dtype or buf.device != val.device:
            replaced = replaced or buf is not None
            buf = owned[path] = val.detach().clone(memory_format=torch.contiguous_format)
        elif val is not buf:
            buf.copy_(val)
        out[path] = buf
    return out, replaced


class _Program:
    """One key's capture: the input buffers the batch is copied into, the
    graph (``None`` on the CPU), the per-call kwargs baked into it, how many
    calls of each kernel it recorded, and how often it replayed."""

    __slots__ = ("static_args", "graph", "kwargs", "kernel_calls", "replays")

    def __init__(self, static_args: Tuple[Any, ...], graph: Any, kwargs: Dict[str, Any], kernel_calls: Dict[str, int]):
        self.static_args = static_args
        self.graph = graph
        self.kwargs = kwargs
        self.kernel_calls = kernel_calls
        self.replays = 0


def _holds_tensor(x: Any) -> bool:
    if isinstance(x, Tensor):
        return True
    if isinstance(x, dict):
        return any(_holds_tensor(k) or _holds_tensor(v) for k, v in x.items())
    if isinstance(x, (list, tuple, set, frozenset)):
        return any(_holds_tensor(v) for v in x)
    return False


def _arg_signature(i: int, a: Any) -> Hashable:
    """A positional argument's part of a program key: a tensor's (shape,
    dtype, device), or a dict of tensors' sorted ``(key, shape, dtype,
    device)``; anything else raises ``TypeError``."""
    if isinstance(a, Tensor):
        return (tuple(a.shape), a.dtype, a.device)
    if isinstance(a, dict) and all(isinstance(k, str) and isinstance(v, Tensor) for k, v in a.items()):
        return ("dict", tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(a.items())))
    raise TypeError(f"positional argument {i} is a {type(a).__name__}, not a tensor or a dict of tensors")


def _clone_arg(a: Any) -> Any:
    """A program's input buffer for a positional argument (a dict gets one per key)."""
    if isinstance(a, dict):
        return {k: v.detach().clone(memory_format=torch.contiguous_format) for k, v in a.items()}
    return a.detach().clone(memory_format=torch.contiguous_format)


def _copy_arg(buf: Any, a: Any) -> None:
    """Copy a call's positional argument into its program's input buffer."""
    if isinstance(buf, dict):
        for k, v in buf.items():
            v.copy_(a[k])
    else:
        buf.copy_(a)


class FusedCollectionStep:
    """One captured, in-place state transition for a whole Metric or
    MetricCollection (see the module note for how a call runs).

    Args:
        metric: a :class:`~tpumetrics_torch.metric.Metric` or
            :class:`~tpumetrics_torch.collections.MetricCollection`. For a
            collection, establish compute groups first (one eager update or
            ``establish_compute_groups``) so the step covers group leaders
            only.
        leaders: for a collection, restrict the step to these group-leader
            names (default: every group leader). The collection's own fused
            path passes the array-state leaders, so list-state leaders stay
            eager.
        update_kwargs: keyword arguments of every call, fixed for the step's
            lifetime (a tensor among them is read at its address by every
            replay).
        donate: update the state the caller passes in place and return the
            step's buffers (default True; the module's donation contract), or
            return copies.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.classification import MulticlassAccuracy
        >>> from tpumetrics_torch.parallel import FusedCollectionStep
        >>> metric = MulticlassAccuracy(num_classes=3, average="micro", device="cpu")
        >>> step = FusedCollectionStep(metric)
        >>> state = step.init_state()
        >>> for _ in range(3):
        ...     state = step.update(state, torch.tensor([0, 1, 2, 2]), torch.tensor([0, 1, 1, 2]))
        >>> float(metric.functional_compute(state)), step.program_count
        (0.75, 1)
    """

    def __init__(
        self,
        metric: Any,
        *,
        leaders: Optional[List[str]] = None,
        update_kwargs: Optional[Dict[str, Any]] = None,
        donate: bool = True,
    ) -> None:
        from tpumetrics_torch.collections import MetricCollection
        from tpumetrics_torch.metric import Metric

        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(f"Expected Metric or MetricCollection, got {type(metric)}")
        self._metric = metric
        self._is_collection = isinstance(metric, MetricCollection)
        if leaders is not None and not self._is_collection:
            raise ValueError("`leaders` only applies to a MetricCollection")
        if self._is_collection:
            all_leaders = [cg[0] for cg in metric._groups.values()]
            if leaders is None:
                leaders = all_leaders
            else:
                unknown = set(leaders) - set(all_leaders)
                if unknown:
                    raise TPUMetricsUserError(f"Not compute-group leaders of this collection: {sorted(unknown)}")
        self._leaders: Optional[List[str]] = leaders
        self._update_kwargs = dict(update_kwargs or {})
        self._donate = bool(donate)
        self._device = metric.device
        self._buffers: Dict[Path, Tensor] = {}
        self._seen: set = set()
        self._programs: Dict[Hashable, _Program] = {}
        self._pool: Any = None
        #: calls by how they ran: "eager" (a key's first sighting), "captured"
        #: (a capture and its first replay), "replayed", and "unfused" (refused
        #: with UnhashableKwargsError; the caller ran them eagerly)
        self.counts = {"eager": 0, "captured": 0, "replayed": 0, "unfused": 0}
        #: seconds spent in each capture, in order
        self.capture_seconds: List[float] = []

    # ------------------------------------------------------------- properties

    @property
    def leaders(self) -> Optional[List[str]]:
        """Fused group-leader names (None for a single Metric)."""
        return list(self._leaders) if self._leaders is not None else None

    @property
    def donate(self) -> bool:
        return self._donate

    @property
    def program_count(self) -> int:
        """Programs captured so far: CUDA graphs for a CUDA state (one per
        key seen twice), their eager stand-ins for a CPU state."""
        return len(self._programs)

    def kernel_launches(self) -> Dict[str, int]:
        """Kernel launches made by graph replays, by kernel: each program's
        replays times the calls it recorded. Eager calls count in the kernel
        wrapper's own ``launches``."""
        out: Dict[str, int] = {}
        for program in self._programs.values():
            for name, calls in program.kernel_calls.items():
                out[name] = out.get(name, 0) + calls * program.replays
        return out

    # ------------------------------------------------------------ transitions

    def init_state(self) -> Dict[str, Any]:
        """Fresh state covering exactly the fused leaders."""
        if not self._is_collection:
            return self._metric.init_state()
        self._metric._compute_groups_create_state_ref(copy=False)
        return {name: self._metric._modules[name].init_state() for name in self._leaders}

    def _transition(self, state: Dict[str, Any], args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Every fused leader's functional_update, one after another."""
        if not self._is_collection:
            return self._metric.functional_update(state, *args, **kwargs)
        out = {}
        for name in self._leaders:
            m0 = self._metric._modules[name]
            out[name] = m0.functional_update(state[name], *args, **m0._filter_kwargs(**kwargs))
        return out

    def _write_back(self, new_state: Dict[str, Any], resize: bool = False) -> bool:
        """Copy the transition's new state into the step's buffers. With
        ``resize`` (an eager transition), a state whose shape the update
        changed gets a new buffer, as a scalar default broadcast to one entry
        per output by its first update does; returns whether one did. A
        captured transition keeps every state's shape, and no transition
        changes a dtype."""
        resized = False
        for path, val in _leaves(new_state):
            buf = self._buffers[path]
            if val.shape != buf.shape or val.dtype != buf.dtype:
                if not resize or val.dtype != buf.dtype:
                    raise TPUMetricsUserError(
                        f"State {'/'.join(path)} went from {tuple(buf.shape)} {buf.dtype} to {tuple(val.shape)}"
                        f" {val.dtype} in one update: a fused step keeps every state at a fixed shape and dtype."
                    )
                self._buffers[path] = val.detach().clone(memory_format=torch.contiguous_format)
                resized = True
            elif val is not buf:
                buf.copy_(val)
        return resized

    def _key(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Hashable:
        """The program key: the per-call kwargs and each positional argument's
        signature (:func:`_arg_signature`); raises :class:`UnhashableKwargsError`."""
        try:
            if _holds_tensor(kwargs):
                raise TypeError("a tensor in the keyword arguments keys a new graph on every call")
            key = (tuple(sorted(kwargs.items())), tuple(_arg_signature(i, a) for i, a in enumerate(args)))
            hash(key)
        except TypeError as err:
            self.counts["unfused"] += 1
            raise UnhashableKwargsError(
                f"FusedCollectionStep.update needs hashable keyword arguments that hold no tensor, and tensors or"
                f" dicts of tensors as positional arguments; got {sorted(kwargs)}: {err}. Pass per-batch tensors"
                " positionally, or use the unfused update path."
            ) from None
        return key

    def update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """One fused, in-place state transition over a batch.

        Per-call ``kwargs`` merge over the constructor's ``update_kwargs``
        and, with the positional tensors' signatures, key the program:
        :class:`UnhashableKwargsError` for a tensor in them, an unhashable
        value, or a positional argument that is not a tensor (callers then
        run the unfused path). Returns the new state (the step's buffers when
        ``donate``, see the module's donation contract).
        """
        key = self._key(args, kwargs)
        merged = {**self._update_kwargs, **kwargs}
        own, replaced = gather_donatable_state(state, self._buffers)
        if replaced:  # a state changed its shape, dtype or device: every graph read the old buffers
            self._programs.clear()
            self._seen.clear()
        state = _rebuild(state, own)
        program = self._programs.get(key)
        if program is not None:
            self._replay(program, args, state)
            self.counts["replayed"] += 1
        elif key not in self._seen:
            if self._write_back(self._transition(state, args, merged), resize=True):  # the warm-up
                # a state changed its shape: every graph read the old buffers
                self._programs.clear()
                self._seen.clear()
                own = {path: self._buffers[path] for path in own}
                state = _rebuild(state, own)
            self._seen.add(key)
            self.counts["eager"] += 1
        else:
            program = self._capture(key, args, merged, state)
            self._replay(program, (), state)  # the batch is in the input buffers already
            self.counts["captured"] += 1
        if self._donate:
            return state
        return _rebuild(state, {path: buf.clone() for path, buf in own.items()})

    def _capture(self, key: Hashable, args: Tuple[Tensor, ...], kwargs: Dict[str, Any], state: Dict[str, Any]) -> _Program:
        """Build the key's program: input buffers holding this batch, and on a
        CUDA state the graph of the transition and its write-back."""
        static = tuple(_clone_arg(a) for a in args)
        graph = None
        kernel_calls: Dict[str, int] = {}
        if self._device.type == "cuda":
            t0 = time.perf_counter()
            with torch.cuda.device(self._device):
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                before = {name: wrapper.captured for name, wrapper in COUNTED_KERNELS.items()}
                with _gc_paused(), torch.cuda.graph(graph, pool=self._pool):
                    self._write_back(self._transition(state, static, kwargs))
                kernel_calls = {name: wrapper.captured - before[name] for name, wrapper in COUNTED_KERNELS.items()}
            self.capture_seconds.append(time.perf_counter() - t0)
        program = self._programs[key] = _Program(static, graph, kwargs, kernel_calls)
        if len(self._programs) == _PROGRAM_CACHE_WARN:
            rank_zero_warn(
                f"FusedCollectionStep holds {_PROGRAM_CACHE_WARN} programs: every distinct per-call kwargs value and"
                " batch shape captures its own graph, kept for the step's lifetime. A kwarg that varies per batch"
                " belongs in a positional tensor, or on the unfused update path."
            )
        return program

    def _replay(self, program: _Program, args: Tuple[Tensor, ...], state: Dict[str, Any]) -> None:
        for buf, a in zip(program.static_args, args):
            _copy_arg(buf, a)
        if program.graph is not None:
            with torch.cuda.device(self._device):
                program.graph.replay()
        else:
            self._write_back(self._transition(state, program.static_args, program.kwargs))
        program.replays += 1

    def __deepcopy__(self, memo: dict) -> None:
        # graphs and buffers belong to the ORIGINAL metric objects; a
        # deep-copied owner (a cloned collection) builds its own step lazily,
        # so the copy carries no step at all
        return None

    def __reduce__(self) -> tuple:
        return (_no_step, ())


def _no_step() -> None:
    """What a pickled step unpickles to: nothing (its owner builds a new one)."""
    return None


__all__ = ["FusedCollectionStep", "UnhashableKwargsError", "fusable_oo_leaders", "gather_donatable_state"]
