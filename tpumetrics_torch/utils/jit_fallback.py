"""A user callable run as one CUDA graph per input signature, with a one-time
eager fallback (counterpart of ``tpumetrics/utils/jit_fallback.py``, which
wraps ``jax.jit``).

The metrics that run a backbone (FID's extractor plus its moments, LPIPS's
backbone plus its sums) capture their whole update as a graph: a replay
relaunches every kernel with no Python in between, as one jitted dispatch
does in the JAX package. On a card a signature's first call runs eagerly
(the warm-up: cuDNN's plans, the allocator's blocks), its second call
captures the graph and replays it, and later calls copy their tensors into
the graph's input buffers and replay it. On the CPU the callable runs
eagerly every call, and under an outer capture it runs inline, so the outer
graph records it.

A callable that cannot be captured (one that reads the device on the host,
copies from pageable memory, or syncs) fails its capture. The wrapper then
runs it eagerly, and only after that eager run succeeds does it latch eager
mode for every later call and warn once: a genuine data error raises in the
eager run too and propagates, so a transient failure never downgrades the
wrapper.

A graph reads the addresses its capture saw: the inputs' buffers, which the
wrapper owns (or, with ``own_inputs=False``, the caller's own buffers, as the
backbone engine's staging buffers are), and whatever the callable closes
over (a backbone's weights). ``key_fn``, when given, returns a token of that
closure's state (the weights' placement); when it changes, every graph is
dropped.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Hashable, Iterator, Optional, Tuple

import torch

from tpumetrics_torch.utils.checks import _gc_paused, _is_capturing

Tensor = torch.Tensor


# one graph memory pool per card, shared by every graph the backbone metrics capture (their updates' and the
# backbone engines' buckets'): their captures run one at a time and their replays in one stream, and each replay's outputs
# are copied out before anything else runs, so a graph may reuse what another freed. Nothing a caller keeps lives
# in the pool: input buffers, staging buffers and states are allocated outside any capture. The captures run on
# one side stream per card, where a pure forward also warms up first (cuDNN binds some of its plans to the
# stream they first ran on: a plan first run on the caller's stream once failed its capture with
# CUDNN_STATUS_BAD_PARAM_STREAM_MISMATCH).
_POOLS: Dict[int, Any] = {}
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
# one graph a pool that lives as long as the pool is used. The caching allocator counts a pool's graphs and
# marks it freeable when the count falls to 0; a block of it still alive then keeps it registered at count 0,
# and the next capture into it fails an internal assert (`use_count > 0`, CUDACachingAllocator.cpp). That
# happened when a BERTScore engine captured after the generative phase had released every graph of the pool.
_KEEPERS: Dict[int, "torch.cuda.CUDAGraph"] = {}


def _new_pool(index: int, stream: "torch.cuda.Stream") -> Any:
    """A fresh pool for card ``index``, held by a one-kernel keeper graph captured into it."""
    pool = torch.cuda.graph_pool_handle()
    keeper = torch.cuda.CUDAGraph()
    with torch.cuda.graph(keeper, pool=pool, stream=stream):
        torch.zeros(1, device=torch.device("cuda", index))
    _KEEPERS[index] = keeper
    return pool


@contextmanager
def _capture_in_pool(
    graph: "torch.cuda.CUDAGraph", device: torch.device, warm_up: Optional[Callable[[], Any]] = None
) -> Iterator[None]:
    """Capture into ``graph`` on the card's capture stream from its shared pool, after ``warm_up`` (a pure
    function, its result dropped) has run once on that stream. A capture that fails (an operation that reads the
    host invalidates it) can leave its pool marked as recording, and no later capture could use it: the card then
    gets a new pool (the old one's blocks stay with it)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    stream, caller = _STREAMS[index], torch.cuda.current_stream(index)
    if index not in _POOLS:
        _POOLS[index] = _new_pool(index, stream)
    if warm_up is not None:
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            warm_up()
        caller.wait_stream(stream)
    try:
        with _gc_paused(), torch.cuda.graph(graph, pool=_POOLS[index], stream=stream):
            yield
    except Exception:
        del _POOLS[index]  # the next capture starts a new pool
        raise


def _tree_map(fn: Callable[[Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


class _Graph:
    """One captured signature: its input buffers, the graph and its outputs."""

    def __init__(self, static_args: Tuple[Any, ...], graph: "torch.cuda.CUDAGraph", out: Any) -> None:
        self.static_args = static_args
        self.graph = graph
        self.out = out
        self.replays = 0

    def replay(self, args: Tuple[Any, ...], device: torch.device) -> Any:
        for buf, a in zip(self.static_args, args):
            if isinstance(buf, Tensor) and buf is not a:
                buf.copy_(a)
        with torch.cuda.device(device):
            self.graph.replay()
        self.replays += 1
        # the next replay overwrites the graph's outputs: the caller gets its own copies
        return _tree_map(torch.clone, self.out)


class JitWithEagerFallback:
    """Callable wrapping ``fn`` in one CUDA graph per input signature, with a
    one-time eager fallback.

    The signature is each tensor argument's (shape, dtype, device) and each
    other argument's value. ``counts`` says how the calls ran: ``eager``
    (the CPU, a first sighting, an outer capture, eager mode), ``captured``
    and ``replayed``. Not picklable (it holds graphs); owners drop it in
    ``__getstate__`` and rebuild it lazily.

    ``own_inputs=False``: the tensor arguments are the caller's buffers, at
    the same addresses every call of a signature; the graph reads them
    where they are (a call with other tensors copies them in). ``pure=True``:
    ``fn`` has no side effects, so before a capture it runs once on the
    capture stream (cuDNN binds some plans to the stream they first ran on).
    """

    def __init__(
        self,
        fn: Callable,
        what: str,
        key_fn: Optional[Callable[[], Hashable]] = None,
        *,
        own_inputs: bool = True,
        pure: bool = False,
    ) -> None:
        self._fn = fn
        self._what = what
        self._key_fn = key_fn
        self._own_inputs = own_inputs
        self._pure = pure
        self._token: Hashable = None
        self.eager_mode = False
        self._graphs: Dict[Hashable, _Graph] = {}
        self._seen: set = set()
        self.counts = {"eager": 0, "captured": 0, "replayed": 0}

    def _device(self, args: Tuple[Any, ...]) -> Optional[torch.device]:
        """The card the tensor arguments live on, or None (the CPU, no tensor, several devices)."""
        devices = {a.device for a in args if isinstance(a, Tensor)}
        if len(devices) != 1:
            return None
        (device,) = devices
        return device if device.type == "cuda" else None

    def _eager(self, args: Tuple[Any, ...]) -> Any:
        self.counts["eager"] += 1
        return self._fn(*args)

    def __call__(self, *args: Any) -> Any:
        device = self._device(args)
        if self.eager_mode or device is None or _is_capturing():
            return self._eager(args)
        token = self._key_fn() if self._key_fn is not None else None
        if token != self._token:  # the closure's state moved: every graph read the old one
            self._graphs.clear()
            self._seen.clear()
            self._token = token
        key = tuple((tuple(a.shape), a.dtype, a.device) if isinstance(a, Tensor) else a for a in args)
        try:
            hash(key)
        except TypeError:  # an unhashable argument cannot key a graph
            return self._eager(args)
        graph = self._graphs.get(key)
        if graph is not None:
            self.counts["replayed"] += 1
            return graph.replay(args, device)
        if key not in self._seen:  # the warm-up
            out = self._eager(args)
            self._seen.add(key)
            return out
        try:
            graph = self._capture(args, device)
        except Exception as err:
            # broad on purpose: a user callable that reads the host fails its
            # capture with whatever its operation raises. The eager re-run
            # below keeps this safe: a genuine data error raises there too and
            # propagates, and the latch flips only after an eager SUCCESS.
            out = self._eager(args)
            self.eager_mode = True
            self._graphs.clear()
            from tpumetrics_torch.utils.prints import rank_zero_warn

            reason = str(err).strip().splitlines()[0][:200] if str(err).strip() else ""
            rank_zero_warn(
                f"{self._what} cannot be captured in a CUDA graph ({type(err).__name__}: {reason}); falling back"
                " to eager evaluation for all further calls."
            )
            return out
        self._graphs[key] = graph
        self.counts["captured"] += 1
        return graph.replay((), device)  # the batch is in the input buffers already

    def _capture(self, args: Tuple[Any, ...], device: torch.device) -> _Graph:
        own = self._own_inputs
        static = tuple(a.detach().clone(memory_format=torch.contiguous_format) if own and isinstance(a, Tensor) else a
                       for a in args)
        with torch.cuda.device(device):
            # a capture allocates from its own pool and cannot reclaim the blocks the caching allocator keeps
            # for eager work (freeing is not allowed while a stream captures): hand those back first
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            with _capture_in_pool(graph, device, warm_up=(lambda: self._fn(*static)) if self._pure else None):
                out = self._fn(*static)
        return _Graph(static, graph, out)


__all__ = ["JitWithEagerFallback"]
