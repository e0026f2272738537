"""MetricCollection (counterpart of ``tpumetrics/collections.py``).

Compute groups work as in the JAX package: the first ``update`` runs every
metric, then metrics whose states came out value-identical are merged into
one group, and later updates run each group's leader only. Members alias
their leader's tensors and are refreshed right before any member access.
An eager update rebinds its states; with ``fused_update=True`` the leaders'
states advance in place (the donation contract of
:mod:`~tpumetrics_torch.parallel.fuse_update`), and the members that alias
them see the new values at once, as their next refresh would give them.

``compute`` syncs the whole collection across ranks in one flush of a
shared :class:`~tpumetrics_torch.parallel.fuse.FusedReducer`: one
``all_reduce`` per (op, dtype) class of the group leaders' reduce states,
plus the gathers of their list states. Members adopt their leader's synced
tensors; every metric unsyncs back to its own states afterwards.
"""

from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Callable, Dict, Hashable, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpumetrics_torch.buffers import _BufferList
from tpumetrics_torch.metric import Metric, _refuse_axis_name, _resolve_device
from tpumetrics_torch.parallel.backend import DistributedBackend, get_default_backend
from tpumetrics_torch.parallel.fuse import FusedReducer
from tpumetrics_torch.telemetry import ledger as _telemetry
from tpumetrics_torch.parallel.fuse_update import (
    FusedCollectionStep,
    UnhashableKwargsError,
    _holds_tensors,
    fusable_oo_leaders,
)
from tpumetrics_torch.utils.data import _flatten_dict
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError
from tpumetrics_torch.utils.prints import rank_zero_warn


class MetricCollection:
    """Dict-like container of metrics updated and computed together.

    Args:
        metrics: a single metric, a sequence of metrics (keyed by class name),
            or a dict name -> metric.
        additional_metrics: more metrics when ``metrics`` is a sequence.
        prefix: string prepended to every output key.
        postfix: string appended to every output key.
        compute_groups: ``True`` (default) to share state between metrics
            whose states are identical after the first update (e.g. accuracy
            and F1, both over tp/fp/tn/fn: only the group leader runs
            ``update``); ``False`` to disable; or an explicit list of lists
            of names.
        fused_update: once compute groups are established, advance every
            tensor-state group leader through one
            :class:`~tpumetrics_torch.parallel.fuse_update.FusedCollectionStep`
            per ``update``: on a card, one CUDA graph replay per batch
            signature, the states updated in place at fixed addresses. The
            first call with a batch signature runs eagerly (the warm-up).
            Leaders with list states, wrappers, and calls with a tensor among
            the keyword arguments (or a positional argument that is not a
            tensor) keep the per-leader eager path. A state tensor read
            before a fused update may change with it (the donation contract).
        device: where every member's states live; ``"cuda"`` (the current
            card) when omitted, which raises ``RuntimeError`` without a card.
            Members are moved there at construction.

    Example:
        >>> import torch
        >>> from tpumetrics_torch import MetricCollection
        >>> from tpumetrics_torch.classification import MulticlassAccuracy, MulticlassF1Score
        >>> target = torch.tensor([0, 2, 0, 2, 0, 1, 0, 2])
        >>> preds = torch.tensor([2, 1, 2, 0, 1, 2, 2, 2])
        >>> metrics = MetricCollection(
        ...     [MulticlassAccuracy(num_classes=3, average='micro', device='cpu'),
        ...      MulticlassF1Score(num_classes=3, average='macro', device='cpu')], device='cpu')
        >>> {k: round(float(v), 4) for k, v in metrics(preds, target).items()}
        {'MulticlassAccuracy': 0.125, 'MulticlassF1Score': 0.0833}
    """

    _modules: "OrderedDict[str, Metric]"
    _groups: Dict[int, List[str]]

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
        fused_update: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self._device = _resolve_device(device)
        self._modules = OrderedDict()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked: bool = False
        self._state_is_copy: bool = False
        self._fused_update = bool(fused_update)
        self._fused_oo_step: Optional[Any] = None  # built lazily per group layout

        self.add_metrics(metrics, *additional_metrics)

    # ---------------------------------------------------------------- updates

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call ``forward`` on every metric; kwargs are routed per signature.
        No compute-group fast path: forward's batch values need every metric."""
        return self._compute_and_reduce("forward", *args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every metric or, once compute groups are established, only
        each group's leader. With ``fused_update=True`` the tensor-state
        leaders advance through one fused step instead of one update each."""
        if self._groups_checked:
            fused = self._fused_oo_update(args, kwargs) if self._fused_update else frozenset()
            for cg in self._groups.values():
                if cg[0] in fused:
                    continue
                m0 = self._modules[cg[0]]
                m0.update(*args, **m0._filter_kwargs(**kwargs))
            # leaders advanced: members are stale until the next propagation
            self._state_is_copy = False
        else:
            # first update runs per metric so there are states to compare
            for m in self._modules.values():
                m.update(*args, **m._filter_kwargs(**kwargs))
            if self._enable_compute_groups:
                self._groups = self._merged_groups(self._groups, self._modules)
                self._state_is_copy = True  # members just updated themselves
            else:
                self._state_is_copy = False
            self._groups_checked = True

    def _fused_oo_update(self, args: tuple, kwargs: Dict[str, Any]) -> frozenset:
        """Advance every fusable group leader through the fused step; returns
        the leader names covered (the caller runs the rest eagerly: list-state
        leaders, or every leader when the call's arguments cannot key a
        graph). The leaders' attribute states go in, the step's buffers come
        back as their states, and the eager update wrapper's side effects
        (cache invalidation, update counter) are applied by hand."""
        step = self._fused_oo_step
        if step is not None and not all(
            _holds_tensors(self._modules[n], a) for n in step.leaders for a in self._modules[n]._defaults
        ):
            step = self._fused_oo_step = None  # a reset put a list back in a buffer state: leaders change
        if step is None:
            leaders = fusable_oo_leaders(self)
            if not leaders:
                return frozenset()
            step = self._fused_oo_step = FusedCollectionStep(self, leaders=leaders, donate=True)
        leaders = step.leaders
        modules = [self._modules[name] for name in leaders]
        if any(m._is_synced for m in modules):
            raise TPUMetricsUserError(
                "A fused update of a synced metric would copy the synced states into the local ones that"
                " ``unsync`` restores; call ``unsync`` before updating."
            )
        state = {name: m._copy_state_dict() for name, m in zip(leaders, modules)}
        try:
            new_state = step.update(state, *args, **kwargs)
        except UnhashableKwargsError:
            return frozenset()  # tensor kwargs: this call runs fully eager
        for name, m0 in zip(leaders, modules):
            m0._set_states(new_state[name])
            m0._computed = None
            m0._update_count += 1
        return frozenset(leaders)

    @classmethod
    def _merged_groups(
        cls, groups: Dict[int, List[str]], modules: "OrderedDict[str, Metric]"
    ) -> Dict[int, List[str]]:
        """Merge groups whose leaders hold value-identical states: O(n²)
        pairwise comparisons on the host, after ONE device-to-host copy of
        every leader's states."""
        groups = {k: list(v) for k, v in groups.items()}
        host_states = cls._leader_host_states(groups, modules)
        num_groups = len(groups)
        while True:
            for cg_idx1, cg_members1 in list(groups.items()):
                merged = False
                for cg_idx2, cg_members2 in list(groups.items()):
                    if cg_idx1 == cg_idx2 or cg_idx1 not in groups or cg_idx2 not in groups:
                        continue
                    if cls._equal_host_states(host_states[cg_members1[0]], host_states[cg_members2[0]]):
                        groups[cg_idx1].extend(groups.pop(cg_idx2))
                        merged = True
                        break
                if merged:
                    break
            if len(groups) == num_groups:
                break
            num_groups = len(groups)
        return dict(enumerate(groups.values()))

    @staticmethod
    def _leader_host_states(
        groups: Dict[int, List[str]], modules: "OrderedDict[str, Metric]"
    ) -> Dict[str, Dict[str, tuple]]:
        """Every group leader's states on the host, ``{leader: {attr: (type,
        kind, value)}}`` with kind ``"tensor"`` / ``"list"`` (a MaskedBuffer
        state is a list of its three fields). The tensors are
        packed as raw bytes into one buffer on the device, copied to the host
        once, and unpacked into numpy arrays of their own dtypes."""
        flat: List[torch.Tensor] = []
        layout: Dict[str, Dict[str, tuple]] = {}
        for cg in groups.values():
            m = modules[cg[0]]
            entry: Dict[str, tuple] = {}
            for attr in m._defaults:
                val = getattr(m, attr)
                if isinstance(val, _BufferList):  # compared field by field, as a list of three
                    fields = list(val.buffer)
                    entry[attr] = (type(val), "list", list(range(len(flat), len(flat) + len(fields))))
                    flat.extend(fields)
                elif isinstance(val, list):
                    entry[attr] = (type(val), "list", list(range(len(flat), len(flat) + len(val))))
                    flat.extend(val)
                else:
                    entry[attr] = (type(val), "tensor", len(flat))
                    flat.append(val)
            layout[cg[0]] = entry
        fetched: List[np.ndarray] = []
        if flat:
            raw = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in flat]
            host = torch.cat([r.to(flat[0].device) for r in raw]).cpu().numpy()
            offset = 0
            for t, r in zip(flat, raw):
                dtype = torch.empty((), dtype=t.dtype).numpy().dtype
                fetched.append(host[offset : offset + r.numel()].view(dtype).reshape(tuple(t.shape)))
                offset += r.numel()
        out: Dict[str, Dict[str, tuple]] = {}
        for name, entry in layout.items():
            out[name] = {
                attr: (orig_type, kind, [fetched[i] for i in slot] if kind == "list" else fetched[slot])
                for attr, (orig_type, kind, slot) in entry.items()
            }
        return out

    @staticmethod
    def _equal_host_states(state1: Dict[str, tuple], state2: Dict[str, tuple]) -> bool:
        """Host-side value equality of two leaders' states: same keys, types
        and shapes, values ``allclose`` after casting to the first's dtype."""

        def _close(a1: np.ndarray, a2: np.ndarray) -> bool:
            if a1.dtype != a2.dtype:
                a2 = a2.astype(a1.dtype)
            return bool(np.allclose(a1, a2, rtol=1e-5, atol=1e-8))

        if len(state1) == 0 or len(state2) == 0 or state1.keys() != state2.keys():
            return False
        for key in state1:
            type1, kind, val1 = state1[key]
            type2, _, val2 = state2[key]
            if type1 is not type2:
                return False
            if kind == "tensor":
                if val1.shape != val2.shape or not _close(val1, val2):
                    return False
            elif len(val1) != len(val2) or not all(
                s1.shape == s2.shape and _close(s1, s2) for s1, s2 in zip(val1, val2)
            ):
                return False
        return True

    def _compute_groups_create_state_ref(self, copy: bool = False) -> None:
        """Point every group member's states at its leader's tensors."""
        if not self._state_is_copy:
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                for name in cg[1:]:
                    mi = self._modules[name]
                    self._alias_leader_states(m0, mi)
                    mi._update_count = m0._update_count
                    mi._computed = None
        self._state_is_copy = copy

    @staticmethod
    def _alias_leader_states(m0: Metric, mi: Metric) -> None:
        """Point every state of ``mi`` at ``m0``'s tensors (lists are
        shallow-copied, so member appends never touch the leader's)."""
        mi._set_states(m0._copy_state_dict())

    # ---------------------------------------------------------------- results

    def compute(self) -> Dict[str, Any]:
        """Compute every metric into one flat dict."""
        return self._compute_and_reduce("compute")

    def _compute_and_reduce(self, method_name: str, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        if method_name == "compute":
            self._compute_groups_create_state_ref(copy=False)
            with self._fused_eager_sync():
                result = {k: m.compute() for k, m in self._modules.items()}
        elif method_name == "forward":
            result = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self._modules.items()}
            self._state_is_copy = False  # every metric advanced its own state
        else:
            raise ValueError(f"method_name should be either 'compute' or 'forward', but got {method_name}")
        return self._flatten_results(result)

    @contextmanager
    def _fused_eager_sync(self) -> Iterator[None]:
        """Sync every metric due to sync with ONE shared FusedReducer flush.

        Without it a K-metric collection pays K sync rounds at ``compute()``.
        Only each compute group's LEADER registers with the reducer (members
        alias the leader's tensors; adding them would multiply the payload by
        the group's size); members then adopt the leader's synced tensors,
        keeping their own states to unsync to. Each synced metric's
        ``_to_sync`` is parked so its own compute neither syncs again nor
        raises; its compute wrapper unsyncs it on exit. Metrics with their
        own ``sync_backend``, ``process_group`` or ``dist_sync_fn`` sync on
        their own path. Every rank must enter with the same metrics due to
        sync, as the collectives of all ranks must match.

        An error in a collective propagates, and every metric synced so far
        is restored to its local states first.
        """

        def _eligible(m: Metric) -> bool:
            return (
                m._to_sync
                and not m._is_synced
                and m._computed is None
                and m.sync_backend is None
                and m.dist_sync_fn is None
                and m.process_group is None
            )

        leaders: List[Tuple[str, Metric, List[Metric]]] = []
        for cg in self._groups.values():
            m0 = self._modules[cg[0]]
            if _eligible(m0):
                leaders.append((cg[0], m0, [self._modules[k] for k in cg[1:] if _eligible(self._modules[k])]))
        parked: List[Metric] = []
        try:
            if leaders:
                reducer = FusedReducer(get_default_backend())
                finalizers: List[Callable[[], None]] = []
                synced: List[Tuple[Metric, List[Metric]]] = []
                for key, m0, members in leaders:
                    with _telemetry.attribution(key):  # the ledger's tag: "<key>/<MetricClass>"
                        fin = m0.sync(_reducer=reducer)
                    if m0._is_synced:
                        parked.append(m0)
                        m0._to_sync = False
                        synced.append((m0, members))
                    if fin is not None:
                        finalizers.append(fin)
                if finalizers:
                    reducer.flush()
                    for fin in finalizers:
                        fin()
                for m0, members in synced:
                    for mi in members:
                        mi._cache = mi._copy_state_dict()
                        self._alias_leader_states(m0, mi)
                        mi._is_synced = True
                        mi._to_sync = False
                        parked.append(mi)
            yield
        finally:
            for m in parked:
                m._to_sync = True
                if m._is_synced:  # its compute never ran (an error): restore
                    m.unsync()

    def _flatten_results(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """Flatten dict-valued results (colliding inner keys get the metric
        name) and apply prefix/postfix."""
        _, duplicates = _flatten_dict(result)
        flattened_results: Dict[str, Any] = {}
        for k, res in result.items():
            if isinstance(res, dict):
                for key, v in res.items():
                    flattened_results[f"{k}_{key}" if duplicates else key] = v
            else:
                flattened_results[k] = res
        return {self._set_name(k): v for k, v in flattened_results.items()}

    def reset(self) -> None:
        """Reset every metric."""
        for m in self._modules.values():
            m.reset()
        self._state_is_copy = True  # all states are (equal) defaults again

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Add metrics from a metric, a sequence or a dict (sorted by name),
        moving each onto the collection's device."""
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence) and not isinstance(metrics, str):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passed extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passed extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            named = [(name, metrics[name]) for name in sorted(metrics.keys())]
        elif isinstance(metrics, Sequence):
            named = [(m.__class__.__name__, m) for m in metrics]
        else:
            raise ValueError(
                "Unknown input to MetricCollection. Expected, `Metric` or `dict`/`sequence` of the"
                f" previous, but got {metrics}"
            )
        for name, metric in named:
            if not isinstance(metric, Metric):
                raise ValueError(f"Value {metric} belonging to key {name} is not an instance of `Metric`")
            if name in self._modules:
                raise ValueError(f"Encountered two metrics both named {name}")
            self._modules[name] = metric.to(self._device) if metric.device != self._device else metric

        self._groups_checked = False
        self._fused_oo_step = None  # the group layout changes
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(self._enable_compute_groups))
            for group in self._groups.values():
                for name in group:
                    if name not in self._modules:
                        raise ValueError(
                            f"Input {name} in `compute_groups` argument does not match a metric in the"
                            f" collection. Please make sure that {self._enable_compute_groups} matches"
                            f" {list(self._modules)}"
                        )
            self._groups_checked = True
        else:
            self._groups = {i: [str(k)] for i, k in enumerate(self._modules)}

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        """Current compute groups."""
        return self._groups

    @property
    def device(self) -> torch.device:
        return self._device

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _to_renamed_dict(self) -> "OrderedDict[str, Metric]":
        return OrderedDict((self._set_name(k), v) for k, v in self._modules.items())

    def __iter__(self) -> Iterator[Hashable]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._modules)

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def keys(self, keep_base: bool = False) -> Iterable[Hashable]:
        if keep_base:
            return self._modules.keys()
        return self._to_renamed_dict().keys()

    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        """Key/metric pairs; group state is propagated to members first."""
        self._compute_groups_create_state_ref(copy_state)
        if keep_base:
            return self._modules.items()
        return self._to_renamed_dict().items()

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        self._compute_groups_create_state_ref(copy_state)
        return self._modules.values()

    def __getitem__(self, key: str) -> Metric:
        self._compute_groups_create_state_ref(copy=True)
        return self._modules[key]

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "(\n  "
        repr_str += ",\n  ".join(f"{k}: {v!r}" for k, v in self._modules.items())
        if self.prefix:
            repr_str += f",\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f",\n  postfix={self.postfix}"
        return repr_str + "\n)"

    # ------------------------------------------------------ functional bridge

    def establish_compute_groups(self, *args: Any, **kwargs: Any) -> None:
        """Discover compute groups from one throwaway eager update on example
        inputs, without touching accumulated state.

        The eager path discovers groups on its first ``update``; the
        functional path (and a fused step built before any update) never
        updates eagerly, so call this once with a representative batch
        first. The probe updates deep copies, never the metrics themselves.
        """
        if self._groups_checked:
            return
        import copy

        probes = {name: copy.deepcopy(m) for name, m in self._modules.items()}
        for m in probes.values():
            m.update(*args, **m._filter_kwargs(**kwargs))
        if self._enable_compute_groups:
            self._groups = self._merged_groups(self._groups, probes)
        self._groups_checked = True
        self._state_is_copy = False

    def init_state(self) -> Dict[str, Dict[str, Any]]:
        """Fresh per-leader state dicts (name -> state dict): one per compute
        group. Groups are established by the first eager ``update`` or by an
        explicit ``compute_groups`` list; otherwise every metric is its own
        group."""
        self._compute_groups_create_state_ref(copy=False)
        return {cg[0]: self._modules[cg[0]].init_state() for cg in self._groups.values()}

    def functional_update(
        self, state: Dict[str, Dict[str, Any]], *args: Any, **kwargs: Any
    ) -> Dict[str, Dict[str, Any]]:
        """Pure collection update: one update per compute-group leader."""
        out = {}
        for cg in self._groups.values():
            m0 = self._modules[cg[0]]
            out[cg[0]] = m0.functional_update(state[cg[0]], *args, **m0._filter_kwargs(**kwargs))
        return out

    def functional_compute(
        self,
        state: Dict[str, Dict[str, Any]],
        axis_name: Optional[str] = None,
        backend: Optional[DistributedBackend] = None,
    ) -> Dict[str, Any]:
        """Pure collection compute: each member computes from its leader's
        state, synced first through ``backend`` when one is given (one
        collective per (op, dtype) class for the whole collection).
        ``axis_name`` has no torch counterpart and raises."""
        _refuse_axis_name(axis_name)
        synced = self.sync_states(state, backend) if backend is not None else state
        results: Dict[str, Any] = {}
        for cg in self._groups.values():
            for name in cg:
                results[name] = self._modules[name].functional_compute(synced[cg[0]])
        return self._flatten_results(results)

    def sync_states(self, state: Dict[str, Dict[str, Any]], backend: DistributedBackend) -> Dict[str, Dict[str, Any]]:
        """Pure cross-rank merge of every group leader's state with one fused
        flush (one collective per (op, dtype) class)."""
        reducer = FusedReducer(backend)
        finalize = self._sync_state_collect(state, backend, reducer)
        reducer.flush()
        return finalize()

    def _sync_state_collect(
        self, state: Dict[str, Dict[str, Any]], backend: DistributedBackend, reducer: FusedReducer, group: Any = None
    ) -> Callable[[], Dict[str, Dict[str, Any]]]:
        """First phase of a shared fused sync, shaped like the collection's
        state (the closure protocol of ``Metric._sync_state_collect``). Each
        leader's collectives carry its collection key as their ledger tag."""
        finalizers = {}
        for cg in self._groups.values():
            with _telemetry.attribution(cg[0]):
                finalizers[cg[0]] = self._modules[cg[0]]._sync_state_collect(state[cg[0]], backend, reducer, group)
        return lambda: {name: fin() for name, fin in finalizers.items()}
