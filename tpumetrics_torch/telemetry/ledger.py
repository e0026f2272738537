"""The collective ledger — process-local accounting of every wire op
(counterpart of ``tpumetrics/telemetry/ledger.py``, the same code: it is
pure Python, so the port keeps its own copy).

The sync machinery (``tpumetrics_torch/parallel/backend.py`` collectives,
``tpumetrics_torch/parallel/fuse.py`` fused flushes,
``tpumetrics_torch/buffers.py`` buffer gathers) reports each collective it
issues here: op class, dtype, element count, payload/wire bytes, backend
class, and an attribution tag naming the metric (class name) or collection
member (key) the traffic belongs to.  ``bench.py`` and tests read the
aggregate counters instead of hand-deriving wire bytes analytically.

Design rules (load-bearing):

- **Metadata only.** Records carry ``shape``/``dtype``/``numel`` of a
  tensor, never its values, so recording never reads the device.  The
  recorded ``dtype`` is the JAX package's name for the same state
  (``"int32"``, ``"float32"``), so the records of the two packages compare.
- **Near-zero cost when disabled.** Every report funnels through
  :func:`record_collective`/:func:`record_flush`, whose first statement is a
  module-flag check; with telemetry off the instrumentation is one function
  call + one bool test per collective (collectives themselves cost ~µs-ms).

Wire-byte model (per-device traffic, ring algorithms):

- ``all_reduce`` of ``payload`` bytes over ``N`` ranks moves
  ``2*(N-1)/N * payload`` bytes per device (reduce-scatter + all-gather).
- ``all_gather`` of a ``payload``-byte local shard receives ``(N-1)*payload``
  bytes per device (its own shard does not travel).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "CollectiveRecord",
    "CollectiveLedger",
    "attribution",
    "capture",
    "current_tag",
    "disable",
    "enable",
    "enabled",
    "get_ledger",
    "gather_wire_bytes",
    "record_collective",
    "record_event",
    "record_flush",
    "recording",
    "reduce_wire_bytes",
    "reset",
    "summary",
]


def reduce_wire_bytes(payload_bytes: int, world_size: int) -> float:
    """Per-device wire bytes of a ring all_reduce."""
    if world_size <= 1:
        return 0.0
    return 2.0 * (world_size - 1) / world_size * payload_bytes


def gather_wire_bytes(payload_bytes: int, world_size: int) -> float:
    """Per-device wire bytes of a ring all_gather (local shard stays put)."""
    if world_size <= 1:
        return 0.0
    return float(world_size - 1) * payload_bytes


@dataclass(frozen=True)
class CollectiveRecord:
    """One wire op (or ledger event) as seen by the instrumentation.

    ``source`` separates the two reporting layers so aggregation never double
    counts: ``"backend"`` records are actual wire calls
    (``DistributedBackend.all_gather``/``all_reduce``); ``"reducer"`` records
    are the logical per-(op, dtype) classes a :class:`FusedReducer` flush
    hands to the backend (useful for attribution even under a custom,
    uninstrumented backend); ``"spmd"`` records are the GSPMD-inserted
    in-trace collectives of a sharded step, recorded at trace time with
    ``extra["static"]=True`` (once per compile, no per-step host cost);
    ``"event"`` records are bookkeeping marks (flushes, lockstep
    fingerprints) that carry no payload.
    """

    kind: str  # "all_gather" | "all_reduce" | "fused_class" | "flush" | "lockstep" | ...
    op: str  # "sum"/"mean"/"max"/"min" for reduces, "gather"/"object" otherwise
    dtype: str
    shape: Tuple[int, ...]
    element_count: int
    payload_bytes: int
    wire_bytes: float  # per-device traffic under the ring model (0.0 for world 1)
    backend: str  # backend class name
    tag: str  # attribution path, e.g. "acc/MulticlassAccuracy"
    world_size: int
    in_trace: bool
    source: str = "backend"  # "backend" | "reducer" | "spmd" | "event"
    extra: Dict[str, Any] = field(default_factory=dict)
    #: monotonic + wall clock PAIR stamped when the record was made.  The
    #: monotonic clock orders records exactly within one process; the wall
    #: anchor lets the JAX package's ``telemetry.timeline`` align per-rank JSONL
    #: streams from DIFFERENT processes onto one global axis.  Trace-safe:
    #: a record made at trace time stamps the trace instant (once per
    #: compile), never forcing a host sync.
    mono_ns: int = 0
    wall_ns: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "mono_ns": self.mono_ns,
            "wall_ns": self.wall_ns,
            "op": self.op,
            "dtype": self.dtype,
            "shape": list(self.shape),
            "element_count": self.element_count,
            "payload_bytes": self.payload_bytes,
            "wire_bytes": self.wire_bytes,
            "backend": self.backend,
            "tag": self.tag,
            "world_size": self.world_size,
            "in_trace": self.in_trace,
            "source": self.source,
            **({"extra": dict(self.extra)} if self.extra else {}),
        }


class CollectiveLedger:
    """Accumulates :class:`CollectiveRecord`s with cheap aggregate counters."""

    def __init__(self, sinks: Sequence[Any] = ()) -> None:
        self._sinks: List[Any] = list(sinks)
        self.reset()

    # ------------------------------------------------------------- recording

    def record(self, rec: CollectiveRecord) -> None:
        self.records.append(rec)
        if rec.source == "backend":
            self.collectives_issued += 1
            self.wire_bytes_total += rec.wire_bytes
            self.payload_bytes_total += rec.payload_bytes
            self.bytes_by_op[rec.op] = self.bytes_by_op.get(rec.op, 0.0) + rec.wire_bytes
        elif rec.source == "spmd":
            # GSPMD-inserted in-trace collectives of a sharded step, recorded
            # at trace time (static metadata, once per compile) — kept apart
            # from eager wire accounting so neither pollutes the other
            self.spmd_collectives += 1
            self.spmd_wire_bytes += rec.wire_bytes
        elif rec.kind == "flush":
            self.flush_count += 1
            self.fused_entries += int(rec.extra.get("entries", 0))
        elif rec.kind == "lockstep":
            self.lockstep_fingerprints += 1
        elif rec.kind == "runtime_drop":
            # the streaming runtime's drop-oldest evictions (dispatch.py)
            self.runtime_drops += 1
        elif rec.kind == "runtime_drain":
            # one worker drain cycle: micro-batch size + queue depth after
            self.runtime_drain_cycles += 1
            self.runtime_items_drained += int(rec.extra.get("items", 0))
            self.runtime_max_depth = max(self.runtime_max_depth, int(rec.extra.get("depth", 0)))
        elif rec.kind == "sync_timeout":
            # a guarded eager collective missed its SyncPolicy deadline
            self.sync_timeouts += 1
        elif rec.kind == "sync_retry":
            # one backoff-retry of a transiently-failing collective
            self.sync_retries += 1
        elif rec.kind == "sync_failed":
            # retries exhausted: the typed SyncFailedError surfaced
            self.sync_failures += 1
        elif rec.kind == "degraded_compute":
            # a compute served unsynced-local or last-good state
            self.degraded_computes += 1
        elif rec.kind == "fault_injected":
            # a FaultInjectionBackend fired one scheduled fault
            self.faults_injected += 1
        elif rec.kind == "non_finite_state":
            # guard_non_finite caught NaN/Inf before the wire (or a snapshot)
            self.non_finite_states += 1
        elif rec.kind == "runtime_crash":
            # the streaming runtime's worker died applying a batch
            self.runtime_crashes += 1
        elif rec.kind == "runtime_restore":
            # crash policy restored from a snapshot and replayed the journal
            self.runtime_restores += 1
        elif rec.kind == "elastic_barrier":
            # one coordinated snapshot barrier (step agreement + cut stamp)
            self.elastic_barriers += 1
        elif rec.kind == "elastic_restore":
            # one rank adopted a folded + resharded consistent cut
            self.elastic_restores += 1
        elif rec.kind == "elastic_degraded":
            # a quorum policy admitted an INCOMPLETE cut (missing ranks' data
            # is absent from the fold) — never silent
            self.elastic_degraded_cuts += 1
        elif rec.kind == "megabatch_step":
            # the service drove K tenants' same-signature updates through
            # ONE vmapped device program (extra["tenants"] = K)
            self.megabatch_steps += 1
            self.megabatch_tenants += int(rec.extra.get("tenants", 0))
        elif rec.kind == "tenant_quarantined":
            # one tenant's crash was fenced off; the service kept serving
            self.tenant_quarantines += 1
        elif rec.kind == "xla_compile":
            # one attributed backend compile (telemetry/xla.py): the event
            # carries tenant + seconds; the per-tenant histogram has the rest
            self.xla_attributed_compiles += 1
        elif rec.kind == "xla_retrace":
            # a previously-seen (token, signature) compiled AGAIN — the jit
            # executable cache should have served it (retrace detector)
            self.xla_retraces += 1
        elif rec.kind == "drift_alert":
            # a drift monitor's score crossed its threshold upward
            # (hysteresis-latched: one event per crossing, not per compute)
            self.drift_alerts += 1
        elif rec.kind == "state_health":
            # an armed health probe surfaced NaN/inf/saturation in a stream's
            # metric state (one event per stream+state on FIRST corruption —
            # before the compute-time non-finite guard would trip)
            self.state_health_events += 1
        elif rec.kind == "slo_violation":
            # an SLO rule's burn rate crossed its fast/slow threshold
            # (hysteresis-latched: one event per crossing — telemetry/slo.py)
            self.slo_violations += 1
        self.counts_by_kind[rec.kind] = self.counts_by_kind.get(rec.kind, 0) + 1
        for sink in self._sinks:
            sink.emit(rec)

    def reset(self) -> None:
        self.records: List[CollectiveRecord] = []
        self.collectives_issued = 0
        self.wire_bytes_total = 0.0
        self.payload_bytes_total = 0
        self.flush_count = 0
        self.fused_entries = 0
        self.lockstep_fingerprints = 0
        self.runtime_drops = 0
        self.runtime_drain_cycles = 0
        self.runtime_items_drained = 0
        self.runtime_max_depth = 0
        self.sync_timeouts = 0
        self.sync_retries = 0
        self.sync_failures = 0
        self.degraded_computes = 0
        self.faults_injected = 0
        self.non_finite_states = 0
        self.runtime_crashes = 0
        self.runtime_restores = 0
        self.elastic_barriers = 0
        self.elastic_restores = 0
        self.elastic_degraded_cuts = 0
        self.megabatch_steps = 0
        self.megabatch_tenants = 0
        self.tenant_quarantines = 0
        self.xla_attributed_compiles = 0
        self.xla_retraces = 0
        self.drift_alerts = 0
        self.state_health_events = 0
        self.slo_violations = 0
        self.spmd_collectives = 0
        self.spmd_wire_bytes = 0.0
        self.bytes_by_op: Dict[str, float] = {}
        self.counts_by_kind: Dict[str, int] = {}

    # ----------------------------------------------------------------- sinks

    def add_sink(self, sink: Any) -> None:
        self._sinks.append(sink)

    def remove_sink(self, sink: Any) -> None:
        self._sinks.remove(sink)

    # --------------------------------------------------------------- reading

    def summary(self) -> Dict[str, Any]:
        """Aggregate view (the dict ``bench.py`` consumes)."""
        return {
            "collectives_issued": self.collectives_issued,
            "wire_bytes_total": self.wire_bytes_total,
            "payload_bytes_total": self.payload_bytes_total,
            "bytes_by_op": dict(self.bytes_by_op),
            "counts_by_kind": dict(self.counts_by_kind),
            "flush_count": self.flush_count,
            "fused_entries": self.fused_entries,
            "lockstep_fingerprints": self.lockstep_fingerprints,
            "runtime_drops": self.runtime_drops,
            "runtime_drain_cycles": self.runtime_drain_cycles,
            "runtime_items_drained": self.runtime_items_drained,
            "runtime_max_depth": self.runtime_max_depth,
            "sync_timeouts": self.sync_timeouts,
            "sync_retries": self.sync_retries,
            "sync_failures": self.sync_failures,
            "degraded_computes": self.degraded_computes,
            "faults_injected": self.faults_injected,
            "non_finite_states": self.non_finite_states,
            "runtime_crashes": self.runtime_crashes,
            "runtime_restores": self.runtime_restores,
            "elastic_barriers": self.elastic_barriers,
            "elastic_restores": self.elastic_restores,
            "elastic_degraded_cuts": self.elastic_degraded_cuts,
            "megabatch_steps": self.megabatch_steps,
            "megabatch_tenants": self.megabatch_tenants,
            "tenant_quarantines": self.tenant_quarantines,
            "xla_attributed_compiles": self.xla_attributed_compiles,
            "xla_retraces": self.xla_retraces,
            "drift_alerts": self.drift_alerts,
            "state_health_events": self.state_health_events,
            "slo_violations": self.slo_violations,
            "spmd_collectives": self.spmd_collectives,
            "spmd_wire_bytes": self.spmd_wire_bytes,
            "records": len(self.records),
        }


# ---------------------------------------------------------------- module state
#
# One global ledger (opt-in via enable()) plus a stack of capture() scopes.
# The hot-path predicate is `_ENABLED or _ACTIVE` — two loads and a bool test.

_LEDGER = CollectiveLedger()
_ACTIVE: List[CollectiveLedger] = []
_ENABLED = False
_LOCK = threading.Lock()

#: installed by export.enable_flight_recorder(): every record additionally
#: lands in the flight ring while a recorder is active, even when neither
#: the global ledger nor a capture scope is recording — the crash dump must
#: carry the last events regardless of who else was listening
_FLIGHT_HOOK = None

# attribution is a plain thread-local stack of tags; pushed around sync
# collection so records name the metric/collection member they belong to
_TAGS = threading.local()


def enabled() -> bool:
    """Whether the *global* ledger is recording."""
    return _ENABLED


def recording() -> bool:
    """Whether any ledger (global or captured) is recording."""
    return _ENABLED or bool(_ACTIVE)


def enable() -> None:
    """Start recording into the global ledger (see :func:`get_ledger`)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Stop recording into the global ledger (capture scopes still record)."""
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Clear the global ledger's records and counters."""
    _LEDGER.reset()


def get_ledger() -> CollectiveLedger:
    """The process-global ledger (records only while :func:`enabled`)."""
    return _LEDGER


def summary() -> Dict[str, Any]:
    """Shorthand for ``get_ledger().summary()``."""
    return _LEDGER.summary()


@contextmanager
def capture(sinks: Sequence[Any] = ()) -> Iterator[CollectiveLedger]:
    """Scoped measurement: records everything issued inside the ``with`` into
    a fresh ledger (independent of the global enable flag)::

        with telemetry.capture() as led:
            step(state, preds, target)   # first call traces -> records
        print(led.summary()["wire_bytes_total"])
    """
    led = CollectiveLedger(sinks=sinks)
    with _LOCK:
        _ACTIVE.append(led)
    try:
        yield led
    finally:
        with _LOCK:  # after removal no _emit can reach these sinks
            _ACTIVE.remove(led)
        for sink in led._sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()


def _tag_stack() -> List[str]:
    stack = getattr(_TAGS, "stack", None)
    if stack is None:
        stack = _TAGS.stack = []
    return stack


@contextmanager
def attribution(tag: Optional[str]) -> Iterator[None]:
    """Push an attribution tag for collectives issued inside the scope.

    Nested scopes join with ``/`` (a collection pushes its member key, the
    member metric its class name: ``"acc/MulticlassAccuracy"``).
    """
    if not tag:
        yield
        return
    stack = _tag_stack()
    stack.append(str(tag))
    try:
        yield
    finally:
        stack.pop()


def current_tag() -> str:
    stack = getattr(_TAGS, "stack", None)
    return "/".join(stack) if stack else ""


# ------------------------------------------------------------- report helpers


def _clocks() -> Tuple[int, int]:
    """The (monotonic_ns, wall_ns) stamp every record carries — captured
    only on the recording path (the disabled fast path never reaches it)."""
    return time.monotonic_ns(), time.time_ns()


def _emit(rec: CollectiveRecord) -> None:
    if _ENABLED:
        _LEDGER.record(rec)
    hook = _FLIGHT_HOOK
    if hook is not None:
        hook(rec)
    # the lock pairs with capture()'s remove-then-close: once a ledger is
    # removed under the lock, no emitter can still deliver to its sinks
    with _LOCK:
        for led in _ACTIVE:
            led.record(rec)


def record_collective(
    backend: Any,
    kind: str,
    op: str,
    shape: Tuple[int, ...],
    dtype: Any,
    itemsize: int,
    world_size: int,
    in_trace: bool = False,
    source: str = "backend",
    tag: Optional[str] = None,
    **extra: Any,
) -> None:
    """Report one collective.  First line is the disabled fast path."""
    if not (_ENABLED or _ACTIVE or _FLIGHT_HOOK is not None):
        return
    count = 1
    for d in shape:
        count *= int(d)
    payload = count * int(itemsize)
    if op in ("sum", "mean", "max", "min"):
        wire = reduce_wire_bytes(payload, world_size)
    else:
        wire = gather_wire_bytes(payload, world_size)
    mono_ns, wall_ns = _clocks()
    _emit(
        CollectiveRecord(
            kind=kind,
            op=op,
            dtype=str(dtype),
            shape=tuple(int(d) for d in shape),
            element_count=count,
            payload_bytes=payload,
            wire_bytes=wire,
            backend=type(backend).__name__,
            tag=tag if tag is not None else current_tag(),
            world_size=int(world_size),
            in_trace=bool(in_trace),
            source=source,
            extra=extra,
            mono_ns=mono_ns,
            wall_ns=wall_ns,
        )
    )


def record_flush(backend: Any, entries: int, classes: int, in_trace: bool = False) -> None:
    """Report one :class:`FusedReducer` flush (bookkeeping only, no payload)."""
    if not (_ENABLED or _ACTIVE or _FLIGHT_HOOK is not None):
        return
    mono_ns, wall_ns = _clocks()
    _emit(
        CollectiveRecord(
            kind="flush",
            op="flush",
            dtype="",
            shape=(),
            element_count=0,
            payload_bytes=0,
            wire_bytes=0.0,
            backend=type(backend).__name__,
            tag=current_tag(),
            world_size=0,
            in_trace=bool(in_trace),
            source="event",
            extra={"entries": int(entries), "classes": int(classes)},
            mono_ns=mono_ns,
            wall_ns=wall_ns,
        )
    )


def record_event(backend: Any, kind: str, in_trace: bool = False, **extra: Any) -> None:
    """Report a payload-free bookkeeping event (e.g. a lockstep fingerprint)."""
    if not (_ENABLED or _ACTIVE or _FLIGHT_HOOK is not None):
        return
    mono_ns, wall_ns = _clocks()
    _emit(
        CollectiveRecord(
            kind=kind,
            op=kind,
            dtype="",
            shape=(),
            element_count=0,
            payload_bytes=0,
            wire_bytes=0.0,
            backend=type(backend).__name__,
            tag=current_tag(),
            world_size=0,
            in_trace=bool(in_trace),
            source="event",
            extra=extra,
            mono_ns=mono_ns,
            wall_ns=wall_ns,
        )
    )
