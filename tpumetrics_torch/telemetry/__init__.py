"""``tpumetrics_torch.telemetry`` — the port's observability core
(counterpart of ``tpumetrics/telemetry``, the parts ported so far):

- **Collective ledger** (:mod:`~tpumetrics_torch.telemetry.ledger`): every
  ``TorchDistBackend`` wire call, every ``FusedReducer.flush`` and every
  buffer gather reports op, dtype, element count, wire bytes, backend class
  and an attribution tag; aggregate counters plus a :func:`capture` context
  manager for scoped measurement. Off unless a ``capture()`` or
  :func:`enable` is active: then a sync pays one flag test per collective.
- **Sinks** (:mod:`~tpumetrics_torch.telemetry.sinks`): pluggable record
  consumers — stdlib logging and JSON lines.
- **Instruments** (:mod:`~tpumetrics_torch.telemetry.instruments`):
  process-global counters, gauges and fixed-bucket histograms (the drift
  monitors' score gauge and alert counter among them).
- **Export** (:mod:`~tpumetrics_torch.telemetry.export`): Prometheus text
  exposition of the instruments and the ledger's aggregates, and JSONL
  dumps of the instruments.

Lockstep verification, spans, the flight recorder, timelines, SLOs, the
admin server and federation wait for the port of the serving planes.

Quick start::

    from tpumetrics_torch import telemetry

    with telemetry.capture() as led:
        value = collection.compute()        # a synced compute()
    print(led.summary())                    # counts, wire bytes by op class
"""

from tpumetrics_torch.telemetry import export, instruments
from tpumetrics_torch.telemetry.export import prometheus_text
from tpumetrics_torch.telemetry.instruments import counter, gauge, histogram
from tpumetrics_torch.telemetry.ledger import (
    CollectiveLedger,
    CollectiveRecord,
    attribution,
    capture,
    current_tag,
    disable,
    enable,
    enabled,
    gather_wire_bytes,
    get_ledger,
    record_collective,
    record_event,
    record_flush,
    recording,
    reduce_wire_bytes,
    reset,
    summary,
)
from tpumetrics_torch.telemetry.sinks import JsonlSink, LoggingSink, TelemetrySink

# the JAX package's ``telemetry.__all__`` restricted to the ported names, in its order
__all__ = [
    "CollectiveLedger",
    "CollectiveRecord",
    "JsonlSink",
    "LoggingSink",
    "TelemetrySink",
    "attribution",
    "counter",
    "export",
    "gauge",
    "histogram",
    "instruments",
    "prometheus_text",
    "capture",
    "current_tag",
    "disable",
    "enable",
    "enabled",
    "gather_wire_bytes",
    "get_ledger",
    "record_collective",
    "record_event",
    "record_flush",
    "recording",
    "reduce_wire_bytes",
    "reset",
    "summary",
]
