"""Pluggable telemetry sinks (counterpart of ``tpumetrics/telemetry/sinks.py``).

A sink receives every :class:`~tpumetrics_torch.telemetry.ledger.CollectiveRecord`
a ledger records (attach with ``CollectiveLedger.add_sink``, the ``sinks=``
argument of :func:`~tpumetrics_torch.telemetry.ledger.capture`, or directly on the
global ledger).  Two stdlib-only implementations ship here:

- :class:`LoggingSink` — one ``logging`` line per record on the
  ``tpumetrics_torch.telemetry`` logger.
- :class:`JsonlSink` — one JSON object per line, machine-readable (the
  format ``telemetry.summary()`` totals are derived from).
"""

from __future__ import annotations

import json
import logging
from typing import IO, Any, Optional, Union

from tpumetrics_torch.telemetry.ledger import CollectiveRecord

__all__ = ["TelemetrySink", "LoggingSink", "JsonlSink"]


class TelemetrySink:
    """Interface: receives records as they are recorded."""

    def emit(self, record: CollectiveRecord) -> None:
        raise NotImplementedError

    def close(self) -> None:  # noqa: B027
        """Release resources (called when a ``capture`` scope exits)."""


class LoggingSink(TelemetrySink):
    """Emit each record through stdlib :mod:`logging`."""

    def __init__(self, logger: Optional[logging.Logger] = None, level: int = logging.INFO) -> None:
        self._logger = logger if logger is not None else logging.getLogger("tpumetrics_torch.telemetry")
        self._level = level

    def emit(self, record: CollectiveRecord) -> None:
        self._logger.log(
            self._level,
            "collective %s op=%s dtype=%s shape=%s elements=%d wire_bytes=%.0f backend=%s tag=%s%s",
            record.kind,
            record.op,
            record.dtype,
            record.shape,
            record.element_count,
            record.wire_bytes,
            record.backend,
            record.tag or "-",
            " (in-trace)" if record.in_trace else "",
        )


class JsonlSink(TelemetrySink):
    """Append each record as one JSON line to a path or open text file."""

    def __init__(self, target: Union[str, IO[str]]) -> None:
        if isinstance(target, str):
            self._fh: IO[str] = open(target, "a")
            self._owns = True
        else:
            self._fh = target
            self._owns = False

    def emit(self, record: CollectiveRecord) -> None:
        self._fh.write(json.dumps(record.to_dict(), sort_keys=True) + "\n")

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.flush()
        if self._owns:
            self._fh.close()


def _record_from_json(line: str) -> Any:
    """Parse one JSONL line back to a dict (test/analysis helper)."""
    return json.loads(line)
