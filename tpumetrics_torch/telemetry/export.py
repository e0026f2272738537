"""Export: Prometheus text exposition and JSONL dumps of the instruments
(counterpart of the Prometheus and JSONL part of
``tpumetrics/telemetry/export.py``, the same code).

- :func:`prometheus_text` — the whole instruments registry (and, by
  default, the global ledger's aggregates as derived families) in
  Prometheus text exposition format, ready to serve from any ``/metrics``
  handler.
- :func:`instruments_jsonl` — machine-readable JSON lines of the
  instrument registry.

The rest of the JAX module (``spans_jsonl``, ``perfetto_trace`` and the
flight recorder) waits for the port of the spans.
"""

from __future__ import annotations

import json
from typing import IO, Dict, Iterator, Optional, Union

from tpumetrics_torch.telemetry import instruments as _instruments
from tpumetrics_torch.telemetry import ledger as _ledger

__all__ = [
    "instruments_jsonl",
    "prometheus_text",
]


# ------------------------------------------------------------ prometheus text


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _fmt_labels(names: tuple, values: tuple, extra: Optional[Dict[str, str]] = None) -> str:
    pairs = [(n, v) for n, v in zip(names, values)]
    if extra:
        pairs += list(extra.items())
    if not pairs:
        return ""
    body = ",".join(
        '%s="%s"' % (n, str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n"))
        for n, v in pairs
    )
    return "{" + body + "}"


def _prometheus_families() -> Iterator[str]:
    for inst in _instruments.registry():
        if inst.help:
            yield f"# HELP {inst.name} {inst.help}"
        yield f"# TYPE {inst.name} {inst.kind}"
        if inst.kind == "histogram":
            for lv, data in inst.collect():
                cum = 0
                for edge, c in data["buckets"]:
                    cum += c
                    yield (
                        f"{inst.name}_bucket"
                        f"{_fmt_labels(inst.labelnames, lv, {'le': _fmt_value(edge)})} {cum}"
                    )
                cum += data["overflow"]
                yield (
                    f"{inst.name}_bucket"
                    f"{_fmt_labels(inst.labelnames, lv, {'le': '+Inf'})} {cum}"
                )
                yield f"{inst.name}_sum{_fmt_labels(inst.labelnames, lv)} {_fmt_value(data['sum'])}"
                yield f"{inst.name}_count{_fmt_labels(inst.labelnames, lv)} {data['count']}"
        else:
            for lv, value in inst.collect():
                yield f"{inst.name}{_fmt_labels(inst.labelnames, lv)} {_fmt_value(value)}"


def _ledger_families() -> Iterator[str]:
    summ = _ledger.summary()
    yield "# TYPE tpumetrics_ledger_events_total counter"
    for kind in sorted(summ["counts_by_kind"]):
        yield (
            f"tpumetrics_ledger_events_total{_fmt_labels(('kind',), (kind,))} "
            f"{summ['counts_by_kind'][kind]}"
        )
    yield "# TYPE tpumetrics_ledger_collectives_total counter"
    yield f"tpumetrics_ledger_collectives_total {summ['collectives_issued']}"
    yield "# TYPE tpumetrics_ledger_wire_bytes_total counter"
    yield f"tpumetrics_ledger_wire_bytes_total {_fmt_value(summ['wire_bytes_total'])}"


def prometheus_text(include_ledger: bool = True) -> str:
    """The instruments registry (+ ledger aggregates) in Prometheus text
    exposition format.  The ledger's aggregate counters are exported as
    derived families (``tpumetrics_ledger_events_total{kind=…}`` etc.) —
    views over the same numbers ``telemetry.summary()`` reports, so one
    scrape covers both layers."""
    lines = list(_prometheus_families())
    if include_ledger:
        lines.extend(_ledger_families())
    return "\n".join(lines) + "\n"


# -------------------------------------------------------------- JSONL dumps


def _open_target(target: Union[str, IO[str]]):
    if isinstance(target, str):
        return open(target, "w"), True
    return target, False


def instruments_jsonl(target: Union[str, IO[str]]) -> int:
    """Write every registered instrument (name, labels, series) as JSON
    lines; returns the line count."""
    fh, owns = _open_target(target)
    try:
        n = 0
        for inst in _instruments.registry():
            fh.write(json.dumps(inst.to_dict(), sort_keys=True, default=repr) + "\n")
            n += 1
        return n
    finally:
        if owns:
            fh.close()
