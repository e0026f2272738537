"""The port's telemetry core held against the JAX package's.

- Instruments: the same calls on counters, gauges and histograms (plain and
  sketch mode) give the same ``collect()``, the same ``to_dict()`` and the
  same ``prometheus_text()`` and ``instruments_jsonl()`` bytes, each
  package's registry and global ledger swapped for empty ones for the test.
- The ledger: ``capture`` and the global switch, ``summary``,
  ``attribution`` nesting, the sinks' output, and nothing recorded while
  off (the report helpers return at their first line).
- The sync's records: a ``FusedReducer`` flush on a world-1 backend, and a
  collection's ``sync_states`` (reduce classes, a list state, a
  MaskedBuffer, a sketch), give records equal field for field to the JAX
  package's (kind, op, dtype, shape, element count, payload and wire bytes,
  backend, tag, world size, source and extras; the JAX package's lockstep
  fingerprint events, not ported yet, left aside).
- A real gloo world of 2 ranks: the ledger of a synced ``compute()`` holds
  one record per wire call of the backend, with the ring model's wire bytes,
  and the members' tags.
"""

import io
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.classification as jcls
import tpumetrics.monitoring as jmon
import tpumetrics_torch
import tpumetrics_torch.classification as cls
import tpumetrics_torch.monitoring as mon
from tests import torch_sync_worker as w
from tpumetrics import telemetry as jtel
from tpumetrics.parallel.fuse import FusedReducer as JaxFusedReducer
from tpumetrics.telemetry import export as jexport
from tpumetrics.telemetry import instruments as jinst
from tpumetrics.telemetry import ledger as jledger
from tpumetrics_torch import telemetry as tel
from tpumetrics_torch.parallel import FusedReducer
from tpumetrics_torch.telemetry import export as texport
from tpumetrics_torch.telemetry import instruments as tinst
from tpumetrics_torch.telemetry import ledger as tledger

# a record's fields that two runs share (the clocks differ)
FIELDS = ("kind", "op", "dtype", "shape", "element_count", "payload_bytes", "wire_bytes", "backend", "tag",
          "world_size", "in_trace", "source", "extra")


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' instrument registries and global ledgers, empty, for one
    test (the module-level instruments, such as the drift gauge, stay
    registered outside it)."""
    for inst, led in ((jinst, jledger), (tinst, tledger)):
        monkeypatch.setattr(inst, "_REGISTRY", {})
        monkeypatch.setattr(inst, "_ENABLED", True)
        monkeypatch.setattr(led, "_LEDGER", led.CollectiveLedger())
        monkeypatch.setattr(led, "_ENABLED", False)


def _drive_instruments(inst):
    """The same calls, through either package's ``instruments`` module."""
    c = inst.counter("test_requests_total", help="requests", labels=("route",))
    c.inc(1, "a")
    c.inc(2.5, "b")
    c.inc(1, 'q"uo\\te')
    g = inst.gauge("test_depth", help="queue depth")
    g.set(7)
    g.inc(0.25)
    g.dec(3)
    h = inst.histogram("test_latency_ms", help="latency", labels=("stream",), buckets=(1.0, 5.0, 10.0))
    s = inst.histogram("test_sketch_ms", labels=("stream",), sketch=True)
    for i, v in enumerate([0.5, 1.0, 3.0, 7.5, 12.0, 0.0, 33.0, 1e9]):
        h.observe(v, "x" if i % 3 else "y")
        s.observe(v, "x")
    inst.counter("test_unlabelled_total").inc()
    with pytest.raises(ValueError):
        inst.gauge("test_requests_total")  # a name is a contract: another kind raises
    return {i.name: (i.kind, list(i.collect()), i.to_dict()) for i in inst.registry()}, h, s


def test_instruments_collect_and_export_like_jax(fresh):
    got, h, s = _drive_instruments(tinst)
    want, jh, js = _drive_instruments(jinst)
    assert got == want
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q) and s.quantile(q, "x") == js.quantile(q, "x")
    assert h.summary("x") == jh.summary("x") and s.summary() == js.summary()
    assert texport.prometheus_text() == jexport.prometheus_text()
    assert texport.prometheus_text(include_ledger=False) == jexport.prometheus_text(include_ledger=False)
    bufs = io.StringIO(), io.StringIO()
    assert texport.instruments_jsonl(bufs[0]) == jexport.instruments_jsonl(bufs[1]) == len(want)
    assert bufs[0].getvalue() == bufs[1].getvalue()


def test_disabled_instruments_record_nothing_and_reset_keeps_families(fresh):
    c = tinst.counter("test_off_total", labels=("k",))
    tinst.disable()
    c.inc(1, "a")
    tinst.histogram("test_off_ms").observe(3.0)
    assert not tinst.enabled() and list(c.collect()) == [] and tinst.histogram("test_off_ms").summary()["count"] == 0
    tinst.enable()
    c.inc(1, "a")
    tinst.reset()
    assert tinst.get_instrument("test_off_total") is c and list(c.collect()) == []


def test_host_sketch_index_is_the_exact_bucket_index():
    """The instruments' host sketch (sketch-mode histograms) bins like the
    monitoring sketch, at the bucket edges too."""
    layout = mon.SketchLayout()
    edges = np.float32(layout.unit * 2.0 ** np.arange(-2, 45))
    values = np.concatenate([np.arange(200, dtype=np.float32), edges, np.nextafter(edges, np.float32(0)), [np.inf]])
    values = np.concatenate([values, -values[1:]])
    want = layout.bucket_index(torch.from_numpy(values)).tolist()
    assert [tinst.sketch_index(float(v)) for v in values] == want
    assert tinst.sketch_index(float("nan")) == 0


def _records(led):
    return [{f: r.to_dict().get(f, {}) for f in FIELDS} for r in led.records if r.kind != "lockstep"]


class _World1:
    """A duck-typed, uninstrumented world-1 backend for both packages."""

    in_trace = False
    has_object_channel = False

    def world_size(self):
        return 1

    def available(self):
        return True

    def all_reduce(self, x, op, group=None):
        return x

    def all_gather(self, x, group=None):
        return [x]


def _flush(pkg_reducer, asarray, ledger_mod):
    with ledger_mod.capture() as led:
        red = pkg_reducer(_World1())
        with ledger_mod.attribution("acc"):
            red.add(asarray(np.ones(3, np.float32)), "sum")
            with ledger_mod.attribution("MulticlassAccuracy"):
                red.add(asarray(np.ones((2, 2), np.float32)), "sum")
        with ledger_mod.attribution("f1"):
            red.add(asarray(np.asarray(5, np.int32)), "max")
            red.add(asarray(np.zeros(4, np.int32)), "sum", tag="explicit")
        red.add(asarray(np.zeros(2, np.float32)), "sum")  # no tag: joins the class untagged
        red.flush()
    return led


def test_fused_reducer_flush_records_equal_the_jax_ones():
    led = _flush(FusedReducer, torch.from_numpy, tledger)
    jled = _flush(JaxFusedReducer, jnp.asarray, jledger)
    assert _records(led) == _records(jled)
    assert led.summary()["flush_count"] == 1 and led.summary()["fused_entries"] == 5
    fused = next(r for r in led.records if r.op == "sum" and r.dtype == "float32")
    assert fused.element_count == 9 and fused.tag == "acc+acc/MulticlassAccuracy"


def _collection_pair():
    """One collection in each package over the same members: reduce classes
    of two dtypes, a list state, a MaskedBuffer and a windowed sketch."""
    C = 4
    port = tpumetrics_torch.MetricCollection({
        "acc": cls.MulticlassAccuracy(C, average="micro", validate_args=False, device="cpu"),
        "auroc": cls.MulticlassAUROC(C, thresholds=8, validate_args=False, device="cpu"),
        "cat": tpumetrics_torch.CatMetric(device="cpu"),
        "buf": tpumetrics_torch.CatMetric(device="cpu"),
        "q": mon.SketchQuantiles((0.5,), window=4, slots=2, device="cpu"),
    }, compute_groups=False, device="cpu")
    jax_col = tpumetrics.MetricCollection({
        "acc": jcls.MulticlassAccuracy(C, average="micro", validate_args=False),
        "auroc": jcls.MulticlassAUROC(C, thresholds=8, validate_args=False),
        "cat": tpumetrics.CatMetric(),
        "buf": tpumetrics.CatMetric(),
        "q": jmon.SketchQuantiles((0.5,), window=4, slots=2),
    }, compute_groups=False)
    for col in (port, jax_col):
        col["buf"].set_state_capacity("value", 6)
    # a sync's records name shapes and dtypes, never values: the initial states will do
    return port, port.init_state(), jax_col, jax_col.init_state()


def test_collection_sync_records_equal_the_jax_ones():
    port, port_state, jax_col, jax_state = _collection_pair()
    with tel.capture() as led:
        port.sync_states(port_state, _World1())
    with jtel.capture() as jled:
        jax_col.sync_states(jax_state, _World1())
    got = _records(led)
    assert got == _records(jled)
    kinds = {(r["kind"], r["tag"]) for r in got}
    assert ("buffer_gather", "buf/CatMetric") in kinds and ("flush", "") in kinds
    assert any(r["kind"] == "fused_class" and "q/SketchQuantiles" in r["tag"] for r in got)


def test_multitask_sync_records_equal_the_jax_ones():
    """A ``MultitaskWrapper``'s sync tags each task's collectives with the
    task's name, as the JAX wrapper does."""
    from tpumetrics.regression import MeanSquaredError as JaxMSE
    from tpumetrics.wrappers import MultitaskWrapper as JaxMultitask
    from tpumetrics_torch.regression import MeanSquaredError
    from tpumetrics_torch.wrappers import MultitaskWrapper

    p = np.arange(6, dtype=np.float32)
    port = MultitaskWrapper({"a": MeanSquaredError(device="cpu"), "b": cls.BinaryAccuracy(device="cpu")})
    ref = JaxMultitask({"a": JaxMSE(), "b": jcls.BinaryAccuracy()})
    y = (p > 2).astype(np.int32)
    port_state = port.functional_update(port.init_state(), {"a": torch.from_numpy(p), "b": torch.from_numpy(p / 6)},
                                        {"a": torch.from_numpy(p + 1), "b": torch.from_numpy(y)})
    jax_state = ref.functional_update(ref.init_state(), {"a": jnp.asarray(p), "b": jnp.asarray(p / 6)},
                                      {"a": jnp.asarray(p + 1), "b": jnp.asarray(y)})
    with tel.capture() as led:
        port.sync_state(port_state, _World1())
    with jtel.capture() as jled:
        ref.sync_state(jax_state, _World1())
    assert _records(led) == _records(jled)
    assert [r.tag for r in led.records if r.kind == "fused_class"] == ["a/MeanSquaredError",
                                                                     "a/MeanSquaredError+b/BinaryAccuracy"]


def test_capture_enable_summary_and_attribution():
    assert tel.current_tag() == "" and not tel.recording()
    tel.record_collective(object(), "all_reduce", "sum", (4,), "float32", 4, 8)  # off: nothing anywhere
    with tel.capture() as outer:
        with tel.attribution("col"):
            with tel.attribution("MulticlassAccuracy"):
                assert tel.current_tag() == "col/MulticlassAccuracy"
                with tel.capture() as inner:
                    tel.record_collective(object(), "all_gather", "gather", (2, 3), "int32", 4, 2)
            with tel.attribution(None):
                assert tel.current_tag() == "col"
        tel.record_event(object(), "drift_alert", monitor="psi")
    assert tel.current_tag() == ""
    assert inner.summary()["collectives_issued"] == 1 and inner.summary()["wire_bytes_total"] == 24.0
    assert outer.records[0].tag == "col/MulticlassAccuracy" and outer.summary()["drift_alerts"] == 1
    try:
        tel.reset()
        tel.enable()
        assert tel.enabled() and tel.recording()
        tel.record_collective(object(), "all_reduce", "sum", (8,), "float32", 4, 4)
        tel.disable()
        tel.record_collective(object(), "all_reduce", "sum", (8,), "float32", 4, 4)
        assert tel.summary()["collectives_issued"] == 1 and tel.summary()["bytes_by_op"] == {"sum": 2 * 3 / 4 * 32}
        assert tel.get_ledger().records[0].world_size == 4
    finally:
        tel.disable()
        tel.reset()


def test_disabled_telemetry_records_nothing_through_a_sync(monkeypatch):
    """Off, a sync's report calls return at their flag test: no record is
    made (the clock stamp of a record would raise here)."""
    port, port_state, _, _ = _collection_pair()

    def stamped():
        raise AssertionError("a record was made with telemetry off")

    monkeypatch.setattr(tledger, "_clocks", stamped)
    assert not tel.recording()
    port.sync_states(port_state, _World1())
    assert tel.get_ledger().records == []


def test_sinks_write_what_the_jax_sinks_write(tmp_path, caplog):
    outs = {}
    for name, ledger_mod, sinks_mod in (("port", tledger, tel), ("jax", jledger, jtel)):
        path = tmp_path / f"{name}.jsonl"
        logger = logging.getLogger(f"sink-test-{name}")
        with caplog.at_level(logging.INFO, logger=logger.name):
            caplog.clear()
            with ledger_mod.capture(sinks=[sinks_mod.JsonlSink(str(path)), sinks_mod.LoggingSink(logger)]):
                with ledger_mod.attribution("acc"):
                    ledger_mod.record_collective(_World1(), "all_reduce", "sum", (3, 2), "float32", 4, 4)
                ledger_mod.record_flush(_World1(), entries=2, classes=1)
            logged = [r.getMessage() for r in caplog.records]
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        for obj in lines:
            obj.pop("mono_ns"), obj.pop("wall_ns")
        outs[name] = (lines, logged)
    assert outs["port"] == outs["jax"] and len(outs["port"][0]) == 2


@pytest.fixture(scope="module")
def gloo2(tmp_path_factory):
    return w.run_worlds((2,), tmp_path_factory.mktemp("ledger"), ["ledger"])[2]


def test_gloo_sync_records_every_wire_call_with_the_ring_model_bytes(gloo2):
    for res in gloo2:
        rec = res["ledger"]
        wire = [r for r in rec["records"] if r["source"] == "backend"]
        assert rec["summary"]["collectives_issued"] == len(wire) == rec["wire"]
        for r in wire:
            assert r["world_size"] == 2 and r["backend"] == "Counting"
            n = 2 * 1 / 2 if r["kind"] == "all_reduce" else 1.0  # 2(N-1)/N for a reduce, N-1 for a gather
            assert r["wire_bytes"] == n * r["payload_bytes"] == n * r["element_count"] * np.dtype(r["dtype"]).itemsize
        reduces = [(r["op"], r["dtype"], r["element_count"]) for r in wire if r["kind"] == "all_reduce"]
        assert reduces == [(op, dt.removeprefix("torch."), n) for op, dt, n in rec["reduces"]]
        assert rec["summary"]["wire_bytes_total"] == sum(r["wire_bytes"] for r in wire)
        fused = [r for r in rec["records"] if r["kind"] == "fused_class"]
        tags = "+".join(r["tag"] for r in fused)
        for key, name in (("acc", "MulticlassAccuracy"), ("auroc", "MulticlassAUROC"), ("mean", "MeanMetric")):
            assert f"{key}/{name}" in tags
        gathers = [r for r in wire if r["kind"] == "all_gather"]
        assert gathers and all(r["tag"] == "cat/CatMetric" for r in gathers)
        assert rec["summary"]["flush_count"] == 1
    # every collective has the same shape on every rank: the ranks account the same bytes
    assert gloo2[0]["ledger"]["summary"]["wire_bytes_total"] == gloo2[1]["ledger"]["summary"]["wire_bytes_total"]
