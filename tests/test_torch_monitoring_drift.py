"""The drift monitors (PSI, KL, KS) held against the JAX package and an
exact oracle, with their alerting and telemetry.

- On a reference and live data free of bucket-edge values (where the JAX
  sketch index equals the exact one) the scores equal the JAX package's
  within 2e-6 (the port reads the exact counts in float64, the JAX package
  float32 masses: they differ by float32 roundings) and ``reference_digest``
  is the JAX digest; cumulative, windowed and coarse-slot monitors.
- On integer counts (bucket edges everywhere) the scores equal a float64
  numpy oracle of the documented math (``chip_smoke.sketch_index_oracle``
  binning) within 1e-6, where the JAX package's binning differs: its digest
  differs from the port's, which is the oracle's.
- Alerting: one alert per upward crossing, re-armed only below ``threshold
  - hysteresis``; per-stream latches under ``stream_scope``;
  ``monitoring_stats``; the ``drift_alert`` ledger events of a capture; the
  gauge and counter series in ``prometheus_text()`` as the JAX package
  writes them, and ``release_stream`` removing them.
- ``clone()``, ``copy.deepcopy`` and pickle rebuild the alert lock and keep
  the latches.
"""

import copy
import hashlib
import pickle
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.monitoring as jmon
import tpumetrics_torch
import tpumetrics_torch.monitoring as mon
from chip_smoke import sketch_index_oracle
from tpumetrics.telemetry import export as jexport
from tpumetrics.telemetry import ledger as jledger
from tpumetrics_torch import telemetry as tel
from tpumetrics_torch.telemetry import export as texport
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

JAX_ATOL = 2e-6
ORACLE_ATOL = 1e-6
MONITORS = ["PSI", "KLDrift", "KSDistance"]
REF_N, LIVE_N = 4096, 512  # one reference and one batch shape, so that each JAX op compiles once


def _floats(seed, n, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(shift, 1.0, n) * 1.0001).astype(np.float32)


def oracle_scores(reference, batches, window=None, slots=1, bins=10, eps=1e-6, levels=44, capacity=64):
    """PSI, KL and KS of the live window against the reference, in float64
    numpy from the documented math: the reference's and the live window's
    bucket counts (``sketch_index_oracle``), the equal-reference-mass score
    bins of the JAX package (midpoint-CDF rule over float32 masses), the
    eps-smoothed bin masses."""
    side = levels * capacity

    def ordered(values):
        counts = np.bincount(sketch_index_oracle(values, levels, capacity), minlength=2 * side)
        return np.concatenate([counts[side:][::-1], counts[:side]]).astype(np.float64)

    ref = np.asarray(reference, np.float32)
    ref = ref[np.isfinite(ref)]
    ref_counts = ordered(ref)
    ref_pmf = (ref_counts.astype(np.float32) / np.float32(ref.size)).astype(np.float32)
    mid = np.cumsum(ref_pmf, dtype=np.float64) - 0.5 * ref_pmf
    assign = np.clip((mid * bins).astype(np.int32), 0, bins - 1)
    q = np.clip(np.bincount(assign, weights=ref_pmf, minlength=bins).astype(np.float32).astype(np.float64), eps, 1.0)
    pane = (window // slots) if window else None
    live = batches if window is None else batches[max(0, ((len(batches) - 1) // pane - slots + 1) * pane):]
    x = np.concatenate([b for b in live]) if live else np.zeros(0, np.float32)
    x = x[~np.isnan(x)]
    counts = ordered(x)
    total = max(counts.sum(), 1.0)
    p = np.clip(np.bincount(assign, weights=counts, minlength=bins) / total, eps, 1.0)
    ks = np.abs(np.cumsum(counts) / total - np.cumsum(ref_pmf, dtype=np.float64)).max()
    out = {"PSI": ((p - q) * np.log(p / q)).sum(), "KLDrift": (p * np.log(p / q)).sum(), "KSDistance": ks}
    return {k: (v if x.size else 0.0) for k, v in out.items()}, hashlib.sha1(ref_counts.astype(np.float32).tobytes()).hexdigest()


def _run(name, reference, batches, **kw):
    port = getattr(mon, name)(reference, device="cpu", **kw)
    ref = getattr(jmon, name)(reference, **kw)
    got, want = [], []
    for x in batches:
        port.update(torch.from_numpy(x))
        ref.update(jnp.asarray(x))
        got.append(float(port.compute()))
        want.append(float(ref.compute()))
    return port, ref, np.array(got), np.array(want)


@pytest.mark.parametrize("geometry", [{}, {"window": 4, "slots": 2}, {"window": 3, "slots": 3}], ids=["cumulative", "coarse", "exact"])
@pytest.mark.parametrize("name", MONITORS)
def test_scores_equal_jax_away_from_edge_values(name, geometry):
    reference = _floats(0, REF_N)
    batches = [_floats(i + 1, LIVE_N, shift=0.1 * i) for i in range(6)]
    batches[2][5] = np.nan
    for x in (reference, *batches):
        assert np.array_equal(np.asarray(jmon.SketchLayout().bucket_index(jnp.asarray(x))), sketch_index_oracle(x))
    port, ref, got, want = _run(name, reference, batches, **geometry)
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
    assert port.reference_digest == ref.reference_digest
    assert got.dtype == np.float64 and port.compute().dtype == torch.float32


@pytest.mark.parametrize("name", MONITORS)
def test_scores_equal_the_oracle_on_integer_counts(name):
    """Heavy-tailed integer counts with missing values (NaN): bucket edges
    everywhere. The port equals the exact oracle; the JAX package bins some
    counts one bucket low, so its digest differs."""
    rng = np.random.default_rng(7)
    reference = np.floor(rng.lognormal(1.5, 1.2, REF_N)).astype(np.float32)
    batches = []
    for i in range(5):
        x = np.floor(rng.lognormal(1.5 + 0.2 * i, 1.2, LIVE_N)).astype(np.float32)
        x[rng.random(LIVE_N) < 0.2] = np.nan
        batches.append(x)
    port = getattr(mon, name)(reference, window=4, slots=2, device="cpu")
    jax_digest = getattr(jmon, name)(reference).reference_digest
    for i, x in enumerate(batches):
        port.update(torch.from_numpy(x))
        want, digest = oracle_scores(reference, batches[: i + 1], window=4, slots=2)
        assert abs(float(port.compute()) - want[name]) <= ORACLE_ATOL
    assert port.reference_digest == digest != jax_digest


def test_empty_live_sketch_scores_zero_and_reference_is_checked():
    m = mon.PSI(_floats(1, 100), device="cpu")
    m.update(torch.zeros(0))
    assert float(m.compute()) == 0.0
    for bad in (lambda: mon.PSI(np.float32([np.nan, np.inf]), device="cpu"),
                lambda: mon.KLDrift(_floats(1, 10), hysteresis=-0.1, device="cpu"),
                lambda: mon.KSDistance(_floats(1, 10), score_bins=1, device="cpu")):
        with pytest.raises(TPUMetricsUserError):
            bad()


def _crossing_stream():
    """Live batches whose windowed PSI goes up through 0.25, jitters, falls
    under 0.25 - 0.05, and rises again: two crossings."""
    shifts = [0.0, 0.0, 3.0, 3.0, 0.3, 3.0, 0.0, 0.0, 0.0, 3.0, 3.0]
    return [_floats(100 + i, LIVE_N, s) for i, s in enumerate(shifts)]


def test_alerts_once_per_crossing_with_hysteresis():
    reference = _floats(0, REF_N)
    port = mon.PSI(reference, threshold=0.25, hysteresis=0.05, window=2, slots=2, device="cpu")
    ref = jmon.PSI(reference, threshold=0.25, hysteresis=0.05, window=2, slots=2)
    with tel.capture() as led, jledger.capture() as jled, mon.stream_scope("criteo-ctr"), jmon.stream_scope("criteo-ctr"):
        scores = []
        for x in _crossing_stream():
            port.update(torch.from_numpy(x))
            ref.update(jnp.asarray(x))
            scores.append(float(port.compute()))
            ref.compute()
    latch, alerts = False, 0
    for s in scores:  # the latch, replayed on the scores
        if s >= 0.25 and not latch:
            latch, alerts = True, alerts + 1
        elif latch and s < 0.2:
            latch = False
    assert alerts == 2
    events = [r for r in led.records if r.kind == "drift_alert"]
    assert len(events) == 2 and led.summary()["drift_alerts"] == 2
    assert events[0].extra["stream"] == "criteo-ctr" and events[0].extra["monitor"] == "PSI"
    assert all(e.extra["score"] >= 0.25 and e.extra["threshold"] == 0.25 for e in events)
    assert [r.kind for r in jled.records if r.kind == "drift_alert"] == ["drift_alert"] * 2
    entry = mon.monitoring_stats(port, "criteo-ctr")["PSI"]
    assert entry["alerts"] == 2 and entry["score"] == scores[-1] and entry["window"] == 2
    mon.release_stream(port, "criteo-ctr")
    jmon.release_stream(ref, "criteo-ctr")


def test_stream_latches_prometheus_series_and_release():
    reference = _floats(0, REF_N)
    members = {"psi": mon.PSI(reference, threshold=0.2, name="score_psi", device="cpu"),
               "ks": mon.KSDistance(reference, threshold=0.2, device="cpu")}
    col = tpumetrics_torch.MetricCollection(members, compute_groups=False, device="cpu")
    jcol = tpumetrics.MetricCollection({"psi": jmon.PSI(reference, threshold=0.2, name="score_psi"),
                                        "ks": jmon.KSDistance(reference, threshold=0.2)}, compute_groups=False)
    drifted = _floats(9, LIVE_N, 2.0)
    for stream, x in (("a", drifted), ("b", _floats(8, LIVE_N))):
        with mon.stream_scope(stream), jmon.stream_scope(stream):
            assert mon.current_stream() == stream
            col.update(torch.from_numpy(x))
            jcol.update(jnp.asarray(x))
            col.compute()
            jcol.compute()
            col.reset()
            jcol.reset()
    assert mon.current_stream() == ""
    stats = mon.monitoring_stats(col, "a")
    assert set(stats) == {"psi", "ks"} and stats["psi"]["alert_active"] and stats["psi"]["alerts"] == 1
    assert not mon.monitoring_stats(col, "b")["psi"]["alert_active"]
    jstats = jmon.monitoring_stats(jcol, "a")
    assert {k: {f: v[f] for f in ("monitor", "alert_active", "alerts")} for k, v in stats.items()} == {
        k: {f: v[f] for f in ("monitor", "alert_active", "alerts")} for k, v in jstats.items()}

    def series(text, stream):
        return sorted(line.rsplit(" ", 1)[0] for line in text.splitlines()
                      if line.startswith("tpumetrics_drift") and f'stream="{stream}"' in line)

    text, jtext = texport.prometheus_text(), jexport.prometheus_text()
    want = ['tpumetrics_drift_alerts_total{stream="a",monitor="KSDistance"}',
            'tpumetrics_drift_alerts_total{stream="a",monitor="score_psi"}',
            'tpumetrics_drift_score{stream="a",monitor="KSDistance"}', 'tpumetrics_drift_score{stream="a",monitor="score_psi"}']
    assert series(text, "a") == series(jtext, "a") == want
    assert "# TYPE tpumetrics_drift_score gauge" in text and "# TYPE tpumetrics_drift_alerts_total counter" in text
    mon.release_stream(col, "a")
    jmon.release_stream(jcol, "a")
    assert series(texport.prometheus_text(), "a") == [] and series(texport.prometheus_text(), "b")
    assert mon.monitoring_stats(col, "a")["psi"]["alerts"] == 0
    mon.release_stream(col, "b")
    jmon.release_stream(jcol, "b")


def test_clone_deepcopy_and_pickle_rebuild_the_alert_lock():
    m = mon.PSI(_floats(0, 1000), threshold=0.1, device="cpu")
    m.update(torch.from_numpy(_floats(3, 1000, 2.0)))
    with mon.stream_scope("s"):
        m.compute()
    for twin in (m.clone(), copy.deepcopy(m), pickle.loads(pickle.dumps(m))):
        assert isinstance(twin._alert_lock, type(threading.Lock())) and twin._alert_lock is not m._alert_lock
        assert twin.monitoring_entry("s")["alerts"] == 1 and twin.monitoring_entry("s")["alert_active"]
        assert twin.reference_digest == m.reference_digest
        twin.update(torch.from_numpy(_floats(4, 10)))
        assert torch.equal(m.sketch, copy.deepcopy(m).sketch)
    mon.release_stream(m, "s")


def test_criteo_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.criteo_phase`` at a small size on the CPU (its card-only
    parts left out): the sketches bit for bit its exact oracles at every
    refresh, the alerts where its oracle's latch fires, the CPU path's
    worker processes, and the Prometheus series and their release."""
    import chip_smoke

    for name, value in (("CRITEO_BATCH", 2048), ("CRITEO_UPDATES", 40), ("CRITEO_ROWS", 39 * 2048 + 777),
                        ("CRITEO_LAST", 777), ("CRITEO_SHIFT_AT", 20), ("CRITEO_WINDOW", 10), ("CRITEO_SLOTS", 5),
                        ("CRITEO_REFRESH", 2), ("CRITEO_CHECKPOINTS", (30, 40)), ("CRITEO_REF_SCORES", 50_000),
                        ("CRITEO_REF_ROWS", 20_000), ("CRITEO_CPU_PARTS", ("collections", tuple(range(13))))):
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.criteo_phase(torch, type("Kernel", (), {"launches": 0})(), device="cpu")
    assert out["cpu_updates"] == 40 and out["reduced"] == "none"
    for name in ("score_psi", "score_kl", "score_ks", "I4"):
        assert out["alerts"][name]["refreshes"] == out["alerts"][name]["oracle"] and len(out["alerts"][name]["oracle"]) == 1
    assert not any(v["refreshes"] for k, v in out["alerts"].items() if k.startswith("I") and k != "I4")
