"""The monitoring domain's sketch and windows held against the JAX package
and an exact oracle.

- The sketch's bucket index equals ``chip_smoke.sketch_index_oracle`` (the
  documented math in float64 numpy, by ``searchsorted`` over the level
  bounds) bit for bit: at every level bound and one float32 ulp either
  side, on the integers 0..69,999, at +-inf, -0.0 and NaN, and on random
  floats, under three layouts (one with a unit and a capacity that are not
  powers of two). It equals the JAX package's ``bucket_index`` wherever
  that equals the oracle; the JAX index puts 355 of the integers 0..69,999
  one bucket low under the default layout (values on a bucket edge: 3, 33,
  34, ...), and none under ``levels=20``: the test lists them.
- ``SketchQuantiles`` (cumulative, windowed, coarse slots) against the JAX
  package on data free of those edge values: states bit for bit, the
  estimates equal, with ``valid`` masks, NaN, zero-size batches and
  eviction; the estimates within 1/capacity of the exact quantiles.
- The windowed aggregators and ``DecayedMean`` against the JAX package
  under every ``nan_strategy``, with exact and coarse slots: counts, maxima
  and minima exact, float32 sums within 1e-6 relative.
- The sketch merge bit-identical under every fold order, and a fused
  collection of every member bit for bit its unfused twin.
- A real gloo world of 2 and of 3 ranks: each rank feeds its rows of every
  batch; the synced sketches are bit for bit the sketch of the whole data,
  the tick folds with ``max``, and the values equal the JAX package's on
  the whole data.
"""

import copy
import itertools
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.monitoring as jmon
import tpumetrics_torch
import tpumetrics_torch.monitoring as mon
from chip_smoke import sketch_index_oracle
from tests import torch_sync_worker as w
from tpumetrics_torch.interop import export_state
from tpumetrics_torch.monitoring.sketch import ring_position
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

RTOL = 1e-6
LAYOUTS = [(44, 64, None), (20, 16, None), (10, 100, 0.3)]
INTS = np.arange(70_000, dtype=np.float32)
# the integers the JAX index puts one bucket low under the default layout (its float32 log2/exp2)
JAX_EDGE_DEVIANTS = 355


def _edge_values(layout):
    """Every level bound of ``layout`` as float32, one ulp either side, and
    the specials, with their negatives."""
    bounds = (layout.unit * 2.0 ** np.arange(-1, layout.levels + 1)).astype(np.float32)
    v = np.concatenate([bounds, np.nextafter(bounds, np.float32(np.inf)), np.nextafter(bounds, np.float32(0)),
                        np.float32([0.0, np.inf, np.nan, 1e30, 3.4e38, 1e-30, 1e-45])])
    return np.concatenate([v, -v])


def _index(layout, values):
    return layout.bucket_index(torch.from_numpy(np.asarray(values, np.float32))).numpy()


@pytest.mark.parametrize("levels,capacity,unit", LAYOUTS)
def test_bucket_index_equals_the_exact_oracle(levels, capacity, unit):
    layout = mon.SketchLayout(levels, capacity, unit)
    rng = np.random.default_rng(levels)
    floats = np.concatenate([rng.lognormal(0, 4, 20_000), -rng.random(20_000), rng.random(2_000) * layout.unit])
    for values in (_edge_values(layout), INTS, floats.astype(np.float32)):
        got = _index(layout, values)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, sketch_index_oracle(values, levels, capacity, unit))


def test_bucket_index_specials():
    layout = mon.SketchLayout()
    side, top = layout.side, layout.side - 1
    got = _index(layout, np.float32([np.inf, -np.inf, -0.0, 0.0, np.nan, -np.nan]))
    assert got.tolist() == [top, top + side, 0, 0, 0, 0]


def test_jax_bucket_index_deviates_only_on_listed_edge_values():
    """Where the JAX index differs from the oracle, it is one bucket low, on
    values that sit on a bucket edge (the JAX package's float32 log2 and
    exp2): the port follows the oracle."""
    jax_layout = jmon.SketchLayout()
    oracle = sketch_index_oracle(INTS)
    jax_index = np.asarray(jax_layout.bucket_index(jnp.asarray(INTS)))
    deviants = INTS[jax_index != oracle]
    assert len(deviants) == JAX_EDGE_DEVIANTS and deviants[:3].tolist() == [3.0, 33.0, 34.0]
    np.testing.assert_array_equal((jax_index - oracle)[jax_index != oracle], -1)
    np.testing.assert_array_equal(_index(mon.SketchLayout(), deviants), oracle[jax_index != oracle])
    small = jmon.SketchLayout(levels=20, capacity=16)
    np.testing.assert_array_equal(np.asarray(small.bucket_index(jnp.asarray(INTS))), sketch_index_oracle(INTS, 20, 16))


def _stream(seed, n_batches=7, size=512, scale=3.0):
    """(values, valid) batches: normal floats (no bucket-edge value), NaNs,
    a masked tail, and one zero-size batch."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        n = 0 if i == 3 else size
        x = (rng.normal(1.0, scale, n) * 1.0001).astype(np.float32)
        if n:
            x[i] = np.nan
        valid = rng.random(n) > 0.2
        out.append((x, valid))
    return out


def _edge_free(batches):
    """The JAX index equals the oracle on every batch (batch by batch: the
    shapes the JAX updates compile for anyway)."""
    jax_layout = jmon.SketchLayout()
    for x, _ in batches:
        assert np.array_equal(np.asarray(jax_layout.bucket_index(jnp.asarray(x))), sketch_index_oracle(x))


@pytest.mark.parametrize("window,slots", [(None, None), (4, 2), (4, 4), (3, None)])
def test_sketch_quantiles_equal_jax(window, slots):
    batches = _stream(window or 1)
    _edge_free(batches)
    qs = (0.0, 0.1, 0.5, 0.9, 0.999, 1.0)
    port = mon.SketchQuantiles(qs, window=window, slots=slots, device="cpu")
    ref = jmon.SketchQuantiles(qs, window=window, slots=slots)
    for x, valid in batches:
        port.update(torch.from_numpy(x), torch.from_numpy(valid))
        ref.update(jnp.asarray(x), jnp.asarray(valid))
        np.testing.assert_array_equal(port.sketch.numpy(), np.asarray(ref.sketch))
        assert int(port.count) == int(ref.count)
        np.testing.assert_array_equal(port.compute().numpy(), np.asarray(ref.compute()))


def test_sketch_quantiles_within_the_bound_of_exact_quantiles():
    rng = np.random.default_rng(1)
    x = rng.lognormal(2.0, 1.0, 50_000).astype(np.float32)
    qs = (0.01, 0.5, 0.9, 0.99)
    m = mon.SketchQuantiles(qs, device="cpu")
    m.update(torch.from_numpy(x))
    exact = np.sort(x)[np.maximum(np.ceil(np.array(qs) * x.size).astype(int) - 1, 0)]
    np.testing.assert_array_less(np.abs(m.compute().numpy() - exact) / exact, 1 / m.capacity)
    empty = mon.SketchQuantiles(qs, device="cpu")
    empty.update(torch.zeros(0))
    assert torch.isnan(empty.compute()).all() and int(empty.count) == 1


def test_sketch_merge_is_bit_identical_under_every_fold_order():
    layout = mon.SketchLayout()
    rng = np.random.default_rng(2)
    rows = []
    for r in range(4):
        m = mon.SketchQuantiles(window=4, slots=2, device="cpu")
        for _ in range(3):
            m.update(torch.from_numpy(rng.normal(r, 2.0, 50).astype(np.float32)))
        rows.append(m.sketch)
    want = layout.merge(torch.stack(rows))
    for order in itertools.permutations(range(4)):
        pairwise = rows[order[0]]
        for i in order[1:]:
            pairwise = layout.merge(torch.stack([pairwise, rows[i]]))
        assert torch.equal(pairwise, want)
    assert torch.equal(layout.merge(torch.stack([want, layout.identity_like(want)])), want)
    jax_merge = jmon.SketchLayout().merge(jnp.stack([jnp.asarray(r.numpy()) for r in rows]))
    np.testing.assert_array_equal(want.numpy(), np.asarray(jax_merge))
    merge = mon.sketch_merge(layout)
    assert merge.describe() == "merge:sketch(capacity=64, levels=44, unit=9.5367431640625e-07)"


def test_ring_position_matches_the_window_rotation():
    for count in range(13):
        idx, fresh = ring_position(torch.tensor(count, dtype=torch.int32), 3, 2)
        assert (int(idx), bool(fresh)) == ((count // 3) % 2, count % 3 == 0)


WINDOWED = ["WindowedMean", "WindowedSum", "WindowedMax", "WindowedMin"]
STRATEGIES = ["ignore", "disable", 10.0]


def _assert_states(port, ref):
    got, want = export_state(port), {k: np.asarray(getattr(ref, k)) for k in port._defaults}
    for name, val in want.items():
        if val.dtype.kind == "f" and name not in ("slot_max", "slot_min"):
            np.testing.assert_allclose(got[name], val, rtol=RTOL, atol=RTOL)
        else:
            np.testing.assert_array_equal(got[name], val)


@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("name", WINDOWED)
def test_windowed_aggregators_equal_jax(name, strategy):
    batches = _stream(4, n_batches=9)
    rng = np.random.default_rng(5)
    for window, slots in ((6, None), (6, 3)):
        port = getattr(mon, name)(window, slots=slots, nan_strategy=strategy, device="cpu")
        ref = getattr(jmon, name)(window, slots=slots, nan_strategy=strategy)
        for x, valid in batches:
            if name == "WindowedMean":
                wt = (rng.random(x.size) + 0.5).astype(np.float32)
                port.update(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(valid))
                ref.update(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(valid))
            else:
                port.update(torch.from_numpy(x), torch.from_numpy(valid))
                ref.update(jnp.asarray(x), jnp.asarray(valid))
            _assert_states(port, ref)
            np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=RTOL, atol=RTOL)


def test_decayed_mean_equals_jax():
    batches = _stream(6)
    port, ref = mon.DecayedMean(half_life=2.5, device="cpu"), jmon.DecayedMean(half_life=2.5)
    for i, (x, valid) in enumerate(batches):
        wt = np.full(x.size, 0.5 + i, np.float32)
        if x.size:
            wt[-1] = np.nan
        port.update(torch.from_numpy(x), torch.from_numpy(wt), valid=torch.from_numpy(valid))
        ref.update(jnp.asarray(x), jnp.asarray(wt), valid=jnp.asarray(valid))
        _assert_states(port, ref)
    port.update(2.0)
    ref.update(2.0)
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=RTOL)


def test_scalars_and_2d_batches_mask_rows_as_jax_does():
    """A per-row mask covers a 2-d batch's rows (the JAX ``_broadcast_rowmask``),
    and a scalar is a batch of one."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    valid = np.array([True, False, True, True])
    total = mon.WindowedSum(2, device="cpu")
    quantiles = mon.SketchQuantiles((0.0, 0.5, 1.0), window=2, device="cpu")
    for m in (total, quantiles):
        m.update(torch.from_numpy(x), torch.from_numpy(valid))
        m.update(7.0)
    assert float(total.compute()) == x[valid].sum() + 7.0
    flat = mon.SketchQuantiles((0.0, 0.5, 1.0), window=2, device="cpu")
    flat.update(torch.from_numpy(x[valid].reshape(-1)))
    flat.update(torch.tensor([7.0]))
    assert torch.equal(quantiles.merged_row(), flat.merged_row()) and torch.equal(quantiles.compute(), flat.compute())


def test_geometry_is_checked_as_jax_checks_it():
    cpu = {"device": "cpu"}
    for bad in (lambda: mon.WindowedMean(2.5, **cpu), lambda: mon.WindowedMean(torch.tensor(3), **cpu),
                lambda: mon.WindowedMean(0, **cpu), lambda: mon.WindowedSum(6, slots=4, **cpu),
                lambda: mon.WindowedMax(3, nan_strategy="warn", **cpu), lambda: mon.SketchQuantiles(window=5, slots=2, **cpu),
                lambda: mon.SketchQuantiles((1.5,), **cpu), lambda: mon.SketchLayout(levels=1),
                lambda: mon.SketchLayout(unit=float("inf")), lambda: mon.DecayedMean(half_life=0, **cpu),
                lambda: mon.DecayedMean(half_life=torch.tensor(2.0), **cpu)):
        with pytest.raises(TPUMetricsUserError):
            bad()
    assert mon.SketchQuantiles(window=12, device="cpu").slots == jmon.SketchQuantiles(window=12).slots == 6


def test_sketch_metrics_pickle_and_copy_mid_stream():
    m = mon.SketchQuantiles((0.5,), window=4, slots=2, device="cpu")
    m.update(torch.arange(1.0, 50.0))
    m.compute()
    for twin in (pickle.loads(pickle.dumps(m)), copy.deepcopy(m), m.clone()):
        twin.update(torch.arange(5.0))
        m2 = copy.deepcopy(m)
        m2.update(torch.arange(5.0))
        assert torch.equal(twin.sketch, m2.sketch) and torch.equal(twin.compute(), m2.compute())


def _members():
    return w.monitoring_members("cpu")


def test_fused_collection_of_every_member_equals_the_unfused_one():
    """The fused step's path on the CPU (first sighting eager, then the
    program's stand-in) gives the unfused collection's states bit for bit."""
    batches = w.monitoring_batches()
    plain = tpumetrics_torch.MetricCollection(_members(), device="cpu")
    fused = tpumetrics_torch.MetricCollection(_members(), fused_update=True, device="cpu")
    for x, valid in batches + batches:
        for col in (plain, fused):
            col.update(torch.from_numpy(x), torch.from_numpy(valid))
        want = export_state(plain)
        got = export_state(fused)
        for leader, states in want.items():
            for name, val in states.items():
                np.testing.assert_array_equal(got[leader][name], val)
    assert fused._fused_oo_step.counts["replayed"] > 0
    assert sorted(fused._fused_oo_step.leaders) == sorted(cg[0] for cg in fused.compute_groups.values())


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return w.run_worlds((2, 3), tmp_path_factory.mktemp("monitoring"), ["monitoring"])


def _whole_data():
    """The members fed every batch whole, in one process: the port's, and the
    JAX package's windowed aggregators."""
    port = _members()
    ref = {
        "mean": jmon.WindowedMean(w.MON_WINDOW, slots=w.MON_SLOTS),
        "max": jmon.WindowedMax(w.MON_WINDOW),
        "min": jmon.WindowedMin(w.MON_WINDOW),
        "decayed": jmon.DecayedMean(half_life=2.0),
    }
    for x, valid in w.monitoring_batches():
        for name in port:
            port[name].update(torch.from_numpy(x), torch.from_numpy(valid))
        for name in ref:
            ref[name].update(jnp.asarray(x), jnp.asarray(valid))
    return port, ref


@pytest.mark.parametrize("world", [2, 3])
def test_gloo_sync_of_sketch_states_is_the_sketch_of_the_whole_data(gloo, world):
    port, ref = _whole_data()
    whole = {name: export_state(m) for name, m in port.items()}
    for res in gloo[world]:
        synced = res["monitoring"]["synced"]
        for name in ("quantiles", "cumulative", "psi"):
            np.testing.assert_array_equal(synced[name]["sketch"], whole[name]["sketch"])
        for name in whole:
            assert int(synced[name].get("count", 0)) == int(whole[name].get("count", 0))
        for name in ("max", "min"):
            np.testing.assert_array_equal(synced[name][f"slot_{name}"], whole[name][f"slot_{name}"])
        for name, states in (("mean", ("slot_sum", "slot_weight")), ("decayed", ("decayed_sum", "decayed_weight"))):
            for s in states:
                np.testing.assert_allclose(synced[name][s], whole[name][s], rtol=RTOL, atol=RTOL)
        values = res["monitoring"]["values"]
        for name in ("quantiles", "cumulative", "psi"):  # the data has bucket-edge integers: the port's own sketch
            np.testing.assert_array_equal(values[name], port[name].compute().numpy())
        for name in ("mean", "max", "min", "decayed"):
            np.testing.assert_allclose(values[name], np.asarray(ref[name].compute()), rtol=RTOL, atol=RTOL)
