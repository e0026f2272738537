"""The aggregation metrics, the running window and metric arithmetic of the
port held against the JAX package, with ``tests/test_aggregation.py`` as the
case list: every aggregator under every ``nan_strategy``, on the same
seeded inputs.

Tolerances: ``max``/``min``/``cat`` exact; sums and means within 1e-6,
relative to the value where it exceeds 1 (float32 sums in another order).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.aggregation as jagg
import tpumetrics_torch
import tpumetrics_torch.aggregation as agg
from tpumetrics_torch.interop import export_state, load_state

ATOL = RTOL = 1e-6
NAMES = ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric", "RunningMean", "RunningSum"]
STRATEGIES = ["error", "warn", "ignore", "disable", 10.0]


def _batches(seed=0, nan=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(5):
        x = rng.normal(size=7).astype(np.float32)
        wt = (rng.random(7) + 0.5).astype(np.float32)
        if nan and i == 2:
            x[3] = np.nan
        if nan and i == 3:
            wt[0] = np.nan
        out.append((x, wt))
    return out


def _make(pkg, name, strategy):
    kw = {} if pkg is jagg else {"device": "cpu"}
    if name.startswith("Running"):
        return getattr(pkg, name)(window=3, nan_strategy=strategy, **kw)
    return getattr(pkg, name)(nan_strategy=strategy, **kw)


def _run(pkg, name, strategy, batches):
    """Feed every batch; returns the value, or the error's type if one was raised."""
    metric = _make(pkg, name, strategy)
    conv = jnp.asarray if pkg is jagg else torch.from_numpy
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            for x, wt in batches:
                if name == "MeanMetric":
                    metric.update(conv(x), conv(wt))
                else:
                    metric.update(conv(x))
        except RuntimeError as err:
            return type(err), str(err)
        return np.asarray(metric.compute())


@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_aggregator_matches_jax_under_every_nan_strategy(name, strategy):
    batches = _batches()
    got, want = _run(agg, name, strategy, batches), _run(jagg, name, strategy, batches)
    if isinstance(want, tuple):  # "error" on a NaN
        assert got == want
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    if name in ("MaxMetric", "MinMetric", "CatMetric"):
        assert np.array_equal(got, want, equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("name", NAMES)
def test_aggregator_without_nans_matches_jax(name):
    batches = _batches(seed=1, nan=False)
    got, want = _run(agg, name, "error", batches), _run(jagg, name, "error", batches)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cat_metric_and_weighted_mean_match_jax():
    cat, jcat = agg.CatMetric(device="cpu"), jagg.CatMetric()
    for v in (1.0, [2.0, 3.0]):
        cat.update(torch.tensor(v))
        jcat.update(jnp.asarray(v))
    assert cat.compute().tolist() == np.asarray(jcat.compute()).tolist() == [1.0, 2.0, 3.0]
    mean, jmean = agg.MeanMetric(device="cpu"), jagg.MeanMetric()
    for v, wt in ((1.0, 2.0), (3.0, 6.0)):
        mean.update(v, weight=wt)
        jmean.update(v, weight=wt)
    assert float(mean.compute()) == float(jmean.compute()) == 2.5


def test_float_and_disable_strategies_leave_the_host_out():
    """A float nan_strategy and "disable" make no host read in update: a
    lazy NaN-bearing input goes through without being inspected."""
    for strategy in (10.0, "disable"):
        metric = agg.SumMetric(nan_strategy=strategy, device="cpu")
        reads = []
        real_any = torch.Tensor.any
        torch.Tensor.any = lambda self, *a, **k: reads.append(1) or real_any(self, *a, **k)
        try:
            metric.update(torch.tensor([1.0, float("nan")]))
        finally:
            torch.Tensor.any = real_any
        assert reads == []
    with pytest.raises(RuntimeError, match="nan"):
        agg.SumMetric(nan_strategy="error", device="cpu").update(torch.tensor([1.0, float("nan")]))


def test_invalid_nan_strategy():
    with pytest.raises(ValueError, match="nan_strategy"):
        agg.SumMetric(nan_strategy="whatever", device="cpu")


@pytest.mark.parametrize("window", [1, 2, 3])
def test_running_forward_and_compute_match_jax(window):
    port = agg.RunningSum(window=window, device="cpu")
    ref = jagg.RunningSum(window=window)
    got = [float(port(torch.tensor(float(i)))) for i in range(6)]
    want = [float(ref(jnp.asarray(float(i)))) for i in range(6)]
    assert got == want
    assert float(port.compute()) == float(ref.compute())
    port.reset()
    assert float(port.compute()) == 0.0


def test_running_refuses_full_state_update_metrics():
    with pytest.raises(ValueError, match="full_state_update"):
        tpumetrics_torch.wrappers.Running(agg.MaxMetric(device="cpu"))
    with pytest.raises(ValueError, match="window"):
        tpumetrics_torch.wrappers.Running(agg.SumMetric(device="cpu"), window=0)


_OPS = [
    ("add", lambda a, b: a + b), ("sub", lambda a, b: a - b), ("mul", lambda a, b: a * b),
    ("truediv", lambda a, b: a / b), ("floordiv", lambda a, b: a // b), ("mod", lambda a, b: a % b),
    ("pow", lambda a, b: a**b), ("radd", lambda a, b: 2.0 + a), ("rsub", lambda a, b: 2.0 - a),
    ("rmul", lambda a, b: 2.0 * a), ("rtruediv", lambda a, b: 2.0 / a), ("rpow", lambda a, b: 2.0**a),
    ("ge", lambda a, b: a >= b), ("gt", lambda a, b: a > b), ("le", lambda a, b: a <= b),
    ("lt", lambda a, b: a < b), ("eq", lambda a, b: a == b), ("ne", lambda a, b: a != b),
    ("abs", lambda a, b: abs(a)), ("neg", lambda a, b: -a), ("pos", lambda a, b: +a),
]


@pytest.mark.parametrize("op", _OPS, ids=[o[0] for o in _OPS])
def test_compositional_metric_matches_jax(op):
    _, fn = op
    port = fn(agg.SumMetric(device="cpu"), agg.MeanMetric(device="cpu"))
    ref = fn(jagg.SumMetric(), jagg.MeanMetric())
    assert isinstance(port, tpumetrics_torch.CompositionalMetric)
    for x in ([1.5, -2.0, 4.0], [0.5, 3.0]):
        port.update(torch.tensor(x))
        ref.update(jnp.asarray(x))
    got, want = port.compute(), np.asarray(ref.compute())
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    port.reset()
    child = port.metric_a if isinstance(port.metric_a, tpumetrics_torch.Metric) else port.metric_b
    assert child.update_count == 0


def test_compositional_forward_and_functional_bridge_match_jax():
    port = agg.SumMetric(device="cpu") + 1
    ref = jagg.SumMetric() + 1
    assert float(port(torch.tensor([2.0, 3.0]))) == float(ref(jnp.asarray([2.0, 3.0]))) == 6.0
    state = port.functional_update(port.init_state(), torch.tensor([1.0, 4.0]))
    jstate = ref.functional_update(ref.init_state(), jnp.asarray([1.0, 4.0]))
    assert float(port.functional_compute(state)) == float(ref.functional_compute(jstate)) == 6.0


@pytest.mark.parametrize("name", ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric"])
def test_aggregation_states_carry_between_the_packages(name):
    batches = _batches(seed=4, nan=False)
    ref = getattr(jagg, name)()
    for x, _ in batches:
        ref.update(jnp.asarray(x))
    state = {k: ([np.asarray(v) for v in getattr(ref, k)] if isinstance(getattr(ref, k), list) else np.asarray(getattr(ref, k))) for k in ref._defaults}
    port = getattr(agg, name)(device="cpu")
    load_state(port, state)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # compute with no update of the port's own
        np.testing.assert_allclose(np.asarray(port.compute()), np.asarray(ref.compute()), rtol=0, atol=0)
    back = export_state(port)
    for k, v in state.items():
        if isinstance(v, list):
            assert all(np.array_equal(a, b) for a, b in zip(back[k], v))
        else:
            assert back[k].dtype == v.dtype and np.array_equal(back[k], v)


def test_top_level_names_match_the_jax_package():
    for name in ("SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric", "RunningMean", "RunningSum",
                 "CompositionalMetric"):
        assert hasattr(tpumetrics, name) and name in tpumetrics_torch.__all__
