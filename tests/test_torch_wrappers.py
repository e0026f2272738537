"""The port's wrappers held against the JAX package on the CPU:
``MinMaxMetric``, ``MultioutputWrapper``, ``ClasswiseWrapper``,
``MultitaskWrapper``, ``BootStrapper`` and ``MetricTracker``, eager and
through their functional bridges, and ``interop.load_state``/``export_state``
of the bridges' states.

Tolerances: int32 states exact; float32 sums and values within ``RTOL`` =
1e-6 relative (``ATOL`` = 1e-6 absolute near zero); correlations within
``CORR_TOL`` = 1e-5. The bootstrap's resamples come from the same numpy
generator in both packages, so its statistics agree within ``RTOL`` too.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.classification as jax_cls
import tpumetrics.regression as jax_reg
import tpumetrics.wrappers as jax_wrap
import tpumetrics_torch.classification as cls
import tpumetrics_torch.regression as reg
import tpumetrics_torch.wrappers as wrap
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.interop import export_state, load_state
from tpumetrics_torch.parallel import NoOpBackend
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

RTOL = 1e-6
ATOL = 1e-6
CORR_TOL = 1e-5


def _data(n=48, d=3, seed=0, nan_rows=()):
    rng = np.random.default_rng(seed)
    target = rng.normal(size=(n, d)).astype(np.float32)
    preds = (target + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    for row, col in nan_rows:
        preds[row, col] = np.nan
    return preds, target


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], rtol, atol)
        return
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    assert np.shape(got) == np.shape(want), (np.shape(got), np.shape(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def _to_numpy_tree(x):
    """A JAX state as numpy leaves (``interop``'s format)."""
    if isinstance(x, dict):
        return {k: _to_numpy_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_numpy_tree(v) for v in x]
    return np.asarray(x)


def _to_jax_tree(x):
    if isinstance(x, dict):
        return {k: _to_jax_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_jax_tree(v) for v in x]
    return jnp.asarray(x)


def _assert_same_tree(got, want):
    """int32 leaves exact, float32 leaves within RTOL, same structure."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
        return
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ MinMaxMetric


def test_minmax_tracks_extrema_over_computes_as_jax():
    port = wrap.MinMaxMetric(reg.MeanAbsoluteError(device="cpu"))
    ref = jax_wrap.MinMaxMetric(jax_reg.MeanAbsoluteError())
    assert port.device == torch.device("cpu")
    for s in range(4):
        p, t = _data(seed=s)
        p = p * (1 + s % 2)  # the error grows and shrinks between computes
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
        _close(port.compute(), ref.compute())
    _close({"min_val": port.min_val, "max_val": port.max_val}, {"min_val": ref.min_val, "max_val": ref.max_val})
    p, t = _data(seed=9)
    _close(port(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)))
    port.reset()
    assert float(port.min_val) == float("inf") and port._base_metric.update_count == 0
    with pytest.raises(RuntimeError, match="scalar"):
        bad = wrap.MinMaxMetric(reg.MeanSquaredError(num_outputs=3, device="cpu"))
        bad.update(torch.from_numpy(p), torch.from_numpy(t))
        bad.compute()
    with pytest.raises(ValueError, match="Metric"):
        wrap.MinMaxMetric(3.0)


def test_minmax_functional_bridge_matches_jax():
    port = wrap.MinMaxMetric(reg.MeanSquaredError(device="cpu"))
    ref = jax_wrap.MinMaxMetric(jax_reg.MeanSquaredError())
    ps, rs = port.init_state(), ref.init_state()
    assert sorted(ps) == ["base", "max_val", "min_val"]
    for s in range(3):
        p, t = _data(d=1, seed=s)
        p = p[:, 0] * (3 - s)
        ps, pstats = port.functional_forward(ps, torch.from_numpy(p), torch.from_numpy(t[:, 0]))
        rs, rstats = ref.functional_forward(rs, jnp.asarray(p), jnp.asarray(t[:, 0]))
        _close(pstats, rstats)
    ps = port.functional_update(ps, torch.from_numpy(p), torch.from_numpy(t[:, 0]))
    rs = ref.functional_update(rs, jnp.asarray(p), jnp.asarray(t[:, 0]))
    _close(port.functional_compute(ps), ref.functional_compute(rs))

    class Synced(NoOpBackend):  # one rank that syncs: every collective is the identity
        def available(self):
            return True

    _assert_same_tree(export_state_tree(port.sync_state(ps, Synced())), _to_numpy_tree(rs))


def export_state_tree(state):
    """A port functional state as numpy leaves."""
    if isinstance(state, dict):
        return {k: export_state_tree(v) for k, v in state.items()}
    if isinstance(state, list):
        return [export_state_tree(v) for v in state]
    return state.numpy()


# ------------------------------------------------------ MultioutputWrapper


@pytest.mark.parametrize("remove_nans", [True, False])
def test_multioutput_with_nan_rows_matches_jax(remove_nans):
    """NaN preds in rows 3, 10 (output 0) and 20 (output 2): with
    ``remove_nans`` each output drops its NaN rows, without it the NaNs reach
    the inner metrics (their values turn NaN, as in the JAX package)."""
    port = wrap.MultioutputWrapper(reg.R2Score(device="cpu"), num_outputs=3, remove_nans=remove_nans)
    ref = jax_wrap.MultioutputWrapper(jax_reg.R2Score(), num_outputs=3, remove_nans=remove_nans)
    for s in range(2):
        p, t = _data(seed=s, nan_rows=[(3, 0), (10, 0), (20, 2)])
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    _close(port.compute(), ref.compute())
    for mp, mr in zip(port.metrics, ref.metrics):
        assert int(mp.total) == int(mr.total)
    p, t = _data(seed=5)
    _close(port(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)))
    port.reset()
    assert all(m.update_count == 0 for m in port.metrics)


def test_multioutput_functional_bridge_matches_jax_and_refuses_nan_removal():
    port = wrap.MultioutputWrapper(reg.MeanAbsoluteError(device="cpu"), num_outputs=3, remove_nans=False)
    ref = jax_wrap.MultioutputWrapper(jax_reg.MeanAbsoluteError(), num_outputs=3, remove_nans=False)
    ps, rs = port.init_state(), ref.init_state()
    assert isinstance(ps, list) and len(ps) == 3
    for s in range(2):
        p, t = _data(seed=s)
        ps = port.functional_update(ps, torch.from_numpy(p), torch.from_numpy(t))
        rs = ref.functional_update(rs, jnp.asarray(p), jnp.asarray(t))
    _assert_same_tree(export_state_tree(ps), _to_numpy_tree(rs))
    _close(port.functional_compute(ps), ref.functional_compute(rs))
    new, batch_val = port.functional_forward(ps, torch.from_numpy(p), torch.from_numpy(t))
    rnew, rbatch = ref.functional_forward(rs, jnp.asarray(p), jnp.asarray(t))
    _close(batch_val, rbatch)
    _assert_same_tree(export_state_tree(new), _to_numpy_tree(rnew))
    with pytest.raises(TPUMetricsUserError, match="remove_nans=False"):
        wrap.MultioutputWrapper(reg.MeanAbsoluteError(device="cpu"), num_outputs=3).init_state()


# ------------------------------------------------------ ClasswiseWrapper


@pytest.mark.parametrize(("labels", "prefix", "postfix"), [
    (None, None, None), (["horse", "fish", "dog"], None, None), (None, "acc_", None), (["a", "b", "c"], "p-", "-q"),
])
def test_classwise_keys_and_values_match_jax(labels, prefix, postfix):
    rng = np.random.default_rng(1)
    preds, target = rng.integers(0, 3, 40), rng.integers(0, 3, 40)
    port = wrap.ClasswiseWrapper(
        cls.MulticlassAccuracy(num_classes=3, average=None, device="cpu"), labels=labels, prefix=prefix, postfix=postfix
    )
    ref = jax_wrap.ClasswiseWrapper(jax_cls.MulticlassAccuracy(num_classes=3, average=None), labels=labels,
                                    prefix=prefix, postfix=postfix)
    _close(port(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target)))
    port.update(torch.from_numpy(preds[::2]), torch.from_numpy(target[::2]))
    ref.update(jnp.asarray(preds[::2]), jnp.asarray(target[::2]))
    _close(port.compute(), ref.compute())


def test_classwise_over_per_target_r2_and_its_bridge_match_jax():
    labels = ["mu", "alpha", "homo"]
    port = wrap.ClasswiseWrapper(reg.R2Score(num_outputs=3, multioutput="raw_values", device="cpu"), labels=labels)
    ref = jax_wrap.ClasswiseWrapper(jax_reg.R2Score(num_outputs=3, multioutput="raw_values"), labels=labels)
    ps, rs = port.init_state(), ref.init_state()
    for s in range(2):
        p, t = _data(seed=s)
        ps = port.functional_update(ps, torch.from_numpy(p), torch.from_numpy(t))
        rs = ref.functional_update(rs, jnp.asarray(p), jnp.asarray(t))
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    _close(port.functional_compute(ps), ref.functional_compute(rs))
    _close(port.compute(), ref.compute())
    assert sorted(port.compute()) == ["r2score_alpha", "r2score_homo", "r2score_mu"]
    with pytest.raises(ValueError, match="entries"):
        wrap.ClasswiseWrapper(reg.R2Score(num_outputs=3, multioutput="raw_values", device="cpu"), labels=["x"])._convert(
            torch.zeros(3)
        )


# ------------------------------------------------------ MultitaskWrapper


def _multitask(pkg_reg, collection_cls, **kw):
    return {
        "u0": pkg_reg.MeanAbsoluteError(**kw),
        "all": pkg_reg.MeanSquaredError(num_outputs=3, **kw),
        "pair": collection_cls({"mse": pkg_reg.MeanSquaredError(**kw), "mae": pkg_reg.MeanAbsoluteError(**kw)}, **kw),
    }


def _task_batch(seed):
    p, t = _data(seed=seed)
    return {"u0": p[:, 1], "all": p, "pair": p[:, 2]}, {"u0": t[:, 1], "all": t, "pair": t[:, 2]}


def test_multitask_routes_tasks_and_matches_jax():
    port = wrap.MultitaskWrapper(_multitask(reg, MetricCollection, device="cpu"))
    ref = jax_wrap.MultitaskWrapper(_multitask(jax_reg, tpumetrics.MetricCollection))
    for s in range(2):
        tp, tt = _task_batch(s)
        port.update({k: torch.from_numpy(v) for k, v in tp.items()}, {k: torch.from_numpy(v) for k, v in tt.items()})
        ref.update({k: jnp.asarray(v) for k, v in tp.items()}, {k: jnp.asarray(v) for k, v in tt.items()})
    _close(port.compute(), ref.compute())
    tp, tt = _task_batch(7)
    _close(port({k: torch.from_numpy(v) for k, v in tp.items()}, {k: torch.from_numpy(v) for k, v in tt.items()}),
           ref({k: jnp.asarray(v) for k, v in tp.items()}, {k: jnp.asarray(v) for k, v in tt.items()}))
    with pytest.raises(ValueError, match="same keys"):
        port.update({"u0": torch.zeros(2)}, {"u0": torch.zeros(2)})
    with pytest.raises(TypeError):
        wrap.MultitaskWrapper({"x": 3})


def test_multitask_functional_bridge_matches_jax():
    port = wrap.MultitaskWrapper(_multitask(reg, MetricCollection, device="cpu"))
    ref = jax_wrap.MultitaskWrapper(_multitask(jax_reg, tpumetrics.MetricCollection))
    ps, rs = port.init_state(), ref.init_state()
    for s in range(2):
        tp, tt = _task_batch(s)
        ps = port.functional_update(ps, {k: torch.from_numpy(v) for k, v in tp.items()},
                                    {k: torch.from_numpy(v) for k, v in tt.items()})
        rs = ref.functional_update(rs, {k: jnp.asarray(v) for k, v in tp.items()}, {k: jnp.asarray(v) for k, v in tt.items()})
    _assert_same_tree(export_state_tree(ps), _to_numpy_tree(rs))
    _close(port.functional_compute(ps), ref.functional_compute(rs))
    _, pb = port.functional_forward(ps, {k: torch.from_numpy(v) for k, v in tp.items()},
                                    {k: torch.from_numpy(v) for k, v in tt.items()})
    _, rb = ref.functional_forward(rs, {k: jnp.asarray(v) for k, v in tp.items()}, {k: jnp.asarray(v) for k, v in tt.items()})
    _close(pb, rb)


# ------------------------------------------------------------ BootStrapper


@pytest.mark.parametrize("strategy", ["multinomial", "poisson"])
def test_bootstrapper_with_a_seed_matches_jax_and_a_numpy_replay(strategy):
    """One seed, one numpy generator, the same resamples in both packages:
    mean, std (ddof 1), quantiles and raw values agree, and equal a numpy
    replay of the same draws within RTOL."""
    kw = {"num_bootstraps": 7, "quantile": [0.1, 0.5, 0.9], "raw": True, "sampling_strategy": strategy, "seed": 123}
    port = wrap.BootStrapper(reg.MeanSquaredError(device="cpu"), **kw)
    ref = jax_wrap.BootStrapper(jax_reg.MeanSquaredError(), **kw)
    batches = [_data(n=40, d=1, seed=s) for s in range(3)]
    for p, t in batches:
        port.update(torch.from_numpy(p[:, 0]), torch.from_numpy(t[:, 0]))
        ref.update(jnp.asarray(p[:, 0]), jnp.asarray(t[:, 0]))
    got, want = port.compute(), ref.compute()
    _close(got, want)

    from tpumetrics_torch.wrappers.bootstrapping import _bootstrap_sampler

    rng = np.random.default_rng(123)
    sse, count = np.zeros(7), np.zeros(7)
    for p, t in batches:
        for b in range(7):
            idx = _bootstrap_sampler(40, strategy, rng)
            err = (p[idx, 0].astype(np.float64) - t[idx, 0]) ** 2
            sse[b] += err.sum()
            count[b] += len(idx)
    vals = sse / count
    np.testing.assert_allclose(_np(got["raw"]), vals, rtol=RTOL)
    np.testing.assert_allclose(_np(got["mean"]), vals.mean(), rtol=RTOL)
    np.testing.assert_allclose(_np(got["std"]), vals.std(ddof=1), rtol=1e-5)
    port.reset()
    assert all(m.update_count == 0 for m in port.metrics)
    with pytest.raises(ValueError, match="sampling_strategy"):
        wrap.BootStrapper(reg.MeanSquaredError(device="cpu"), sampling_strategy="stratified")
    with pytest.raises(ValueError, match="tensors"):
        port.update(3.0)


def test_bootstrapper_has_no_functional_bridge():
    with pytest.raises(TPUMetricsUserError, match="functional bridge"):
        wrap.BootStrapper(reg.MeanSquaredError(device="cpu")).init_state()


# ------------------------------------------------------------ MetricTracker


def test_tracker_of_a_metric_with_maximize_as_a_bool_matches_jax():
    for maximize in (True, False):
        port = wrap.MetricTracker(reg.MeanAbsoluteError(device="cpu"), maximize=maximize)
        ref = jax_wrap.MetricTracker(jax_reg.MeanAbsoluteError(), maximize=maximize)
        for step in range(4):
            port.increment()
            ref.increment()
            p, t = _data(d=1, seed=step)
            p = p * (1 + abs(step - 1))
            port.update(torch.from_numpy(p[:, 0]), torch.from_numpy(t[:, 0]))
            ref.update(jnp.asarray(p[:, 0]), jnp.asarray(t[:, 0]))
        _close(port.compute_all(), ref.compute_all())
        got, want = port.best_metric(return_step=True), ref.best_metric(return_step=True)
        assert got[1] == want[1]
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
        assert port.n_steps == 4


def test_tracker_of_a_collection_with_maximize_as_a_list_matches_jax():
    """Per-key best values and steps, R2 maximised and RSE minimised; the
    noise shrinks each epoch, so both name the last."""

    def col(pkg, collection_cls, **kw):
        return collection_cls({"r2": pkg.R2Score(num_outputs=3, **kw), "rse": pkg.RelativeSquaredError(num_outputs=3, **kw)},
                              **kw)

    port = wrap.MetricTracker(col(reg, MetricCollection, device="cpu"), maximize=[True, False])
    ref = jax_wrap.MetricTracker(col(jax_reg, tpumetrics.MetricCollection), maximize=[True, False])
    rng = np.random.default_rng(3)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    for epoch in range(3):
        port.increment()
        ref.increment()
        p = (t + (0.8 - 0.3 * epoch) * rng.normal(size=t.shape)).astype(np.float32)
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    got, want = port.best_metric(return_step=True), ref.best_metric(return_step=True)
    assert got[1] == want[1] == {"r2": 2, "rse": 2}
    _close(got[0], want[0])
    _close(port.compute_all(), ref.compute_all())


def test_tracker_with_tuple_and_vector_values_as_jax():
    """A vector value has no single best: that key is None, with a warning,
    in both packages. Kendall's (tau, p-value) tuples do not stack into a
    history: ``compute_all`` raises ``TypeError`` in both."""

    def run(tracker, conv):
        for s in range(2):
            tracker.increment()
            p, t = _data(seed=s)
            tracker.update(conv(p), conv(t))
        return tracker

    vector = {"kendall": reg.KendallRankCorrCoef(num_outputs=3, device="cpu")}
    port = run(wrap.MetricTracker(MetricCollection(vector, device="cpu")), torch.from_numpy)
    ref = run(wrap_jax_tracker({"kendall": jax_reg.KendallRankCorrCoef(num_outputs=3)}), jnp.asarray)
    _close(port.compute_all(), ref.compute_all(), CORR_TOL, CORR_TOL)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert port.best_metric(return_step=True) == ({"kendall": None}, {"kendall": None})
    assert caught
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert ref.best_metric(return_step=True) == ({"kendall": None}, {"kendall": None})

    tupled = {"kendall": reg.KendallRankCorrCoef(num_outputs=3, t_test=True, device="cpu")}
    port = run(wrap.MetricTracker(MetricCollection(tupled, device="cpu")), torch.from_numpy)
    ref = run(wrap_jax_tracker({"kendall": jax_reg.KendallRankCorrCoef(num_outputs=3, t_test=True)}), jnp.asarray)
    for tracker in (port, ref):
        with pytest.raises(TypeError):
            tracker.compute_all()


def wrap_jax_tracker(members):
    return jax_wrap.MetricTracker(tpumetrics.MetricCollection(members))


def test_tracker_argument_checks_and_increment_guard():
    with pytest.raises(TypeError):
        wrap.MetricTracker(3)
    with pytest.raises(ValueError, match="single bool"):
        wrap.MetricTracker(reg.MeanAbsoluteError(device="cpu"), maximize=[True])
    with pytest.raises(ValueError, match="length"):
        wrap.MetricTracker(MetricCollection({"a": reg.MeanAbsoluteError(device="cpu")}, device="cpu"), maximize=[True, False])
    tracker = wrap.MetricTracker(reg.MeanAbsoluteError(device="cpu"))
    for method in ("update", "compute", "compute_all"):
        with pytest.raises(TPUMetricsUserError, match="increment"):
            getattr(tracker, method)() if method != "update" else tracker.update(torch.zeros(1), torch.zeros(1))


# ------------------------------------------------------------ interop


def _wrapper_pairs():
    """(port wrapper, JAX wrapper, batch maker) with bridges."""
    return [
        (wrap.MinMaxMetric(reg.MeanSquaredError(device="cpu")), jax_wrap.MinMaxMetric(jax_reg.MeanSquaredError()),
         lambda p, t: (p[:, 0], t[:, 0])),
        (wrap.MultioutputWrapper(reg.MeanAbsoluteError(device="cpu"), 3, remove_nans=False),
         jax_wrap.MultioutputWrapper(jax_reg.MeanAbsoluteError(), 3, remove_nans=False), lambda p, t: (p, t)),
        (wrap.ClasswiseWrapper(reg.PearsonCorrCoef(num_outputs=3, device="cpu"), labels=["a", "b", "c"]),
         jax_wrap.ClasswiseWrapper(jax_reg.PearsonCorrCoef(num_outputs=3), labels=["a", "b", "c"]), lambda p, t: (p, t)),
        (wrap.MultitaskWrapper({"x": reg.MeanSquaredError(device="cpu"), "y": reg.R2Score(device="cpu")}),
         jax_wrap.MultitaskWrapper({"x": jax_reg.MeanSquaredError(), "y": jax_reg.R2Score()}),
         lambda p, t: ({"x": p[:, 0], "y": p[:, 1]}, {"x": t[:, 0], "y": t[:, 1]})),
    ]


def _to(x, fn):
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


@pytest.mark.parametrize("index", range(4), ids=["minmax", "multioutput", "classwise", "multitask"])
def test_wrapper_bridge_states_round_trip_between_packages(index):
    """A JAX bridge state loads into the eager port wrapper and computes the
    JAX value; the port's exported state computes its value through the JAX
    functional compute, and has the JAX state's structure and dtypes."""
    port, ref, batch = _wrapper_pairs()[index]
    state = ref.init_state()
    for s in range(2):
        p, t = batch(*_data(seed=s))
        state = ref.functional_update(state, _to(p, jnp.asarray), _to(t, jnp.asarray))
        port.update(_to(p, torch.from_numpy), _to(t, torch.from_numpy))
    if isinstance(ref, jax_wrap.MinMaxMetric):  # observe a value, so the extrema are finite
        state, _ = ref.functional_forward(state, _to(p, jnp.asarray), _to(t, jnp.asarray))
        port.update(_to(p, torch.from_numpy), _to(t, torch.from_numpy))
        port.compute()
    exported = export_state(port)
    _assert_same_tree(exported, _to_numpy_tree(state))
    _close(port.compute(), ref.functional_compute(_to_jax_tree(exported)), CORR_TOL, CORR_TOL)
    fresh, _, _ = _wrapper_pairs()[index]
    load_state(fresh, _to_numpy_tree(state))
    for m in (getattr(fresh, "metrics", None) or [getattr(fresh, "_base_metric", None) or getattr(fresh, "metric", None)]
              if not isinstance(fresh, wrap.MultitaskWrapper) else fresh.task_metrics.values()):
        m._update_count = 1
    _close(fresh.compute(), ref.functional_compute(state), CORR_TOL, CORR_TOL)
