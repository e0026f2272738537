"""The port's regression domain held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through each JAX function or
class and its counterpart in ``tpumetrics_torch``. Tolerances:

- int32 states (counts) exact;
- float32 sum states within ``RTOL`` = 1e-6 relative, with an absolute
  floor of 1e-6 times the sum of the absolute terms, for sums that cancel
  (``Σ(t - p)``, ``Σ t`` of a centred column): the two packages add in
  other orders;
- errors, R2, explained variance, cosine similarity and KL divergence within
  ``RTOL`` relative (``ATOL`` = 1e-6 absolute near zero);
- correlations (Pearson, concordance, Spearman, Kendall's tau) within
  ``CORR_TOL`` = 1e-5;
- KL divergence's per-sample list state within ``RTOL`` relative and
  ``KL_ATOL`` = 1e-7 absolute (its terms, of size up to 1, cancel near 0);
- Kendall's p-value within ``P_ATOL`` = 1e-6 absolute (``torch.special.ndtr``
  against ``jax.scipy.stats.norm``);
- Spearman's average ranks bit for bit where the JAX tie sums are exact
  (below 2^24), and equal to a float64 oracle past that, where the JAX ones
  round; Kendall's pair count bit for bit, also past 2^24.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import tpumetrics
import tpumetrics.functional.regression as jax_fr
import tpumetrics.regression as jax_reg
import tpumetrics_torch
import tpumetrics_torch.functional.regression as fr
import tpumetrics_torch.regression as reg
from tpumetrics.functional.regression import kendall as jax_kendall
from tpumetrics.functional.regression import pearson as jax_pearson
from tpumetrics.functional.regression import spearman as jax_spearman
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.functional.regression import kendall as kendall
from tpumetrics_torch.functional.regression import pearson as pearson
from tpumetrics_torch.functional.regression import spearman as spearman
from tpumetrics_torch.interop import export_state, load_state

RTOL = 1e-6
ATOL = 1e-6
CORR_TOL = 1e-5
P_ATOL = 1e-6
KL_ATOL = 1e-7  # float32 rounding of terms of size <= 1: KL's per-sample values near 0 cancel
N = 192  # rows of a functional case; the modular cases feed 3 batches of 64


def _data(kind, n=N, d=1, seed=0):
    """``(preds, target)`` float32 of shape ``(n,)`` or ``(n, d)``:
    "normal" (unit noise around a normal target), "ties" (both on a grid of
    halves, many ties), "positive" (in [0.5, 5], for the log, percentage and
    Tweedie errors) and "constant" (a constant target column)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if d == 1 else (n, d)
    target = rng.normal(size=shape)
    if kind == "ties":
        target = np.round(target * 2) / 2
        preds = np.round((target + rng.normal(size=shape)) * 2) / 2
    elif kind == "positive":
        target = rng.integers(1, 11, size=shape) / 2
        preds = np.clip(target + 0.5 * rng.normal(size=shape), 0.5, 5.0)
    else:
        preds = target + 0.7 * rng.normal(size=shape)
    if kind == "constant":
        target = np.full(shape, 1.5)
    return preds.astype(np.float32), target.astype(np.float32)


def _both(x):
    return torch.from_numpy(np.asarray(x)), jnp.asarray(x)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x)


def _close(got, want, rtol, atol=ATOL):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], rtol, atol)
        return
    assert np.shape(got) == np.shape(want), (np.shape(got), np.shape(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def _assert_states(got, want, scale=None):
    """int32 states exact; float32 states within RTOL relative, with a floor
    of RTOL times ``scale[name]`` (the sum of the absolute terms) where given;
    list states entry by entry."""
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        val = got[name]
        if isinstance(ref, list):
            assert len(val) == len(ref)
            for v, r in zip(val, ref):
                if name == "measures":  # KL's per-sample values: sums of p log(p/q) terms of size <= 1
                    np.testing.assert_allclose(_np(v), np.asarray(r), rtol=RTOL, atol=KL_ATOL)
                else:  # the inputs themselves, appended
                    np.testing.assert_array_equal(_np(v), np.asarray(r))
            continue
        ref = np.asarray(ref)
        val = _np(val)
        if np.issubdtype(ref.dtype, np.floating):
            assert val.dtype == np.float32 and ref.dtype == np.float32
            floor = RTOL * np.asarray((scale or {}).get(name, 0.0))
            assert np.all(np.abs(val.astype(np.float64) - ref) <= RTOL * np.abs(ref) + floor), (name, val, ref)
        else:
            assert val.dtype == ref.dtype == np.int32, (name, val.dtype, ref.dtype)
            np.testing.assert_array_equal(val, ref)


# ------------------------------------------------------------ functional


FUNCTIONAL = {
    # name: (kinds, extra kwargs, tolerance, multi-output capable)
    "mean_squared_error": (("normal", "ties"), {}, RTOL, True),
    "mean_absolute_error": (("normal", "ties"), {}, RTOL, True),
    "mean_squared_log_error": (("positive",), {}, RTOL, False),
    "log_cosh_error": (("normal", "ties"), {}, RTOL, True),
    "minkowski_distance": (("normal",), {"p": 3}, RTOL, False),
    "mean_absolute_percentage_error": (("positive", "normal"), {}, RTOL, False),
    "symmetric_mean_absolute_percentage_error": (("positive", "normal"), {}, RTOL, False),
    "weighted_mean_absolute_percentage_error": (("positive", "normal"), {}, RTOL, False),
    "tweedie_deviance_score": (("positive",), {"power": 1.5}, RTOL, False),
    "r2_score": (("normal", "ties", "constant"), {}, RTOL, True),
    "relative_squared_error": (("normal", "ties"), {}, RTOL, True),
    "explained_variance": (("normal", "ties", "constant"), {}, RTOL, True),
    "pearson_corrcoef": (("normal", "ties"), {}, CORR_TOL, True),
    "concordance_corrcoef": (("normal", "ties"), {}, CORR_TOL, True),
    "spearman_corrcoef": (("normal", "ties"), {}, CORR_TOL, True),
    "kendall_rank_corrcoef": (("normal", "ties"), {}, CORR_TOL, True),
    "cosine_similarity": (("normal",), {"reduction": "mean"}, RTOL, True),
    "kl_divergence": (("positive",), {}, RTOL, True),
}
FUNCTIONAL_CASES = [
    (name, kind, d)
    for name, (kinds, _, _, multi) in FUNCTIONAL.items()
    for kind in kinds
    for d in ((1, 3) if multi else (1,))
    if not (name in ("cosine_similarity", "kl_divergence") and d == 1)  # 2-D inputs only
]


def test_exports_match_the_jax_package():
    assert sorted(fr.__all__) == sorted(jax_fr.__all__)
    assert sorted(reg.__all__) == sorted(jax_reg.__all__)
    import tpumetrics.functional as jax_functional
    import tpumetrics.wrappers as jax_wrappers

    import tpumetrics_torch.functional as functional
    import tpumetrics_torch.wrappers as wrappers

    assert sorted(wrappers.__all__) == sorted(jax_wrappers.__all__)
    jax_top = {n for n in tpumetrics.__all__ if n in set(jax_reg.__all__) | set(jax_wrappers.__all__)}
    assert jax_top <= set(tpumetrics_torch.__all__)
    assert set(jax_fr.__all__) <= set(functional.__all__) and set(jax_fr.__all__) <= set(jax_functional.__all__)


@pytest.mark.parametrize(("name", "kind", "d"), FUNCTIONAL_CASES)
def test_functional_matches_jax(name, kind, d):
    _, kwargs, tol, _ = FUNCTIONAL[name]
    preds, target = _data(kind, d=d, seed=len(name))
    (tp, jp), (tt, jt) = _both(preds), _both(target)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # constant columns warn in both packages
        got = getattr(fr, name)(tp, tt, **kwargs)
        want = getattr(jax_fr, name)(jp, jt, **kwargs)
    _close(got, want, tol)


@pytest.mark.parametrize("multioutput", ["raw_values", "uniform_average", "variance_weighted"])
@pytest.mark.parametrize("name", ["r2_score", "explained_variance"])
def test_multioutput_modes_match_jax(name, multioutput):
    preds, target = _data("normal", d=3, seed=4)
    (tp, jp), (tt, jt) = _both(preds), _both(target)
    _close(getattr(fr, name)(tp, tt, multioutput=multioutput), getattr(jax_fr, name)(jp, jt, multioutput=multioutput), RTOL)


@pytest.mark.parametrize("adjusted", [0, 3, 190, 191])
def test_adjusted_r2_and_its_fallbacks_match_jax(adjusted):
    preds, target = _data("normal", seed=5)
    (tp, jp), (tt, jt) = _both(preds), _both(target)
    with warnings.catch_warnings(record=True) as port_w:
        warnings.simplefilter("always")
        got = fr.r2_score(tp, tt, adjusted=adjusted)
    with warnings.catch_warnings(record=True) as jax_w:
        warnings.simplefilter("always")
        want = jax_fr.r2_score(jp, jt, adjusted=adjusted)
    _close(got, want, RTOL)
    assert len(port_w) == len(jax_w)


@pytest.mark.parametrize("squared", [True, False])
def test_rmse_and_rse_root_match_jax(squared):
    preds, target = _data("normal", d=3, seed=6)
    (tp, jp), (tt, jt) = _both(preds), _both(target)
    _close(fr.mean_squared_error(tp, tt, squared=squared, num_outputs=3),
           jax_fr.mean_squared_error(jp, jt, squared=squared, num_outputs=3), RTOL)
    _close(fr.relative_squared_error(tp, tt, squared=squared), jax_fr.relative_squared_error(jp, jt, squared=squared), RTOL)


@pytest.mark.parametrize("power", [0.0, 1.0, 2.0, 3.0, -1.0])
def test_tweedie_powers_match_jax(power):
    preds, target = _data("positive", seed=7)
    (tp, jp), (tt, jt) = _both(preds), _both(target)
    _close(fr.tweedie_deviance_score(tp, tt, power=power), jax_fr.tweedie_deviance_score(jp, jt, power=power), RTOL)


@pytest.mark.parametrize(("power", "preds", "targets"), [
    (1.0, [0.0, 1.0], [1.0, 1.0]), (1.0, [1.0, 1.0], [-1.0, 1.0]), (2.0, [1.0, 1.0], [0.0, 1.0]),
    (-1.0, [0.0, 1.0], [1.0, 1.0]), (1.5, [1.0, 1.0], [-1.0, 1.0]), (3.0, [1.0, 1.0], [0.0, 1.0]), (0.5, [1.0], [1.0]),
])
def test_tweedie_domain_checks_raise_as_in_jax(power, preds, targets):
    p, t = np.asarray(preds, np.float32), np.asarray(targets, np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_fr.tweedie_deviance_score(jnp.asarray(p), jnp.asarray(t), power=power)
    with pytest.raises(ValueError) as port_err:
        fr.tweedie_deviance_score(torch.from_numpy(p), torch.from_numpy(t), power=power)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
@pytest.mark.parametrize("log_prob", [False, True])
def test_kl_divergence_reductions_match_jax(reduction, log_prob):
    p, q = _data("positive", d=3, seed=8)
    if log_prob:
        p, q = np.log(p / p.sum(1, keepdims=True)), np.log(q / q.sum(1, keepdims=True))
    (tp, jp), (tq, jq) = _both(p), _both(q)
    _close(fr.kl_divergence(tp, tq, log_prob=log_prob, reduction=reduction),
           jax_fr.kl_divergence(jp, jq, log_prob=log_prob, reduction=reduction), RTOL)


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_cosine_similarity_reductions_match_jax(reduction):
    preds, target = _data("normal", d=3, seed=9)
    (tp, jp), (tt, jt) = _both(preds), _both(target)
    _close(fr.cosine_similarity(tp, tt, reduction=reduction), jax_fr.cosine_similarity(jp, jt, reduction=reduction), RTOL)


def test_input_checks_raise_as_in_jax():
    from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

    preds, target = _data("normal", d=3)
    tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
    with pytest.raises(ValueError, match="num_outputs"):
        reg.PearsonCorrCoef(num_outputs=2, device="cpu").update(tp, tt)
    with pytest.raises(ValueError, match="num_outputs"):
        reg.LogCoshError(device="cpu").update(tp, tt)
    with pytest.raises(RuntimeError, match="same shape"):
        fr.mean_absolute_error(tp, tt[:, :2])
    with pytest.raises(ValueError, match="floating point"):
        fr.spearman_corrcoef(tp.long(), tt.long())
    with pytest.raises(TPUMetricsUserError):
        fr.minkowski_distance(tp, tt, p=0.5)
    with pytest.raises(ValueError, match="variant"):
        fr.kendall_rank_corrcoef(tp, tt, variant="d")


# ---------------------------------------------------- ranks and pair counts


def test_spearman_ranks_are_bit_for_bit_the_jax_ones_where_their_sums_are_exact():
    """Grids of 2, 10 and 1000 values (groups of up to 550 ranks, sums under
    2^24), with NaNs, a column with no ties, and one with +-inf, NaN and
    -0.0 among its ties."""
    rng = np.random.default_rng(10)
    cols = [
        rng.integers(0, 2, 1100).astype(np.float32),
        (rng.integers(1, 11, 1100) / 2).astype(np.float32),
        rng.integers(0, 1000, 1100).astype(np.float32),
        rng.normal(size=1100).astype(np.float32),
    ]
    cols[1][::97] = np.nan
    edge = rng.integers(-2, 3, 1100).astype(np.float32)
    edge[::50], edge[1::50], edge[2::50], edge[3::50] = np.inf, -np.inf, np.nan, -0.0
    cols.append(edge)  # +-inf runs, NaNs (each its own run, ranked last), -0.0 in the run of 0.0
    for x in cols:
        got = spearman._rank_data(torch.from_numpy(x)).numpy()
        want = np.asarray(jax_spearman._rank_data(jnp.asarray(x)))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_spearman_ranks_past_2_to_the_24_equal_a_float64_oracle():
    """A half-star rating scale over 400,000 ratings: tie groups of some
    40,000 ranks whose sums (about 8e9) a float32 sum rounds. The closed form
    gives scipy's float64 average ranks exactly."""
    x = (np.random.default_rng(11).integers(1, 11, 400_000) / 2).astype(np.float32)
    got = spearman._rank_data(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), scipy.stats.rankdata(x))


@pytest.mark.parametrize("n", [511, 512, 513, 1025])
@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_kendall_across_the_chunk_edge_matches_jax(n, variant):
    rng = np.random.default_rng(n)
    x = np.round(rng.normal(size=n) * 4).astype(np.float32)
    y = np.round(x + 2 * rng.normal(size=n)).astype(np.float32)
    (tx, jx), (ty, jy) = _both(x), _both(y)
    tau, p = fr.kendall_rank_corrcoef(tx, ty, variant=variant, t_test=True)
    jtau, jp = jax_fr.kendall_rank_corrcoef(jx, jy, variant=variant, t_test=True)
    # the pair count and the tie sums are exact integers here, so tau is the JAX one bit for bit
    assert float(tau) == float(jtau)
    np.testing.assert_allclose(_np(p), np.asarray(jp), rtol=0, atol=P_ATOL)
    assert float(kendall._pair_stats(tx, ty)) == float(jax_kendall._pair_stats(jx, jy))
    for got, want in zip(kendall._tie_stats(tx), jax_kendall._tie_stats(jx)):
        assert float(got) == float(want)


@pytest.mark.parametrize("alternative", ["two-sided", "less", "greater"])
@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_kendall_p_values_of_every_alternative_match_jax(variant, alternative):
    preds, target = _data("ties", n=513, d=3, seed=12)
    target[:, 1] = np.random.default_rng(13).permutation(target[:, 1])  # no association: a p-value mid-range
    (tp, jp), (tt, jt) = _both(preds), _both(target)
    tau, p = fr.kendall_rank_corrcoef(tp, tt, variant=variant, t_test=True, alternative=alternative)
    jtau, jpv = jax_fr.kendall_rank_corrcoef(jp, jt, variant=variant, t_test=True, alternative=alternative)
    _close(tau, jtau, 0, CORR_TOL)
    np.testing.assert_allclose(_np(p), np.asarray(jpv), rtol=0, atol=P_ATOL)


def test_kendall_pair_count_past_2_to_the_24_is_the_jax_one_bit_for_bit():
    """n = 7000 strongly associated: the running float32 total passes 2^24
    and rounds; the port adds the exact chunk sums in the JAX order."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=7000).astype(np.float32)
    y = (x + 0.1 * rng.normal(size=7000)).astype(np.float32)
    got = float(kendall._pair_stats(torch.from_numpy(x), torch.from_numpy(y)))
    assert got > 2**24
    assert got == float(jax_kendall._pair_stats(jnp.asarray(x), jnp.asarray(y)))
    exact = sum(int((np.sign(x[i] - x[i + 1 :]) * np.sign(y[i] - y[i + 1 :])).sum()) for i in range(0, 7000))
    assert abs(got - exact) <= 2 * np.spacing(np.float32(got)) * 14  # one rounding per chunk at most


def test_pearson_rank_stacked_states_merge_as_jax_final_aggregation():
    """Three ranks' moments (one of them empty) stacked as a sync stacks them,
    merged by the port and by the JAX ``_final_aggregation``; the merged
    correlation against the JAX value on the whole data."""
    preds, target = _data("normal", n=150, d=3, seed=15)
    parts = [slice(0, 40), slice(40, 150), slice(150, 150)]
    states = []
    for part in parts:
        m = reg.PearsonCorrCoef(num_outputs=3, device="cpu")
        if part.stop > part.start:
            m.update(torch.from_numpy(preds[part]), torch.from_numpy(target[part]))
        states.append([getattr(m, k).numpy() for k in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")])
    stacked = [np.stack(s) for s in zip(*states)]
    got = pearson._final_aggregation(*(torch.from_numpy(s) for s in stacked))
    want = jax_pearson._final_aggregation(*(jnp.asarray(s) for s in stacked))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL, atol=ATOL)
    m = reg.PearsonCorrCoef(num_outputs=3, device="cpu")
    for name, s in zip(("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"), stacked):
        setattr(m, name, torch.from_numpy(s))
    m._update_count = 1
    _close(m.compute(), jax_fr.pearson_corrcoef(jnp.asarray(preds), jnp.asarray(target)), 0, CORR_TOL)


# ------------------------------------------------------------ modular


def _modular(name, kwargs, d):
    return getattr(reg, name)(**kwargs, device="cpu"), getattr(jax_reg, name)(**kwargs)


MODULAR = {
    # name: (kind, kwargs, value tolerance)
    "MeanSquaredError": ("normal", {}, RTOL),
    "MeanAbsoluteError": ("normal", {}, RTOL),
    "MeanSquaredLogError": ("positive", {}, RTOL),
    "LogCoshError": ("normal", {}, RTOL),
    "MinkowskiDistance": ("normal", {"p": 3}, RTOL),
    "MeanAbsolutePercentageError": ("positive", {}, RTOL),
    "SymmetricMeanAbsolutePercentageError": ("positive", {}, RTOL),
    "WeightedMeanAbsolutePercentageError": ("positive", {}, RTOL),
    "TweedieDevianceScore": ("positive", {"power": 1.5}, RTOL),
    "R2Score": ("normal", {}, RTOL),
    "RelativeSquaredError": ("normal", {}, RTOL),
    "ExplainedVariance": ("normal", {}, RTOL),
    "PearsonCorrCoef": ("ties", {}, CORR_TOL),
    "ConcordanceCorrCoef": ("ties", {}, CORR_TOL),
    "SpearmanCorrCoef": ("ties", {}, CORR_TOL),
    "KendallRankCorrCoef": ("ties", {"t_test": True}, CORR_TOL),
    "CosineSimilarity": ("normal", {"reduction": "none"}, RTOL),
    "KLDivergence": ("positive", {"reduction": "none"}, RTOL),
}
MULTI_KW = {
    "MeanSquaredError": {"num_outputs": 3}, "LogCoshError": {"num_outputs": 3}, "R2Score": {"num_outputs": 3},
    "RelativeSquaredError": {"num_outputs": 3}, "PearsonCorrCoef": {"num_outputs": 3},
    "ConcordanceCorrCoef": {"num_outputs": 3}, "SpearmanCorrCoef": {"num_outputs": 3},
    "KendallRankCorrCoef": {"num_outputs": 3}, "ExplainedVariance": {"multioutput": "raw_values"},
    "MeanAbsoluteError": {}, "CosineSimilarity": {"reduction": "none"}, "KLDivergence": {"reduction": "none"},
}
MODULAR_CASES = [(name, 1) for name in MODULAR if name not in ("CosineSimilarity", "KLDivergence")]
MODULAR_CASES += [(name, 3) for name in MULTI_KW]


def _abs_scale(name, batches):
    """The sums of absolute terms of the states whose terms cancel."""
    p = np.concatenate([b[0] for b in batches]).astype(np.float64)
    t = np.concatenate([b[1] for b in batches]).astype(np.float64)
    if name == "ExplainedVariance":
        return {"sum_error": np.abs(t - p).sum(0), "sum_target": np.abs(t).sum(0)}
    if name in ("R2Score", "RelativeSquaredError"):
        return {"sum_error": np.abs(t).sum(0), "sum_obs": np.abs(t).sum(0)}
    if name in ("PearsonCorrCoef", "ConcordanceCorrCoef"):
        dx, dy = p - p.mean(0), t - t.mean(0)
        return {"mean_x": np.abs(p).mean(0), "mean_y": np.abs(t).mean(0), "corr_xy": np.abs(dx * dy).sum(0)}
    return {}


@pytest.mark.parametrize(("name", "d"), MODULAR_CASES)
def test_modular_states_and_values_match_jax(name, d):
    kind, kwargs, tol = MODULAR[name]
    kwargs = {**kwargs, **(MULTI_KW[name] if d > 1 else {})}
    port, ref = _modular(name, kwargs, d)
    batches = [_data(kind, n=64, d=d, seed=s) for s in range(3)]
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    _assert_states(export_state(port), {k: (list(v) if isinstance(v, list) else np.asarray(v))
                                        for k, v in ((k, getattr(ref, k)) for k in ref._defaults)},
                   _abs_scale(name, batches))
    _close(port.compute(), ref.compute(), tol, ATOL if tol == RTOL else CORR_TOL)


@pytest.mark.parametrize("name", ["MeanSquaredError", "PearsonCorrCoef", "SpearmanCorrCoef", "ExplainedVariance"])
def test_forward_returns_the_batch_value_as_jax(name):
    kind, kwargs, tol = MODULAR[name]
    port, ref = _modular(name, kwargs, 1)
    for s in range(2):
        p, t = _data(kind, n=64, seed=20 + s)
        _close(port(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)), tol, CORR_TOL)
    _close(port.compute(), ref.compute(), tol, CORR_TOL)


def test_collection_groups_form_as_in_the_jax_package():
    """MSE and RMSE share a state, Pearson and concordance, and the list-state
    Spearman, Kendall and cosine similarity of (N, 3) inputs; the groups and
    every value as the JAX package's collection has them."""

    def members(pkg, **kw):
        return {
            "mse": pkg.MeanSquaredError(num_outputs=3, **kw),
            "rmse": pkg.MeanSquaredError(squared=False, num_outputs=3, **kw),
            "mae": pkg.MeanAbsoluteError(**kw),
            "pearson": pkg.PearsonCorrCoef(num_outputs=3, **kw),
            "ccc": pkg.ConcordanceCorrCoef(num_outputs=3, **kw),
            "spearman": pkg.SpearmanCorrCoef(num_outputs=3, **kw),
            "kendall": pkg.KendallRankCorrCoef(num_outputs=3, **kw),
            "cosine": pkg.CosineSimilarity(reduction="mean", **kw),
            "r2": pkg.R2Score(num_outputs=3, multioutput="raw_values", **kw),
            "rse": pkg.RelativeSquaredError(num_outputs=3, **kw),
        }

    port = MetricCollection(members(reg, device="cpu"), device="cpu")
    ref = tpumetrics.MetricCollection(members(jax_reg))
    for s in range(3):
        p, t = _data("normal", n=64, d=3, seed=30 + s)
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    groups = sorted(sorted(g) for g in port.compute_groups.values())
    assert groups == sorted(sorted(g) for g in ref.compute_groups.values())
    assert ["mse", "rmse"] in groups and ["ccc", "pearson"] in groups and ["cosine", "kendall", "spearman"] in groups
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], CORR_TOL, CORR_TOL)


def test_fused_collection_of_regression_leaders_is_bit_for_bit_the_unfused_one():
    """On the CPU the fused step takes its card path (eager first sighting,
    then its stand-in for a capture, then replays): the sum-state leaders and
    Pearson advance through it, Spearman stays eager, and every state equals
    the unfused collection's bit for bit after every update."""

    def make(fused):
        return MetricCollection(
            {
                "mse": reg.MeanSquaredError(device="cpu"),
                "rmse": reg.MeanSquaredError(squared=False, device="cpu"),
                "mae": reg.MeanAbsoluteError(device="cpu"),
                "tweedie": reg.TweedieDevianceScore(power=1.5, device="cpu"),
                "r2": reg.R2Score(device="cpu"),
                "ev": reg.ExplainedVariance(device="cpu"),
                "pearson": reg.PearsonCorrCoef(device="cpu"),
                "ccc": reg.ConcordanceCorrCoef(device="cpu"),
                "spearman": reg.SpearmanCorrCoef(device="cpu"),
            },
            fused_update=fused,
            device="cpu",
        )

    plain, fused = make(False), make(True)
    for s in range(5):
        p, t = (torch.from_numpy(x) for x in _data("positive", n=64, seed=40 + s % 2))
        plain.update(p, t)
        fused.update(p, t)
        got, want = export_state(fused), export_state(plain)
        assert sorted(got) == sorted(want)
        for leader in want:
            for name, ref in want[leader].items():
                val = got[leader][name]
                if isinstance(ref, list):
                    assert all(np.array_equal(v, r) for v, r in zip(val, ref)) and len(val) == len(ref)
                else:
                    assert val.dtype == ref.dtype and np.array_equal(val, ref), (leader, name)
    step = fused._fused_oo_step
    assert sorted(step.leaders) == ["ccc", "ev", "mae", "mse", "r2", "tweedie"]  # ccc leads pearson
    assert step.counts["replayed"] >= 2
    for k, v in plain.compute().items():
        assert torch.equal(fused.compute()[k], v)


def test_fused_collection_resizes_a_broadcast_state_after_reset_as_jax():
    """``ExplainedVariance``'s scalar states become one entry per output in
    its first 2-D update. After ``reset()`` a fused collection's warm-up
    gives that state a new buffer (it raised that the state changed its
    shape), and the values match the JAX fused collection's."""
    def make(pkg, collection, **kw):
        members = {"ev": pkg.ExplainedVariance(multioutput="raw_values", **kw), "mse": pkg.MeanSquaredError(num_outputs=3, **kw)}
        return collection(members, fused_update=True, **kw)

    port, ref = make(reg, MetricCollection, device="cpu"), make(jax_reg, tpumetrics.MetricCollection)
    p, t = _data("normal", n=64, d=3, seed=45)
    for rounds in (4, 3):
        for _ in range(rounds):
            port.update(torch.from_numpy(p), torch.from_numpy(t))
            ref.update(jnp.asarray(p), jnp.asarray(t))
        got, want = port.compute(), ref.compute()
        _close(got, want, RTOL)
        port.reset()
        ref.reset()
    assert port._fused_oo_step.counts["replayed"] >= 2


def test_state_round_trip_with_the_jax_package():
    """A JAX functional state of each modular metric loads into the port
    (``interop.load_state``) and gives the JAX value; the port's exported
    state loads into the JAX functional compute and gives the port's."""
    for name in ("MeanSquaredError", "R2Score", "PearsonCorrCoef", "SpearmanCorrCoef", "TweedieDevianceScore"):
        kind, kwargs, tol = MODULAR[name]
        port, ref = _modular(name, kwargs, 1)
        state = ref.init_state()
        for s in range(2):
            p, t = _data(kind, n=64, seed=50 + s)
            state = ref.functional_update(state, jnp.asarray(p), jnp.asarray(t))
            port.update(torch.from_numpy(p), torch.from_numpy(t))
        fresh = getattr(reg, name)(**kwargs, device="cpu")
        load_state(fresh, {k: (list(map(np.asarray, v)) if isinstance(v, list) else np.asarray(v)) for k, v in state.items()})
        fresh._update_count = 2
        _close(fresh.compute(), ref.functional_compute(state), tol, CORR_TOL)
        back = {k: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)) for k, v in export_state(port).items()}
        _close(port.compute(), ref.functional_compute(back), tol, CORR_TOL)


# ------------------------------------------------------------ set_dtype


@pytest.mark.parametrize("method", ["half", "double", "float"])
def test_set_dtype_converts_float_states_as_jax(method):
    """``half()`` gives bfloat16, as the JAX package's; ``double()`` float64
    (which the JAX package truncates to float32 without x64); int32 states
    keep their dtypes; a cached compute value and list states are converted
    too."""
    port = reg.MeanSquaredError(device="cpu")
    ref = jax_reg.MeanSquaredError()
    p, t = _data("normal", n=64, seed=60)
    port.update(torch.from_numpy(p), torch.from_numpy(t))
    ref.update(jnp.asarray(p), jnp.asarray(t))
    port.compute()
    out = getattr(port, method)()
    assert out is port
    getattr(ref, method)()
    want = {"half": torch.bfloat16, "double": torch.float64, "float": torch.float32}[method]
    assert port.sum_squared_error.dtype == want and port.dtype == want
    if method != "double":  # the JAX package holds float32 for float64 unless x64 is enabled
        assert str(ref.sum_squared_error.dtype) == str(want).replace("torch.", "")
    assert port.total.dtype == torch.int32 and str(ref.total.dtype) == "int32"
    assert port._defaults["sum_squared_error"].dtype == want and port._computed.dtype == want
    np.testing.assert_allclose(port.sum_squared_error.double().numpy(), np.asarray(ref.sum_squared_error, np.float64))

    spear = reg.SpearmanCorrCoef(device="cpu")
    spear.update(torch.from_numpy(p), torch.from_numpy(t))
    spear.set_dtype(torch.float64)
    assert all(x.dtype == torch.float64 for x in spear.preds)
    counts = reg.MeanSquaredError(device="cpu").half()
    counts.add_state("extra", torch.zeros(2), dist_reduce_fx="sum")
    assert counts.extra.dtype == torch.bfloat16


# ------------------------------------------------------------ small utils


def test_utils_distributed_and_imports_match_jax():
    from tpumetrics.utils import distributed as jax_dist
    from tpumetrics.utils import imports as jax_imports

    from tpumetrics_torch.parallel import NoOpBackend, set_default_backend
    from tpumetrics_torch.utils import distributed as dist_utils
    from tpumetrics_torch.utils import imports

    x = np.asarray([[1.0, 2.0, 3.0], [0.0, 5.0, 1.0]], np.float32)
    for reduction in ("elementwise_mean", "sum", "none", None):
        _close(dist_utils.reduce(torch.from_numpy(x), reduction), jax_dist.reduce(jnp.asarray(x), reduction), RTOL)
    num, den, w = np.asarray([1.0, 2.0, 0.0]), np.asarray([2.0, 4.0, 0.0]), np.asarray([1, 3, 0])
    for mode in ("micro", "macro", "weighted", "none", None):
        _close(dist_utils.class_reduce(*(torch.from_numpy(a) for a in (num, den, w)), class_reduction=mode),
               jax_dist.class_reduce(*(jnp.asarray(a) for a in (num, den, w)), class_reduction=mode), RTOL)
    with pytest.raises(ValueError):
        dist_utils.reduce(torch.zeros(1), "max")
    with pytest.raises(ValueError):
        dist_utils.class_reduce(torch.zeros(1), torch.ones(1), torch.ones(1), "max")
    set_default_backend(NoOpBackend())
    try:
        gathered = dist_utils.gather_all_tensors(torch.arange(3))
    finally:
        set_default_backend(None)
    assert len(gathered) == 1 and torch.equal(gathered[0], torch.arange(3))
    for flag in ("_SCIPY_AVAILABLE", "_SKLEARN_AVAILABLE", "_MATPLOTLIB_AVAILABLE", "_TRANSFORMERS_AVAILABLE"):
        assert getattr(imports, flag) == getattr(jax_imports, flag)
    assert imports.package_available("torch") and not imports.package_available("no_such_package_here")
