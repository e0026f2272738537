"""The port's nominal domain held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through each JAX function or
class and its counterpart in ``tpumetrics_torch``. Tolerances:

- contingency tables exact (the port's int32 ``_masked_confmat``, the JAX
  package's int32 one-hot count), the modular float32 ``(C, C)`` table
  states and Fleiss kappa's int32 count lists exact;
- Cramer's V, Tschuprow's T, Pearson's contingency coefficient, Theil's U
  and Fleiss kappa within ``RTOL`` = 1e-5 relative or ``ATOL`` = 1e-6
  absolute: the same float32 arithmetic, summed in another order; NaN where
  the JAX value is NaN.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.functional.nominal as jax_fn
import tpumetrics.nominal as jax_nom
import tpumetrics_torch.functional.nominal as fn
import tpumetrics_torch.nominal as nom
from tpumetrics.buffers import MaskedBuffer as JaxMaskedBuffer
from tpumetrics.functional.nominal import utils as jax_utils
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.functional.nominal import utils
from tpumetrics_torch.interop import export_state, load_state

RTOL = 1e-5
ATOL = 1e-6
N = 120
C = 5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


def _pair(case, seed=0, n=N):
    """``(preds, target)``: "random" (5 classes, independent), "dependent"
    (the target mostly follows preds), "nan" (float series with NaNs),
    "dropped" (negative and out-of-range labels, dropped), "constant" (a
    constant preds variable), "perfect" (preds the target under a
    relabelling) and "2d" (score matrices, argmaxed)."""
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, C, n)
    target = np.where(rng.random(n) < 0.6, preds, rng.integers(0, C, n)) if case != "random" else rng.integers(0, C, n)
    if case == "nan":
        preds, target = preds.astype(np.float32), target.astype(np.float32)
        preds[::9] = np.nan
        target[4::13] = np.nan
    elif case == "dropped":
        preds[::8] = -1
        target[3::10] = C + 2
    elif case == "constant":
        preds[:] = 2
    elif case == "perfect":
        preds = np.array([4, 2, 0, 1, 3])[target]
    elif case == "2d":
        return rng.random((n, C)).astype(np.float32), np.eye(C, dtype=np.float32)[target] + 0.1 * rng.random((n, C)).astype(np.float32)
    return preds, target


def _both(x):
    return torch.from_numpy(np.asarray(x)), jnp.asarray(x)


def test_exports_match_the_jax_package():
    assert sorted(nom.__all__) == sorted(jax_nom.__all__)
    assert sorted(fn.__all__) == sorted(jax_fn.__all__)
    import tpumetrics_torch
    import tpumetrics_torch.functional

    assert set(jax_nom.__all__) <= set(tpumetrics_torch.__all__)
    assert set(jax_fn.__all__) <= set(tpumetrics_torch.functional.__all__)


@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize("case", ["random", "nan", "dropped", "2d"])
def test_contingency_table_is_the_jax_one(case, nan_strategy):
    p, t = _pair(case)
    (tp, jp), (tt, jt) = _both(p), _both(t)
    got = utils._nominal_confmat(tp, tt, C, nan_strategy, 1.0)
    want = jax_utils._nominal_confmat(jp, jt, C, nan_strategy, 1.0)
    assert got.dtype == torch.int32 and np.array_equal(_np(got), np.asarray(want))
    assert utils._infer_num_classes(tp, tt, nan_strategy, 1.0) == jax_utils._infer_num_classes(jp, jt, nan_strategy, 1.0)


FUNCTIONAL = [
    ("cramers_v", {"bias_correction": True}), ("cramers_v", {"bias_correction": False}),
    ("tschuprows_t", {"bias_correction": True}), ("tschuprows_t", {"bias_correction": False}),
    ("pearsons_contingency_coefficient", {}), ("theils_u", {}),
]
CASES = [("random", "replace"), ("dependent", "replace"), ("nan", "replace"), ("nan", "drop"), ("dropped", "replace"),
         ("constant", "replace"), ("perfect", "replace"), ("2d", "replace")]


@pytest.mark.parametrize(("case", "nan_strategy"), CASES)
@pytest.mark.parametrize(("name", "kwargs"), FUNCTIONAL, ids=[f"{n}-{k}" for n, k in FUNCTIONAL])
def test_functional_matches_jax(name, kwargs, case, nan_strategy):
    p, t = _pair(case)
    (tp, jp), (tt, jt) = _both(p), _both(t)
    num_classes = {"num_classes": C} if case in ("dropped", "2d") else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the bias correction's warning on a degenerate table, in both
        got = getattr(fn, name)(tp, tt, nan_strategy=nan_strategy, **kwargs, **num_classes)
        want = getattr(jax_fn, name)(jp, jt, nan_strategy=nan_strategy, **kwargs, **num_classes)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want)


@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize(("name", "kwargs"), [
    ("cramers_v_matrix", {"bias_correction": True}), ("cramers_v_matrix", {"bias_correction": False}),
    ("tschuprows_t_matrix", {"bias_correction": True}), ("tschuprows_t_matrix", {"bias_correction": False}),
    ("pearsons_contingency_coefficient_matrix", {}), ("theils_u_matrix", {}),
])
def test_matrix_functions_match_jax(name, kwargs, nan_strategy):
    rng = np.random.default_rng(7)
    matrix = np.stack([rng.integers(0, 3, N), rng.integers(0, 5, N), rng.integers(0, 2, N), rng.integers(0, 6, N)], 1)
    matrix[:, 3] = np.where(rng.random(N) < 0.5, matrix[:, 1], matrix[:, 3])  # one dependent pair
    matrix = matrix.astype(np.float32)
    matrix[5::17, 2] = np.nan
    tm, jm = _both(matrix)
    got = getattr(fn, name)(tm, nan_strategy=nan_strategy, **kwargs)
    want = getattr(jax_fn, name)(jm, nan_strategy=nan_strategy, **kwargs)
    assert got.shape == (4, 4) and got.dtype == torch.float32
    _close(got, want)


def test_edge_cases_as_the_jax_package_pins_them():
    """A constant variable and a perfect association (the JAX package's
    ``tests/clustering/test_edge_cases.py``)."""
    const = torch.zeros(12, dtype=torch.int32)
    mixed = torch.tensor([0, 1, 2] * 4, dtype=torch.int32)
    with pytest.warns(UserWarning, match="bias correction"):
        assert np.isnan(float(fn.cramers_v(const, mixed)))
    assert float(fn.theils_u(const, mixed)) == pytest.approx(0.0)
    assert float(fn.cramers_v(mixed, mixed)) == pytest.approx(1.0)
    assert float(fn.theils_u(mixed, mixed)) == pytest.approx(1.0)
    assert float(fn.pearsons_contingency_coefficient(mixed, mixed)) == pytest.approx(np.sqrt(2 / 3), abs=1e-6)


def test_argument_checks_raise_as_in_jax():
    p = torch.tensor([0.0, 1, 2, float("nan"), 1])
    with pytest.raises(ValueError, match="nan_strategy"):
        fn.cramers_v(p, p, nan_strategy="bad")
    with pytest.raises(ValueError, match="nan_replace"):
        fn.cramers_v(p, p, nan_strategy="replace", nan_replace_value=None)
    with pytest.raises(ValueError, match="num_classes"):
        nom.TheilsU(num_classes=1, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        fn.fleiss_kappa(torch.ones(2, 3, dtype=torch.int32), mode="votes")
    with pytest.raises(ValueError, match="floating point"):
        fn.fleiss_kappa(torch.ones(2, 3, 4, dtype=torch.int32), mode="probs")
    with pytest.raises(ValueError, match="none floating point"):
        nom.FleissKappa(device="cpu").update(torch.ones(2, 3))


def _ratings(mode, seed=0, n=40, categories=4, raters=6):
    rng = np.random.default_rng(seed)
    if mode == "counts":
        return rng.multinomial(raters, [0.1, 0.2, 0.3, 0.4], size=n).astype(np.int32)
    return rng.random((n, categories, raters)).astype(np.float32)


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_kappa_matches_jax(mode):
    """Functional and modular, over three batches: the int32 count list
    states exact, the values within tolerance; and through a capacity
    buffer, against the JAX package's."""
    batches = [_ratings(mode, seed=s) for s in range(3)]
    tr, jr = _both(batches[0])
    _close(fn.fleiss_kappa(tr, mode), jax_fn.fleiss_kappa(jr, mode))
    port, ref = nom.FleissKappa(mode, device="cpu"), jax_nom.FleissKappa(mode)
    for b in batches:
        port.update(torch.from_numpy(b))
        ref.update(jnp.asarray(b))
    states = export_state(port)["counts"]
    assert all(s.dtype == np.int32 and np.array_equal(s, np.asarray(w)) for s, w in zip(states, ref.counts))
    _close(port.compute(), ref.compute())

    port, ref = nom.FleissKappa(mode, device="cpu"), jax_nom.FleissKappa(mode)
    for m in (port, ref):
        m.set_state_capacity("counts", 160, feature_shape=(4,))
    state, jstate = port.init_state(), ref.init_state()
    for b in batches:
        state = port.functional_update(state, torch.from_numpy(b))
        jstate = ref.functional_update(jstate, jnp.asarray(b))
    assert all(np.array_equal(_np(a), np.asarray(b)) for a, b in zip(state["counts"], jstate["counts"]))
    _close(port.functional_compute(state), ref.functional_compute(jstate))
    load_state(port, {"counts": JaxMaskedBuffer(*(np.asarray(x) for x in jstate["counts"]))})
    port._update_count = 3
    _close(port.compute(), ref.functional_compute(jstate))


MODULAR = [("CramersV", {"bias_correction": True}), ("CramersV", {"bias_correction": False}),
           ("TschuprowsT", {"bias_correction": True}), ("TschuprowsT", {"bias_correction": False}),
           ("PearsonsContingencyCoefficient", {}), ("TheilsU", {})]


@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize(("name", "kwargs"), MODULAR, ids=[f"{n}-{k}" for n, k in MODULAR])
def test_modular_states_and_values_match_jax(name, kwargs, nan_strategy):
    port = getattr(nom, name)(num_classes=C + 1, nan_strategy=nan_strategy, **kwargs, device="cpu")
    ref = getattr(jax_nom, name)(num_classes=C + 1, nan_strategy=nan_strategy, **kwargs)
    for s in range(3):
        p, t = _pair("nan", seed=10 + s, n=40)
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    assert port.confmat.dtype == torch.float32 and port.confmat.shape == (C + 1, C + 1)
    assert np.array_equal(_np(port.confmat), np.asarray(ref.confmat))
    _close(port.compute(), ref.compute())
    assert port._update_reads_host == (nan_strategy == "drop")


def _association(pkg, nan_strategy="replace", **kw):
    return {
        "cramers": pkg.CramersV(num_classes=C, nan_strategy=nan_strategy, **kw),
        "tschuprow": pkg.TschuprowsT(num_classes=C, bias_correction=False, nan_strategy=nan_strategy, **kw),
        "pearson": pkg.PearsonsContingencyCoefficient(num_classes=C, nan_strategy=nan_strategy, **kw),
        "theil": pkg.TheilsU(num_classes=C, nan_strategy=nan_strategy, **kw),
    }


def test_collection_groups_form_as_in_the_jax_package():
    """The four association metrics accumulate one table: one group, as in
    the JAX package, and every value equal."""
    port = MetricCollection(_association(nom, device="cpu"), device="cpu")
    ref = tpumetrics.MetricCollection(_association(jax_nom))
    for s in range(2):
        p, t = _pair("dependent", seed=20 + s, n=40)
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    groups = sorted(sorted(g) for g in port.compute_groups.values())
    assert groups == sorted(sorted(g) for g in ref.compute_groups.values()) == [["cramers", "pearson", "theil", "tschuprow"]]
    got, want = port.compute(), ref.compute()
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
def test_fused_collection_captures_replace_and_keeps_drop_eager(nan_strategy):
    """With ``nan_strategy="replace"`` the shared table's leader advances
    through the fused step (eager, then its stand-in for a capture, then
    replays) bit for bit the unfused collection; with ``"drop"``, whose
    update selects rows on the host, it stays eager."""
    plain = MetricCollection(_association(nom, nan_strategy, device="cpu"), device="cpu")
    fused = MetricCollection(_association(nom, nan_strategy, device="cpu"), device="cpu", fused_update=True)
    for s in range(5):
        p, t = _pair("nan", seed=30 + s % 2, n=40)
        plain.update(torch.from_numpy(p), torch.from_numpy(t))
        fused.update(torch.from_numpy(p), torch.from_numpy(t))
        got, want = export_state(fused), export_state(plain)
        assert all(np.array_equal(got[k]["confmat"], want[k]["confmat"]) for k in want)
    step = fused._fused_oo_step
    if nan_strategy == "replace":
        assert step.counts == {"eager": 1, "captured": 1, "replayed": 2, "unfused": 0}
    else:
        assert step is None
    for k, v in plain.compute().items():
        assert torch.equal(fused.compute()[k], v)


def test_jax_states_carry_into_the_port():
    """A JAX metric's float32 table, updated on some batches, loads into the
    port (``interop.load_state``) and computes the JAX value; the port's
    exported table loads back into the JAX functional compute."""
    for name, kwargs in MODULAR[::2]:
        ref = getattr(jax_nom, name)(num_classes=C, **kwargs)
        for s in range(2):
            p, t = _pair("dependent", seed=40 + s, n=40)
            ref.update(jnp.asarray(p), jnp.asarray(t))
        port = getattr(nom, name)(num_classes=C, **kwargs, device="cpu")
        load_state(port, {"confmat": np.asarray(ref.confmat)})
        port._update_count = 2
        _close(port.compute(), ref.compute())
        _close(port.compute(), ref.functional_compute({"confmat": jnp.asarray(export_state(port)["confmat"])}))
    ref = jax_nom.FleissKappa("counts")
    for s in range(2):
        ref.update(jnp.asarray(_ratings("counts", seed=s)))
    port = nom.FleissKappa("counts", device="cpu")
    load_state(port, {"counts": [np.asarray(c) for c in ref.counts]})
    port._update_count = 2
    _close(port.compute(), ref.compute())
