"""The port's pairwise functions held against the JAX package on the CPU:
cosine and linear here, the distances in
``tests/test_torch_pairwise_distances.py`` (split so that ``--dist
loadfile`` spreads them), with the inputs and tolerances of this file.

The same seeded numpy inputs (``X`` 24 x 13 and ``Y`` 17 x 13, offset and
scaled as the JAX package's own pairwise tests make them) go through each
JAX function and its port. Tolerances, relative to max(1, |value|):

- cosine within ``COSINE_TOL`` = 1e-5 (float32 norms and one product);
- linear, manhattan and minkowski within ``SUM_TOL`` = 2e-5 (float32 sums
  of 13 terms in another order);
- euclidean: its ``|a|^2 + |b|^2 - 2ab`` cancels, so the float32 squared
  distance may be off by ``e`` = ``EUCLID_TOL`` = 1e-5 times the largest
  squared norms of the centred rows (some 80 ulps of them); a distance ``d``
  is then off by at most ``sqrt(d^2 + e) - d`` (``sqrt(e)`` near zero, as on
  the self case's diagonal when it is not zeroed), summed or averaged along
  with the distances under a reduction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.functional.pairwise as jax_pw
import tpumetrics_torch.functional.pairwise as pw
from tpumetrics_torch.utils.compute import _safe_matmul
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

COSINE_TOL = 1e-5
SUM_TOL = 2e-5
EUCLID_TOL = 1e-5

_rng = np.random.default_rng(7)
X = _rng.standard_normal((24, 13)).astype(np.float32) * 3.0 + 1.5
Y = _rng.standard_normal((17, 13)).astype(np.float32) * 2.0 - 0.5

SIMILARITIES = [("pairwise_cosine_similarity", {}), ("pairwise_linear_similarity", {})]


def _euclid_atol(x, y, reduction):
    """The absolute tolerance of each euclidean result (see the module note)."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    centre = x.mean(0)
    e = EUCLID_TOL * (((x - centre) ** 2).sum(1).max() + ((y - centre) ** 2).sum(1).max())
    d = np.sqrt(np.maximum((x**2).sum(1)[:, None] + (y**2).sum(1)[None, :] - 2 * x @ y.T, 0.0))
    tol = np.sqrt(d**2 + e) - d
    return {None: tol, "mean": tol.mean(-1), "sum": tol.sum(-1)}[reduction]


def _compare(got, want, rtol, atol=0.0):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= rtol * np.maximum(1.0, np.abs(want)) + atol)


# the defaults (None: False with ``y``, True without it) and the other value of each mode
MODES = [("xy", None), ("xy", True), ("self", None), ("self", False)]


def check_pairwise_matches_jax(name, kw, reduction, mode, zero_diagonal):
    y = Y if mode == "xy" else None
    args = {"reduction": reduction, "zero_diagonal": zero_diagonal, **kw}
    got = getattr(pw, name)(torch.from_numpy(X), None if y is None else torch.from_numpy(y), **args)
    want = getattr(jax_pw, name)(jnp.asarray(X), None if y is None else jnp.asarray(y), **args)
    if name == "pairwise_euclidean_distance":
        _compare(got, want, 0.0, _euclid_atol(X, X if y is None else y, reduction))
    else:
        _compare(got, want, COSINE_TOL if name == "pairwise_cosine_similarity" else SUM_TOL)
    if reduction is None and mode == "self" and zero_diagonal is not False:
        assert torch.all(torch.diagonal(got) == 0)


@pytest.mark.parametrize("mode, zero_diagonal", MODES)
@pytest.mark.parametrize("reduction", [None, "mean", "sum"])
@pytest.mark.parametrize("name, kw", SIMILARITIES, ids=[f[0] for f in SIMILARITIES])
def test_similarities_match_jax(name, kw, reduction, mode, zero_diagonal):
    check_pairwise_matches_jax(name, kw, reduction, mode, zero_diagonal)


def test_input_errors_raise_as_jax():
    with pytest.raises(ValueError, match="Expected argument `x`"):
        pw.pairwise_cosine_similarity(torch.zeros((3,)))
    with pytest.raises(ValueError, match="Expected argument `y`"):
        pw.pairwise_cosine_similarity(torch.zeros((3, 2)), torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="Expected reduction"):
        pw.pairwise_cosine_similarity(torch.zeros((3, 2)), reduction="bad")
    with pytest.raises(TPUMetricsUserError, match="must be a float or int greater than or equal to 1"):
        pw.pairwise_minkowski_distance(torch.zeros((3, 2)), exponent=0.5)


def test_safe_matmul_restores_the_callers_precision_settings():
    torch.set_float32_matmul_precision("medium")
    try:
        saved = (torch.backends.cuda.matmul.fp32_precision, torch.backends.mkldnn.matmul.fp32_precision)
        got = _safe_matmul(torch.from_numpy(X), torch.from_numpy(Y))
        assert (torch.backends.cuda.matmul.fp32_precision, torch.backends.mkldnn.matmul.fp32_precision) == saved
    finally:
        torch.set_float32_matmul_precision("highest")
    want = X.astype(np.float64) @ Y.astype(np.float64).T
    assert np.all(np.abs(got.numpy() - want) <= SUM_TOL * np.maximum(1.0, np.abs(want)))
