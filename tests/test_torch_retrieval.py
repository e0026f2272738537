"""The port's retrieval domain held against the JAX package on the CPU:
every modular metric under each ``empty_target_action``, and the inputs,
helpers and tolerances that ``tests/test_torch_retrieval_states.py`` and
``tests/test_torch_retrieval_functional.py`` share (the domain's tests are
split in three files, so that ``--dist loadfile`` spreads them).

The same numpy inputs, made from a seed, go through each JAX function or
class and its counterpart in ``tpumetrics_torch``. Tolerances:

- list states, buffers, ranks, counts and the sort permutation exact;
- every value within ``ATOL`` = 1e-6: the per-query sums are float64
  differences cast to float32 in the port and float32 segment sums in the
  JAX package, so fractional terms (AP, nDCG) may differ in the last bit;
  binary counts are exact in both;
- compute groups equal.

Inputs: ``N_ROWS`` rows over ``N_QUERIES`` query ids in two batches of
unequal size, in shuffled order (queries straddle the batches), scores on a
1/8 grid (ties within a query), with queries that have no relevant and
queries that have no irrelevant documents, so the empty-target policies
act; one shape per JAX function, so that each compiles once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.functional.retrieval as jax_fr
import tpumetrics.retrieval as jax_r
import tpumetrics_torch.functional.retrieval as fr
import tpumetrics_torch.retrieval as rt

ATOL = 1e-6
N_ROWS, N_QUERIES, SPLIT = 60, 9, 23
ACTIONS = ["neg", "pos", "skip", "error"]
CLASSES = [
    "RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut",
    "RetrievalHitRate", "RetrievalRPrecision", "RetrievalNormalizedDCG", "RetrievalPrecisionRecallCurve",
    "RetrievalRecallAtFixedPrecision",
]
TIES = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 0.5, 0.25, -0.5], np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0, atol=atol)


def _stream(seed=0, graded=False, ties=False):
    """``(indexes, preds, target)`` of ``N_ROWS`` rows in shuffled order.
    Query 3 has no relevant document and query 5 no irrelevant one; query 7
    never occurs (an index gap)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(np.array([0, 1, 2, 3, 4, 5, 6, 8]), N_ROWS).astype(np.int64)
    preds = (rng.integers(0, 8, N_ROWS) / 8).astype(np.float32)
    if ties:
        preds = rng.choice(TIES, N_ROWS)
    target = rng.integers(0, 4 if graded else 2, N_ROWS).astype(np.int64)
    target[idx == 3] = 0
    target[idx == 5] = 3 if graded else 1
    return idx, preds, target


def _batches(idx, preds, target):
    return [(idx[s], preds[s], target[s]) for s in (slice(0, SPLIT), slice(SPLIT, None))]


def _make(pkg, name, **kw):
    cls = getattr(pkg, name)
    if name == "RetrievalRecallAtFixedPrecision":
        kw.setdefault("min_precision", 0.3)
    return cls(**kw)


def _run(name, kw, stream, port_kw=None):
    """The port's and the JAX package's value of class ``name`` over the
    stream's two batches; an exception is returned as its type."""
    port = _make(rt, name, device="cpu", **kw, **(port_kw or {}))
    ref = _make(jax_r, name, **kw)
    for i, p, t in _batches(*stream):
        port.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        ref.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
    out = []
    for m in (port, ref):
        try:
            out.append(m.compute())
        except ValueError as err:
            out.append(type(err))
    return out


def _assert_same(got, want):
    if isinstance(want, type):
        assert got is want
    else:
        _close(got, want)


def test_exports_match_the_jax_package():
    assert sorted(rt.__all__) == sorted(jax_r.__all__)
    assert sorted(fr.__all__) == sorted(jax_fr.__all__)


@pytest.mark.parametrize("action", ACTIONS)
@pytest.mark.parametrize("name", CLASSES)
def test_modular_matches_jax_under_each_empty_target_action(name, action):
    _assert_same(*_run(name, {"empty_target_action": action}, _stream(seed=1)))
