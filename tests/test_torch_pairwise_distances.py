"""The port's pairwise distances (euclidean, manhattan, minkowski) held
against the JAX package on the CPU, with the inputs and tolerances of
``tests/test_torch_pairwise.py``, and the chunked difference of manhattan
and minkowski forced through more than one chunk."""

import importlib

import numpy as np
import pytest
import torch

import tpumetrics_torch.functional.pairwise as pw
from tests.test_torch_pairwise import MODES, X, Y, check_pairwise_matches_jax

helpers = importlib.import_module("tpumetrics_torch.functional.pairwise.helpers")

DISTANCES = [
    ("pairwise_euclidean_distance", {}),
    ("pairwise_manhattan_distance", {}),
    ("pairwise_minkowski_distance", {"exponent": 3}),
]


@pytest.mark.parametrize("mode, zero_diagonal", MODES)
@pytest.mark.parametrize("reduction", [None, "mean", "sum"])
@pytest.mark.parametrize("name, kw", DISTANCES, ids=[f[0] for f in DISTANCES])
def test_distances_match_jax(name, kw, reduction, mode, zero_diagonal):
    check_pairwise_matches_jax(name, kw, reduction, mode, zero_diagonal)


@pytest.mark.parametrize("name, kw", DISTANCES[1:], ids=[f[0] for f in DISTANCES[1:]])
def test_chunked_difference_takes_more_than_one_chunk(monkeypatch, name, kw):
    """With the difference budget cut to 3 rows of ``(17, 13)`` float32, the
    24 rows of ``X`` take 8 chunks; the result equals the one-chunk one
    (within 1e-6 relative: ``pow`` and the sums vectorize by shape)."""
    whole = getattr(pw, name)(torch.from_numpy(X), torch.from_numpy(Y), **kw)
    chunks = []
    real = helpers._rowwise_chunks

    def counting(x, y, per_chunk):
        return real(x, y, lambda diff: chunks.append(diff.shape[0]) or per_chunk(diff))

    monkeypatch.setattr(helpers, "_DIFF_BUDGET_BYTES", 3 * 17 * 13 * 4)
    monkeypatch.setattr(importlib.import_module(f"tpumetrics_torch.functional.pairwise.{name.split('_')[1]}"),
                        "_rowwise_chunks", counting)
    got = getattr(pw, name)(torch.from_numpy(X), torch.from_numpy(Y), **kw)
    assert chunks == [3] * 8
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=0.0)
