"""The port's single-query retrieval functions held against the JAX
package on the CPU: each function on ``N_DOCS`` seeded documents, with
random, none, all relevant, and tied (NaN, +-inf, +-0.0) scores; graded
targets for nDCG. Values within ``ATOL`` = 1e-6 (see
``tests/test_torch_retrieval.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.functional.retrieval as jax_fr
import tpumetrics_torch.functional.retrieval as fr
from tests.test_torch_retrieval import TIES, _close

N_DOCS = 12  # the single-query functions' length


FUNCTIONS = [
    ("retrieval_average_precision", {}), ("retrieval_fall_out", {"top_k": 4}), ("retrieval_hit_rate", {"top_k": 2}),
    ("retrieval_normalized_dcg", {}), ("retrieval_precision", {"top_k": 4}),
    ("retrieval_precision", {"top_k": 20, "adaptive_k": True}), ("retrieval_r_precision", {}),
    ("retrieval_recall", {"top_k": 5}), ("retrieval_reciprocal_rank", {}),
    ("retrieval_precision_recall_curve", {"max_k": 5}),
    ("retrieval_precision_recall_curve", {"max_k": 16, "adaptive_k": True}),
]


@pytest.mark.parametrize("case", ["random", "no_relevant", "all_relevant", "ties"])
@pytest.mark.parametrize("name, kw", FUNCTIONS)
def test_functional_matches_jax(name, kw, case):
    rng = np.random.default_rng(9)
    preds = rng.random(N_DOCS).astype(np.float32)
    target = rng.integers(0, 2, N_DOCS).astype(np.int64)
    if case == "no_relevant":
        target[:] = 0
    elif case == "all_relevant":
        target[:] = 1
    elif case == "ties":
        preds = rng.choice(TIES, N_DOCS)
    if name == "retrieval_normalized_dcg" and case == "random":
        target = rng.integers(0, 4, N_DOCS).astype(np.int64)  # graded
    got = getattr(fr, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    want = getattr(jax_fr, name)(jnp.asarray(preds), jnp.asarray(target), **kw)
    _close(tuple(got) if isinstance(got, tuple) else got, tuple(want) if isinstance(want, tuple) else want)
