"""The port's perplexity held against the JAX package on the CPU.

The same numpy logits and targets, made from a seed, go through
``_perplexity_update`` and ``perplexity`` of both packages and through both
``Perplexity`` classes. On the CPU the port's ``token_nll`` runs its plain
version (a float32 ``log_softmax`` and ``gather``) inside the autograd
function whose backward a card also runs. Tolerances: the total within
``RTOL`` = 1e-6 relative (the rows summed in float64 here, in float32 by
XLA), the count exact, the gradient within ``GRAD_TOL`` = 1e-6. bfloat16 and
float16 logits are rounded from the same float32 numbers on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.functional.text as jax_fn
import tpumetrics.text as jax_text
from tpumetrics.functional.text.perplexity import _perplexity_update as jax_update
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.functional.text import perplexity
from tpumetrics_torch.functional.text.perplexity import _perplexity_update
from tpumetrics_torch.interop import export_state
from tpumetrics_torch.ops import token_nll as tn
from tpumetrics_torch.text import Perplexity

RTOL = 1e-6
GRAD_TOL = 1e-6
B, S = 2, 6
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _inputs(vocab, seed=0, ignore=None, spread=3.0):
    rng = np.random.default_rng(seed)
    logits = (spread * rng.standard_normal((B, S, vocab))).astype(np.float32)
    target = rng.integers(0, vocab, (B, S))
    if ignore is not None:
        target[0, ::2] = ignore
    return logits, target


def _both(logits, target, dtype="float32"):
    tdt, jdt = DTYPES[dtype]
    return (torch.from_numpy(logits).to(tdt), torch.from_numpy(target)), (jnp.asarray(logits, jdt), jnp.asarray(target))


def _close_total(got, want):
    got, want = float(got), float(want)
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert abs(got - want) <= RTOL * abs(want), (got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("vocab", [37, 64])
@pytest.mark.parametrize("ignore_index", [None, -100, 3])
def test_update_matches_jax(dtype, vocab, ignore_index):
    logits, target = _inputs(vocab, seed=vocab, ignore=ignore_index)
    (tl, tt), (jl, jt) = _both(logits, target, dtype)
    total, count = _perplexity_update(tl, tt, ignore_index)
    jtotal, jcount = jax_update(jl, jt, ignore_index)
    assert total.dtype == count.dtype == torch.float32
    _close_total(total, jtotal)
    assert float(count) == float(jcount)
    again = _perplexity_update(tl, tt, ignore_index)
    assert torch.equal(again[0], total) and torch.equal(again[1], count)


def test_functional_value_and_float64_logits_match_jax():
    logits, target = _inputs(37, seed=5)
    (tl, tt), (jl, jt) = _both(logits, target)
    np.testing.assert_allclose(float(perplexity(tl, tt)), float(jax_fn.perplexity(jl, jt)), rtol=RTOL)
    double = perplexity(tl.double(), tt)  # cast to float32 first, as the JAX package does
    assert double.dtype == torch.float32 and float(double) == float(perplexity(tl, tt))


@pytest.mark.parametrize(
    ("targets", "ignore_index", "nan"),
    [
        ([[5, 0]], None, True),  # past the last class: NaN, as JAX's take_along_axis fills
        ([[-1, -5]], None, False),  # wraps: -1 the last class, -5 the first
        ([[-100, 1]], None, True),  # -100 with no ignore_index: out of range
        ([[-100, 1]], -100, False),
        ([[-6, 2]], None, True),  # below -V
    ],
)
def test_out_of_range_and_wrapped_targets_as_jax(targets, ignore_index, nan):
    logits = np.random.default_rng(7).standard_normal((1, 2, 5)).astype(np.float32)
    target = np.asarray(targets)
    (tl, tt), (jl, jt) = _both(logits, target)
    total, count = _perplexity_update(tl, tt, ignore_index)
    jtotal, jcount = jax_update(jl, jt, ignore_index)
    assert bool(torch.isnan(total)) == nan == bool(np.isnan(float(jtotal)))
    _close_total(total, jtotal)
    assert float(count) == float(jcount)
    if targets == [[-1, -5]]:
        x = torch.from_numpy(logits)
        want = -(torch.log_softmax(x, -1)[0, 0, 4] + torch.log_softmax(x, -1)[0, 1, 0])
        assert abs(float(total) - float(want)) <= RTOL * abs(float(want))


def test_shifted_logits_of_a_causal_lm_match_jax():
    """``logits[:, :-1]`` against ``target[:, 1:]``: a view with strides on B
    and S, read as it is."""
    logits, target = _inputs(64, seed=11)
    tl = torch.from_numpy(logits)[:, :-1]
    assert not tl.is_contiguous() and tl.stride(2) == 1
    total, count = _perplexity_update(tl, torch.from_numpy(target)[:, 1:])
    jtotal, jcount = jax_update(jnp.asarray(logits)[:, :-1], jnp.asarray(target)[:, 1:])
    _close_total(total, jtotal)
    assert float(count) == float(jcount) == B * (S - 1)


def test_one_class_and_an_all_ignored_batch():
    one = torch.randn(B, S, 1)
    total, count = _perplexity_update(one, torch.zeros(B, S, dtype=torch.int64))
    assert float(total) == 0.0 and float(count) == B * S
    logits, target = _inputs(37, seed=2)
    ignored = torch.full((B, S), -100)
    total, count = _perplexity_update(torch.from_numpy(logits), ignored, -100)
    jtotal, jcount = jax_update(jnp.asarray(logits), jnp.asarray(ignored.numpy()), -100)
    assert float(total) == float(jtotal) == 0.0 and float(count) == float(jcount) == 0.0


@pytest.mark.parametrize("ignore_index", [None, -100])
def test_gradient_matches_jax_grad(ignore_index):
    logits, target = _inputs(37, seed=3, ignore=ignore_index)
    x = torch.from_numpy(logits).requires_grad_(True)
    total, _ = _perplexity_update(x, torch.from_numpy(target), ignore_index)
    (2.5 * total).backward()
    want = jax.grad(lambda z: 2.5 * jax_update(z, jnp.asarray(target), ignore_index)[0])(jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=GRAD_TOL, rtol=0)
    # the plain version differentiated by autograd gives the same gradient
    y = torch.from_numpy(logits).requires_grad_(True)
    (2.5 * tn.token_nll_plain(y, torch.from_numpy(target), ignore_index)[0]).backward()
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=GRAD_TOL, rtol=0)


def test_bfloat16_gradient_keeps_the_logits_dtype():
    logits, target = _inputs(37, seed=4)
    x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    _perplexity_update(x, torch.from_numpy(target))[0].backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()


def test_class_matches_jax_over_batches():
    port, ref = Perplexity(ignore_index=-100, device="cpu"), jax_text.Perplexity(ignore_index=-100)
    for seed in range(3):
        logits, target = _inputs(64, seed=20 + seed, ignore=-100)
        port.update(torch.from_numpy(logits), torch.from_numpy(target))
        ref.update(jnp.asarray(logits), jnp.asarray(target))
        assert port.total_log_probs.dtype == port.count.dtype == torch.float32
        _close_total(port.total_log_probs, ref.total_log_probs)
        assert float(port.count) == float(ref.count)
    np.testing.assert_allclose(float(port.compute()), float(ref.compute()), rtol=RTOL)
    with pytest.raises(ValueError, match="ignore_index"):
        Perplexity(ignore_index=1.5, device="cpu")


def test_fused_collection_equals_the_unfused_one_bit_for_bit():
    """A fused collection's step takes its card path on the CPU: first sighting
    eager, then captured, then replays (the transition runs where a card
    replays a graph)."""
    cols = {f: MetricCollection({"ppl": Perplexity(ignore_index=-100, device="cpu")}, fused_update=f, device="cpu")
            for f in (False, True)}
    for seed in range(4):
        logits, target = _inputs(37, seed=30 + seed, ignore=-100)
        for col in cols.values():
            col.update(torch.from_numpy(logits), torch.from_numpy(target))
        got, want = export_state(cols[True]), export_state(cols[False])
        for name in want["ppl"]:
            assert torch.equal(torch.from_numpy(got["ppl"][name]), torch.from_numpy(want["ppl"][name]))
    step = cols[True]._fused_oo_step
    assert step.leaders == ["ppl"] and step.counts["replayed"] >= 1
    assert float(cols[True].compute()["ppl"]) == float(cols[False].compute()["ppl"])


def test_input_checks():
    with pytest.raises(ValueError, match="3 dimensions"):
        _perplexity_update(torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError, match="integer"):
        _perplexity_update(torch.zeros(1, 2, 3), torch.zeros(1, 2))
    with pytest.raises(TypeError, match="floating"):
        _perplexity_update(torch.zeros(1, 2, 3, dtype=torch.int64), torch.zeros(1, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="equaling"):
        _perplexity_update(torch.zeros(1, 2, 3), torch.zeros(1, 3, dtype=torch.int64))
