"""Fixed-capacity masked buffers of the port held against ``tpumetrics.buffers``
(``tests/test_buffers.py`` as the case list): append, masked append,
overflow, bucketed append, extend, compact and merge, the functional path
of a metric with capacity-declared list states, and MaskedBuffer leaves
carried between the packages.

Tolerances: buffers are compared exactly (values, count, requested and
dtypes); AUROC values within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.buffers as jb
import tpumetrics_torch.buffers as tb
from tests.torch_sync_worker import masked_cat_auroc
from tpumetrics_torch.interop import export_state, load_state

ATOL = 1e-6


def _same(port, ref):
    """A port buffer equals a JAX one: every field, dtype and shape."""
    assert isinstance(port, tb.MaskedBuffer) and isinstance(ref, jb.MaskedBuffer)
    for got, want in zip(port, ref):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def _both(capacity, feature_shape=(), dtype=np.float32):
    return (
        tb.create_buffer(capacity, feature_shape, torch.from_numpy(np.zeros(0, dtype)).dtype, "cpu"),
        jb.create_buffer(capacity, feature_shape, jnp.dtype(dtype)),
    )


def _append(bufs, batch, valid=None):
    port, ref = bufs
    tv = None if valid is None else torch.from_numpy(np.asarray(valid))
    jv = None if valid is None else jnp.asarray(valid)
    return tb.buffer_append(port, torch.from_numpy(np.asarray(batch)), tv), jb.buffer_append(ref, jnp.asarray(batch), jv)


def test_append_and_materialize_match_jax():
    bufs = _both(10)
    bufs = _append(bufs, np.asarray([1.0, 2.0, 3.0], np.float32))
    bufs = _append(bufs, np.asarray([4.0], np.float32))
    _same(*bufs)
    np.testing.assert_array_equal(tb.materialize(bufs[0]).numpy(), np.asarray(jb.materialize(bufs[1])))


def test_masked_append_drops_invalid_rows_like_jax():
    bufs = _both(10)
    batch = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    bufs = _append(bufs, batch, np.asarray([True, False, True, False]))
    bufs = _append(bufs, batch, np.asarray([False, True, False, True]))
    _same(*bufs)
    assert tb.materialize(bufs[0]).tolist() == [1, 3, 2, 4]


@pytest.mark.parametrize("feature_shape,dtype", [((), np.float32), ((2,), np.float32), ((3,), np.int32)])
def test_overflow_goes_to_the_dump_row_like_jax(feature_shape, dtype):
    bufs = _both(3, feature_shape, dtype)
    rng = np.random.default_rng(0)
    for n in (2, 2, 1):
        bufs = _append(bufs, rng.integers(0, 9, (n, *feature_shape)).astype(dtype))
    _same(*bufs)
    assert bool(tb.buffer_overflowed(bufs[0])) and int(bufs[0].count) == 3 and int(bufs[0].requested) == 5


def test_bucketed_append_matches_jax():
    port, ref = _both(8, (2,))
    padded = np.arange(12, dtype=np.float32).reshape(6, 2)
    for n in (4, 3):
        port = tb.buffer_append_bucketed(port, torch.from_numpy(padded), n)
        ref = jb.buffer_append_bucketed(ref, jnp.asarray(padded), n)
    _same(port, ref)


def test_extend_keeps_the_overflow_count_like_jax():
    a, ja = _append(_both(4), np.asarray([0.9, 0.1], np.float32))
    b, jbuf = _append(_both(2), np.asarray([0.8, 0.7, 0.6], np.float32))  # one row dropped
    _same(tb.buffer_extend(a, b), jb.buffer_extend(ja, jbuf))


def test_compact_and_merge_match_jax_with_an_empty_rank():
    rng = np.random.default_rng(1)
    parts = [_append(_both(5, (2,)), rng.random((n, 2)).astype(np.float32)) if n else _both(5, (2,)) for n in (2, 0, 4)]
    _same(tb.buffer_merge([p for p, _ in parts]), jb.buffer_merge([r for _, r in parts]))
    stacked = np.stack([np.asarray(r.values) for _, r in parts])
    counts = np.asarray([2, 0, 4], np.int32)
    _same(tb.buffer_compact(torch.from_numpy(stacked), torch.from_numpy(counts)), jb.buffer_compact(jnp.asarray(stacked), jnp.asarray(counts)))
    values, mask = tb.masked_values(tb.buffer_merge([p for p, _ in parts]))
    assert values.shape == (15, 2) and int(mask.sum()) == 6


def test_masked_values_of_lists_and_tensors():
    values, mask = tb.masked_values([], feature_shape=(3,), dtype=torch.int32)
    assert values.shape == (0, 3) and values.dtype == torch.int32 and mask.shape == (0,)
    values, mask = tb.masked_values([torch.ones(2), torch.zeros(1)])
    assert values.tolist() == [1, 1, 0] and bool(mask.all())
    with pytest.raises(TypeError):
        tb.masked_values("rows")


def _jax_masked_cat_auroc():
    from tests.test_buffers import MaskedCatAUROC

    return MaskedCatAUROC(capacity=16)


def _stream(seed=3):
    rng = np.random.default_rng(seed)
    return [
        (rng.random(8).astype(np.float32), rng.integers(0, 2, 8).astype(np.int32), rng.random(8) < 0.7) for _ in range(3)
    ]


def test_capacity_states_on_the_functional_path_match_jax():
    port, ref = masked_cat_auroc(capacity=16), _jax_masked_cat_auroc()
    state, jstate = port.init_state(), ref.init_state()
    assert isinstance(state["preds"], tb.MaskedBuffer) and state["target"].values.dtype == torch.int32
    for p, t, v in _stream():
        state = port.functional_update(state, torch.from_numpy(p), torch.from_numpy(t), valid=torch.from_numpy(v))
        jstate = ref.functional_update(jstate, jnp.asarray(p), jnp.asarray(t), valid=jnp.asarray(v))
    for name in ("preds", "target"):
        _same(state[name], jstate[name])  # 3 x 8 rows into 16: an overflow on both sides
    np.testing.assert_allclose(
        port.functional_compute(state).numpy(), np.asarray(ref.functional_compute(jstate)), rtol=0, atol=ATOL
    )
    # the eager path of the same metric drops the invalid rows from its lists
    for p, t, v in _stream():
        port.update(torch.from_numpy(p), torch.from_numpy(t), valid=torch.from_numpy(v))
    assert sum(x.numel() for x in port.preds) == sum(int(v.sum()) for _, _, v in _stream())


def test_set_state_capacity_uses_the_declared_row_spec():
    port = masked_cat_auroc(capacity=4)
    port.set_state_capacity("target", 6)
    buf = port.init_state()["target"]
    assert buf.values.shape == (6,) and buf.values.dtype == torch.int32
    with pytest.raises(ValueError, match="not a registered list state"):
        port.set_state_capacity("nope", 3)


def test_masked_buffer_leaves_carry_between_the_packages():
    ref = _jax_masked_cat_auroc()
    jstate = ref.init_state()
    for p, t, v in _stream(seed=8):
        jstate = ref.functional_update(jstate, jnp.asarray(p), jnp.asarray(t), valid=jnp.asarray(v))
    as_numpy = {k: jb.MaskedBuffer(*(np.asarray(x) for x in buf)) for k, buf in jstate.items()}
    port = masked_cat_auroc(capacity=16)
    load_state(port, as_numpy)
    assert isinstance(port.preds, tb._BufferList)  # update keeps appending to the buffer
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.functional_compute(jstate)), rtol=0, atol=ATOL)
    back = export_state(port)
    for name in ("preds", "target"):
        _same(tb.MaskedBuffer(*(torch.from_numpy(x) for x in back[name])), jstate[name])
        restored = jb.MaskedBuffer(*(jnp.asarray(x) for x in back[name]))  # the JAX side takes it as is
        _same(tb.MaskedBuffer(*(torch.from_numpy(np.asarray(x)) for x in restored)), jstate[name])
    port.update(torch.tensor([0.5]), torch.tensor([1], dtype=torch.int32))
    assert int(port.preds.buffer.requested) == int(jstate["preds"].requested) + 1
