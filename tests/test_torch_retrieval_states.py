"""The port's retrieval metrics held against the JAX package on the CPU,
beyond the empty-target actions (``tests/test_torch_retrieval.py``, whose
inputs and tolerances these share): ``top_k``/``adaptive_k``/``max_k``,
``ignore_index``, graded nDCG, ties with NaN, +-inf and +-0.0, the sort
and its segments, the edge cases, input errors, the capacity path over
uneven batches, interop, compute groups and the fused collection."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.retrieval as jax_r
import tpumetrics_torch.functional.retrieval as fr
import tpumetrics_torch.retrieval as rt
from tests.test_torch_retrieval import (
    CLASSES,
    N_QUERIES,
    N_ROWS,
    TIES,
    _assert_same,
    _batches,
    _close,
    _make,
    _np,
    _run,
    _stream,
)
from tpumetrics.buffers import MaskedBuffer as JaxMaskedBuffer
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.buffers import MaskedBuffer
from tpumetrics_torch.interop import export_state, load_state

grouped = importlib.import_module("tpumetrics_torch.functional.retrieval._grouped")
jax_grouped = importlib.import_module("tpumetrics.functional.retrieval._grouped")


@pytest.mark.parametrize(
    "name, kw",
    [
        ("RetrievalPrecision", {"top_k": 2}),
        ("RetrievalPrecision", {"top_k": 20, "adaptive_k": True}),
        ("RetrievalRecall", {"top_k": 3}),
        ("RetrievalFallOut", {"top_k": 2}),
        ("RetrievalHitRate", {"top_k": 1}),
        ("RetrievalMRR", {"top_k": 2}),
        ("RetrievalMAP", {"top_k": 3}),
        ("RetrievalNormalizedDCG", {"top_k": 3}),
        ("RetrievalPrecisionRecallCurve", {"max_k": 4}),
        ("RetrievalPrecisionRecallCurve", {"max_k": 15, "adaptive_k": True}),
        ("RetrievalRecallAtFixedPrecision", {"max_k": 5, "min_precision": 0.5}),
    ],
)
def test_top_k_adaptive_k_and_max_k_match_jax(name, kw):
    _assert_same(*_run(name, kw, _stream(seed=2)))


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalPrecisionRecallCurve"])
def test_ignore_index_drops_rows_as_jax(name):
    """Twelve rows with the target -100 among the stream's: dropped, so the
    states hold the stream's rows (the JAX side computes at the shape of
    the other tests)."""
    idx, preds, target = _stream(seed=3)
    rng = np.random.default_rng(3)
    at = np.sort(rng.choice(N_ROWS, 12, replace=False))
    idx = np.insert(idx, at, rng.integers(0, 9, 12))
    preds = np.insert(preds, at, rng.random(12).astype(np.float32))
    target = np.insert(target, at, -100)
    kw = {"ignore_index": -100} if name != "RetrievalNormalizedDCG" else {"ignore_index": -100, "top_k": 4}
    _assert_same(*_run(name, kw, (idx, preds, target)))


def test_graded_ndcg_with_ties_matches_jax():
    for top_k in (None, 2, 5):
        _assert_same(*_run("RetrievalNormalizedDCG", {"top_k": top_k}, _stream(seed=4, graded=True)))


@pytest.mark.parametrize("name", ["RetrievalMRR", "RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalPrecision"])
def test_ties_with_nan_inf_and_signed_zeros_match_jax(name):
    kw = {"top_k": 3} if name == "RetrievalPrecision" else {}
    _assert_same(*_run(name, kw, _stream(seed=5, ties=True)))


def test_ranked_order_equals_the_jax_lexsort_on_nan_inf_and_signed_zeros():
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 4, N_ROWS).astype(np.int32)
    preds = rng.choice(TIES, N_ROWS)
    want = np.asarray(jnp.lexsort((-jnp.asarray(preds), jnp.asarray(idx))))
    assert np.array_equal(grouped._ranked_order(torch.from_numpy(idx), torch.from_numpy(preds)).numpy(), want)


def test_sorted_queries_equal_jax_with_a_mask_and_invalid_ids():
    idx, preds, target = _stream(seed=7)
    idx = idx.astype(np.int32)
    idx[::11] = -1
    mask = np.arange(N_ROWS) % 4 != 0
    got = grouped.sort_queries(torch.from_numpy(idx), torch.from_numpy(preds), torch.from_numpy(target), 8, torch.from_numpy(mask))
    want = jax_grouped.sort_queries(jnp.asarray(idx), jnp.asarray(preds), jnp.asarray(target), 8, jnp.asarray(mask))
    valid = _np(want.idx) < 8
    for field in ("idx", "preds", "target", "counts", "pos"):
        assert np.array_equal(_np(getattr(got, field)), _np(getattr(want, field)), equal_nan=True), field
    for field in ("rank", "cum_target"):
        assert np.array_equal(_np(getattr(got, field))[valid], _np(getattr(want, field))[valid]), field


def test_cumsum64_is_the_float64_cumulative_sum():
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(5000))
    np.testing.assert_allclose(grouped._cumsum64(x).numpy(), np.cumsum(x.numpy()), rtol=0, atol=1e-11)
    assert grouped._cumsum64(x[:1]).tolist() == x[:1].tolist() and grouped._cumsum64(x[:0]).numel() == 0


def test_edge_cases_of_the_jax_package_hold():
    """tests/retrieval/test_edge_cases.py: single documents, all relevant,
    all tied (input order), ties broken by score first."""
    t = torch.tensor
    assert float(fr.retrieval_average_precision(t([0.5]), t([True]))) == 1.0
    assert float(fr.retrieval_average_precision(t([0.5]), t([False]))) == 0.0
    assert float(fr.retrieval_reciprocal_rank(t([0.5]), t([True]))) == 1.0
    assert float(fr.retrieval_normalized_dcg(t([0.5]), t([True]))) == 1.0
    assert float(fr.retrieval_fall_out(t([0.5]), t([False]), top_k=1)) == 1.0
    p, rel = t([0.9, 0.1, 0.5]), t([True, True, True])
    assert float(fr.retrieval_average_precision(p, rel)) == pytest.approx(1.0)
    assert float(fr.retrieval_precision(p, rel, top_k=2)) == pytest.approx(1.0)
    assert float(fr.retrieval_normalized_dcg(p, rel)) == pytest.approx(1.0)
    flat = torch.full((4,), 0.5)
    assert float(fr.retrieval_reciprocal_rank(flat, t([True, False, False, False]))) == 1.0
    assert float(fr.retrieval_reciprocal_rank(flat, t([False, False, False, True]))) == pytest.approx(0.25)
    assert {float(fr.retrieval_reciprocal_rank(flat, t([False, True, False, False]))) for _ in range(3)} == {0.5}
    assert float(fr.retrieval_reciprocal_rank(t([0.5, 0.5, 0.9]), t([False, False, True]))) == 1.0


@pytest.mark.parametrize(
    "call, err",
    [
        (lambda: fr.retrieval_precision(torch.rand(3), torch.tensor([0, 1])), ValueError),
        (lambda: fr.retrieval_precision(torch.rand(0), torch.rand(0)), ValueError),
        (lambda: fr.retrieval_precision(torch.tensor([1, 2]), torch.tensor([0, 1])), ValueError),
        (lambda: fr.retrieval_precision(torch.rand(2), torch.tensor([0, 2])), ValueError),
        (lambda: fr.retrieval_precision(torch.rand(2), torch.tensor([0, 1]), top_k=0), ValueError),
        (lambda: fr.retrieval_precision(torch.rand(2), torch.tensor([0, 1]), adaptive_k=1), ValueError),
        (lambda: fr.retrieval_precision_recall_curve(torch.rand(2), torch.tensor([0, 1]), max_k=-1), ValueError),
        (lambda: rt.RetrievalMAP(empty_target_action="x", device="cpu"), ValueError),
        (lambda: rt.RetrievalMAP(ignore_index=0.5, device="cpu"), ValueError),
        (lambda: rt.RetrievalRecallAtFixedPrecision(min_precision=2.0, device="cpu"), ValueError),
        (lambda: rt.RetrievalMAP(device="cpu").update(torch.rand(2), torch.tensor([0, 1]), torch.tensor([0.0, 1.0])),
         ValueError),
        (lambda: rt.RetrievalMAP(device="cpu").update(torch.rand(2), torch.tensor([0, 1]), None), ValueError),
    ],
)
def test_input_errors_raise_as_jax(call, err):
    with pytest.raises(err):
        call()


def _buffered(metric, cap):
    for state in metric._defaults:
        metric.set_state_capacity(state, cap)
    load_state(metric, metric.init_state())
    return metric


@pytest.mark.parametrize("name", ["RetrievalMRR", "RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalPrecisionRecallCurve"])
def test_capacity_buffers_over_uneven_batches_match_jax(name):
    """MaskedBuffer states (``set_state_capacity``, ``num_queries``) through
    the functional bridge as the JAX package's jitted path runs them: the
    buffers equal the JAX ones, the value equals the JAX compute of the same
    state and the port's list path; a live-buffer metric's eager update
    gives the same buffers."""
    kw = {"num_queries": N_QUERIES, "max_k": 6} if name == "RetrievalPrecisionRecallCurve" else {"num_queries": N_QUERIES}
    port, ref = _make(rt, name, device="cpu", **kw), _make(jax_r, name, **kw)
    for m in (port, ref):
        for state in m._defaults:
            m.set_state_capacity(state, N_ROWS)
    live = _buffered(_make(rt, name, device="cpu", **kw), N_ROWS)
    exact = _make(rt, name, device="cpu", **kw)
    state, jstate = port.init_state(), ref.init_state()
    for i, p, t in _batches(*_stream(seed=10)):
        args = (torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(i))
        state = port.functional_update(state, *args)
        jstate = ref.functional_update(jstate, jnp.asarray(p), jnp.asarray(t), jnp.asarray(i))
        live.update(*args)
        exact.update(*args)
    for key, buf in state.items():
        assert isinstance(buf, MaskedBuffer) and int(buf.count) == N_ROWS
        for got, want, mine in zip(buf, jstate[key], live.metric_state()[key].buffer):
            assert np.array_equal(_np(got), np.asarray(want)) and _np(got).dtype == np.asarray(want).dtype
            assert np.array_equal(_np(mine), _np(got))
    value = port.functional_compute(state)
    _close(value, ref.functional_compute(jstate))
    _close(value, exact.compute())
    _close(live.compute(), exact.compute())


def test_interop_loads_the_jax_state_and_computes_its_value():
    ref = jax_r.RetrievalMAP()
    for i, p, t in _batches(*_stream(seed=11)):
        ref.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
    port = rt.RetrievalMAP(device="cpu")
    load_state(port, {k: [np.asarray(v) for v in getattr(ref, k)] for k in ref._defaults})
    _close(port.compute(), ref.compute())
    exported = export_state(port)
    assert [a.dtype for a in exported["indexes"]] == [np.int32, np.int32]
    jbuf = jax_r.RetrievalMAP(num_queries=N_QUERIES)
    for state in jbuf._defaults:
        jbuf.set_state_capacity(state, N_ROWS)
    jstate = jbuf.init_state()
    for i, p, t in _batches(*_stream(seed=11)):
        jstate = jbuf.functional_update(jstate, jnp.asarray(p), jnp.asarray(t), jnp.asarray(i))
    buffered = rt.RetrievalMAP(num_queries=N_QUERIES, device="cpu")
    load_state(buffered, {k: JaxMaskedBuffer(*(np.asarray(x) for x in v)) for k, v in jstate.items()})
    _close(buffered.compute(), ref.compute())


def _members(pkg, **kw):
    return {name: _make(pkg, name, **kw) for name in CLASSES}


def test_collection_groups_form_as_in_the_jax_package():
    """Ten members on list states share them; a capacity copy of MRR, MAP and
    nDCG on live MaskedBuffers share theirs: two groups, as the JAX
    package's collection forms them, with every value equal."""
    from tpumetrics.buffers import _BufferList as JaxBufferList

    def capacity_copies(pkg, **kw):
        members = {f"cap_{k}": _make(pkg, name, num_queries=N_QUERIES, **kw)
                   for k, name in (("mrr", "RetrievalMRR"), ("map", "RetrievalMAP"), ("ndcg", "RetrievalNormalizedDCG"))}
        for m in members.values():
            for state in m._defaults:
                m.set_state_capacity(state, N_ROWS)
        return members

    port_caps, ref_caps = capacity_copies(rt, device="cpu"), capacity_copies(jax_r)
    for name, m in port_caps.items():
        load_state(m, m.init_state())
        for state, buf in ref_caps[name].init_state().items():
            object.__setattr__(ref_caps[name], state, JaxBufferList(buf))
    port = MetricCollection({**_members(rt, device="cpu"), **port_caps}, device="cpu")
    ref = tpumetrics.MetricCollection({**_members(jax_r), **ref_caps})
    for i, p, t in _batches(*_stream(seed=12)):
        port.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        ref.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
    groups = sorted(sorted(g) for g in port.compute_groups.values())
    assert groups == sorted(sorted(g) for g in ref.compute_groups.values())
    assert groups == [sorted(CLASSES), ["cap_map", "cap_mrr", "cap_ndcg"]]
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        _close(tuple(got[k]) if isinstance(got[k], tuple) else got[k], tuple(want[k]) if isinstance(want[k], tuple) else want[k])


def test_ignore_index_on_list_states_marks_the_update_as_reading_the_host():
    assert rt.RetrievalMAP(ignore_index=-1, device="cpu")._update_reads_host
    assert not rt.RetrievalMAP(device="cpu")._update_reads_host
    assert not _buffered(rt.RetrievalMAP(ignore_index=-1, num_queries=N_QUERIES, device="cpu"), N_ROWS)._update_reads_host


def test_fused_collection_captures_the_buffered_leader_bit_for_bit():
    """A capacity leader is captured (on the CPU the step's stand-in for a
    capture, then replays) while a list leader stays eager beside it, and a
    list member with ``ignore_index`` stays eager too; states bit for bit
    the unfused collection's after every update."""

    def make(fused):
        members = {
            "mrr": rt.RetrievalMRR(top_k=3, device="cpu"), "map": rt.RetrievalMAP(device="cpu"),
            "cap_mrr": _buffered(rt.RetrievalMRR(top_k=3, num_queries=N_QUERIES, device="cpu"), 4 * N_ROWS),
            "cap_ndcg": _buffered(rt.RetrievalNormalizedDCG(num_queries=N_QUERIES, device="cpu"), 4 * N_ROWS),
            "ign": rt.RetrievalMAP(ignore_index=-1, device="cpu"),
        }
        return MetricCollection(members, fused_update=fused, device="cpu")

    plain, fused = make(False), make(True)
    batch = _batches(*_stream(seed=13))[0]
    batch = tuple(torch.from_numpy(x) for x in (batch[1], batch[2], batch[0]))
    for _ in range(5):
        plain.update(*batch)
        fused.update(*batch)
        got, want = export_state(fused), export_state(plain)
        assert sorted(got) == sorted(want)
        for leader, states in want.items():
            for name, ref in states.items():
                assert all(np.array_equal(a, b) for a, b in zip(got[leader][name], ref)), (leader, name)
        for k, v in plain.compute().items():
            assert torch.equal(fused.compute()[k], v)
    step = fused._fused_oo_step
    assert step.leaders == ["cap_mrr"] and step.counts == {"eager": 1, "captured": 1, "replayed": 2, "unfused": 0}
