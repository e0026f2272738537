"""The port's clustering domain held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through each JAX function or
class and its counterpart in ``tpumetrics_torch``. Tolerances:

- contingency tables, pair confusion matrices and label states exact
  (float32 counts of integers below 2^24; int32 labels);
- the MI family (MI, NMI, homogeneity, completeness, V-measure) and the
  Rand family (Rand, adjusted Rand, Fowlkes-Mallows) within ``RTOL`` = 1e-5
  relative or ``ATOL`` = 1e-6 absolute: the same float32 arithmetic,
  summed in another order;
- AMI within ``AMI_ATOL`` = 1e-6 of the JAX package's eager value (its
  expected MI a host float64 grid, the port's a float64 grid on the
  tensors' device), and the expected MI itself within 1e-6 relative; JAX's
  jitted compute of a capacity buffer takes a float32 grid, whose lgamma
  differences lose some three digits: held within ``AMI_F32_ATOL`` = 1e-3;
- Calinski-Harabasz, Davies-Bouldin and Dunn within ``INTRINSIC_RTOL`` =
  1e-5 relative: the port's per-cluster sums are float64 one-hot products
  cast to float32, the JAX package's float32 products.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics
import tpumetrics.clustering as jax_cl
import tpumetrics.functional.clustering as jax_fc
import tpumetrics_torch.clustering as cl
import tpumetrics_torch.functional.clustering as fc
from tpumetrics.buffers import MaskedBuffer as JaxMaskedBuffer
from tpumetrics.functional.clustering import utils as jax_utils
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.buffers import MaskedBuffer
from tpumetrics_torch.functional.clustering import utils
from tpumetrics_torch.interop import export_state, load_state

# the modules (the packages' ``__init__`` shadows their names with the functions)
ami = importlib.import_module("tpumetrics_torch.functional.clustering.adjusted_mutual_info_score")
jax_ami = importlib.import_module("tpumetrics.functional.clustering.adjusted_mutual_info_score")

RTOL = 1e-5
ATOL = 1e-6
AMI_ATOL = 1e-6
AMI_F32_ATOL = 1e-3
INTRINSIC_RTOL = 1e-5
N = 96


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def _labels(case, seed=0, n=N):
    """``(preds, target, class spaces)``: "random" (6 and 5 labels, sized from
    the data), "declared" (the same in declared spaces of 8 and 7, with
    empty classes), "dropped" (negative and out-of-range labels in declared
    spaces of 6 and 5, dropped), "single" (one predicted cluster) and
    "perfect" (the target under a relabelling)."""
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, 6, n).astype(np.int32)
    target = rng.integers(0, 5, n).astype(np.int32)
    spaces = {}
    if case == "declared":
        spaces = {"num_classes_preds": 8, "num_classes_target": 7}
    elif case == "dropped":
        preds[::7] = -1
        preds[3::11] = 6
        target[5::13] = -2
        spaces = {"num_classes_preds": 6, "num_classes_target": 5}
    elif case == "single":
        preds[:] = 0
    elif case == "perfect":
        preds = np.array([3, 0, 4, 1, 2], np.int32)[target]
    return preds, target, spaces


def _intrinsic(case, seed=1, n=N, d=5):
    """``(data, labels, num_labels, mask)``: four clusters in 5-D around
    spread centres; "declared" adds two empty clusters, "masked" drops every
    fifth row through a mask."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, n).astype(np.int32)
    centres = rng.normal(scale=3.0, size=(4, d))
    data = (centres[labels] + rng.normal(size=(n, d))).astype(np.float32)
    num_labels = {"random": None, "declared": 6, "masked": 4}[case]
    mask = (np.arange(n) % 5 != 0) if case == "masked" else None
    return data, labels, num_labels, mask


def test_exports_match_the_jax_package():
    assert sorted(cl.__all__) == sorted(jax_cl.__all__)
    assert sorted(fc.__all__) == sorted(jax_fc.__all__)
    import tpumetrics_torch
    import tpumetrics_torch.functional

    assert set(jax_cl.__all__) <= set(tpumetrics_torch.__all__)
    assert set(jax_fc.__all__) <= set(tpumetrics_torch.functional.__all__)


@pytest.mark.parametrize("case", ["random", "declared", "dropped", "single", "perfect"])
def test_contingency_and_pair_matrices_are_the_jax_ones(case):
    p, t, spaces = _labels(case)
    got = utils.calculate_contingency_matrix(torch.from_numpy(p), torch.from_numpy(t), **spaces)
    want = jax_utils.calculate_contingency_matrix(jnp.asarray(p), jnp.asarray(t), **spaces)
    assert got.dtype == torch.float32 and np.array_equal(_np(got), np.asarray(want))
    pairs = utils.calculate_pair_cluster_confusion_matrix(contingency=got)
    assert np.array_equal(_np(pairs), np.asarray(jax_utils.calculate_pair_cluster_confusion_matrix(contingency=want)))
    mask = np.arange(N) % 3 != 1
    masked = utils.calculate_contingency_matrix(
        torch.from_numpy(p), torch.from_numpy(t), mask=torch.from_numpy(mask), **spaces
    )
    jmasked = jax_utils.calculate_contingency_matrix(jnp.asarray(p), jnp.asarray(t), mask=jnp.asarray(mask), **spaces)
    assert np.array_equal(_np(masked), np.asarray(jmasked))


EXTRINSIC = [
    ("mutual_info_score", {}),
    *[("normalized_mutual_info_score", {"average_method": m}) for m in ("min", "geometric", "arithmetic", "max")],
    *[("adjusted_mutual_info_score", {"average_method": m}) for m in ("min", "geometric", "arithmetic", "max")],
    ("rand_score", {}),
    ("adjusted_rand_score", {}),
    ("fowlkes_mallows_index", {}),
    ("homogeneity_score", {}),
    ("completeness_score", {}),
    ("v_measure_score", {}),
    ("v_measure_score", {"beta": 2.0}),
]


@pytest.mark.parametrize("case", ["random", "declared", "dropped", "single", "perfect"])
@pytest.mark.parametrize(("name", "kwargs"), EXTRINSIC, ids=[f"{n}-{'-'.join(map(str, k.values()))}" for n, k in EXTRINSIC])
def test_extrinsic_functional_matches_jax(name, kwargs, case):
    p, t, spaces = _labels(case)
    got = getattr(fc, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs, **spaces)
    want = getattr(jax_fc, name)(jnp.asarray(p), jnp.asarray(t), **kwargs, **spaces)
    assert got.dtype == torch.float32 and got.shape == ()
    if name == "adjusted_mutual_info_score":
        _close(got, want, 0.0, AMI_ATOL)
    else:
        _close(got, want)


@pytest.mark.parametrize("case", ["random", "declared", "masked"])
@pytest.mark.parametrize(("name", "kwargs"), [
    ("calinski_harabasz_score", {}), ("davies_bouldin_score", {}), ("dunn_index", {"p": 2}), ("dunn_index", {"p": 1}),
])
def test_intrinsic_functional_matches_jax(name, kwargs, case):
    x, labels, num_labels, mask = _intrinsic(case)
    extra = {} if mask is None else {"mask": mask}
    got = getattr(fc, name)(
        torch.from_numpy(x), torch.from_numpy(labels), num_labels=num_labels, **kwargs,
        **{k: torch.from_numpy(v) for k, v in extra.items()},
    )
    want = getattr(jax_fc, name)(
        jnp.asarray(x), jnp.asarray(labels), num_labels=num_labels, **kwargs,
        **{k: jnp.asarray(v) for k, v in extra.items()},
    )
    _close(got, want, INTRINSIC_RTOL, 0.0)


@pytest.mark.parametrize("budget", [1 << 23, 64, 7])
def test_expected_mutual_info_is_the_jax_float64_value_in_any_chunking(monkeypatch, budget):
    """The port's device grid against the JAX package's host float64 grid,
    whole and in chunks of rows and of n_ij values (a budget of 64 or 7
    elements splits the 6 x 5 table into row chunks, one n_ij at a time)."""
    monkeypatch.setattr(ami, "_EMI_BUDGET", budget)
    for case in ("random", "declared", "dropped"):
        p, t, spaces = _labels(case, seed=3)
        table = utils.calculate_contingency_matrix(torch.from_numpy(p), torch.from_numpy(t), **spaces)
        got = ami.expected_mutual_info_score(table, table.sum())
        want = jax_ami._expected_mutual_info_host(_np(table).astype(np.float64), int(table.sum()))
        assert got.dtype == torch.float32
        _close(got, want, 1e-6, 0.0)


def test_edge_cases_as_the_jax_package_pins_them():
    """Single-cluster partitions, perfect agreement and a relabelled
    perfect partition (the JAX package's ``tests/clustering/test_edge_cases.py``)."""
    const = torch.zeros(12, dtype=torch.int32)
    mixed = torch.tensor([0, 1, 2] * 4, dtype=torch.int32)
    assert float(fc.adjusted_rand_score(const, const)) == pytest.approx(1.0)
    assert float(fc.rand_score(const, const)) == pytest.approx(1.0)
    assert float(fc.adjusted_rand_score(const, mixed)) == pytest.approx(0.0)
    assert float(fc.normalized_mutual_info_score(const, mixed)) == pytest.approx(0.0)
    assert float(fc.adjusted_rand_score(mixed, mixed)) == pytest.approx(1.0)
    assert float(fc.normalized_mutual_info_score(mixed, mixed)) == pytest.approx(1.0)
    assert float(fc.adjusted_rand_score(mixed, torch.tensor([2, 0, 1] * 4))) == pytest.approx(1.0)


def test_input_checks_raise_as_in_jax():
    with pytest.raises(ValueError, match="real, discrete"):
        fc.mutual_info_score(torch.rand(4), torch.tensor([0, 1, 0, 1]))
    with pytest.raises(RuntimeError, match="same shape"):
        fc.rand_score(torch.tensor([0, 1]), torch.tensor([0, 1, 1]))
    with pytest.raises(ValueError, match="average_method"):
        fc.normalized_mutual_info_score(torch.tensor([0, 1]), torch.tensor([0, 1]), "median")
    with pytest.raises(ValueError, match="positive real"):
        utils.calculate_generalized_mean(torch.tensor([1.0, -2.0]), "arithmetic")
    with pytest.raises(ValueError, match="greater than one"):
        fc.calinski_harabasz_score(torch.rand(4, 2), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="2D data"):
        fc.davies_bouldin_score(torch.rand(4), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="positive float"):
        cl.VMeasureScore(beta=0.0, device="cpu")
    _close(utils.calculate_generalized_mean(torch.tensor([1.0, 4.0]), 2), jax_utils.calculate_generalized_mean(jnp.asarray([1.0, 4.0]), 2))


MODULAR = [
    ("MutualInfoScore", {}), ("NormalizedMutualInfoScore", {"average_method": "geometric"}),
    ("AdjustedMutualInfoScore", {"average_method": "max"}), ("RandScore", {}), ("AdjustedRandScore", {}),
    ("FowlkesMallowsIndex", {}), ("HomogeneityScore", {}), ("CompletenessScore", {}), ("VMeasureScore", {"beta": 0.5}),
    ("CalinskiHarabaszScore", {}), ("DaviesBouldinScore", {}), ("DunnIndex", {"p": 2}),
]
INTRINSIC_CLASSES = ("CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex")


def _batches(name, declared=False):
    """Three batches of 32 rows: label pairs, or data and labels."""
    out = []
    for s in range(3):
        if name in INTRINSIC_CLASSES:
            x, labels, _, _ = _intrinsic("random", seed=10 + s, n=32)
            out.append((x, labels))
        else:
            p, t, _ = _labels("declared" if declared else "random", seed=10 + s, n=32)
            out.append((p, t))
    return out


@pytest.mark.parametrize("declared", [False, True])
@pytest.mark.parametrize(("name", "kwargs"), MODULAR, ids=[n for n, _ in MODULAR])
def test_modular_states_and_values_match_jax(name, kwargs, declared):
    if declared:
        kwargs = {**kwargs, **({"num_labels": 4} if name in INTRINSIC_CLASSES else {"num_classes_preds": 8, "num_classes_target": 7})}
    port, ref = getattr(cl, name)(**kwargs, device="cpu"), getattr(jax_cl, name)(**kwargs)
    for a, b in _batches(name, declared):
        port.update(torch.from_numpy(a), torch.from_numpy(b))
        ref.update(jnp.asarray(a), jnp.asarray(b))
    for key, states in export_state(port).items():
        want = getattr(ref, key)
        assert len(states) == len(want)
        assert all(s.dtype == np.asarray(w).dtype and np.array_equal(s, np.asarray(w)) for s, w in zip(states, want))
    tol = (INTRINSIC_RTOL, 0.0) if name in INTRINSIC_CLASSES else ((0.0, AMI_ATOL) if name.startswith("Adjusted") else (RTOL, ATOL))
    _close(port.compute(), ref.compute(), *tol)
    p, t = _batches(name)[0]
    _close(port.forward(torch.from_numpy(p), torch.from_numpy(t)), ref.forward(jnp.asarray(p), jnp.asarray(t)), *tol)


CAPACITY = [("MutualInfoScore", {}), ("RandScore", {}), ("VMeasureScore", {}), ("AdjustedMutualInfoScore", {}),
            ("FowlkesMallowsIndex", {}), ("CalinskiHarabaszScore", {}), ("DaviesBouldinScore", {}), ("DunnIndex", {})]
SIZES = (32, 17, 45)  # uneven batches: 94 valid rows of a capacity of 160, an invalid tail the mask drops


def _capacity_pair(name, kwargs, cap=160):
    intrinsic = name in INTRINSIC_CLASSES
    spaces = {"num_labels": 4} if intrinsic else {"num_classes_preds": 6, "num_classes_target": 5}
    port, ref = getattr(cl, name)(**kwargs, **spaces, device="cpu"), getattr(jax_cl, name)(**kwargs, **spaces)
    for m in (port, ref):
        for state in m._defaults:
            m.set_state_capacity(state, cap, feature_shape=(5,) if state == "data" else ())
    rows = []
    for s, n in enumerate(SIZES):
        if intrinsic:
            x, labels, _, _ = _intrinsic("random", seed=20 + s, n=n)
            rows.append((x, labels))
        else:
            p, t, _ = _labels("random", seed=20 + s, n=n)
            rows.append((p, t))
    return port, ref, rows


@pytest.mark.parametrize(("name", "kwargs"), CAPACITY, ids=[n for n, _ in CAPACITY])
def test_capacity_buffers_with_uneven_batches_match_jax(name, kwargs):
    """Fixed-capacity buffer states (``set_state_capacity``) through the
    functional bridge, as the JAX package's jitted clustering test runs them:
    the buffers equal the JAX ones, and the value equals the JAX eager
    compute of the same state and the port's exact list path."""
    port, ref, rows = _capacity_pair(name, kwargs)
    state, jstate = port.init_state(), ref.init_state()
    exact = getattr(cl, name)(**kwargs, device="cpu")
    for a, b in rows:
        state = port.functional_update(state, torch.from_numpy(a), torch.from_numpy(b))
        jstate = ref.functional_update(jstate, jnp.asarray(a), jnp.asarray(b))
        exact.update(torch.from_numpy(a), torch.from_numpy(b))
    for key, buf in state.items():
        assert isinstance(buf, MaskedBuffer) and int(buf.count) == sum(SIZES)
        for got, want in zip(buf, jstate[key]):
            assert np.array_equal(_np(got), np.asarray(want)) and _np(got).dtype == np.asarray(want).dtype
    value = port.functional_compute(state)
    tol = (INTRINSIC_RTOL, 0.0) if name in INTRINSIC_CLASSES else ((0.0, AMI_ATOL) if name.startswith("Adjusted") else (RTOL, ATOL))
    _close(value, ref.functional_compute(jstate), *tol)
    _close(value, exact.compute(), *tol)
    if name == "AdjustedMutualInfoScore":  # the JAX package's jitted compute: a float32 EMI grid
        _close(value, jax.jit(ref.functional_compute)(jstate), 0.0, AMI_F32_ATOL)


def _members(pkg, **kw):
    return {
        "mi": pkg.MutualInfoScore(**kw), "nmi": pkg.NormalizedMutualInfoScore(**kw),
        "ami": pkg.AdjustedMutualInfoScore(**kw), "ari": pkg.AdjustedRandScore(**kw), "v": pkg.VMeasureScore(**kw),
        "ch": pkg.CalinskiHarabaszScore(**kw), "db": pkg.DaviesBouldinScore(**kw), "dunn": pkg.DunnIndex(**kw),
    }


def test_collection_groups_form_as_in_the_jax_package():
    """Label-pair members share their preds/target states and intrinsic
    members their data/labels: two groups, as in the JAX package, with every
    value equal."""
    port = MetricCollection(_members(cl, device="cpu"), device="cpu")
    ref = tpumetrics.MetricCollection(_members(jax_cl))
    for s in range(2):
        p, t, _ = _labels("random", seed=30 + s, n=48)
        x, labels, _, _ = _intrinsic("random", seed=30 + s, n=48)
        port.update(preds=torch.from_numpy(p), target=torch.from_numpy(t), data=torch.from_numpy(x), labels=torch.from_numpy(labels))
        ref.update(preds=jnp.asarray(p), target=jnp.asarray(t), data=jnp.asarray(x), labels=jnp.asarray(labels))
    groups = sorted(sorted(g) for g in port.compute_groups.values())
    assert groups == sorted(sorted(g) for g in ref.compute_groups.values())
    assert groups == [["ami", "ari", "mi", "nmi", "v"], ["ch", "db", "dunn"]]
    got, want = port.compute(), ref.compute()
    for k in want:
        _close(got[k], want[k], *((INTRINSIC_RTOL, 0.0) if k in ("ch", "db", "dunn") else (RTOL, AMI_ATOL)))


def _buffered(metric, cap):
    """``metric`` with every list state a fixed-capacity buffer, live: its
    eager update appends to the buffers."""
    for state in metric._defaults:
        metric.set_state_capacity(state, cap, feature_shape=(5,) if state == "data" else ())
    load_state(metric, metric.init_state())
    return metric


def test_collection_of_members_holding_buffers_forms_groups_as_jax():
    """Members whose live states are MaskedBuffers form their compute groups
    as the JAX package's collection does (the port's group merge raised an
    ``AttributeError`` on such a state before), and compute its values."""
    from tpumetrics.buffers import _BufferList as JaxBufferList

    def make(pkg, **kw):
        spaces = {"num_classes_preds": 6, "num_classes_target": 5}
        members = {"mi": pkg.MutualInfoScore(**spaces, **kw), "ari": pkg.AdjustedRandScore(**spaces, **kw),
                   "rand": pkg.RandScore(**kw)}
        for name in ("mi", "ari"):
            for state in members[name]._defaults:
                members[name].set_state_capacity(state, 200)
        return members

    port_members, ref_members = make(cl, device="cpu"), make(jax_cl)
    for name in ("mi", "ari"):
        _buffered(port_members[name], 200)
        for state, buf in ref_members[name].init_state().items():
            object.__setattr__(ref_members[name], state, JaxBufferList(buf))
    port, ref = MetricCollection(port_members, device="cpu"), tpumetrics.MetricCollection(ref_members)
    for s in range(2):
        p, t, _ = _labels("random", seed=35 + s, n=48)
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    groups = sorted(sorted(g) for g in port.compute_groups.values())
    assert groups == sorted(sorted(g) for g in ref.compute_groups.values()) == [["ari", "mi"], ["rand"]]
    got, want = port.compute(), ref.compute()
    for k in want:
        _close(got[k], want[k])


def test_fused_collection_of_buffered_members_is_bit_for_bit_the_unfused_one():
    """Members whose live states are MaskedBuffers (declared class spaces,
    a capacity, ``load_state(m, m.init_state())``) are fusable leaders: on
    the CPU the step takes its card path (eager, then its stand-in for a
    capture, then replays), every buffer equals the unfused collection's bit
    for bit after every update, list-state members stay eager beside them,
    and a ``reset`` puts lists back and leaves the members eager."""

    def make(fused):
        spaces = {"num_classes_preds": 6, "num_classes_target": 5, "device": "cpu"}
        members = {
            "mi": _buffered(cl.MutualInfoScore(**spaces), 400), "ami": _buffered(cl.AdjustedMutualInfoScore(**spaces), 400),
            "ari": _buffered(cl.AdjustedRandScore(**spaces), 400), "rand_list": cl.RandScore(device="cpu"),
        }
        return MetricCollection(members, fused_update=fused, device="cpu")

    plain, fused = make(False), make(True)
    for s in range(5):
        p, t, _ = _labels("random", seed=40 + s % 2, n=64)
        plain.update(torch.from_numpy(p), torch.from_numpy(t))
        fused.update(torch.from_numpy(p), torch.from_numpy(t))
        got, want = export_state(fused), export_state(plain)
        assert sorted(got) == sorted(want) == ["ami", "rand_list"]
        for name, ref in want["ami"].items():
            assert all(np.array_equal(a, b) for a, b in zip(got["ami"][name], ref))
        assert all(np.array_equal(a, b) for a, b in zip(got["rand_list"]["preds"], want["rand_list"]["preds"]))
    step = fused._fused_oo_step
    assert step.leaders == ["ami"] and step.counts == {"eager": 1, "captured": 1, "replayed": 2, "unfused": 0}
    for k, v in plain.compute().items():
        assert torch.equal(fused.compute()[k], v)
    fused.reset()
    p, t, _ = _labels("random", seed=40, n=64)
    fused.update(torch.from_numpy(p), torch.from_numpy(t))
    assert fused._fused_oo_step is None and isinstance(fused["ami"].preds, list)


def test_jax_states_carry_into_the_port():
    """A JAX metric's list states (int32 labels, float32 data) and its
    MaskedBuffer states, updated on some batches, load into the port
    (``interop.load_state``) and compute the JAX value; the port's exported
    states load back into the JAX functional compute."""
    for name, kwargs in (("AdjustedMutualInfoScore", {}), ("DaviesBouldinScore", {})):
        ref = getattr(jax_cl, name)(**kwargs)
        for a, b in _batches(name):
            ref.update(jnp.asarray(a), jnp.asarray(b))
        port = getattr(cl, name)(**kwargs, device="cpu")
        load_state(port, {k: [np.asarray(v) for v in getattr(ref, k)] for k in ref._defaults})
        port._update_count = 3
        tol = (INTRINSIC_RTOL, 0.0) if name in INTRINSIC_CLASSES else (0.0, AMI_ATOL)
        _close(port.compute(), ref.compute(), *tol)
        back = {k: [jnp.asarray(x) for x in v] for k, v in export_state(port).items()}
        _close(port.compute(), ref.functional_compute(back), *tol)

        jport, jref, rows = _capacity_pair(name, kwargs)
        jstate = jref.init_state()
        for a, b in rows:
            jstate = jref.functional_update(jstate, jnp.asarray(a), jnp.asarray(b))
        load_state(jport, {k: JaxMaskedBuffer(*(np.asarray(x) for x in v)) for k, v in jstate.items()})
        jport._update_count = 3
        _close(jport.compute(), jref.functional_compute(jstate), *tol)
