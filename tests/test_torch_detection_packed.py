"""The packed (dense) detection update of the port on the CPU.

``pack_detection_batch`` against the JAX package's, the packed update
against the list-of-dicts one and against the JAX packed update (every
``compute()`` entry bit for bit; ``valid`` masks of padded images), the
row states as MaskedBuffers through the port's ``FusedCollectionStep``
given the two dicts positionally (first sighting eager, then captured and
replayed) and through a fused ``MetricCollection``, the capacity overflow
and 2^24 image-id guards, the refusal of a packed state's cross-rank merge,
and a gloo world of 2 merging the list states with their image boundaries
(``tests/torch_sync_worker.py``). The JAX side runs with
``TPUMETRICS_JIT_MATCHER=0`` (see ``tests/test_torch_detection_map.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sync_worker as w
import tpumetrics.detection as jdet
from tpumetrics.detection.packing import pack_detection_batch as jax_pack
from tpumetrics_torch import MetricCollection, interop
from tpumetrics_torch.buffers import MaskedBuffer
from tpumetrics_torch.detection import MeanAveragePrecision, pack_detection_batch
from tpumetrics_torch.parallel import FusedCollectionStep, NoOpBackend
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

PREDS, TARGET = w.detection_images(n=22, seed=41)
DET_SLOTS, GT_SLOTS = 16, 8


@pytest.fixture(autouse=True)
def _numpy_matcher(monkeypatch):
    monkeypatch.setenv("TPUMETRICS_JIT_MATCHER", "0")


def _t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _packed(lo, hi, **kw):
    return pack_detection_batch(PREDS[lo:hi], TARGET[lo:hi], det_slots=DET_SLOTS, gt_slots=GT_SLOTS, **kw)


def _batches(size=4):
    return [(lo, min(lo + size, len(PREDS))) for lo in range(0, len(PREDS), size)]  # the last one ragged


def _list_reference(kw=None):
    m = MeanAveragePrecision(device="cpu", **(kw or {}))
    for lo, hi in _batches():
        m.update([_t(p) for p in PREDS[lo:hi]], [_t(t) for t in TARGET[lo:hi]])
    return m.compute()


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# --------------------------------------------------------------- packing


@pytest.mark.parametrize("slots", [(None, None), (DET_SLOTS, GT_SLOTS)])
def test_packing_is_the_jax_packages(slots):
    got = pack_detection_batch(PREDS[:6], TARGET[:6], det_slots=slots[0], gt_slots=slots[1])
    want = jax_pack(PREDS[:6], TARGET[:6], det_slots=slots[0], gt_slots=slots[1])
    for g, wd in zip(got, want):
        assert sorted(g) == sorted(wd)
        for k in wd:
            assert g[k].dtype == wd[k].dtype and np.array_equal(g[k], wd[k]), k


def test_packing_refuses_what_the_jax_package_refuses():
    with pytest.raises(ValueError, match="missing"):
        pack_detection_batch([{"boxes": np.zeros((1, 4))}], [TARGET[0]])
    with pytest.raises(ValueError, match="slot budget"):
        pack_detection_batch(PREDS[:2], TARGET[:2], det_slots=1)
    big = [{**PREDS[0], "labels": np.full(len(PREDS[0]["labels"]), 2**24 + 1)}]
    with pytest.raises(ValueError, match="2\\^24"):
        pack_detection_batch(big, TARGET[:1])
    with pytest.raises(ValueError, match="images but target"):
        pack_detection_batch(PREDS[:2], TARGET[:1])


# ------------------------------------------------------------ the update


@pytest.mark.parametrize("kw", [{}, {"class_metrics": True}, {"average": "micro"}, {"box_format": "xywh"}])
def test_packed_updates_equal_list_updates_and_the_jax_packed_ones(kw):
    port, ref = MeanAveragePrecision(device="cpu", **kw), jdet.MeanAveragePrecision(**kw)
    for lo, hi in _batches():
        pd, gd = _packed(lo, hi)
        port.update(_t(pd), _t(gd))
        ref.update(_j(pd), _j(gd))
    got = port.compute()
    _same(got, _list_reference(kw))
    want = ref.compute()
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])) and got[k].numpy().dtype == np.asarray(want[k]).dtype, k


def test_valid_masks_drop_padded_images():
    port, ref = MeanAveragePrecision(device="cpu"), jdet.MeanAveragePrecision()
    for lo, hi in _batches(5):
        pd, gd = _packed(lo, hi)
        pad = 8 - (hi - lo)  # pad every batch to 8 images with copies of its first, masked out
        pd = {k: np.concatenate([v, np.repeat(v[:1], pad, 0)]) for k, v in pd.items()}
        gd = {k: np.concatenate([v, np.repeat(v[:1], pad, 0)]) for k, v in gd.items()}
        valid = np.arange(8) < hi - lo
        port.update(_t(pd), _t(gd), torch.from_numpy(valid))
        ref.update(_j(pd), _j(gd), jnp.asarray(valid))
    got, want = port.compute(), ref.compute()
    _same(got, _list_reference())
    assert int(port.packed_imgs) == len(PREDS)
    assert all(np.array_equal(got[k].numpy(), np.asarray(want[k])) for k in want)


def test_packed_state_layout():
    m = MeanAveragePrecision(device="cpu")
    pd, gd = _packed(0, 4)
    m.update(_t(pd), _t(gd))
    assert [tuple(r.shape) for r in m.det_rows] == [(4 * DET_SLOTS, 7)] and m.det_rows[0].dtype == torch.float32
    assert [tuple(r.shape) for r in m.gt_rows] == [(4 * GT_SLOTS, 8)] and m.gt_rows[0].dtype == torch.float32
    assert m.packed_imgs.dtype == torch.int32 and int(m.packed_imgs) == 4
    ids = m.det_rows[0][:, -1].reshape(4, DET_SLOTS)
    for i in range(4):  # real rows carry their image id, pad rows -1
        n = len(PREDS[i]["scores"])
        assert torch.all(ids[i, :n] == i) and torch.all(ids[i, n:] == -1)


def test_layout_misuse_is_refused():
    m = MeanAveragePrecision(device="cpu")
    pd, gd = _packed(0, 2)
    with pytest.raises(TPUMetricsUserError, match="valid"):
        m.update([_t(p) for p in PREDS[:2]], [_t(t) for t in TARGET[:2]], torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="BOTH"):
        m.update(_t(pd), [_t(t) for t in TARGET[:2]])
    with pytest.raises(ValueError, match="count"):
        m.update({**pd, "count": np.full(2, DET_SLOTS + 1, np.int32)}, gd)
    with pytest.raises(ValueError, match="missing"):
        m.update({k: v for k, v in _t(pd).items() if k != "scores"}, _t(gd))
    with pytest.raises(TPUMetricsUserError, match="bbox"):
        MeanAveragePrecision(iou_type="segm", device="cpu").update(_t(pd), _t(gd))
    m.update(_t(pd), _t(gd))
    with pytest.raises(NotImplementedError, match="packed"):
        m.tm_to_coco("unused")


# ----------------------------------------------- buffers and the fused step


def _buffered(det_capacity=1024, gt_capacity=512):
    m = MeanAveragePrecision(det_capacity=det_capacity, gt_capacity=gt_capacity, device="cpu")
    interop.load_state(m, m.init_state())
    return m


def test_masked_buffer_state_through_the_fused_step_with_dict_positionals():
    m = MeanAveragePrecision(det_capacity=1024, gt_capacity=512, device="cpu")
    step = FusedCollectionStep(m)
    state = step.init_state()
    assert isinstance(state["det_rows"], MaskedBuffer) and state["detection_scores"] == []
    for lo, hi in _batches():
        pd, gd = _packed(lo, hi)
        state = step.update(state, _t(pd), _t(gd))
    assert step.counts == {"eager": 2, "captured": 1, "replayed": 3, "unfused": 0}  # the ragged last batch eager
    _same(m.functional_compute(state), _list_reference())


def test_a_fused_collection_replays_the_packed_update():
    col = MetricCollection({"map": _buffered()}, fused_update=True, device="cpu")
    for lo, hi in _batches():
        pd, gd = _packed(lo, hi)
        col.update(_t(pd), _t(gd))
    assert col._fused_oo_step.leaders == ["map"]
    assert col._fused_oo_step.counts["replayed"] == 2 and col._fused_oo_step.counts["eager"] == 2
    _same(col["map"].compute(), _list_reference())


def test_a_list_update_leaves_the_fused_step_for_the_eager_path():
    col = MetricCollection({"map": _buffered()}, fused_update=True, device="cpu")
    for lo, hi in _batches()[:3]:
        pd, gd = _packed(lo, hi)
        col.update(_t(pd), _t(gd))
    col.update([_t(p) for p in PREDS[12:]], [_t(t) for t in TARGET[12:]])  # lists: not a key, run eagerly
    assert col._fused_oo_step.counts["unfused"] == 1
    col.update(*(_t(d) for d in _packed(0, 2)))  # the per-image lists now hold tensors: the metric stays eager
    assert "map" not in (col._fused_oo_step.leaders if col._fused_oo_step else [])


def test_buffer_overflow_raises_at_compute():
    m = _buffered(det_capacity=8, gt_capacity=8)
    m.update(*(_t(d) for d in _packed(0, 4)))
    with pytest.raises(TPUMetricsUserError, match="overflowed"):
        m.compute()


def test_image_ids_past_2_to_the_24_raise():
    m = MeanAveragePrecision(device="cpu")
    m.update(*(_t(d) for d in _packed(0, 2)))
    m.packed_imgs = torch.tensor(2**24 + 1, dtype=torch.int32)
    with pytest.raises(TPUMetricsUserError, match="2\\^24"):
        m.compute()


def test_merged_packed_id_spaces_are_caught():
    a, b = MeanAveragePrecision(device="cpu"), MeanAveragePrecision(device="cpu")
    a.update(*(_t(d) for d in _packed(0, 3)))
    b.update(*(_t(d) for d in _packed(3, 6)))
    a.det_rows = a.det_rows + b.det_rows  # what a cat-merge of two ranks' packed states would hold
    a.gt_rows = a.gt_rows + b.gt_rows
    a.packed_imgs = a.packed_imgs + b.packed_imgs
    with pytest.raises(TPUMetricsUserError, match="distinct id spaces"):
        a.compute()


class _TwoRanks(NoOpBackend):
    def available(self) -> bool:
        return True

    def world_size(self) -> int:
        return 2


def test_a_cross_rank_sync_of_packed_rows_is_refused():
    m = MeanAveragePrecision(device="cpu")
    m.update(*(_t(d) for d in _packed(0, 2)))
    with pytest.raises(TPUMetricsUserError, match="cannot sync"):
        m.sync_state(m._copy_state_dict(), _TwoRanks())
    lists = MeanAveragePrecision(device="cpu")
    lists.update([_t(p) for p in PREDS[:2]], [_t(t) for t in TARGET[:2]])
    lists.sync_state(lists._copy_state_dict(), _TwoRanks())  # list states sync


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return w.run_worlds((2,), tmp_path_factory.mktemp("detection"), ["detection"])


def test_gloo_world_of_2_merges_list_states_with_their_image_boundaries(gloo, monkeypatch):
    monkeypatch.setenv("TPUMETRICS_JIT_MATCHER", "0")
    preds, target = w.detection_images()
    ref = jdet.MeanAveragePrecision(class_metrics=True)
    ref.update([_j(p) for p in preds], [_j(t) for t in target])
    want = ref.compute()
    for rank in gloo[2]:
        got = rank["detection"]["values"]
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], np.asarray(want[k])) and got[k].dtype == np.asarray(want[k]).dtype, k
        assert "cannot sync" in rank["detection"]["packed_refused"]
        assert rank["modules"] == []
