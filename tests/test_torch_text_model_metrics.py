"""BERTScore and InfoLM of the port against the JAX package, on the CPU.

Both packages get the same inputs: the JAX test's ``_WordTokenizer`` and
its toy embedding table and masked LM (``tests/multimodal/test_model_metrics.py``,
the same numpy tables in torch), and the port's own encoders against
``transformers``' Flax BERT, RoBERTa and BERT masked LM at tiny widths (two
layers, width 32, vocab 100) with the same random weights. Tolerances:
``SCORE_ATOL`` for P, R and F1 and InfoLM's scores (float32 embeddings,
distributions and sums in another order); the encoders' scores
``ENCODER_ATOL`` (two float32 networks apart by some 1e-7 of their hidden
states). The gated defaults are run with the Hugging Face hub's offline
switches set, so no loader reaches the network.
"""

from __future__ import annotations

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.functional.text as jax_text_fn
import tpumetrics.text as jax_text
import tpumetrics_torch.functional.text as text_fn
from tests.multimodal.test_model_metrics import _ToyEmbedder, _ToyMLM, _WordTokenizer
from tpumetrics_torch.text import BERTScore, InfoLM
from tpumetrics_torch.text._bert_encoder import build

SCORE_ATOL = 1e-5
ENCODER_ATOL = 1e-5
PREDS = ["the cat sat on the mat", "a dog barked at the moon", "hello there general kenobi", "one two three"]
TARGET = ["the cat sat on a mat", "the dog barked", "hello there", "three two one four"]


@pytest.fixture(autouse=True, scope="module")
def _offline():
    """The hub's offline switches, read when a loader runs: no download is tried."""
    import huggingface_hub.constants
    import transformers.utils.hub

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
        mp.setattr(transformers.utils.hub, "_is_offline_mode", True)
        yield


class _TorchEmbedder:
    """``_ToyEmbedder``'s table in torch."""

    def __init__(self, seed=0):
        self.table = torch.from_numpy(np.array(_ToyEmbedder(seed=seed).table))

    def __call__(self, model, batch):
        return self.table[batch["input_ids"]]


class _TorchMLM:
    """``_ToyMLM`` in torch: a table of logits plus twice the sequence's mean."""

    def __init__(self, seed=0):
        self.table = torch.from_numpy(np.array(_ToyMLM(seed=seed).table))

    def __call__(self, input_ids, attention_mask=None):
        from types import SimpleNamespace

        logits = self.table[input_ids]
        return SimpleNamespace(logits=logits + 2.0 * logits.mean(dim=1, keepdim=True))


# one instance each: the JAX package compiles its embedding pipeline once per (model, forward) identity
JAX_EMB, EMB = _ToyEmbedder(), _TorchEmbedder()


def _close(got, want, atol=SCORE_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=0, atol=atol)


def _write_baseline(path):
    path.write_text("LAYER,P,R,F\n0,0.9,0.9,0.9\n1,0.3,0.4,0.5\n2,0.2,0.1,0.3\n3,0.1,0.2,0.3\n")
    return str(path)


# ------------------------------------------------------------------ BERTScore, toy embedder


@pytest.mark.parametrize("case", ["plain", "idf", "batch_size=1", "baseline", "hash"])
def test_bert_score_matches_jax(case, tmp_path):
    tok, jax_emb, emb = _WordTokenizer(), JAX_EMB, EMB
    kw = {"idf": {"idf": True}, "batch_size=1": {"batch_size": 1}, "hash": {"return_hash": True},
          "baseline": {"rescale_with_baseline": True, "baseline_path": _write_baseline(tmp_path / "b.csv")}}.get(case, {})
    want = jax_text_fn.bert_score(PREDS, TARGET, model=jax_emb, user_tokenizer=tok, user_forward_fn=jax_emb, **kw)
    got = text_fn.bert_score(PREDS, TARGET, model=emb, user_tokenizer=tok, user_forward_fn=emb, device="cpu", **kw)
    for key in ("precision", "recall", "f1"):
        assert got[key].shape == (len(PREDS),) and got[key].dtype == torch.float32
        _close(got[key], want[key])
    assert got.get("hash") == want.get("hash")


def test_bert_score_all_layers_and_layer_axis_match_jax():
    """A three-layer forward: (layers, n) outputs, layer 0 the single-layer run's."""
    tok, jax_emb, emb = _WordTokenizer(), JAX_EMB, EMB

    def jax_three(model, batch):
        h = jax_emb(model, batch)
        return jnp.stack([h, 0.5 * h + 0.1, -h], axis=1)

    def three(model, batch):
        h = emb(model, batch)
        return torch.stack([h, 0.5 * h + 0.1, -h], dim=1)

    want = jax_text_fn.bert_score(PREDS, TARGET, model=object(), user_tokenizer=tok, user_forward_fn=jax_three)
    got = text_fn.bert_score(PREDS, TARGET, model=emb, user_tokenizer=tok, user_forward_fn=three, device="cpu",
                             batch_size=3)
    single = text_fn.bert_score(PREDS, TARGET, model=emb, user_tokenizer=tok, user_forward_fn=emb, device="cpu")
    for key in ("precision", "recall", "f1"):
        assert got[key].shape == (3, len(PREDS))
        _close(got[key], want[key])
        assert torch.allclose(got[key][0], single[key], atol=1e-6)


def test_bert_score_perfect_match_and_ordering():
    tok, emb = _WordTokenizer(), EMB
    out = text_fn.bert_score(PREDS, PREDS, model=emb, user_tokenizer=tok, user_forward_fn=emb, device="cpu")
    assert torch.allclose(out["f1"], torch.ones(len(PREDS)), atol=1e-5)
    close = text_fn.bert_score(["the quick brown fox leaps"], ["the quick brown fox jumps"], model=emb,
                               user_tokenizer=tok, user_forward_fn=emb, device="cpu")
    far = text_fn.bert_score(["completely unrelated words entirely different"], ["the quick brown fox jumps"],
                             model=emb, user_tokenizer=tok, user_forward_fn=emb, device="cpu")
    assert float(close["f1"][0]) > float(far["f1"][0])


def test_bert_score_errors_as_jax():
    tok, emb = _WordTokenizer(), EMB
    with pytest.raises(ValueError, match="same length"):
        text_fn.bert_score(["a"], ["a", "b"], model=emb, user_tokenizer=tok, device="cpu")
    with pytest.raises(ValueError, match="user_tokenizer"):
        text_fn.bert_score(["a"], ["a"], model=emb, device="cpu")
    with pytest.raises(NotImplementedError, match="baseline_path"):
        text_fn.bert_score(["a"], ["a"], model=emb, user_tokenizer=tok, user_forward_fn=emb,
                           rescale_with_baseline=True, device="cpu")
    with pytest.raises(NotImplementedError, match="baseline_path"):
        BERTScore(model=emb, user_tokenizer=tok, user_forward_fn=emb, rescale_with_baseline=True, device="cpu")


class _Absent:
    """A ``transformers`` class whose checkpoint is absent: ``from_pretrained`` raises as offline."""

    @classmethod
    def from_pretrained(cls, name, *args, **kwargs):
        raise OSError(f"{name} is not in the cache and the hub is offline")


def test_default_hub_ids_are_gated_with_the_jax_messages(monkeypatch):
    """The port's loaders fail on the absent configuration; the JAX ones'
    classes are stood in for by ``_Absent`` (its real ones would import the
    modeling code, some seconds, for the same error)."""
    import importlib

    import transformers

    for name in ("AutoTokenizer", "FlaxAutoModel", "FlaxAutoModelForMaskedLM"):
        monkeypatch.setitem(vars(transformers), name, _Absent)  # no lazy import of the real class
    for fn, jax_fn in ((text_fn.bert_score, jax_text_fn.bert_score), (text_fn.infolm, jax_text_fn.infolm)):
        with pytest.raises(ModuleNotFoundError) as got:
            fn(["a"], ["a"], model_name_or_path="definitely-not-cached-model", device="cpu")
        with pytest.raises(ModuleNotFoundError) as want:
            jax_fn(["a"], ["a"], model_name_or_path="definitely-not-cached-model")
        assert str(got.value) == str(want.value)
    for name in ("bert", "infolm"):
        monkeypatch.setattr(importlib.import_module(f"tpumetrics_torch.functional.text.{name}"), "_TRANSFORMERS_AVAILABLE", False)
        monkeypatch.setattr(importlib.import_module(f"tpumetrics.functional.text.{name}"), "_TRANSFORMERS_AVAILABLE", False)
    for fn, jax_fn in ((text_fn.bert_score, jax_text_fn.bert_score), (text_fn.infolm, jax_text_fn.infolm)):
        with pytest.raises(ModuleNotFoundError) as got:
            fn(["a"], ["a"], device="cpu")
        with pytest.raises(ModuleNotFoundError) as want:
            jax_fn(["a"], ["a"])
        assert "requires `transformers`" in str(got.value) and str(got.value) == str(want.value)


def test_bertscore_class_matches_jax_and_keeps_host_sentences():
    tok, jax_emb, emb = _WordTokenizer(), JAX_EMB, EMB
    want_m = jax_text.BERTScore(model=jax_emb, user_tokenizer=tok, user_forward_fn=jax_emb, idf=True)
    m = BERTScore(model=emb, user_tokenizer=tok, user_forward_fn=emb, idf=True, device="cpu")
    for metric in (want_m, m):
        metric.update(PREDS[:2], TARGET[:2])
        metric.update(PREDS[2:], TARGET[2:])
    got, want = m.compute(), want_m.compute()
    for key in ("precision", "recall", "f1"):
        _close(got[key], want[key])
    assert m._update_reads_host and m.sentence_state == (PREDS, TARGET)
    m.reset()
    assert m.sentence_state == ([], [])


# ------------------------------------------------------------------ BERTScore on the backbone runtime


def _backbone(table):
    from tpumetrics_torch.backbones import get_backbone

    def forward(params, ids, mask):
        return params["emb"][ids] * mask[..., None].to(params["emb"].dtype)

    return get_backbone("test:encoder", {"emb": table}, forward=forward, pad_axes=(0, 1), device="cpu")


def test_bertscore_backbone_streams_and_matches_compute_time_and_jax():
    """Stream-time embeddings (batches of their own lengths, the engine's
    pow-2 buckets on both axes) score as the compute-time path does, bit for
    bit, and as the JAX package's toy forward within SCORE_ATOL; a snapshot
    carries no embeddings and a restored metric embeds at compute."""
    import copy

    tok, jax_emb = _WordTokenizer(), JAX_EMB
    table = np.array(jax_emb.table)
    handle = _backbone(table)
    m = BERTScore(backbone=handle, user_tokenizer=tok, device="cpu")
    m.update(PREDS[:1], TARGET[:1])
    m.update(PREDS[1:], TARGET[1:])
    assert len(m._streamed) == 2
    got = m.compute()
    full = text_fn.bert_score(PREDS, TARGET, backbone=handle, user_tokenizer=tok, device="cpu")
    want = jax_text_fn.bert_score(PREDS, TARGET, model=jax_emb, user_tokenizer=tok, user_forward_fn=jax_emb)
    for key in ("precision", "recall", "f1"):
        assert torch.equal(got[key], full[key])
        _close(got[key], want[key])
    restored = copy.deepcopy(m)
    assert restored._streamed == [] and restored.sentence_state == (PREDS, TARGET)
    for key, value in restored.compute().items():
        assert torch.equal(value, got[key])
    with pytest.raises(ValueError, match="user_tokenizer"):
        BERTScore(backbone=handle, device="cpu")
    m.release_backbones()
    restored.release_backbones()
    handle.close()


# ------------------------------------------------------------------ the port's encoders against Flax


@pytest.fixture(scope="module")
def flax_encoders():
    """``{name: (Flax model with its params bound, the port's module)}`` on the same random weights."""
    from tests.test_torch_text_encoders import flax_bert_models

    out = {}
    for name, (_, flax_model, tree, port_config, params) in flax_bert_models(seed=2).items():
        out[name] = (_Bound(flax_model, tree), build(port_config, params, mlm=name == "mlm"))
    return out


class _Bound:
    """A Flax model built without its own parameters, called with a tree (the
    JAX package calls ``model(input_ids=, attention_mask=, ...)``)."""

    def __init__(self, model, params):
        self.model, self.params = model, params

    def __call__(self, *args, **kwargs):
        return self.model(*args, params=self.params, **kwargs)


@pytest.mark.parametrize(("name", "kw"), [("roberta", {}), ("bert", {"all_layers": True, "idf": True}),
                                          ("bert", {"num_layers": 1})])
def test_bert_score_on_the_port_encoders_matches_flax(flax_encoders, name, kw):
    flax_model, port_model = flax_encoders[name]
    tok = _WordTokenizer()
    want = jax_text_fn.bert_score(PREDS, TARGET, model=flax_model, user_tokenizer=tok, **kw)
    got = text_fn.bert_score(PREDS, TARGET, model=port_model, user_tokenizer=tok, device="cpu", **kw)
    for key in ("precision", "recall", "f1"):
        assert got[key].shape == np.asarray(want[key]).shape
        _close(got[key], want[key], ENCODER_ATOL)


# ------------------------------------------------------------------ InfoLM


MEASURES = [
    ("kl_divergence", {}), ("alpha_divergence", {"alpha": 0.5}), ("beta_divergence", {"beta": 0.5}),
    ("ab_divergence", {"alpha": 0.5, "beta": 0.5}), ("renyi_divergence", {"alpha": 0.5}), ("l1_distance", {}),
    ("l2_distance", {}), ("l_infinity_distance", {}), ("fisher_rao_distance", {}),
]


@pytest.mark.parametrize(("measure", "kw"), MEASURES)
def test_infolm_matches_jax_for_every_measure(measure, kw):
    tok = _WordTokenizer()
    args = dict(user_tokenizer=tok, information_measure=measure, idf=measure == "kl_divergence",
                return_sentence_level_score=True, **kw)
    want_mean, want = jax_text_fn.infolm(PREDS, TARGET, model=_ToyMLM(), **args)
    got_mean, got = text_fn.infolm(PREDS, TARGET, model=_TorchMLM(), device="cpu", **args)
    assert got.shape == (len(PREDS),)
    _close(got, want)
    _close(got_mean, want_mean)


class _JittedMLM:
    """A Flax masked LM behind one ``jax.jit`` (InfoLM's JAX path calls its
    model eagerly, which compiles each op on its own)."""

    def __init__(self, bound):
        self.params = bound.params
        self.forward = jax.jit(lambda p, i, m: bound.model(input_ids=i, attention_mask=m, params=p).logits)

    def __call__(self, input_ids, attention_mask=None):
        from types import SimpleNamespace

        return SimpleNamespace(logits=self.forward(self.params, input_ids, attention_mask))


def test_infolm_on_the_port_masked_lm_matches_flax(flax_encoders):
    flax_model, port_model = flax_encoders["mlm"]
    tok = _WordTokenizer()
    kw = {"information_measure": "kl_divergence", "idf": True, "temperature": 0.25, "return_sentence_level_score": True}
    want = jax_text_fn.infolm(PREDS, TARGET, model=_JittedMLM(flax_model), user_tokenizer=tok, **kw)
    got = text_fn.infolm(PREDS, TARGET, model=port_model, user_tokenizer=tok, device="cpu", **kw)
    _close(got[1], want[1], ENCODER_ATOL)
    _close(got[0], want[0], ENCODER_ATOL)


def test_infolm_class_matches_jax_and_runs_bit_for_bit():
    tok = _WordTokenizer()
    want_m = jax_text.InfoLM(model=_ToyMLM(), user_tokenizer=tok, information_measure="l1_distance")
    m = InfoLM(model=_TorchMLM(), user_tokenizer=tok, information_measure="l1_distance", device="cpu")
    for metric in (want_m, m):
        metric.update(PREDS[:3], TARGET[:3])
        metric.update(PREDS[3:], TARGET[3:])
    first = m.compute()
    _close(first, want_m.compute())
    m._computed = None
    assert torch.equal(first, m.compute())
    assert m._update_reads_host and m.sentence_state == (PREDS, TARGET)
    with pytest.raises(ValueError, match="information_measure"):
        InfoLM(information_measure="bad", device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        InfoLM(information_measure="alpha_divergence", alpha=1.0, device="cpu")
    with pytest.raises(ValueError, match="same length"):
        text_fn.infolm(["a"], ["a", "b"], model=_TorchMLM(), user_tokenizer=tok, device="cpu")


def test_infolm_backbone_adapter_matches_the_model():
    from tpumetrics_torch.backbones import get_backbone

    tok = _WordTokenizer()
    mlm = _TorchMLM()

    def forward(params, ids, mask):
        logits = params["table"][ids]
        return logits + 2.0 * logits.mean(dim=1, keepdim=True)

    # a batch of one shape: the engine pads rows only, so the sequence mean is the model's
    handle = get_backbone("test:mlm", {"table": mlm.table}, forward=forward, pad_axes=(0,), device="cpu")
    m = InfoLM(backbone=handle, user_tokenizer=tok, idf=False, information_measure="l2_distance", device="cpu")
    m.update(PREDS, TARGET)
    want = text_fn.infolm(PREDS, TARGET, model=mlm, user_tokenizer=tok, idf=False, information_measure="l2_distance",
                          device="cpu")
    assert torch.allclose(m.compute(), want, atol=1e-6)
    with pytest.raises(ValueError, match="not both"):
        InfoLM(backbone=handle, model=mlm, user_tokenizer=tok, device="cpu")
    m.release_backbones()
    handle.close()


def test_segment_sum_is_the_scatter_add():
    from tpumetrics_torch.functional.text.infolm import _segment_sum

    rng = np.random.default_rng(4)
    rows = np.sort(rng.integers(0, 6, 40))
    x = torch.from_numpy(rng.standard_normal((40, 7)).astype(np.float32))
    want = np.zeros((8, 7))
    np.add.at(want, rows, x.numpy().astype(np.float64))
    got = _segment_sum(x, rows, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert float(got[6:].abs().max()) == 0.0
    assert torch.allclose(_segment_sum(x[:, 0], rows, 8), got[:, 0], atol=1e-6)
