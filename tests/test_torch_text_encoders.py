"""The port's own encoders and BERTScore's matcher against the JAX package's
building blocks, on the CPU at tiny widths (two layers, width 32, vocab 100).

- ``text._bert_encoder.BertEncoder`` (BERT and RoBERTa) and
  ``BertForMaskedLM`` against ``transformers``' ``FlaxBertModel``,
  ``FlaxRobertaModel`` and ``FlaxBertForMaskedLM`` with the same random
  weights, carried by ``text._bert_convert``: every hidden state (and the
  logits) within ``HIDDEN_RTOL`` of its largest entry (float32 products and
  LayerNorm statistics in another order);
- ``ops.bert_match.bert_greedy_match`` (its plain version, which the CPU
  runs) against the JAX ``_get_precision_recall_f1`` within ``MATCH_ATOL``,
  at the edge cases of its contract: every real similarity negative, ``Sp !=
  St``, padded rows, one token;
- ``text._sentence_state.HostSentenceStateMixin``: the object-gather merge,
  unsync and the three refusals, with the JAX package's messages.

Each Flax model runs once, in a module-scoped fixture.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tpumetrics_torch.ops import bert_match as bm
from tpumetrics_torch.text._bert_convert import bert_params_from_flax, mlm_params_from_flax
from tpumetrics_torch.text._bert_encoder import (
    BERT_BASE_UNCASED,
    ROBERTA_LARGE,
    BertConfig,
    BertEncoder,
    BertForMaskedLM,
    build,
    position_ids,
    random_bert_params,
)

HIDDEN_RTOL = 1e-5  # hidden states and logits, of the largest entry: float32 sums in another order
MATCH_ATOL = 1e-6  # P, R, F1 of unit vectors: float32 dot products and sums in another order
TINY = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=37,
            max_position_embeddings=64)


def _batch(pad_id: int):
    """Three rows of token ids (one full, two padded with ``pad_id``) and their mask."""
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 100, (3, 9))
    mask = np.ones((3, 9), np.int64)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = pad_id
    return ids, mask


def flax_bert_tree(state, mlm: bool = False):
    """A Flax BERT / RoBERTa (``mlm``: ``FlaxBertForMaskedLM``) parameter tree
    holding the port's ``state_dict``: the inverse of ``bert_params_from_flax``
    and ``mlm_params_from_flax``, written apart from them, so a Flax model
    built without its own initialization (which compiles for seconds on the
    CPU) runs on the port's weights."""
    a = {k: v.numpy() for k, v in state.items()}
    pre = "encoder." if mlm else ""

    def dense(key):
        return {"kernel": a[f"{key}.weight"].T, "bias": a[f"{key}.bias"]}

    def norm(key):
        return {"scale": a[f"{key}.weight"], "bias": a[f"{key}.bias"]}

    count = len({k.split(".")[-3] for k in a if k.startswith(f"{pre}layers.")})
    layers = {str(i): {
        "attention": {"self": {x: dense(f"{pre}layers.{i}.{x}") for x in ("query", "key", "value")},
                      "output": {"dense": dense(f"{pre}layers.{i}.attn_out"), "LayerNorm": norm(f"{pre}layers.{i}.attn_norm")}},
        "intermediate": {"dense": dense(f"{pre}layers.{i}.ffn_in")},
        "output": {"dense": dense(f"{pre}layers.{i}.ffn_out"), "LayerNorm": norm(f"{pre}layers.{i}.ffn_norm")},
    } for i in range(count)}
    bert = {"embeddings": {"word_embeddings": {"embedding": a[f"{pre}embeddings.word.weight"]},
                           "position_embeddings": {"embedding": a[f"{pre}embeddings.position.weight"]},
                           "token_type_embeddings": {"embedding": a[f"{pre}embeddings.token_type.weight"]},
                           "LayerNorm": norm(f"{pre}embeddings.norm")},
            "encoder": {"layer": layers}}
    if not mlm:
        return bert
    return {"bert": bert, "cls": {"predictions": {"transform": {"dense": dense("dense"), "LayerNorm": norm("norm")},
                                                  "bias": a["decoder_bias"]}}}


def flax_bert_models(seed: int):
    """``{name: (hf config, flax model, its params, port config, port params)}`` for BERT, RoBERTa and BERT's
    masked LM at ``TINY``: the port's random weights (N(0, 0.1) matrices, so the layers move the states),
    carried into Flax trees; the Flax models are built without their own initialization."""
    from transformers import BertConfig as HFBertConfig
    from transformers import FlaxBertForMaskedLM, FlaxBertModel, FlaxRobertaModel, RobertaConfig

    out = {}
    for name, cls, config in (("bert", FlaxBertModel, HFBertConfig(**TINY)),
                              ("roberta", FlaxRobertaModel, RobertaConfig(**TINY)),
                              ("mlm", FlaxBertForMaskedLM, HFBertConfig(**TINY))):
        kw = {} if name == "mlm" else {"add_pooling_layer": False}
        port_config = _port_config(config, name == "roberta")
        params = {k: v * 5.0 if "norm" not in k else v
                  for k, v in random_bert_params(port_config, seed=seed, mlm=name == "mlm").items()}
        out[name] = (config, cls(config, _do_init=False, **kw), flax_bert_tree(params, name == "mlm"), port_config, params)
    return out


@pytest.fixture(scope="module")
def flax_runs():
    """Each Flax model's config, params and outputs on one batch (numpy)."""
    runs = {}
    for name, (config, model, params, _, _) in flax_bert_models(seed=1).items():
        ids, mask = _batch(config.pad_token_id)
        # one jit a model: an eager Flax forward compiles each of its ops on its own
        forward = jax.jit(lambda p, i, m, model=model: model(input_ids=i, attention_mask=m, params=p,
                                                             output_hidden_states=True))
        out = forward(params, ids, mask)
        runs[name] = {
            "config": config, "params": params, "ids": ids, "mask": mask,
            "hidden": [np.asarray(h) for h in out.hidden_states],
            "logits": np.asarray(out.logits) if name == "mlm" else None,
        }
    return runs


def _port_config(hf, roberta: bool) -> BertConfig:
    return BertConfig(hf.vocab_size, hf.hidden_size, hf.num_hidden_layers, hf.num_attention_heads, hf.intermediate_size,
                      hf.max_position_embeddings, hf.type_vocab_size, hf.layer_norm_eps, hf.pad_token_id, roberta)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["bert", "roberta"])
def test_encoder_hidden_states_match_flax(flax_runs, name):
    run = flax_runs[name]
    model = build(_port_config(run["config"], name == "roberta"), bert_params_from_flax(run["params"]))
    out = model(input_ids=torch.from_numpy(run["ids"]), attention_mask=torch.from_numpy(run["mask"]),
                output_hidden_states=True)
    assert len(out.hidden_states) == len(run["hidden"]) == TINY["num_hidden_layers"] + 1
    for got, want in zip(out.hidden_states, run["hidden"]):
        assert _rel(got.numpy(), want) <= HIDDEN_RTOL
    assert out.last_hidden_state is out.hidden_states[-1]


def test_masked_lm_logits_and_hidden_states_match_flax(flax_runs):
    run = flax_runs["mlm"]
    model = build(_port_config(run["config"], False), mlm_params_from_flax(run["params"]), mlm=True)
    out = model(input_ids=torch.from_numpy(run["ids"]), attention_mask=torch.from_numpy(run["mask"]))
    assert out.logits.shape == (3, 9, TINY["vocab_size"])
    assert _rel(out.logits.numpy(), run["logits"]) <= HIDDEN_RTOL
    for got, want in zip(out.hidden_states, run["hidden"]):
        assert _rel(got.numpy(), want) <= HIDDEN_RTOL
    # the decoder is the word embeddings, tied: one tensor
    assert model.encoder.embeddings.word.weight.data_ptr() == dict(model.named_parameters())[
        "encoder.embeddings.word.weight"].data_ptr()


def test_converters_fill_every_parameter_and_nothing_else(flax_runs):
    for name, mlm in (("bert", False), ("roberta", False), ("mlm", True)):
        params = (mlm_params_from_flax if mlm else bert_params_from_flax)(flax_runs[name]["params"])
        module = (BertForMaskedLM if mlm else BertEncoder)(_port_config(flax_runs[name]["config"], name == "roberta"))
        assert set(params) == set(module.state_dict())
        for key, value in module.state_dict().items():
            assert tuple(params[key].shape) == tuple(value.shape), key


def test_roberta_positions_are_transformers_ones(flax_runs):
    from transformers.models.roberta.modeling_flax_roberta import create_position_ids_from_input_ids

    ids, _ = _batch(pad_id=1)
    want = torch.from_numpy(np.asarray(create_position_ids_from_input_ids(ids, 1)).astype(np.int64))
    ids = torch.from_numpy(ids)
    got = position_ids(ids, ROBERTA_LARGE)
    assert torch.equal(got, want) and int(got[0, 0]) == 2  # real tokens start at pad_token_id + 1
    assert torch.equal(position_ids(ids, BERT_BASE_UNCASED)[0], torch.arange(9))


def test_published_widths_and_random_weights():
    assert (ROBERTA_LARGE.num_hidden_layers, ROBERTA_LARGE.hidden_size, ROBERTA_LARGE.num_attention_heads,
            ROBERTA_LARGE.intermediate_size, ROBERTA_LARGE.vocab_size, ROBERTA_LARGE.max_position_embeddings,
            ROBERTA_LARGE.pad_token_id, ROBERTA_LARGE.type_vocab_size, ROBERTA_LARGE.layer_norm_eps) == (
        24, 1024, 16, 4096, 50265, 514, 1, 1, 1e-5)
    assert (BERT_BASE_UNCASED.num_hidden_layers, BERT_BASE_UNCASED.hidden_size, BERT_BASE_UNCASED.num_attention_heads,
            BERT_BASE_UNCASED.intermediate_size, BERT_BASE_UNCASED.vocab_size, BERT_BASE_UNCASED.max_position_embeddings,
            BERT_BASE_UNCASED.type_vocab_size, BERT_BASE_UNCASED.layer_norm_eps) == (12, 768, 12, 3072, 30522, 512, 2, 1e-12)
    tiny = BertConfig(**TINY, type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0)
    params = random_bert_params(tiny, seed=3, mlm=True)
    again = random_bert_params(tiny, seed=3, mlm=True)
    assert set(params) == set(BertForMaskedLM(tiny).state_dict())
    assert all(torch.equal(params[k], again[k]) for k in params)
    model = build(tiny, params, mlm=True, dtype=torch.float64)
    ids, mask = _batch(0)
    out = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    assert out.logits.dtype == torch.float64 and torch.isfinite(out.logits).all()


# ------------------------------------------------------------------ the greedy matcher


def _unit_rows(rng, shape, zero_first=True):
    x = rng.standard_normal(shape).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    if zero_first:
        x[..., 0, :] = 0.0  # the [CLS] position: weight 0, embedding 0
    return x


def _scales(rng, n, s):
    w = rng.random((n, s)).astype(np.float32)
    w[:, 0] = 0.0
    return w / np.maximum(w.sum(1, keepdims=True), 1e-30)


def _jax_match(pe, te, ps, ts):
    """The JAX function under ``jax.jit`` (as the JAX package's ``_score_scan``
    runs it; eager, each of its ops compiles on its own), back to (n, L) each."""
    from tpumetrics.functional.text.bert import _get_precision_recall_f1

    out = jax.jit(_get_precision_recall_f1)(pe, te, ps, ts)
    return [np.asarray(o)[:, None] if pe.shape[1] == 1 else np.asarray(o).T for o in out]


def _hold(pe, te, ps, ts):
    got = bm.bert_greedy_match(*(torch.from_numpy(a) for a in (pe, te, ps, ts)))
    want = _jax_match(pe, te, ps, ts)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=MATCH_ATOL)
    ref = bm.bert_greedy_match_reference(*(torch.from_numpy(a) for a in (pe, te, ps, ts)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=MATCH_ATOL)
    return got


@pytest.mark.parametrize(("n", "layers", "sp", "st", "dim"), [(4, 1, 7, 7, 16), (3, 3, 9, 5, 24), (2, 2, 1, 6, 8)])
def test_greedy_match_plain_version_matches_jax(n, layers, sp, st, dim):
    rng = np.random.default_rng(n + sp)
    pe, te = _unit_rows(rng, (n, layers, sp, dim), sp > 1), _unit_rows(rng, (n, layers, st, dim))
    ps, ts = (_scales(rng, n, sp) if sp > 1 else np.ones((n, 1), np.float32)), _scales(rng, n, st)
    _hold(pe, te, ps, ts)


def test_greedy_match_every_real_similarity_negative():
    """Every real pair's cosine is negative: the maxima are the zero rows' 0,
    so P = R = 0 and F1 = 0 (not the largest negative similarity)."""
    rng = np.random.default_rng(7)
    pe = _unit_rows(rng, (2, 1, 5, 8), zero_first=False)
    pe[..., 1:] = np.abs(pe[..., 1:])
    pe[..., 1:, 0] = 1.0
    pe /= np.maximum(np.linalg.norm(pe, axis=-1, keepdims=True), 1e-30)
    te = -pe[:, :, ::-1].copy()
    pe[:, :, 0] = 0.0
    te[:, :, 0] = 0.0
    assert (np.einsum("blpd,blrd->blpr", pe[:, :, 1:], te[:, :, 1:]) < 0).all()
    got = _hold(pe, te, _scales(rng, 2, 5), _scales(rng, 2, 5))
    assert all(float(x.abs().max()) == 0.0 for x in got)


def test_greedy_match_padded_rows_give_zero_f1_not_nan():
    rng = np.random.default_rng(8)
    pe, te = _unit_rows(rng, (4, 1, 6, 8)), _unit_rows(rng, (4, 1, 3, 8))
    ps, ts = _scales(rng, 4, 6), _scales(rng, 4, 3)
    pe[2:], te[2:], ps[2:], ts[2:] = 0.0, 0.0, 0.0, 0.0  # rows past the real count
    p, r, f1 = _hold(pe, te, ps, ts)
    assert float(p[2:].abs().max()) == float(r[2:].abs().max()) == float(f1[2:].abs().max()) == 0.0
    assert bool((f1[:2] > 0).all())


def test_greedy_match_refuses_what_it_does_not_take():
    x = torch.zeros(2, 1, 3, 4)
    s = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="Expected pe"):
        bm.bert_greedy_match(x[0], x, s, s)
    with pytest.raises(ValueError, match="differ outside"):
        bm.bert_greedy_match(x, torch.zeros(2, 1, 3, 5), s, s)
    with pytest.raises(ValueError, match="at least one token"):
        bm.bert_greedy_match(torch.zeros(2, 1, 0, 4), x, torch.zeros(2, 0), s)
    with pytest.raises(TypeError, match="float32"):
        bm.bert_greedy_match(x.double(), x, s, s)
    before = bm.launches
    bm.bert_greedy_match(x, x, s, s)  # the plain version on the CPU: no launch counted
    assert bm.launches == before


def test_greedy_match_contract_helper():
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(a) for a in (_unit_rows(rng, (2, 1, 4, 8)), _unit_rows(rng, (2, 1, 4, 8)),
                                          _scales(rng, 2, 4), _scales(rng, 2, 4))]
    plain = bm.bert_greedy_match_plain(*args)
    ref = bm.bert_greedy_match_reference(*args)
    assert float(bm.cell_excess(plain, plain, ref)) <= 0.0
    off = tuple(p + 1e-4 for p in plain)
    assert float(bm.cell_excess(off, plain, ref)) > 0.0


# ------------------------------------------------------------------ the host-sentence sync


class _Table:
    """A token-embedding table as a ``user_forward_fn``."""

    def __init__(self):
        self.table = torch.from_numpy(np.random.default_rng(0).standard_normal((100, 16)).astype(np.float32))

    def __call__(self, model, batch):
        return self.table[batch["input_ids"]]


def _tokenizer(sentences, **_):
    ids = [[1] + [4 + (sum(map(ord, w)) % 96) for w in s.split()] + [2] for s in sentences]
    return {"input_ids": ids, "attention_mask": [[1] * len(r) for r in ids]}


def _bertscore(**kw):
    from tpumetrics_torch.text import BERTScore

    fwd = _Table()
    return BERTScore(model=fwd, user_tokenizer=_tokenizer, user_forward_fn=fwd, device="cpu", **kw)


def test_sentence_sync_gathers_every_rank_and_unsyncs():
    from tpumetrics_torch.parallel.backend import NoOpBackend

    class TwoRanks(NoOpBackend):
        def available(self):
            return True

        def all_gather_object(self, obj, group=None):
            return [obj, (["other pred"], ["other target"])]

    m = _bertscore(sync_backend=TwoRanks(), distributed_available_fn=lambda: True)
    m.update(["a b c"], ["a b d"])
    m.sync()
    assert m._preds == ["a b c", "other pred"] and m._target == ["a b d", "other target"]
    m.unsync()
    assert m.sentence_state == (["a b c"], ["a b d"]) and m._sentence_cache is None
    m.reset()
    assert m.sentence_state == ([], [])


def test_sentence_sync_refusals_keep_the_jax_messages():
    from tpumetrics_torch.parallel.backend import DistributedBackend
    from tpumetrics_torch.utils.exceptions import TPUMetricsUserError

    class NoObjects(DistributedBackend):
        def available(self):
            return True

    m = _bertscore(sync_backend=NoObjects())
    m.update(["a b"], ["a b"])
    with pytest.raises(TPUMetricsUserError, match="no host-object channel"):
        m._sync_dist()
    assert m.sentence_state == (["a b"], ["a b"])
    m = _bertscore()
    m.update(["a b"], ["a b"])
    with pytest.raises(TPUMetricsUserError, match="custom dist_sync_fn cannot move them"):
        m._sync_dist(dist_sync_fn=lambda x, group: [x])
    m = _bertscore(dist_sync_on_step=True)
    m.update(["a b"], ["a b"])
    with pytest.raises(TPUMetricsUserError, match="does not support dist_sync_on_step=True"):
        m._sync_dist()
    # replicated sentences: the tensor states sync over the backend, the lists stay as they are
    m = _bertscore(sentences_replicated=True)
    m.update(["a b"], ["a b"])
    m._sync_dist()
    assert m.sentence_state == (["a b"], ["a b"])
