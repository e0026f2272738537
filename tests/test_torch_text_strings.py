"""The port's string text metrics held against the JAX package on the CPU.

The same small corpora, made from a numpy seed (unicode words, empty
strings, punctuation and entities, several references a prediction, Chinese
for the ``zh`` tokenizer), go through each JAX function or class and its
counterpart in ``tpumetrics_torch``. Both run the same host algorithms, so
the modular states are equal bit for bit (list states compared
concatenated) and the values agree within ``TOL`` = 1e-6: the float32
arithmetic of the scores, done by torch and by XLA. rougeLsum runs on the
punkt-free fallback in both packages: the JAX side is told that punkt is
missing (it would otherwise try to download it), the port never downloads.
"""

import sys
import types
import warnings

import numpy as np
import pytest
import torch

import tpumetrics.functional.text as jax_fn
import tpumetrics.functional.text.rouge as jax_rouge
import tpumetrics.text as jax_text
import tpumetrics_torch.functional.text as fn
import tpumetrics_torch.text as text
from tpumetrics.collections import MetricCollection as JaxCollection
from tpumetrics_torch import MetricCollection
from tpumetrics_torch.functional.text import rouge as port_rouge
from tpumetrics_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS
from tpumetrics_torch.utils.imports import _REGEX_AVAILABLE

TOL = 1e-6

WORDS = (
    "the cat sat on mat a dog ran fast over lazy fox brown quick it is was and of to in "
    "naïve café Zürich über straße señor résumé 東京 élan"
).split()
PUNCT = [",", ".", "!", "?", ";", "'s", "&amp;", "3.5", "1,000", "U.S.", "-"]
ZH = list("我们今天去公园散步天气很好他说这个问题非常有意思")


@pytest.fixture(autouse=True)
def _punkt_free(monkeypatch):
    """Both rougeLsums take their fallback: the JAX one without looking for
    punkt online, neither importing nltk (seconds) to find it absent."""
    monkeypatch.setattr(jax_rouge, "_NLTK_AVAILABLE", False)
    monkeypatch.setattr(port_rouge, "_PUNKT_STATE", {"ok": False, "warned": True})


def _sentence(rng, n_min=0, n_max=14):
    n = int(rng.integers(n_min, n_max))
    toks = [str(rng.choice(WORDS)) if rng.random() > 0.15 else str(rng.choice(PUNCT)) for _ in range(n)]
    return " ".join(toks)


def _perturb(rng, sentence):
    """A hypothesis: the reference with words dropped, swapped and replaced."""
    toks = sentence.split()
    out = []
    for tok in toks:
        r = rng.random()
        if r < 0.1:
            continue
        out.append(str(rng.choice(WORDS)) if r < 0.25 else tok)
    if len(out) > 3 and rng.random() < 0.5:
        i = int(rng.integers(0, len(out) - 2))
        out[i], out[i + 2] = out[i + 2], out[i]
    return " ".join(out)


def _corpus(seed, n=8, refs=2):
    """``(preds, target)``: ``n`` hypotheses with ``refs`` references each;
    one empty hypothesis, one empty reference, one capitalised pair."""
    rng = np.random.default_rng(seed)
    target = [[_sentence(rng, 3) for _ in range(refs)] for _ in range(n)]
    preds = [_perturb(rng, t[0]) for t in target]
    preds[1] = ""
    target[2][refs - 1] = ""
    preds[3], target[3][0] = preds[3].upper() + " !", target[3][0].capitalize()
    return preds, target


def _zh_corpus(seed, n=4):
    rng = np.random.default_rng(seed)
    target = [["".join(rng.choice(ZH, int(rng.integers(4, 12)))) + "。"] for _ in range(n)]
    preds = ["".join(rng.choice(ZH, int(rng.integers(4, 12)))) for _ in range(n)]
    return preds, target


PREDS, TARGET = _corpus(0)
PREDS2, TARGET2 = _corpus(1, n=5, refs=1)
FLAT = [t[0] for t in TARGET]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key])
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=TOL, atol=TOL)


def _states(metric):
    out = {}
    for name in metric._defaults:
        val = getattr(metric, name)
        if isinstance(val, list):
            val = np.concatenate([_np(v).reshape(-1) for v in val]) if val else np.zeros(0)
        out[name] = _np(val)
    return out


def _same_states(port, ref):
    got, want = _states(port), _states(ref)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_exports_match_the_jax_package_less_the_encoder_metrics():
    """The encoder metrics (BERTScore, InfoLM) are ported too now: the port's
    text exports are the JAX package's, less nothing."""
    assert sorted(text.__all__) == sorted(jax_text.__all__)
    assert sorted(fn.__all__) == sorted(jax_fn.__all__)


FUNCTIONAL_CASES = [
    ("bleu_score", (PREDS, TARGET), {}),
    ("bleu_score", (PREDS, TARGET), {"n_gram": 2, "smooth": True}),
    ("bleu_score", (PREDS[0], [TARGET[0]]), {"weights": [0.4, 0.3, 0.2, 0.1]}),
    ("chrf_score", (PREDS, TARGET), {"return_sentence_level_score": True}),
    ("chrf_score", (PREDS, TARGET), {"n_word_order": 0, "lowercase": True, "whitespace": True}),
    ("translation_edit_rate", (PREDS, TARGET), {"return_sentence_level_score": True}),
    ("translation_edit_rate", (PREDS, TARGET), {"normalize": True, "no_punctuation": True, "lowercase": False}),
    ("translation_edit_rate", (["东京 今天 很好。"], [["今天 东京 很 好 ．"]]), {"normalize": True, "asian_support": True}),
    ("extended_edit_distance", (PREDS, TARGET), {"return_sentence_level_score": True}),
    ("extended_edit_distance", (["Dr. Who e.g. 3 , 5", "ｶﾀｶﾅ"], ["Dr. Who i.e. 3,5", "カタカナ"]), {"language": "ja"}),
    ("extended_edit_distance", (PREDS2, FLAT[:5]), {"alpha": 1.5, "rho": 0.1, "deletion": 0.3, "insertion": 0.9}),
    ("rouge_score", (PREDS, TARGET), {}),
    ("rouge_score", (PREDS, TARGET), {"accumulate": "avg", "rouge_keys": ("rouge3", "rougeL")}),
    ("rouge_score", (["a b c.\nd e f.", "x y! z"], ["d e f.\na b c.", "z y x."]), {"rouge_keys": ("rougeLsum",)}),
    ("rouge_score", ("My name is John", "Is your name John"), {"rouge_keys": "rouge1"}),
    ("edit_distance", (PREDS, FLAT), {}),
    ("edit_distance", (PREDS, FLAT), {"substitution_cost": 2, "reduction": "sum"}),
    ("edit_distance", (PREDS, FLAT), {"reduction": None}),
    ("word_error_rate", (PREDS, FLAT), {}),
    ("char_error_rate", (PREDS, FLAT), {}),
    ("match_error_rate", (PREDS, FLAT), {}),
    ("word_information_lost", (PREDS, FLAT), {}),
    ("word_information_preserved", (PREDS, FLAT), {}),
]


@pytest.mark.parametrize(("name", "args", "kwargs"), FUNCTIONAL_CASES, ids=lambda v: v if isinstance(v, str) else "")
def test_functional_matches_jax(name, args, kwargs):
    got = getattr(fn, name)(*args, **kwargs, device="cpu")
    _close(got, getattr(jax_fn, name)(*args, **kwargs))


@pytest.mark.parametrize("tokenize", AVAILABLE_TOKENIZERS)
@pytest.mark.parametrize("lowercase", [False, True])
def test_sacre_bleu_tokenizers_match_jax(tokenize, lowercase):
    if tokenize == "intl" and not _REGEX_AVAILABLE:
        with pytest.raises(ModuleNotFoundError, match="regex"):
            fn.sacre_bleu_score(PREDS, TARGET, tokenize=tokenize, device="cpu")
        return
    preds, target = _zh_corpus(2) if tokenize == "zh" else (PREDS, TARGET)
    if tokenize == "zh":
        preds, target = preds + PREDS[:2], target + TARGET[:2]
    kwargs = {"tokenize": tokenize, "lowercase": lowercase, "smooth": True}
    _close(fn.sacre_bleu_score(preds, target, **kwargs, device="cpu"), jax_fn.sacre_bleu_score(preds, target, **kwargs))


def test_squad_matches_jax():
    rng = np.random.default_rng(3)
    target = [
        {"answers": {"answer_start": [0] * 2, "text": [_sentence(rng, 1, 5), _sentence(rng, 1, 5)]}, "id": str(i)}
        for i in range(12)
    ]
    preds = [{"prediction_text": t["answers"]["text"][i % 2] if i % 3 else _sentence(rng, 0, 4), "id": t["id"]}
             for i, t in enumerate(target[:-1])]  # the last question unanswered
    with pytest.warns(UserWarning, match="Unanswered"):
        got = fn.squad(preds, target, device="cpu")
    _close(got, jax_fn.squad(preds, target))


MODULAR_CASES = [
    ("BLEUScore", {}, "multi"),
    ("BLEUScore", {"n_gram": 3, "smooth": True}, "multi"),
    ("SacreBLEUScore", {"tokenize": "13a", "lowercase": True}, "multi"),
    ("SacreBLEUScore", {"tokenize": "char"}, "multi"),
    ("CHRFScore", {}, "multi"),
    ("CHRFScore", {"n_word_order": 0, "return_sentence_level_score": True}, "multi"),
    ("TranslationEditRate", {"return_sentence_level_score": True}, "multi"),
    ("ExtendedEditDistance", {}, "multi"),
    ("ExtendedEditDistance", {"return_sentence_level_score": True}, "flat"),
    ("ROUGEScore", {}, "multi"),
    ("ROUGEScore", {"accumulate": "avg", "rouge_keys": ("rouge2", "rougeLsum")}, "multi"),
    ("EditDistance", {}, "flat"),
    ("EditDistance", {"reduction": "sum", "substitution_cost": 3}, "flat"),
    ("EditDistance", {"reduction": "none"}, "flat"),
    ("WordErrorRate", {}, "flat"),
    ("CharErrorRate", {}, "flat"),
    ("MatchErrorRate", {}, "flat"),
    ("WordInfoLost", {}, "flat"),
    ("WordInfoPreserved", {}, "flat"),
]


def _batches(kind):
    if kind == "multi":
        return [(PREDS[:5], TARGET[:5]), (PREDS[5:], TARGET[5:]), (PREDS2, [[t[0]] for t in TARGET2])]
    return [(PREDS[:5], FLAT[:5]), (PREDS[5:], FLAT[5:]), (PREDS2, [t[0] for t in TARGET2])]


@pytest.mark.parametrize(("name", "kwargs", "kind"), MODULAR_CASES, ids=lambda v: v if isinstance(v, str) else "")
def test_modular_states_equal_jax_bit_for_bit(name, kwargs, kind):
    port, ref = getattr(text, name)(**kwargs, device="cpu"), getattr(jax_text, name)(**kwargs)
    assert port._update_reads_host
    for preds, target in _batches(kind):
        port.update(preds, target)
        ref.update(preds, target)
        _same_states(port, ref)
    _close(port.compute(), ref.compute())


def test_squad_class_states_equal_jax():
    preds = [{"prediction_text": "1976", "id": "a"}, {"prediction_text": "the Blue  house!", "id": "b"}]
    target = [{"answers": {"answer_start": [1], "text": ["1976"]}, "id": "a"},
              {"answers": {"answer_start": [1, 2], "text": ["blue house", "a house"]}, "id": "b"}]
    port, ref = text.SQuAD(device="cpu"), jax_text.SQuAD()
    for p, t in zip(preds, target):
        port.update(p, t)
        ref.update(p, t)
        _same_states(port, ref)
    _close(port.compute(), ref.compute())


def _mt_members(pkg, **kw):
    return {
        "bleu": pkg.BLEUScore(**kw),
        "sacrebleu": pkg.SacreBLEUScore(tokenize="13a", **kw),
        "chrf": pkg.CHRFScore(n_word_order=0, **kw),
        "chrfpp": pkg.CHRFScore(**kw),
        "ter": pkg.TranslationEditRate(**kw),
        "eed": pkg.ExtendedEditDistance(**kw),
    }


def _asr_members(pkg, **kw):
    return {
        "wer": pkg.WordErrorRate(**kw),
        "cer": pkg.CharErrorRate(**kw),
        "mer": pkg.MatchErrorRate(**kw),
        "wil": pkg.WordInfoLost(**kw),
        "wip": pkg.WordInfoPreserved(**kw),
        "edit": pkg.EditDistance(**kw),
    }


@pytest.mark.parametrize("which", ["mt", "asr"])
def test_text_collections_form_the_jax_compute_groups(which):
    members = _mt_members if which == "mt" else _asr_members
    port = MetricCollection(members(text, device="cpu"), device="cpu")
    ref = JaxCollection(members(jax_text))
    for preds, target in _batches("multi" if which == "mt" else "flat"):
        port.update(preds, target)
        ref.update(preds, target)
    groups = sorted(sorted(g) for g in port.compute_groups.values())
    assert groups == sorted(sorted(g) for g in ref.compute_groups.values())
    if which == "asr":
        assert ["wil", "wip"] in groups  # one state layout, one group
    _close(port.compute(), {k: v for k, v in ref.compute().items()})


def test_functional_results_live_on_the_device_asked_for():
    assert fn.word_error_rate(PREDS, FLAT, device="cpu").device.type == "cpu"
    assert fn.bleu_score(PREDS, TARGET, device=torch.device("cpu")).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="No CUDA device"):
            fn.word_error_rate(PREDS, FLAT)
        with pytest.raises(RuntimeError, match="No CUDA device"):
            text.BLEUScore()


def _fake_nltk(found):
    """An ``nltk`` module whose data lookup finds punkt or not and whose
    download fails the test."""

    def find(path):
        if not found:
            raise LookupError(path)

    def download(*args, **kwargs):
        raise AssertionError("nltk.download was called")

    return types.SimpleNamespace(
        data=types.SimpleNamespace(find=find), download=download, sent_tokenize=lambda x: ["punkt:" + x]
    )


@pytest.mark.parametrize("found", [False, True])
def test_rouge_lsum_finds_punkt_or_falls_back_and_never_downloads(monkeypatch, found):
    """With nltk's punkt data the port splits with ``nltk.sent_tokenize``;
    without them on newlines, then sentence ends (warned once); it never
    calls ``nltk.download``."""
    monkeypatch.setitem(sys.modules, "nltk", _fake_nltk(found))
    monkeypatch.setattr(port_rouge, "_NLTK_AVAILABLE", True)
    monkeypatch.setattr(port_rouge, "_PUNKT_STATE", {})
    if found:
        assert port_rouge._split_sentence("One. Two") == ["punkt:One. Two"]
        return
    with pytest.warns(UserWarning, match="punkt"):
        split = port_rouge._split_sentence("One. Two!\nThree <n>four?  Five")
    assert split == ["One.", "Two!", "Three four?", "Five"]
    with warnings.catch_warnings(record=True) as later:
        warnings.simplefilter("always")
        assert port_rouge._split_sentence("a. b") == ["a.", "b"]
    assert not later  # warned once a process


def test_errors_match_the_jax_package():
    with pytest.raises(ValueError, match="same length"):
        fn.word_error_rate(["a"], ["a", "b"], device="cpu")
    with pytest.raises(ValueError, match="different size"):
        fn.bleu_score(["a"], [["a"], ["b"]], device="cpu")
    with pytest.raises(ValueError, match="tokenize"):
        text.SacreBLEUScore(tokenize="wrong", device="cpu")
    with pytest.raises(ValueError, match="n_char_order"):
        text.CHRFScore(n_char_order=0, device="cpu")
    with pytest.raises(ValueError, match="language"):
        text.ExtendedEditDistance(language="de", device="cpu")
    with pytest.raises(ValueError, match="rouge key"):
        text.ROUGEScore(rouge_keys="rouge10", device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        text.EditDistance(reduction="max", device="cpu")
    with pytest.raises(KeyError, match="prediction_text"):
        fn.squad([{"id": "1"}], [{"answers": {"text": ["x"]}, "id": "1"}], device="cpu")
