"""The multimodal slice of the port against the JAX package, on the CPU.

- ``multimodal._clip.CLIPModel`` against ``transformers``' ``FlaxCLIPModel``
  at the JAX test's tiny widths (``tests/multimodal/test_model_metrics.py``:
  two layers a tower, width 32, vocab 100, 32 x 32 images in 8 x 8 patches)
  with the same random weights (``multimodal._clip_convert``), in both text
  pooling branches (``eos_token_id`` 2, the legacy argmax, and the default
  first-end-token): text and image features within ``FEATURE_RTOL`` of their
  largest entry;
- ``clip_score`` / ``CLIPScore`` (100 x cosine: ``CLIP_SCORE_ATOL``) and
  ``clip_image_quality_assessment`` / ``CLIPImageQualityAssessment``
  (probabilities: ``IQA_ATOL``) on that model against the JAX package on the
  Flax one, whose features the JAX side computes under one ``jax.jit``;
- the truncation warning, the errors, the gated hub ids and the device a
  hub-loaded model runs on (the hub's
  offline switches set: no loader reaches the network).
"""

from __future__ import annotations

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")

import jax
import numpy as np
import pytest
import torch

import tpumetrics.functional.multimodal as jax_mm_fn
import tpumetrics.multimodal as jax_mm
import tpumetrics_torch.functional.multimodal as mm_fn
from tests.multimodal.test_model_metrics import _WordTokenizer
from tpumetrics_torch.functional.multimodal.clip_score import _get_clip_model_and_processor
from tpumetrics_torch.multimodal import CLIPImageQualityAssessment, CLIPScore
from tpumetrics_torch.multimodal._clip import (
    CLIP_VIT_L_14,
    CLIPConfig,
    CLIPModel,
    CLIPTextConfig,
    CLIPVisionConfig,
    build_clip,
    random_clip_params,
)
from tpumetrics_torch.multimodal._clip_convert import clip_params_from_flax

FEATURE_RTOL = 1e-5  # of the largest feature: float32 products and LayerNorm statistics in another order
CLIP_SCORE_ATOL = 1e-3  # CLIPScore is 100 x a cosine
IQA_ATOL = 1e-5
CAPTIONS = ["a photo of a cat", "a photo of a dog on a mat", "two birds", "the red house by the sea"]


@pytest.fixture(autouse=True, scope="module")
def _offline():
    """The hub's offline switches, read when a loader runs: no download is tried."""
    import huggingface_hub.constants
    import transformers.utils.hub

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
        mp.setattr(transformers.utils.hub, "_is_offline_mode", True)
        yield


class _ClipProcessor(_WordTokenizer):
    """The JAX test's processor: word ids for text, the images stacked (HWC to CHW)."""

    def __call__(self, text=None, images=None, return_tensors="np", padding=True):
        out = {}
        if text is not None:
            out.update(super().__call__(text))
        if images is not None:
            pix = np.stack([np.asarray(i, np.float32) for i in images])
            if pix.shape[-1] == 3:
                pix = pix.transpose(0, 3, 1, 2)
            out["pixel_values"] = pix
        return out


class _JittedCLIP:
    """A Flax CLIP's surface with each tower under one ``jax.jit``."""

    def __init__(self, model, params):
        self.config = model.config
        text = jax.jit(lambda p, i, m: model.get_text_features(i, m, params=p))
        image = jax.jit(lambda p, x: model.get_image_features(x, params=p))
        self.get_text_features = lambda ids, mask: text(params, ids, mask)
        self.get_image_features = lambda pixels: image(params, pixels)


def _flax_tree(state):
    """A ``FlaxCLIPModel`` parameter tree holding the port's ``state_dict``: the
    inverse of ``clip_params_from_flax`` (a Flax model built without its own
    initialization, which compiles for some 10 s on the CPU)."""
    a = {k: v.numpy() for k, v in state.items()}

    def dense(key):
        return {"kernel": a[f"{key}.weight"].T, "bias": a[f"{key}.bias"]}

    def norm(key):
        return {"scale": a[f"{key}.weight"], "bias": a[f"{key}.bias"]}

    def layers(tower):
        count = len({k.split(".")[2] for k in a if k.startswith(f"{tower}.layers.")})
        return {str(i): {"layer_norm1": norm(f"{tower}.layers.{i}.norm1"), "layer_norm2": norm(f"{tower}.layers.{i}.norm2"),
                         "self_attn": {f"{x}_proj": dense(f"{tower}.layers.{i}.{y}") for x, y in
                                       (("q", "query"), ("k", "key"), ("v", "value"), ("out", "out"))},
                         "mlp": {"fc1": dense(f"{tower}.layers.{i}.fc1"), "fc2": dense(f"{tower}.layers.{i}.fc2")}}
                for i in range(count)}

    return {
        "text_model": {"embeddings": {"token_embedding": {"embedding": a["text.token.weight"]},
                                      "position_embedding": {"embedding": a["text.position.weight"]}},
                       "encoder": {"layers": layers("text")}, "final_layer_norm": norm("text.final_norm")},
        "vision_model": {"embeddings": {"class_embedding": a["vision.class_embedding"],
                                        "patch_embedding": {"kernel": a["vision.patch.weight"].transpose(2, 3, 1, 0)},
                                        "position_embedding": {"embedding": a["vision.position.weight"]}},
                         "pre_layrnorm": norm("vision.pre_norm"), "encoder": {"layers": layers("vision")},
                         "post_layernorm": norm("vision.post_norm")},
        "text_projection": {"kernel": a["text_projection.weight"].T},
        "visual_projection": {"kernel": a["visual_projection.weight"].T},
        "logit_scale": np.asarray(2.6592, np.float32),
    }


def _clips(eos_token_id):
    """``(flax model, its jitted surface, the port's model)`` for one pooling
    branch, on the same random weights: the port's, carried into a Flax tree
    and back through ``clip_params_from_flax``."""
    from transformers import CLIPConfig as HFCLIPConfig
    from transformers import CLIPTextConfig as HFText
    from transformers import CLIPVisionConfig as HFVision
    from transformers import FlaxCLIPModel

    tc = HFText(hidden_size=32, intermediate_size=64, num_attention_heads=2, num_hidden_layers=2, vocab_size=100,
                max_position_embeddings=64, projection_dim=32, eos_token_id=eos_token_id)
    vc = HFVision(hidden_size=32, intermediate_size=64, num_attention_heads=2, num_hidden_layers=2, image_size=32,
                  patch_size=8, projection_dim=32)
    flax_model = FlaxCLIPModel(HFCLIPConfig(text_config=tc.to_dict(), vision_config=vc.to_dict(), projection_dim=32),
                               _do_init=False)
    config = CLIPConfig(CLIPTextConfig(100, 32, 64, 2, 2, 64, tc.layer_norm_eps, tc.hidden_act, eos_token_id),
                        CLIPVisionConfig(32, 64, 2, 2, 32, 8, 3, vc.layer_norm_eps, vc.hidden_act), 32)
    state = {k: v * 5.0 if k.endswith(".weight") and "norm" not in k else v  # N(0, 0.1): features that differ
             for k, v in random_clip_params(config, seed=3).items()}
    tree = _flax_tree(state)
    carried = clip_params_from_flax(tree)
    assert set(carried) == set(state) and all(torch.equal(carried[k], state[k]) for k in state)
    return flax_model, _JittedCLIP(flax_model, tree), build_clip(config, carried)


@pytest.fixture(scope="module")
def clips():
    """The JAX test's configuration (its text pooling at the first end token): the metrics' model."""
    return _clips(49407)


def _images(seed, n=4, scale=255.0):
    return np.asarray(np.random.default_rng(seed).random((n, 3, 32, 32)) * scale, np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("eos_token_id", [49407, 2], ids=["first-eos", "legacy-argmax"])
def test_clip_model_matches_flax(clips, eos_token_id):
    _, jitted, model = clips if eos_token_id == 49407 else _clips(eos_token_id)
    ids = np.random.default_rng(0).integers(4, 99, (3, 7))
    mask = np.ones((3, 7), np.int64)
    mask[1, 5:] = 0
    ids[0, 3] = 99  # the legacy branch pools at the row's largest id
    want = jitted.get_text_features(ids, mask)
    got = model.get_text_features(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (3, 32) and _rel(got, want) <= FEATURE_RTOL
    pixels = _images(1, 2, 1.0)
    assert _rel(model.get_image_features(torch.from_numpy(pixels)), jitted.get_image_features(pixels)) <= FEATURE_RTOL
    assert model.config.text_config.max_position_embeddings == 64


def test_clip_score_matches_jax(clips):
    _, jitted, model = clips
    processor = _ClipProcessor()
    images = _images(2)
    want = jax_mm_fn.clip_score(images, CAPTIONS, model_name_or_path=(jitted, processor))
    got = mm_fn.clip_score(torch.from_numpy(images), CAPTIONS, model_name_or_path=(model, processor))
    assert abs(float(got) - float(want)) <= CLIP_SCORE_ATOL
    as_list = mm_fn.clip_score(list(torch.from_numpy(images)), CAPTIONS, model_name_or_path=(model, processor))
    assert torch.equal(as_list, got)

    metric, jax_metric = CLIPScore((model, processor), device="cpu"), jax_mm.CLIPScore((jitted, processor))
    for m in (metric, jax_metric):
        m.update(images[:2] if m is jax_metric else torch.from_numpy(images[:2]), CAPTIONS[:2])
        m.update(images[2:] if m is jax_metric else torch.from_numpy(images[2:]), CAPTIONS[2:])
    assert abs(float(metric.compute()) - float(jax_metric.compute())) <= CLIP_SCORE_ATOL
    assert metric.score.device.type == "cpu" and float(metric.n_samples) == 4.0 and metric._update_reads_host


def test_clip_iqa_matches_jax(clips):
    _, jitted, model = clips
    processor = _ClipProcessor()
    images = _images(3, scale=1.0)
    want = jax_mm_fn.clip_image_quality_assessment(images, model_name_or_path=(jitted, processor))
    got = mm_fn.clip_image_quality_assessment(torch.from_numpy(images), model_name_or_path=(model, processor))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=IQA_ATOL)

    prompts = ("quality", ("Nice photo.", "Terrible photo."))
    want = jax_mm_fn.clip_image_quality_assessment(images, (jitted, processor), 2.0, prompts)
    got = mm_fn.clip_image_quality_assessment(torch.from_numpy(images), (model, processor), 2.0, prompts)
    assert set(got) == set(want) == {"quality", "user_defined_0"}
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=IQA_ATOL)

    prompts = ("quality", "sharpness")
    metric = CLIPImageQualityAssessment((model, processor), prompts=prompts, device="cpu")
    jax_metric = jax_mm.CLIPImageQualityAssessment((jitted, processor), prompts=prompts)
    for m in (metric, jax_metric):
        m.update(images[:2] if m is jax_metric else torch.from_numpy(images[:2]))
        m.update(images[2:] if m is jax_metric else torch.from_numpy(images[2:]))
    got, want = metric.compute(), jax_metric.compute()
    for key in prompts:
        assert abs(float(got[key]) - float(want[key])) <= IQA_ATOL
    # precomputed anchors, raw (the function normalizes them), give the same probabilities
    anchors = model.get_text_features(*(torch.from_numpy(processor(text=["Good photo.", "Bad photo."])[k])
                                        for k in ("input_ids", "attention_mask")))
    again = mm_fn.clip_image_quality_assessment(torch.from_numpy(images), (model, processor),
                                                text_features=3.0 * anchors)
    np.testing.assert_allclose(again.numpy(), mm_fn.clip_image_quality_assessment(
        torch.from_numpy(images), (model, processor)).numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="one row per"):
        mm_fn.clip_image_quality_assessment(torch.from_numpy(images), (model, processor), text_features=anchors[:1])


def test_long_captions_warn_and_truncate_as_jax(clips):
    _, jitted, model = clips
    processor = _ClipProcessor()
    long = [" ".join(f"w{i}" for i in range(70)), "short caption"]
    images = _images(4, 2)
    with pytest.warns(UserWarning, match="max_position_embeddings=64"):
        got = mm_fn.clip_score(torch.from_numpy(images), long, (model, processor))
    with pytest.warns(UserWarning, match="max_position_embeddings=64"):
        want = jax_mm_fn.clip_score(images, long, (jitted, processor))
    assert abs(float(got) - float(want)) <= CLIP_SCORE_ATOL


def test_errors_as_jax(clips):
    _, _, model = clips
    processor = _ClipProcessor()
    images = torch.from_numpy(_images(5, 2))
    with pytest.raises(ValueError, match="same"):
        mm_fn.clip_score(images, ["just one"], (model, processor))
    with pytest.raises(ValueError, match="3d"):
        mm_fn.clip_score([images[0], images], ["a", "b"], (model, processor))
    with pytest.raises(ValueError, match="prompts"):
        mm_fn.clip_image_quality_assessment(images, (model, processor), prompts=("nonexistent-prompt",))
    with pytest.raises(ValueError, match="must be a tuple"):
        mm_fn.clip_image_quality_assessment(images, (model, processor), prompts=["quality"])
    with pytest.raises(ValueError, match="length 2"):
        mm_fn.clip_image_quality_assessment(images, (model, processor), prompts=(("a", "b", "c"),))
    with pytest.raises(ValueError, match="4D"):
        mm_fn.clip_image_quality_assessment(images[0], (model, processor))


class _Absent:
    """A ``transformers`` class whose checkpoint is absent: ``from_pretrained`` raises as offline."""

    @classmethod
    def from_pretrained(cls, name, *args, **kwargs):
        raise OSError(f"{name} is not in the cache and the hub is offline")


def test_default_hub_ids_are_gated_with_the_jax_messages(monkeypatch):
    """The port's loader fails on the absent configuration; the JAX one's
    Flax classes are stood in for by ``_Absent`` (its real ones would import
    the modeling code, some seconds, for the same error)."""
    import importlib

    import transformers

    for name in ("FlaxCLIPModel", "CLIPProcessor"):
        monkeypatch.setitem(vars(transformers), name, _Absent)  # no lazy import of the real class
    for make, jax_make in ((lambda: CLIPScore("openai/clip-not-cached", device="cpu"),
                            lambda: jax_mm.CLIPScore("openai/clip-not-cached")),
                           (lambda: mm_fn.clip_image_quality_assessment(torch.zeros(1, 3, 8, 8)),
                            lambda: jax_mm_fn.clip_image_quality_assessment(np.zeros((1, 3, 8, 8), np.float32)))):
        with pytest.raises(ModuleNotFoundError) as got:
            make()
        with pytest.raises(ModuleNotFoundError) as want:
            jax_make()
        assert str(got.value) == str(want.value) and "(model, processor)" in str(got.value)
    clip = importlib.import_module("tpumetrics_torch.functional.multimodal.clip_score")
    jax_clip = importlib.import_module("tpumetrics.functional.multimodal.clip_score")
    monkeypatch.setattr(clip, "_TRANSFORMERS_AVAILABLE", False)
    monkeypatch.setattr(jax_clip, "_TRANSFORMERS_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError) as got:
        mm_fn.clip_score(torch.zeros(3, 8, 8), "a")
    with pytest.raises(ModuleNotFoundError) as want:
        jax_mm_fn.clip_score(np.zeros((3, 8, 8), np.float32), "a")
    assert "requires `transformers`" in str(got.value) and str(got.value) == str(want.value)


class _TrackedCLIP(CLIPModel):
    """The port's CLIP at tiny widths, recording every device it is moved to."""

    def __init__(self):
        super().__init__(CLIPConfig(CLIPTextConfig(100, 32, 64, 2, 1, 16), CLIPVisionConfig(32, 64, 2, 1, 32, 8), 16))
        self.moved_to = []

    def to(self, *args, **kwargs):
        self.moved_to.append(torch.device(args[0] if args else kwargs["device"]))
        return super().to(*args, **kwargs)


def test_a_model_loaded_from_a_hub_id_runs_on_the_metrics_device(monkeypatch):
    """The hub loader stubbed with a model that records its moves: the model a
    hub id loads goes to the device asked for (functional ``device=``, a
    metric's own device); a ``(model, processor)`` pair stays where it is."""
    import transformers

    class _Config:
        @classmethod
        def from_pretrained(cls, name):
            return cls()

    class _Model:
        @classmethod
        def from_pretrained(cls, name):
            return _TrackedCLIP()

    class _Processor:
        @classmethod
        def from_pretrained(cls, name):
            return _ClipProcessor()

    for name, stub in (("CLIPConfig", _Config), ("CLIPModel", _Model), ("CLIPProcessor", _Processor)):
        monkeypatch.setitem(vars(transformers), name, stub)
    cpu = torch.device("cpu")
    images = torch.from_numpy(_images(4, 2, 1.0))
    loaded = [CLIPScore("stub", device="cpu").model, CLIPImageQualityAssessment("stub", device="cpu").model,
              _get_clip_model_and_processor("stub", "cpu")[0]]
    for model in loaded:
        assert model.moved_to == [cpu] and next(model.parameters()).device == cpu and not model.training
    assert mm_fn.clip_score(images, CAPTIONS[:2], "stub", device="cpu").shape == ()
    assert mm_fn.clip_image_quality_assessment(images, "stub", device="cpu").shape == (2,)
    pair = (_TrackedCLIP(), _ClipProcessor())
    CLIPScore(pair, device="cpu").update(images, CAPTIONS[:2])
    assert pair[0].moved_to == []


def test_published_widths_and_random_weights():
    text, vision = CLIP_VIT_L_14.text_config, CLIP_VIT_L_14.vision_config
    assert (text.num_hidden_layers, text.hidden_size, text.num_attention_heads, text.intermediate_size,
            text.vocab_size, text.max_position_embeddings, text.hidden_act, text.eos_token_id) == (
        12, 768, 12, 3072, 49408, 77, "quick_gelu", 2)
    assert (vision.num_hidden_layers, vision.hidden_size, vision.num_attention_heads, vision.intermediate_size,
            vision.image_size, vision.patch_size) == (24, 1024, 16, 4096, 224, 14)
    assert (vision.image_size // vision.patch_size) ** 2 + 1 == 257 and CLIP_VIT_L_14.projection_dim == 768
    small = CLIPConfig(CLIPTextConfig(100, 32, 64, 2, 1, 16), CLIPVisionConfig(32, 64, 2, 1, 32, 8), 16)
    params = random_clip_params(small, seed=5)
    assert set(params) == set(CLIPModel(small).state_dict())
    assert all(torch.equal(params[k], v) for k, v in random_clip_params(small, seed=5).items())
    model = build_clip(small, params, dtype=torch.float64)
    feats = model.get_image_features(torch.rand(2, 3, 32, 32))
    assert feats.dtype == torch.float64 and feats.shape == (2, 16)
