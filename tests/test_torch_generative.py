"""The port's FID, KID, MiFID and Inception Score, held against the JAX
package on the CPU.

Both packages take the same seeded uint8 images through the same stand-in
extractor (the first pixels as features, as ``tests/image/test_generative.py``
does) and, once, through the 64-d tap of a narrow InceptionV3 (the stem only)
from one ``random_inception_params`` file. Tolerances:

- KID and IS draw their subsets and splits from numpy's ``default_rng(seed)``
  in both packages: on the same float32 features KID's float64 host MMD is
  bit for bit the JAX one, IS within ``RTOL`` (float32 softmax);
- FID's and MiFID's float32 moment states and values within ``RTOL`` = 1e-5
  relative (plus 1e-6): the same sums in another order; the Inception stem's
  features within 1e-5 of their scale, its FID within ``TAP_RTOL`` = 1e-4
  (the float32 covariances' cancellation over six images);
- counts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpumetrics.image as jax_image
from tpumetrics.image import fid as jax_fid
from tpumetrics.image import kid as jax_kid
from tpumetrics.image._inception import random_inception_params
from tpumetrics_torch.backbones import registry, registry_stats
from tpumetrics_torch.image import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    MemorizationInformedFrechetInceptionDistance,
)
from tpumetrics_torch.image import fid as port_fid
from tpumetrics_torch.image import kid as port_kid

RTOL, ATOL = 1e-5, 1e-6
TAP_RTOL = 1e-4
DIM = 12


@pytest.fixture(autouse=True)
def _clean_registry():
    registry._reset_backbones()
    yield
    registry._reset_backbones()


def _extract(imgs):
    return imgs.reshape(imgs.shape[0], -1)[:, :DIM].to(torch.float32)


def _jax_extract(imgs):
    return jnp.asarray(imgs, jnp.float32).reshape(imgs.shape[0], -1)[:, :DIM]


def _batches(n_batches=3, n=8, seed=0, high=255):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, high, (n, 3, 4, 4)).astype(np.uint8) for _ in range(n_batches)]


REAL, FAKE = _batches(seed=1), _batches(seed=2, high=128)


def _run(metric, batches_by_flag, port):
    for real, batches in batches_by_flag:
        for b in batches:
            x = torch.from_numpy(b) if port else jnp.asarray(b)
            if real is None:
                metric.update(x)
            else:
                metric.update(x, real=real)
    return metric.compute()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("normalize", [False, True])
def test_fid_states_and_value_match_jax(normalize):
    scale = (lambda b: (b / 255.0).astype(np.float32)) if normalize else (lambda b: b)
    stream = [(True, [scale(b) for b in REAL]), (False, [scale(b) for b in FAKE])]
    fid = FrechetInceptionDistance(feature=_extract, num_features=DIM, normalize=normalize, device="cpu")
    jfid = jax_image.FrechetInceptionDistance(feature=_jax_extract, num_features=DIM, normalize=normalize)
    got, want = _run(fid, stream, True), _run(jfid, stream, False)
    for name in fid._defaults:
        ours, theirs = getattr(fid, name), np.asarray(getattr(jfid, name))
        assert ours.dtype == torch.float32 and tuple(ours.shape) == theirs.shape, name
        _close(ours, theirs)
    _close(got, want)
    assert float(fid.real_features_num_samples) == 24.0


def test_fid_streaming_equals_one_pass_and_keeps_real_stats():
    one = FrechetInceptionDistance(feature=_extract, num_features=DIM, reset_real_features=False, device="cpu")
    many = FrechetInceptionDistance(feature=_extract, num_features=DIM, device="cpu")
    one.update(torch.from_numpy(np.concatenate(REAL)), real=True)
    for b in REAL:
        many.update(torch.from_numpy(b), real=True)
    for s in ("sum", "cov_sum", "num_samples"):
        _close(getattr(one, f"real_features_{s}"), getattr(many, f"real_features_{s}"))
    kept = one.real_features_cov_sum
    one.update(torch.from_numpy(FAKE[0]), real=False)
    one.reset()
    assert one.real_features_cov_sum is kept and float(one.fake_features_num_samples) == 0.0
    many.reset()
    assert float(many.real_features_num_samples) == 0.0
    with pytest.raises(RuntimeError, match="More than one sample"):
        many.compute()


def test_fid_probes_the_extractor_and_drops_its_graphs_on_copy():
    import copy

    fid = FrechetInceptionDistance(feature=lambda x: x.reshape(x.shape[0], -1)[:, :5], device="cpu")
    assert fid.num_features == 5  # probed with a (1, 3, 299, 299) batch
    fid.update(torch.from_numpy(REAL[0]), real=True)
    assert fid._jit_accum is not None and copy.deepcopy(fid)._jit_accum is None
    assert "_jit_accum" not in fid.__getstate__()
    with pytest.raises(TypeError, match="unknown input"):
        FrechetInceptionDistance(feature=1.5, device="cpu")


def test_compute_fid_matches_jax():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((40, 6)), rng.standard_normal((40, 6)) * 1.3 + 0.2
    mu1, mu2 = a.mean(0).astype(np.float32), b.mean(0).astype(np.float32)
    s1, s2 = np.cov(a.T).astype(np.float32), np.cov(b.T).astype(np.float32)
    got = port_fid._compute_fid(*(torch.from_numpy(x) for x in (mu1, s1, mu2, s2)))
    want = jax_fid._compute_fid(*(jnp.asarray(x) for x in (mu1, s1, mu2, s2)))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("subsets,subset_size,degree,gamma,coef", [(4, 10, 3, None, 1.0), (3, 16, 2, 0.5, 2.0)])
def test_kid_subsets_are_the_jax_draws(subsets, subset_size, degree, gamma, coef):
    stream = [(True, REAL), (False, FAKE)]
    kw = dict(subsets=subsets, subset_size=subset_size, degree=degree, gamma=gamma, coef=coef, seed=7)
    got = _run(KernelInceptionDistance(feature=_extract, device="cpu", **kw), stream, True)
    want = _run(jax_image.KernelInceptionDistance(feature=_jax_extract, **kw), stream, False)
    for ours, theirs in zip(got, want):
        assert float(ours) == float(theirs)  # the same float64 MMD over the same subsets, then float32


def test_kid_kernels_match_jax():
    rng = np.random.default_rng(4)
    f1, f2 = (rng.standard_normal((9, 5)).astype(np.float32) for _ in range(2))
    _close(port_kid.poly_kernel(torch.from_numpy(f1), torch.from_numpy(f2)), jax_kid.poly_kernel(f1, f2))
    _close(port_kid.poly_mmd(torch.from_numpy(f1), torch.from_numpy(f2), degree=2, coef=0.5),
           jax_kid.poly_mmd(jnp.asarray(f1), jnp.asarray(f2), degree=2, coef=0.5))
    assert port_kid._np_poly_mmd(f1.astype(np.float64), f2.astype(np.float64)) == jax_kid._np_poly_mmd(
        f1.astype(np.float64), f2.astype(np.float64))
    kid = KernelInceptionDistance(feature=_extract, subset_size=100, device="cpu")
    kid.update(torch.from_numpy(REAL[0]), real=True)
    kid.update(torch.from_numpy(FAKE[0]), real=False)
    with pytest.raises(ValueError, match="subset_size"):
        kid.compute()


@pytest.mark.parametrize("splits,n", [(2, 16), (10, 6)])
def test_inception_score_splits_are_the_jax_draws(splits, n):
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 255, (n, 3, 4, 4)).astype(np.uint8)]
    got = _run(InceptionScore(feature=_extract, splits=splits, seed=3, device="cpu"), [(None, imgs)], True)
    want = _run(jax_image.InceptionScore(feature=_jax_extract, splits=splits, seed=3), [(None, imgs)], False)
    for ours, theirs in zip(got, want):
        _close(ours, theirs)


def test_mifid_matches_jax():
    stream = [(True, REAL), (False, FAKE)]
    for eps in (0.1, 1.0):
        got = _run(MemorizationInformedFrechetInceptionDistance(feature=_extract, cosine_distance_eps=eps,
                                                                device="cpu"), stream, True)
        want = _run(jax_image.MemorizationInformedFrechetInceptionDistance(feature=_jax_extract,
                                                                           cosine_distance_eps=eps), stream, False)
        _close(got, want)
    # all-zero feature rows are dropped from the memorization distance, as the JAX package drops them
    zero = [np.zeros_like(REAL[0])]
    got = _run(MemorizationInformedFrechetInceptionDistance(feature=_extract, device="cpu"),
               [(True, REAL + zero), (False, FAKE)], True)
    want = _run(jax_image.MemorizationInformedFrechetInceptionDistance(feature=_jax_extract),
                [(True, REAL + zero), (False, FAKE)], False)
    _close(got, want)


@pytest.fixture(scope="module")
def inception_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("inception") / "inception.npz"
    np.savez(path, **random_inception_params(seed=2))
    return str(path)


def test_the_family_on_one_narrow_inception_handle_matches_jax(inception_npz):
    """FID, KID, MiFID and IS on the 64-d tap (the stem alone) of one weights
    file: one resident handle shared by four metrics, their values against
    the JAX package's on the same file and images."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (6, 3, 32, 32), dtype=np.uint8)
    b = rng.integers(0, 96, (6, 3, 32, 32), dtype=np.uint8)
    kw = dict(feature_extractor_weights_path=inception_npz)
    ours = {"fid": FrechetInceptionDistance(feature=64, device="cpu", **kw),
            "kid": KernelInceptionDistance(feature=64, subsets=2, subset_size=6, seed=1, device="cpu", **kw),
            "mifid": MemorizationInformedFrechetInceptionDistance(feature=64, device="cpu", **kw),
            "is": InceptionScore(feature=64, splits=2, seed=1, device="cpu", **kw)}
    stats = registry_stats()
    (key,) = stats
    assert stats[key]["refs"] == 4 and all(m.backbone_key == key for m in ours.values())
    # FID and KID against the JAX classes on the same file (MiFID and IS share the handle; their arithmetic is
    # held above with callable extractors)
    theirs = {"fid": jax_image.FrechetInceptionDistance(feature=64, **kw),
              "kid": jax_image.KernelInceptionDistance(feature=64, subsets=2, subset_size=6, seed=1, **kw)}
    for name, metric in ours.items():
        stream = [(None, [a])] if name == "is" else [(True, [a]), (False, [b])]
        got = _run(metric, stream, True)
        if name in theirs:
            _close(got, _run(theirs[name], stream, False), rtol=TAP_RTOL, atol=TAP_RTOL)
        assert np.isfinite(np.asarray([float(v) for v in (got if isinstance(got, tuple) else (got,))])).all()
    feats = ours["kid"].real_features[0].numpy()
    np.testing.assert_allclose(feats, np.asarray(theirs["kid"].real_features[0]), rtol=0,
                               atol=1e-5 * np.abs(feats).max())
    assert registry_stats()[key]["dispatches"] == 7 and registry_stats()[key]["compiles"] == 1
    for m in ours.values():
        m.release_backbones()
    assert not registry_stats()


def test_int_features_without_weights_raise_with_the_recipe(monkeypatch):
    monkeypatch.delenv("TPUMETRICS_INCEPTION_WEIGHTS", raising=False)
    for cls in (FrechetInceptionDistance, KernelInceptionDistance, MemorizationInformedFrechetInceptionDistance):
        with pytest.raises(ModuleNotFoundError, match="_inception_convert"):
            cls(feature=2048, device="cpu")
    with pytest.raises(ModuleNotFoundError, match="_inception_convert"):
        InceptionScore(device="cpu")  # default feature="logits_unbiased"


def test_the_weights_file_from_the_environment(inception_npz, monkeypatch):
    monkeypatch.setenv("TPUMETRICS_INCEPTION_WEIGHTS", inception_npz)
    fid = FrechetInceptionDistance(feature=192, device="cpu")
    assert fid.num_features == 192 and fid.real_features_cov_sum.shape == (192, 192)
    assert InceptionScore(device="cpu").inception.arch == "inception:logits_unbiased"


def test_chip_smoke_fid_state_check_holds_and_rejects_planted_faults():
    """``chip_smoke.fid_state_check`` (FID's float32 states entry by entry against float64 sums of the same
    features) passes FID's own states and rejects the other set's sums and a stream that lost half of a batch."""
    import chip_smoke

    fid = FrechetInceptionDistance(feature=_extract, num_features=DIM, device="cpu")
    sums = {}
    for real, seed in ((True, 40), (False, 41)):
        f = np.concatenate([_extract(torch.from_numpy(b)).double().numpy() for b in _batches(3, 8, seed)])
        for b in _batches(3, 8, seed):
            fid.update(torch.from_numpy(b), real=real)
        sums[real] = {"n": float(len(f)), "s": f.sum(0), "abs_s": np.abs(f).sum(0), "c": f.T @ f,
                      "abs_c": np.abs(f).T @ np.abs(f)}
    for real, prefix in ((True, "real"), (False, "fake")):
        assert max(chip_smoke.fid_state_check(fid, prefix, sums[real], depth=8 + 3).values()) <= 1.0
    lost = _extract(torch.from_numpy(_batches(3, 8, 40)[0][4:])).double().numpy()
    half = {**sums[True], "n": sums[True]["n"] - 4, "s": sums[True]["s"] - lost.sum(0), "c": sums[True]["c"] - lost.T @ lost}
    for fault in (sums[False], half):
        got = chip_smoke.fid_state_check(fid, "real", fault, depth=8 + 3)
        assert got["sum"] > 1.0 and got["cov_sum"] > 1.0, got


def test_chip_smoke_fid_oracle_holds_compute_within_its_bounds():
    """``chip_smoke.fid_oracle`` (scipy's ``sqrtm`` in float64) and ``fid64_of_states`` (FID in float64 from the
    metric's float32 states) hold the port's FID within ``bound`` and ``compute()`` within ``bound_compute``, on
    features with a dead channel and a cancelling mean; a compute() that drops the mean term fails."""
    import chip_smoke

    rng = np.random.default_rng(42)
    feats = {True: 5.0 + rng.standard_normal((300, DIM)), False: 5.3 + 1.2 * rng.standard_normal((300, DIM))}
    for f in feats.values():
        f[:, 3] = 0.0
    fid = FrechetInceptionDistance(feature=lambda x: x, num_features=DIM, device="cpu")
    sums = {}
    for real, f in feats.items():
        f32 = f.astype(np.float32)
        for lo in range(0, 300, 100):
            fid.update(torch.from_numpy(f32[lo:lo + 100]), real=real)
        f64 = f32.astype(np.float64)
        sums[real] = {"n": 300.0, "s": f64.sum(0), "abs_s": np.abs(f64).sum(0), "c": f64.T @ f64,
                      "abs_c": np.abs(f64).T @ np.abs(f64)}
    oracle = chip_smoke.fid_oracle(sums[True], sums[False], depth=100 + 3)
    value = float(fid.compute())
    assert abs(value - oracle["fid"]) <= oracle["bound"] and oracle["bound_compute"] < oracle["bound"]
    own = chip_smoke.fid64_of_states(torch, fid)
    assert abs(value - own) <= oracle["bound_compute"]
    mean_term = float(((fid.real_features_sum - fid.fake_features_sum).double() / 300).pow(2).sum())
    assert abs(value - mean_term - own) > oracle["bound_compute"]


def test_fid_compute_refuses_a_capture(monkeypatch):
    monkeypatch.setattr(port_fid, "_is_capturing", lambda: True)
    z = torch.zeros(2)
    with pytest.raises(NotImplementedError, match="outside a CUDA graph capture"):
        port_fid._compute_fid(z, torch.eye(2), z, torch.eye(2))
