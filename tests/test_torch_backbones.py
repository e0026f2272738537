"""The port's backbone runtime (``tpumetrics_torch/backbones``), its
``JitWithEagerFallback`` and ``Metric.release_backbones``, held against the
JAX package on the CPU.

The same seeded numpy weights go into both registries, the same sequence of
acquisitions and closes runs on both, and their counts (refs, handles,
resident bytes, compiles, dispatches) must agree; the forwards (a 3x3
convolution with a tanh, JAX's and torch's) agree within ``RTOL`` = 1e-5
(float32 sums in another order). On the CPU the port's engine counts first
sightings where a card counts captures, as the JAX engine counts compiles.
The JIT fallback's latch is driven on the CPU with a capture that fails by
construction; ``tests/test_torch_cuda.py`` drives it on a card with a
callable that reads the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpumetrics.backbones import registry as jax_registry
from tpumetrics_torch.backbones import (
    DTYPE_POLICIES,
    BackboneEngine,
    cast_params,
    get_backbone,
    place_backbone,
    registry_stats,
    resident_bytes,
)
from tpumetrics_torch.backbones import registry
from tpumetrics_torch.backbones.engine import pow2_at_least
from tpumetrics_torch.utils import jit_fallback
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError
from tpumetrics_torch.utils.jit_fallback import JitWithEagerFallback

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_registries():
    registry._reset_backbones()
    jax_registry._reset_backbones()
    yield
    registry._reset_backbones()
    jax_registry._reset_backbones()


def _conv_params(seed, cout=8):
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((cout, 3, 3, 3)) * 0.2).astype(np.float32),
        "b": (rng.standard_normal((cout,)) * 0.1).astype(np.float32),
    }


def _torch_forward(params, x):
    return torch.tanh(F.conv2d(x, params["w"], padding=1) + params["b"].reshape(1, -1, 1, 1))


def _jax_forward(params, x):
    out = jax.lax.conv_general_dilated(x, jnp.asarray(params["w"]), (1, 1), "SAME",
                                       dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return jnp.tanh(out + jnp.reshape(jnp.asarray(params["b"]), (1, -1, 1, 1)))


def _both(params, **kw):
    return (get_backbone("test:conv", params, forward=_torch_forward, device="cpu", **kw),
            jax_registry.get_backbone("test:conv", params, forward=_jax_forward, **kw))


def _counts(handle):
    return handle.refs, handle.closed, handle.resident_bytes()


# ---------------------------------------------------------------- registry


def test_dedupe_by_digest_refcount_and_eviction_match_jax():
    params = _conv_params(0)
    h1, j1 = _both(params)
    h2, j2 = _both({k: v.copy() for k, v in params.items()})  # separate arrays, the same content
    assert h1 is h2 and j1 is j2 and _counts(h1) == _counts(j1) == (2, False, 8 * 27 * 4 + 8 * 4)
    h1.acquire(), j1.acquire()
    for _ in range(2):
        h1.close(), j1.close()
        assert _counts(h1) == _counts(j1)
    assert len(registry._HANDLES) == len(jax_registry._HANDLES) == 1
    h1.close(), j1.close()
    assert h1.closed and j1.closed and h1.params is None and not registry._HANDLES and resident_bytes() == 0
    with pytest.raises(TPUMetricsUserError, match="closed"):
        h1.acquire()
    with pytest.raises(TPUMetricsUserError, match="closed"):
        h1(torch.zeros(1, 3, 4, 4))


def test_distinct_weights_policies_and_devices_are_distinct_handles():
    a = get_backbone("test:conv", _conv_params(1), forward=_torch_forward, device="cpu")
    b = get_backbone("test:conv", _conv_params(2), forward=_torch_forward, device="cpu")
    c = get_backbone("test:conv", _conv_params(1), forward=_torch_forward, device="cpu", dtype_policy="bfloat16")
    assert len({id(a), id(b), id(c)}) == 3 and len(registry._HANDLES) == 3
    assert c.params["w"].dtype == torch.bfloat16 and a.params["w"].dtype == torch.float32
    assert set(registry_stats()) == {a.key, b.key, c.key} and registry_stats()[c.key]["dtype_policy"] == "bfloat16"
    with pytest.raises(TPUMetricsUserError, match="dtype policy"):
        get_backbone("test:conv", _conv_params(1), forward=_torch_forward, device="cpu", dtype_policy="float16")
    with pytest.raises(TPUMetricsUserError, match="sharding"):
        get_backbone("test:conv", _conv_params(1), forward=_torch_forward, device="cpu", mesh=object())
    with pytest.raises(TPUMetricsUserError, match="Unknown backbone arch"):
        get_backbone("test:other", _conv_params(1), device="cpu")


def test_acquire_false_and_resident_bytes_flat_match_jax():
    params = _conv_params(3)
    h, j = _both(params, acquire=False)
    assert (h.refs, j.refs) == (1, 1)
    h2, j2 = _both(params, acquire=False)
    assert h2 is h and j2 is j and (h.refs, j.refs) == (1, 1)
    single, jax_single = resident_bytes(), jax_registry.resident_bytes()
    extra = [_both(params) for _ in range(4)]
    assert (resident_bytes(), jax_registry.resident_bytes()) == (single, jax_single) == (single, single)
    assert (h.refs, j.refs) == (5, 5)
    for e, f in extra:
        e.close(), f.close()
    h.close(), j.close()
    assert resident_bytes() == jax_registry.resident_bytes() == 0


def test_park_revive_and_discard_match_jax():
    params = _conv_params(4)
    h, j = _both(params)
    h.acquire(), j.acquire()
    assert h.release_resident() is False and j.release_resident() is False  # another resident holder
    assert h.release_resident() is True and j.release_resident() is True  # the last one: weights to the host
    assert h.params is None and resident_bytes() == 0 and (h.refs, h.parked) == (j.refs, j.parked) == (0, 2)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 8, 8)).astype(np.float32))
    h.reacquire(), j.reacquire()
    assert h.generation == 1 and (h.refs, h.parked) == (j.refs, j.parked) == (1, 1)
    np.testing.assert_allclose(h(x).numpy(), _torch_forward({k: torch.from_numpy(v) for k, v in params.items()}, x))
    h.close(), j.close()  # a parked reference keeps the handle registered
    assert not h.closed and not j.closed and len(registry._HANDLES) == 1
    h.discard_parked(), j.discard_parked()
    assert h.closed and j.closed and not registry._HANDLES and not jax_registry._HANDLES


def test_deepcopy_shares_the_handle_and_counts_once():
    import copy

    h = get_backbone("test:conv", _conv_params(5), forward=_torch_forward, device="cpu")
    holder = {"a": h, "b": [h]}
    clone = copy.deepcopy(holder)
    assert clone["a"] is h and clone["b"][0] is h and h.refs == 2


def test_registry_stats_and_the_digest():
    params = _conv_params(6)
    h, j = _both(params)
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 8)).astype(np.float32)
    h(torch.from_numpy(x)), j(jnp.asarray(x))
    st, jst = registry_stats()[h.key], jax_registry.registry_stats()[j.key]
    for k in ("arch", "refs", "parked", "bytes", "compiles", "dispatches", "dtype_policy"):
        assert st[k] == jst[k], k
    assert h.key.startswith("test:conv:") and h.key.endswith(":float32")
    # the digest is over content: a tensor tree and its numpy twin hash alike, other content does not
    digest = registry._weights_digest(params)
    assert digest == registry._weights_digest({k: v.copy() for k, v in params.items()})
    assert digest != registry._weights_digest(_conv_params(7))
    assert registry._weights_digest({"w": torch.ones(2, dtype=torch.bfloat16)})  # no numpy dtype needed


# ---------------------------------------------------------------- placement


def test_placement_casts_once_and_copies():
    params = {"w": np.ones((2, 2), np.float32), "n": np.arange(3, dtype=np.int32), "l": [np.zeros(2, np.float64)]}
    placed = place_backbone("test:x", params, dtype_policy="bfloat16", device="cpu")
    assert placed["w"].dtype == torch.bfloat16 and placed["n"].dtype == torch.int32
    assert placed["l"][0].dtype == torch.bfloat16 and isinstance(placed["l"], list)
    params["w"][0, 0] = 5.0  # the placed weights are a copy
    assert float(placed["w"][0, 0]) == 1.0
    assert cast_params(params)["w"].dtype == torch.float32 and DTYPE_POLICIES == ("float32", "bfloat16")
    with pytest.raises(TPUMetricsUserError, match="sharding"):
        place_backbone("test:x", params, mesh=object(), device="cpu")


def test_builtin_lpips_arch_matches_the_direct_stack():
    from tpumetrics_torch.image._backbones import alexnet_features, lpips_conv_params, random_lpips_params

    params = random_lpips_params("alex", 0)
    h = get_backbone("lpips:alex", params, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32))
    for got, want in zip(h(x), alexnet_features(lpips_conv_params(params, "cpu"))(x)):
        assert torch.equal(got, want)
    with pytest.raises(TPUMetricsUserError, match="lpips:alex/vgg/squeeze"):
        get_backbone("lpips:resnet", params, device="cpu")


# ------------------------------------------------------------------- engine


def test_pow2_buckets_bound_the_programs_as_jax_compiles():
    assert [pow2_at_least(n) for n in (0, 1, 3, 4, 5, 129)] == [1, 1, 4, 4, 8, 256]
    h, j = _both(_conv_params(20))
    rng = np.random.default_rng(20)
    for n in (3, 4, 5, 7, 8, 6):  # buckets 4, 4, 8, 8, 8, 8
        x = rng.standard_normal((n, 3, 8, 8)).astype(np.float32)
        got, want = h(torch.from_numpy(x)), np.asarray(j(jnp.asarray(x)))
        assert tuple(got.shape) == want.shape and got.shape[0] == n  # the pad rows sliced off
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    assert h.engine.compile_count == j.engine.compile_count == 2
    assert h.engine.dispatch_count == j.engine.dispatch_count == 6


def test_pad_rows_do_not_leak_into_results():
    h = get_backbone("test:conv", _conv_params(21), forward=_torch_forward, device="cpu")
    rng = np.random.default_rng(21)
    x5 = torch.from_numpy(rng.standard_normal((5, 3, 8, 8)).astype(np.float32))
    x8 = torch.cat([x5, torch.zeros(3, 3, 8, 8)])
    x7 = torch.from_numpy(rng.standard_normal((7, 3, 8, 8)).astype(np.float32))
    h(x7)  # fills seven rows of the 8-bucket's staging buffer
    assert torch.equal(h(x5), h(x8)[:5])  # rows 5-6 were zeroed again


def test_sequence_axis_padding_and_the_staging_buffers():
    """``pad_axes=(0, 1)`` pads a token axis too; the staging buffers are the engine's own."""
    seen = []

    def forward(params, ids):
        seen.append(tuple(ids.shape))
        return (ids.float() * params["s"]).sum(dim=1)

    h = get_backbone("test:tok", {"s": np.float32(2.0)}, forward=forward, pad_axes=(0, 1), device="cpu")
    ids = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    assert h(ids).tolist() == [12.0, 30.0, 48.0] and seen == [(4, 4)]
    assert h(ids[:2, :2]).tolist() == [6.0, 18.0] and seen == [(4, 4), (2, 2)]
    (program,) = [p for p in h.engine._programs.values() if p.staging[0].shape == (4, 4)]
    assert program.staging[0].data_ptr() != ids.data_ptr()


def test_runs_inline_while_a_stream_captures(monkeypatch):
    """Under a capture the engine neither pads nor stages: the caller's graph records the forward."""
    h = get_backbone("test:conv", _conv_params(22), forward=_torch_forward, device="cpu")
    from tpumetrics_torch.backbones import engine

    monkeypatch.setattr(engine, "_is_capturing", lambda: True)
    x = torch.zeros(3, 3, 8, 8)
    assert tuple(h(x).shape) == (3, 8, 8, 8)
    assert h.engine.compile_count == h.engine.dispatch_count == 0 and not h.engine._programs


def test_dtype_policy_casts_inputs_in_and_outputs_back():
    h = get_backbone("test:conv", _conv_params(23), forward=_torch_forward, dtype_policy="bfloat16", device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 8, 8)).astype(np.float32))
    out = h(x)
    assert out.dtype == torch.float32
    full = get_backbone("test:conv", _conv_params(23), forward=_torch_forward, device="cpu")(x)
    assert 0 < float((out - full).abs().max()) < 0.05  # bf16 rounding, not another function
    with pytest.raises(TPUMetricsUserError, match="sharding"):
        BackboneEngine(_torch_forward, label="x", mesh=object())


def test_an_engine_and_its_programs_are_freed_without_the_garbage_collector():
    """The bucket forwards close over the weights, not the engine: a dropped engine (and so its graphs on a card)
    is freed at once, never by a collection that might run while a stream captures."""
    import gc
    import weakref

    engine = BackboneEngine(_torch_forward, label="x")
    params = {k: torch.from_numpy(v) for k, v in _conv_params(24).items()}
    gc.disable()
    try:
        for n in (3, 3, 5):
            engine(params, torch.zeros(n, 3, 8, 8))
        ref = weakref.ref(engine)
        del engine
        assert ref() is None
    finally:
        gc.enable()


def test_captures_hold_the_garbage_collector_off():
    """A collection during a capture could destroy a dead metric's graph and so invalidate the capture: the
    wrapper's captures run with the collector off, and turn it back on after a failed one."""
    import gc

    from tpumetrics_torch.utils.checks import _gc_paused

    seen = []
    with _gc_paused():
        seen.append(gc.isenabled())
    assert seen == [False] and gc.isenabled()
    with pytest.raises(RuntimeError, match="capture failed"), _gc_paused():
        raise RuntimeError("capture failed")
    assert gc.isenabled()


# ---------------------------------------------------- the JIT fallback's latch


class _FakeCard:
    """Make the CPU take the wrapper's card path, with a capture that fails
    (a callable that reads the host) or one that records a replay."""

    def __init__(self, monkeypatch, capture_fails=True):
        monkeypatch.setattr(JitWithEagerFallback, "_device", lambda self, args: torch.device("cpu"))

        def capture(wrapper, args, device):
            if capture_fails:
                raise RuntimeError("operation not permitted when stream is capturing")
            return _Replay(wrapper._fn, args)

        monkeypatch.setattr(JitWithEagerFallback, "_capture", capture)


class _Replay:
    def __init__(self, fn, args):
        self.fn, self.static = fn, [a.clone() if isinstance(a, torch.Tensor) else a for a in args]

    def replay(self, args, device):
        for buf, a in zip(self.static, args):
            if isinstance(buf, torch.Tensor):
                buf.copy_(a)
        return self.fn(*self.static)


def test_latch_after_a_failed_capture_and_an_eager_success(monkeypatch, recwarn):
    _FakeCard(monkeypatch)
    fn = JitWithEagerFallback(lambda x: x * 2, "The probe")
    x = torch.arange(3.0)
    assert fn(x).tolist() == [0.0, 2.0, 4.0] and not fn.eager_mode  # the first sighting: the warm-up
    assert fn(x).tolist() == [0.0, 2.0, 4.0] and fn.eager_mode  # the capture failed, the eager run did not
    assert fn(x + 1).tolist() == [2.0, 4.0, 6.0] and fn.counts == {"eager": 3, "captured": 0, "replayed": 0}
    warned = [w for w in recwarn if "cannot be captured" in str(w.message)]
    assert len(warned) == 1 and "The probe" in str(warned[0].message)


def test_a_transient_data_error_does_not_latch(monkeypatch, recwarn):
    _FakeCard(monkeypatch)
    state = {"bad": False}

    def fn(x):
        if state["bad"]:
            raise ValueError("bad batch")
        return x + 1

    wrapped = JitWithEagerFallback(fn, "The probe")
    wrapped(torch.zeros(2))
    state["bad"] = True
    with pytest.raises(ValueError, match="bad batch"):
        wrapped(torch.zeros(2))  # the capture fails and so does the eager run: it propagates
    assert not wrapped.eager_mode and not [w for w in recwarn if "cannot be captured" in str(w.message)]
    state["bad"] = False
    wrapped(torch.zeros(2))
    assert wrapped.eager_mode  # the next failed capture, then an eager success, latches


def test_signatures_replays_and_the_placement_token(monkeypatch):
    _FakeCard(monkeypatch, capture_fails=False)
    token = {"gen": 0}
    fn = JitWithEagerFallback(lambda a, k: a * (k[0] if isinstance(k, list) else k), "The probe",
                              key_fn=lambda: token["gen"])
    a = torch.ones(2)
    outs = [fn(a * i, 3) for i in range(4)]
    assert [o.tolist() for o in outs] == [[0.0, 0.0], [3.0, 3.0], [6.0, 6.0], [9.0, 9.0]]
    assert fn.counts == {"eager": 1, "captured": 1, "replayed": 2}
    fn(torch.ones(3), 3)  # another signature: its own warm-up
    assert fn.counts["eager"] == 2
    token["gen"] = 1  # new weights: every graph dropped, the warm-ups start again
    fn(a, 3)
    assert fn.counts["eager"] == 3 and not fn._graphs
    fn(a, [1])  # an unhashable argument cannot key a graph: eager
    assert fn.counts["eager"] == 4


def test_the_cpu_runs_eagerly_and_warns_never(recwarn):
    fn = JitWithEagerFallback(lambda x: x.sum() * float(x.max()), "The probe")  # reads the host
    for _ in range(3):
        assert float(fn(torch.arange(3.0))) == 6.0
    assert fn.counts == {"eager": 3, "captured": 0, "replayed": 0} and not fn.eager_mode and not list(recwarn)
    assert jit_fallback._tree_map(lambda t: t + 1, {"a": (torch.zeros(1), 2)})["a"][1] == 2


# ------------------------------------------------------ release_backbones


def test_release_backbones_is_idempotent_and_matches_jax():
    from tpumetrics.image import LearnedPerceptualImagePatchSimilarity as JaxLPIPS
    from tpumetrics_torch.image import LearnedPerceptualImagePatchSimilarity
    from tpumetrics_torch.image._backbones import random_lpips_params

    params = random_lpips_params("alex", 1)
    m = LearnedPerceptualImagePatchSimilarity(net_type="alex", backbone_params=params, device="cpu")
    jm = JaxLPIPS(net_type="alex", backbone_params=params)
    (handle,) = m._backbone_handles
    (jhandle,) = jm._backbone_handles
    assert m._backbone_share_ids == (handle.key,) and m.backbone_key == handle.key
    clone = m.clone()
    jclone = jm.clone()
    assert clone._backbone_handles[0] is handle and handle.refs == jhandle.refs == 2
    for metric, jmetric in ((clone, jclone), (m, jm)):
        metric.release_backbones(), jmetric.release_backbones()
        metric.release_backbones(), jmetric.release_backbones()  # a no-op, not a double close
        assert (handle.refs, handle.closed) == (jhandle.refs, jhandle.closed)
    assert handle.closed and not registry_stats() and m._backbone_share_ids == ()
