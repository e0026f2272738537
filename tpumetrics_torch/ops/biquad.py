"""Cascaded IIR biquads over time (the filterbanks of SRMR; port of
``tpumetrics/functional/audio/srmr.py`` ``_biquad_cascade``).

Every lane of ``x`` (``(L, T)`` float32) runs ``S`` direct-form-II-transposed
biquads in cascade, the ``(S, L, 2)`` state starting at zero; ``b`` and ``a``
are ``(S, L, 3)`` and are normalised by ``a[..., 0]`` first. With ``clamp``
each stage's output is clipped to [-1, 1] before it feeds the next stage,
while the stage's own recursion keeps the unclipped value.

On a CUDA tensor the hand-written kernel in ``csrc/biquad_cascade.cu`` runs:
a chunked linear-recurrence scan over T, its state carried between tiles in
float64 in one fixed order (its source gives its bound and design). It
launches on the current stream with no host sync, its scratch (the carries,
and the ticket and flags, zeroed) allocated here on the stream, so a CUDA
graph can capture the call. On a CPU tensor the plain version below runs: a
loop over time in torch. A scan reassociates the recurrence, so the kernel
is not bit for bit the plain loop; both are held to
``biquad_cascade_reference``, the cascade in float64 on the host (scipy's
``lfilter`` a stage): with ``rel`` the largest over lanes of a lane's max
abs error over its peak, the kernel's ``rel`` is at most twice the plain
loop's plus 1e-6 (``REL_SLACK``, ``REL_FLOOR``). There is no fallback: a
CUDA tensor launches the kernel or raises. ``biquad_cascade`` takes SRMR's
two cascades only, on either device (4 stages with ``clamp``, 1 without:
the pairs the kernel is built for); ``biquad_cascade_plain`` and the
reference take any.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from tpumetrics_torch.ops import _build

Tensor = torch.Tensor

# the (stages, clamp) pairs the kernel is built for: SRMR's gammatone bank and its modulation bank
_KERNEL_CASES = ((4, True), (1, False))

# the kernel against the float64 reference: rel(kernel) <= REL_SLACK * rel(plain loop) + REL_FLOOR
REL_SLACK, REL_FLOOR = 2.0, 1e-6

#: kernel launches in this process; callers may set it to 0 to count a run
launches = 0
#: kernel calls recorded into CUDA graphs (each replay launches them again)
captured = 0


@functools.cache
def _kernel() -> Tuple[ctypes._CFuncPtr, int]:
    """The launcher and the samples a block of the kernel owns (its tile)."""
    lib = _build.load("biquad_cascade")
    fn = lib.biquad_cascade
    # (x, b, a, out, carry, sync, lanes, t, tiles, stages, clamp, stream)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.biquad_cascade_tile.restype = ctypes.c_int
    return fn, lib.biquad_cascade_tile()


def scratch_shapes(lanes: int, t_len: int, stages: int, tile: int) -> Tuple[int, int, int]:
    """``(tiles, carry, sync)``: the tiles of a lane, the float64 numbers of
    the carries (a 2-float state per tile, lane and stage) and the int32
    words of the ticket and the tiles' flags, which must be zero at launch."""
    tiles = -(-t_len // tile)
    return tiles, 2 * tiles * lanes * stages, 1 + tiles * lanes


def _normalized(x: Tensor, b: Tensor, a: Tensor) -> Tuple[Tensor, Tensor]:
    """Check the inputs and return ``(b / a0, a / a0)``, contiguous."""
    if x.ndim != 2:
        raise ValueError(f"Expected `x` of shape (lanes, time), got {tuple(x.shape)}")
    if b.ndim != 3 or b.shape[1:] != (x.shape[0], 3) or a.shape != b.shape:
        raise ValueError(
            f"Expected `b` and `a` of shape (stages, {x.shape[0]}, 3), got {tuple(b.shape)} and {tuple(a.shape)}"
        )
    if b.shape[0] < 1:
        raise ValueError(f"Expected at least 1 stage, got {b.shape[0]}")
    for name, t in (("x", x), ("b", b), ("a", a)):
        if t.dtype != torch.float32:
            raise TypeError(f"Expected `{name}` to be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"Expected `{name}` on {x.device}, got {t.device}")
    a0 = a[..., :1]
    return (b / a0).contiguous(), (a / a0).contiguous()


def biquad_cascade_plain(x: Tensor, b: Tensor, a: Tensor, clamp: bool = False) -> Tensor:
    """The plain version, for any number of stages: the cascade as a loop
    over time, all lanes of a step at once (``5 S + 1`` torch ops a step, a
    few more with ``clamp``)."""
    b, a = _normalized(x, b, a)
    return _plain(x, b, a, clamp)


def _plain(x: Tensor, b: Tensor, a: Tensor, clamp: bool) -> Tensor:
    num_stages = b.shape[0]
    out = torch.empty_like(x)
    s0 = [torch.zeros_like(x[:, 0]) for _ in range(num_stages)]
    s1 = [torch.zeros_like(x[:, 0]) for _ in range(num_stages)]
    coef = [(b[i, :, 0], b[i, :, 1], b[i, :, 2], a[i, :, 1], a[i, :, 2]) for i in range(num_stages)]
    for t in range(x.shape[1]):
        h = x[:, t]
        for i, (b0, b1, b2, a1, a2) in enumerate(coef):
            y = b0 * h + s0[i]
            s0[i] = b1 * h - a1 * y + s1[i]
            s1[i] = b2 * h - a2 * y
            h = torch.clamp(y, -1.0, 1.0) if clamp else y
        out[:, t] = h
    return out


def biquad_cascade_reference(x: Tensor, b: Tensor, a: Tensor, clamp: bool = False) -> np.ndarray:
    """The cascade in float64 on the host, the yardstick of the kernel and
    the plain loop: ``scipy.signal.lfilter`` a stage, ``np.clip`` between
    the stages with ``clamp``, on ``x`` and the float32-normalised
    coefficients, each widened to float64. Lanes that share a stage's
    coefficients are filtered in one call. Returns ``(L, T)`` float64."""
    from scipy.signal import lfilter

    b, a = _normalized(x, b, a)
    h = x.detach().cpu().numpy().astype(np.float64)
    b = b.cpu().numpy().astype(np.float64)
    a = a.cpu().numpy().astype(np.float64)
    for i in range(b.shape[0]):
        coef, group = np.unique(np.concatenate([b[i], a[i]], axis=1), axis=0, return_inverse=True)
        group = group.reshape(-1)
        out = np.empty_like(h)
        for g, row in enumerate(coef):
            sel = group == g
            out[sel] = lfilter(row[:3], row[3:], h[sel], axis=-1)
        h = np.clip(out, -1.0, 1.0) if clamp else out
    return h


def relative_error(got: Tensor, want: np.ndarray) -> float:
    """``rel``: the largest over lanes of a lane's max abs error against
    ``want`` over the lane's peak of ``|want|``, on the positions where both
    are finite (0 for a lane that is zero in both, inf for an error on a
    silent lane)."""
    got = got.detach().cpu().numpy().astype(np.float64)
    fin = np.isfinite(got) & np.isfinite(want)
    with np.errstate(invalid="ignore"):  # inf - inf off the finite positions
        err = np.where(fin, np.abs(got - want), 0.0).max(axis=1, initial=0.0)
    peak = np.where(fin, np.abs(want), 0.0).max(axis=1, initial=0.0)
    rel = np.where(peak > 0, err / np.where(peak > 0, peak, 1.0), np.where(err > 0, np.inf, 0.0))
    return float(rel.max(initial=0.0))


def biquad_cascade(x: Tensor, b: Tensor, a: Tensor, clamp: bool = False) -> Tensor:
    """``(L, T)`` output of the cascade: the kernel on a CUDA tensor, the
    plain version on a CPU tensor.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.ops.biquad import biquad_cascade
        >>> x = torch.tensor([[1.0, 0.0, 0.0, 0.0]])  # an impulse
        >>> b = torch.tensor([[[1.0, 0.0, 0.0]]])
        >>> a = torch.tensor([[[1.0, -0.5, 0.0]]])  # y[t] = x[t] + 0.5 y[t-1]
        >>> biquad_cascade(x, b, a).tolist()
        [[1.0, 0.5, 0.25, 0.125]]
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"biquad_cascade runs on cpu or cuda tensors, got {x.device}")
    b, a = _normalized(x, b, a)
    if (b.shape[0], bool(clamp)) not in _KERNEL_CASES:
        raise ValueError(
            "The kernel runs SRMR's two filterbanks only, 4 stages with clamp or 1 stage without;"
            f" got {b.shape[0]} stages with clamp={bool(clamp)} (biquad_cascade_plain runs any cascade)"
        )
    if x.device.type == "cpu":
        return _plain(x, b, a, clamp)
    x = x.contiguous()
    lanes, t_len = x.shape
    out = torch.empty_like(x)
    if lanes == 0 or t_len == 0:
        return out
    with torch.cuda.device(x.device):
        launch, tile = _kernel()
        tiles, n_carry, n_sync = scratch_shapes(lanes, t_len, b.shape[0], tile)
        if lanes * tiles >= 1 << 31:
            raise ValueError(f"At most 2^31 - 1 blocks of {tile} samples per call, got {lanes} lanes x {tiles}")
        # freed on return while the kernel may run: the caching allocator gives their memory only to work queued
        # after it on this stream
        carry = torch.empty(n_carry, dtype=torch.float64, device=x.device)
        sync = torch.zeros(n_sync, dtype=torch.int32, device=x.device)
        err = launch(
            x.data_ptr(), b.data_ptr(), a.data_ptr(), out.data_ptr(), carry.data_ptr(), sync.data_ptr(), lanes, t_len,
            tiles, b.shape[0], int(clamp), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"biquad_cascade kernel launch failed with CUDA error {err}")
    global launches, captured
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out
