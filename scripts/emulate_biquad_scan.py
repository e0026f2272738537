#!/usr/bin/env python3
"""Emulate the ``biquad_cascade`` kernel's chunked scan on the CPU (numpy) and
measure its error against the float64 reference, beside the plain loop's.

The emulation follows the kernel's arithmetic, not its thread layout: per
stage, each chunk of K samples runs from state zero in float32 (the plain
loop's order of operations) to its end state e; the chunks' maps
``s -> M s + e`` (M = A^K) are composed along T in order, in float64 or,
with ``--carry float32``, in float32 (M and its products rounded to
float32 too); each chunk then runs again in float32 from its start state
cast to float32, and its output (clipped with ``clamp``) feeds the next
stage. The inputs are SRMR's at 16 kHz (``chip_smoke.biquad_call_inputs``'
recipe on the host): one utterance's 23 gammatone lanes (4 stages,
clipped), and the 8 modulation lanes of each of 3 envelopes (1 stage).
It prints, for each bank, ``rel`` (the worst lane's max abs error over its
peak, ``ops.biquad.relative_error``) of the plain float32 loop and of the
scan::

    python3 scripts/emulate_biquad_scan.py --t 128000 --chunk 16 --carry float64
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def matpow(a: np.ndarray, n: int) -> np.ndarray:
    out = np.broadcast_to(np.eye(2, dtype=a.dtype), a.shape).copy()
    base = a.copy()
    while n:
        if n & 1:
            out = out @ base
        base = base @ base
        n >>= 1
    return out


def chunk_pass(h, s0, s1, c):
    """K float32 steps of a stage over the last axis of ``h`` from states ``s0, s1``: ``(y, s0, s1)``."""
    b0, b1, b2, a1, a2 = c
    ys = np.empty_like(h)
    for k in range(h.shape[-1]):
        x = h[..., k]
        y = (b0 * x + s0).astype(np.float32)
        n0 = ((b1 * x - a1 * y).astype(np.float32) + s1).astype(np.float32)
        s1 = (b2 * x - a2 * y).astype(np.float32)
        s0 = n0
        ys[..., k] = y
    return ys, s0, s1


def scan(x: np.ndarray, b: np.ndarray, a: np.ndarray, clamp: bool, chunk: int, carry) -> np.ndarray:
    lanes, t_len = x.shape
    n = -(-t_len // chunk)
    h = np.zeros((lanes, n * chunk), np.float32)
    h[:, :t_len] = x
    h = h.reshape(lanes, n, chunk)
    for i in range(b.shape[0]):
        c = tuple(v[:, None] for v in (b[i, :, 0], b[i, :, 1], b[i, :, 2], a[i, :, 1], a[i, :, 2]))
        zero = np.zeros((lanes, n), np.float32)
        _, e0, e1 = chunk_pass(h, zero, zero, c)
        e = np.stack([e0, e1], -1).astype(carry)
        step = np.zeros((lanes, 2, 2), carry)
        step[:, 0, 0], step[:, 0, 1], step[:, 1, 0] = -a[i, :, 1], 1.0, -a[i, :, 2]
        m = matpow(step, chunk)
        start = np.zeros_like(e)
        state = np.zeros((lanes, 2), carry)
        for j in range(n):
            start[:, j] = state
            state = (np.einsum("lij,lj->li", m, state) + e[:, j]).astype(carry)
        start = start.astype(np.float32)
        ys, _, _ = chunk_pass(h, start[..., 0], start[..., 1], c)
        h = np.clip(ys, -1.0, 1.0) if clamp else ys
    return h.reshape(lanes, -1)[:, :t_len]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--t", type=int, default=128_000, help="samples a lane (16 kHz)")
    parser.add_argument("--chunk", type=int, default=16, help="K: samples a chunk")
    parser.add_argument("--carry", choices=("float64", "float32"), default="float64")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from tpumetrics_torch.functional.audio import srmr
    from tpumetrics_torch.ops import biquad

    const = srmr._constants(16000, 23, 125.0, 4.0, 128.0, torch.device("cpu"))
    rng = np.random.default_rng(args.seed)
    banks = {
        "gammatone": (np.repeat(rng.uniform(-1, 1, (1, args.t)), 23, axis=0), const["as_"], const["bs"], True),
        "modulation": (np.repeat(np.abs(rng.standard_normal((3, 1, args.t))) * 1e-3, 8, axis=1).reshape(24, args.t),
                       const["mb"].repeat(3, 1)[None], const["ma"].repeat(3, 1)[None], False),
    }
    for kind, (x, b, a, clamp) in banks.items():
        x = torch.from_numpy(x.astype(np.float32))
        bn, an = (v.numpy() for v in biquad._normalized(x, b, a))
        ref = biquad.biquad_cascade_reference(x, b, a, clamp)
        plain = biquad.biquad_cascade_plain(x, b, a, clamp)
        got = scan(x.numpy(), bn, an, clamp, args.chunk, np.dtype(args.carry))
        print(f"{kind} {tuple(x.shape)}, K={args.chunk}, {args.carry} carries: rel plain loop"
              f" {biquad.relative_error(plain, ref):.3e}, scan {biquad.relative_error(torch.from_numpy(got), ref):.3e}",
              flush=True)


if __name__ == "__main__":
    main()
