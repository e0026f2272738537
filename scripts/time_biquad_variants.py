#!/usr/bin/env python3
"""Time variants of the ``biquad_cascade`` scan kernel on one card, in turns.

Each variant is a copy of ``tpumetrics_torch/csrc/biquad_cascade.cu`` with
some of its constants or lines replaced (``VARIANTS``; the first is the
source as it is), built with the port's ``nvcc`` flags into a temporary
directory and called as ``ops/biquad.py`` calls the kernel. At SRMR's two
full shapes (the gammatone bank, 184 lanes x 128,000 x 4 stages; the
modulation bank, 1,472 x 128,000 x 1; ``chip_smoke.biquad_call_inputs``)
it prints, for each variant: ptxas's registers and spills, the device time
of a call in three rounds of 10 (events, L2 flushed; the rounds alternate
the variants' order), a one-lane call at the full T, ``rel`` against the
float64 reference, and whether two calls give the same bits::

    python3 scripts/time_biquad_variants.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LB = "__launch_bounds__(kThreads, 4)"
VARIANTS = {
    "K16 x 256 threads, 4 blocks/SM (the source)": {},
    "K16 x 256, 3 blocks/SM": {LB: "__launch_bounds__(kThreads, 3)"},
    "K16 x 256, 2 blocks/SM": {LB: "__launch_bounds__(kThreads, 2)"},
    "K32 x 256, 2 blocks/SM": {"kChunk = 16;": "kChunk = 32;", LB: "__launch_bounds__(kThreads, 2)"},
    "K32 x 128, 3 blocks/SM": {"kChunk = 16;": "kChunk = 32;", "kThreads = 256;": "kThreads = 128;",
                               "kTilePower = 8;": "kTilePower = 7;", LB: "__launch_bounds__(kThreads, 3)"},
    "K16 x 256, 4 blocks/SM, zero-state pass in the plain loop's order": {
        "for (int n = 0; n < kChunk; ++n) zero_state_step(c, h[n], s0, s1);":
        "for (int n = 0; n < kChunk; ++n) step(c, h[n], s0, s1);"},
}


def build(tmp: str, nvcc: str, flags) -> dict:
    src = (ROOT / "tpumetrics_torch" / "csrc" / "biquad_cascade.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        Path(cu).write_text(text)
        procs[name] = (so, subprocess.Popen([nvcc, *flags, "-o", so, cu], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} did not build:\n{out}")
        print(f"build: {name}: " + "; ".join(
            line.split(":", 1)[-1].strip() for line in out.splitlines() if "registers" in line or "spill" in line), flush=True)
        lib = ctypes.CDLL(so)
        fn = lib.biquad_cascade
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (fn, lib.biquad_cascade_tile())
    return libs


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from tpumetrics_torch.ops import _build
    from tpumetrics_torch.ops import biquad as bq

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, _build._nvcc(), _build.NVCC_FLAGS)

        def call(name, x, b, a, clamp):
            fn, tile = libs[name]
            b, a = bq._normalized(x, b, a)
            lanes, t_len = x.shape
            out = torch.empty_like(x)
            tiles, n_carry, n_sync = bq.scratch_shapes(lanes, t_len, b.shape[0], tile)
            carry = torch.empty(n_carry, dtype=torch.float64, device=x.device)
            sync = torch.zeros(n_sync, dtype=torch.int32, device=x.device)
            err = fn(x.data_ptr(), b.data_ptr(), a.data_ptr(), out.data_ptr(), carry.data_ptr(), sync.data_ptr(), lanes,
                     t_len, tiles, b.shape[0], int(clamp), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return out

        flush = chip_smoke.l2_flush(torch)
        for kind in ("gammatone", "modulation"):
            x, b, a, clamp = chip_smoke.biquad_call_inputs(torch, kind, chip_smoke.SRMR_BATCH, chip_smoke.SRMR_T, 3)
            ref = bq.biquad_cascade_reference(x, b, a, clamp)
            times = {name: [] for name in VARIANTS}
            for rnd in range(3):
                for name in list(VARIANTS)[:: 1 if rnd % 2 == 0 else -1]:
                    times[name].append(chip_smoke.cuda_ms(torch, lambda: call(name, x, b, a, clamp), 10, flush)[0])
            for name in VARIANTS:
                got, again = call(name, x, b, a, clamp), call(name, x, b, a, clamp)
                one = chip_smoke.cuda_ms(torch, lambda: call(name, x[:1], b[:, :1], a[:, :1], clamp), 5, flush)[0]
                torch.cuda.synchronize()
                same = bool(torch.equal(got.view(torch.int32), again.view(torch.int32)))
                print(f"{kind} {tuple(x.shape)}: {name}: {', '.join(f'{t:.4f}' for t in times[name])} ms; one lane"
                      f" {one:.4f} ms; rel {bq.relative_error(got, ref):.3e}; two calls bit for bit {same}", flush=True)
            del x, ref


if __name__ == "__main__":
    main()
