#!/usr/bin/env python3
"""Time the CUDA ``binned_confusion`` kernel of one tree of the port on one card.

Two versions of the kernel are compared by running this script once for
each tree, in turns, in one session on one card; for a parent and a change::

    python3 scripts/time_binned_confusion.py --tree _archive/parent --label parent
    python3 scripts/time_binned_confusion.py --label change

``--tree`` is a checkout whose ``tpumetrics_torch`` is imported and built
(default: the checkout that holds this script). Whatever the tree, the
timing is this checkout's ``chip_smoke.cuda_ms`` on the same seeded inputs,
so both sides are measured the same way. At each shape it prints one JSON
line: the median of 30 calls between CUDA events with the L2 flushed and
the device kept ahead of the host before each (the device's time, the
host's launch cost left out), the median host time to make the call, the
flush's own device time (which the host time must stay below), and the
device time per call of each kernel the call launched, as ``torch.profiler``
reads it over 10 further calls.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(8192, 1000, 200), (8192, 128, 64)]  # main path; bench headline


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="checkout whose tpumetrics_torch is timed")
    parser.add_argument("--label", default="change")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, l2_flush  # this checkout's timing, whatever the tree

    sys.path.insert(0, str(Path(args.tree).resolve()))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import tpumetrics_torch
    from tpumetrics_torch.ops import binned_confusion as bc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsum must count exactly
    dev = torch.device("cuda")
    flush = l2_flush(torch)
    flush_ms, _ = cuda_ms(torch, flush, reps=10, ahead=flush)
    for n, c, t in SHAPES:
        rng = np.random.default_rng(0)
        preds = rng.random((n, c), dtype=np.float32)
        valid = (rng.random((n, c)) < 0.9).astype(np.float32)
        y = rng.integers(0, 2, (n, c)).astype(np.float32) * valid
        thr = np.linspace(0, 1, t, dtype=np.float32)
        inputs = [torch.from_numpy(x).to(dev) for x in (preds, y, valid, thr)]
        call = lambda: bc.binned_confusion_counts(*inputs)  # noqa: E731
        tp, pp = call()
        ref_tp, ref_pp = bc.binned_confusion_plain(*inputs)
        if not (torch.equal(tp.float(), ref_tp) and torch.equal(pp.float(), ref_pp)):
            sys.exit(f"{args.label}: kernel != plain version at {n}x{c}x{t}")
        ms, host_ms = cuda_ms(torch, call, reps=30, ahead=flush)
        calls = 10
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush()
                call()
            torch.cuda.synchronize()
        kernels = {
            e.key: e.device_time_total / calls
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0 and "bitwise_not" not in e.key
        }
        print(json.dumps({
            "label": args.label, "package": str(Path(tpumetrics_torch.__file__).parent), "card": smi,
            "shape": [n, c, t], "ms": ms, "host_ms": host_ms, "flush_ms": flush_ms,
            "profiler_us_per_call": sum(kernels.values()), "profiler_kernels_us": kernels,
        }), flush=True)


if __name__ == "__main__":
    main()
