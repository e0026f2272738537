#!/usr/bin/env python3
"""Time the multiclass confusion count of the port on one card, three ways.

The count behind multiclass accuracy, F1 and the confusion matrix is an
int32 histogram of ``target * C + pred`` over a batch (``_masked_confmat``).
This script times, on the same seeded labels at the bench headline shape
(8192 samples, C=128) and the ImageNet-1k shape (8192, C=1000):

- ``index_add``: the port's count, an int32 ``index_add_`` of ones into a
  fixed ``(C * C + 1,)`` buffer (no host read);
- ``scatter_add``: the same with ``scatter_add_``;
- ``bincount``: CUDA ``torch.bincount`` with ``minlength``, cast to int32
  (what the port used before; it reads the input's maximum on the host).

Each is checked equal to the others, then timed over 50 calls in turns:
the host clock from the call to the end of ``torch.cuda.synchronize()``,
and the device time between CUDA events with the device kept busy ahead of
the call, so the host's launch cost is left out. One JSON line per shape
and way gives the medians::

    python3 scripts/time_confmat_count.py
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

SHAPES = [(8192, 128), (8192, 1000)]
REPS = 50


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_confmat_count.py needs a CUDA card")

    def index_add(idx, m):
        counts = torch.zeros((m + 1,), dtype=torch.int32, device=idx.device)
        return counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))[:m]

    def scatter_add(idx, m):
        counts = torch.zeros((m + 1,), dtype=torch.int32, device=idx.device)
        return counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))[:m]

    def bincount(idx, m):
        return torch.bincount(idx, minlength=m + 1)[:m].to(torch.int32)

    ways = {"index_add": index_add, "scatter_add": scatter_add, "bincount": bincount}
    busy = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for n, c in SHAPES:
        rng = np.random.default_rng(0)
        target = torch.from_numpy(rng.integers(0, c, n)).cuda()
        preds = torch.from_numpy(rng.integers(0, c, n)).cuda()
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        m = c * c
        idx = torch.where(valid, target * c + preds, m)
        ref = bincount(idx, m)
        for name, fn in ways.items():
            if not torch.equal(fn(idx, m), ref):
                sys.exit(f"{name} differs from bincount at {n}x{c}")
        host = {name: [] for name in ways}
        device = {name: [] for name in ways}
        for i in range(REPS):
            for name, fn in ways.items() if i % 2 == 0 else reversed(list(ways.items())):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(idx, m)
                torch.cuda.synchronize()
                host[name].append((time.perf_counter() - t0) * 1e3)
                busy.bitwise_not_()  # keeps the device ahead of the host's launches
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn(idx, m)
                end.record()
                end.synchronize()
                device[name].append(start.elapsed_time(end))
        for name in ways:
            print(json.dumps({
                "shape": [n, c], "way": name, "host_ms": float(np.median(host[name])),
                "device_ms": float(np.median(device[name])), "device": torch.cuda.get_device_name(0),
            }), flush=True)


if __name__ == "__main__":
    main()
