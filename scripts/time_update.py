#!/usr/bin/env python3
"""Time one collection update of a tree of the port on one card, host clock.

Two trees are compared by running this script once for each, in turns, on
one card; for a parent and a change::

    python3 scripts/time_update.py --tree _archive/parent --label parent
    python3 scripts/time_update.py --label change --fused

``--tree`` is a checkout whose ``tpumetrics_torch`` is imported and built
(default: the checkout that holds this script). The collection is BASELINE
config #2's metric set (micro accuracy, macro F1, binned AUROC, with
``validate_args=False``) at the bench headline shape (8192 x 128, T=64) and
at the ImageNet-1k shape (8192 x 1000, T=200). After 5 warm updates, each
timed update runs from the call to the end of ``torch.cuda.synchronize()``
on seeded probabilities; one JSON line per shape gives the median, the
quartiles and every time of 30 updates. With ``--fused`` the same runs
again with ``fused_update=True`` (the tree must have it), the two modes
updating in turns.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(8192, 128, 64), (8192, 1000, 200)]  # bench headline; ImageNet-1k
WARM, TIMED = 5, 30


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="checkout whose tpumetrics_torch is timed")
    parser.add_argument("--label", default="change")
    parser.add_argument("--fused", action="store_true", help="also time fused_update=True, in turns")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_update.py needs a CUDA card")
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score

    modes = [False, True] if args.fused else [False]
    for n, c, t in SHAPES:
        rng = np.random.default_rng(0)
        z = rng.random((n, c), dtype=np.float32)
        preds = torch.from_numpy(z / z.sum(axis=1, keepdims=True)).cuda()
        target = torch.from_numpy(rng.integers(0, c, n)).cuda()
        cols = {}
        for fused in modes:
            kw = {"fused_update": True} if fused else {}
            cols[fused] = MetricCollection(
                {
                    "acc": MulticlassAccuracy(c, average="micro", validate_args=False),
                    "f1": MulticlassF1Score(c, average="macro", validate_args=False),
                    "auroc": MulticlassAUROC(c, thresholds=t, validate_args=False),
                },
                **kw,
            )
        times = {fused: [] for fused in modes}
        for i in range(WARM + TIMED):
            for fused in modes if i % 2 == 0 else modes[::-1]:
                t0 = time.perf_counter()
                cols[fused].update(preds, target)
                torch.cuda.synchronize()
                if i >= WARM:
                    times[fused].append((time.perf_counter() - t0) * 1e3)
        for fused in modes:
            q1, med, q3 = np.percentile(times[fused], [25, 50, 75])
            print(json.dumps({
                "label": args.label, "fused_update": fused, "shape": [n, c, t], "median_ms": float(med),
                "q1_ms": float(q1), "q3_ms": float(q3), "ms": times[fused],
                "device": torch.cuda.get_device_name(0),
            }), flush=True)


if __name__ == "__main__":
    main()
