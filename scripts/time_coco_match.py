#!/usr/bin/env python3
"""Time the CUDA ``coco_greedy_match`` kernel of one tree of the port on one card.

Two versions of the kernel are compared by running this script once for
each tree, in turns, in one run on one card; for a parent and a change::

    python3 scripts/time_coco_match.py --tree _archive/parent --label parent
    python3 scripts/time_coco_match.py --label change

``--tree`` is a checkout whose ``tpumetrics_torch`` is imported and built
(default: the checkout that holds this script). The call timed is the one
``chip_smoke.py``'s detection phase times: every cell of the macro
evaluation of the COCO val2017-size stream (``chip_smoke.coco_stream()``,
5,000 images, made from the seed), recorded from that tree's
``coco_evaluate_rows`` on the card. Whatever the tree, the timing is this
checkout's ``chip_smoke.cuda_ms``: the median of ``--reps`` calls between
CUDA events with the L2 flushed before each, and the median host time to
make the call. It also prints the device time per call of each kernel the
call launched, as ``torch.profiler`` reads it over 10 further calls, and
holds the kernel bit for bit against the tree's plain version. One JSON
line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def stream_call(torch, device: str = "cuda") -> tuple:
    """The matcher's arguments at the stream's macro evaluation, recorded on ``device``."""
    from chip_smoke import COCO_IMAGES, coco_flat, coco_stream
    from tpumetrics_torch.detection import MeanAveragePrecision
    from tpumetrics_torch.detection import _coco_eval_device as dev_eval

    preds, target = coco_stream()
    flat = coco_flat(preds, target)
    on = {k: torch.as_tensor(v, device=device) for k, v in flat.items() if not k.endswith("count")}
    dc, gc = flat["d_count"].tolist(), flat["g_count"].tolist()
    d_views = {k: on[f"d_{k}"].split(dc) for k in ("boxes", "scores", "labels")}
    g_views = {k: on[f"g_{k}"].split(gc) for k in ("boxes", "labels", "crowd", "area")}
    preds_dev = [{k: d_views[k][i] for k in d_views} for i in range(COCO_IMAGES)]
    target_dev = [{"boxes": g_views["boxes"][i], "labels": g_views["labels"][i], "iscrowd": g_views["crowd"][i],
                   "area": g_views["area"][i]} for i in range(COCO_IMAGES)]
    m = MeanAveragePrecision(device=device)
    for lo in range(0, COCO_IMAGES, 500):
        m.update(preds_dev[lo : lo + 500], target_dev[lo : lo + 500])
    det, gt, n_imgs, _, _ = m._gather_rows()
    rows = ((m._convert_boxes(det["boxes"]), det["scores"], det["labels"], det["img"]),
            (m._convert_boxes(gt["boxes"]), gt["labels"], gt["crowds"], gt["area"].double(), gt["img"]))
    classes = torch.unique(torch.cat([det["labels"], gt["labels"]])).tolist()
    match, calls = dev_eval.coco_greedy_match, []

    def recording(*args):
        calls.append(args)
        return match(*args)

    dev_eval.coco_greedy_match = recording
    try:
        dev_eval.coco_evaluate_rows(rows[0], rows[1], n_imgs, m.iou_thresholds, m.rec_thresholds,
                                    m.max_detection_thresholds, classes, average="macro", arrays=True)
    finally:
        dev_eval.coco_greedy_match = match
    return calls[0]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="checkout whose tpumetrics_torch is timed")
    parser.add_argument("--label", default="change")
    parser.add_argument("--reps", type=int, default=30)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import coco_match_bound, cuda_ms, l2_flush  # this checkout's timing, whatever the tree

    sys.path.insert(0, str(Path(args.tree).resolve()))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import tpumetrics_torch
    from tpumetrics_torch.ops import coco_match as cm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    call_args = stream_call(torch)
    call = lambda: cm.coco_greedy_match(*call_args)  # noqa: E731
    m, ig = call()
    pm, pig = cm.coco_greedy_match_plain(*call_args)
    if not (torch.equal(m, pm) and torch.equal(ig, pig)):
        sys.exit(f"{args.label}: kernel != plain version at the stream's call")
    flush = l2_flush(torch)
    flush_ms, _ = cuda_ms(torch, flush, reps=10, ahead=flush)
    ms, host_ms = cuda_ms(torch, call, reps=args.reps, ahead=flush)
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
    bound = coco_match_bound(call_args)
    print(json.dumps({
        "label": args.label, "package": str(Path(tpumetrics_torch.__file__).parent), "card": smi,
        "cells": bound["cells"], "launch": getattr(cm, "last_launch", None), "ms": ms, "host_ms": host_ms, "flush_ms": flush_ms, "bound_ms": bound["bound_ms"],
        "profiler_us_per_call": sum(kernels.values()), "profiler_kernels_us": kernels,
    }), flush=True)


if __name__ == "__main__":
    main()
