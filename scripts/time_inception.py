#!/usr/bin/env python3
"""Time the FID InceptionV3 forward on one card, and say where its time goes.

At the CIFAR-10 stream's batch in ``chip_smoke.py`` (256 uint8 32 x 32
images, resized to 299 x 299; ``random_inception_params``), the 2048-d tap
through ``inception_v3_features`` as the library runs it (every convolution
in full float32), between CUDA events (``chip_smoke.cuda_ms``, no L2 flush:
a batch's activations are some GB), median of 5 calls, four ways in turns:

- ``float32``: the library's forward, cuDNN's heuristics choosing each
  convolution's algorithm (``cudnn.benchmark`` off, torch's default);
- ``float32, cudnn.benchmark``: the same with cuDNN timing its candidates
  on the first call of each shape (a process-wide setting the library does
  not change);
- ``bfloat16``: the weights cast once, float input (the tensor cores);
- ``tf32``: the float32 forward with its full-float32 guard taken out and
  ``cudnn.allow_tf32`` on (what the guard prevents; the features it gives are
  not the metric's).

Then one float32 forward under ``torch.profiler``: the device union and the
kernels that take most, grouped by name. Each line is JSON with the card's
name and power limit and the bound (5.7 G multiply-adds an image at 67
TFLOP/s, float32 outside the tensor cores). Run from the repository root::

    python3 scripts/time_inception.py
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BATCH = 256
MACS_PER_IMAGE = 5.71e9  # InceptionV3 at 299 x 299 to the pool before the logits


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from tpumetrics_torch.image import _inception

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    params = _inception.random_inception_params(cs.SEED)
    p32 = {k: torch.from_numpy(v).cuda() for k, v in params.items()}
    p16 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    imgs = cs.cifar_images(torch, 0, BATCH)
    floats = imgs.float()
    f32 = _inception.inception_v3_features(p32, ("2048",))
    f16 = _inception.inception_v3_features(p16, ("2048",))
    unguarded = mock.patch.object(_inception, "_ieee_float32", lambda *b: contextlib.nullcontext())

    def bench(**flags):
        @contextlib.contextmanager
        def ctx():
            saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
            for k, v in flags.items():
                setattr(torch.backends.cudnn, k, v)
            try:
                yield
            finally:
                for k, v in saved.items():
                    setattr(torch.backends.cudnn, k, v)
        return ctx

    ways = {
        "float32": (lambda: f32(imgs), bench(benchmark=False, allow_tf32=False)),
        "float32, cudnn.benchmark": (lambda: f32(imgs), bench(benchmark=True, allow_tf32=False)),
        "bfloat16": (lambda: f16(floats.to(torch.bfloat16)), bench(benchmark=False)),
        "tf32": (lambda: f32(imgs), bench(benchmark=False, allow_tf32=True)),
    }
    times = {name: [] for name in ways}
    for _ in range(2):
        for name, (fn, flags) in ways.items():
            with flags(), (unguarded if name == "tf32" else contextlib.nullcontext()):
                ms, host = cs.cuda_ms(torch, fn, 5, lambda: None)
            times[name].append(ms)
    bound_ms = BATCH * MACS_PER_IMAGE * 2 / cs.H100_FP32_OPS_PER_S * 1e3
    for name, ms in times.items():
        best = min(ms)
        print(json.dumps({"card": card, "way": name, "batch": BATCH, "ms": ms, "images_per_s": BATCH / best * 1e3,
                          "bound_ms_fp32": bound_ms, "times_bound": best / bound_ms}), flush=True)

    with bench(benchmark=False, allow_tf32=False)():
        f32(imgs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            f32(imgs)
            torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
    union_ms = cs.busy_union_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
                     key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in kernels)
    conv = sum(e.device_time_total for e in kernels if any(
        s in e.key.lower() for s in ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop", "sgemm", "gemm")))
    print(json.dumps({"card": card, "profile": "float32 forward", "union_ms": union_ms, "kernel_ms": total / 1e3,
                      "conv_and_gemm_share": conv / total if total else 0.0,
                      "top": [(e.key[:80], e.count, round(e.device_time_total / 1e3, 3)) for e in kernels[:12]]}),
          flush=True)


if __name__ == "__main__":
    main()
