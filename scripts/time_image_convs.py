#!/usr/bin/env python3
"""Time the image metrics' convolutions, and each member's update, on one card.

At the restoration stream's shape in ``chip_smoke.py`` (4 RGB images of
1356 x 2040), in full float32 as the library runs them, between CUDA events
with the L2 flushed (``chip_smoke.cuda_ms``), median of 10 calls:

- VIF's first-scale convolution (a 17 x 17 window) two ways: the channels
  folded into the batch, a single-channel convolution (``(12, 1, H, W)``),
  and the channels as depthwise groups (``(4, 3, H, W)``, ``groups=3``), the
  form ``functional/image/vif.py`` takes;
- SSIM's and UQI's one convolution of the 5-stacked moments (an 11 x 11
  window over ``(20, 3, H + 10, W + 10)``, ``groups=3``);
- one update of each member of the stream's RGB collection.

Each line is JSON with the card's name and power limit, and each
convolution's bound: the larger of its bytes (input read once, output
written once) over 3.35 TB/s and its direct multiply-adds over 67 TFLOP/s
(float32 outside the tensor cores). Run from the repository root::

    python3 scripts/time_image_convs.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from tpumetrics_torch.utils.compute import _ieee_float32

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    flush = cs.l2_flush(torch)
    b, c, h, w = cs.DIV2K_BATCH, 3, cs.DIV2K_H, cs.DIV2K_W
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x = torch.rand((b, c, h, w), device="cuda", generator=gen)
    stacked = torch.rand((5 * b, c, h + 10, w + 10), device="cuda", generator=gen)
    k17 = torch.rand((17, 17), device="cuda", generator=gen)
    k11 = torch.rand((11, 11), device="cuda", generator=gen)

    def ieee(fn):
        def run():
            with _ieee_float32(torch.backends.cudnn.conv, torch.backends.mkldnn.conv):
                return fn()
        return run

    def bound(inp, out, taps):
        bytes_ms = 4 * (inp.numel() + out.numel()) / cs.H100_BYTES_PER_S * 1e3
        ops_ms = 2 * out.numel() * taps / cs.H100_FP32_OPS_PER_S * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    cases = {
        "vif_scale0_folded": (x.reshape(b * c, 1, h, w), lambda: F.conv2d(x.reshape(b * c, 1, h, w), k17[None, None]), 289),
        "vif_scale0_grouped": (x, lambda: F.conv2d(x, k17.expand(c, 1, 17, 17).contiguous(), groups=c), 289),
        "ssim_moments_grouped": (stacked, lambda: F.conv2d(stacked, k11.expand(c, 1, 11, 11).contiguous(), groups=c), 121),
    }
    for name, (inp, fn, taps) in cases.items():
        fn = ieee(fn)
        out = fn()
        ms, host_ms = cs.cuda_ms(torch, fn, 10, flush)
        bound_ms, bound_by = bound(inp, out, taps)
        print(json.dumps({"case": name, "card": card, "ms": ms, "host_ms": host_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "shape": list(inp.shape)}), flush=True)
        del out

    p8 = (x * 255).round().to(torch.uint8).cpu().numpy()
    data = cs.image_batch(torch, p8, (p8 // 2 + 64).astype(p8.dtype), "cuda")
    for name, metric in cs.restoration_members("cuda")["rgb"].items():
        ms, host_ms = cs.cuda_ms(torch, lambda m=metric: m.update(*data["rgb"]), 10, flush)
        print(json.dumps({"case": f"update_{name}", "card": card, "ms": ms, "host_ms": host_ms,
                          "metric": type(metric).__name__}), flush=True)


if __name__ == "__main__":
    main()
