#!/usr/bin/env python3
"""Which device kernels does ``torch.profiler`` record in one SRMR update?

SRMR at 16 kHz over one batch of 8 utterances of 8 s (the ``chip_smoke.py``
SRMR stream's batch) is profiled four ways, three times each: (a) a
collection update right after the profiler starts, as ``chip_smoke.py``'s
``profile_step`` does; (b) the functional call the same way; (c) a
collection update after a small kernel and a synchronize inside the
profiled region; (d) a collection update in the active step of a profiler
``schedule`` after a warm-up step. For each it prints the device events
recorded, their span, the first event's start after the profiler's first
CPU event, and the ``biquad_cascade`` kernels seen (the gammatone and the
modulation bank's, one each an update). Then it lists the device launches
of one ``biquad_cascade`` call of each bank::

    python3 scripts/probe_profiler.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke
    from tpumetrics_torch import MetricCollection
    from tpumetrics_torch.ops import biquad as bq
    from tpumetrics_torch.audio import SpeechReverberationModulationEnergyRatio as SRMR
    from tpumetrics_torch.functional.audio import speech_reverberation_modulation_energy_ratio as srmr_fn

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _, reverb = chip_smoke.make_utterances(chip_smoke.SEED + 11)
    batch = torch.from_numpy(reverb[: chip_smoke.SRMR_BATCH]).cuda()
    col = MetricCollection({"srmr": SRMR(chip_smoke.SRMR_FS, device="cuda")}, device="cuda")

    def report(how, events):
        dev = sorted((e for e in events if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
        cpu = [e.time_range.start for e in events if e.device_type == DeviceType.CPU]
        iir = [e.name.split("biquad_cascade_kernel")[1].split("(")[0] for e in dev if "biquad_cascade_kernel" in e.name]
        span = (dev[-1].time_range.end - dev[0].time_range.start) / 1e3 if dev else 0.0
        first = (dev[0].time_range.start - min(cpu)) / 1e3 if dev and cpu else float("nan")
        print(f"{how}: {len(dev)} device events over {span:.3f} ms, the first {first:.3f} ms after the first CPU event;"
              f" biquad_cascade kernels {iir}; first device event {dev[0].name[:60] if dev else None}", flush=True)

    def update():
        col.update(batch)
        torch.cuda.synchronize()

    for _ in range(3):
        update()
        with profile(activities=acts) as prof:
            update()
        report("(a) collection update", prof.events())
        update()
        with profile(activities=acts) as prof:
            srmr_fn(batch, chip_smoke.SRMR_FS)
            torch.cuda.synchronize()
        report("(b) functional call", prof.events())
        update()
        with profile(activities=acts) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            update()
        report("(c) a kernel and a sync first", prof.events())
        update()
        seen = []
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: seen.append(list(p.events()))) as prof:
            for _ in range(2):
                update()
                prof.step()
        report("(d) after a warm-up step", seen[0] if seen else [])
    for kind in ("gammatone", "modulation"):
        x, b, a, clamp = chip_smoke.biquad_call_inputs(torch, kind, chip_smoke.SRMR_BATCH, chip_smoke.SRMR_T, 0)
        bq.biquad_cascade(x, b, a, clamp)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            bq.biquad_cascade(x, b, a, clamp)
            torch.cuda.synchronize()
        dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
        print(f"one {kind} call: {len(dev)} device launches: " + "; ".join(e.name[:70] for e in dev), flush=True)


if __name__ == "__main__":
    main()
