#!/usr/bin/env python3
"""Time variants of the ``coco_greedy_match`` kernel on one card, in turns.

Each variant is a copy of ``tpumetrics_torch/csrc/coco_greedy_match.cu``
with some of its ``constexpr int`` constants set to other values, or the
walks launched after the default rows instead of beside them
(``VARIANTS``; the first is the source as it is). Each is built with the
port's ``nvcc`` flags into a temporary directory and called as
``ops/coco_match.py`` calls the kernel, at the COCO val2017-size stream's
call (``scripts/time_coco_match.py``'s ``stream_call``). For each variant it
prints ptxas's registers and spills, whether its outputs are bit for bit the
plain version's, and the median device time of a call in three rounds of 10
(events, L2 flushed; the rounds alternate the variants' order)::

    python3 scripts/time_coco_match_variants.py
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SERIAL = ("programmaticStreamSerializationAllowed = 1;", "programmaticStreamSerializationAllowed = 0;")
VARIANTS = {  # name: {constant: value}, or the launch attribute's line replaced
    "the source": {},
    "walks after the default rows": {SERIAL[0]: SERIAL[1]},
    "3 default-row blocks an SM": {"kRowBlocks": 3},
    "walk blocks: 3 an SM": {"kMinBlocks": 3},
    "128 buffered rewrites": {"kRewrites": 128},
}


def variant_source(src: str, subs: dict) -> str:
    for old, new in subs.items():
        if isinstance(new, int):
            src, hits = re.subn(rf"(constexpr int {old} = )\d+;", rf"\g<1>{new};", src)
        else:
            hits = src.count(old)
            src = src.replace(old, new)
        if hits != 1:
            raise SystemExit(f"{old!r} is in the source {hits} times, not once")
    return src


def build(tmp: str, nvcc: str, flags) -> dict:
    src = (ROOT / "tpumetrics_torch" / "csrc" / "coco_greedy_match.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        cu, so = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        Path(cu).write_text(variant_source(src, subs))
        procs[name] = (so, subprocess.Popen([nvcc, *flags, "-o", so, cu], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} did not build:\n{out}")
        props = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used (\d+) registers", out)
        print(f"build: {name}: " + "; ".join(f"{r} registers, {s} B spill stores, {l} B spill loads"
                                             for s, l, r in props), flush=True)
        fn = ctypes.CDLL(so).coco_greedy_match
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import cuda_ms, l2_flush
    from time_coco_match import stream_call
    from tpumetrics_torch.ops import _build
    from tpumetrics_torch.ops import coco_match as cm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    args = stream_call(torch)
    want = cm.coco_greedy_match_plain(*args)
    nd, n, num_areas, num_thrs = args[0].shape[0], args[4].shape[0], args[6].shape[0], args[5].numel()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, _build._nvcc(), _build.NVCC_FLAGS)
        out = {name: (torch.empty((nd, num_areas, num_thrs), dtype=torch.uint8, device="cuda"),
                      torch.empty((nd, num_areas, num_thrs), dtype=torch.uint8, device="cuda")) for name in libs}
        blocks = (ctypes.c_int * 3)()
        counters = torch.zeros(cm._plan(num_areas, num_thrs)["counters"], dtype=torch.int64, device="cuda")
        lists = torch.empty((3, n, 4), dtype=torch.int32, device="cuda")

        def call(name):
            m, ig = out[name]
            counters.zero_()
            err = libs[name](*(a.data_ptr() for a in args), m.data_ptr(), ig.data_ptr(), counters.data_ptr(),
                             lists.data_ptr(), nd, n, num_areas, num_thrs,
                             torch.cuda.current_stream().cuda_stream, ctypes.addressof(blocks))
            if err:
                raise SystemExit(f"{name}: launch failed with CUDA error {err}")

        flush = l2_flush(torch)
        for name in libs:
            call(name)
            torch.cuda.synchronize()
            same = torch.equal(out[name][0], want[0]) and torch.equal(out[name][1], want[1])
            print(f"{name}: bit for bit the plain version: {same}", flush=True)
        times = {name: [] for name in libs}
        for rnd in range(3):
            for name in list(libs)[:: 1 if rnd % 2 == 0 else -1]:
                times[name].append(cuda_ms(torch, lambda: call(name), 10, flush)[0])
        for name in libs:
            print(json.dumps({"variant": name, "card": smi, "ms": float(np.median(times[name])),
                              "rounds_ms": times[name]}), flush=True)


if __name__ == "__main__":
    main()
