#!/usr/bin/env python3
"""Device time per launch of the port's two scan kernels, for A/B runs.

    python3 tools/time_scans_torch.py [--src DIR]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), builds
its kernels, and times them on one CUDA card at the shapes a prefill of S
rows gives them, S = 131 (the smoke trace's prompt) and 2048: the SSD scan
with bf16 x/B/C at mamba2-370m's widths (nh 32, hd 64, ns 128) and the
fresh cache's zero state, and the RG-LRU scan in f32 at recurrentgemma-2b's
width (B 1, W 2560) with a zero h0.  Each is timed on the profiler's
device clock (``chip_smoke.profiled_ms``) and by CUDA events around 50
back-to-back calls (``chip_smoke.time_ms``).  Only the wrappers' common
interface is called, so the checkout of an earlier commit is timed the same
way: run it once per tree, alternating the trees on one card.

Prints one JSON line: the card's ``nvidia-smi`` name and power limit, the
source directory, and per kernel and S the two times in milliseconds.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = (131, 2048)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="directory that holds the repro_torch package")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_scans_torch: no CUDA device is available",
              file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    if not Path(ssd_ops.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch was imported from "
                           f"{ssd_ops.__file__}, not from {src}")
    _build.build_all()

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(98)
    out = {"nvidia_smi": cs.nvidia_smi(), "src": str(src), "ssd_scan": {},
           "rglru_scan": {}}
    for S in LENGTHS:
        ssd = cs.ssd_inputs(gen, dev, torch.bfloat16, 1, S, 32, 64, 128)
        h0 = torch.zeros((1, 32, 64, 128), device=dev)
        a, bx = cs.rglru_inputs(gen, dev, 1, S, 2560)
        r0 = torch.zeros((1, 2560), device=dev)
        for name, fn in (
                ("ssd_scan", lambda: ssd_ops.ssd_scan(*ssd, init_state=h0)),
                ("rglru_scan", lambda: rglru_ops.rglru_scan(a, bx, r0))):
            out[name][str(S)] = {"device_ms": cs.profiled_ms(fn),
                                 "events_ms": cs.time_ms(fn)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
