#!/usr/bin/env python3
"""Where the SSD-scan kernel's bf16 body spends its time, on one CUDA card.

    python3 tools/ssd_ablation_torch.py

Builds copies of ``src/repro_torch/kernels/ssd_scan/ssd_scan.cu`` in which
one part of the tensor-core body's chunk loop is switched off (by replacing
the line that guards it), loads each with ``ctypes`` and times one launch at
mamba2-370m's widths (bf16 x/B/C, nh 32, hd 64, ns 128, zero initial state)
for S = 131 and 2048 rows on the profiler's device clock
(``chip_smoke.profiled_ms``).  The copies compute wrong results: their times
only say how much each part adds to a launch.  A variant whose line is not
in the source is reported and skipped.

Variants: ``base`` (the kernel as it is); ``no_m_blocks`` (no warp builds
its block of M); ``no_y`` (the y warps compute nothing); ``no_update`` (the
state warps add nothing to h); ``no_prefetch`` (the next chunk's tiles are
not loaded); ``skeleton`` (the first three off: what is left is the
barriers, the tile loads, the scans and the splits of h and w x).

Prints one JSON line: the card's name and power limit and, per variant,
the milliseconds per launch at each S.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "ssd_scan" / "ssd_scan.cu"
OUT = ROOT / "build" / "ablation"
LENGTHS = (131, 2048)
M_BLOCKS = ("    if (has_block) {\n      const bf16* crow",
            "    if (false) {\n      const bf16* crow")
Y = ("      if (mi < row_tiles && pt * 8 < HP) {", "      if (false) {")
UPDATE = ("if (kj < row_tiles)", "if (false)")
PREFETCH = ("    if (c + 1 < n_chunks) load_chunk(c0 + kTL, st ^ 1);", "")
VARIANTS = {
    "base": [],
    "no_m_blocks": [M_BLOCKS],
    "no_y": [Y],
    "no_update": [UPDATE],
    "no_prefetch": [PREFETCH],
    "skeleton": [M_BLOCKS, Y, UPDATE],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_ablation_torch: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    source = SOURCE.read_text()
    procs, skipped = {}, {}
    for name, subs in VARIANTS.items():
        text = source
        missing = [old for old, _ in subs if old not in text]
        if missing:
            skipped[name] = f"line not found: {missing[0]!r}"
            continue
        for old, new in subs:
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
               str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in list(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode:
            skipped[name] = "nvcc failed: " + log[-2000:]
            del procs[name]

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(98)
    nh, hd, ns = 32, 64, 128
    times = {name: {} for name in procs}
    for S in LENGTHS:
        xs, dt, A, Bm, Cm, D = cs.ssd_inputs(gen, dev, torch.bfloat16, 1, S,
                                             nh, hd, ns)
        h0 = torch.zeros((1, nh, hd, ns), device=dev)
        y = torch.empty((1, S, nh, hd), device=dev)
        state = torch.empty((1, nh, hd, ns), device=dev)
        ptrs = [t.data_ptr() for t in (xs, dt, A, Bm, Cm, D, h0, y, state)]
        for name in procs:
            fn = ctypes.CDLL(str(OUT / f"{name}.so")).ssd_scan_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])

            def launch(fn=fn):
                err = fn(*ptrs, 1, S, nh, hd, ns, 1,
                         torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            times[name][str(S)] = cs.profiled_ms(launch)
    print(json.dumps({"nvidia_smi": cs.nvidia_smi(), "device_ms": times,
                      "skipped": skipped}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
