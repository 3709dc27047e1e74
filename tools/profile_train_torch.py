#!/usr/bin/env python3
"""Where a train step's time goes on one CUDA card, at the full-width
shapes of ``chip_smoke.py`` phase ``train``.

    python3 tools/profile_train_torch.py [--arch ARCH ...] [--steps N]

For each arch (default: the four of ``chip_smoke.TRAIN_RUNS``, at their
batch and sequence), full-depth bf16 parameters from seed 0 take three
warm-up steps of ``make_train_step`` (warmup-cosine at 3e-3, the
launcher's defaults), then N steps (default 3) split into their two
parts on the host clock, each ended by a synchronise: the gradient
(forward, recompute and backward through the plain layers) and the AdamW
update.  Then N more steps run under ``torch.profiler`` (CPU and
CUDA activities): device time per step by kernel, summed into the
categories matmul (cuBLAS and CUTLASS kernels), elementwise, reduction,
copy and other, kernel launches per step, and the device's busy share of
the profiled wall time.  No kernel of the port has a backward, so a train
step launches none of them; the line says so from the launch counters.

Prints one JSON line per arch, after the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MATMUL = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def _category(name: str) -> str:
    low = name.lower()
    if any(k in low for k in MATMUL):
        return "matmul"
    if "reduce" in low:
        return "reduction"
    if any(k in low for k in ("copy", "memset", "catarray")):
        return "copy"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def profile_arch(arch: str, batch: int, seq: int, steps: int, dev) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim import init_state, update, warmup_cosine
    from repro_torch.train import TrainStepConfig, make_train_step
    from repro_torch.tree import unflatten

    cfg = configs.get(arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, torch.bfloat16)
    opt = init_state(params)
    sched = warmup_cosine(3e-3, 2, 100)
    tcfg = TrainStepConfig()
    step_fn, loss_fn = make_train_step(cfg, sched, tcfg)
    batch_t = cs._device_batch(cfg, seq, batch, 0, dev)
    counters = cs.launch_counters()
    for fn in counters.values():
        fn.launches = 0
    for i in range(3):
        step_fn(params, opt, batch_t, i)
    torch.cuda.synchronize()

    grad_s, update_s = [], []
    for i in range(3, 3 + steps):
        t0 = time.perf_counter()
        loss, grads = cs._value_and_grad(loss_fn, params, batch_t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        update(params, unflatten(grads.items()), opt, sched(i), tcfg.adamw)
        torch.cuda.synchronize()
        grad_s.append(t1 - t0)
        update_s.append(time.perf_counter() - t1)
        del grads

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3 + steps, 3 + 2 * steps):
            step_fn(params, opt, batch_t, i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and cs.device_us(e) > 0]
    busy_us = sum(cs.device_us(e) for e in events)
    by_cat: dict = {}
    for e in events:
        cat = by_cat.setdefault(_category(e.key), {"device_ms": 0.0,
                                                   "launches": 0})
        cat["device_ms"] += cs.device_us(e) / 1e3 / steps
        cat["launches"] += e.count / steps
    top = sorted(events, key=cs.device_us, reverse=True)[:10]
    return {
        "arch": arch, "dtype": "bfloat16", "batch": batch, "seq": seq,
        "steps": steps,
        "grad_ms": [s * 1e3 for s in grad_s],
        "update_ms": [s * 1e3 for s in update_s],
        "profiled_wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernel_launches_per_step": sum(e.count for e in events) / steps,
        "by_category": by_cat,
        "top_kernels": [{"name": e.key[:90], "calls_per_step":
                         e.count / steps,
                         "device_ms_per_step": cs.device_us(e) / 1e3 / steps}
                        for e in top],
        "port_kernel_launches": {name: fn.launches
                                 for name, fn in counters.items()},
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", action="append", default=None,
                        help="arch id (repeatable; default: all four)")
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_train_torch: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    for arch, batch, seq, _, _ in cs.TRAIN_RUNS:
        if args.arch and arch not in args.arch:
            continue
        print(json.dumps(profile_arch(arch, batch, seq, args.steps, dev)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
