#!/usr/bin/env python3
"""Where a train step's time goes on one CUDA card, at the full-width
shapes of ``chip_smoke.py`` phase ``train``.

    python3 tools/profile_train_torch.py [--arch ARCH ...] [--steps N]

    python3 tools/profile_train_torch.py --arch tinyllama-1.1b --pipeline 4 --pipeline 8

For each arch (default: every run of ``chip_smoke.TRAIN_RUNS``, at its
batch, sequence and ``--layers`` depth cut), bf16 parameters from seed 0
take three warm-up steps of ``make_train_step`` (warmup-cosine at 3e-3,
the launcher's defaults), then N steps (default 3) split into their two
parts on the host clock, each ended by a synchronise: the gradient
(forward, recompute and backward through the plain layers) and the AdamW
update.  Then N more steps run under ``torch.profiler`` (CPU and
CUDA activities): device time per step by kernel, summed into the
categories matmul (cuBLAS and CUTLASS kernels), elementwise, reduction,
copy and other, kernel launches per step, and the device's busy share of
the profiled wall time.  No kernel of the port has a backward, so a train
step launches none of them; the line says so from the launch counters.

Each ``--pipeline M`` profiles the same way, for each arch the pipeline
takes, a step of ``make_pipeline_train_step`` over 2 stages with M
microbatches, at the same batch and weights (``chip_smoke.stage_devices``:
both stages on the one card, or on two cards where there are two).

Prints one JSON line per arch and step, after the card's ``nvidia-smi``
name and power limit.
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


def _profile(step_fn, loss_fn, params, opt, batch_t, sched, adamw_cfg,
             steps: int, allow_unused: bool) -> dict:
    """Warm-up, host-clock and profiled steps of ``step_fn`` (see the
    module's docstring); the gradient of ``loss_fn`` and the AdamW update
    are timed apart."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.optim import update
    from repro_torch.train import value_and_grad
    from repro_torch.tree import flatten, unflatten

    counters = cs.launch_counters()
    for fn in counters.values():
        fn.launches = 0
    for i in range(3):
        step_fn(params, opt, batch_t, i)
    torch.cuda.synchronize()

    grad_s, update_s = [], []
    for i in range(3, 3 + steps):
        t0 = time.perf_counter()
        _, _, grads = value_and_grad(loss_fn, params, batch_t,
                                     allow_unused=allow_unused)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = unflatten(zip((path for path, _ in flatten(params)), grads))
        update(params, grads, opt, sched(i), adamw_cfg)
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


def profile_arch(cfg, batch: int, seq: int, steps: int, dev,
                 pipeline_micro: tuple) -> list:
    """One profile of the one-card step of ``cfg``, and one of the
    pipeline's step for each M in ``pipeline_micro``."""
    import torch

    import chip_smoke as cs
    from repro_torch.models import lm
    from repro_torch.optim import init_state, warmup_cosine
    from repro_torch.train import (TrainStepConfig, make_pipeline_train_step,
                                   make_train_step, pipeline_refusal,
                                   split_stage_params)
    from repro_torch.tree import tree_map

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, torch.bfloat16)
    sched = warmup_cosine(3e-3, 2, 100)
    tcfg = TrainStepConfig()
    batch_t = cs._device_batch(cfg, seq, batch, 0, dev)
    head = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": "bfloat16",
            "batch": batch, "seq": seq}
    devices = cs.stage_devices(2)
    if pipeline_refusal(cfg, len(devices)) is not None:
        pipeline_micro = ()
    runs = []
    step_fn, loss_fn = make_train_step(cfg, sched, tcfg)
    # every step profiled starts from these weights
    one = tree_map(torch.clone, params) if pipeline_micro else params
    runs.append({**head, "step": "one card",
                 **_profile(step_fn, loss_fn, one, init_state(one), batch_t,
                            sched, tcfg.adamw, steps, False)})
    del one
    for micro in pipeline_micro:
        torch.cuda.empty_cache()
        split = split_stage_params(cfg, params, devices)
        step_fn, loss_fn = make_pipeline_train_step(
            cfg, devices, n_microbatches=micro, lr_fn=sched,
            adamw_cfg=tcfg.adamw)
        runs.append({**head, "step": f"pipeline, M = {micro}",
                     **cs._placement(devices),
                     **_profile(step_fn, loss_fn, split, init_state(split),
                                batch_t, sched, tcfg.adamw, steps, True)})
        del split
    return runs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", action="append", default=None,
                        help="arch id (repeatable; default: all four)")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--pipeline", type=int, action="append", default=[],
                        metavar="M",
                        help="also profile the pipeline's step over 2 "
                        "stages at M microbatches (repeatable)")
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
    from repro_torch import configs
    for arch, batch, seq, _, extra in cs.TRAIN_RUNS:
        if args.arch and arch not in args.arch:
            continue
        cfg = configs.get(arch)
        if "--layers" in extra:
            cfg = cfg.replace(
                n_layers=int(extra[extra.index("--layers") + 1]))
        for run in profile_arch(cfg, batch, seq, args.steps, dev,
                                tuple(args.pipeline)):
            print(json.dumps(run), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
