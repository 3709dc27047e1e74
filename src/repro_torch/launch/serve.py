"""Serving launcher of the port: static batch, or continuous batching over
dense per-slot lanes or the paged KV cache (window block rings for
sliding-window layers, and per-lane recurrent state slabs for mamba2's and
recurrentgemma's recurrent layers), with whole, bucketed (``--bucket``) or
chunked (``--chunk-prefill C``, paged only) prefill.

Usage (on the CUDA card; ``--device cpu`` runs the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --continuous --paged
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --continuous --paged --bucket --chunk-prefill 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --continuous --bucket
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --continuous --paged
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --continuous --paged
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --continuous --paged --adapt --devices 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --reduced --batch 4 --prompt-len 16 --max-new 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --reduced --continuous --paged --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --reduced --continuous --paged \
        --prompt-len 40 --kv-len 96 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-mlp \
        --reduced --continuous --paged --adapt --devices 4 --device cpu

``--adapt`` closes the paper's compiler/assistant loop on the continuous
path: the engine is sized from a plan compiled (or fetched from the plan
cache) for its decode shape on ``--devices`` modelled H100 SXM cards, and
after the run the serving telemetry (slot occupancy, cache pressure) feeds
the §3 scheduling assistants, which rebalance that plan under the measured
serving interference.  The plan's step times are modelled from datasheet
figures, not measured.

Weights are random, drawn from ``--seed`` with a ``torch.Generator`` on
the serving device; prompts come from the same generator.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core import H100_SXM, Topology, adapt_plan, compile_plan
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import ContinuousEngine, Engine

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _static(args, cfg, params, gen, device, dtype):
    eng = Engine(cfg, params, kv_len=args.kv_len, dtype=dtype,
                 device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=args.max_new)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    print(f"[serve] {args.arch}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s batched) on {device}")
    print("first sequence:", out[0].tolist())


def _continuous(args, cfg, params, gen, device, dtype):
    plan = None
    if args.adapt:
        # compile (or fetch from the plan cache) the placement for the
        # decode traffic this launch serves: the engine's cache length x
        # lane count, on the modelled cards of --devices
        serve_shape = ContinuousEngine.decode_shape_for(args.kv_len,
                                                        args.batch)
        plan = compile_plan(cfg, serve_shape,
                            Topology.homogeneous(args.devices, H100_SXM))
    eng = ContinuousEngine(cfg, params, kv_len=args.kv_len,
                           n_slots=args.batch, paged=args.paged,
                           bucket_prompts=args.bucket,
                           prefill_chunk=args.chunk_prefill,
                           dtype=dtype, device=device, plan=plan)
    for i in range(args.requests):
        prompt = torch.randint(0, cfg.vocab_size, (args.prompt_len,),
                               generator=gen, device=device)
        eng.submit(prompt.tolist(), max_new_tokens=args.max_new, rid=i,
                   arrival=i * args.stagger)
    t0 = time.perf_counter()
    results = eng.run()
    dt = time.perf_counter() - t0
    tel = eng.telemetry
    total = sum(len(v) for v in results.values())
    print(f"[serve-cb] {args.arch}: {len(results)} requests, {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s) on {device}")
    print(f"[serve-cb] occupancy={tel.occupancy():.2f} "
          f"cache_pressure={tel.cache_pressure():.2f} "
          f"peak={tel.peak_cache_pressure():.2f} "
          f"prefill={tel.mean_prefill_ms():.1f}ms "
          f"chunk={tel.mean_chunk_ms():.1f}ms "
          f"chunks={tel.prefill_chunks()} "
          f"decode_step={tel.mean_decode_step_ms():.1f}ms "
          f"slot_reuse={eng.scheduler.max_slot_reuse()}")
    if not args.paged:
        print(f"[serve-cb] dense lanes: {eng.n_slots} per-slot caches of "
              f"kv_len {eng.kv_len}")
    else:
        by_group = " ".join(f"{g}={b / 1024:.0f}KiB" for g, b in
                            tel.peak_resident_bytes_by_group().items())
        print(f"[serve-cb] paged: peak_resident="
              f"{tel.peak_resident_bytes() / 1024:.0f}KiB / "
              f"{eng.allocator.capacity_bytes() / 1024:.0f}KiB "
              f"({len(eng.allocator.stores)} layer pools, "
              f"block_size={eng.block_size}, "
              f"{eng.allocator.layout.state_slots} state slots) "
              f"peak by group: {by_group}")
    if results:
        print("first request:", results[0])
    if args.adapt:
        _adapt(plan, eng)


def _adapt(plan, eng) -> None:
    """The §3 assistants over the engine's plan under the run's serving
    interference; the trace's deltas are validated by
    ``CompiledPlan.apply``."""
    tel = eng.telemetry
    assert plan.shape == eng.decode_shape()
    cb = tel.assistant_callback(plan.graph, plan.cost_model)
    adapted, trace = adapt_plan(
        plan, interference=tel.device_interference(plan.k), telemetry=cb)
    print(f"[adapt] plan {plan.describe()}"
          + (" (plan-cache hit)" if plan.from_cache else ""))
    print(f"[adapt] assistants: {len(trace.deltas)} deltas, step time "
          f"{trace.step_times[0]*1e3:.2f}ms -> "
          f"{trace.step_times[-1]*1e3:.2f}ms "
          f"({trace.improvement:.1%} improvement under serving load)")
    for d in trace.deltas:
        print(f"[adapt]   delta cycle={d.cycle} {d.node}: "
              f"{d.src} -> {d.dst} ({d.resource}, "
              f"gain {d.gain*1e3:+.2f}ms)")
    if trace.deltas:
        print(f"[adapt] adapted t_step {adapted.step_time*1e3:.2f}ms "
              f"cut {adapted.cut_bytes:.3e}B (trace replayable: "
              f"{adapted.assignment == trace.replay(plan.assignment)})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch size / continuous slot count")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--kv-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (slot scheduler + paged cache)")
    ap.add_argument("--paged", action="store_true",
                    help="continuous: physical paged cache (block-table "
                         "decode; global tables / window rings / recurrent "
                         "state slots)")
    ap.add_argument("--bucket", action="store_true",
                    help="continuous: pad prefills to power-of-two buckets "
                         "(a bounded set of prefill shapes)")
    ap.add_argument("--chunk-prefill", type=int, default=0, metavar="C",
                    help="continuous+paged: prefill prompts in C-token "
                         "chunks interleaved with decode")
    ap.add_argument("--requests", type=int, default=8,
                    help="continuous: number of requests in the trace")
    ap.add_argument("--stagger", type=int, default=2,
                    help="continuous: arrival gap between requests, in steps")
    ap.add_argument("--adapt", action="store_true",
                    help="continuous: size the engine from a compiled plan "
                         "and feed the serve telemetry to the §3 "
                         "assistants")
    ap.add_argument("--devices", type=int, default=4,
                    help="modelled H100 SXM count for --adapt planning")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="parameter and cache type (default: float32 with "
                         "--reduced, else bfloat16)")
    args = ap.parse_args(argv)
    if args.adapt and not args.continuous:
        ap.error("--adapt requires --continuous (it sizes the continuous "
                 "engine from a compiled plan)")

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype or ("float32" if args.reduced else "bfloat16")]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device, dtype)
    if args.continuous:
        _continuous(args, cfg, params, gen, device, dtype)
    else:
        _static(args, cfg, params, gen, device, dtype)


if __name__ == "__main__":
    main()
