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
        --reduced --batch 4 --prompt-len 16 --max-new 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --reduced --continuous --paged --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --reduced --continuous --paged \
        --prompt-len 40 --kv-len 96 --device cpu

Weights are random, drawn from ``--seed`` with a ``torch.Generator`` on
the serving device; prompts come from the same generator.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
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
    eng = ContinuousEngine(cfg, params, kv_len=args.kv_len,
                           n_slots=args.batch, paged=args.paged,
                           bucket_prompts=args.bucket,
                           prefill_chunk=args.chunk_prefill,
                           dtype=dtype, device=device)
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="parameter and cache type (default: float32 with "
                         "--reduced, else bfloat16)")
    args = ap.parse_args(argv)

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
