"""Serving launcher of the port: static batch, or continuous batching over
dense per-slot lanes or the paged KV cache (window block rings for
sliding-window layers, per-lane recurrent state slabs for mamba2's and
recurrentgemma's recurrent layers, latent pools for deepseek-v2-lite's
multi-head latent attention, and static cross block sets for
seamless-m4t-medium's encoder frames; phi-3-vision's projected image rows
page through its decoder tables: requests of these two archs carry
seeded stub frontend embeddings), with whole, bucketed (``--bucket``) or
chunked (``--chunk-prefill C``, paged only) prefill, per-request sampling
(``--temperature``, ``--top-k``, ``--top-p``; request i samples with seed
``--sample-seed + i``), self-speculative decoding (``--speculate K``,
``--draft-layers L``, paged only), worst-case or lazy admission pricing
(``--pricing``, ``--cache-blocks`` to undersize the pool), the
content-addressed prefix cache (``--prefix-cache``, paged only, with
``--shared-prefix P`` opening every prompt with the same P tokens), and a
cache-aware router over ``--replicas N`` engine replicas (``--disaggregate``
splits prefill from decode replicas with a block handoff; archs whose
blocks cannot be handed over run co-located replicas and say why).

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
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --continuous --paged
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi-3-vision-4.2b --continuous --paged
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --continuous --paged --chunk-prefill 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --continuous --paged --bucket --chunk-prefill 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --continuous --paged --adapt --devices 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --continuous --paged --speculate 4 --temperature 0.8 --top-k 40 \
        --top-p 0.95
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --continuous --paged --pricing lazy --cache-blocks 40
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --continuous --paged --prefix-cache --shared-prefix 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --continuous --paged --replicas 2 --disaggregate --chunk-prefill 16 \
        --shared-prefix 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --reduced --batch 4 --prompt-len 16 --max-new 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --reduced --continuous --paged --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --reduced --continuous --paged \
        --prompt-len 40 --kv-len 96 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --reduced --continuous --paged \
        --prefix-cache --shared-prefix 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi-3-vision-4.2b --reduced --continuous --paged \
        --kv-len 56 --prompt-len 8 --max-new 6 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --reduced --continuous --paged \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-mlp \
        --reduced --continuous --paged --adapt --devices 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --reduced --continuous --paged --bucket --chunk-prefill 16 \
        --prompt-len 40 --kv-len 96 --device cpu

Every arch of ``repro_torch.configs.available()`` serves: gemma2-9b's
sliding-window layers page through window rings beside its global
layers' tables, mixtral-8x7b's through rings alone (with the MoE FFN);
both refuse ``--prefix-cache`` and serve ``--disaggregate`` as
co-located replicas.  minicpm-2b and command-r-35b take every flag.

A modality-frontend arch's paged lanes hold its frontend rows ahead of the
prompt, so ``--kv-len`` plus those rows must be a multiple of the block
size (16): 128 + 576 for phi-3-vision, 56 + 8 at its reduced size.

``--adapt`` closes the paper's compiler/assistant loop on the continuous
path: the engine is sized from a plan compiled (or fetched from the plan
cache) for its decode shape on ``--devices`` modelled H100 SXM cards, and
after the run the serving telemetry (slot occupancy, cache pressure) feeds
the §3 scheduling assistants, which rebalance that plan under the measured
serving interference.  The plan's step times are modelled from datasheet
figures, not measured.

Weights are random, drawn from ``--seed`` with a ``torch.Generator`` on
the serving device; prompts (the shared prefix first) come from the same
generator, and so do the stub frontend embeddings of a modality-frontend
or enc-dec arch (standard normal, one [frontend_tokens, frontend_dim]
block per request; the CLIP and conformer towers are not modelled).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core import H100_SXM, Topology, adapt_plan, compile_plan
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import ContinuousEngine, Engine, Router, SamplingParams

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _static(args, cfg, params, gen, device, dtype):
    eng = Engine(cfg, params, kv_len=args.kv_len, dtype=dtype,
                 device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    fe = _frontend_emb(cfg, gen, device, args.batch)
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=args.max_new, frontend_emb=fe)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    print(f"[serve] {args.arch}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s batched) on {device}")
    print("first sequence:", out[0].tolist())


def _frontend_emb(cfg, gen, device, *batch):
    """Seeded stub frontend embeddings ``[*batch, frontend_tokens,
    frontend_dim]`` for a modality-frontend or enc-dec arch, else None."""
    if not (cfg.frontend or cfg.n_enc_layers):
        return None
    return torch.randn(tuple(batch) + (cfg.frontend_tokens, cfg.frontend_dim),
                       generator=gen, device=device)


def _trace(args, cfg, gen, device) -> list:
    """The arrival trace, ``(prompt, frontend_emb, sampling)`` per request,
    shared by the single-engine and routed paths (``--replicas`` changes
    placement, never the workload).  With ``--shared-prefix P`` every
    prompt opens with the same P tokens, the workload the prefix cache
    deduplicates."""
    shared = (torch.randint(0, cfg.vocab_size, (args.shared_prefix,),
                            generator=gen, device=device).tolist()
              if args.shared_prefix > 0 else [])
    out = []
    for i in range(args.requests):
        prompt = torch.randint(0, cfg.vocab_size, (args.prompt_len,),
                               generator=gen, device=device).tolist()
        # per-request sampling (temperature 0 stays bitwise greedy)
        sp = (SamplingParams(temperature=args.temperature, top_k=args.top_k,
                             top_p=args.top_p, seed=args.sample_seed + i)
              if args.temperature > 0 else None)
        out.append((shared + prompt, _frontend_emb(cfg, gen, device), sp))
    return out


def _plan(args, cfg):
    """With ``--adapt``: the plan (compiled, or fetched from the plan
    cache) of the decode traffic this launch serves, the engine's cache
    length x lane count, on the modelled cards of --devices."""
    if not args.adapt:
        return None
    serve_shape = ContinuousEngine.decode_shape_for(args.kv_len, args.batch)
    return compile_plan(cfg, serve_shape,
                        Topology.homogeneous(args.devices, H100_SXM))


def _router(args, cfg, params, gen, device, dtype):
    """``--replicas N``: the trace routed over an N-engine fleet, with
    ``--disaggregate`` splitting prefill from decode replicas."""
    router = Router.build(cfg, params, n_replicas=args.replicas,
                          disaggregate=args.disaggregate,
                          kv_len=args.kv_len, n_slots=args.batch,
                          paged=args.paged,
                          prefill_chunk=args.chunk_prefill,
                          prefix_cache=args.prefix_cache or None,
                          plans=_plan(args, cfg), dtype=dtype,
                          device=device, bucket_prompts=args.bucket,
                          pricing=args.pricing,
                          cache_blocks=args.cache_blocks)
    if router.disagg_unsupported_reason:
        print(f"[router] {args.arch}: disaggregation unavailable "
              f"({router.disagg_unsupported_reason}) — running "
              f"{args.replicas} co-located replicas")
    for i, (prompt, fe, sp) in enumerate(_trace(args, cfg, gen, device)):
        router.submit(prompt, max_new_tokens=args.max_new, rid=i,
                      arrival=i * args.stagger, frontend_emb=fe, sampling=sp)
    t0 = time.perf_counter()
    results = router.run()
    _sync(device)
    dt = time.perf_counter() - t0
    fs = router.fleet_stats()
    total = fs["total_tokens"]
    roles = "/".join(r.role for r in router.replicas)
    print(f"[router] {args.arch}: {len(results)} requests over "
          f"{args.replicas} replicas ({roles}), {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s) on {device}")
    print(f"[router] placement={fs['routed_per_replica']} "
          f"handoffs={fs['handoffs']} "
          f"transferred_blocks={fs['transferred_blocks']} "
          f"decode_starvation={fs['decode_starvation']} "
          f"occupancy={fs['occupancy']:.2f} "
          f"cache_pressure={fs['cache_pressure']:.2f}"
          + (f" prefix_hit_rate={fs['prefix_hit_rate']:.2f}"
             if args.prefix_cache or args.disaggregate else ""))
    for name, row in router.telemetry.summary().items():
        print(f"[router]   {name}: tokens={row['tokens']} "
              f"steps={row['steps']} "
              f"starved={row['decode_starvation']} "
              f"occupancy={row['occupancy']:.2f}")
    if results:
        print("first request:", results[0])
    if args.adapt:
        out = router.adapt()
        print(f"[adapt] fleet: {len(out.migrations)} queued-request "
              f"migrations, plan deltas="
              f"{len(out.trace.deltas) if out.trace else 0}")
        if out.trace and out.trace.deltas:
            print(f"[adapt] step time {out.trace.step_times[0]*1e3:.2f}ms "
                  f"-> {out.trace.step_times[-1]*1e3:.2f}ms "
                  f"({out.trace.improvement:.1%} under fleet load)")


def _continuous(args, cfg, params, gen, device, dtype):
    plan = _plan(args, cfg)
    eng = ContinuousEngine(cfg, params, kv_len=args.kv_len,
                           n_slots=args.batch, paged=args.paged,
                           bucket_prompts=args.bucket,
                           prefill_chunk=args.chunk_prefill,
                           prefix_cache=args.prefix_cache,
                           pricing=args.pricing,
                           cache_blocks=args.cache_blocks,
                           speculate=args.speculate,
                           draft_layers=args.draft_layers,
                           dtype=dtype, device=device, plan=plan)
    for i, (prompt, fe, sp) in enumerate(_trace(args, cfg, gen, device)):
        eng.submit(prompt, max_new_tokens=args.max_new, rid=i,
                   arrival=i * args.stagger, frontend_emb=fe, sampling=sp)
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
    if args.prefix_cache:
        st = eng.allocator.prefix_stats()
        print(f"[serve-cb] prefix-cache: hit_rate="
              f"{tel.prefix_hit_rate():.2f} "
              f"({st['hit_tokens']}/{st['lookup_tokens']} tokens, "
              f"{st['hit_admissions']}/{st['admissions']} admissions) "
              f"commits={st['commits']} evictions={st['evictions']} "
              f"cow_forks={st['cow_forks']} "
              f"peak_shared={tel.peak_shared_saved_bytes() / 1024:.0f}KiB")
    if args.speculate:
        print(f"[serve-cb] speculative: k={args.speculate} "
              f"draft_layers={eng.draft_layers} "
              f"accept_rate={tel.accept_rate():.2f} "
              f"({tel.total_drafted()} drafted, "
              f"{tel.total_rewound_tokens()} rows rewound)")
    if eng.scheduler.preemptions:
        print(f"[serve-cb] preemptions={eng.scheduler.preemptions} "
              f"(lazy-pricing evict-and-requeue)")
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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="continuous+paged: content-addressed prefix-block "
                         "reuse with copy-on-write (all-global-attention "
                         "archs)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="P",
                    help="continuous: open every prompt with the same P "
                         "random tokens (the workload --prefix-cache "
                         "deduplicates)")
    ap.add_argument("--pricing", choices=("worst", "lazy"), default="worst",
                    help="continuous admission pricing: reserve the full "
                         "worst case (default) or oversubscribe and "
                         "preempt-requeue on mid-decode exhaustion")
    ap.add_argument("--cache-blocks", type=int, default=None, metavar="N",
                    help="continuous: override the self-sized block pool "
                         "(undersize it to exercise admission backpressure)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="continuous: sampling temperature (0 = exact "
                         "greedy argmax, the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="continuous: keep only the k highest logits "
                         "(0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="continuous: nucleus sampling mass (1.0 disables)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="continuous: base PRNG seed for sampling (request "
                         "i uses sample-seed + i; --seed seeds the weights)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="continuous+paged: self-speculative decoding: "
                         "draft K tokens per round with a truncated-layer "
                         "pass, verify in one batched step, rewind the "
                         "paged cache past the rejection point")
    ap.add_argument("--draft-layers", type=int, default=None, metavar="L",
                    help="--speculate: layers the draft pass runs "
                         "(default: half the stack, whole cycles)")
    ap.add_argument("--requests", type=int, default=8,
                    help="continuous: number of requests in the trace")
    ap.add_argument("--stagger", type=int, default=2,
                    help="continuous: arrival gap between requests, in steps")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="continuous: serve through a cache-aware router "
                         "over N engine replicas (N > 1)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="--replicas: replica 0 runs chunked prefill only "
                         "and hands finished KV blocks to decode replicas "
                         "(co-located replicas on archs whose blocks "
                         "cannot be handed over)")
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
    if args.replicas > 1:
        if not args.continuous:
            raise SystemExit("--replicas requires --continuous (the router "
                             "fans a request trace over engine replicas)")
        _router(args, cfg, params, gen, device, dtype)
    elif args.continuous:
        _continuous(args, cfg, params, gen, device, dtype)
    else:
        _static(args, cfg, params, gen, device, dtype)


if __name__ == "__main__":
    main()
