"""Training launcher of the port, on one card: the counterpart of
``repro.launch.train``.

Config -> the paper's planner (the train shape's plan on two modelled
H100 SXM cards, through the plan cache) -> parameters and AdamW state ->
the train step (``train.make_train_step``, the plain layers under
autograd) -> the synthetic data pipeline -> checkpoints -> telemetry.

Usage (on the CUDA card; ``--device cpu`` runs on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 20 --batch 8 --seq 512 --ckpt-dir ckpt --ckpt-every 10

Weights are random, drawn from ``--seed`` with a ``torch.Generator`` on the
training device; batches come from ``data.SyntheticLM`` with the same seed,
with stub ``frontend_emb`` rows for a modality-frontend or enc-dec arch, as
the reference's launcher asks for them.
Parameters are float32 with ``--reduced`` and bfloat16 otherwise, as in the
reference, unless ``--dtype`` says otherwise.  The plan sizes nothing on one
card: it is printed, and its step time is the cost model's (datasheet
figures), not a measurement.  Multi-device training (``--data-mesh``,
``--model-mesh``, ``--multi-pod``) is not ported yet and raises.

Checkpoints: ``--ckpt-every N`` saves after every N steps taken and the
run saves at its end, each checkpoint under the number of steps taken, so
``--resume`` goes on with the first step not yet taken.  (The reference
saves mid-run checkpoints under the index of the step just taken, and a
resume from one of them takes that step again.)
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import H100_SXM, Topology, compile_plan
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import SCHEDULES, init_state
from repro_torch.runtime import Telemetry
from repro_torch.train import TrainStepConfig, make_train_step
from repro_torch.tree import flatten

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None) -> dict:
    """Run the launcher; returns what it trained: {"cfg", "plan",
    "params", "opt", "history" (one dict of floats per step taken),
    "telemetry", "n_params", "device", "dtype"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine", choices=sorted(SCHEDULES))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="parameter type (default: float32 with --reduced, "
                         "else bfloat16)")
    ap.add_argument("--layers", type=int, default=None,
                    help="train the config cut to its first N layers, at "
                         "full width (a depth cut, for a model whose "
                         "training state does not fit the card)")
    args = ap.parse_args(argv)
    if args.data_mesh != 1 or args.model_mesh != 1 or args.multi_pod:
        raise NotImplementedError(
            "multi-device training is not ported yet (ROADMAP queue 1 item "
            "6; the pipeline over stage devices is "
            "train.make_pipeline_train_step): run with --data-mesh 1 "
            "--model-mesh 1 and no --multi-pod")

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)

    # the paper's compiler pass, through the on-disk plan cache: a launch
    # of the same (config x shape x topology) reuses the stored artifact
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    plan = compile_plan(cfg, shape, Topology.homogeneous(2, H100_SXM),
                        backend="tensor")
    print(f"[plan] {plan.describe()}"
          + (" (plan-cache hit)" if plan.from_cache else ""))

    dtype = DTYPES[args.dtype or ("float32" if args.reduced else "bfloat16")]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device, dtype)
    opt = init_state(params)
    n_params = sum(t.numel() for _, t in flatten(params))
    print(f"[init] {args.arch} params={n_params / 1e6:.1f}M "
          f"dtype={str(dtype).removeprefix('torch.')} device={device}")

    sched = SCHEDULES[args.schedule](args.lr, max(args.steps // 20, 2),
                                     args.steps)
    step_fn, _ = make_train_step(
        cfg, sched, TrainStepConfig(grad_accum=args.grad_accum))

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        state, meta = mgr.restore({"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        start = meta["step"]
        print(f"[resume] from step {start}")

    data = make_pipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch, seed=args.seed,
                   frontend_tokens=cfg.frontend_tokens if cfg.frontend
                   else 0,
                   frontend_dim=cfg.frontend_dim if cfg.frontend else 0),
        start_step=start)
    telem, history = Telemetry(), []
    try:
        for _ in range(start, args.steps):
            step_i, raw = data.next()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in raw.items()}
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch, step_i)
            # reading the metrics waits for the step's device work
            loss, ce, aux, gnorm = torch.stack(
                [m["loss"], m["ce"], m["aux"], m["grad_norm"]]).tolist()
            dt = time.perf_counter() - t0
            lr = float(m["lr"])
            telem.record(step_i, dt, loss)
            history.append({"step": step_i, "loss": loss, "ce": ce,
                            "aux": aux, "grad_norm": gnorm, "lr": lr,
                            "seconds": dt})
            if step_i % args.log_every == 0 or step_i == args.steps - 1:
                print(f"[step {step_i:5d}] loss={loss:.4f} "
                      f"gnorm={gnorm:.3f} lr={lr:.2e} {dt * 1e3:.0f}ms")
            taken = step_i + 1
            if mgr and taken % args.ckpt_every == 0 and taken < args.steps:
                mgr.save(taken, {"params": params, "opt": opt},
                         meta={"arch": args.arch})
        if mgr:
            mgr.save(args.steps, {"params": params, "opt": opt},
                     meta={"arch": args.arch})
    finally:
        data.close()
    print(f"[done] median step {telem.median_ms():.0f}ms; "
          f"stragglers detected: {telem.n_stragglers()}")
    return {"cfg": cfg, "plan": plan, "params": params, "opt": opt,
            "history": history, "telemetry": telem, "n_params": n_params,
            "device": device, "dtype": dtype}


if __name__ == "__main__":
    main()
