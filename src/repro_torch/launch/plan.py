"""Plan compiler CLI of the port: compile, print, save, and diff
CompiledPlan artifacts.

The launch-layer face of the plan-centric compiler API
(``repro_torch.core.plan``, the port's copy of ``repro.launch.plan``):
compiles one (arch x shape x topology) cell through the on-disk plan
cache, prints the costed summary, and optionally writes the JSON artifact
other launchers consume.  The default and ``--hetero`` topologies are
built on ``H100_SXM``, the port's target; ``--topology-json`` takes any
described machine.  Planning is pure Python and needs no card.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.plan --arch tinyllama-1.1b
    PYTHONPATH=src python -m repro_torch.launch.plan --arch tinyllama-1.1b \
        --shape decode_32k --devices 8 --backend pipeline --save plan.json
    PYTHONPATH=src python -m repro_torch.launch.plan --arch mamba2-370m \
        --hetero 0.5,1.0,1.0,1.0            # heterogeneous topology
    PYTHONPATH=src python -m repro_torch.launch.plan \
        --topology-json topo.json ...
    PYTHONPATH=src python -m repro_torch.launch.plan --diff a.json b.json
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch import configs
from repro_torch.core import (H100_SXM, CompiledPlan, PartitionStrategy,
                              Topology, compile_plan, plan_key)
from repro_torch.models.config import SHAPES


def _topology(args) -> Topology:
    if args.topology_json:
        with open(args.topology_json, encoding="utf-8") as fh:
            return Topology.from_json(json.load(fh))
    if args.hetero:
        speeds = [float(s) for s in args.hetero.split(",")]
        return Topology.heterogeneous(speeds, H100_SXM)
    return Topology.homogeneous(args.devices, H100_SXM)


def _print_plan(plan: CompiledPlan) -> None:
    src = "cache hit" if plan.from_cache else "compiled"
    print(f"[plan] {plan.describe()}")
    print(f"[plan] topology: {plan.topology.describe()}")
    b = plan.balance()
    loads = " ".join(f"{v * 1e3:.1f}" for v in b["loads"])
    print(f"[plan] per-device load (ms): {loads} "
          f"(ideal {b['ideal'] * 1e3:.1f}ms)")
    print(f"[plan] partitioner: {plan.strategy.strategy}"
          f"{'+refine' if plan.strategy.refine else ''} "
          f"passes={plan.result.passes} comm_moves={plan.result.comm_moves} "
          f"balance_moves={plan.result.balance_moves} "
          f"cut {plan.result.cut_before:.3e} -> {plan.result.cut_after:.3e}B")
    print(f"[plan] source: {src} (key={plan.key})")


def _diff(path_a: str, path_b: str) -> int:
    a = CompiledPlan.load(path_a)
    b = CompiledPlan.load(path_b)
    d = a.diff(b)
    print(f"[diff] {path_a} vs {path_b}")
    print(f"[diff] same_key={d['same_key']} moved={d['n_moved']} "
          f"only_a={len(d['only_self'])} only_b={len(d['only_other'])}")
    for nid in d["moved"][:20]:
        print(f"[diff]   {nid}: {a.assignment[nid]} -> {b.assignment[nid]}")
    if d["n_moved"] > 20:
        print(f"[diff]   ... and {d['n_moved'] - 20} more")
    if "step_time_s" in d:
        ta, tb = d["step_time_s"]
        ca, cb = d["cut_bytes"]
        print(f"[diff] t_step {ta * 1e3:.2f}ms -> {tb * 1e3:.2f}ms; "
              f"cut {ca:.3e}B -> {cb:.3e}B")
    return 0 if d["n_moved"] == 0 and d["same_key"] else 1


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="compile / inspect / diff CompiledPlan artifacts")
    ap.add_argument("--arch", default=None,
                    help="arch id (see repro_torch.configs.available())")
    ap.add_argument("--reduced", action="store_true",
                    help="plan the reduced (CPU-sized) config")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--devices", type=int, default=4,
                    help="homogeneous topology size (H100 SXM)")
    ap.add_argument("--hetero", default=None, metavar="S0,S1,...",
                    help="heterogeneous topology: per-device speed factors")
    ap.add_argument("--topology-json", default=None, metavar="PATH",
                    help="load a described machine (Topology.to_json file)")
    ap.add_argument("--backend", default="tensor",
                    choices=["tensor", "pipeline"])
    ap.add_argument("--save", default=None, metavar="PATH", nargs="?",
                    const="", help="write the JSON artifact (default name: "
                                   "plan-<arch>__<shape>__k<k>.json)")
    ap.add_argument("--no-cache", action="store_true",
                    help="bypass the on-disk plan cache")
    ap.add_argument("--key-only", action="store_true",
                    help="print the plan key without compiling")
    ap.add_argument("--diff", nargs=2, metavar=("A.json", "B.json"),
                    help="diff two saved artifacts and exit")
    args = ap.parse_args(argv)

    if args.diff:
        sys.exit(_diff(*args.diff))
    if not args.arch:
        ap.error("--arch is required (unless --diff)")

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = SHAPES[args.shape]
    topology = _topology(args)
    strategy = PartitionStrategy()

    if args.key_only:
        print(plan_key(cfg, shape, topology, args.backend, strategy))
        return

    plan = compile_plan(cfg, shape, topology, backend=args.backend,
                        strategy=strategy,
                        cache=False if args.no_cache else None)
    _print_plan(plan)

    if args.save is not None:
        path = args.save or f"plan-{cfg.name}__{shape.name}__k{plan.k}.json"
        plan.save(path)
        print(f"[plan] saved -> {path}")
        # prove the artifact stands alone: reload + verify cost summaries
        reloaded = CompiledPlan.load(path)
        assert reloaded.assignment == plan.assignment
        print(f"[plan] reload verified (t_step "
              f"{reloaded.step_time * 1e3:.2f}ms)")


if __name__ == "__main__":
    main()
