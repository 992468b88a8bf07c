"""Hillclimb helper (the JAX package's ``launch/inspect_cell.py``): run a
one-unit probe of one cell (``num_layers`` = one superblock) on the
placeholder ranks of ``launch/dryrun.py`` and print the largest
collectives by kind, each with the leaf that caused it, and the operators
that move the most bytes, so each perf hypothesis is grounded in what the
step issues rather than guesswork. The reference reads both out of the
compiled HLO; here ``distributed.comm.LOG`` tags each collective with its
leaf and ``dryrun.CostMode`` counts each operator's bytes.

    PYTHONPATH=src python -m repro_torch.launch.inspect_cell --arch llama3.2-1b \\
        --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
from collections import defaultdict

from repro_torch.configs import get_config
from repro_torch.distributed import comm
from repro_torch.launch.dryrun import _build_step, _cell_unit, measure, production_mesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--gather-weights", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    repl = {"num_layers": args.units * _cell_unit(cfg), "unroll_layers": True}
    if args.remat:
        repl["remat"] = args.remat
    if args.gather_weights:
        repl["gather_weights"] = True
    cfg = dataclasses.replace(cfg, **repl)
    mesh = production_mesh(args.multi_pod)
    run, _, _ = _build_step(cfg, args.shape, mesh)
    comm.LOG = []
    try:
        m = measure(run)
        log = list(comm.LOG)
    finally:
        comm.LOG = None

    per_kind = defaultdict(int)
    for kind, b, _ in log:
        per_kind[kind] += b
    rows = sorted(((b, kind, tag) for kind, b, tag in log), reverse=True)
    print(f"== {args.arch} {args.shape} probe({args.units} unit) "
          f"collective bytes by kind ==")
    for k, v in sorted(per_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {k:20s} {v/1e9:8.3f} GB")
    print(f"== top {args.top} collectives ==")
    for b, kind, name in rows[: args.top]:
        print(f"  {b/1e9:8.3f} GB  {kind:18s} {name}")
    ops = sorted(m["by_op"].items(), key=lambda kv: -kv[1][0])
    print(f"== top {args.top} operators by bytes ==")
    for name, (b, n) in ops[: args.top]:
        print(f"  {b/1e9:8.3f} GB  {n:6d} calls  {name}")
    print(f"== cost: flops={m['flops']:.3e} bytes={m['bytes']:.3e}")
    return {"collectives": rows, "by_kind": dict(per_kind), "ops": ops, "cost": m}


if __name__ == "__main__":
    main()
