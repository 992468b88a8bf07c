"""Training launcher (the JAX package's ``launch/train.py``) on one device.

Drives ``make_train_step`` with ``adamw`` and ``cosine_lr`` over synthetic
batches, with checkpoint/restart through ``CheckpointManager`` (async saves,
the reference's layout). ``--smoke`` runs the reduced SMOKE config, the
same code path. The production mesh and ``--model-parallel`` above 1 need
the sharding rules, which the port has not yet (``distributed/sharding``):
they raise.

A resumed run continues the batch stream where the checkpoint left it (the
generator is advanced past the steps already taken), so it equals the run
that was never interrupted; the reference's restarts the stream from its
seed. Checkpoints hold the parameters and the optimizer state, as the
reference's.

Example (the card; ``--device cpu`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import data_axes, make_host_mesh
from repro_torch.models import init_params, make_train_step
from repro_torch.train import CheckpointManager, adamw, cosine_lr


def synthetic_batch(rng, cfg, batch, seq):
    shape = (batch, seq)
    if cfg.num_codebooks > 1:
        shape = shape + (cfg.num_codebooks,)
    tokens = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def main(argv=None) -> dict:
    """Runs the loop; returns ``{"start", "steps", "losses"}`` (the losses
    of the steps this run took, as floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    if args.production_mesh or args.model_parallel > 1:
        raise SystemExit("--production-mesh and --model-parallel > 1 need "
                         "distributed/sharding (ROADMAP A13.3)")
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = make_host_mesh(args.model_parallel, device=args.device)
    print(f"{cfg.name}: mesh {dict(zip(mesh.axis_names, mesh.shape))}, batch over "
          f"{data_axes(mesh)}, device {mesh.device}", flush=True)
    opt = adamw(lr=cosine_lr(args.lr, warmup=10, total=args.steps))
    step = make_train_step(cfg, opt)

    params = init_params(cfg, seed=args.seed, device=mesh.device)
    opt_state = opt.init(params)
    manager = (
        CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
        if args.ckpt_dir else None
    )
    start = 0
    if manager and args.resume:
        _, start, _ = manager.restore_latest((params, opt_state))
        print(f"resumed from step {start}")

    rng = np.random.default_rng(args.seed + 1)
    for _ in range(start):                 # the batches the restored steps took
        synthetic_batch(rng, cfg, args.batch, args.seq)
    losses = []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        batch = synthetic_batch(rng, cfg, args.batch, args.seq)
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(metrics["loss"])
        if (i + 1) % 10 == 0 or i == start:
            loss = float(metrics["loss"])
            dt = (time.perf_counter() - t0) / max(i + 1 - start, 1)
            print(f"step {i+1:5d}  loss {loss:.4f}  {dt*1e3:.0f} ms/step", flush=True)
        if manager and (i + 1) % args.ckpt_every == 0:
            manager.save(i + 1, (params, opt_state))
    if manager:
        manager.save(args.steps, (params, opt_state))
        manager.wait()
    print("done")
    return {"start": start, "steps": args.steps,
            "losses": [float(v) for v in losses]}


if __name__ == "__main__":
    main()
