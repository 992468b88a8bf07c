"""Training launcher (the JAX package's ``launch/train.py``).

Drives a train step with ``adamw`` and ``cosine_lr`` over synthetic
batches, with checkpoint/restart through ``CheckpointManager`` (async saves,
the reference's layout). ``--smoke`` runs the reduced SMOKE config, the
same code path.

* **One process** (no ``WORLD_SIZE`` in the environment): the unsharded
  ``make_train_step`` on one device. ``--model-parallel`` above 1 and
  ``--production-mesh`` raise: one rank has nothing to shard over.
* **Under torchrun** (``WORLD_SIZE`` set): every rank joins the process
  group (NCCL on the card, one card a rank by ``LOCAL_RANK``; gloo with
  ``--device cpu``), builds the mesh data = W / model x model
  (``--model-parallel``; ``--production-mesh`` is the reference's 16 x 16
  and needs W = 256) and drives ``distributed.fsdp``'s sharded step. The
  checkpoints hold the unsharded tree in the one-process layout (gathered,
  saved by rank 0), so either form resumes the other's.

A resumed run continues the batch stream where the checkpoint left it (the
generator is advanced past the steps already taken), so it equals the run
that was never interrupted; the reference's restarts the stream from its
seed. Checkpoints hold the parameters and the optimizer state, as the
reference's.

Examples (the card; ``--device cpu`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-1b --smoke --model-parallel 2
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import data_axes, make_host_mesh
from repro_torch.models import init_params, make_train_step
from repro_torch.train import CheckpointManager, adamw, cosine_lr

PRODUCTION_RANKS = 256          # the reference's single-pod mesh, data 16 x model 16


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

    world = int(os.environ.get("WORLD_SIZE", "0"))
    if args.production_mesh and world != PRODUCTION_RANKS:
        raise SystemExit(f"--production-mesh needs W = {PRODUCTION_RANKS} ranks (data 16 x model "
                         f"16); this run has W = {max(world, 1)}")
    if not world and args.model_parallel > 1:
        raise SystemExit(f"--model-parallel {args.model_parallel} needs W ranks that it divides "
                         "(torchrun --nproc-per-node W); this run has W = 1")
    cfg = get_config(args.arch, smoke=args.smoke)
    opt = adamw(lr=cosine_lr(args.lr, warmup=10, total=args.steps))
    manager = (
        CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
        if args.ckpt_dir else None
    )
    if world:
        return _run_sharded(args, cfg, opt, manager, world)
    mesh = make_host_mesh(args.model_parallel, device=args.device)
    print(f"{cfg.name}: mesh {dict(zip(mesh.axis_names, mesh.shape))}, batch over "
          f"{data_axes(mesh)}, device {mesh.device}", flush=True)
    step = make_train_step(cfg, opt)

    params = init_params(cfg, seed=args.seed, device=mesh.device)
    opt_state = opt.init(params)
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


def _run_sharded(args, cfg, opt, manager, world: int) -> dict:
    """The torchrun form: the sharded step over a process-group mesh."""
    from repro_torch.distributed import make_train_mesh
    from repro_torch.distributed.fsdp import make_sharded_train_step

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    model_axis = 16 if args.production_mesh else args.model_parallel
    if world % model_axis:
        raise SystemExit(f"--model-parallel {model_axis} does not divide W = {world}")
    mesh = make_train_mesh(model=model_axis, device=dev)
    rank = dist.get_rank()
    if rank == 0:
        print(f"{cfg.name}: mesh {dict(zip(mesh.axis_names, mesh.shape))} over W = {world} "
              f"ranks, sharded step, device {dev.type}", flush=True)
    shard_state, step = make_sharded_train_step(cfg, opt, mesh)
    params = init_params(cfg, seed=args.seed, device=dev)
    whole_opt = None
    start = 0
    if manager and args.resume:
        whole_opt = opt.init(params)
        _, start, _ = manager.restore_latest((params, whole_opt))
        if rank == 0:
            print(f"resumed from step {start}")
    state = shard_state(params, whole_opt)
    del params, whole_opt

    def save(at: int) -> None:
        whole = step.unshard(state)
        if rank == 0:
            manager.save(at, whole)
        dist.barrier()

    rng = np.random.default_rng(args.seed + 1)
    for _ in range(start):                 # the batches the restored steps took
        synthetic_batch(rng, cfg, args.batch, args.seq)
    losses = []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        batch = synthetic_batch(rng, cfg, args.batch, args.seq)
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        if rank == 0 and ((i + 1) % 10 == 0 or i == start):
            dt = (time.perf_counter() - t0) / max(i + 1 - start, 1)
            print(f"step {i+1:5d}  loss {float(metrics['loss']):.4f}  {dt*1e3:.0f} ms/step",
                  flush=True)
        if manager and (i + 1) % args.ckpt_every == 0:
            save(i + 1)
    if manager:
        save(args.steps)
        if rank == 0:
            manager.wait()
        dist.barrier()
    if rank == 0:
        print("done")
    return {"start": start, "steps": args.steps, "losses": [float(v) for v in losses]}


if __name__ == "__main__":
    main()
