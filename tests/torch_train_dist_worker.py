"""The port's distributed training on gloo ranks, for ``test_torch_train_dist.py``.

    python tests/torch_train_dist_worker.py WORKDIR

Spawns ``WORLD`` ranks (``torch.multiprocessing``) joined in a gloo process
group through a file store in ``WORKDIR``. Each rank, in turn:

* ``compressed_psum`` on its slice of ``psum_inputs()``, two rounds;
* ``make_dp_train_step`` over data 4: ``DP_STEPS`` steps of the f32 SMOKE
  llama3.2-1b from ``WORKDIR/init.npz`` (the reference's parameters,
  carried across by the test) with and without compression, and of the
  bf16 SMOKE config from ``init_params(seed=0)``;
* ``ElasticRunner`` on the toy quadratic, 4 ranks down to 2 at
  ``FAIL_AT`` (ranks 2 and 3 leave);
* ``make_sharded_train_step``: ``FSDP_STEPS`` f32 steps of each of
  ``FSDP_ARCHS`` at each of ``FSDP_LAYOUTS`` from
  ``WORKDIR/fsdp_init_<arch>.npz`` (the reference's parameters, carried
  across by the test), with this rank's slice bytes beside the leaf's
  bytes over its spec's slices, the gathered parameters, and this rank's
  FLOPs in the first step (``FlopCounterMode``);
* ``make_sharded_serve_steps`` at each of ``SERVE_LAYOUTS``: the prefill
  of ``serve_tokens``' first ``SERVE_PROMPT`` positions and
  ``SERVE_NEW`` decode steps on a state sized for prompt + new tokens
  (the prefill's cache gathered, copied into its first positions and
  sliced again), each step's logits gathered whole, and the decode
  steps' collectives by tag (``comm.LOG``);
* each of ``SCAN_CASES`` (zamba2 with ``ssm_impl="ssd"``, the chunked SSD
  scan on each rank's heads, and falcon-mamba's scan on each rank's
  channels, both chunked by 8, so that the split scans carry their state
  across chunks) at data 1 x model 4: one sharded step's loss and grad
  norm and the sharded prefill's logits of ``serve_tokens``' first
  ``SERVE_PROMPT`` positions, gathered whole;
* ``launch.train.main`` with ``WORLD_SIZE`` set, data 2 x model 2, its
  ``get_config`` giving the f32 SMOKE config (rank 0 keeps its step-4
  checkpoint's arrays).

Writes ``rank{r}.npz`` into ``WORKDIR``. The constants and input makers are
shared with ``torch_train_dist_ref.py`` (the JAX package's side) and the
test.
"""
import contextlib
import dataclasses
import os
import sys

import numpy as np

WORLD = 4
SHARD_CASES = (
    ((8, 12, 4), (("pod", "data"), "model")),
    ((8, 12, 4), ("model", ("pod", "data"))),
    ((8, 12, 4), (None, "data", "model")),
    ((8, 12, 4), ("pod", None, ("data", "model"))),
    ((8, 12, 4), (("data", "pod"),)),
    ((8, 12, 4), ()),
)
DP_STEPS, DP_LR = 8, 1e-3
FAIL_AT = 17
FSDP_ARCHS = ("llama3.2-1b", "moonshot-v1-16b-a3b", "falcon-mamba-7b", "zamba2-2.7b")
FSDP_LAYOUTS = {"data2_model2": dict(model=2, pod=1), "pod2_data2": dict(model=1, pod=2),
                "data1_model4": dict(model=4, pod=1)}
FSDP_STEPS, FSDP_LR, FSDP_BATCH, FSDP_SEQ = 3, 3e-4, 8, 32
# the sharded prefill + decode; 64 rows a data rank fill whole MoE groups (moonshot's
# SMOKE ``moe_group``), as the one-process step groups them
SERVE_LAYOUTS = ("data2_model2", "data1_model4")
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 128, 16, 4
# config changes of the scan cases, run at data 1 x model 4: FSDP_SEQ and
# SERVE_PROMPT span several chunks of 8
SCAN_CASES = {"ssd": ("zamba2-2.7b", dict(ssm_impl="ssd", ssm_chunk=8)),
              "mamba1_chunked": ("falcon-mamba-7b", dict(ssm_chunk=8))}
LAUNCH = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "4", "--batch", "4",
          "--seq", "16", "--ckpt-every", "2"]


def psum_inputs():
    """Per-rank gradients and residuals: {leaf: [WORLD, ...]} each."""
    rng = np.random.default_rng(7)
    grads = {"a": rng.normal(size=(WORLD, 16, 8)).astype(np.float32),
             "b": (rng.normal(size=(WORLD, 33)) * 1e-3).astype(np.float32)}
    grads["a"][1] *= 5.0                     # ranks with different scales
    resid = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32) for k, v in grads.items()}
    return grads, resid


def dp_batch(cfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def elastic_inputs():
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4,)).astype(np.float32)
    batches = [{"x": rng.normal(size=(8, 4)).astype(np.float32),
                "y": rng.normal(size=(8,)).astype(np.float32)} for _ in range(30)]
    return w0, batches


def fsdp_batches(cfg):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(FSDP_STEPS):
        tokens = rng.integers(0, cfg.vocab_size, (FSDP_BATCH, FSDP_SEQ)).astype(np.int32)
        out.append({"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)})
    return out


def serve_tokens(cfg):
    """[SERVE_BATCH, SERVE_PROMPT + SERVE_NEW] (, K) token ids."""
    rng = np.random.default_rng(13)
    shape = (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW) + (
        (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int64)


def copy_prefix(dst, src, n):
    """A prefill state ``src`` into the first ``n`` positions of a decode
    state ``dst`` (the SSM leaves whole)."""
    for k, v in src.items():
        if isinstance(v, dict):
            copy_prefix(dst[k], v, n)
        elif k in ("k", "v"):
            dst[k][..., :n, :, :].copy_(v)
        else:
            dst[k].copy_(v)


def f32_smoke(arch):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def psum_part(rank, out):
    import torch
    from repro_torch.distributed.compression import compressed_psum

    grads, resid = psum_inputs()
    g = {k: torch.as_tensor(v[rank]) for k, v in grads.items()}
    r = {k: torch.as_tensor(v[rank]) for k, v in resid.items()}
    for rnd in range(2):
        means, r = compressed_psum(g, r)
        for k in g:
            out[f"psum/{rnd}/{k}/mean"] = means[k].numpy()
            out[f"psum/{rnd}/{k}/resid"] = r[k].numpy()


def load_model(cfg, path):
    """The port's model of ``cfg`` holding the parameters saved at ``path``
    (by name)."""
    import torch
    from repro_torch.models import LM

    model = LM(cfg, device="meta").to_empty(device="cpu")
    with np.load(path) as z, torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.as_tensor(z[n]))
    return model


def toy_dp(cfg, workdir, mesh, compress, lr, seed=None):
    from repro_torch.models import init_params
    from repro_torch.train import adamw
    from repro_torch.train.dp_trainer import make_dp_train_step

    if seed is None:
        model = load_model(cfg, os.path.join(workdir, "init.npz"))
    else:
        model = init_params(cfg, seed=seed, device="cpu")
    init_state, step = make_dp_train_step(cfg, adamw(lr=lr), mesh, compress_grads=compress)
    state = init_state(model)
    losses = []
    for _ in range(DP_STEPS):
        state, m = step(state, dp_batch(cfg))
        losses.append(float(m["loss"]))
    return np.array(losses)


def dp_part(rank, workdir, out):
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_train_mesh

    mesh = make_train_mesh(model=1, device="cpu")
    assert mesh.shape == (WORLD, 1) and mesh.coord == {"data": rank, "model": 0}
    for compress in (False, True):
        out[f"dp/{int(compress)}"] = toy_dp(f32_smoke("llama3.2-1b"), workdir, mesh, compress, DP_LR)
        out[f"dp_bf16/{int(compress)}"] = toy_dp(get_config("llama3.2-1b", smoke=True), workdir,
                                                 mesh, compress, DP_LR, seed=0)


def elastic_part(rank, workdir, out):
    import torch
    from repro_torch.distributed import comm, make_train_mesh
    from repro_torch.distributed.elastic import ElasticRunner
    from torch.utils._pytree import tree_map
    from repro_torch.distributed.sharding import P, local_shard
    from repro_torch.train import CheckpointManager, adamw

    opt = adamw(lr=0.1, weight_decay=0.0)

    def make_step(mesh):
        def step(state, batch):
            rows = P("data")
            x = local_shard(torch.as_tensor(batch["x"]), rows, mesh, mesh.coord)
            y = local_shard(torch.as_tensor(batch["y"]), rows, mesh, mesh.coord)
            w = state["params"]["w"].requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(torch.mean((x @ w - y) ** 2), [w])
            group = mesh.group("data")
            comm.all_reduce(g, group)
            g.div_(torch.distributed.get_world_size(group))
            opt.update({"w": g}, state["opt"], state["params"])
            return state
        return step

    w0, batches = elastic_inputs()
    w0 = {"w": torch.as_tensor(w0)}
    state = {"params": w0, "opt": opt.init(w0)}
    runner = ElasticRunner(
        ckpt=CheckpointManager(os.path.join(workdir, "elastic"), keep=2),
        make_mesh=lambda n: make_train_mesh(ranks=range(n), device="cpu"),
        make_step=make_step, state_specs=lambda mesh: tree_map(lambda _: P(), state),
        ckpt_every=5)
    state, steps, restarts = runner.run(state, batches, n_devices=WORLD, fail_at=FAIL_AT,
                                        recover_devices=WORLD // 2)
    out["elastic/steps_restarts_left"] = np.array([steps, restarts, state is None])
    if state is not None:
        out["elastic/w"] = state["params"]["w"].detach().numpy()


def fsdp_part(rank, workdir, out):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import make_train_mesh
    from repro_torch.distributed.fsdp import make_sharded_train_step
    from repro_torch.distributed.sharding import opt_state_specs, spec_size
    from repro_torch.train import adamw

    for arch in FSDP_ARCHS:
        cfg = f32_smoke(arch)
        for layout, kw in FSDP_LAYOUTS.items():
            key = f"fsdp/{arch}/{layout}"
            mesh = make_train_mesh(device="cpu", **kw)
            shard_state, step = make_sharded_train_step(cfg, adamw(lr=FSDP_LR), mesh)
            model = load_model(cfg, os.path.join(workdir, f"fsdp_init_{arch}.npz"))
            state = shard_state(model)
            ospecs = opt_state_specs(state["opt"], step.specs)
            got, want = [], []
            for tree, specs in ((state["params"], step.specs), (state["opt"].mu, ospecs.mu),
                                (state["opt"].nu, ospecs.nu), (state["opt"].master, ospecs.master)):
                for n, t in tree.items():
                    full = dict(model.named_parameters())[n]
                    got.append(t.numel() * t.element_size())
                    want.append(full.numel() * t.element_size() // spec_size(mesh, specs[n]))
            out[f"{key}/shard_bytes"] = np.array(got)
            out[f"{key}/whole_over_slices"] = np.array(want)
            metrics = []
            for i, batch in enumerate(fsdp_batches(cfg)):
                with FlopCounterMode(display=False) if i == 0 else contextlib.nullcontext() as fc:
                    state, m = step(state, batch)
                if i == 0:
                    out[f"{key}/flops"] = np.array(fc.get_total_flops(), np.float64)
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
            out[f"{key}/metrics"] = np.array(metrics)
            params, _ = step.unshard(state)
            if rank == 0:
                for n, t in params.items():
                    out[f"{key}/param/{n}"] = t.numpy()


def serve_part(rank, workdir, out):
    import torch
    from repro_torch.distributed import comm, fsdp, make_train_mesh
    from repro_torch.distributed.sharding import logits_spec, param_specs
    from repro_torch.models import init_decode_state

    S, B = SERVE_PROMPT, SERVE_BATCH
    for arch in FSDP_ARCHS:
        cfg = f32_smoke(arch)
        model = load_model(cfg, os.path.join(workdir, f"fsdp_init_{arch}.npz"))
        toks = serve_tokens(cfg)
        for layout in SERVE_LAYOUTS:
            mesh = make_train_mesh(device="cpu", **FSDP_LAYOUTS[layout])
            named = dict(model.named_parameters())
            shards = fsdp.shard_tree(named, param_specs(named, cfg, mesh), mesh)
            prefill, decode = fsdp.make_sharded_serve_steps(cfg, mesh)
            prompt_specs = fsdp.state_specs(cfg, mesh, B, S)
            logits, cache = prefill(shards, toks[:, :S], prompt_specs)
            state = init_decode_state(cfg, B, S + SERVE_NEW, device="cpu")
            copy_prefix(state, fsdp.gather_cache(cache, prompt_specs, mesh), S)
            specs = fsdp.state_specs(cfg, mesh, B, S + SERVE_NEW)
            state = fsdp.shard_cache(state, specs, mesh)
            steps = [logits]
            comm.LOG = []
            try:
                for i in range(SERVE_NEW):
                    logits, state = decode(shards, state, specs, toks[:, S + i:S + i + 1],
                                           torch.full((B,), S + i))
                    steps.append(logits)
                log = comm.LOG
            finally:
                comm.LOG = None
            out[f"serve/{arch}/{layout}/decode_collectives"] = np.array(
                [f"{kind} {tag}" for kind, _, tag in log])
            whole = [fsdp.gather(t, logits_spec(mesh, (B,) + tuple(t.shape[1:-1])
                                                + (cfg.vocab_size,)), mesh).numpy() for t in steps]
            if rank == 0:
                out[f"serve/{arch}/{layout}"] = np.stack(whole)


def scan_config(name):
    arch, changes = SCAN_CASES[name]
    return dataclasses.replace(f32_smoke(arch), **changes)


def scan_part(rank, workdir, out):
    from repro_torch.distributed import fsdp, make_train_mesh
    from repro_torch.distributed.sharding import logits_spec
    from repro_torch.train import adamw

    mesh = make_train_mesh(device="cpu", **FSDP_LAYOUTS["data1_model4"])
    for name, (arch, _) in SCAN_CASES.items():
        cfg = scan_config(name)
        model = load_model(cfg, os.path.join(workdir, f"fsdp_init_{arch}.npz"))
        shard_state, step = fsdp.make_sharded_train_step(cfg, adamw(lr=FSDP_LR), mesh)
        state = shard_state(model)
        prefill, _ = fsdp.make_sharded_serve_steps(cfg, mesh)
        toks = serve_tokens(cfg)[:, :SERVE_PROMPT]
        logits, _ = prefill(state["params"], toks,
                            fsdp.state_specs(cfg, mesh, SERVE_BATCH, SERVE_PROMPT))
        whole = fsdp.gather(logits, logits_spec(mesh, (SERVE_BATCH, cfg.vocab_size)), mesh)
        _, m = step(state, fsdp_batches(cfg)[0])
        out[f"{name}/metrics"] = np.array([float(m["loss"]), float(m["grad_norm"])])
        out[f"{name}/prefill"] = whole.numpy()


def launcher_part(rank, workdir, out):
    from repro_torch.launch import train as launcher

    os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank), LOCAL_RANK=str(rank))
    launcher.get_config = lambda arch, smoke=False: f32_smoke(arch)     # f32 losses, as the test's
    res = launcher.main(LAUNCH + ["--model-parallel", "2",
                                  "--ckpt-dir", os.path.join(workdir, "launch")])
    out["launch/losses"] = np.array(res["losses"])
    if rank == 0:
        with np.load(os.path.join(workdir, "launch", "step_0000000004", "arrays.npz")) as z:
            out.update({f"launch/ckpt/{k}": z[k] for k in z.files})


def rank_main(rank, workdir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=WORLD,
                            rank=rank)
    out = {}
    try:
        psum_part(rank, out)
        dp_part(rank, workdir, out)
        elastic_part(rank, workdir, out)
        fsdp_part(rank, workdir, out)
        serve_part(rank, workdir, out)
        scan_part(rank, workdir, out)
        launcher_part(rank, workdir, out)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def main(workdir):
    import torch.multiprocessing as mp

    mp.start_processes(rank_main, args=(workdir,), nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1])
