"""Production-mesh dry-run (the JAX package's ``launch/dryrun.py``): one
rank's step of every (arch x shape x mesh) cell, counted, with no device.

The reference lowers and compiles each cell's jitted step for 512
placeholder host devices (``XLA_FLAGS=--xla_force_host_platform_device_count``)
and reads XLA's cost and memory analyses and the HLO's collectives. The
port runs the step itself, eagerly, on ``meta`` tensors:

* **placeholder ranks:** torch's ``fake`` process group
  (``torch.testing._internal.distributed.fake_pg.FakeStore``) at 256 or
  512 ranks, this process rank 0; the training mesh
  (``distributed.mesh.make_train_mesh``) is built over it, and its
  ``all_gather`` / ``all_reduce`` calls on ``meta`` tensors run through it
  and move nothing;
* **the step:** train cells run ``distributed.fsdp``'s sharded step on
  rank 0's ``meta`` slices (parameters and AdamW state under
  ``param_specs`` / ``opt_state_specs``, its rows of the batch); prefill
  and decode cells run ``fsdp.make_sharded_serve_steps`` over the same
  parameter slices, on rank 0's rows, the decode state held under
  ``cache_specs``. Rank 0 computes only its share of each layer: its query
  heads, its ``d_ff`` slice, its experts, its rows of the vocabulary and
  its Mamba1 channels or Mamba2 heads (every rank computes Mamba2's B and
  C), combined over the ``model`` group. A cache whose sequence lies on
  ``model`` (fewer KV heads than ranks) and Mamba2's conv state are
  gathered over ``model`` for the decode step;
* **FLOPs:** ``torch.utils.flop_counter.FlopCounterMode`` (recomputation
  under ``cfg.remat`` included);
* **bytes accessed:** the input and output bytes of every dispatched
  operator (views and collectives excluded), counted by a
  ``TorchDispatchMode``. Eager PyTorch fuses nothing, so this is the
  traffic eager PyTorch really issues, where XLA's figure is after fusion;
* **temp_bytes:** the peak of live bytes allocated during the step (the
  same mode: each non-aliasing output counted until it is freed);
* **collectives:** ``distributed.comm``'s counts (``launch/hlo.py``).

No probes: the reference's ``_probe_cost`` / ``_extrapolate`` correct XLA
counting a ``lax.scan`` body once; the port's Python loop runs every layer,
so the counts are whole. The record says so (``probe_corrected`` true,
``cost_raw_scanned`` equal to ``cost``).

``run_udg_serving_cell`` cannot run on ``meta``: the serving loop ends on
the data (it reads the device's state each block) and its kernels are
CUDA-only. Its cost is analytic: one iteration's bytes and operations from
the kernel table's bound model (``kernels/bounds.py``, which
``chip_smoke.py`` charges each kernel with) for B1 (the packed scorer, at
the FP32 rate) and B2 (the beam merge, at the compare rate), times the
expected ``beam`` expansions, plus the merge's collective bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape decode_32k --mesh single --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, ModelConfig, get_config, shape_supported
from repro_torch.configs.registry import ARCH_NAMES
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import batch_spec, local_shard
from repro_torch.kernels import bounds
from repro_torch.launch import hlo as hlo_lib
from repro_torch.launch import roofline as roof_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_decode_state, init_params_shapes, param_count
from repro_torch.train import adamw

S32 = torch.int32
META = torch.device("meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of one cell (global shapes).

    train:   {tokens, labels}            [GB, S](, K) int32
    prefill: {tokens}                    [GB, S](, K) int32
    decode:  {tokens [GB, 1](, K), pos [GB]} (+ the decode state, built
             separately because its structure is family-dependent)
    """
    sh = SHAPES[shape_name]
    tok_shape: Tuple[int, ...] = (sh.global_batch, sh.seq_len)
    if sh.kind == "decode":
        tok_shape = (sh.global_batch, 1)
    if cfg.num_codebooks > 1:
        tok_shape = tok_shape + (cfg.num_codebooks,)
    specs = {"tokens": torch.empty(tok_shape, dtype=S32, device=META)}
    if sh.kind == "train":
        specs["labels"] = torch.empty(tok_shape, dtype=S32, device=META)
    if sh.kind == "decode":
        specs["pos"] = torch.empty((sh.global_batch,), dtype=S32, device=META)
    return specs


def _active_params(cfg: ModelConfig, total: int) -> int:
    if not cfg.is_moe:
        return total
    mats = 3 if cfg.mlp_type == "swiglu" else 2
    per_expert = cfg.d_model * cfg.d_ff_expert * mats
    dead = cfg.num_layers * (cfg.num_experts - cfg.top_k) * per_expert
    return total - dead


def _cell_unit(cfg: ModelConfig) -> int:
    """Smallest depth (in layers) that preserves the superblock structure."""
    if cfg.is_hybrid:
        return cfg.hybrid_every
    if cfg.attn_pattern == "local_global":
        return cfg.global_every
    return 1


# --- counting --------------------------------------------------------------------------


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class CostMode(TorchDispatchMode):
    """Counts every dispatched operator: the bytes of its tensor inputs and
    outputs (``bytes``; views and collectives excluded), the live bytes of
    the tensors it allocates (an output that aliases no input, counted
    until the tensor is freed) and their peak, and bytes and calls by
    operator (``by_op``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.by_op: Dict[str, list] = defaultdict(lambda: [0, 0])

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False) or func.namespace in ("c10d", "_c10d_functional"):
            return out
        ins = sum(_nbytes(t) for t in tree_flatten((args, kwargs or {}))[0])
        outs = tree_flatten(out)[0]
        moved = ins + sum(_nbytes(t) for t in outs)
        self.bytes += moved
        rec = self.by_op[str(func)]
        rec[0] += moved
        rec[1] += 1
        rets = func._schema.returns
        if not (rets and rets[0].alias_info is not None):
            for t in outs:
                if isinstance(t, torch.Tensor):
                    n = _nbytes(t)
                    self.live += n
                    weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


def fake_world(chips: int) -> None:
    """The default process group: ``fake`` at ``chips`` ranks, this process
    rank 0 (replacing a fake group of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == chips:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=chips)


def production_mesh(multi_pod: bool):
    """The production mesh over placeholder ranks: (data 16, model 16) or
    (pod 2, data 16, model 16)."""
    from repro_torch.distributed.mesh import make_train_mesh

    spec = make_production_mesh(multi_pod=multi_pod)
    sizes = dict(zip(spec.axis_names, spec.shape))
    fake_world(math.prod(spec.shape))
    return make_train_mesh(model=sizes["model"], pod=sizes.get("pod", 1), device=META)


def _state_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_flatten(tree)[0])


def _build_step(cfg: ModelConfig, shape_name: str, mesh):
    """The cell's step on rank 0: (run() -> outputs, argument bytes,
    tokens_per_step)."""
    from repro_torch.distributed.fsdp import (make_sharded_serve_steps, make_sharded_train_step,
                                              shard_cache, state_specs)

    sh = SHAPES[shape_name]
    ins = input_specs(cfg, shape_name)
    opt = adamw(lr=3e-4)
    shard_state, step = make_sharded_train_step(cfg, opt, mesh)
    state = shard_state(init_params_shapes(cfg))
    coord = mesh.coord

    def local_bytes(t):
        return _nbytes(local_shard(t, batch_spec(mesh, t.shape), mesh, coord))

    if sh.kind == "train":
        batch = {"tokens": ins["tokens"], "labels": ins["labels"]}
        args = _state_bytes(state) + sum(local_bytes(t) for t in batch.values())
        return (lambda: step(state, batch)), args, sh.global_batch * sh.seq_len
    shards = state["params"]
    del state["opt"]
    prefill, decode = make_sharded_serve_steps(cfg, mesh)
    tokens = ins["tokens"]
    if sh.kind == "prefill":
        cspecs = state_specs(cfg, mesh, sh.global_batch, sh.seq_len)
        return ((lambda: prefill(shards, tokens, cspecs)),
                _state_bytes(shards) + local_bytes(tokens), sh.global_batch * sh.seq_len)
    cspecs = state_specs(cfg, mesh, sh.global_batch, sh.seq_len, ring_local=cfg.ring_local)
    cache = shard_cache(init_decode_state(cfg, sh.global_batch, sh.seq_len,
                                          ring_local=cfg.ring_local, device=META), cspecs, mesh)
    pos = ins["pos"]
    args = _state_bytes(shards) + _state_bytes(cache) + local_bytes(tokens) + local_bytes(pos)
    return (lambda: decode(shards, cache, cspecs, tokens, pos)), args, sh.global_batch


def measure(run) -> Dict:
    """One call of ``run`` counted: flops, bytes, peak live bytes,
    collectives, output bytes, operator breakdown, wall seconds."""
    comm.reset_counts()
    t0 = time.perf_counter()
    with CostMode() as cm, FlopCounterMode(display=False) as fc:
        out = run()
    return {"flops": float(fc.get_total_flops()), "bytes": float(cm.bytes), "peak": cm.peak,
            "coll": hlo_lib.collective_bytes(comm.counts()), "out_bytes": _state_bytes(out),
            "by_op": dict(cm.by_op), "seconds": time.perf_counter() - t0}


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    ring_local: bool = False,
    remat: Optional[str] = None,
    gather_weights: bool = False,
    ssm_impl: Optional[str] = None,
    extra_tag: str = "",
) -> Dict:
    """Run and count one (arch x shape x mesh) cell; return the record."""
    cfg = get_config(arch)
    repl = {}
    if remat is not None:
        repl["remat"] = remat
    if gather_weights:
        repl["gather_weights"] = True
    if ssm_impl:
        repl["ssm_impl"] = ssm_impl
    if ring_local:
        repl["ring_local"] = True
    if repl:
        cfg = dataclasses.replace(cfg, **repl)
    sh = SHAPES[shape_name]
    spec = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = math.prod(spec.shape)
    rec: Dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "kind": sh.kind, "ok": False, "tag": extra_tag,
    }
    ok, why = shape_supported(cfg, shape_name)
    if not ok:
        rec["skipped"] = why
        return rec
    t0 = time.perf_counter()
    try:
        n_params = param_count(init_params_shapes(cfg))
        mesh = production_mesh(multi_pod)
        run, arg_bytes, tokens = _build_step(cfg, shape_name, mesh)
        t_build = time.perf_counter() - t0
        m = measure(run)
        cost = {"flops": m["flops"], "bytes accessed": m["bytes"]}
        coll = m["coll"]
        terms = roof_lib.derive(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            cost=cost, coll=coll, kind=sh.kind, n_params=n_params,
            n_active_params=_active_params(cfg, n_params), tokens=tokens,
        )
        rec.update(
            ok=True,
            lower_s=round(t_build, 1),
            compile_s=round(m["seconds"], 1),
            probe_s=0.0,
            probe_corrected=True,
            probe_note="eager: the Python loop runs every layer, no scan body to correct",
            n_params=n_params,
            n_active_params=_active_params(cfg, n_params),
            tokens_per_step=tokens,
            memory={
                "argument_bytes": arg_bytes,
                "output_bytes": m["out_bytes"],
                "temp_bytes": m["peak"],
                "code_bytes": 0,
            },
            cost=cost,
            cost_raw_scanned=dict(cost),
            collectives=coll,
            collectives_raw_scanned=dict(coll),
            roofline=terms.as_dict(),
        )
    except Exception as e:  # recorded, not raised: failures are bugs to fix
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


# --- the UDG serving cell ------------------------------------------------------------------

# bytes an element of the table's rows
_ELT = {"f32": 4, "bf16": 2, "int8": 1}


def udg_serving_cost(*, n_l: int, d: int, E: int, B: int, k: int, beam: int, shards: int,
                     vec_dtype: str, merge: str) -> Dict:
    """One device's search of its ``B`` queries over its shard, from the
    kernel table's bound model (``kernels/bounds.py``, the one
    ``chip_smoke.py`` charges each kernel's run with), over ``beam``
    iterations. Each iteration is one call of B1
    (``filter_dist_gather_packed``, one expanded node a query, ``E``
    slots) and one of B2 (``beam_merge`` with the visited bits fused, as
    the search loop calls it), counted at the bound's upper end: every
    slot live and kept, no row, label or visited word shared between
    slots, and every beam entry reaching the output. B1's operations run
    at the FP32 rate and B2's compares at the compare rate, so the
    compute time is their sum at those rates (``compute_s``). Collectives:
    the merge of the shards' top-k (ids and distances, 8 bytes an entry):
    one ``all_gather`` over ``model``, or ``log2(shards)`` tournament
    rounds of ``collective-permute``."""
    L = beam
    b1_bytes = bounds.scorer_bytes(
        slots=B * E, labels=B * E, label_bytes=8, words=B * E, rows_read=B * E,
        row_bytes=bounds.row_bytes(d, _ELT[vec_dtype], vec_dtype == "int8"),
        queries=B, per_query=d * 4 + 8 + 4)
    b1_ops = bounds.scorer_ops(B * E, d)
    # live candidate ids, and beam ids and expanded flags, read whole
    b2_bytes = bounds.merge_bytes(B=B, L=L, C=E, sector_bytes=B * E * 4 + B * L * 5,
                                  words=B * E)
    b2_ops = bounds.merge_ops(B=B, L=L, C=E, live=B * E)
    compute_s = beam * (b1_ops / bounds.FP32_OPS_PER_S + b2_ops / bounds.CMP_OPS_PER_S)
    entry = B * k * 8
    if merge == "tournament":
        rounds = max(1, math.ceil(math.log2(shards)))
        coll = {"collective-permute": entry * rounds, "collective-permute_count": 2 * rounds}
    else:
        coll = {"all-gather": entry, "all-gather_count": 2}
    coll["total"] = sum(v for kk, v in coll.items() if not kk.endswith("_count"))
    return {"per_iter": {"b1_bytes": b1_bytes, "b1_ops": b1_ops, "b2_bytes": b2_bytes,
                         "b2_ops": b2_ops,
                         "b1_bound_ms": bounds.bound(b1_bytes, b1_ops, bounds.FP32_OPS_PER_S)[0],
                         "b2_bound_ms": bounds.bound(b2_bytes, b2_ops, bounds.CMP_OPS_PER_S)[0]},
            "cost": {"flops": float(beam * (b1_ops + b2_ops)),
                     "bytes accessed": float(beam * (b1_bytes + b2_bytes))},
            "compute_s": compute_s, "coll": coll}


def run_udg_serving_cell(
    multi_pod: bool,
    *,
    merge: str = "all_gather",
    vec_dtype: str = "f32",
    beam: int = 64,
    degree: int = 96,
) -> Dict:
    """Dry-run the distributed UDG serving step at production scale.

    Database: 16.7M vectors x 768 dims sharded over the model axis (65k per
    shard), padded degree E, batch 4096 queries over the data(/pod) axes.
    Analytic (the module's docstring): each iteration expands one beam slot
    a query, and the search ends once every slot is expanded, so ``beam``
    iterations."""
    spec = make_production_mesh(multi_pod=multi_pod)
    sizes = dict(zip(spec.axis_names, spec.shape))
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = math.prod(spec.shape)
    tag = f"{merge}.{vec_dtype}.b{beam}.E{degree}"
    rec: Dict = {
        "arch": "udg-serve", "shape": "serve_16M", "mesh": mesh_name,
        "chips": chips, "kind": "serve", "ok": False, "tag": tag,
    }
    try:
        if vec_dtype not in _ELT or merge not in ("all_gather", "tournament"):
            raise ValueError(f"vec_dtype {vec_dtype!r}, merge {merge!r}")
        shards = sizes["model"]
        n_l, d, E, B, k = 65536, 768, degree, 4096, 10
        b_local = B // (chips // shards)
        c = udg_serving_cost(n_l=n_l, d=d, E=E, B=b_local, k=k, beam=beam, shards=shards,
                             vec_dtype=vec_dtype, merge=merge)
        elt = _ELT[vec_dtype]
        arg_bytes = (n_l * d * elt + n_l * E * 4 + n_l * E * 8 + n_l * 4 + 5 * n_l * 4 + 4
                     + b_local * (d + 2) * 4 + (n_l * 4 if vec_dtype == "int8" else 0))
        terms = roof_lib.derive(
            arch="udg-serve", shape="serve_16M", mesh=mesh_name, chips=chips,
            cost=c["cost"], coll=c["coll"], kind="serve", n_params=0, n_active_params=0,
            tokens=B, compute_s=c["compute_s"],
        )
        rec.update(
            ok=True, compile_s=0.0, probe_corrected=True, expected_iters=beam,
            analytic=True, queries_per_device=b_local, per_iter=c["per_iter"],
            memory={"argument_bytes": arg_bytes, "output_bytes": b_local * k * 8,
                    "temp_bytes": b_local * (2 * beam + E) * 8, "code_bytes": 0},
            cost=c["cost"], cost_raw_scanned=dict(c["cost"]), collectives=c["coll"],
            roofline=terms.as_dict(),
        )
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or 'udg-serve'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--ring-local", action="store_true")
    ap.add_argument("--gather-weights", action="store_true")
    ap.add_argument("--ssm-impl", default=None, choices=[None, "scan", "ssd"])
    ap.add_argument("--remat", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--merge", default="all_gather")
    ap.add_argument("--vec-dtype", default="f32", choices=["f32", "bf16", "int8"])
    ap.add_argument("--beam", type=int, default=64)
    ap.add_argument("--degree", type=int, default=96)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    for arch in archs:
        for multi in meshes:
            mesh_name = "pod2x16x16" if multi else "pod16x16"
            if arch == "udg-serve":
                rec = run_udg_serving_cell(
                    multi, merge=args.merge, vec_dtype=args.vec_dtype,
                    beam=args.beam, degree=args.degree,
                )
                fn = (f"{args.out}/udg-serve.{rec['tag']}.{mesh_name}.json")
                with open(fn, "w") as f:
                    json.dump(rec, f, indent=1)
                status = "OK" if rec["ok"] else ("SKIP" if "skipped" in rec else "FAIL")
                print(f"[{status}] udg-serve {args.merge} {mesh_name} "
                      f"compile={rec.get('compile_s', '-')}s", flush=True)
                continue
            for shape in shapes:
                rec = run_cell(
                    arch, shape, multi,
                    ring_local=args.ring_local,
                    remat=args.remat, gather_weights=args.gather_weights,
                    ssm_impl=args.ssm_impl, extra_tag=args.tag,
                )
                tag = f".{args.tag}" if args.tag else ""
                fn = f"{args.out}/{arch}.{shape}.{mesh_name}{tag}.json"
                with open(fn, "w") as f:
                    json.dump(rec, f, indent=1)
                status = "OK" if rec["ok"] else ("SKIP" if "skipped" in rec else "FAIL")
                print(
                    f"[{status}] {arch} {shape} {mesh_name} "
                    f"compile={rec.get('compile_s', '-')}s "
                    f"{rec.get('error', '')[:120]}",
                    flush=True,
                )
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
