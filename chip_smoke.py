#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py [--n N] [--profile] [--out DIR] [--form NAME=SOURCE ...]

Phases, each of which exits non-zero when it fails. Every path phase sets the
kernel launch counts to 0 just before it and reads them just after:

1. card: requires CUDA; prints ``nvidia-smi``'s name and power limit;
2. build: compiles the port's CUDA kernels (``src/repro_torch/kernels/csrc``)
   with nvcc for sm_90a, one process per source, all at once;
3. index: a seeded synthetic corpus at the serving deployment's shard
   (``configs/udg_serve``: d=768, containment), built by
   ``build_index(batched=None, device="cuda")`` -- the wave constructor, its
   broad searches on the card (B3) -- with M=16, Z=128, K_p=8, and exported
   to the card;
4. constructor parity: at a small size (2048 x 128, M=8, Z=32, K_p=4,
   wave=128) the wave build on the card and on the CPU give identical graphs,
   and the wave graph's recall@10 is within 0.5 pt of the sequential graph's;
5. kernels: each kernel against its plain PyTorch version on the card, at the
   paths' shapes (B=4096, the export's E, M in {1, 2}, L in {64, 128}, brute
   C=256, f32 and int8 tables; the wave constructor's broad search, B=256,
   C=512; the unfused scorer on the dense [B, E, D] pre-gather; the distance
   matrices at ``bench_kernels.py``'s shapes and one 4096 x 4096 x 768 block,
   f32, int8 and f16) and on edge cases, then timed with CUDA events beside
   its plain version, its bound and, where one exists, a library call:
   ``ms`` times single calls (``time_ms``), ``queued_ms`` the device time of
   calls queued behind one another with the L2 flushed before each
   (``queued_ms``). B2 also with the visited bits fused (``fused_queued_ms``;
   the bitmap after the call held against ``ref.set_bits``), on the
   scorer's output (L 64, C 720), with that beam shuffled, and on a dense
   wide merge (L 128, C 1440); untimed at L 7, 32, 200, 300, 600 and 1100
   (each of the kernel's instances, and its chunked selection). B3 also at
   the streaming delta scan's shape (the batch against n/8 delta slots, the
   broadcast rectangles materialized), beside its re-read floor.
   ``--form`` builds other sources of
   ``filter_dist.cu`` or ``beam_merge.cu`` and holds and times them on the
   same inputs beside the committed one;
6. main path: ``execute_batch(plan="auto")`` over 4096-query batches with
   selectivities that give every plan rows, plus one ``plan="brute"`` batch;
   B1-B3 must have launched there; QPS, latency, plan mix, recall@10
   against exact ground truth. Then, outside the counted run, the auto
   batch with ``stats=True`` (``main_path_stats``: the same results,
   launches and host syncs; per plan the share of rows cut by the iteration
   cap; the batch time with the counters on over off), B2 on the
   loop's own inputs (``beam_merge_loop``: iterations 1, 8, 32 and the last
   of the graph and the wide search, bitwise, timed, with B2's launches by
   search) and, with ``--form``, the same batch in turns with the
   committed kernels and each form's, which must give the same results;
7. unfused path: ``execute_batch(plan="auto", fused=False)`` and
   ``batched_udg_search(fused=False)`` on the same batch: B4 must launch, ids
   equal the fused path's under the tie rule;
8. int32 path: ``search_core`` over the export's int32 labels: B3 must
   launch, ids and distances equal the packed path's;
9. distance matrices: exact distances of 1024 queries to the corpus through
   ``ops.l2dist`` (B5) and to its int8 copy through ``ops.int8_l2dist`` (B6);
   the exact filtered top-10 equals the host ground truth under the tie rule;
   both matrices are then held against their plain versions, and both
   kernels timed, at this shape;
10. parity: 64 of the main path's queries on the CPU (plain versions) and on
    the card, held equal under the tie rule of ``repro_torch.data.parity``;
    then 8 of them at beam 300, whose wide search (L 600) takes B2's chunked
    selection;
11. streaming (``stream_phase``): a ``StreamingIndex`` at the shard's shape
    (node capacity n, delta capacity n/8) loaded with 3n/16 objects through
    ``insert`` (a compaction each time the delta fills), snapshotted, then
    n/32 inserts and 1 % deletes through a ``WriteAheadLog(sync="always")``;
    4096 queries with ``plan`` auto, graph and wide (B1-B3 must launch on
    each), the acknowledged inserts read back, no deleted id returned,
    ``recover`` bit-equal, card against CPU, ``fused=False`` (B4), and an
    epoch swap built on a thread while batches are served;
12. serving (``serve_phase``): ``build_sharded_index`` with 4 round-robin
    shards of the main path's corpus (the wave constructor on the card),
    every kernel launch of one auto batch and of the unfused step held bitwise against its plain version (``held_launches``), then
    the launcher's loop (``launch.serve.serve_requests``) over the main
    path's queries with ``plan`` auto and graph and both merges (B1, B2 on
    every batch, B3 on the auto ones; the merges equal; recall, QPS, plan
    mix per shard), the auto batch on a ``data=2`` mesh bit-equal to data
    1 (B1-B3 launched on both query slices), the unfused step (B4), the stats step against each
    shard's counters, card against CPU, a one-rank NCCL process group
    bit-equal to the single-process mesh; ``StreamingServer`` over the
    streaming index (``bench_serving.py``'s 2x overload loop with its
    gates, a background compaction while it serves); a two-shard
    ``ShardedStreamingIndex`` (host merge against the stacked step, B3 on
    the delta tier, its launches held as above, ``refresh_shard``
    copy-on-write);
13. segmented (``segmented_phase``): ``build_segmented_index`` over a quarter
    of the corpus (up to 16 segments, int8, the wave constructor on the card), then
    routed 4096-query batches with ``plan`` auto, graph, wide and brute (B1,
    B2 on every batch, B3 on auto): one dispatch a batch whatever the routed
    mix (B1 once an iteration, B2 once an iteration plus one fold), the
    scheduler bit-equal to the per-segment loop, ``fused=False`` (B4), every
    launch of one auto batch held bitwise, B2 timed on the fold's inputs,
    the host rerank tail and routing timed, card against CPU, quarantine and
    lift; the segments through ``segments_to_sharded_index`` and
    ``serve_batch`` (the primed device bundle); a ``SegmentedStreamingIndex``
    with its WALs and manifest: B1-B3 on its searches, acknowledged inserts
    read back, ``recover_segmented`` bit-equal, a segment-local stack patch,
    a corrupt snapshot quarantined and rebuilt. A quarantine or a degraded
    answer in a step that injects no fault fails the run;
14. fault injection (``fault_phase``): ``repro_torch.fault.chaos.run_chaos``
    on the card for seeds 0-4 (tiny) and seed 0 at its default sizes, every
    phase ok, B3 launched, seed 0 equal to the CPU run in every field the
    seed determines; the full-width step, taken in phases 11 and 12 before
    their index and server are dropped: ``poison_vector`` at d 768 and
    non-finite interval endpoints rejected by ``submit`` with no launch, two
    injected ``build_epoch`` failures under the serving phase's compaction
    (the old epoch answering a 4096-query auto batch bit for bit between
    them, B1-B3 launched) then its clean swap, and the streaming phase's
    directory with a torn WAL tail recovered bit for bit against a clean
    cut of the same record;
15. baselines (``baselines_phase``): ``PreFilter`` over the whole corpus
    equal to the ground truth and to the card's brute batch (B3) under the
    tie rule on 512 auto and 512 brute queries; PostFilter, ACORN and
    Hi-PNG at ``bench_main_search.py``'s parameters on 1024 rows beside UDG
    on the card: valid ids only, recall@10 by selectivity, build seconds,
    host ms a query;
16. LM serving (``lm_phase``): llama3.2-1b's ``CONFIG`` at full width and
    depth with random weights (seed 0) serves 8 prompts of 512 tokens:
    ``prefill_step``, the cache copied into ``init_decode_state(cfg, 8,
    576)``, 64 greedy ``decode_step``s, each step's logits held against
    ``forward`` over the prompt plus the fed tokens, in f32 (1e-3) and bf16
    (2e-2 of the row's max); every other architecture at full width and
    one superblock deep (``reduced``), gemma3's ring-local decode, card
    against CPU on every SMOKE config (1e-4) and on llama3.2-1b in f32
    (1e-3); B1-B6 launch no time;
17. training (``train_phase``): llama3.2-1b's ``CONFIG`` at full width and
    depth (bf16, remat "dots", random weights from seed 0) takes 8 AdamW
    steps (``cosine_lr(1e-3, warmup=2, total=8)``) over one repeated batch
    of 8 x 512: losses and grad norms finite, the first loss within 2e-2 of
    ``softmax_xent(forward)``, the last below the first; step ms, tokens/s
    beside the bound, peak bytes, one traced step; one step each under
    remat "none", "dots" and "full" (loss and grad norm within 1e-6, peak
    bytes and ms each) and one in f32; one f32 step of every SMOKE config
    on the card against the CPU (1e-4); ``launch.train.main`` for 6 steps
    with a checkpoint every 3, and 3 steps resumed to 6, equal at step 6
    (the launcher on the SMOKE config: ``reduced``); B1-B6 launch no time.
18. distributed training (``distributed_phase``), in a one-rank process
    group (NCCL for the card, gloo for the host): llama3.2-1b's ``CONFIG``
    at full width and depth takes 3 steps through
    ``distributed.fsdp.make_sharded_train_step`` (data 1 x model 1, the
    tensor-parallel code on a one-rank model group) and 3 through the
    one-process ``make_train_step`` from the same weights, deterministic
    algorithms on: loss and grad norm within 1e-6; ms, peak bytes,
    collective bytes and calls a step, the model group's (``tp``) apart;
    then two processes on the one card in a gloo group over CUDA tensors
    (NCCL refuses two ranks on one card) at data 1 x model 2: the same
    config in f32, 1 layer deep (``reduced``), 2 tensor-parallel steps
    against 2 f32 one-process steps
    (loss and grad norm within 1e-4), each rank's ms, peak bytes, FLOPs
    and ``tp`` all-reduce bytes and calls a step, and which collectives
    and dtypes gloo takes on CUDA tensors (its collectives stage through
    the host: the times say nothing about NVLink); in the same two
    processes falcon-mamba-7b (1 layer) and zamba2-2.7b (one superblock)
    at full width in f32, their Mamba blocks split over the two ranks: a
    sharded prefill and 2 decode steps, then 2 steps, against the
    one-process f32 run (logits, losses and the first grad norm within
    1e-4, the second grad norm 1e-3; each rank's FLOPs half the
    one-process step's plus Mamba2's B and C columns, within 5 %),
    each Mamba leaf's read and the ``tp`` collectives printed; ``make_dp_train_step`` for 8
    steps plain and 8 with int8 compression over phase 17's batch: both
    losses fall, the last ones within the reference test's bound; the
    ``ElasticRunner`` toy recovering from a failure at step 17 bit-equal to
    an uninterrupted run; one sharded f32 step of every SMOKE config card
    against CPU (1e-4); B1-B6 launch no time.

Prints one JSON object per line; the line before the last is the kernel
table and the last is ``{"ok": true, "device": {...}}``. Details go to
``<out>/chip_smoke.json``, nvcc's output to ``<out>/nvcc.txt`` and, with
``--profile``, device time by kernel to ``<out>/profile.json`` (``<out>``
defaults to ``build/chip_smoke``).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import models as lm  # noqa: E402
from repro_torch.configs import ARCH_NAMES as LM_ARCHS, CONFIG, get_config as get_lm_config  # noqa: E402
from repro_torch.core import build_index  # noqa: E402
from repro_torch.data import generate_queries, ground_truth, make_dataset, make_queries_vectors  # noqa: E402
from repro_torch.data.parity import mismatches  # noqa: E402
from repro_torch.data.workloads import QuerySet, recall_at_k  # noqa: E402
from repro_torch.core import EntryTable, build_udg  # noqa: E402
from repro_torch.exec import execute_batch, export_planned_graph  # noqa: E402
from repro_torch.exec.plan import PLAN_NAMES, QueryPlan, default_planner_config  # noqa: E402
from repro_torch.fault import FaultInjector, FaultSpec, InjectedFault, poison_vector, truncate_file  # noqa: E402
from repro_torch.kernels import _build, bounds, ops, ref  # noqa: E402
from repro_torch.kernels.bounds import (  # noqa: E402  (the kernel table's bound model)
    CMP_OPS_PER_S, FP32_OPS_PER_S, HBM_BYTES_PER_S, bound)
from repro_torch.search import batched as search_mod  # noqa: E402
from repro_torch.search import batched_udg_search  # noqa: E402
from repro_torch.search.batched import prepare_states, prepare_states_extended, search_core  # noqa: E402

DIM, BATCH, BEAM, K = CONFIG.dim, CONFIG.batch, CONFIG.beam, CONFIG.k
FULL_N = CONFIG.n_per_shard   # one shard of the serving deployment, the default n
TIMED_BATCHES = 5
PARITY_BUILD = dict(n=2048, d=128, M=8, Z=32, K_p=4, wave=128)   # constructor parity
L2_SHAPES = ((64, 512, 128), (256, 4096, 128), (64, 512, 768), (4096, 4096, 768))
SELECTIVITIES = (0.003, 0.01, 0.03, 0.1, 0.3)   # query i gets SELECTIVITIES[i % 5]
BRUTE_SELECTIVITY = 0.003     # <= 256 valid objects at n <= 65536
WIDE_BEAM, WIDE_BEAM_QUERIES = 300, 8   # parity at a beam wider than B2's registers
PARITY_QUERIES = 64           # card against CPU on the main path (reduced from 128)
STREAM_CPU_QUERIES = 16       # card against CPU on the streaming index (reduced from 64)
TF32_OPS_PER_S = 495e12       # H100 SXM, dense TF32 on the tensor cores (NVIDIA data sheet)
FP16_OPS_PER_S = 989e12       # H100 SXM, dense FP16 on the tensor cores (NVIDIA data sheet)
SLEEP_CYCLES_PER_CALL = 400_000   # about 0.2 ms of host time per queued call
RECORD: dict = {}
FORMS: dict = {}   # name -> another build of filter_dist.cu (--form)
MERGE_FORMS: dict = {}   # name -> another build of beam_merge.cu (--form)
FAULT: dict = {}   # the fault phase's full-width step, taken in the streaming and serving phases
FAULT_WORK = ROOT / "build" / "fault_work"


def require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def emit(obj: dict) -> None:
    RECORD.update(obj)
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warm`` calls,
    each call timed alone from an idle stream: its device time plus the host
    time it spends before its first kernel is queued (the kernel table's
    ``ms``)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


_FLUSH: dict = {}


def queued_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Device time of one call of ``fn`` with the host's share taken out:
    ``reps`` calls queued behind a sleep kernel long enough for the host to
    enqueue them all, each after a read of twice the L2's size (so the call
    finds its inputs in device memory, as the search loop finds most rows)
    and timed by its own pair of CUDA events; the median."""
    dev = torch.cuda.current_device()
    if dev not in _FLUSH:
        l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 50 << 20)
        _FLUSH[dev] = torch.ones(2 * l2 // 4, dtype=torch.int32, device="cuda")
    flush = _FLUSH[dev]
    for _ in range(warm):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    for t0, t1 in events:
        flush.sum()
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return statistics.median(t0.elapsed_time(t1) for t0, t1 in events)


def kernel_times(fn) -> dict:
    """A kernel's ``ms`` (single calls, ``time_ms``) and ``queued_ms``."""
    return {"ms": time_ms(fn), "queued_ms": queued_ms(fn)}


def reset_counts() -> None:
    ops.reset_launches()
    for key in search_mod.LOOP_STATS:
        search_mod.LOOP_STATS[key] = 0


def bitwise(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Raises unless the two f32 tensors are equal bit for bit; returns 0.0."""
    require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
            f"{what} differs from the plain version")
    return 0.0


def matrix_close(got, want, q, c) -> tuple:
    """(max abs error, its largest share of the tolerance); raises beyond
    |got - want| <= 1e-5·(|q|² + |c|²) + 1e-6 (the expanded form cancels, so
    its error follows the norms)."""
    qn = torch.sum(q.double() ** 2, dim=1)[:, None]
    cn = torch.sum(c.double() ** 2, dim=1)[None, :]
    err = (got.double() - want.double()).abs()
    share = (err / (1e-5 * (qn + cn) + 1e-6)).max().item()
    require(share <= 1.0, f"distance matrix error {err.max().item():.3g} beyond tolerance")
    return err.max().item(), share


def scorer_bound(out, open_out, cand, label_key, *, D, elt, scaled, label_bytes,
                 per_query) -> dict:
    """A scorer's bound from this run's inputs: the bytes the function must
    move, each input element read once and each output written once, against
    its multiply-adds. Every slot's id and output; the label of each slot
    with id >= 0 (``label_key`` names the distinct labels); the visited word
    of each slot that passes the label test (``open_out``: the plain version
    over an empty bitmap), each distinct (query, word) once; the row, norm
    and scale of each distinct row that is scored; ``per_query`` bytes of
    query, state and expanded ids per query; 2·D operations per distinct
    (query, row) pair that is scored.

    Beside it, and no bound: ``pair_bytes``, the bytes of a kernel that
    reads the row, norm and scale of every scored slot from device memory
    (no row shared between queries), plus every slot's id and output, and
    ``pair_floor_ms``, that traffic at the card's memory rate: the re-read
    floor of a per-query gather."""
    B, C = cand.shape
    row_of = torch.arange(B, device=cand.device)[:, None].long() << 32
    fin = torch.isfinite(out)
    labels = int(torch.unique(label_key[cand >= 0]).numel())
    words = int(torch.unique((row_of + (cand.long() >> 5))[torch.isfinite(open_out)]).numel())
    rows_read = int(torch.unique(cand[fin]).numel())
    pairs = int(torch.unique((row_of + cand.long())[fin]).numel())
    row_bytes = bounds.row_bytes(D, elt, scaled)
    nbytes = bounds.scorer_bytes(slots=B * C, labels=labels, label_bytes=label_bytes,
                                 words=words, rows_read=rows_read, row_bytes=row_bytes,
                                 queries=B, per_query=per_query)
    pair_bytes = int(fin.sum()) * row_bytes + B * C * 8
    b_ms, b_by = bound(nbytes, bounds.scorer_ops(pairs, D), FP32_OPS_PER_S)
    return {"bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes, "scored": pairs,
            "rows_read": rows_read, "labels_read": labels, "words_read": words,
            "pair_bytes": pair_bytes, "pair_floor_ms": pair_bytes / HBM_BYTES_PER_S * 1e3}


def build_forms(forms, out: Path) -> None:
    """Builds other sources of ``filter_dist.cu`` or ``beam_merge.cu``
    (``NAME=SOURCE``) beside the committed ones, all at once, for the kernel
    checks and ``main_path_ab`` to run on the same inputs. Which kernel a
    source builds, and its interface, are read from the library: one that
    exports ``beam_merge`` is a B2 form, any other a B1/B3 form; one that
    exports ``filter_dist_abi`` / ``beam_merge_abi`` must give the committed
    build's number; one that does not is taken to have the earlier entry
    points (gather scorers without ``tile``, a merge without the bitmap)."""
    if not forms:
        return
    abis = {"filter_dist": _build.library("filter_dist").filter_dist_abi(),
            "beam_merge": _build.library("beam_merge").beam_merge_abi()}
    where = out / "forms"
    where.mkdir(parents=True, exist_ok=True)
    specs = [f.split("=", 1) for f in forms]
    require(all(len(s) == 2 for s in specs), "--form takes NAME=SOURCE")
    procs = [(name, src, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(where / f"lib{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for name, src in specs]
    logs = []
    for name, src, proc in procs:
        log, _ = proc.communicate()
        logs.append(f"== {name}: {src} ==\n{log}\n")
        require(proc.returncode == 0, f"nvcc {src} failed:\n{log}")
        lib = ctypes.CDLL(str(where / f"lib{name}.so"))
        kind = "beam_merge" if hasattr(lib, "beam_merge") else "filter_dist"
        current = hasattr(lib, f"{kind}_abi")
        got = getattr(lib, f"{kind}_abi")() if current else None
        require(not current or got == abis[kind],
                f"{src}: {kind}_abi {got}, the committed build has {abis[kind]}")
        for fn, argtypes in _build.ARGTYPES[kind].items():
            if not current and kind == "beam_merge":
                argtypes = argtypes[:9] + argtypes[11:]
            elif not current and fn != "filter_dist_dense":
                argtypes = argtypes[:-3] + argtypes[-2:]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        if kind == "beam_merge":
            MERGE_FORMS[name] = lib if current else _WithoutVisited(lib)
        else:
            FORMS[name] = lib if current else _WithoutTile(lib)
    (out / "nvcc_forms.txt").write_text("".join(logs))


class _WithoutTile:
    """A library whose gather entry points take no tile: calls them with
    that argument (the 3rd from the end) left out."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, fn):
        f = getattr(self._lib, fn)
        return f if fn == "filter_dist_dense" else (lambda *a: f(*a[:-3], *a[-2:]))


class _WithoutVisited:
    """A ``beam_merge`` library of the earlier interface, which takes no
    bitmap: calls it with the bitmap and its width (the 10th and 11th
    arguments) left out; the bitmap must be null (``b2_form`` sets the bits
    in torch after the call)."""

    def __init__(self, lib):
        self._lib = lib

    def beam_merge(self, *a):
        require(a[9] is None, "an earlier beam_merge build was given a bitmap")
        return self._lib.beam_merge(*a[:9], *a[11:])


@contextlib.contextmanager
def b2_form(lib):
    """``lib`` in place of the committed ``beam_merge`` build. A build of the
    earlier interface gets no bitmap: ``ops.beam_merge`` sets the kept bits
    after it with ``ref.set_bits``, as the packed loop did before the bits
    were fused."""
    merge = ops.beam_merge

    def with_torch_bits(*args, n, visited=None):
        out = merge(*args, n=n)
        if visited is not None:
            ref.set_bits(visited, args[4], out[3], n)
        return out

    with _build.swapped("beam_merge", lib):
        if isinstance(lib, _WithoutVisited):
            ops.beam_merge = with_torch_bits
        try:
            yield
        finally:
            ops.beam_merge = merge


def form_times(fn, want, what: str) -> dict:
    """Each form in place of the committed build: held bitwise against the
    plain version, then timed on the same inputs by both measures."""
    times = {}
    for name, lib in FORMS.items():
        with _build.swapped("filter_dist", lib):
            bitwise(fn(), want, f"{what} ({name})")
            times[name] = kernel_times(fn)
    return times


def scorer_case(fn, plain, want, **fields) -> dict:
    """A B1/B3 case: the committed kernel's times, its plain version's, each
    form's and the committed kernel's once more, in that order."""
    case = {**fields, **kernel_times(fn), "plain_ms": time_ms(plain)}
    if FORMS:
        case["forms"] = form_times(fn, want, fields["kernel"])
        case["again"] = kernel_times(fn)
    case["fraction_of_bound"] = case["bound_ms"] / case["ms"]
    case["queued_fraction_of_bound"] = case["bound_ms"] / case["queued_ms"]
    return case


def pack(lab: torch.Tensor) -> torch.Tensor:
    """int32 rectangles [..., 4] -> packed int32 word pairs [..., 2]."""
    lab = lab.long()
    w = torch.stack([lab[..., 0] | lab[..., 1] << 16, lab[..., 2] | lab[..., 3] << 16], dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def check_scalar_rows(dev) -> list:
    """Both scorers' scalar row path (vec = 0: D not a multiple of one
    16-byte load, or a table that is not 16-byte aligned), int8 tail loop
    included, bitwise against the plain versions on small random inputs."""
    gen = torch.Generator(device=dev).manual_seed(1)
    n, B, E, M, V = 300, 16, 24, 2, 40
    W = (n + 31) // 32
    lab = torch.randint(0, 12, (n, E, 4), generator=gen, device=dev, dtype=torch.int32)
    lab[:, ::5, 1] = 0xFFFF                               # the top of a 16-bit field
    plabels = pack(lab)
    cur = torch.randint(0, n, (B, M), generator=gen, device=dev, dtype=torch.int32)
    cand = torch.randint(-1, n, (B, M * E), generator=gen, device=dev, dtype=torch.int32)
    bf = torch.randint(-1, n, (B, V), generator=gen, device=dev, dtype=torch.int32)
    rect = torch.randint(0, 12, (B, V, 4), generator=gen, device=dev, dtype=torch.int32)
    state = torch.randint(0, 12, (B, 2), generator=gen, device=dev, dtype=torch.int32)
    visited = torch.randint(-2**31, 2**31 - 1, (B, W), generator=gen, device=dev, dtype=torch.int32)
    cases = []
    for dt, D, offset in (("f32", 7, 0), ("int8", 770, 0), ("f32", DIM, 1), ("int8", DIM, 1)):
        x = torch.randn((n, D), generator=gen, device=dev)
        q = torch.randn((B, D), generator=gen, device=dev)
        if dt == "int8":
            rows, scales = ref.quantize_int8(x)
            deq = rows.float() * scales[:, None]
            norms = torch.sum(deq * deq, dim=1)
        else:
            rows, scales, norms = x, None, torch.sum(x * x, dim=1)
        # the same rows, ``offset`` elements past an aligned allocation
        buf = torch.empty(n * D + offset, dtype=rows.dtype, device=dev)
        table = buf[offset:].view(n, D)
        table.copy_(rows)
        require(ops._table_args(table, norms, scales, q)[3] == 0, "the scalar row path not taken")
        args = (table, plabels, norms, q, cur, cand, state, visited)
        err = bitwise(ops.filter_dist_gather_packed(*args, scales=scales),
                      ref.filter_dist_gather_packed_ref(*args, scales), "scalar-row packed scorer")
        args = (table, norms, q, bf, rect, state, visited)
        err = max(err, bitwise(ops.filter_dist_gather(*args, scales=scales),
                               ref.filter_dist_gather_ref(*args, scales), "scalar-row gather scorer"))
        cases.append({"kernel": "filter_dist (scalar rows)", "table": dt, "D": D,
                      "offset": offset, "max_abs_err": err})
    return cases


def sectors(t: torch.Tensor, need: torch.Tensor) -> int:
    """The 32-byte sectors of the contiguous tensor ``t`` that hold an
    element where ``need`` is set."""
    at = t.data_ptr() + torch.nonzero(need.reshape(-1)).squeeze(1) * t.element_size()
    return int(torch.unique_consecutive(at // 32).numel())


def merge_bound(args, keep, words: int = 0) -> dict:
    """B2's bound from this run's inputs: the bytes the function must move,
    each needed input byte read once and each output written once, against
    its compares. Read: every beam and candidate distance (a +inf says the
    candidate is dead); the 32-byte sectors of ``cand_ids`` that hold a live
    (not +inf) candidate, whose id the dedup or the output needs (a +inf
    candidate's never: the reference keys it as n and does not output it);
    the sectors of ``beam_ids`` and ``beam_exp`` that hold a beam entry that
    reaches the output. Written: ids and d (4 bytes), exp and keep (1).
    With the bits fused, each visited word that a kept id touches, read and
    written (``words``, 8 bytes each). Compares: ``ceil(log2(L + C))`` for
    each beam entry and live candidate, one a lane a clock. ``keep`` is the
    plain version's."""
    beam_d, beam_ids, beam_exp, cand_d, cand_ids = args
    B, L = beam_d.shape
    C = cand_d.shape[1]
    live = cand_d != float("inf")
    # a beam entry reaches the output when fewer than L pairs precede it:
    # beam entries of a smaller key, or the same key and a lower index, and
    # survivors (kept, or -inf) of a smaller key (their indices are larger)
    bk = ref.mono_key(beam_d)
    order = torch.sort(bk, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(L, device=bk.device).expand(B, L))
    surv = keep | (cand_d == float("-inf"))
    ck = torch.sort(torch.where(surv, ref.mono_key(cand_d), 1 << 32), dim=1).values
    out_beam = rank + torch.searchsorted(ck, bk) < L
    id_sectors = sectors(cand_ids, live)
    beam_sectors = sectors(beam_ids, out_beam) + sectors(beam_exp, out_beam)
    nbytes = bounds.merge_bytes(B=B, L=L, C=C, sector_bytes=32 * (id_sectors + beam_sectors),
                                words=words)
    b_ms, b_by = bound(nbytes, bounds.merge_ops(B=B, L=L, C=C, live=int(live.sum())),
                       CMP_OPS_PER_S)
    return {"bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "id_sectors": id_sectors, "beam_sectors": beam_sectors}


def same_merge(got, want, what: str) -> None:
    """The four outputs of a merge equal bit for bit."""
    for g_, w_, name in zip(got, want, ("ids", "d", "exp", "keep")):
        if name == "d":
            g_, w_ = g_.view(torch.int32), w_.view(torch.int32)
        require(torch.equal(g_, w_), f"beam_merge {name} differs from the plain version ({what})")


def hold_merge(args, n, visited, what: str):
    """The committed B2 held bitwise against the plain version on all four
    outputs and, with ``visited`` (the kept ids' bits cleared first, as the
    scorer leaves them), the bitmap after the fused call against
    ``ref.set_bits``'s. Returns the plain outputs, the kept ids' bits, the
    bitmap given to the fused call, and the fused check as a function of
    the build's name, for ``--form`` builds."""
    want = ref.beam_merge_ref(*args, n=n)
    same_merge(ops.beam_merge(*args, n=n), want, what)
    kept = torch.zeros_like(visited)
    ref.set_bits(kept, args[4], want[3], n)
    vis = visited & ~kept                         # the kept ids unvisited
    want_vis = vis.clone()
    ref.set_bits(want_vis, args[4], want[3], n)

    def fused_check(name):
        got_vis = vis.clone()
        same_merge(ops.beam_merge(*args, n=n, visited=got_vis), want, f"{what}, {name}, fused")
        require(torch.equal(got_vis, want_vis), f"fused visited bits differ from set_bits ({what}, {name})")

    fused_check("committed")
    return want, kept, vis, fused_check


def merge_case(args, n, visited, *, plain_reps: int = 5, **fields) -> dict:
    """A B2 case: the committed kernel held as ``hold_merge`` does, then
    timed without the bitmap (``ms``, ``queued_ms``) and with it
    (``fused_queued_ms``), beside the plain version, each ``--form`` of
    ``beam_merge.cu`` (held the same way) and the committed kernel once
    more. ``visited_words``: the words the kept ids touch, counted in
    ``fused_bound_ms``."""
    B, L = args[0].shape
    C = args[3].shape[1]
    what = fields.get("case", "")
    want, kept, vis, fused_check = hold_merge(args, n, visited, what)

    def times():
        scratch = vis.clone()
        return {**kernel_times(lambda: ops.beam_merge(*args, n=n)),
                "fused_queued_ms": queued_ms(lambda: ops.beam_merge(*args, n=n, visited=scratch))}

    words = int((kept != 0).sum())
    bnd = merge_bound(args, want[3])
    fin = torch.isfinite(args[3]).sum(1).float()
    case = {"kernel": "beam_merge", **fields, "B": B, "L": L, "C": C, "max_abs_err": 0.0,
            "visited_equal": True,
            "finite_per_row": {"median": fin.median().item(), "p99": fin.quantile(0.99).item(),
                               "max": fin.max().item()},
            "kept_per_row_mean": want[3].sum(1).float().mean().item(),
            **times(), "plain_ms": time_ms(lambda: ref.beam_merge_ref(*args, n=n),
                                           reps=plain_reps, warm=1),
            **bnd, "visited_words": words,
            "fused_bound_ms": merge_bound(args, want[3], words)["bound_ms"]}
    if MERGE_FORMS:
        case["forms"] = {}
        for name, lib in MERGE_FORMS.items():
            with b2_form(lib):
                same_merge(ops.beam_merge(*args, n=n), want, f"{what}, {name}")
                fused_check(name)
                case["forms"][name] = times()
        case["again"] = times()
    case["fraction_of_bound"] = bnd["bound_ms"] / case["ms"]
    case["queued_fraction_of_bound"] = bnd["bound_ms"] / case["queued_ms"]
    case["fused_queued_fraction_of_bound"] = case["fused_bound_ms"] / case["fused_queued_ms"]
    return case


def merge_inputs(B, L, C, n, gen, cand=None) -> tuple:
    """B2's inputs: a sorted random beam, its upper half +inf, row 2 empty;
    ``cand`` (distances, ids) or random candidates, 70 % finite; then exact
    ties and duplicate ids (rows 3-7: few distinct distances and ids), -0.0
    against +0.0 (row 4), all-inf candidates (row 9), a -inf (row 10) and
    the sentinel id n after an inf (row 11)."""
    dev = gen.device
    beam_d = torch.sort(torch.rand((B, L), generator=gen, device=dev) * 400, dim=1).values
    beam_d[:, L // 2:] = float("inf")
    beam_d[2] = float("inf")                          # an empty beam
    beam_ids = torch.randint(0, n, (B, L), generator=gen, device=dev, dtype=torch.int32)
    beam_ids[torch.isinf(beam_d)] = -1
    beam_exp = torch.rand((B, L), generator=gen, device=dev) < 0.5
    if cand is not None:
        cand_d, cand_ids = cand[0].clone(), cand[1].clone()
    else:
        cand_d = torch.rand((B, C), generator=gen, device=dev) * 400
        cand_ids = torch.randint(0, n, (B, C), generator=gen, device=dev, dtype=torch.int32)
        cand_d[torch.rand((B, C), generator=gen, device=dev) < 0.3] = float("inf")
    cand_d[3:8] = torch.randint(0, 4, (5, C), generator=gen, device=dev).float()
    cand_ids[3:8] = torch.randint(0, 8, (5, C), generator=gen, device=dev, dtype=torch.int32)
    beam_d[3:8] = torch.sort(torch.randint(0, 4, (5, L), generator=gen, device=dev).float(), 1).values
    beam_d[4, 0] = -0.0                               # -0.0 ties +0.0
    cand_d[4, :4] = torch.tensor([0.0, -0.0, 0.0, -0.0], device=dev)
    cand_d[9] = float("inf")                          # all-inf candidates
    cand_d[10, 5] = float("-inf")                     # -inf sorts by its key
    cand_d[11, 2] = float("inf")                      # the sentinel id n after it
    cand_d[11, 7], cand_ids[11, 7] = 1.0, n
    return beam_d, beam_ids, beam_exp, cand_d, cand_ids


def shuffle_beam(args, gen) -> tuple:
    """The same inputs with each row's beam in a random order."""
    B, L = args[0].shape
    perm = torch.argsort(torch.rand((B, L), generator=gen, device=gen.device), dim=1)
    return tuple(torch.gather(x, 1, perm) for x in args[:3]) + args[3:]


# (B, L, C): one pair a lane (L <= 32; L 10 and 20 with C 16·L are the
# segment fold's shapes, fetch k and 2k over 16 segments), 8 a lane (L 129-256), 16 a lane
# (L 257-512, the widest in registers) and wider than the registers (the
# chunked selection: the wide search of a beam-300 batch, and three chunks)
MERGE_WIDTHS = ((512, 7, 100), (512, 10, 160), (512, 20, 320), (512, 32, 720), (512, 200, 720),
                (512, 300, 600), (256, 600, 1440), (64, 1100, 300))


def merge_width_cases(n, visited) -> list:
    """B2 at the beam widths that the paths' cases leave out, sorted and
    shuffled, with the edge rows of ``merge_inputs``: held as
    ``hold_merge`` does (bitwise, the fused bitmap too); not timed."""
    gen = torch.Generator(device=visited.device).manual_seed(4)
    cases = []
    for B, L, C in MERGE_WIDTHS:
        args = merge_inputs(B, L, C, n, gen)
        for order, a in (("sorted", args), ("shuffled", shuffle_beam(args, gen))):
            hold_merge(a, n, visited[:B], f"L {L}, C {C}, {order} beam")
            cases.append({"kernel": "beam_merge (widths)", "B": B, "L": L, "C": C, "beam": order,
                          "max_abs_err": 0.0, "visited_equal": True})
    return cases


def check_kernels(dg, q, states, ep) -> dict:
    """Every kernel against its plain version at the paths' shapes and on
    edge cases (the scorers B1, B3, B4 bitwise: their plain versions sum in
    the kernels' order; B2 bitwise; B5, B6 within ``matrix_close``'s bound);
    returns the timed table rows by kernel name. The scorer
    expands each query's entry node (and, at M = 2, that node's first
    neighbour), as the search's first iterations do, so its candidates pass
    the label test at the search's own rate."""
    dev = q.device
    di = dg.device(dev)
    n, D = di.table.shape
    E = di.nbr.shape[1]
    B = q.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    W = (n + 31) // 32
    # ~25% of the bits set, bit 31 in about a quarter of the words
    visited = (torch.randint(-2**31, 2**31 - 1, (B, W), generator=gen, device=dev, dtype=torch.int32)
               & torch.randint(-2**31, 2**31 - 1, (B, W), generator=gen, device=dev, dtype=torch.int32))
    vec_q, sc = ref.quantize_int8(di.table)
    deq = vec_q.float() * sc[:, None]
    tables = {"f32": (di.table, di.norms, None),
              "int8": (vec_q, torch.sum(deq * deq, dim=1), sc)}
    rows, cases = {}, []

    # B1: packed scorer, M = 1 (GRAPH) and M = 2 (GRAPH_WIDE)
    first = ep.clamp(min=0)
    expanded = torch.stack([first, di.nbr[first.long(), 0].clamp(min=0)], dim=1)
    for M in (1, 2):
        cur = expanded[:, :M].contiguous()
        cand = di.nbr[cur.long()].reshape(B, M * E).clone()
        cand[0] = -1                                      # an all-invalid row
        cand[1, ::3] = -1                                 # scattered padding
        for dt, (table, norms, scales) in tables.items():
            args = (table, di.labels, norms, q, cur, cand, states, visited)
            got = ops.filter_dist_gather_packed(*args, scales=scales)
            want = ref.filter_dist_gather_packed_ref(*args, scales)
            err = bitwise(got, want, "filter_dist_gather_packed")
            require(bool(torch.isinf(got[0]).all()), "an all-padding row scored")
            open_out = ref.filter_dist_gather_packed_ref(*args[:7], torch.zeros_like(visited), scales)
            label_key = (cur.long()[:, :, None] * E + torch.arange(E, device=dev)).reshape(B, M * E)
            case = scorer_case(
                lambda: ops.filter_dist_gather_packed(*args, scales=scales),
                lambda: ref.filter_dist_gather_packed_ref(*args, scales), want,
                kernel="filter_dist_gather_packed", table=dt, B=B, M=M, E=E, D=D,
                max_abs_err=err, tile=ops.scorer_tile(B, M * E, ops._sm_count(dev)),
                **scorer_bound(want, open_out, cand, label_key, D=D, elt=table.element_size(),
                               scaled=scales is not None, label_bytes=8,
                               per_query=D * 4 + 8 + M * 4))
            cases.append(case)
            if M == 1 and dt == "f32":
                rows["filter_dist_gather_packed"] = case
                d_new, nb = got, cand     # real candidates for the merge check
            if M == 1:
                cases.append(int32_case(dg, args, want, scales, cand, B))

    # B2: beam merge, L = 64 against the scorer's output, L = 128 wide and
    # dense, and the first case's beam out of order; then the other widths
    for L, C in ((BEAM, E), (2 * BEAM, 2 * E)):
        args = merge_inputs(B, L, C, n, gen, cand=(d_new, nb) if C == E else None)
        case = merge_case(args, n, visited, case="dense wide" if C != E else "scorer output",
                          inputs="sorted random beam, half +inf; " + (
                              "B1's output on the entry nodes' neighbours" if C == E
                              else "random candidates, 70 % finite")
                          + "; ties, -0.0, all-inf, -inf and sentinel rows")
        cases.append(case)
        if L == BEAM:
            rows["beam_merge"] = case
            cases.append(merge_case(shuffle_beam(args, gen), n, visited, case="unsorted beam",
                                    inputs="the scorer-output case, each row's beam shuffled"))
    cases += merge_width_cases(n, visited)

    # B3: the BRUTE_VALID scan: all-pass rectangles, empty bitmap, C = 256
    V = 256
    bf = torch.randint(0, n, (B, V), generator=gen, device=dev, dtype=torch.int32)
    cnt = torch.randint(0, V + 1, (B, 1), generator=gen, device=dev)
    bf[torch.arange(V, device=dev)[None] >= cnt] = -1     # -1 padded lists
    bf[0] = -1
    zeros_lab = torch.zeros((B, V, 4), dtype=torch.int32, device=dev)
    zeros_st = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    zeros_vis = torch.zeros((B, W), dtype=torch.int32, device=dev)
    rand_lab = torch.randint(0, 12, (B, V, 4), generator=gen, device=dev, dtype=torch.int32)
    rand_st = torch.randint(0, 12, (B, 2), generator=gen, device=dev, dtype=torch.int32)
    for dt, (table, norms, scales) in tables.items():
        # general label + visited semantics first, then the brute shape
        args = (table, norms, q, bf, rand_lab, rand_st, visited)
        bitwise(ops.filter_dist_gather(*args, scales=scales),
                ref.filter_dist_gather_ref(*args, scales), "filter_dist_gather")
        args = (table, norms, q, bf, zeros_lab, zeros_st, zeros_vis)
        got = ops.filter_dist_gather(*args, scales=scales)
        want = ref.filter_dist_gather_ref(*args, scales)
        err = bitwise(got, want, "filter_dist_gather")
        require(bool(torch.isinf(got[0]).all()), "an all-padding row scored")
        case = scorer_case(
            lambda: ops.filter_dist_gather(*args, scales=scales),
            lambda: ref.filter_dist_gather_ref(*args, scales), want,
            kernel="filter_dist_gather", table=dt, B=B, C=V, D=D, max_abs_err=err,
            tile=ops.scorer_tile(B, V, ops._sm_count(dev)),
            # the bitmap is empty here, so ``want`` is its own open version
            **scorer_bound(want, want, bf, torch.arange(B * V, device=dev).view(B, V), D=D,
                           elt=table.element_size(), scaled=scales is not None,
                           label_bytes=16, per_query=D * 4 + 8))
        cases.append(case)
        if dt == "f32":
            rows["filter_dist_gather"] = case
    cases.append(wave_case(di.table, di.norms, di.nbr, visited, gen))
    cases += check_scalar_rows(dev)
    rows.update(check_dense_scorer(dg, q, states, ep, cases))
    rows.update(check_distance_matrices(di.table, cases))
    torch.cuda.synchronize()
    RECORD["kernel_cases"] = cases
    return rows


def int32_case(dg, packed_args, want, scales, cand, B) -> dict:
    """B3 at the int32 search branch's shape: B1's M = 1 inputs with each
    candidate's label as a pre-gathered int32 rectangle ([B, E, 4]), as
    ``search_core`` passes them over an int32 export; the same outputs as B1
    bit for bit."""
    table, _, norms, q, cur, _, states, visited = packed_args
    lab = dg.device_labels_i32(q.device)[cur[:, 0].long()].contiguous()
    args = (table, norms, q, cand, lab, states, visited)
    got = ops.filter_dist_gather(*args, scales=scales)
    err = bitwise(got, want, "filter_dist_gather (int32 path) against the packed scorer")
    open_out = ref.filter_dist_gather_ref(*args[:6], torch.zeros_like(visited), scales)
    return scorer_case(
        lambda: ops.filter_dist_gather(*args, scales=scales),
        lambda: ref.filter_dist_gather_ref(*args, scales), want,
        kernel="filter_dist_gather (int32 path)", table="int8" if scales is not None else "f32",
        B=B, C=cand.shape[1], D=table.shape[1], max_abs_err=err,
        tile=ops.scorer_tile(B, cand.shape[1], ops._sm_count(q.device)),
        **scorer_bound(want, open_out, cand, torch.arange(cand.numel(), device=q.device).view_as(cand),
                       D=table.shape[1], elt=table.element_size(), scaled=scales is not None,
                       label_bytes=16, per_query=table.shape[1] * 4 + 8))


def wave_case(table, norms, nbr, visited, gen) -> dict:
    """B3 at the wave constructor's shape, f32 as the constructor's table:
    B = 256 (one wave) and C = 4 x 128 (``expand = min(4, Z)`` over the
    broad rows' cap ``max(Z, 2M, 32)`` = 128), all-zero rectangles and
    state as in the broad search. Queries are 256 random corpus rows; each
    one's candidates are the first 128 neighbours of 4 random nodes of the
    export; the bitmap is the first 256 rows of ``check_kernels``' (about 25 %
    of the bits set). Held bitwise against the plain version and timed; its
    launches are the index phase's."""
    dev = table.device
    n, D = table.shape
    WB, WX, WC = 256, 4, 128
    nodes = torch.randint(0, n, (WB, WX), generator=gen, device=dev)
    q = table[torch.randint(0, n, (WB,), generator=gen, device=dev)].contiguous()
    cand = torch.full((WB * WX, WC), -1, dtype=torch.int32, device=dev)   # -1 past a short row
    cand[:, :min(WC, nbr.shape[1])] = nbr[nodes.view(-1), :WC]
    cand = cand.view(WB, WX * WC)
    args = (table, norms, q, cand, torch.zeros((WB, WX * WC, 4), dtype=torch.int32, device=dev),
            torch.zeros((WB, 2), dtype=torch.int32, device=dev), visited[:WB].contiguous())
    got = ops.filter_dist_gather(*args)
    want = ref.filter_dist_gather_ref(*args)
    err = bitwise(got, want, "filter_dist_gather (wave shape)")
    open_out = ref.filter_dist_gather_ref(*args[:6], torch.zeros_like(args[6]))
    return scorer_case(
        lambda: ops.filter_dist_gather(*args), lambda: ref.filter_dist_gather_ref(*args), want,
        kernel="filter_dist_gather (wave)", table="f32", B=WB, C=WX * WC, D=D, max_abs_err=err,
        inputs="256 random corpus rows as queries; the first 128 neighbours of 4 random "
               "export nodes each; zero rectangles and state; visited ~25% of the bits",
        launches=RECORD.get("index", {}).get("b3_launches"),
        tile=ops.scorer_tile(WB, WX * WC, ops._sm_count(dev)),
        **scorer_bound(want, open_out, cand, torch.arange(cand.numel(), device=dev).view_as(cand),
                       D=D, elt=4, scaled=False,
                       label_bytes=16, per_query=D * 4 + 8))


def check_dense_scorer(dg, q, states, ep, cases) -> dict:
    """B4 at the unfused path's shapes: the first iteration's dense
    pre-gather of each query's entry node's neighbours ``[B, E, D]`` with
    their int32 rectangles, bitwise against the plain version; then the edge
    cases (odd D, an all-invalid label tile, ids -1)."""
    dev = q.device
    di = dg.device(dev)
    n, D = di.table.shape
    B = q.shape[0]
    first = ep.clamp(min=0).long()
    nb = di.nbr[first].clone()
    nb[0] = -1                                            # an all-padding row
    nb[1, ::3] = -1                                       # scattered padding
    cand = di.table[nb.clamp(0, n - 1).long()]
    labels = dg.device_labels_i32(dev)[first].contiguous()
    args = (q, cand, labels, states, nb)
    got = ops.filter_dist(*args)
    want = ref.filter_dist_ref(*args)
    require(bool(torch.isinf(got[0]).all()), "an all-padding row scored")
    passed = torch.isfinite(want)
    E = nb.shape[1]
    nbytes = B * E * (4 + 16 + 4) + int(passed.sum()) * D * 4 + B * (D * 4 + 8)
    b_ms, b_by = bound(nbytes, int(passed.sum()) * 4 * D, FP32_OPS_PER_S)
    case = {
        "kernel": "filter_dist", "B": B, "E": E, "D": D, "max_abs_err": bitwise(got, want, "filter_dist"),
        "scored": int(passed.sum()),
        **kernel_times(lambda: ops.filter_dist(*args)),
        "plain_ms": time_ms(lambda: ref.filter_dist_ref(*args), reps=5, warm=1),
        "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
    }
    cases.append(case)
    del cand, got, want
    gen = torch.Generator(device=dev).manual_seed(2)
    for b, e, d in ((3, 17, 8), (5, 200, 131), (64, 33, 770)):
        qq = torch.randn((b, d), generator=gen, device=dev)
        cc = torch.randn((b, e, d), generator=gen, device=dev)
        lab = torch.randint(0, 12, (b, e, 4), generator=gen, device=dev, dtype=torch.int32)
        lab[0] = torch.tensor([5, 4, 0, 11], dtype=torch.int32, device=dev)   # l > r: no tuple passes
        st = torch.randint(0, 12, (b, 2), generator=gen, device=dev, dtype=torch.int32)
        ids = torch.randint(-1, 40, (b, e), generator=gen, device=dev, dtype=torch.int32)
        ids[1] = -1
        out = ops.filter_dist(qq, cc, lab, st, ids)
        require(bool(torch.isinf(out[:2]).all()), "an invalid label tile or id -1 scored")
        cases.append({"kernel": "filter_dist (edge)", "B": b, "E": e, "D": d,
                      "max_abs_err": bitwise(out, ref.filter_dist_ref(qq, cc, lab, st, ids),
                                             "filter_dist edge case")})
    return {"filter_dist": case}


def check_distance_matrices(table, cases) -> dict:
    """B5 and B6 at ``bench_kernels.py``'s shapes and one large block, rows
    drawn from the corpus (f32; int8 quantized per row; B5 also on the same
    rows in f16), and on edge cases (ragged Bq/Bc/D against the 128 x 128 x 32
    tiles, odd D and D below one 16-byte copy, each in f32, f16 and int8).
    The bound counts the f32-accurate products at the tensor cores' dense
    rate for the inputs' type: 3 TF32 passes for f32, 2 for int8 rows, and
    one FP16 pass for f16 (f16 products summed in f32 are exact on the FP16
    tensor cores; the kernel widens them to TF32, a choice that the bound
    does not credit); ``library_ms`` is ``torch.cdist`` (TF32 off), on the
    dequantized rows for B6 and the f16 values widened to f32 for f16."""
    dev = table.device
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    n = table.shape[0]
    for bq, bc, d in L2_SHAPES:
        q = table[torch.randint(0, n, (bq,), generator=gen, device=dev), :d].contiguous()
        q = q + 0.1 * torch.randn(q.shape, generator=gen, device=dev)
        c = table[torch.randint(0, n, (bc,), generator=gen, device=dev), :d].contiguous()
        c8, sc = ref.quantize_int8(c)
        deq = c8.float() * sc[:, None]
        qh, ch = q.half(), c.half()
        qhf, chf = qh.float(), ch.float()
        for name, fn, plain, lib, qin, cin, elt, passes, rate in (
            ("l2dist", lambda: ops.l2dist(q, c), lambda: ref.l2dist_ref(q, c),
             lambda: torch.cdist(q, c), q, c, 4, 3, TF32_OPS_PER_S),
            ("int8_l2dist", lambda: ops.int8_l2dist(q, c8, sc),
             lambda: ref.int8_l2dist_ref(q, c8, sc), lambda: torch.cdist(q, deq), q, deq, 1, 2,
             TF32_OPS_PER_S),
            ("l2dist (f16)", lambda: ops.l2dist(qh, ch), lambda: ref.l2dist_ref(qh, ch),
             lambda: torch.cdist(qhf, chf), qhf, chf, 2, 1, FP16_OPS_PER_S),
        ):
            err, share = matrix_close(fn(), plain(), qin, cin)
            q_elt = 2 if elt == 2 else 4
            nbytes = bq * d * q_elt + bc * d * elt + bq * bc * 4 + (bc * 4 if elt == 1 else 0)
            b_ms, b_by = bound(nbytes, passes * 2 * bq * bc * d, rate)
            case = {"kernel": name, "Bq": bq, "Bc": bc, "D": d, "max_abs_err": err,
                    "tol_share": share, **kernel_times(fn), "plain_ms": time_ms(plain),
                    "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
                    "passes": passes, "pass_type": "fp16" if rate == FP16_OPS_PER_S else "tf32"}
            case["fraction_of_bound"] = b_ms / case["ms"]
            cases.append(case)
            rows[name] = case            # the last shape, the large block, is the row
    for bq, bc, d in ((37, 215, 70), (1, 1, 4), (130, 50, 33), (7, 65, 131),
                      (129, 257, 96), (200, 300, 100)):
        q = torch.randn((bq, d), generator=gen, device=dev)
        c = torch.randn((bc, d), generator=gen, device=dev)
        c8, sc = ref.quantize_int8(c)
        errs = [matrix_close(ops.l2dist(q, c), ref.l2dist_ref(q, c), q, c),
                matrix_close(ops.l2dist(q.half(), c.half()), ref.l2dist_ref(q.half(), c.half()),
                             q.half().float(), c.half().float()),
                matrix_close(ops.int8_l2dist(q, c8, sc), ref.int8_l2dist_ref(q, c8, sc), q,
                             c8.float() * sc[:, None])]
        cases.append({"kernel": "l2dist/int8_l2dist (edge, f32+f16+int8)", "Bq": bq, "Bc": bc,
                      "D": d, "max_abs_err": max(e for e, _ in errs),
                      "tol_share": max(s for _, s in errs)})
    return rows


def traced_ms(run) -> dict:
    """Device time and launches by kernel name over one traced call of ``run``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    return by_name


def profile_batch(run, batch_ms: float, out: Path) -> dict:
    """Device time by kernel over one traced batch; the idle share is
    1 - device busy time / the untraced median batch time."""
    by_name = traced_ms(run)
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    (out / "profile.json").write_text(json.dumps(top, indent=1))
    return {"device_busy_ms": busy, "batch_ms": batch_ms,
            "idle_share": 1.0 - busy / batch_ms,
            "top": [[name[:60], round(t, 3), c] for name, (t, c) in top[:12]]}


def traced_split(by_name: dict) -> dict:
    """Device time and launches of the scorers (``filter_dist_kernel``: B1,
    B3), the merge (``beam_merge_kernel``: B2) and torch's scatter/gather
    kernels (the bitmap update of an earlier-interface merge, ``_select``'s
    scatter and the loop's gathers), each of those by name."""
    out = {}
    for key, part in (("scorer", "filter_dist_kernel"), ("merge", "beam_merge_kernel"),
                      ("scatter_gather", "scatter_gather")):
        hits = {k: v for k, v in by_name.items() if part in k}
        out[f"{key}_device_ms"] = sum(t for t, _ in hits.values())
        out[f"{key}_launches"] = sum(c for _, c in hits.values())
        if key == "scatter_gather":
            out["scatter_gather_by_name"] = {k[:160]: v for k, v in hits.items()}
    return out


def main_path_ab(run, want, rounds: int = 5) -> dict:
    """The main path's batch with the committed kernels and with each
    ``--form`` in place of its kernel, in turns (committed, form, form,
    committed, ... ``rounds`` times a form), on one index in one process:
    the same ids and distances bit for bit; each side's batch times and
    traced device time by kernel (``traced_split``)."""
    res = {}
    for kind, forms, swap in (("filter_dist", FORMS, lambda lib: _build.swapped("filter_dist", lib)),
                              ("beam_merge", MERGE_FORMS, b2_form)):
        for form, lib in forms.items():
            libs = {"committed": _build.library(kind), form: lib}
            lat = {name: [] for name in libs}
            for name in ("committed", form, form, "committed") * rounds:
                with swap(libs[name]):
                    t0 = time.perf_counter()
                    ids, d = run()
                    lat[name].append(time.perf_counter() - t0)
                require(np.array_equal(ids, want[0]) and np.array_equal(d.view(np.int32), want[1].view(np.int32)),
                        f"the main path with the {name} {kind} build gave other results")
            res[form] = {"kernel": kind}
            for name, l in libs.items():
                with swap(l):
                    traced = traced_split(traced_ms(run))
                res[form][name] = {"qps": BATCH / statistics.median(lat[name]),
                                   "batch_ms": [t * 1e3 for t in lat[name]], **traced}
    return res


CAPTURE_ITERS = (1, 8, 32)


def merge_captures(run, n: int) -> dict:
    """B2 on the loop's own inputs: the auto batch (outside the counted main
    path) run twice with ``ops.beam_merge`` recorded, once to count the
    merges of each search and once to copy the (beam, candidates, bitmap)
    of iterations 1, 8, 32 and the last of the graph search (L 64, C 720)
    and of the wide search (L 128, C 1440); each copy is held bitwise and
    timed as ``merge_case`` does, with its finite candidates per row
    (median, p99, max). Also B2's launches of the batch split by search."""
    merge = ops.beam_merge
    calls, last, caps = {}, {}, {}

    def record(*args, n, visited=None):
        L = args[0].shape[1]
        i = calls[L] = calls.get(L, 0) + 1
        if last and (i in CAPTURE_ITERS or i == last[L]):
            caps[(L, i)] = tuple(x.clone() for x in (*args, visited))
        return merge(*args, n=n, visited=visited)

    ops.beam_merge = record
    try:
        run()
        last.update(calls)
        calls.clear()
        run()
    finally:
        ops.beam_merge = merge
    names = {BEAM: "graph", 2 * BEAM: "wide"}
    require(set(calls) == set(names), f"merges of beam widths {sorted(calls)}, expected {sorted(names)}")
    require(calls == last, f"the batch merged {last} times, then {calls}")
    cases = []
    for (L, i), snap in sorted(caps.items()):
        label = f"{names[L]} iteration {i}" + (" (the last)" if i == last[L] else "")
        cases.append(merge_case(snap[:5], n, snap[5], case=label, plain_reps=3,
                                inputs=f"captured from the auto batch's {names[L]} search"))
    del caps
    return {"launches": {names[L]: c for L, c in calls.items()}, "iterations": CAPTURE_ITERS,
            "cases": cases}


def make_queries(n_q, s, t, sels, seed):
    """``n_q`` queries, query i at selectivity ``sels[i % len(sels)]``."""
    qv = make_queries_vectors(n_q, DIM, seed=seed)
    s_q, t_q = np.empty(n_q), np.empty(n_q)
    for g, sel in enumerate(sels):
        idx = np.arange(g, n_q, len(sels))
        qs = generate_queries(qv[idx], s, t, CONFIG.relation, sel, k=K, seed=seed + g)
        s_q[idx], t_q[idx] = qs.s_q, qs.t_q
    return qv, s_q, t_q


def constructor_parity() -> dict:
    """The wave build on the card and on the CPU give identical graphs (the
    same arithmetic to the bit, the same stable sorts); the wave graph's
    recall@10 is within 0.5 pt of the sequential graph's."""
    p = PARITY_BUILD
    vecs, s, t = make_dataset(p["n"], p["d"], seed=5)
    kw = dict(M=p["M"], Z=p["Z"], K_p=p["K_p"])
    out = {**p}
    graphs = {}
    for name, extra in (("card", dict(batched=True, wave=p["wave"], device="cuda")),
                        ("cpu", dict(batched=True, wave=p["wave"], device="cpu")),
                        ("sequential", dict(batched=False))):
        t0 = time.perf_counter()
        graphs[name], rep = build_udg(vecs, s, t, CONFIG.relation, **kw, **extra)
        out[f"{name}_build_s"] = round(time.perf_counter() - t0, 2)
        out[f"{name}_tuples"] = rep.num_tuples
    ga, gb = graphs["card"], graphs["cpu"]
    same = ga.num_tuples == gb.num_tuples and all(
        all(np.array_equal(x, y) for x, y in zip(ga.tuples(u), gb.tuples(u))) for u in range(ga.n))
    require(same, "the wave build on the card and on the CPU gave different graphs")
    qv = make_queries_vectors(256, p["d"], seed=6)
    qs = ground_truth(generate_queries(qv, s, t, CONFIG.relation, 0.1, k=K, seed=7), vecs, s, t)
    for name in ("card", "sequential"):
        g = graphs[name]
        dg = export_planned_graph(g, EntryTable(g), device="cuda")
        ids, _ = batched_udg_search(dg, qs.vectors, qs.s_q, qs.t_q, k=K, beam=BEAM)
        out[f"{name}_recall_at_10"] = recall_at_k(ids, qs)
    require(out["card_recall_at_10"] >= out["sequential_recall_at_10"] - 0.005,
            "the wave graph's recall@10 is more than 0.5 pt below the sequential graph's")
    out["graphs_identical"] = True
    return out


def unfused_path(dg, qv, s_q, t_q) -> dict:
    """``execute_batch(fused=False)`` and ``batched_udg_search(fused=False)``
    at batch 4096 against the same calls fused: ids equal under the tie rule
    and distances within the reference's ``atol=1e-4``
    (``tests/test_packed_labels.py:166-170``; the export's norms are the ones
    the unfused scorer recomputes), and B4 launched. The unfused executor
    widens with expand 1, as the reference's does, so the fused baseline
    takes ``wide_expand=1`` too."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    config = dataclasses.replace(default_planner_config(), wide_expand=1)
    fused_auto = execute_batch(dg, qv, s_q, t_q, k=K, beam=BEAM, plan="auto", config=config)
    fused_graph = batched_udg_search(dg, qv, s_q, t_q, k=K, beam=BEAM)
    reset_counts()
    t0 = time.perf_counter()
    auto = execute_batch(dg, qv, s_q, t_q, k=K, beam=BEAM, plan="auto", fused=False,
                         config=config)
    auto_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = batched_udg_search(dg, qv, s_q, t_q, k=K, beam=BEAM, fused=False)
    graph_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    loop = dict(search_mod.LOOP_STATS)
    require(launches["filter_dist"] > 0, "B4 never launched on the unfused path")
    errs = []
    for name, got, want in (("auto", auto, fused_auto), ("graph", graph, fused_graph)):
        bad = mismatches(*want, *got)
        require(not bad, f"unfused {name} vs fused: {bad[:5]}")
        fin = np.isfinite(want[1])
        errs.append(float(np.max(np.abs(got[1][fin] - want[1][fin]), initial=0.0)))
        require(errs[-1] <= 1e-4, f"unfused {name} distances off by {errs[-1]}")
    emit({"unfused_path": {
        "batch": len(qv), "auto_batch_ms": auto_s * 1e3, "graph_batch_ms": graph_s * 1e3,
        "ids_equal": bool(np.array_equal(auto[0], fused_auto[0]) and np.array_equal(graph[0], fused_graph[0])),
        "max_abs_err": max(errs), "launches": launches, "loop_iterations": loop["iterations"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }})
    return launches


def int32_path(dg, qv, s_q, t_q) -> dict:
    """``search_core`` over the export's int32 labels (the branch an export
    over a grid too wide for 16-bit ranks runs): the gather scorer (B3) with
    the same arithmetic as the packed scorer, so ids and distances equal the
    packed path's bit for bit."""
    di = dg.device()
    states, ep = prepare_states(dg, s_q, t_q)
    args = (di.table, di.nbr)
    rest = (torch.as_tensor(qv, device="cuda"), torch.as_tensor(states, device="cuda"),
            torch.as_tensor(ep, device="cuda"))
    kw = dict(k=K, beam=BEAM, max_iters=2 * BEAM, norms=di.norms, scales=di.scales)
    t0 = time.perf_counter()
    ids_p, d_p = search_core(*args, di.labels, *rest, **kw)
    torch.cuda.synchronize()
    packed_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    ids_i, d_i = search_core(*args, dg.device_labels_i32(), *rest, **kw)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    require(launches["filter_dist_gather"] > 0, "B3 never launched on the int32 path")
    require(torch.equal(ids_i, ids_p), "int32 path ids differ from the packed path's")
    require(torch.equal(d_i.view(torch.int32), d_p.view(torch.int32)),
            "int32 path distances differ from the packed path's")
    emit({"int32_path": {"batch": len(qv), "batch_ms": batch_s * 1e3,
                         "packed_batch_ms": packed_s * 1e3, "ids_equal": True,
                         "launches": launches}})
    return launches


def distance_matrix_path(dg, qv, s_q, t_q, vecs, s, t, gt_ids) -> dict:
    """The queries' exact distances to the whole corpus through ``ops.l2dist``
    (B5) and to its int8 copy through ``ops.int8_l2dist`` (B6), masked to each
    query's valid set: the exact top-10 must equal the host ground truth under
    the tie rule; the int8 top-10's recall against it is reported (>= 0.9).
    Both matrices are then held against their plain versions at this shape
    (``matrix_close``), outside the timed scan."""
    from repro_torch.core.predicates import get_relation

    rel = get_relation(CONFIG.relation)
    table = torch.as_tensor(vecs, device="cuda")
    q = torch.as_tensor(qv, device="cuda")
    c8, sc = ref.quantize_int8(table)
    valid = torch.as_tensor(np.stack([rel.valid_mask(s, t, a, b) for a, b in zip(s_q, t_q)]),
                            device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    m = ops.l2dist(q, table)
    m8 = ops.int8_l2dist(q, c8, sc)
    d = torch.where(valid, m, float("inf"))
    d8 = torch.where(valid, m8, float("inf"))
    # ascending, ties toward the smaller id (the ground truth's rule)
    top = torch.sort(d, dim=1, stable=True)
    top8 = torch.sort(d8, dim=1, stable=True).indices[:, :K]
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    ids = top.indices[:, :K].int().cpu().numpy()
    dist = top.values[:, :K].cpu().numpy()
    exact = np.sum((vecs[gt_ids].astype(np.float64) - qv[:, None].astype(np.float64)) ** 2, axis=-1)
    bad = mismatches(gt_ids, exact, ids, dist)
    require(not bad, f"l2dist top-10 vs host ground truth: {bad[:5]}")
    rec8 = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(top8.cpu().numpy().tolist(),
                                                                  gt_ids.tolist())]))
    require(rec8 >= 0.9, f"int8 scan recall@10 {rec8}")
    del d, d8, top, top8
    err, share = matrix_close(m, ref.l2dist_ref(q, table), q, table)
    del m
    deq = c8.float() * sc[:, None]
    err8, share8 = matrix_close(m8, ref.int8_l2dist_ref(q, c8, sc), q, deq)
    del m8, deq
    emit({"distance_matrices": {"queries": len(qv), "corpus": len(vecs), "scan_ms": scan_s * 1e3,
                                "l2dist_ms": time_ms(lambda: ops.l2dist(q, table)),
                                "int8_l2dist_ms": time_ms(lambda: ops.int8_l2dist(q, c8, sc)),
                                "exact_topk_equal": bool(np.array_equal(ids, gt_ids)),
                                "int8_recall_at_10": rec8,
                                "l2dist_max_abs_err": err, "l2dist_tol_share": share,
                                "int8_l2dist_max_abs_err": err8, "int8_l2dist_tol_share": share8,
                                "launches": launches}})
    return launches


def delta_scan_case(q, s_q, t_q, C: int) -> dict:
    """B3 at the streaming delta scan's shape (``stream/search.py``): the
    batch's queries against a delta segment of ``C`` objects
    (``make_dataset(C, DIM, seed=3)``, every 97th slot dead), their
    key-space rectangles broadcast to ``[B, C, 4]`` and materialized, slot
    ids as the candidates, an empty ``[B, ceil(C/32)]`` bitmap, the delta
    norms summed as the export's (``delta_norms``). Held bitwise against
    ``ref.filter_dist_gather_ref`` (run over 128 queries at a time: its
    ``[B, C, D]`` gather would not fit), timed beside its bound, the
    re-read floor and the materialization of the broadcast."""
    from repro_torch.stream import DeltaBuffer, query_key_state
    from repro_torch.core.predicates import get_relation
    from repro_torch.stream.search import delta_norms

    dev = q.device
    B, D = q.shape
    rel = get_relation(CONFIG.relation)
    vecs, s, t = make_dataset(C, D, seed=3)
    buf = DeltaBuffer(D, C, rel)
    for i in range(C):
        buf.append(vecs[i], s[i], t[i], i)
    for i in range(0, C, 97):
        buf.tombstone(i)
    seg = buf.device_segment()
    dvec = torch.as_tensor(seg.vectors, device=dev)
    dlab = torch.as_tensor(seg.labels, device=dev)
    dids = torch.as_tensor(seg.slot_ids, device=dev)
    dstate = torch.as_tensor(query_key_state(rel, s_q, t_q), device=dev)
    dn = delta_norms(dvec)
    lab = dlab[None].expand(B, C, 4).contiguous()
    slot = dids[None].expand(B, C).contiguous()
    vis = torch.zeros((B, (C + 31) // 32), dtype=torch.int32, device=dev)
    args = (dvec, dn, q, slot, lab, dstate, vis)

    def plain():
        return torch.cat([ref.filter_dist_gather_ref(dvec, dn, q[i:i + 128], slot[i:i + 128],
                                                     lab[i:i + 128], dstate[i:i + 128],
                                                     vis[i:i + 128])
                          for i in range(0, B, 128)])

    got = ops.filter_dist_gather(*args)
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = bitwise(got, want, "filter_dist_gather (delta scan)")
    fin = torch.isfinite(want)
    case = {
        "kernel": "filter_dist_gather (delta scan)", "table": "f32", "B": B, "C": C, "D": D,
        "max_abs_err": err, "passing_share": float(fin.float().mean()),
        "tile": ops.scorer_tile(B, C, ops._sm_count(dev)),
        "inputs": f"make_dataset({C}, {D}, seed=3) as the delta, every 97th slot dead; the "
                  "main batch's queries and key states; broadcast rectangles materialized",
        **kernel_times(lambda: ops.filter_dist_gather(*args)), "plain_ms": plain_ms,
        # the function reads each slot's rectangle once: C distinct labels
        **scorer_bound(want, want, slot, slot.long(), D=D, elt=4, scaled=False,
                       label_bytes=16, per_query=D * 4 + 8),
        "every_pair_floor_ms": (B * C * (D * 4 + 4) + B * C * 8) / HBM_BYTES_PER_S * 1e3,
        "materialized_bytes": lab.numel() * 4 + slot.numel() * 4,
        "materialize_ms": time_ms(lambda: (dlab[None].expand(B, C, 4).contiguous(),
                                           dids[None].expand(B, C).contiguous())),
    }
    case["fraction_of_bound"] = case["bound_ms"] / case["ms"]
    case["queued_fraction_of_bound"] = case["bound_ms"] / case["queued_ms"]
    del lab, slot, got, want
    return case


def main_path_stats(dg, qv, s_q, t_q, launches, loop, want, batches: int) -> dict:
    """The auto batch with ``stats=True``, outside the counted run: the same
    results bit for bit; the same kernel launches and host syncs as with the
    counters off, and with them off the counted run's launches per
    iteration; per plan the share of rows cut by the iteration cap
    (``hit_max_iters``) and the mean iterations and valid candidates; the
    batch wall time with the counters on over off, three batches each in
    turns."""
    runs = {}
    for stats in (False, True):
        reset_counts()
        out = execute_batch(dg, qv, s_q, t_q, k=K, beam=BEAM, plan="auto", return_plans=True,
                            stats=stats)
        runs[stats] = (out, dict(ops.LAUNCHES), dict(search_mod.LOOP_STATS))
    (off, l_off, loop_off), (on, l_on, loop_on) = runs[False], runs[True]
    for name, res in (("off", off), ("on", on)):
        require(np.array_equal(res[0], want[0]) and
                np.array_equal(res[1].view(np.int32), want[1].view(np.int32)),
                f"the auto batch with stats {name} gave other results")
    require(l_on == l_off and loop_on == loop_off,
            f"stats on changed launches or syncs: {l_on} {loop_on} vs {l_off} {loop_off}")
    per_iter = {k: launches[k] / loop["iterations"] for k in ("filter_dist_gather_packed", "beam_merge")}
    per_iter_off = {k: l_off[k] / loop_off["iterations"] for k in per_iter}
    require(per_iter_off == per_iter, f"launches per iteration {per_iter_off}, counted {per_iter}")
    lat = {False: [], True: []}
    for stats in (False, True, True, False) * 2:
        t0 = time.perf_counter()
        execute_batch(dg, qv, s_q, t_q, k=K, beam=BEAM, plan="auto", stats=stats)
        lat[stats].append(time.perf_counter() - t0)
    pb, st = on[2], on[3]
    by_plan = {}
    for p, name in PLAN_NAMES.items():
        rows = pb.plans == p
        if rows.any():
            by_plan[name] = {"rows": int(rows.sum()),
                             "hit_max_iters_share": float(st.hit_max_iters[rows].mean()),
                             "iters_mean": float(st.iters[rows].mean()),
                             "cand_valid_mean": float(st.cand_valid[rows].mean()),
                             "kept_mean": float(st.kept[rows].mean()),
                             "visited_mean": float(st.visited[rows].mean())}
    return {"batch": len(qv), "by_plan": by_plan,
            "iters_mean": float(st.iters.mean()), "cand_valid_mean": float(st.cand_valid.mean()),
            "hit_max_iters_share": float(st.hit_max_iters.mean()),
            "launches_per_iteration_off": per_iter_off, "launches_per_iteration_counted": per_iter,
            "counted_batches": batches, "loop_syncs_off": loop_off["syncs"],
            "loop_syncs_on": loop_on["syncs"],
            "batch_ms_off": [x * 1e3 for x in lat[False]], "batch_ms_on": [x * 1e3 for x in lat[True]],
            "on_off_ratio": statistics.median(lat[True]) / statistics.median(lat[False])}


STREAM_KERNELS = ("filter_dist_gather_packed", "beam_merge", "filter_dist_gather")


def stream_phase(n: int, work: Path) -> tuple:
    """The streaming index (``repro_torch.stream``) at the serving shard's
    shape, on the card; returns the kernel launches of its searches by
    search, the index after its epoch swap and the phase's queries (the
    serving phase serves them through a ``StreamingServer``). Sizes scale with ``n`` (65536: node capacity 65536, delta
    capacity 8192, 12288 objects loaded, 2048 mutations logged):

    1. construct with the shard's capacities and build settings;
    2. load through ``insert_batch``: each full delta forces a compaction
       (at 8192 objects), each reported;
    3. a snapshot, then a ``WriteAheadLog(sync="always")``: 2048 inserts and
       deletes of 1 % of the live objects, over both tiers, each
       acknowledged after its fsync;
    4. 4096 queries at the main path's selectivities with ``plan`` auto,
       graph and wide: B1, B2 and B3 launch on each; QPS, latency, plan
       mix, recall@10 against exact ground truth over the live set, mean
       ``delta_valid``, device bytes;
    5. guarantees: 256 acknowledged inserts, each queried by its own vector
       and interval, come back first at distance 0; no deleted id in any
       result of the phase;
    6. ``recover`` into a new index on the card: the same batch's ids and
       distances bit for bit;
    7. ``STREAM_CPU_QUERIES`` (16) queries on the CPU (plain versions)
       against the card;
    8. ``fused=False`` on 128 queries: B4 launches; ids equal the fused
       path's under the tie rule;
    9. an epoch swap: ``build_epoch`` on a thread while auto batches are
       served (the pre-swap results, bit for bit), then the swap: the delta
       drained, the tombstones cleared, every device shape and each kernel
       library unchanged, recall over the new live set."""
    import threading

    from repro_torch.core.predicates import get_relation
    from repro_torch.exec.plan import plan_queries
    from repro_torch.search.batched import prepare_states_extended as prep
    from repro_torch.stream import StreamingIndex, WriteAheadLog, recover

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    scale = n / FULL_N
    ncap, dcap = n, n // 8
    n_load, n_mut = (3 * n) // 16, n // 32
    res = {"node_capacity": ncap, "delta_capacity": dcap, "edge_capacity": 768,
           "loaded": n_load, "logged_inserts": n_mut}
    reports, deleted, seen = [], set(), []
    kw = dict(node_capacity=ncap, delta_capacity=dcap, edge_capacity=768, M=16, Z=128, K_p=8)
    idx = StreamingIndex(DIM, CONFIG.relation, on_epoch_swap=reports.append, **kw)
    dev = idx.device

    # 2. load
    vecs, s, t = make_dataset(n_load, DIM, seed=1)
    t0 = time.perf_counter()
    idx.insert_batch(vecs, s, t)
    res["load_s"] = time.perf_counter() - t0
    res["compactions"] = [dataclasses.asdict(r) for r in reports]
    require(len(reports) == n_load // dcap - (n_load % dcap == 0),
            f"{len(reports)} compactions while loading")
    res["graph_max_labeled_degree"] = int((idx._dg.nbr >= 0).sum(axis=1).max())

    # 3. snapshot, then logged mutations
    t0 = time.perf_counter()
    snap = idx.save_snapshot(str(work))
    res["snapshot_s"], res["snapshot_bytes"] = time.perf_counter() - t0, os.path.getsize(snap)
    wal = WriteAheadLog(str(work), sync="always")
    idx.attach_wal(wal)
    mv, ms_, mt = make_dataset(n_mut, DIM, seed=2)
    t0 = time.perf_counter()
    acked = idx.insert_batch(mv, ms_, mt)
    res["inserts_per_s"] = n_mut / (time.perf_counter() - t0)
    rng = np.random.default_rng(4)
    live_ids = idx.live_ids()
    victims = rng.choice(live_ids, len(live_ids) // 100, replace=False)
    keep_acked = np.setdiff1d(acked, victims)
    t0 = time.perf_counter()
    for e in victims:
        require(idx.delete(int(e)), f"delete of live id {e} refused")
    res["deletes_per_s"] = len(victims) / (time.perf_counter() - t0)
    deleted.update(int(e) for e in victims)
    in_graph = int(np.isin(victims, idx._graph_ext[:idx._graph_n]).sum())
    res.update(deletes=len(victims), deletes_in_graph=in_graph, deletes_in_delta=len(victims) - in_graph,
               wal_sync="always", live=idx.live_count, graph_n=idx._graph_n,
               delta_live=idx._delta.live_count)
    require(0 < in_graph < len(victims), "the deletes did not reach both tiers")

    # 4. searches
    lv, ls, lt, lext = idx.snapshot_live()
    qv, s_q, t_q = make_queries(BATCH, ls, lt, SELECTIVITIES, 11)
    n_gt = min(1024, BATCH)
    qs = ground_truth(QuerySet(CONFIG.relation, qv[:n_gt], s_q[:n_gt], t_q[:n_gt], 0.0,
                               np.zeros(n_gt), K), lv, ls, lt)
    qs.gt_ids = np.where(qs.gt_ids >= 0, lext[np.maximum(qs.gt_ids, 0)], -1)
    states, _, invalid = prep(idx._dg, s_q, t_q)
    res["plan_mix"] = plan_queries(idx._dg.planner, states, invalid,
                                   config=default_planner_config()).mix()
    launches, searches = {}, {}
    for plan in ("auto", "graph", "wide"):
        reset_counts()
        lat = []
        for _ in range(1 + 3):
            t0 = time.perf_counter()
            ids, d = idx.search(qv, s_q, t_q, k=K, beam=BEAM, plan=plan)
            lat.append(time.perf_counter() - t0)
        launches[plan] = dict(ops.LAUNCHES)
        for name in STREAM_KERNELS:
            require(launches[plan][name] > 0, f"{name} never launched on the streaming {plan} search")
        require(ids.shape == (BATCH, K) and np.all(np.isfinite(d)), f"streaming {plan} result")
        seen.append(ids)
        searches[plan] = {"qps": BATCH / statistics.median(lat[1:]),
                          "p50_batch_ms": float(np.percentile(lat[1:], 50) * 1e3),
                          "p99_batch_ms": float(np.percentile(lat[1:], 99) * 1e3),
                          "warmup_batch_ms": lat[0] * 1e3, "recall_at_10": recall_at_k(ids[:n_gt], qs),
                          "launches": launches[plan], "loop_iterations": search_mod.LOOP_STATS["iterations"]}
        if plan == "auto":
            want = (ids, d)
    res["searches"] = searches
    by_name = traced_ms(lambda: idx.search(qv, s_q, t_q, k=K, beam=BEAM, plan="auto"))
    busy = sum(t for t, _ in by_name.values())
    res["auto_profile"] = {
        "device_busy_ms": busy, "idle_share": 1.0 - busy / searches["auto"]["p50_batch_ms"],
        "top": [[k[:60], round(t, 3), c] for k, (t, c) in
                sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]]}
    *_, st = idx.search(qv, s_q, t_q, k=K, beam=BEAM, plan="auto", return_stats=True)
    res["delta_valid_mean"] = float(st.delta_valid.mean())
    res["hit_max_iters_share"] = float(st.hit_max_iters.mean())
    di = idx._dg.device(dev)
    mut = idx._device_mutables(dev)
    res["device_bytes"] = {
        "graph_tier": sum(v.numel() * v.element_size() for v in vars(di).values() if v is not None),
        "delta": sum(v.numel() * v.element_size() for v in mut[2:]),
        "live_and_ext": sum(v.numel() * v.element_size() for v in mut[:2]),
        "materialized_labels": BATCH * dcap * 16, "materialized_slots": BATCH * dcap * 4}

    # 5. guarantees
    g = min(256, len(keep_acked))
    pick = rng.choice(keep_acked, g, replace=False)
    rows = pick - acked[0]
    ids, d = idx.search(mv[rows], ms_[rows], mt[rows], k=K, beam=BEAM, plan="auto")
    seen.append(ids)
    require(np.array_equal(ids[:, 0], pick) and np.all(d[:, 0] == 0.0),
            "an acknowledged insert did not come back first at distance 0")
    res["acked_read_back"] = g

    # 6. recovery
    wal.close()
    idx.attach_wal(None)
    # the directory as a crash leaves it, torn later by the fault phase
    shutil.rmtree(FAULT_WORK, ignore_errors=True)
    copy_durable(work, FAULT_WORK / "stream_dir")
    FAULT.update(stream_kw=kw, deleted=deleted)
    t0 = time.perf_counter()
    rec, rep = recover(str(work), dim=DIM, relation=CONFIG.relation, device="cuda", **kw)
    torch.cuda.synchronize()
    res["recovery_s"] = time.perf_counter() - t0
    got = rec.search(qv, s_q, t_q, k=K, beam=BEAM, plan="auto")
    require(np.array_equal(got[0], want[0]) and
            np.array_equal(got[1].view(np.int32), want[1].view(np.int32)),
            "the recovered index's results differ from the live index's")
    res["recovery"] = {"records_replayed": rep.records_replayed, "snapshot_found": rep.snapshot_found,
                       "truncated": rep.truncated, "live_count": rep.live_count, "bit_equal": True}
    rec._wal.close()
    del rec

    # 7. card against CPU
    sub = slice(0, STREAM_CPU_QUERIES)
    t0 = time.perf_counter()
    ids_c, d_c = idx.search(qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM, plan="auto", device="cpu")
    res["cpu_s"] = time.perf_counter() - t0
    ids_g, d_g = idx.search(qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM, plan="auto")
    bad = mismatches(ids_c, d_c, ids_g, d_g)
    require(not bad, f"streaming card vs CPU: {bad[:5]}")
    res["cpu_parity"] = {"queries": STREAM_CPU_QUERIES,
                         "ids_equal": bool(np.array_equal(ids_c, ids_g))}
    idx._dg._cache.pop(("device", "cpu"), None)
    idx._dev_mut.pop("cpu", None)

    # 8. unfused baseline
    sub = slice(0, 128)
    reset_counts()
    t0 = time.perf_counter()
    un = idx.search(qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM, plan="graph", fused=False)
    res["unfused_batch_ms"] = (time.perf_counter() - t0) * 1e3
    launches["unfused"] = dict(ops.LAUNCHES)
    require(launches["unfused"]["filter_dist"] > 0, "B4 never launched on the streaming unfused search")
    fu = idx.search(qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM, plan="graph")
    bad = mismatches(*fu, *un)
    require(not bad, f"streaming unfused vs fused: {bad[:5]}")
    seen += [un[0], fu[0]]
    res["unfused"] = {"queries": 128, "ids_equal": bool(np.array_equal(un[0], fu[0])),
                      "launches": launches["unfused"]}

    # 9. epoch swap while serving (outside any counted section)
    shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in vars(idx._dg.device(dev)).items()
              if v is not None}
    libs = {k: id(v) for k, v in _build._libs.items()}
    pre_epoch, pre_dead, pre_delta = idx.epoch, idx.graph_dead, idx._delta.live_count
    job = idx.begin_compaction()
    err: list = []

    def build():
        try:
            idx.build_epoch(job)
        except BaseException as exc:   # re-raised below
            err.append(exc)

    build_thread = threading.Thread(target=build)
    t0 = time.perf_counter()
    build_thread.start()
    served = 0
    while build_thread.is_alive() and served < 8:
        ids, d = idx.search(qv, s_q, t_q, k=K, beam=BEAM, plan="auto")
        require(np.array_equal(ids, want[0]) and np.array_equal(d.view(np.int32), want[1].view(np.int32)),
                "a batch served during the rebuild differs from the pre-swap index's")
        served += 1
    build_thread.join()
    require(not err, f"build_epoch failed: {err}")
    swap = idx.finish_compaction(job)
    res["epoch_swap"] = {**dataclasses.asdict(swap), "wall_s": time.perf_counter() - t0,
                         "batches_served_during_build": served}
    require(idx.epoch == pre_epoch + 1 and idx._delta.live_count == 0 and idx.graph_dead == 0,
            "the swap left delta objects or tombstones")
    require(swap.delta_drained == pre_delta and swap.tombstones_cleared == pre_dead, "swap report")
    require({k: (tuple(v.shape), str(v.dtype)) for k, v in vars(idx._dg.device(dev)).items()
             if v is not None} == shapes, "the epoch swap changed a device shape")
    require({k: id(v) for k, v in _build._libs.items()} == libs, "a kernel library was rebuilt")
    lv2, ls2, lt2, lext2 = idx.snapshot_live()
    qs2 = ground_truth(QuerySet(CONFIG.relation, qv[:n_gt], s_q[:n_gt], t_q[:n_gt], 0.0,
                                np.zeros(n_gt), K), lv2, ls2, lt2)
    qs2.gt_ids = np.where(qs2.gt_ids >= 0, lext2[np.maximum(qs2.gt_ids, 0)], -1)
    ids, d = idx.search(qv, s_q, t_q, k=K, beam=BEAM, plan="auto")
    seen.append(ids)
    res["epoch_swap"]["recall_at_10"] = recall_at_k(ids[:n_gt], qs2)
    res["epoch_swap"]["shapes_unchanged"] = True
    for ids in seen:
        require(not np.isin(ids, list(deleted)).any(), "a deleted id came back")
    res["no_deleted_id"] = True
    res["live_after_swap"] = idx.live_count
    if n != FULL_N:
        res["scale"] = scale
    emit({"reduced": {"stream_live": [ncap, idx.live_count],
                      "why": "the JAX package has no bulk load: loading through insert costs one "
                             "rebuild per delta fill (the full shard: 7 rebuilds of up to 57344 "
                             "nodes); 3n/16 objects, one rebuild, keep the script with the "
                             "segmented phase within the run's time limit"}})
    emit({"stream": res})
    shutil.rmtree(work, ignore_errors=True)
    return launches, idx, (qv, s_q, t_q)


SERVE_SHARDS = 4              # the serving phase's round-robin shards
SERVE_TIMED = 3               # timed batches per (plan, merge) after one warm-up
SERVE_SUB = 1024              # queries of the unfused and stats steps
SERVE_CPU_QUERIES = 16        # card against CPU (reduced from 64: the run's time limit)
OVERLOAD_ROUNDS = 8
SHARDED_STREAM = dict(node_capacity=8192, delta_capacity=1024, edge_capacity=768, M=16, Z=128,
                      K_p=8, build_kwargs=dict(batched=True))
SHARDED_STREAM_LOAD = 3000    # objects a shard, whatever n: compactions at 1024 and 2048


def shard_graph(idx, j):
    """Shard ``j`` of a ``ShardedIndex`` as a ``DeviceGraph`` on the card (its
    f32 grids widened to f64, so ``execute_batch`` snaps f32-valued queries
    as the serving step does)."""
    from repro_torch.search.device_graph import device_graph_from_numpy

    kx, ky = int(np.isfinite(idx.U_X[j]).sum()), int(idx.num_y[j])
    packed = idx.labels.dtype == np.uint32
    arrays = {"vectors": idx.vectors[j], "nbr": idx.nbr[j], "norms": idx.norms[j],
              "plabels": idx.labels[j] if packed else None,
              "labels": None if packed else idx.labels[j],
              "U_X": idx.U_X[j, :kx].astype(np.float64), "U_Y": idx.U_Y[j, :ky].astype(np.float64),
              "entry_node": idx.entry_node[j, :kx], "entry_y_rank": idx.entry_y_rank[j, :kx],
              "relation": idx.relation}
    return device_graph_from_numpy(arrays, planner=idx.planners[j], device="cuda")


@contextlib.contextmanager
def held_launches(what: str, cases: list):
    """Every launch of B1-B4 inside the block held bitwise against its plain
    version on the same inputs (copied before the launch, since B2 sets the
    visited bits in place): all four outputs of B2 and the bitmap after it.
    Appends one case per (kernel, shape, tile) to ``cases``, with the
    launches held. The kernels are launched through the committed wrappers,
    so the launch counts see them; a held run is never a counted one."""
    wrapped = {name: getattr(ops, name) for name in
               ("filter_dist_gather_packed", "filter_dist_gather", "filter_dist", "beam_merge")}
    seen: dict = {}

    def note(kernel, shape, tile=None):
        key = (kernel, shape, tile)
        seen[key] = seen.get(key, 0) + 1

    def packed(*args, scales=None):
        out = wrapped["filter_dist_gather_packed"](*args, scales=scales)
        bitwise(out, ref.filter_dist_gather_packed_ref(*args, scales), f"filter_dist_gather_packed ({what})")
        B, C = args[5].shape
        note("filter_dist_gather_packed", (B, C), ops.scorer_tile(B, C, ops._sm_count(out.device)))
        return out

    def gather(*args, scales=None):
        out = wrapped["filter_dist_gather"](*args, scales=scales)
        bitwise(out, ref.filter_dist_gather_ref(*args, scales), f"filter_dist_gather ({what})")
        B, C = args[3].shape
        note("filter_dist_gather", (B, C), ops.scorer_tile(B, C, ops._sm_count(out.device)))
        return out

    def dense(*args):
        out = wrapped["filter_dist"](*args)
        bitwise(out, ref.filter_dist_ref(*args), f"filter_dist ({what})")
        note("filter_dist", tuple(args[1].shape))
        return out

    def merge(*args, n, visited=None):
        want_vis = None if visited is None else visited.clone()
        want = ref.beam_merge_ref(*args, n=n, visited=want_vis)
        got = wrapped["beam_merge"](*args, n=n, visited=visited)
        same_merge(got, want, what)
        require(visited is None or torch.equal(visited, want_vis),
                f"beam_merge visited bits differ from the plain version ({what})")
        note("beam_merge", (args[0].shape[0], args[0].shape[1], args[3].shape[1]))
        return got

    for name, fn in (("filter_dist_gather_packed", packed), ("filter_dist_gather", gather),
                     ("filter_dist", dense), ("beam_merge", merge)):
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)
    for (kernel, shape, tile), count in sorted(seen.items()):
        dims = dict(zip(("B", "L", "C") if kernel == "beam_merge" else
                        ("B", "E", "D") if kernel == "filter_dist" else ("B", "C"), shape))
        cases.append({"kernel": f"{kernel} ({what})", **dims, **({"tile": tile} if tile else {}),
                      "launches_held": count, "max_abs_err": 0.0})


def overload(idx, qv, s_q, t_q, srv_cls, adm_mod) -> dict:
    """``bench_serving.py``'s 2x overload loop at batch 4096 over ``idx``:
    every degradation rung searched first, a calibration, then
    ``OVERLOAD_ROUNDS`` rounds that each offer two batches and serve one
    through an ``AdmissionController(max_queue=4·batch)``, gated on
    ``shed > 0``, the queue bound and the admitted p99 within the deadline.

    The deadline is the bench's: 10x the calibrated step of an ``auto``
    server (its last batch, timed alone). Each calibration round is also
    timed whole (a batch's submits and its step), and a ``graph`` server,
    the overload rung, is calibrated beside it; those times are reported."""
    n_q = len(qv)
    degraded = dataclasses.replace(default_planner_config(), wide_max_fraction=0.0)
    rungs = {}
    for name, kw in (("auto", dict(plan="auto")), ("no_wide", dict(plan="auto", planner_config=degraded)),
                     ("graph", dict(plan="graph"))):
        t0 = time.perf_counter()
        idx.search(qv[:BATCH], s_q[:BATCH], t_q[:BATCH], k=K, beam=BEAM, **kw)
        rungs[name] = (time.perf_counter() - t0) * 1e3
    round_s, step_s = {}, {}
    for plan in ("auto", "graph"):
        cal = srv_cls(idx, batch_size=BATCH, k=K, beam=BEAM, timeout_s=0.0, plan=plan)
        round_s[plan], step_s[plan] = [], []
        for r in range(2):
            t0 = time.monotonic()
            for i in range(BATCH):
                cal.submit(qv[i % n_q], s_q[i % n_q], t_q[i % n_q])
            t1 = time.monotonic()
            ans = cal.step(force=True)
            round_s[plan].append(time.monotonic() - t0)
            step_s[plan].append(time.monotonic() - t1)
            if r == 0:      # one full batch answers as index.search does, bit for bit
                want = idx.search(qv[:BATCH], s_q[:BATCH], t_q[:BATCH], k=K, beam=BEAM, plan=plan)
                got_i = np.stack([ans[i][0] for i in range(BATCH)])
                got_d = np.stack([ans[i][1] for i in range(BATCH)])
                require(np.array_equal(got_i, want[0]) and
                        np.array_equal(got_d.view(np.int32), want[1].view(np.int32)),
                        f"the server's answers to a full {plan} batch differ from index.search")
    res = {"rung_batch_ms": rungs, "calibration_round_s": round_s, "calibration_step_s": step_s,
           "submit_us": (round_s["auto"][-1] - step_s["auto"][-1]) / BATCH * 1e6}

    batch_s = step_s["auto"][-1]
    max_queue = 4 * BATCH
    deadline_s = max(0.1, 10.0 * batch_s)
    adm = adm_mod.AdmissionController(
        adm_mod.AdmissionConfig(max_queue=max_queue, default_deadline_s=deadline_s,
                                min_batches_for_prediction=1), batch_size=BATCH)
    srv = srv_cls(idx, batch_size=BATCH, k=K, beam=BEAM, timeout_s=0.0, admission=adm)
    adm.observe_batch(batch_s)
    offered = shed = max_depth = 0
    answered, submit_times, j = {}, {}, 0
    submits_s, steps_s = [], []
    t_all = time.monotonic()
    r = 0
    while r < OVERLOAD_ROUNDS or srv.batcher.pending:      # the rounds, then the tail
        t0 = time.monotonic()
        if r < OVERLOAD_ROUNDS:
            for _ in range(2 * BATCH):
                offered += 1
                try:
                    rid = srv.submit(qv[j % n_q], s_q[j % n_q], t_q[j % n_q])
                    submit_times[rid] = time.monotonic()
                except adm_mod.RequestShed:
                    shed += 1
                j += 1
            max_depth = max(max_depth, srv.batcher.pending)
        r += 1
        t1 = time.monotonic()
        out = srv.step(force=True)
        now = time.monotonic()
        submits_s.append(t1 - t0)
        steps_s.append(now - t1)
        for rid in out:
            answered[rid] = now - submit_times.pop(rid)
    lats = np.sort(np.fromiter(answered.values(), float))
    rec = {"offered": offered, "admitted": adm.admitted, "answered": len(answered), "shed": shed,
           "expired_in_queue": len(submit_times), "deadline_s": deadline_s,
           "batch_service_s": batch_s, "max_queue": max_queue, "max_observed_depth": max_depth,
           "admitted_p50_s": float(np.percentile(lats, 50)),
           "admitted_p99_s": float(np.percentile(lats, 99)),
           "round_submits_s": submits_s[:OVERLOAD_ROUNDS], "steps_s": steps_s,
           "wall_s": time.monotonic() - t_all}
    require(shed > 0, f"2x overload must shed: {rec}")
    require(max_depth <= max_queue, f"queue bound violated: {rec}")
    require(rec["admitted_p99_s"] <= deadline_s, f"admitted p99 blew the deadline: {rec}")
    res["overload_2x"] = rec
    return res


def serve_phase(n: int, vecs, s, t, qv, s_q, t_q, gt_auto, stream_idx, stream_q, out: Path) -> dict:
    """The serving layer (``repro_torch.serve``) on the card; returns the
    kernel launches of each counted run. Sizes scale with ``n``:

    1. ``build_sharded_index``: ``SERVE_SHARDS`` round-robin shards of the
       main path's corpus (16384 rows each at n = 65536), the wave
       constructor on the card with M 16, Z 128, K_p 8, padded to the
       shard's own size (``CONFIG.build_kwargs(pad_nodes=n // 4)``);
    2. every launch of B1-B3 in one auto batch, and of B4 in the unfused
       step, held bitwise against the plain version on its inputs
       (``held_launches``: the kernels at the shapes and tiles the shards
       give them, outside the counted runs); then the launcher's own loop (``launch.serve.serve_requests``: the
       request batcher, then ``serve_batch``) over the main path's 4096
       queries with ``plan`` auto and graph and both merges: B1 and B2 on
       every batch, B3 on the auto batches (the planner plans BRUTE_VALID
       inside shards; where it plans none, the lowest selectivity is lowered
       until it does); the two merges equal under the tie rule; recall@10,
       QPS, p50 and p99, the plan mix per shard; ``fused=False`` (B4) equal
       to the fused step; the stats step's counters equal to the sum of each
       shard's ``execute_batch(stats=True)``; the auto batch again on a
       ``data=2`` mesh (its two query slices in turn), bit-equal to the data-1
       answer, with B1-B3's launches per slice;
    3. ``SERVE_CPU_QUERIES`` queries on the CPU mesh (plain versions) against
       the card;
    4. a one-rank NCCL process group on the card (a FileStore under
       ``out``): bit-equal to the single-process mesh;
    5. ``StreamingServer`` over the streaming phase's index: the overload
       loop (``overload``), then one ``maybe_compact_async`` swap while the
       server steps;
    6. ``ShardedStreamingIndex`` of 2 shards (node 8192, delta 1024, 3000
       objects a shard, at any n): ``search`` and ``serve_streaming_batch`` equal under
       the tie rule, B1-B3 launched by the stacked step and each launch of
       one stacked step held as in 2, ``refresh_shard``
       after a per-shard compaction keeps the old dict."""
    import torch.distributed as dist

    from repro_torch.core.predicates import get_relation
    from repro_torch.distributed import make_host_mesh, make_process_mesh
    from repro_torch.launch.serve import serve_requests
    from repro_torch.serve import (
        RequestBatcher,
        ShardedIndex,
        ShardedStreamingIndex,
        StreamingServer,
        build_sharded_index,
        make_serving_step,
        make_streaming_serving_step,
        plan_sharded_batch,
        serve_batch,
        serve_streaming_batch,
    )
    from repro_torch.serve import admission as adm_mod
    from repro_torch.serve.distributed import STACK_FIELDS
    from repro_torch.stream import CompactionPolicy

    S = SERVE_SHARDS
    rel = get_relation(CONFIG.relation)
    launches, res = {}, {}

    # 1. the sharded index
    t0 = time.perf_counter()
    idx = build_sharded_index(vecs, s, t, CONFIG.relation, S, M=16, Z=128, K_p=8,
                              build_kwargs=CONFIG.build_kwargs(pad_nodes=n // S), device="cuda")
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    mesh = make_host_mesh(S, device="cuda")
    dev = idx.device(mesh.device)
    res.update(shards=S, rows_per_shard=idx.n_local, E=int(idx.nbr.shape[2]),
               labels=str(idx.labels.dtype),
               device_bytes=sum(v.numel() * v.element_size() for v in dev.values()),
               device_bytes_per_shard=sum(v.numel() * v.element_size() for v in dev.values()) / S)
    emit({"reduced": {"serve_rows_per_shard": [CONFIG.n_per_shard, idx.n_local],
                      "why": "four shards of the deployment's 65536 rows would take four builds of "
                             "about 130 s each, beyond the run's time limit"}})

    # 2. batches through the launcher's loop
    def plan_mix(qq_s, qq_t):
        xq, yq = rel.query_map(qq_s, qq_t)
        plans, _ = plan_sharded_batch(idx, np.float32(xq), np.float32(yq), config=default_planner_config())
        return plans, [{PLAN_NAMES[p]: int((plans[j] == p).sum()) for p in PLAN_NAMES} for j in range(S)]

    t0 = time.perf_counter()
    plans, mix = plan_mix(s_q, t_q)
    res["plan_ms"] = (time.perf_counter() - t0) * 1e3     # the host planner, all shards
    res["plan_mix_per_shard"] = mix
    sels, gt = SELECTIVITIES, gt_auto
    while not (plans == int(QueryPlan.BRUTE_VALID)).any():
        require(sels[0] > 1e-5, "no selectivity gives a BRUTE_VALID row")
        sels = (sels[0] / 3,) + tuple(sels[1:])
        qv, s_q, t_q = make_queries(BATCH, s, t, sels, 1)
        gt = ground_truth(QuerySet(CONFIG.relation, qv[:1024], s_q[:1024], t_q[:1024], 0.0,
                                   np.zeros(1024), K), vecs, s, t).gt_ids
        plans, mix = plan_mix(s_q, t_q)
        res["lowered_selectivities"] = {"selectivities": sels, "plan_mix_per_shard": mix}
    qs = QuerySet(CONFIG.relation, qv[:1024], s_q[:1024], t_q[:1024], 0.0, np.zeros(1024), K, gt_ids=gt)
    # every kernel launch of one auto batch held against its plain version
    # at the shapes (and tiles) the shards give it: the graph batch's
    # shapes (L 64, C 320) are among them
    held = []
    with held_launches("serving auto batch", held):
        serve_batch(idx, mesh, qv, s_q, t_q, k=K, beam=BEAM)
    held_names = {c["kernel"].split(" (")[0] for c in held}
    require({"filter_dist_gather_packed", "beam_merge", "filter_dist_gather"} <= held_names,
            f"the held serving batches launched only {sorted(held_names)}")
    runs, results = {}, {}
    for plan in ("auto", "graph"):
        for merge in ("all_gather", "tournament"):
            batcher = RequestBatcher(BATCH, DIM)
            for _ in range(1 + SERVE_TIMED):
                for i in range(BATCH):
                    batcher.submit(qv[i], s_q[i], t_q[i])
            reset_counts()
            t0 = time.perf_counter()
            ids, d, secs = serve_requests(idx, mesh, batcher, BATCH * (1 + SERVE_TIMED), k=K, beam=BEAM,
                                          merge=merge, plan=plan)
            wall = time.perf_counter() - t0
            key = f"{plan}/{merge}"
            launches[key] = dict(ops.LAUNCHES)
            for name in ("filter_dist_gather_packed", "beam_merge"):
                require(launches[key][name] >= 1 + SERVE_TIMED, f"{name} not launched on every {key} batch")
            if plan == "auto":
                require(launches[key]["filter_dist_gather"] >= 1 + SERVE_TIMED,
                        f"B3 not launched on every {key} batch")
            ids = ids.reshape(1 + SERVE_TIMED, BATCH, K)
            d = d.reshape(1 + SERVE_TIMED, BATCH, K)
            require(all(np.array_equal(ids[b], ids[0]) and np.array_equal(d[b], d[0])
                        for b in range(1, 1 + SERVE_TIMED)), f"the {key} batches answered differently")
            ids, d = ids[0], d[0]
            require(np.all(np.isfinite(d)), f"serving {key} result")
            results[key] = (ids, d)
            timed = secs[1:]
            runs[key] = {"qps": BATCH / statistics.median(timed),
                         "p50_batch_ms": float(np.percentile(timed, 50) * 1e3),
                         "p99_batch_ms": float(np.percentile(timed, 99) * 1e3),
                         "warmup_batch_ms": secs[0] * 1e3,
                         "loop_wall_per_batch_ms": wall / (1 + SERVE_TIMED) * 1e3,
                         "recall_at_10": recall_at_k(ids[:1024], qs), "launches": launches[key],
                         "loop_iterations": search_mod.LOOP_STATS["iterations"]}
    for plan in ("auto", "graph"):
        bad = mismatches(*results[f"{plan}/all_gather"], *results[f"{plan}/tournament"])
        require(not bad, f"the two merges differ on {plan}: {bad[:5]}")
        runs[f"{plan}/tournament"]["ids_equal_all_gather"] = bool(np.array_equal(
            results[f"{plan}/all_gather"][0], results[f"{plan}/tournament"][0]))
    res["batches"] = runs
    by_name = traced_ms(lambda: serve_batch(idx, mesh, qv, s_q, t_q, k=K, beam=BEAM))
    busy = sum(t for t, _ in by_name.values())
    res["auto_profile"] = {
        "device_busy_ms": busy, "idle_share": 1.0 - busy / runs["auto/all_gather"]["p50_batch_ms"],
        "top": [[k[:60], round(t, 3), c] for k, (t, c) in
                sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]]}
    # the query axis: the auto batch again at data 2 (its two slices in turn
    # on the card), bit-equal to the data-1 answer
    want_i, want_d = serve_batch(idx, mesh, qv, s_q, t_q, k=K, beam=BEAM)
    mesh2 = make_host_mesh(S, data=2, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    ids2, d2 = serve_batch(idx, mesh2, qv, s_q, t_q, k=K, beam=BEAM)
    data2_s = time.perf_counter() - t0
    launches["auto/data2"] = dict(ops.LAUNCHES)
    require(np.array_equal(ids2, want_i) and np.array_equal(d2.view(np.int32), want_d.view(np.int32)),
            "the data-2 auto batch differs from the data-1 answer")
    for name in ("filter_dist_gather_packed", "beam_merge", "filter_dist_gather"):
        require(launches["auto/data2"][name] >= 2, f"{name} not launched on both data-2 slices")
    res["data2"] = {"mesh": dict(zip(mesh2.axis_names, mesh2.shape)), "slices": mesh2.queries,
                    "queries_per_slice": BATCH // mesh2.queries, "batch_ms": data2_s * 1e3,
                    "bit_equal_data1": True, "launches": launches["auto/data2"],
                    "launches_per_slice": {k: v / mesh2.queries
                                           for k, v in launches["auto/data2"].items()},
                    "data1_launches": launches["auto/all_gather"]}

    # the unfused step (B4) against the fused one, and the stats step against
    # each shard's own counters, on SERVE_SUB queries snapped to f32
    sub = slice(0, SERVE_SUB)
    s32 = s_q[sub].astype(np.float32).astype(np.float64)
    t32 = t_q[sub].astype(np.float32).astype(np.float64)
    xq, yq = rel.query_map(s32, t32)
    args = [dev[f] for f in STACK_FIELDS] + [qv[sub], np.float32(xq), np.float32(yq)]
    fused = make_serving_step(mesh, CONFIG.relation, k=K, beam=BEAM)(*args)
    with held_launches("serving unfused step", held):
        make_serving_step(mesh, CONFIG.relation, k=K, beam=BEAM, fused=False)(*args)
    require(any(c["kernel"].startswith("filter_dist (") for c in held), "the held unfused step ran no B4")
    res["held_kernel_cases"] = held
    reset_counts()
    t0 = time.perf_counter()
    unfused = make_serving_step(mesh, CONFIG.relation, k=K, beam=BEAM, fused=False)(*args)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    launches["unfused"] = dict(ops.LAUNCHES)
    require(launches["unfused"]["filter_dist"] > 0, "B4 never launched on the unfused serving step")
    bad = mismatches(fused[0].cpu().numpy(), fused[1].cpu().numpy(),
                     unfused[0].cpu().numpy(), unfused[1].cpu().numpy())
    require(not bad, f"unfused serving step vs fused: {bad[:5]}")
    res["unfused"] = {"queries": SERVE_SUB, "batch_ms": unfused_s * 1e3, "launches": launches["unfused"],
                      "ids_equal": bool(torch.equal(fused[0], unfused[0]))}
    _, _, pq = make_serving_step(mesh, CONFIG.relation, k=K, beam=BEAM, stats=True)(*args)
    summed = {}
    for j in range(S):
        st = execute_batch(shard_graph(idx, j), qv[sub], s32, t32, k=K, beam=BEAM, plan="graph",
                           stats=True, device="cuda")[2]
        for f in pq:
            summed[f] = summed.get(f, 0) + np.asarray(getattr(st, f), np.int64)
    for f, v in pq.items():
        require(np.array_equal(v.cpu().numpy(), summed[f]), f"summed counter {f} differs")
    res["stats_step"] = {"queries": SERVE_SUB, "equal_to_shard_sums": True,
                         "iters_mean": float(pq["iters"].float().mean()),
                         "hit_max_iters_shards_mean": float(pq["hit_max_iters"].float().mean())}

    # 3. card against CPU
    cpu_mesh = make_host_mesh(S, device="cpu")
    sub = slice(0, SERVE_CPU_QUERIES)
    t0 = time.perf_counter()
    ids_c, d_c = serve_batch(idx, cpu_mesh, qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM)
    cpu_s = time.perf_counter() - t0
    ids_g, d_g = serve_batch(idx, mesh, qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM)
    bad = mismatches(ids_c, d_c, ids_g, d_g)
    require(not bad, f"serving card vs CPU: {bad[:5]}")
    res["cpu_parity"] = {"queries": SERVE_CPU_QUERIES, "cpu_s": cpu_s,
                         "ids_equal": bool(np.array_equal(ids_c, ids_g))}
    idx.invalidate_device()
    dev = idx.device(mesh.device)

    # 4. one-rank NCCL process group on the card, against the single-process mesh
    one = ShardedIndex(**{f: getattr(idx, f)[:1] for f in STACK_FIELDS}, relation=idx.relation,
                       n_local=idx.n_local, planners=idx.planners[:1])
    single = make_host_mesh(1, device="cuda")
    want = {(p, m): serve_batch(one, single, qv, s_q, t_q, k=K, beam=BEAM, plan=p, merge=m)
            for p in ("auto", "graph") for m in ("all_gather", "tournament")}
    xq, yq = rel.query_map(s_q, t_q)
    one_args = [one.device("cuda")[f] for f in STACK_FIELDS] + [qv, np.float32(xq), np.float32(yq)]
    want_st = make_serving_step(single, CONFIG.relation, k=K, beam=BEAM, stats=True)(*one_args)
    torch.cuda.set_device(0)
    store = out / "nccl_store"             # a FileStore: no port to race for
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store.resolve()}", world_size=1, rank=0)
    try:
        pmesh = make_process_mesh(device="cuda")
        for (p, m), (wi, wd) in want.items():
            gi, gd = serve_batch(one, pmesh, qv, s_q, t_q, k=K, beam=BEAM, plan=p, merge=m)
            require(np.array_equal(gi, wi) and np.array_equal(gd.view(np.int32), wd.view(np.int32)),
                    f"the NCCL process group differs from the single-process mesh on {p}/{m}")
        got_st = make_serving_step(pmesh, CONFIG.relation, k=K, beam=BEAM, stats=True)(*one_args)
        require(torch.equal(got_st[0], want_st[0]) and all(
            torch.equal(got_st[2][f], want_st[2][f]) for f in want_st[2]),
            "the NCCL stats step differs from the single-process mesh")
    finally:
        dist.destroy_process_group()
    res["nccl_one_rank"] = {"world_size": 1, "backend": "nccl", "bit_equal": True,
                            "cases": [f"{p}/{m}" for p, m in want] + ["stats"]}
    emit({"serve": res, "card": RECORD.get("card")})
    del one, dev

    # 5. the streaming server over the streaming phase's index
    sq_v, sq_s, sq_t = stream_q
    srv_res = overload(stream_idx, sq_v, sq_s, sq_t, StreamingServer, adm_mod)
    stream_idx.policy = CompactionPolicy(max_delta_fraction=0.005, min_mutations=64)
    extra = max(64, stream_idx.live_count // 100)
    mv, ms_, mt = make_dataset(extra, DIM, seed=21)
    acked = stream_idx.insert_batch(mv, ms_, mt)
    srv = StreamingServer(stream_idx, batch_size=BATCH, k=K, beam=BEAM, timeout_s=0.0)
    # the fault phase's full-width step on this server: poison, then two
    # injected build failures before the clean swap below
    FAULT["poison"] = poison_step(srv, stream_q)
    inj = FaultInjector(FAULT_SEED).add("compaction.build", FaultSpec("error", max_hits=2))
    undo = inj.wrap_method(stream_idx, "build_epoch", "compaction.build")
    FAULT["compaction"] = failed_compactions(srv, inj, stream_q)
    epoch, delta_live = stream_idx.epoch, stream_idx._delta.live_count
    t0 = time.perf_counter()
    require(srv.maybe_compact_async(), "the server started no compaction")
    served = 0
    # a few batches while the epoch builds (at least one), then wait: every
    # step's host work competes with the build's host sweep for the GIL
    while served < 4:
        for i in range(BATCH):
            srv.submit(sq_v[i], sq_s[i], sq_t[i])
        require(len(srv.step(force=True)) == BATCH, "a batch during the compaction went unanswered")
        served += 1
        if not srv.compacting:
            break
    srv.join_compaction()
    wall = time.perf_counter() - t0
    undo()
    require(stream_idx.epoch == epoch + 1 and len(srv.compactions) == 1, "the compaction did not swap")
    require(srv.compactions[0].delta_drained == delta_live and stream_idx._delta.live_count == 0,
            "the swap did not drain the delta")
    rids = [srv.submit(sq_v[i], sq_s[i], sq_t[i]) for i in range(BATCH)]
    after = srv.step(force=True)
    want = stream_idx.search(sq_v[:BATCH], sq_s[:BATCH], sq_t[:BATCH], k=K, beam=BEAM, plan="auto")
    require(np.array_equal(np.stack([after[r][0] for r in rids]), want[0]) and
            np.array_equal(np.stack([after[r][1] for r in rids]).view(np.int32), want[1].view(np.int32)),
            "the server's answers after the swap differ from index.search")
    srv_res["compaction"] = {**dataclasses.asdict(srv.compactions[0]), "wall_s": wall,
                             "batches_served_during_build": served, "inserted_before": extra}
    emit({"streaming_server": srv_res})
    FAULT["compaction"].update(swap_after_failures(srv, inj, acked, (mv, ms_, mt), want[0]))

    # 6. the sharded streaming index: host merge against the stacked step
    sidx = ShardedStreamingIndex(DIM, CONFIG.relation, 2, device="cuda", **SHARDED_STREAM)
    load = 2 * SHARDED_STREAM_LOAD
    lv, ls, lt = make_dataset(load, DIM, seed=31)
    t0 = time.perf_counter()
    sidx.insert_batch(lv, ls, lt)
    load_s = time.perf_counter() - t0
    for e in range(0, load, 97):
        sidx.delete(e)
    qq, qs_, qt_ = make_queries(BATCH, ls, lt, SELECTIVITIES, 41)
    host = sidx.search(qq, qs_, qt_, k=K, beam=BEAM, plan="graph")
    smesh = make_host_mesh(2, device="cuda")
    stacked = sidx.stacked_arrays()
    held = []
    with held_launches("sharded streaming step", held):
        serve_streaming_batch(stacked, smesh, CONFIG.relation, qq, qs_, qt_, k=K, beam=BEAM)
    reset_counts()
    t0 = time.perf_counter()
    ids, d = serve_streaming_batch(stacked, smesh, CONFIG.relation, qq, qs_, qt_, k=K, beam=BEAM)
    step_s = time.perf_counter() - t0
    launches["sharded_stream"] = dict(ops.LAUNCHES)
    for name in STREAM_KERNELS:
        require(launches["sharded_stream"][name] > 0, f"{name} never launched on the stacked streaming step")
    bad = mismatches(*host, ids, d)
    require(not bad, f"stacked streaming step vs host merge: {bad[:5]}")
    require(not np.isin(ids, np.arange(0, load, 97)).any(), "a deleted id came back")
    step = make_streaming_serving_step(smesh, k=K, beam=BEAM, stats=True)
    *_, st = serve_streaming_batch(stacked, smesh, CONFIG.relation, qq, qs_, qt_, step=step, k=K, beam=BEAM)
    keep = {k: v.copy() for k, v in stacked.items()}
    for sh in sidx.shards:
        sh.policy = CompactionPolicy(max_delta_fraction=0.01, min_mutations=64)
    i = sidx.maybe_compact_shards()
    require(i in (0, 1), "no shard compacted")
    fresh = sidx.refresh_shard(stacked, i)
    require(all(np.array_equal(stacked[k], keep[k]) for k in stacked), "refresh_shard changed the old dict")
    require(all(fresh[k].shape == stacked[k].shape for k in stacked), "refresh_shard changed a shape")
    ids2, d2 = serve_streaming_batch(fresh, smesh, CONFIG.relation, qq, qs_, qt_, k=K, beam=BEAM)
    bad = mismatches(*sidx.search(qq, qs_, qt_, k=K, beam=BEAM, plan="graph"), ids2, d2)
    require(not bad, f"stacked step after refresh_shard vs host merge: {bad[:5]}")
    emit({"sharded_stream": {
        "shards": 2, **{k: v for k, v in SHARDED_STREAM.items() if k != "build_kwargs"},
        "loaded": load, "load_s": load_s, "epochs": [sh.epoch for sh in sidx.shards],
        "step_batch_ms": step_s * 1e3, "launches": launches["sharded_stream"],
        "ids_equal_host_merge": bool(np.array_equal(host[0], ids)),
        "delta_valid_mean": float(st["delta_valid"].mean()), "compacted_shard": i,
        "refresh_keeps_old": True, "held_kernel_cases": held}})
    return launches


SEG_CELLS = 4                 # cells_per_axis of the segmented build (up to 16 segments)
SEG_TIMED = 3                 # timed batches per plan after one warm-up
SEG_SUB = 1024                # queries of the unfused search
SEG_CPU_QUERIES = 64          # card against CPU
SEG_STREAM = dict(node_capacity=4096, delta_capacity=512, edge_capacity=768, M=16, Z=128, K_p=8)
SEG_STREAM_STORAGE = dict(policy=None, build_kwargs=dict(batched=True), wal_segment_bytes=1 << 20)
SEG_STREAM_LOAD = 3000        # objects loaded into the streaming tier (2 x 2 cells; the
                              # containment plane puts about 1500 in each of two cells)


def lexsorted(ids, d) -> bool:
    """Every row ascending by (distance, id), -1 / +inf padding last: the
    rerank's (the ground truth's) order."""
    dd = np.where(ids >= 0, d, np.inf).astype(np.float64)
    key_ok = (dd[:, 1:] > dd[:, :-1]) | ((dd[:, 1:] == dd[:, :-1]) &
                                          ((ids[:, 1:] > ids[:, :-1]) | (ids[:, 1:] < 0)))
    return bool(np.all(key_ok | np.isinf(dd[:, 1:])))


def segment_plans(idx, route, s_q, t_q) -> dict:
    """The plan mix of a routed batch over every (query, segment) pair, as
    the scheduler plans them (default thresholds)."""
    from repro_torch.exec.plan import plan_queries

    counts = np.zeros(3, np.int64)
    for si, seg in enumerate(idx.segments):
        rows = np.flatnonzero(route[:, si])
        if rows.size:
            st, _, inv = prepare_states_extended(seg.dg, s_q[rows], t_q[rows])
            counts += np.bincount(plan_queries(seg.dg.planner, st, inv,
                                               config=default_planner_config()).plans, minlength=3)
    return {PLAN_NAMES[p]: int(c) for p, c in enumerate(counts)}


def segmented_phase(n: int, vecs, s, t, out: Path) -> dict:
    """The segmented tier (``repro_torch.scale``) on the card; returns the
    kernel launches of each counted run. Sizes scale with ``n``:

    1. ``build_segmented_index`` over the first n/4 rows of the main path's
       corpus (containment, ``cells_per_axis`` 4, M 16, Z 128, K_p 8, wave
       512, int8, planner buckets 64): segments, capacities, slot use, the
       stack's device bytes and one auto batch's visited bitmaps;
    2. 4096 queries at the main path's selectivities, k 10, beam 64, rerank
       on, with ``plan`` auto, graph, wide and brute: routed pairs,
       worklist capacity, plan mix, recall@10 against exact ground truth,
       QPS, p50, p99; B1 and B2 on every batch, B3 on the auto one. One
       dispatch for any mix: on the 0.003 rows alone and the 0.3 rows
       alone, ``dispatch_count`` rises by 1, B1 launches once an iteration
       and B2 once an iteration plus the one fold. ``scheduler=False``
       equals the scheduler bit for bit (results and counters);
       ``fused=False`` (B4) equals the fused search under the tie rule;
       every launch of one auto batch held bitwise against its plain
       version; B2 timed on the fold's own inputs; the rerank tail and the
       routing timed on the host;
    3. 64 of the queries on the CPU (plain versions) against the card; the
       final order is (distance, id);
    4. a routed segment quarantined: named by ``return_partial``, none of
       its ids returned, still one dispatch a batch; lifted: the earlier
       results bit for bit;
    5. ``segments_to_sharded_index`` and ``serve_batch`` (auto and graph,
       ``all_gather``, and ``tournament`` when the segment count is a power
       of two): every remapped id valid and unique in its row, 64 queries on
       the CPU against the card, recall@10, the primed bundle used;
    6. ``SegmentedStreamingIndex`` (2 x 2 cells, node 4096, delta 512, edge
       768 a cell, a ``storage_dir``): 3000 objects through ``insert_batch``
       (about 1500 in each of the two cells the containment plane fills), ``save_snapshot``, 256 inserts and 1 % deletes
       through the WALs; auto and graph searches launch B1-B3; acknowledged
       inserts read back, no deleted id returned; ``recover_segmented`` on
       the card bit-equal, nothing quarantined; one epoch swap repatches
       only its cell's slice of ``device_stack()``; a corrupt snapshot (on a
       copy) quarantines its cell only when its WAL lost the history, and
       ``maybe_rebuild`` restores it once the file is repaired.

    No step that injects no fault may quarantine a segment or report a
    degraded answer."""
    from repro_torch.core.predicates import DominanceSpace, get_relation
    from repro_torch.distributed import make_host_mesh
    from repro_torch.scale import (
        SegmentedStreamingIndex,
        SegmentGrid,
        build_segmented_index,
        dispatch_count,
        read_manifest,
        recover_segmented,
        worklist_capacity,
    )
    from repro_torch.scale.durability import segment_dir
    from repro_torch.serve import segments_to_sharded_index, serve_batch
    from repro_torch.stream import WriteAheadLog

    rel = get_relation(CONFIG.relation)
    launches, res = {}, {}

    def clean(what, info=None):
        require(not idx.quarantined, f"a segment was quarantined by {what}")
        require(info is None or not info.degraded, f"{what} reported a degraded answer")

    # 1. the build
    rows = n // 4
    sv, ss, st_ = vecs[:rows], s[:rows], t[:rows]
    emit({"reduced": {"segmented_rows": [FULL_N, rows],
                      "why": "the build is host-sweep bound (about 1.8 ms a node): a quarter "
                             "of the corpus keeps the script within the run's time limit"}})
    reset_counts()
    t0 = time.perf_counter()
    idx = build_segmented_index(sv, ss, st_, CONFIG.relation, cells_per_axis=SEG_CELLS, M=16, Z=128,
                                K_p=8, wave=512, quantize_int8=True, planner_buckets=64, device="cuda")
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    res["build_launches"] = dict(ops.LAUNCHES)
    require(res["build_launches"]["filter_dist_gather"] > 0, "the segmented build launched no B3")
    S, ncap = idx.num_segments, idx.node_capacity
    sizes = idx.segment_sizes()
    stack = idx.device_stack()
    res.update(rows=rows, segments=S, node_capacity=ncap, E=idx.edge_capacity, packed=idx.packed,
               segment_sizes=sizes.tolist(), slot_utilization=float(sizes.sum() / (S * ncap)),
               waves=sum(seg.report.waves for seg in idx.segments),
               stack_device_bytes=stack.nbytes_by_component(), at_rest_bytes=idx.nbytes_by_component())
    require(S >= 2 and int(sizes.sum()) == rows, "the segmented build")

    # 2. routed batches
    qv, s_q, t_q = make_queries(BATCH, ss, st_, SELECTIVITIES, 61)
    n_gt = 1024
    qs = ground_truth(QuerySet(CONFIG.relation, qv[:n_gt], s_q[:n_gt], t_q[:n_gt], 0.0,
                               np.zeros(n_gt), K), sv, ss, st_)
    t0 = time.perf_counter()
    route0, _ = idx.coarse_route(s_q, t_q)
    x_q, y_q, *_ = idx._query_states(s_q, t_q)
    route = idx._refine_route(route0, x_q, y_q)
    res["route_ms"] = (time.perf_counter() - t0) * 1e3
    W = int(route.sum())
    res.update(routed_pairs=W, coarse_pairs=int(route0.sum()), worklist_capacity=worklist_capacity(W),
               routed_segments_per_query=float(route.sum(1).mean()),
               plan_mix=segment_plans(idx, route, s_q, t_q),
               visited_bitmap_bytes=worklist_capacity(W) * ((S * ncap + 31) // 32) * 4)
    if not res["plan_mix"]["BRUTE_VALID"]:
        sels = SELECTIVITIES
        while not res["plan_mix"]["BRUTE_VALID"]:
            require(sels[0] > 1e-5, "no selectivity gives a BRUTE_VALID row")
            sels = (sels[0] / 3,) + tuple(sels[1:])
            qv, s_q, t_q = make_queries(BATCH, ss, st_, sels, 61)
            route0, _ = idx.coarse_route(s_q, t_q)
            x_q, y_q, *_ = idx._query_states(s_q, t_q)
            route = idx._refine_route(route0, x_q, y_q)
            res["plan_mix"] = segment_plans(idx, route, s_q, t_q)
        res["lowered_selectivities"] = {"selectivities": sels, "plan_mix": res["plan_mix"]}
        qs = ground_truth(QuerySet(CONFIG.relation, qv[:n_gt], s_q[:n_gt], t_q[:n_gt], 0.0,
                                   np.zeros(n_gt), K), sv, ss, st_)
    batches, results = {}, {}
    for plan in ("auto", "graph", "wide", "brute"):
        reset_counts()
        d0 = dispatch_count()
        lat = []
        for _ in range(1 + SEG_TIMED):
            t0 = time.perf_counter()
            ids, d, info = idx.search(qv, s_q, t_q, k=K, beam=BEAM, plan=plan, return_partial=True)
            lat.append(time.perf_counter() - t0)
            clean(f"the {plan} batch", info)
        launches[plan] = dict(ops.LAUNCHES)
        require(dispatch_count() - d0 == 1 + SEG_TIMED, f"more than one dispatch a {plan} batch")
        for name in ("beam_merge",) + (("filter_dist_gather_packed",) if plan != "brute" else ()) + (
                ("filter_dist_gather",) if plan in ("auto", "brute") else ()):
            require(launches[plan][name] >= 1 + SEG_TIMED, f"{name} not launched on every segmented {plan} batch")
        require(ids.shape == (BATCH, K) and np.all(np.isfinite(d)), f"segmented {plan} result")
        require(lexsorted(ids, d), f"the {plan} answer is not in (distance, id) order")
        results[plan] = (ids, d)
        timed = lat[1:]
        batches[plan] = {"qps": BATCH / statistics.median(timed),
                         "p50_batch_ms": float(np.percentile(timed, 50) * 1e3),
                         "p99_batch_ms": float(np.percentile(timed, 99) * 1e3),
                         "warmup_batch_ms": lat[0] * 1e3, "recall_at_10": recall_at_k(ids[:n_gt], qs),
                         "launches": launches[plan],
                         "loop_iterations": search_mod.LOOP_STATS["iterations"]}
    require(batches["brute"]["recall_at_10"] >= 0.999, f"segmented brute recall {batches['brute']}")
    res["batches"] = batches
    by_name = traced_ms(lambda: idx.search(qv, s_q, t_q, k=K, beam=BEAM))
    busy = sum(t for t, _ in by_name.values())
    res["auto_profile"] = {
        "device_busy_ms": busy, "idle_share": 1.0 - busy / batches["auto"]["p50_batch_ms"],
        "top": [[k[:60], round(t, 3), c] for k, (t, c) in
                sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]]}

    # one dispatch for any mix: the rarest and the broadest rows alone
    mixes = {}
    for sel in (SELECTIVITIES[0], SELECTIVITIES[-1]):
        mq, ms_, mt = make_queries(BATCH, ss, st_, (sel,), 62)
        reset_counts()
        d0, it0 = dispatch_count(), search_mod.LOOP_STATS["iterations"]
        _, _, mroute, info = idx.search(mq, ms_, mt, k=K, beam=BEAM, return_route=True,
                                        return_partial=True)
        clean(f"the {sel} mix", info)
        iters = search_mod.LOOP_STATS["iterations"] - it0
        got = dict(ops.LAUNCHES)
        mixes[str(sel)] = {"routed_pairs": int(mroute.sum()),
                           "routed_segments": int(mroute.any(0).sum()),
                           "dispatches": dispatch_count() - d0, "iterations": iters, "launches": got}
        require(dispatch_count() - d0 == 1, f"the {sel} mix took more than one dispatch")
        require(got["filter_dist_gather_packed"] == iters and got["beam_merge"] == iters + 1,
                f"the {sel} mix: B1/B2 launches {got} against {iters} iterations and one fold")
    require(mixes[str(SELECTIVITIES[0])]["routed_pairs"] != mixes[str(SELECTIVITIES[-1])]["routed_pairs"],
            "the two mixes route the same pairs")
    res["mixes"] = mixes

    # the loop against the scheduler, bit for bit, counters too
    a = idx.search(qv, s_q, t_q, k=K, beam=BEAM, stats=True)
    t0 = time.perf_counter()
    b = idx.search(qv, s_q, t_q, k=K, beam=BEAM, stats=True, scheduler=False)
    loop_s = time.perf_counter() - t0
    require(np.array_equal(a[0], b[0]) and np.array_equal(a[1].view(np.int32), b[1].view(np.int32)),
            "the scheduler differs from the per-segment loop")
    require(all(np.array_equal(x, y) for x, y in zip(a[2], b[2])),
            "the scheduler's counters differ from the loop's")
    clean("the loop")
    res["scheduler_vs_loop"] = {"bit_equal": True, "loop_batch_ms": loop_s * 1e3,
                                "hit_max_iters_share": float(np.mean(a[2].hit_max_iters))}

    # the unfused search (B4) against the fused one
    sub = slice(0, SEG_SUB)
    reset_counts()
    t0 = time.perf_counter()
    un = idx.search(qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM, fused=False)
    un_s = time.perf_counter() - t0
    launches["unfused"] = dict(ops.LAUNCHES)
    require(launches["unfused"]["filter_dist"] > 0, "B4 never launched on the unfused segmented search")
    fu = idx.search(qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM)
    bad = mismatches(*fu, *un)
    require(not bad, f"unfused segmented search vs fused: {bad[:5]}")
    res["unfused"] = {"queries": SEG_SUB, "batch_ms": un_s * 1e3, "launches": launches["unfused"],
                      "ids_equal": bool(np.array_equal(fu[0], un[0]))}

    # every launch of one auto batch held against its plain version, and
    # the fold's inputs captured for B2's timed case
    held, fold = [], []
    fetch = 2 * K
    with held_launches("segmented auto batch", held):
        held_merge = ops.beam_merge

        def capture(*args, n, visited=None):
            if args[0].shape[1] == fetch and visited is None and not fold:
                fold.append(tuple(x.clone() for x in args) + (n,))
            return held_merge(*args, n=n, visited=visited)

        ops.beam_merge = capture
        ids, d = idx.search(qv, s_q, t_q, k=K, beam=BEAM)
    require(np.array_equal(ids, results["auto"][0]), "the held auto batch answered differently")
    held_names = {c["kernel"].split(" (")[0] for c in held}
    require({"filter_dist_gather_packed", "beam_merge", "filter_dist_gather"} <= held_names,
            f"the held segmented batch launched only {sorted(held_names)}")
    res["held_kernel_cases"] = held
    require(len(fold) == 1 and fold[0][3].shape[1] == S * fetch, "the fold's inputs were not captured")
    *fargs, fn = fold[0]
    fold_case = merge_case(tuple(fargs), fn, torch.zeros((BATCH, (fn + 31) // 32), dtype=torch.int32,
                                                         device="cuda"), case="segment fold")
    RECORD["kernel_cases"].append(fold_case)
    res["fold_case"] = {k: fold_case[k] for k in ("L", "C", "ms", "queued_ms", "plain_ms", "bound_ms",
                                                  "bound_by", "fraction_of_bound")}

    # the host tail: routing and the exact rerank, alone
    cand_ids, cand_d = idx.search(qv, s_q, t_q, k=fetch, beam=BEAM, rerank=False, fetch_k=fetch)
    t0 = time.perf_counter()
    rr = idx._rerank_exact(qv, cand_ids.astype(np.int32), cand_d, K)
    res["rerank_ms"] = (time.perf_counter() - t0) * 1e3
    require(np.array_equal(rr[0], results["auto"][0]), "the rerank alone gives another answer")

    # 3. card against CPU
    sub = slice(0, SEG_CPU_QUERIES)
    t0 = time.perf_counter()
    ids_c, d_c = idx.search(qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM, device="cpu")
    cpu_s = time.perf_counter() - t0
    ids_g, d_g = idx.search(qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM)
    bad = mismatches(ids_c, d_c, ids_g, d_g)
    require(not bad, f"segmented card vs CPU: {bad[:5]}")
    require(lexsorted(ids_c, d_c), "the CPU answer is not in (distance, id) order")
    res["cpu_parity"] = {"queries": SEG_CPU_QUERIES, "cpu_s": cpu_s,
                         "ids_equal": bool(np.array_equal(ids_c, ids_g))}
    idx._stacks.pop("cpu", None)
    for seg in idx.segments:
        seg.dg._cache.pop(("device", "cpu"), None)

    # 4. quarantine one routed segment, then lift it
    victim = int(np.argmax(route.sum(0)))
    idx.quarantine_segment(victim)
    reset_counts()
    d0, it0 = dispatch_count(), search_mod.LOOP_STATS["iterations"]
    ids_q, d_q, info = idx.search(qv, s_q, t_q, k=K, beam=BEAM, return_partial=True)
    iters = search_mod.LOOP_STATS["iterations"] - it0
    got = dict(ops.LAUNCHES)
    require(info.degraded and victim in info.missing_segments, "return_partial did not name the segment")
    require(not np.isin(ids_q, idx.segments[victim].ids).any(), "a quarantined segment's id came back")
    require(dispatch_count() - d0 == 1 and got["filter_dist_gather_packed"] == iters
            and got["beam_merge"] == iters + 1, "the quarantined batch is not one dispatch")
    missing = info.missing_segments
    idx.lift_quarantine(victim)
    ids_l, d_l, info = idx.search(qv, s_q, t_q, k=K, beam=BEAM, return_partial=True)
    clean("the lifted batch", info)
    require(np.array_equal(ids_l, results["auto"][0]) and
            np.array_equal(d_l.view(np.int32), results["auto"][1].view(np.int32)),
            "lifting the quarantine did not restore the results")
    res["quarantine"] = {"segment": victim, "segment_rows": int(sizes[victim]),
                         "missing": missing, "launches": got, "iterations": iters,
                         "restored_bit_equal": True}

    # 5. the segments served through the sharded step
    t0 = time.perf_counter()
    sh, id_map = segments_to_sharded_index(idx)
    res_sh = {"stack_s": time.perf_counter() - t0}
    primed = sh._cache[("device", "cuda", None)]
    mesh = make_host_mesh(S, device="cuda")
    require(sh.device(mesh.device) is primed, "ShardedIndex.device() did not return the primed bundle")
    require(primed["labels"].data_ptr() == idx.device_stack().flat("labels").data_ptr(),
            "the primed labels are not the stack's")
    merges = ("all_gather", "tournament") if S & (S - 1) == 0 else ("all_gather",)
    served = {}
    for plan in ("auto", "graph"):
        for merge in merges:
            reset_counts()
            t0 = time.perf_counter()
            ids, d = serve_batch(sh, mesh, qv, s_q, t_q, k=K, beam=BEAM, plan=plan, merge=merge,
                                 id_map=id_map)
            wall = time.perf_counter() - t0
            key = f"{plan}/{merge}"
            launches[f"sharded {key}"] = dict(ops.LAUNCHES)
            for b_ in range(BATCH):
                row = ids[b_][ids[b_] >= 0]
                require(np.unique(row).size == row.size, f"an id twice in a sharded {key} row")
                require(rel.valid_mask(ss, st_, s_q[b_], t_q[b_])[row].all(),
                        f"a sharded {key} id fails its predicate")
            served[key] = {"batch_ms": wall * 1e3, "recall_at_10": recall_at_k(ids[:n_gt], qs),
                           "launches": launches[f"sharded {key}"]}
            if key == "auto/all_gather":
                want = (ids, d)
    require(sh.device(mesh.device) is primed, "serve_batch staged the sharded index again")
    cpu_mesh = make_host_mesh(S, device="cpu")
    sub = slice(0, SEG_CPU_QUERIES)
    ids_c, d_c = serve_batch(sh, cpu_mesh, qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM, id_map=id_map)
    bad = mismatches(ids_c, d_c, want[0][sub], want[1][sub])
    require(not bad, f"sharded segments card vs CPU: {bad[:5]}")
    res_sh.update(shards=S, merges=list(merges), batches=served,
                  cpu_parity={"queries": SEG_CPU_QUERIES,
                              "ids_equal": bool(np.array_equal(ids_c, want[0][sub]))},
                  primed_bundle_used=True, segmented_recall_at_10=batches["auto"]["recall_at_10"])
    res["sharded"] = res_sh
    del sh, primed, cpu_mesh
    emit({"segmented": res})

    # 6. the segmented streaming tier
    work = out / "segmented_stream"
    shutil.rmtree(work, ignore_errors=True)
    lv, ls, lt = make_dataset(SEG_STREAM_LOAD, DIM, seed=51)
    grid = SegmentGrid.from_space(DominanceSpace.from_intervals(rel, ls, lt), 2)
    kw = SEG_STREAM_STORAGE
    sidx = SegmentedStreamingIndex(DIM, CONFIG.relation, grid, storage_dir=str(work), device="cuda",
                                   **SEG_STREAM, **kw)
    srec = {"cells": sidx.num_segments}
    t0 = time.perf_counter()
    sidx.insert_batch(lv, ls, lt)
    srec["load_s"] = time.perf_counter() - t0
    srec["live_per_cell"] = [sub_.live_count for sub_ in sidx.subs]
    srec["epochs_after_load"] = sidx.epochs()
    require(max(srec["live_per_cell"]) <= SEG_STREAM["node_capacity"], "a cell outgrew its capacity")
    t0 = time.perf_counter()
    srec["generation"] = sidx.save_snapshot()
    srec["snapshot_s"] = time.perf_counter() - t0
    mv, ms_, mt = make_dataset(256, DIM, seed=52)
    epochs = sum(sidx.epochs())
    t0 = time.perf_counter()
    acked = sidx.insert_batch(mv, ms_, mt)
    srec["logged_inserts_per_s"] = 256 / (time.perf_counter() - t0)
    srec["compactions_during_logged_inserts"] = sum(sidx.epochs()) - epochs
    rng = np.random.default_rng(53)
    live = sidx.live_ids()
    victims = rng.choice(live, len(live) // 100, replace=False)
    for e in victims:
        require(sidx.delete(int(e)), f"delete of live id {e} refused")
    deleted = set(int(e) for e in victims)
    keep_acked = np.array([e for e in acked if int(e) not in deleted])
    sq, sqs, sqt = make_queries(BATCH, ls, lt, SELECTIVITIES, 54)
    seen, sres = [], {}
    for plan in ("auto", "graph"):
        reset_counts()
        t0 = time.perf_counter()
        ids, d, info = sidx.search(sq, sqs, sqt, k=K, beam=BEAM, plan=plan, return_partial=True)
        wall = time.perf_counter() - t0
        require(not sidx.quarantined and not info.degraded, f"the streaming {plan} search degraded")
        launches[f"stream {plan}"] = dict(ops.LAUNCHES)
        for name in STREAM_KERNELS:
            require(launches[f"stream {plan}"][name] > 0,
                    f"{name} never launched on the segmented streaming {plan} search")
        seen.append(ids)
        sres[plan] = {"batch_ms": wall * 1e3, "launches": launches[f"stream {plan}"]}
        if plan == "auto":
            want = (ids, d)
    srec["searches"] = sres
    g = min(256, len(keep_acked))
    pick = keep_acked[:g]
    pos = {int(e): i for i, e in enumerate(acked)}
    rows_ = np.array([pos[int(e)] for e in pick])
    ids, d, info = sidx.search(mv[rows_], ms_[rows_], mt[rows_], k=K, beam=BEAM, return_partial=True)
    require(not info.degraded and np.array_equal(ids[:, 0], pick) and np.all(d[:, 0] == 0.0),
            "an acknowledged insert did not come back first at distance 0")
    seen.append(ids)
    srec["acked_read_back"] = g
    # recovery from a copy of the directory (the live index's WALs stay open)
    crash = out / "segmented_crash"
    shutil.rmtree(crash, ignore_errors=True)
    shutil.copytree(work, crash)
    t0 = time.perf_counter()
    rec, report = recover_segmented(str(crash), device="cuda", **kw)
    torch.cuda.synchronize()
    srec["recovery_s"] = time.perf_counter() - t0
    require(report.quarantined == [] and not rec.quarantined, "recovery quarantined a cell")
    got = rec.search(sq, sqs, sqt, k=K, beam=BEAM, plan="auto")
    require(np.array_equal(got[0], want[0]) and np.array_equal(got[1].view(np.int32), want[1].view(np.int32)),
            "the recovered segmented index's results differ from the live index's")
    srec["recovery"] = {"records_replayed": report.records_replayed, "generation": report.generation,
                        "live_count": report.live_count, "bit_equal": True}
    for w in rec._wals:
        if w is not None:
            w.close()
    del rec
    # one epoch swap repatches only its cell's slice of the stack
    stk = sidx.device_stack()
    before = [dict(stk.part(ci)) for ci in range(stk.num_segments)]
    hot = int(np.argmax([sub_.live_count for sub_ in sidx.subs]))
    t0 = time.perf_counter()
    sidx.subs[hot].compact()
    srec["swap_s"] = time.perf_counter() - t0
    for ci in range(stk.num_segments):
        for key in ("table", "nbr", "labels", "gids"):
            require((stk.part(ci)[key] is before[ci][key]) == (ci != hot),
                    f"the epoch swap of cell {hot} touched cell {ci}'s {key}")
    ids, d, info = sidx.search(sq, sqs, sqt, k=K, beam=BEAM, return_partial=True)
    require(not info.degraded and not sidx.quarantined, "the search after the swap degraded")
    seen.append(ids)
    srec["epoch_swap"] = {"cell": hot, "epochs": sidx.epochs(), "segment_local": True}
    for ids in seen:
        require(not np.isin(ids, list(deleted)).any(), "a deleted id came back")
    srec["no_deleted_id"] = True
    # a corrupt snapshot on a copy: quarantine only when the history is gone
    bad_dir = out / "segmented_corrupt"
    shutil.rmtree(bad_dir, ignore_errors=True)
    shutil.copytree(work, bad_dir)
    man = read_manifest(str(bad_dir))
    cell = hot
    seg_path = segment_dir(str(bad_dir), cell)
    snap = os.path.join(seg_path, man["segments"][cell]["snapshot"])
    good = Path(snap).read_bytes()
    Path(snap).write_bytes(good[:100] + bytes([good[100] ^ 0xFF]) + good[101:])
    ro = WriteAheadLog(seg_path, sync="never")
    first = next(iter(ro.replay(after_lsn=0)), None)
    ro.close()
    history_lost = first is None or first.lsn != 1
    rec, report = recover_segmented(str(bad_dir), device="cuda", **kw)
    require(report.quarantined == ([cell] if history_lost else []),
            f"the corrupt snapshot gave quarantined={report.quarantined}, history lost: {history_lost}")
    healed = None
    if history_lost:
        require(rec.maybe_rebuild() == {cell: False}, "a rebuild from the corrupt file succeeded")
        Path(snap).write_bytes(good)
        rec._q_retry_at[cell] = 0.0
        healed = rec.maybe_rebuild()
        require(healed == {cell: True} and not rec.quarantined, "maybe_rebuild did not restore the cell")
    srec["corrupt_snapshot"] = {"cell": cell, "history_lost": history_lost,
                                "quarantined": report.quarantined, "rebuilt": healed,
                                "reason": report.segments[cell].reason}
    for w in rec._wals:
        if w is not None:
            w.close()
    for w in sidx._wals:
        if w is not None:
            w.close()
    del rec, sidx
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(crash, ignore_errors=True)
    shutil.rmtree(bad_dir, ignore_errors=True)
    emit({"segmented_stream": srec})
    return launches


FAULT_SEED = 0                # the full-width step's injector and torn-tail draw
CHAOS_SEEDS = range(5)        # with the rotation of relations, every crash point x relation pair
CHAOS_PHASES = ("compaction", "poison", "overload", "crash_recovery", "segmented")
# the fields of a chaos summary that are functions of the seed (wall-clock fields left out)
CHAOS_FIELDS = {
    "compaction": ("injected_failures", "epoch_recovered"),
    "poison": ("attempts", "rejected"),
    "overload": ("submitted", "shed", "answered", "max_queue_depth"),
    "crash_recovery": ("cut_bytes", "torn_size", "snapshot_found", "truncated", "tail_replayed",
                       "parity"),
}
CHAOS_RUN_FIELDS = ("point", "relation", "cut_bytes", "replayed", "corrupt_offset", "victim",
                    "orphans", "degraded", "rebuild_blocked", "heal_ok")


def copy_durable(src: Path, dst: Path) -> None:
    """A copy of a streaming durability directory: the snapshot hard-linked
    (recovery only reads it), every WAL segment copied (recovery truncates
    a torn tail in place)."""
    from repro_torch.stream.wal import SNAPSHOT_NAME

    dst.mkdir(parents=True)
    for f in src.iterdir():
        (os.link if f.name == SNAPSHOT_NAME else shutil.copy2)(f, dst / f.name)


def poison_step(srv, q) -> dict:
    """Non-finite queries at d 768 against a ``StreamingServer``:
    ``poison_vector`` with NaN, +Inf and -Inf, and a clean vector with a
    NaN and an Inf interval endpoint, each rejected by ``submit`` with
    ``ValueError``, with no kernel launched and nothing queued; then a clean
    query is answered."""
    qv, s_q, t_q = q
    cases = [(poison_vector(DIM, kind=kind, seed=i), s_q[0], t_q[0])
             for i, kind in enumerate(("nan", "inf", "-inf"), 1)]
    cases += [(qv[0], float("nan"), t_q[0]), (qv[0], s_q[0], float("inf"))]
    launches, pending = dict(ops.LAUNCHES), srv.batcher.pending
    rejected = 0
    for vec, sq, tq in cases:
        try:
            srv.submit(vec, sq, tq)
        except ValueError:
            rejected += 1
    require(rejected == len(cases), f"{len(cases) - rejected} poisoned submits were accepted")
    require(dict(ops.LAUNCHES) == launches and srv.batcher.pending == pending,
            "a rejected submit launched a kernel or queued a request")
    rid = srv.submit(qv[0], s_q[0], t_q[0])
    out = srv.step(force=True)
    require(rid in out and np.all(out[rid][0] >= 0) and np.all(np.isfinite(out[rid][1])),
            "the clean query after the poisoned ones went unanswered")
    return {"attempts": len(cases), "rejected": rejected, "launches_unchanged": True,
            "clean_answered": True}


def failed_compactions(srv, inj, q) -> dict:
    """Two injected ``build_epoch`` failures on the server's compaction
    worker (the injector's error fires before the build's body), each reaped
    into a backoff; between attempts the old epoch answers a fixed
    4096-query auto batch bit for bit, with B1, B2 and B3 launched. Returns
    once the second backoff has passed, so the next ``maybe_compact_async``
    starts the clean build."""
    idx = srv.index
    qv, s_q, t_q = (a[:BATCH] for a in q)
    epoch = idx.epoch
    want = idx.search(qv, s_q, t_q, k=K, beam=BEAM, plan="auto")
    reset_counts()
    attempts, backoff_s, batches = 0, [], 0
    t0 = time.perf_counter()
    deadline = time.monotonic() + 120.0
    while True:
        fails = srv._fail_count
        if srv.maybe_compact_async():
            attempts += 1
            srv._worker.join()
        elif srv._fail_count > fails:          # a failure reaped: backoff
            backoff_s.append(srv._retry_at - time.monotonic())
            if srv._fail_count == 2:
                break
        ids, d = idx.search(qv, s_q, t_q, k=K, beam=BEAM, plan="auto")
        batches += 1
        require(idx.epoch == epoch and np.array_equal(ids, want[0]) and
                np.array_equal(d.view(np.int32), want[1].view(np.int32)),
                "the old epoch's answers changed between failed compactions")
        require(time.monotonic() < deadline, "the injected compaction failures did not fire")
    launches = dict(ops.LAUNCHES)
    for name in STREAM_KERNELS:
        require(launches[name] > 0, f"{name} never launched between the failed compactions")
    failures = [f for f in inj.fired if f[0] == "compaction.build"]
    require(len(failures) == 2 and attempts == 2 and idx.epoch == epoch and
            isinstance(srv.last_compaction_error, InjectedFault),
            f"expected two injected failures: fired {inj.fired}, attempts {attempts}")
    failed_s = time.perf_counter() - t0
    time.sleep(max(0.0, srv._retry_at - time.monotonic()))
    return {"injected_failures": len(failures), "attempts": attempts, "backoff_s": backoff_s,
            "old_epoch_batches": batches, "old_epoch_bit_equal": True, "launches": launches,
            "failed_attempts_s": failed_s}


def swap_after_failures(srv, inj, acked, rows, served_ids) -> dict:
    """After the clean swap that follows the failures: the fault healed
    (no third firing, no error left), the acknowledged inserts come back
    first, and no id the streaming phase deleted is returned."""
    idx = srv.index
    mv, ms_, mt = rows
    g = min(256, len(acked))
    ids, d = idx.search(mv[:g], ms_[:g], mt[:g], k=K, beam=BEAM, plan="auto")
    norms = np.einsum("ij,ij->i", mv[:g], mv[:g])
    require(np.array_equal(ids[:, 0], acked[:g]) and np.all(np.abs(d[:, 0]) <= 1e-5 * norms),
            "an acknowledged insert did not come back first after the swap")
    require(len(inj.fired) == 2 and srv.last_compaction_error is None and srv._fail_count == 0,
            "the compaction fault did not heal after the swap")
    deleted = list(FAULT["deleted"])
    require(not np.isin(ids, deleted).any() and not np.isin(served_ids, deleted).any(),
            "a deleted id came back after the swap")
    return {"swap_s": srv.compactions[0].build_seconds + srv.compactions[0].swap_seconds,
            "last_compaction_error": None, "acked_read_back": g,
            "max_self_distance": float(np.abs(d[:, 0]).max()), "no_deleted_id": True}


def torn_tail(q) -> dict:
    """Two copies of the streaming phase's durability directory (its
    snapshot and ``sync="always"`` WAL): ``FAULT_SEED``'s 1-12 bytes torn
    off the last record of one, the other cut cleanly where that record
    starts. ``recover`` of the torn copy on the card reports the tear,
    replays every record but the torn one and answers a 4096-query auto
    batch bit for bit as the recovery of the clean cut does."""
    from repro_torch.stream import WriteAheadLog, recover
    from repro_torch.stream.wal import KIND_INSERT, encode_delete, encode_insert

    stash = FAULT_WORK / "stream_dir"
    ro = WriteAheadLog(str(stash), sync="never")
    records = list(ro.replay(after_lsn=0))
    seg = max(f for f in ro.segments() if os.path.getsize(stash / f) > 0)
    ro.close()
    last = records[-1]
    frame = len(encode_insert(last.lsn, last.ext_id, last.s, last.t, last.vec)
                if last.kind == KIND_INSERT else encode_delete(last.lsn, last.ext_id))
    size = os.path.getsize(stash / seg)
    cut = int(np.random.default_rng(FAULT_SEED).integers(1, 13))
    qv, s_q, t_q = (a[:BATCH] for a in q)
    res, answers = {"records": len(records), "cut_bytes": cut, "frame_bytes": frame}, {}
    for name, keep in (("torn", size - cut), ("clean", size - frame)):
        work = FAULT_WORK / name
        copy_durable(stash, work)
        truncate_file(str(work / seg), keep)
        t0 = time.perf_counter()
        rec, rep = recover(str(work), dim=DIM, relation=CONFIG.relation, device="cuda",
                           **FAULT["stream_kw"])
        torch.cuda.synchronize()
        res[name] = {"recovery_s": time.perf_counter() - t0, "truncated": rep.truncated,
                     "records_replayed": rep.records_replayed, "live_count": rep.live_count}
        answers[name] = rec.search(qv, s_q, t_q, k=K, beam=BEAM, plan="auto")
        rec._wal.close()
        del rec
    require(res["torn"]["truncated"] and not res["clean"]["truncated"],
            f"the torn tail was not reported (or the clean cut was): {res}")
    require(res["torn"]["records_replayed"] == res["clean"]["records_replayed"] == len(records) - 1,
            f"recovery did not replay every record but the torn one: {res}")
    (ti, td), (ci, cd) = answers["torn"], answers["clean"]
    require(np.array_equal(ti, ci) and np.array_equal(td.view(np.int32), cd.view(np.int32)),
            "the torn tail's recovery answers differently from the clean cut's")
    res["bit_equal"] = True
    return res


def chaos_seeded(summary: dict) -> dict:
    """The fields of a chaos summary that are functions of its seed."""
    out = {p: {f: summary[p][f] for f in fields} for p, fields in CHAOS_FIELDS.items()}
    out["segmented"] = [{f: r[f] for f in CHAOS_RUN_FIELDS if f in r} for r in summary["segmented"]["runs"]]
    out["faults_fired"] = summary["faults_fired"]
    return out


def chaos_runs() -> tuple:
    """``run_chaos(seed, tiny=True, device="cuda")`` for ``CHAOS_SEEDS`` and
    ``run_chaos(0, tiny=False, device="cuda")``, at the module's own sizes
    (d 8; node capacity 256 or 1024): every phase ok, B3 launched
    (BRUTE_VALID plans and delta scans), seed 0's seed-determined fields
    equal to the CPU run's. Returns the report and the runs' launches."""
    from repro_torch.fault.chaos import run_chaos

    reset_counts()
    t0 = time.perf_counter()
    runs = {f"tiny/{seed}": run_chaos(seed, tiny=True, device="cuda") for seed in CHAOS_SEEDS}
    runs["full/0"] = run_chaos(0, tiny=False, device="cuda")
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for name, summary in runs.items():
        for phase in CHAOS_PHASES:
            require(summary[phase]["ok"], f"chaos {name}: {phase} failed: {summary[phase]}")
    require(launches["filter_dist_gather"] > 0, "B3 never launched in the chaos runs")
    t0 = time.perf_counter()
    cpu = run_chaos(0, tiny=True, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(cpu["ok"] and chaos_seeded(runs["tiny/0"]) == chaos_seeded(cpu),
            f"chaos seed 0 on the card differs from the CPU: {chaos_seeded(runs['tiny/0'])} "
            f"against {chaos_seeded(cpu)}")
    return {
        "ok": {name: s["ok"] for name, s in runs.items()}, "seconds": seconds, "cpu_seed0_s": cpu_s,
        "seed0_equals_cpu": True, "launches": launches,
        "faults_fired": {name: s["faults_fired"] for name, s in runs.items()},
        "history_whole": {name: [r["point"] for r in s["segmented"]["runs"] if r.get("history_whole")]
                          for name, s in runs.items()},
        "wall_clock": {name: {"backoff_waits": s["compaction"]["backoff_waits"],
                              "recovery_seconds": s["crash_recovery"]["recovery_seconds"]}
                       for name, s in runs.items()},
        "seed0": chaos_seeded(runs["tiny/0"])}, launches


def fault_phase(stream_q) -> dict:
    """Fault injection (``repro_torch.fault``) on the card; returns the
    kernel launches of the chaos runs.

    1. the chaos scenario at its own sizes (``chaos_runs``);
    2. the full-width step on the streaming phase's index and the serving
       phase's ``StreamingServer``, taken in those phases before they are
       dropped (``poison_step``, ``failed_compactions``,
       ``swap_after_failures``), and here the torn WAL tail of the
       streaming phase's directory, recovered bit for bit against its clean
       cut (``torn_tail``)."""
    for key in ("poison", "compaction"):
        require(key in FAULT, f"the full-width {key} step did not run in the serving phase")
    chaos, launches = chaos_runs()
    t0 = time.perf_counter()
    torn = torn_tail(stream_q)
    emit({"fault": {
        "chaos": chaos,
        "full_width": {"d": DIM, "poison": FAULT["poison"], "compaction": FAULT["compaction"],
                       "torn_tail": torn, "torn_tail_s": time.perf_counter() - t0},
        "launches": {"chaos": launches, "full_width": FAULT["compaction"]["launches"]}}})
    shutil.rmtree(FAULT_WORK, ignore_errors=True)
    return launches


BASELINE_ROWS = 1024          # the graph baselines' rows: single-threaded Python builds
                              # (reduced from 2048: the run's time limit)
BASELINE_QUERIES = 256
BASELINE_EF = 64
PREFILTER_QUERIES = 512        # of the 1024 with ground truth (reduced: the run's time limit)
BASELINE_KW = {               # benchmarks/bench_main_search.py's parameters
    "postfilter": dict(M=16, ef_construction=64),
    "acorn": dict(M=16, gamma=6, ef_construction=64),
    "hipng": dict(M=12, ef_construction=48, leaf_size=256, min_graph_size=128),
}


def host_search(method, qv, s_q, t_q, ef: int) -> tuple:
    """One baseline over a query batch, a query at a time on the host: ids
    and distances padded to k (-1, +inf) and the mean ms a query."""
    ids = np.full((len(qv), K), -1, dtype=np.int64)
    d = np.full((len(qv), K), np.inf, dtype=np.float32)
    t0 = time.perf_counter()
    for i in range(len(qv)):
        got_i, got_d = method.search(qv[i], float(s_q[i]), float(t_q[i]), K, ef)
        ids[i, :len(got_i)], d[i, :len(got_d)] = got_i, got_d
    return ids, d, (time.perf_counter() - t0) / len(qv) * 1e3


def tie_sorted(ids, d) -> tuple:
    """Each row's (distance, id) pairs sorted by distance bits, then id: two
    results that differ only in how they order exactly equal distances
    give the same arrays."""
    bits = np.ascontiguousarray(d, dtype=np.float32).view(np.int32)
    order = np.lexsort((ids, bits), axis=-1)
    return np.take_along_axis(ids, order, -1), np.take_along_axis(bits, order, -1)


def baselines_phase(dg, vecs, s, t, auto_q, brute_q, gt: dict) -> dict:
    """The hybrid-search baselines (``repro_torch.baselines``, host numpy as
    in the JAX package) beside the card's search; returns the kernel
    launches of the card's runs.

    1. ``PreFilter`` over the whole corpus: on the first
       ``PREFILTER_QUERIES`` (512) queries of the main path's auto batch and of its forced brute batch, the answers
       equal the exact ground truth's, ids and distance bits, up to the
       order of exactly equal distances (the JAX package's PreFilter
       leaves those in ``argpartition``'s order where the ground truth
       puts the smaller id first: ROADMAP C4), and equal the card's
       ``plan="brute"`` batch (B3) under the tie rule of
       ``repro_torch.data.parity`` (B3 sums cached norms, the host scan
       the difference's squares);
    2. PostFilter, ACORN and Hi-PNG at ``bench_main_search.py``'s
       parameters on the first ``BASELINE_ROWS`` rows, beside UDG built
       there on the card (M 16, Z 128, K_p 8) and searched with
       ``execute_batch(plan="auto")``: 256 queries of the main mix at ef
       64; every baseline returns only valid ids, Hi-PNG refuses overlap,
       PreFilter's recall@10 is 1.0; recall@10 by method and selectivity,
       build seconds, host ms a query and the card's batch ms reported.

    ``gt`` maps ``"auto"`` and ``"brute"`` to the ground truth's ids and
    distances on the first 1024 queries of each batch."""
    from repro_torch.baselines import Acorn, HiPNG, PostFilterHNSW, PreFilter
    from repro_torch.core.predicates import get_relation

    res = {}
    rel = get_relation(CONFIG.relation)
    pre = PreFilter()
    t0 = time.perf_counter()
    pre.build(vecs, s, t, CONFIG.relation)
    res["prefilter"] = {"n": len(vecs), "build_s": time.perf_counter() - t0,
                        "index_bytes": pre.index_bytes}
    launches = {}
    for name, (qv, s_q, t_q) in (("auto", auto_q), ("brute", brute_q)):
        qv, s_q, t_q = (a[:PREFILTER_QUERIES] for a in (qv, s_q, t_q))
        ids, d, ms = host_search(pre, qv, s_q, t_q, 0)
        want = tuple(w[:PREFILTER_QUERIES] for w in gt[name])
        require(all(np.array_equal(a, b) for a, b in zip(tie_sorted(ids, d), tie_sorted(*want))),
                f"PreFilter differs from the ground truth on the {name} batch")
        swapped = int((ids != want[0]).any(axis=1).sum())
        reset_counts()
        t0 = time.perf_counter()
        c_ids, c_d = execute_batch(dg, qv, s_q, t_q, k=K, beam=BEAM, plan="brute")
        card_ms = (time.perf_counter() - t0) * 1e3
        launches[name] = dict(ops.LAUNCHES)
        require(launches[name]["filter_dist_gather"] > 0, f"B3 never launched on the {name} queries")
        bad = mismatches(ids, d, c_ids, c_d)
        require(not bad, f"PreFilter vs the card's brute batch ({name}): {bad[:5]}")
        res["prefilter"][name] = {"queries": len(qv), "recall_at_10": 1.0, "host_ms_per_query": ms,
                                  "rows_with_exact_ties_reordered": swapped,
                                  "card_brute_batch_ms": card_ms, "ids_equal_card": bool(np.array_equal(ids, c_ids)),
                                  "launches": launches[name]}
    emit({"reduced": {"prefilter_queries": [1024, PREFILTER_QUERIES],
                      "why": "the host PreFilter takes about 20 ms a query; the time went to the "
                             "train phase (17) within the run's time limit"}})

    # 2. the graph baselines beside UDG on the same rows
    m = BASELINE_ROWS
    bv, bs, bt = vecs[:m], s[:m], t[:m]
    qv, s_q, t_q = make_queries(BASELINE_QUERIES, bs, bt, SELECTIVITIES, 61)
    qs = ground_truth(QuerySet(CONFIG.relation, qv, s_q, t_q, 0.0, np.zeros(len(qv)), K), bv, bs, bt)
    groups = {str(sel): np.arange(g, len(qv), len(SELECTIVITIES)) for g, sel in enumerate(SELECTIVITIES)}
    masks = [rel.valid_mask(bs, bt, s_q[i], t_q[i]) for i in range(len(qv))]
    methods = {"prefilter": PreFilter(), "postfilter": PostFilterHNSW(**BASELINE_KW["postfilter"]),
               "acorn": Acorn(**BASELINE_KW["acorn"]), "hipng": HiPNG(**BASELINE_KW["hipng"])}
    rows = {}
    for name, method in methods.items():
        t0 = time.perf_counter()
        method.build(bv, bs, bt, CONFIG.relation)
        build_s = time.perf_counter() - t0
        ids, d, ms = host_search(method, qv, s_q, t_q, BASELINE_EF)
        for i in range(len(qv)):
            got = ids[i][ids[i] >= 0]
            require(masks[i][got].all(), f"{name} returned an invalid id on query {i}")
        rows[name] = {"build_s": build_s, "index_bytes": int(method.index_bytes),
                      "host_ms_per_query": ms, "recall_at_10": recall_at_k(ids, qs),
                      "by_selectivity": {sel: recall_at_k(ids[g], QuerySet(
                          CONFIG.relation, qv[g], s_q[g], t_q[g], float(sel), np.zeros(g.size), K,
                          gt_ids=qs.gt_ids[g])) for sel, g in groups.items()}}
    require(rows["prefilter"]["recall_at_10"] == 1.0, "PreFilter is not exact at the baselines' rows")
    try:
        HiPNG(**BASELINE_KW["hipng"]).build(bv, bs, bt, "overlap")
        require(False, "Hi-PNG built an overlap index")
    except ValueError:
        pass
    reset_counts()
    t0 = time.perf_counter()
    g, et, _ = build_index(bv, bs, bt, CONFIG.relation, M=16, Z=128, K_p=8, device="cuda")
    small = export_planned_graph(g, et, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lat = []
    for _ in range(1 + 3):
        t0 = time.perf_counter()
        ids, d, pb = execute_batch(small, qv, s_q, t_q, k=K, beam=BEAM, plan="auto", return_plans=True)
        lat.append(time.perf_counter() - t0)
    launches["udg"] = dict(ops.LAUNCHES)
    require(ids.shape == (len(qv), K) and np.all(np.isfinite(d)), "UDG's result at the baselines' rows")
    for i in range(len(qv)):
        require(masks[i][ids[i]].all(), f"UDG returned an invalid id on query {i}")
    rows["udg_card"] = {"build_s": build_s, "batch_ms": statistics.median(lat[1:]) * 1e3,
                        "warmup_batch_ms": lat[0] * 1e3, "plan_mix": pb.mix(),
                        "recall_at_10": recall_at_k(ids, qs), "launches": launches["udg"],
                        "by_selectivity": {sel: recall_at_k(ids[g], QuerySet(
                            CONFIG.relation, qv[g], s_q[g], t_q[g], float(sel), np.zeros(g.size), K,
                            gt_ids=qs.gt_ids[g])) for sel, g in groups.items()}}
    res["graph_baselines"] = {"rows": m, "queries": len(qv), "ef": BASELINE_EF, "k": K,
                              "params": BASELINE_KW, "hipng_refuses_overlap": True, "methods": rows}
    emit({"reduced": {"baseline_rows": [FULL_N, m],
                      "why": "the graph baselines' single-threaded Python builds cost 2.6-8.3 ms a "
                             "node at d 768"}})
    emit({"baselines": res})
    return launches


LM_ARCH = "llama3.2-1b"       # served at full width and depth
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 64
LM_F32_TOL = 1e-3             # atol = rtol, f32 with TF32 off
LM_BF16_TOL = 2e-2            # of the row's max |logit| (tests/test_models.py's 2e-2)
LM_OTHER = dict(batch=2, prompt=64, new=8)
# the reference's own bf16 decode leaves its forward by more than 2e-2 on
# these (a SMOKE run on the CPU: 0.0254 and 0.0338, ROADMAP C6): their bf16
# error is reported and their f32 run decides
LM_BF16_REPORTED = ("falcon-mamba-7b", "zamba2-2.7b")
LM_PROMPTS = {"gemma3-12b": 1536}   # past the 1024-token window, a multiple of the 512 chunk
LM_CPU = dict(batch=2, prompt=16, steps=4, full_prompt=32)
BF16_OPS_PER_S = FP16_OPS_PER_S


def lm_tokens(cfg, b: int, s: int, seed: int) -> torch.Tensor:
    shape = (b, s) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    return torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size, shape),
                           device="cuda")


def sized_state(cfg, cache: dict, b: int, s: int, new: int, device="cuda") -> dict:
    """The prefill cache copied into a decode state of length s + new (ROADMAP
    C5: the prompt-sized cache has no room for a decoded token)."""
    st = lm.init_decode_state(cfg, b, s + new, device=device)
    for key, sub in cache.items():
        for leaf, t in sub.items():
            (st[key][leaf] if key == "ssm" else st[key][leaf][..., :s, :, :]).copy_(t)
    return st


def whole_chunk(cfg, s: int):
    """``cfg`` whose attention chunk divides ``s`` (the reference's forward
    asserts ``s % chunk == 0``; the chunk only blocks the online softmax)."""
    chunk = min(cfg.attn_chunk, s)
    return cfg if s % chunk == 0 else dataclasses.replace(cfg, attn_chunk=math.gcd(s, cfg.attn_chunk))


def lm_gate(got: torch.Tensor, want: torch.Tensor, what: str, *, f32: bool,
            soft: bool = False) -> dict:
    """f32: |got - want| <= tol + tol |want| everywhere; bf16: the largest
    |got - want| of a row within 2e-2 of that row's max |want| (only
    reported when ``soft``). Also the greedy (argmax) agreement."""
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    diff = (got - want).abs()
    row = (diff.amax(-1) / want.abs().amax(-1)).max().item()
    out = {"max_abs_err": diff.max().item(), "max_row_rel_err": row,
           "greedy_agree": (got.argmax(-1) == want.argmax(-1)).float().mean().item()}
    if f32:
        excess = (diff - LM_F32_TOL - LM_F32_TOL * want.abs()).max().item()
        require(excess <= 0, f"{what}: f32 logits leave forward's by {out['max_abs_err']}")
    elif not soft:
        require(row <= LM_BF16_TOL, f"{what}: bf16 logits leave forward's by {row} of the row max")
    return out


def lm_serve(cfg, b: int, s: int, new: int, *, f32: bool, seed: int, what: str,
             timed: bool = False, soft: bool = False) -> tuple:
    """Prefill ``b`` prompts of ``s`` seeded tokens, copy the cache into a
    state of length s + new, decode ``new`` greedy tokens, then hold the
    prefill's and every step's logits against ``forward`` over the prompt
    plus the fed tokens. Returns (record, model)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    rec = {"params": lm.param_count(model), "init_s": time.perf_counter() - t0,
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
    toks = lm_tokens(cfg, b, s, seed)
    if timed:                                  # warm-up: cuBLAS handles, allocator
        lg, cache = lm.prefill_step(model, cfg, toks)
        st = sized_state(cfg, cache, b, s, 1)
        lm.decode_step(model, cfg, st, lg.argmax(-1)[:, None], torch.full((b,), s, device="cuda"))
        del lg, cache, st
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = lm.prefill_step(model, cfg, toks)
    torch.cuda.synchronize()
    rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    state = sized_state(cfg, cache, b, s, new)
    del cache
    fed, step_logits, step_ms = [], [], []
    nxt = logits.argmax(-1)
    for i in range(new):
        fed.append(nxt)
        t0 = time.perf_counter()
        lg, state = lm.decode_step(model, cfg, state, nxt[:, None], torch.full((b,), s + i, device="cuda"))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_logits.append(lg)
        nxt = lg.argmax(-1)
    rec["decode_p50_ms"] = float(np.percentile(step_ms, 50))
    rec["decode_p99_ms"] = float(np.percentile(step_ms, 99))
    rec["decode_tok_s"] = b * 1e3 / statistics.median(step_ms)
    rec["prefill_tok_s"] = b * s * 1e3 / rec["prefill_ms"]
    rec["state_bytes"] = sum(t.numel() * t.element_size() for sub in state.values() for t in sub.values())
    if timed:   # one more step at the last position (its slot rewritten) and the prefill, traced
        last = torch.full((b,), s + new - 1, device="cuda")
        rec["decode_trace"] = lm_trace(lambda: lm.decode_step(model, cfg, state, fed[-1][:, None], last),
                                       rec["decode_p50_ms"])
        rec["prefill_trace"] = lm_trace(lambda: lm.prefill_step(model, cfg, toks), rec["prefill_ms"])
    del state
    seq = torch.cat([toks, torch.stack(fed, dim=1)], dim=1)
    full, aux = lm.forward(model, whole_chunk(cfg, s + new), seq)
    require(bool(torch.isfinite(aux)), f"{what}: non-finite aux loss")
    rec["aux"] = aux.item()
    rec["prefill_gate"] = lm_gate(logits, full[:, s - 1], f"{what} prefill", f32=f32, soft=soft)
    steps = [lm_gate(lg, full[:, s + i], f"{what} decode step {i}", f32=f32, soft=soft)
             for i, lg in enumerate(step_logits)]
    rec["decode_gate"] = {k: (min if k == "greedy_agree" else max)(st[k] for st in steps)
                          for k in steps[0]}
    rec["logits_shape"] = list(step_logits[0].shape)
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated() - base
    del full, step_logits
    return rec, model


def lm_trace(run, wall_ms: float) -> dict:
    """Device busy time, kernel launches and the top kernels by device time
    over one traced call of ``run``; idle share against its untraced time."""
    by_name = traced_ms(run)
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_busy_ms": busy, "launches": sum(n for _, n in by_name.values()),
            "idle_share": 1.0 - busy / wall_ms,
            "top": [[name[:80], round(t, 4), n] for name, (t, n) in top]}


def lm_bounds(cfg, rec: dict, b: int, s: int, new: int, ops_rate: float) -> None:
    """The least time of a prefill (operations: 2 x the layers' matmul
    parameters x tokens, the causal attention's QK and PV, the last
    position's unembedding; or its parameter bytes) and of a decode step
    (bytes: every parameter and the K/V read at the steps' mean length)."""
    elt = 2 if cfg.dtype == "bfloat16" else 4
    table = cfg.vocab_size * cfg.d_model
    layer_mm = rec["params"] - table - (cfg.num_layers * 2 + 1) * cfg.d_model
    attn = cfg.num_layers * 2 * b * cfg.num_heads * s * s * cfg.head_dim     # causal: S^2/2 x 2 products x 2
    prefill_ops = 2 * layer_mm * b * s + attn + 2 * table * b
    rec["prefill_bound_ms"], rec["prefill_bound_by"] = bound(rec["param_bytes"], prefill_ops, ops_rate)
    kv_read = sum(cfg.num_layers * b * (s + i + 1) * cfg.num_kv_heads * cfg.head_dim * 2 * elt
                  for i in range(new)) / new
    rec["decode_kv_bytes"] = kv_read
    rec["decode_bound_ms"], rec["decode_bound_by"] = bound(
        rec["param_bytes"] + kv_read, 2 * (layer_mm + table) * b, ops_rate)


def ring_matches_full(model, cfg, b: int, steps: int) -> dict:
    """gemma3: decoding from a fresh ring-local state equals decoding from a
    fresh full cache, past the window (the reference's
    ``test_ring_local_decode_matches_full_cache``, at its 2e-2)."""
    toks = lm_tokens(cfg, b, steps, 12)
    full = lm.init_decode_state(cfg, b, steps)
    ring = lm.init_decode_state(cfg, b, steps, ring_local=True)
    worst = torch.zeros((), device="cuda")
    for i in range(steps):
        pos = torch.full((b,), i, device="cuda")
        lf, full = lm.decode_step(model, cfg, full, toks[:, i:i + 1], pos)
        lr, ring = lm.decode_step(model, cfg, ring, toks[:, i:i + 1], pos)
        worst = torch.maximum(worst, ((lr - lf).abs().amax(-1) / lf.abs().amax(-1)).max())
    worst = worst.item()
    require(worst <= LM_BF16_TOL, f"ring-local decode leaves the full cache's by {worst}")
    return {"steps": steps, "window": cfg.window_size, "ring_slots": ring["kv_local"]["k"].shape[-3],
            "max_row_rel_err": worst}


def card_vs_cpu(model, cfg, b: int, s: int, steps: int, tol: float) -> float:
    """The same weights on the card and the CPU: forward and prefill logits,
    every prefill cache leaf, ``steps`` decode steps on the sized cache (the
    logits and every state leaf) equal within ``tol``; the largest error."""
    cpu_model = lm.LM(cfg, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    toks = lm_tokens(cfg, b, s + steps, 7)
    worst = 0.0

    def same(got, want, what):
        nonlocal worst
        got, want = got.cpu().float(), want.float()
        require(torch.allclose(got, want, atol=tol, rtol=tol), f"{cfg.name} card vs CPU: {what}")
        worst = max(worst, (got - want).abs().max().item())

    same(lm.forward(model, cfg, toks[:, :s])[0], lm.forward(cpu_model, cfg, toks[:, :s].cpu())[0],
         "forward")
    lg, cache = lm.prefill_step(model, cfg, toks[:, :s])
    lg_c, cache_c = lm.prefill_step(cpu_model, cfg, toks[:, :s].cpu())
    same(lg, lg_c, "prefill logits")
    for key in cache:
        for leaf in cache[key]:
            same(cache[key][leaf], cache_c[key][leaf], f"prefill {key}/{leaf}")
    st, st_c = sized_state(cfg, cache, b, s, steps), sized_state(cfg, cache_c, b, s, steps, "cpu")
    for i in range(steps):
        pos = torch.full((b,), s + i)
        lg, st = lm.decode_step(model, cfg, st, toks[:, s + i:s + i + 1], pos.cuda())
        lg_c, st_c = lm.decode_step(cpu_model, cfg, st_c, toks[:, s + i:s + i + 1].cpu(), pos)
        same(lg, lg_c, f"decode step {i}")
        for key in st:
            for leaf in st[key]:
                same(st[key][leaf], st_c[key][leaf], f"step {i} {key}/{leaf}")
    return worst


def lm_phase(out: Path) -> dict:
    """Phase 16: the LM substrate's serving path (``repro_torch.models``).

    1. llama3.2-1b's ``CONFIG`` (16 layers, d 2048, vocab 128256) with random
       weights from seed 0: 8 prompts of 512 seeded tokens prefilled, the
       cache copied into a state of 512 + 64, 64 greedy decode steps; the
       prefill's and every step's logits held against ``forward`` over the
       prompt plus the fed tokens, in f32 (TF32 off, 1e-3) and in bf16
       (2e-2 of the row's max |logit|); times, tokens/s, peak bytes, bounds;
    2. every other architecture at full width and one superblock deep: its
       forward, prefill and 8 decode steps on the sized cache in f32 and in
       bf16 under the same gates (the SSM stacks' bf16 error reported, not
       gated: ``LM_BF16_REPORTED``; the MoE stacks at a capacity that drops no token: a
       forward and a decode step group tokens differently); gemma3's prompt
       of 1536 past its window and its ring-local decode against its full
       cache; MoE's aux loss finite; musicgen's [B, 4, 2048] logits;
    3. card against CPU: every SMOKE config in f32 (forward, prefill and its
       cache, 4 decode steps) within 1e-4, then llama3.2-1b's ``CONFIG`` in
       f32 at B 2, S 32 within 1e-3;
    4. B1-B6 launch no time in the phase.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    reset_counts()
    rec: dict = {}
    reduced: dict = {}

    # 1. the served model, f32 then bf16
    cfg = get_lm_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    served = {}
    for name, c, ops_rate in (("float32", cfg32, FP32_OPS_PER_S), ("bfloat16", cfg, BF16_OPS_PER_S)):
        r, model = lm_serve(c, LM_BATCH, LM_PROMPT, LM_NEW, f32=c is cfg32, seed=1,
                            what=f"{LM_ARCH} {name}", timed=True)
        lm_bounds(c, r, LM_BATCH, LM_PROMPT, LM_NEW, ops_rate)
        served[name] = r
        if c is cfg32:
            model32 = model
        del model
        torch.cuda.empty_cache()
    rec["served"] = {"arch": LM_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
                     "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW, **served}

    # 2. every other architecture, full width, one superblock
    archs = {}
    for arch in LM_ARCHS:
        if arch == LM_ARCH:
            continue
        full_cfg = get_lm_config(arch)
        keep = max(full_cfg.layer_groups()[1], 2)     # one superblock; two layers of a flat stack
        c = dataclasses.replace(full_cfg, num_layers=keep)
        reduced[f"{arch}.num_layers"] = [full_cfg.num_layers, keep]
        if c.is_moe:
            # capacity follows the token group (a forward's whole batch, a decode
            # step's B rows), so at 1.25 the two drop different tokens and their
            # logits differ by design; at E / k no group drops a token
            c = dataclasses.replace(c, capacity_factor=c.num_experts / c.top_k)
            reduced[f"{arch}.capacity_factor"] = [full_cfg.capacity_factor, c.capacity_factor]
        t0 = time.perf_counter()
        archs[arch] = {}
        for name, cd in (("float32", dataclasses.replace(c, dtype="float32")), ("bfloat16", c)):
            f32 = cd.dtype == "float32"
            r, model = lm_serve(cd, LM_OTHER["batch"], LM_PROMPTS.get(arch, LM_OTHER["prompt"]),
                                LM_OTHER["new"], f32=f32, seed=2, what=f"{arch} {name}",
                                soft=not f32 and arch in LM_BF16_REPORTED)
            if cd.num_codebooks > 1:
                require(r["logits_shape"] == [LM_OTHER["batch"], cd.num_codebooks, cd.vocab_size],
                        f"{arch}: logits {r['logits_shape']}")
            if cd.attn_pattern == "local_global" and not f32:
                r["ring_local"] = ring_matches_full(model, cd, LM_OTHER["batch"], cd.window_size + 8)
            archs[arch][name] = {k: r[k] for k in (
                "params", "param_bytes", "init_s", "prefill_ms", "decode_p50_ms", "aux",
                "prefill_gate", "decode_gate", "logits_shape", "peak_device_bytes", "ring_local")
                if k in r}
            del model
            torch.cuda.empty_cache()
        archs[arch]["seconds"] = time.perf_counter() - t0
    rec["archs"] = archs

    # 3. card against CPU
    t0 = time.perf_counter()
    smoke = {}
    for arch in LM_ARCHS:
        c = dataclasses.replace(get_lm_config(arch, smoke=True), dtype="float32")
        model = lm.init_params(c, seed=0)
        smoke[arch] = card_vs_cpu(model, c, LM_CPU["batch"], LM_CPU["prompt"], LM_CPU["steps"], 1e-4)
    full_err = card_vs_cpu(model32, cfg32, LM_CPU["batch"], LM_CPU["full_prompt"], 2, LM_F32_TOL)
    del model, model32
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = {"smoke_f32_max_abs_err": smoke, "tol": 1e-4,
                          f"{LM_ARCH}_f32_max_abs_err": full_err, f"{LM_ARCH}_tol": LM_F32_TOL,
                          "seconds": time.perf_counter() - t0}

    # 4. no UDG kernel on this path
    launches = dict(ops.LAUNCHES)
    require(not any(launches.values()), f"the LM path launched a UDG kernel: {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"reduced": reduced})
    emit({"lm": rec})
    (out / "lm.json").write_text(json.dumps(rec, indent=1))
    return launches


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8   # phase 17: one repeated batch of 8 x 512
TRAIN_REL_TOL = 2e-2          # the first loss against softmax_xent(forward) under no_grad
REMAT_REL_TOL = 1e-6          # loss and grad norm across the three remat policies
TRAIN_CPU_TOL = 1e-4          # a SMOKE step on the card against the CPU, f32


def train_bound(cfg, n_params: int, b: int, s: int) -> tuple:
    """The least time of one train step: operations, 3 x the forward's (the
    layers' and the tied unembedding's products, 2 x parameters x tokens,
    and the causal attention's QK and PV) at the bf16 tensor-core peak; or
    bytes, each parameter, gradient, f32 master and moment read and written
    once by the update. Returns (ms, "operations" or "bytes", ops, bytes)."""
    norms = (cfg.num_layers * 2 + 1) * cfg.d_model
    matmul = n_params - norms                     # every matrix, the table as the unembedding
    attn = cfg.num_layers * 2 * b * cfg.num_heads * s * s * cfg.head_dim
    ops = 3 * (2 * matmul * b * s + attn)
    elt = 2 if cfg.dtype == "bfloat16" else 4
    nbytes = n_params * (2 * elt + elt + 3 * 4 * 2)   # params r+w, grads r, master/mu/nu r+w
    ms, by = bound(nbytes, ops, BF16_OPS_PER_S)
    return ms, by, ops, nbytes


def train_smoke_card_vs_cpu(arch: str) -> float:
    """One f32 train step of ``arch``'s SMOKE config on the card and on the
    CPU from the same parameters and batch: the metrics and every leaf of
    (params, opt_state) within ``TRAIN_CPU_TOL``; the largest error."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.train import adamw
    from repro_torch.train.checkpoint import _flatten

    c = dataclasses.replace(get_lm_config(arch, smoke=True), dtype="float32")
    model = lm.init_params(c, seed=0)
    cpu_model = lm.LM(c, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    batch = synthetic_batch(np.random.default_rng(3), c, 2, 32)
    opt = adamw(lr=1e-3)
    st, st_c = opt.init(model), opt.init(cpu_model)
    _, _, m = lm.make_train_step(c, opt)(model, st, batch)
    _, _, m_c = lm.make_train_step(c, opt)(cpu_model, st_c, batch)
    got, want = _flatten((model, st)), _flatten((cpu_model, st_c))
    got.update({f"metric/{k}": v.cpu().numpy() for k, v in m.items()})
    want.update({f"metric/{k}": v.numpy() for k, v in m_c.items()})
    worst = 0.0
    for key, w in want.items():
        require(np.allclose(got[key], w, atol=TRAIN_CPU_TOL, rtol=TRAIN_CPU_TOL),
                f"{arch} train step, card vs CPU: {key}")
        worst = max(worst, float(np.max(np.abs(got[key].astype(np.float64) - w))) if w.size else 0.0)
    return worst


def launcher_resume(work: Path) -> dict:
    """``launch.train.main`` on the card: llama3.2-1b SMOKE for 6 steps with
    a checkpoint every 3, and again stopped at 3 then resumed to 6; step 6's
    checkpoints compared (bitwise under ``torch.use_deterministic_algorithms``
    where that holds, else within 1e-6)."""
    from repro_torch.launch import train as launcher

    shutil.rmtree(work, ignore_errors=True)
    base = ["--arch", LM_ARCH, "--smoke", "--ckpt-every", "3"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        whole = launcher.main(base + ["--steps", "6", "--ckpt-dir", str(work / "whole")])
        whole_s = time.perf_counter() - t0
        first = launcher.main(base + ["--steps", "3", "--ckpt-dir", str(work / "cut")])
        resumed = launcher.main(base + ["--steps", "6", "--resume", "--ckpt-dir", str(work / "cut")])
    finally:
        torch.use_deterministic_algorithms(False)
    require(resumed["start"] == 3, f"the resumed run started at {resumed['start']}")
    require(all(math.isfinite(v) for v in whole["losses"] + first["losses"] + resumed["losses"]),
            "a launcher loss is not finite")
    with np.load(work / "whole" / "step_0000000006" / "arrays.npz") as a, \
            np.load(work / "cut" / "step_0000000006" / "arrays.npz") as b:
        require(sorted(a.files) == sorted(b.files), "the two step-6 checkpoints hold other keys")
        err = max(float(np.max(np.abs(a[k].astype(np.float64) - b[k]))) if a[k].size else 0.0
                  for k in a.files)
        bitwise = all(np.array_equal(a[k], b[k]) for k in a.files)
    require(err <= 1e-6, f"the resumed run's step 6 leaves the uninterrupted run's by {err}")
    shutil.rmtree(work, ignore_errors=True)
    return {"steps": 6, "ckpt_every": 3, "resumed_from": resumed["start"],
            "losses_whole": whole["losses"], "losses_resumed": first["losses"] + resumed["losses"],
            "step6_bitwise": bitwise, "step6_max_abs_err": err,
            "deterministic_algorithms": True, "whole_run_s": whole_s}


def train_phase(out: Path) -> dict:
    """Phase 17: the training path (``models.steps.make_train_step``,
    ``train.adamw``, ``train.checkpoint``, ``launch.train``).

    1. llama3.2-1b's ``CONFIG`` at full width and depth (bf16, remat
       "dots"), random weights from seed 0: ``TRAIN_STEPS`` AdamW steps
       (``cosine_lr(1e-3, warmup=2, total=8)``) over one repeated
       ``synthetic_batch`` of 8 x 512 (seed 1); every loss and grad norm
       finite, the first loss within 2e-2 of ``softmax_xent(forward)``
       under ``no_grad``, the last below the first; step ms (p50), tokens/s,
       the bound, peak bytes, and one traced step (device busy, launches,
       idle share);
    2. from the trained parameters, two steps each under remat "none",
       "dots" and "full" (a fresh optimizer state each, deterministic
       algorithms on): the first's loss and grad norm within 1e-6 of each
       other, the second's ms, the peak bytes of both; then
       one step in f32 (TF32 off) from the same parameters widened, its
       loss beside the bf16 one;
    3. card against CPU: one f32 step of every SMOKE config within 1e-4;
    4. the launcher on the card: 6 steps with a checkpoint every 3, and 3
       steps resumed to 6, equal at step 6;
    5. B1-B6 launch no time in the phase."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.train import adamw, cosine_lr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    reset_counts()
    rec: dict = {}
    cfg = get_lm_config(LM_ARCH)
    require(cfg.remat == "dots", f"{LM_ARCH}'s remat is {cfg.remat}")

    # 1. eight steps at full width
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, seed=0)
    opt = adamw(lr=cosine_lr(1e-3, warmup=2, total=TRAIN_STEPS))
    state = opt.init(model)
    torch.cuda.synchronize()
    n_params = lm.param_count(model)
    rec.update(arch=LM_ARCH, layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
               dtype=cfg.dtype, config_remat=cfg.remat, params=n_params, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, steps=TRAIN_STEPS, init_s=time.perf_counter() - t0,
               state_bytes=torch.cuda.memory_allocated() - base)
    batch = synthetic_batch(np.random.default_rng(1), cfg, TRAIN_BATCH, TRAIN_SEQ)
    toks = torch.as_tensor(batch["tokens"], device="cuda")
    labels = torch.as_tensor(batch["labels"], device="cuda")
    with torch.no_grad():
        logits, aux = lm.forward(model, cfg, toks)
        want0 = lm.softmax_xent(logits, labels).item()
    del logits
    step = lm.make_train_step(cfg, opt)
    losses, gnorms, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, state, batch)[2]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated() - base
    require(all(math.isfinite(v) for v in losses + gnorms), f"non-finite loss or grad norm: {losses} {gnorms}")
    first_rel = abs(losses[0] - want0) / abs(want0)
    require(first_rel <= TRAIN_REL_TOL,
            f"the first step's loss {losses[0]} leaves softmax_xent(forward) {want0} by {first_rel}")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    timed = step_ms[1:]                           # the first is warm-up
    p50 = float(np.percentile(timed, 50))
    b_ms, b_by, b_ops, b_bytes = train_bound(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    rec.update(forward_loss=want0, first_loss_rel_err=first_rel, losses=losses, grad_norms=gnorms,
               step_ms=step_ms, step_p50_ms=p50, warmup_step_ms=step_ms[0],
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ * 1e3 / p50, bound_ms=b_ms, bound_by=b_by,
               bound_ops=b_ops, bound_bytes=b_bytes, fraction_of_bound=b_ms / p50)
    rec["trace"] = lm_trace(lambda: step(model, state, batch), p50)

    # 2. the remat policies and f32, from the trained parameters: two steps
    # each, the first's loss and grad norm compared, the second timed (its
    # memory comes from the allocator's cache, as in a training loop)
    snap = {n: p.detach().clone() for n, p in model.named_parameters()}
    del state, m
    torch.cuda.empty_cache()
    remat = {}
    torch.use_deterministic_algorithms(True, warn_only=True)   # the embedding's scatter-add
    for policy in ("none", "dots", "full"):
        c = dataclasses.replace(cfg, remat=policy)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(snap[n])
        o = adamw(lr=1e-4)
        st = o.init(model)
        pstep = lm.make_train_step(c, o)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m = pstep(model, st, batch)[2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pstep(model, st, batch)
        torch.cuda.synchronize()
        remat[policy] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                         "step_ms": (time.perf_counter() - t0) * 1e3,
                         "peak_device_bytes": torch.cuda.max_memory_allocated() - base}
        del st, m
    torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    for policy in ("dots", "full"):
        for key in ("loss", "grad_norm"):
            a, b = remat[policy][key], remat["none"][key]
            require(abs(a - b) <= REMAT_REL_TOL * abs(b),
                    f"remat {policy} {key} {a} leaves none's {b}")
    rec["remat"] = remat
    del model
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    c32 = dataclasses.replace(cfg, dtype="float32")
    m32 = lm.LM(c32, device="meta").to_empty(device="cuda")
    with torch.no_grad():
        for n, p in m32.named_parameters():
            p.copy_(snap[n])
    del snap
    o = adamw(lr=1e-4)
    st = o.init(m32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = lm.make_train_step(c32, o)(m32, st, batch)[2]
    torch.cuda.synchronize()
    f32 = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
           "step_ms": (time.perf_counter() - t0) * 1e3,
           "peak_device_bytes": torch.cuda.max_memory_allocated() - base}
    require(math.isfinite(f32["loss"]) and math.isfinite(f32["grad_norm"]), f"f32 step: {f32}")
    f32["loss_rel_to_bf16"] = abs(f32["loss"] - remat["dots"]["loss"]) / abs(f32["loss"])
    f32["grad_norm_rel_to_bf16"] = abs(f32["grad_norm"] - remat["dots"]["grad_norm"]) / abs(f32["grad_norm"])
    rec["f32_step"] = f32
    del m32, st, m
    torch.cuda.empty_cache()

    # 3. card against CPU on every SMOKE config
    t0 = time.perf_counter()
    rec["card_vs_cpu"] = {"smoke_f32_max_abs_err": {a: train_smoke_card_vs_cpu(a) for a in LM_ARCHS},
                          "tol": TRAIN_CPU_TOL, "seconds": time.perf_counter() - t0}

    # 4. the launcher, its checkpoints and a resume
    rec["launcher"] = launcher_resume(out / "train_ckpt")

    # 5. no UDG kernel on this path
    launches = dict(ops.LAUNCHES)
    require(not any(launches.values()), f"the train path launched a UDG kernel: {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"reduced": {"train_checkpoint_smoke": [LM_ARCH, f"{LM_ARCH}-smoke"],
                      "why": "a full-width checkpoint is 19.8 GB of npz (parameters, f32 masters "
                             "and both moments), beyond the run's time limit; the launcher's "
                             "checkpoints and resume run on the SMOKE config"}})
    emit({"train": rec, "card": RECORD.get("card")})
    (out / "train.json").write_text(json.dumps(rec, indent=1))
    return launches


DIST_STEPS = 3                # phase 18: sharded steps held against the one-process step
DIST_REL_TOL = 1e-6           # their loss and grad norm, deterministic algorithms on
DIST_SMOKE_TOL = 1e-4         # a SMOKE sharded step on the card against the CPU, f32
DIST_BUDGET_S = 100.0         # the phase's share of the run's time limit (reported)
ELASTIC_FAIL_AT = 17
TP_RANKS, TP_STEPS = 2, 2     # phase 18's two processes on one card (gloo over CUDA tensors)
TP_LAYERS = 1                 # their depth (of 16): gloo stages every collective through the host
TP_REL_TOL = 1e-4             # their f32 loss and grad norm against the one-process f32 step
TP_TIMEOUT_S = 240            # the two processes' wall-clock limit, and the gloo group's
TP_SSM = {"falcon-mamba-7b": 1, "zamba2-2.7b": 6}   # their SSM runs: layers (one superblock)
TP_SSM_BATCH, TP_SSM_SEQ, TP_SSM_NEW = 2, 128, 2    # batch, sequence and decoded tokens
TP_SSM_CHUNK = 64             # their scan's chunk: the sequence's two chunks carry the state
TP_SSM_LOGIT_TOL = 1e-4       # their f32 logits against the one-process f32 run (atol = rtol)
TP_SSM_GNORM_TOL = 3e-4       # their grad norm after the first AdamW step (relative; PERF.md 6)
TP_FLOPS_REL_TOL = 0.05       # a rank's FLOPs against the one-process step's share


def dist_smoke_card_vs_cpu(arch: str, mesh_gpu, mesh_cpu) -> float:
    """One f32 sharded step of ``arch``'s SMOKE config on the card and on
    the CPU (the same one-rank group: NCCL for the card's tensors, gloo for
    the host's) from the same parameters and batch: the metrics and every
    slice of the state within ``DIST_SMOKE_TOL``; the largest error."""
    from repro_torch.distributed.fsdp import make_sharded_train_step
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.train import adamw

    c = dataclasses.replace(get_lm_config(arch, smoke=True), dtype="float32")
    model = lm.init_params(c, seed=0)
    cpu_model = lm.LM(c, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    batch = synthetic_batch(np.random.default_rng(3), c, 2, 32)
    got, want = {}, {}
    for mesh, m_, out in ((mesh_gpu, model, got), (mesh_cpu, cpu_model, want)):
        shard_state, step = make_sharded_train_step(c, adamw(lr=1e-3), mesh)
        st = shard_state(m_)
        st, m = step(st, batch)
        out.update({f"metric/{k}": v.detach().cpu().double().numpy() for k, v in m.items()})
        opt = st["opt"]
        for tree, name in ((st["params"], "params"), (opt.mu, "mu"), (opt.nu, "nu"),
                           (opt.master, "master")):
            out.update({f"{name}/{k}": v.detach().cpu().double().numpy() for k, v in tree.items()})
    worst = 0.0
    for key, w in want.items():
        require(np.allclose(got[key], w, atol=DIST_SMOKE_TOL, rtol=DIST_SMOKE_TOL),
                f"{arch} sharded step, card vs CPU: {key}")
        worst = max(worst, float(np.max(np.abs(got[key] - w))) if w.size else 0.0)
    return worst


def elastic_toy(mesh_of, work: Path, fail_at) -> tuple:
    """The reference test's toy quadratic (``tests/test_distributed.py``)
    through ``ElasticRunner`` on the card: 30 steps, a checkpoint every 5,
    one failure at ``fail_at`` (or none) recovered on the same one rank.
    Returns (the final w, steps, restarts)."""
    from repro_torch.distributed.elastic import ElasticRunner
    from torch.utils._pytree import tree_map
    from repro_torch.distributed.sharding import P
    from repro_torch.train import CheckpointManager, adamw

    opt = adamw(lr=0.1, weight_decay=0.0)

    def make_step(mesh):
        def step(state, batch):
            w = state["params"]["w"].requires_grad_(True)
            x, y = (torch.as_tensor(batch[k], device=mesh.device) for k in ("x", "y"))
            with torch.enable_grad():
                (g,) = torch.autograd.grad(torch.mean((x @ w - y) ** 2), [w])
            opt.update({"w": g}, state["opt"], state["params"])
            return state
        return step

    rng = np.random.default_rng(0)
    w0 = {"w": torch.as_tensor(rng.normal(size=(4,)).astype(np.float32))}
    state = {"params": w0, "opt": opt.init(w0)}
    batches = [{"x": rng.normal(size=(8, 4)).astype(np.float32),
                "y": rng.normal(size=(8,)).astype(np.float32)} for _ in range(30)]
    shutil.rmtree(work, ignore_errors=True)
    runner = ElasticRunner(ckpt=CheckpointManager(str(work), keep=2), make_mesh=mesh_of,
                           make_step=make_step, state_specs=lambda m: tree_map(lambda _: P(), state),
                           ckpt_every=5)
    st, steps, restarts = runner.run(state, batches, n_devices=1, fail_at=fail_at,
                                     recover_devices=1)
    shutil.rmtree(work, ignore_errors=True)
    return st["params"]["w"].detach().cpu(), steps, restarts


def tp_schedule():
    """Phase 18's optimizer, for every run of the phase:
    ``cosine_lr(1e-3, warmup=2, total=8)`` AdamW."""
    from repro_torch.train import adamw, cosine_lr

    return adamw(lr=cosine_lr(1e-3, warmup=2, total=TRAIN_STEPS))


def f32_model(cfg):
    """``init_params(cfg, seed=0)`` on the card, widened to f32."""
    model = lm.init_params(cfg, seed=0)
    m32 = lm.LM(dataclasses.replace(cfg, dtype="float32"), device="meta").to_empty(device="cuda")
    with torch.no_grad():
        for (_, p), (_, q) in zip(m32.named_parameters(), model.named_parameters()):
            p.copy_(q)
    return m32


def gloo_cuda_probe(group) -> dict:
    """Which collectives a gloo group takes on CUDA tensors, by dtype: "ok"
    or the error it raised."""
    import torch.distributed as dist

    ops = {"all_reduce_sum": lambda t: dist.all_reduce(t, group=group),
           "all_reduce_max": lambda t: dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group),
           "all_gather_into_tensor": lambda t: dist.all_gather_into_tensor(
               t.new_empty((t.numel() * dist.get_world_size(group),)), t, group=group)}
    got = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, op in ops.items():
            try:
                op(torch.ones(4, dtype=dtype, device="cuda"))
                torch.cuda.synchronize()
                got[f"{name}/{str(dtype)[6:]}"] = "ok"
            except Exception as e:  # recorded: the run says what gloo refused
                got[f"{name}/{str(dtype)[6:]}"] = f"{type(e).__name__}: {str(e)[:160]}"
    return got


def tp_config():
    """llama3.2-1b at full width, ``TP_LAYERS`` deep (bf16, as ``CONFIG``)."""
    return dataclasses.replace(get_lm_config(LM_ARCH), num_layers=TP_LAYERS)


def tp_ssm_config(arch: str):
    """``arch`` at full width, ``TP_SSM[arch]`` layers deep, its scan chunked
    by ``TP_SSM_CHUNK`` (bf16, as ``CONFIG``; the runs widen it to f32)."""
    return dataclasses.replace(get_lm_config(arch), num_layers=TP_SSM[arch],
                               ssm_chunk=TP_SSM_CHUNK)


def tp_ssm_inputs(cfg) -> tuple:
    """(the train batch, the serving tokens [B, S + new]) of an SSM run."""
    from repro_torch.launch.train import synthetic_batch

    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (TP_SSM_BATCH, TP_SSM_SEQ + TP_SSM_NEW))
    return synthetic_batch(np.random.default_rng(1), cfg, TP_SSM_BATCH, TP_SSM_SEQ), toks


def tp_ssm_repeated_flops(cfg) -> float:
    """The FLOPs of one train step that every rank of the model group
    computes whole: Mamba2's B and C columns of ``in_proj`` (forward and
    both backward products)."""
    if cfg.ssm_kind != "mamba2":
        return 0.0
    G, P = cfg.layer_groups()
    return 3 * 2 * TP_SSM_BATCH * TP_SSM_SEQ * cfg.d_model * 2 * cfg.ssm_state * G * (P - 1)


def tp_ssm_one_process(arch: str) -> dict:
    """A prefill of ``TP_SSM_SEQ`` tokens and ``TP_SSM_NEW`` decode steps
    of ``tp_ssm_config(arch)`` in f32 on ``f32_model``'s weights, then
    ``TP_STEPS`` one-process train steps (the first counted): the logits
    (on the host), metrics, FLOPs and peak bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = tp_ssm_config(arch)
    c32 = dataclasses.replace(cfg, dtype="float32")
    batch, toks = tp_ssm_inputs(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = f32_model(cfg)
    S, B, new = TP_SSM_SEQ, TP_SSM_BATCH, TP_SSM_NEW
    t = torch.as_tensor(toks, device="cuda")
    logits, cache = lm.prefill_step(model, c32, t[:, :S])
    st = sized_state(c32, cache, B, S, new)
    outs = [logits]
    for i in range(new):
        logits, st = lm.decode_step(model, c32, st, t[:, S + i:S + i + 1],
                                    torch.full((B,), S + i, device="cuda"))
        outs.append(logits)
    logits = torch.stack(outs).cpu()
    del st, cache, outs
    opt = tp_schedule()
    state, ustep = opt.init(model), lm.make_train_step(c32, opt)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) if i == 0 else contextlib.nullcontext() as fc:
            m = ustep(model, state, batch)[2]
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item()})
        if i == 0:
            steps[0]["flops"] = float(fc.get_total_flops())
    peak = torch.cuda.max_memory_allocated()
    del model, state, ustep, m
    torch.cuda.empty_cache()
    return {"steps": steps, "peak_device_bytes": peak, "logits": logits}


def tp_ssm_rank(arch: str, mesh, work: str) -> dict:
    """One rank's share of an SSM run: the sharded prefill and
    ``TP_SSM_NEW`` decode steps of ``tp_ssm_config(arch)`` in f32 (rank 0
    writes the gathered logits to ``tp_ssm_<arch>.pt`` in ``work``), then
    ``TP_STEPS`` steps through the sharded train step (the first
    counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import comm
    from repro_torch.distributed.fsdp import (gather, gather_cache, make_sharded_serve_steps,
                                              make_sharded_train_step, read_policy, shard_cache,
                                              state_specs)
    from repro_torch.distributed.sharding import leaf_name, logits_spec

    cfg = tp_ssm_config(arch)
    c32 = dataclasses.replace(cfg, dtype="float32")
    batch, toks = tp_ssm_inputs(cfg)
    shard_state, step = make_sharded_train_step(c32, tp_schedule(), mesh)
    model = f32_model(cfg)
    state = shard_state(model)
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec = {"reads": {leaf_name(n): read_policy(n, c32, mesh) for n in step.specs
                     if ".mamba." in n},
           "state_bytes": torch.cuda.memory_allocated()}
    S, B, new = TP_SSM_SEQ, TP_SSM_BATCH, TP_SSM_NEW
    prefill, decode = make_sharded_serve_steps(c32, mesh)
    comm.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pspecs = state_specs(c32, mesh, B, S)
    logits, cache = prefill(state["params"], toks[:, :S], pspecs)
    st = sized_state(c32, gather_cache(cache, pspecs, mesh), B, S, new)
    specs = state_specs(c32, mesh, B, S + new)
    st = shard_cache(st, specs, mesh)
    outs = [logits]
    for i in range(new):
        logits, st = decode(state["params"], st, specs, toks[:, S + i:S + i + 1],
                            torch.full((B,), S + i))
        outs.append(logits)
    whole = torch.stack([gather(t, logits_spec(mesh, (B, c32.vocab_size)), mesh) for t in outs])
    torch.cuda.synchronize()
    rec["serve"] = {"ms": (time.perf_counter() - t0) * 1e3, "tp": comm.counts(tp=True),
                    "collectives": comm.counts()}
    if mesh.coord["model"] == 0:
        torch.save(whole.cpu(), Path(work) / f"tp_ssm_{arch}.pt")
    del st, cache, outs, whole
    steps = []
    for i in range(TP_STEPS):
        comm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) if i == 0 else contextlib.nullcontext() as fc:
            _, m = step(state, batch)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item(),
                      "peak_device_bytes": torch.cuda.max_memory_allocated(),
                      "tp": comm.counts(tp=True), "collectives": comm.counts()})
        if i == 0:
            steps[0]["flops"] = float(fc.get_total_flops())
    rec["steps"] = steps
    del state
    torch.cuda.empty_cache()
    return rec


def tp_rank(rank: int, work: str) -> None:
    """One of phase 18's two processes on the one card: a gloo group over
    CUDA tensors at data 1 x model ``TP_RANKS``; ``TP_STEPS`` f32 steps of
    ``tp_config()`` through the tensor-parallel sharded step, from
    ``f32_model``'s weights over phase 17's batch. Writes
    ``tp_rank<r>.json`` into ``work``."""
    import datetime

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import comm, make_train_mesh
    from repro_torch.distributed.fsdp import make_sharded_train_step
    from repro_torch.launch.train import synthetic_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=TP_RANKS,
                            rank=rank, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    rec: dict = {"rank": rank}
    try:
        rec["gloo_cuda"] = gloo_cuda_probe(dist.group.WORLD)
        cfg = tp_config()
        c32 = dataclasses.replace(cfg, dtype="float32")
        mesh = make_train_mesh(model=TP_RANKS, device="cuda")
        rec["mesh"] = {"shape": list(mesh.shape), "axes": list(mesh.axis_names)}
        shard_state, step = make_sharded_train_step(c32, tp_schedule(), mesh)
        model = f32_model(cfg)
        state = shard_state(model)
        del model
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rec["state_bytes"] = torch.cuda.memory_allocated()
        batch = synthetic_batch(np.random.default_rng(1), cfg, TRAIN_BATCH, TRAIN_SEQ)
        steps = []
        for i in range(TP_STEPS):
            comm.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with FlopCounterMode(display=False) if i == 0 else contextlib.nullcontext() as fc:
                _, m = step(state, batch)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"].item(),
                          "grad_norm": m["grad_norm"].item(),
                          "peak_device_bytes": torch.cuda.max_memory_allocated(),
                          "tp": comm.counts(tp=True), "collectives": comm.counts()})
            if i == 0:
                steps[0]["flops"] = float(fc.get_total_flops())
        rec["steps"] = steps
        del state
        torch.cuda.empty_cache()
        rec["ssm"] = {arch: tp_ssm_rank(arch, mesh, work) for arch in TP_SSM}
        rec["ok"] = True
    except Exception as e:  # reported by the parent, which fails the phase
        import traceback

        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    finally:
        (Path(work) / f"tp_rank{rank}.json").write_text(json.dumps(rec, indent=1))
        dist.destroy_process_group()


def tp_two_process(work: Path) -> dict:
    """Phase 18 section 2: ``TP_STEPS`` f32 one-process steps of
    ``tp_config()`` from ``f32_model``'s weights, then the same through
    ``TP_RANKS`` processes on the one card (``tp_rank``): their losses and
    grad norms within ``TP_REL_TOL``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.train import synthetic_batch

    cfg = tp_config()
    c32 = dataclasses.replace(cfg, dtype="float32")
    batch = synthetic_batch(np.random.default_rng(1), cfg, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = f32_model(cfg)
    opt = tp_schedule()
    state, ustep = opt.init(model), lm.make_train_step(c32, opt)
    torch.cuda.reset_peak_memory_stats()
    one = []
    for i in range(TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) if i == 0 else contextlib.nullcontext() as fc:
            m = ustep(model, state, batch)[2]
        torch.cuda.synchronize()
        one.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"].item(),
                    "grad_norm": m["grad_norm"].item()})
        if i == 0:
            one[0]["flops"] = float(fc.get_total_flops())
    peak = torch.cuda.max_memory_allocated()
    del model, state, ustep, m
    torch.cuda.empty_cache()
    ssm_one = {arch: tp_ssm_one_process(arch) for arch in TP_SSM}

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=tp_rank, args=(r, str(work.resolve()))) for r in range(TP_RANKS)]
    t0 = time.perf_counter()
    for pr in procs:
        pr.start()
    deadline = time.monotonic() + TP_TIMEOUT_S
    for pr in procs:
        pr.join(max(1.0, deadline - time.monotonic()))
    for pr in procs:
        if pr.is_alive():
            pr.kill()
            pr.join()
    wall = time.perf_counter() - t0
    ranks = []
    for r, pr in enumerate(procs):
        f = work / f"tp_rank{r}.json"
        ranks.append(json.loads(f.read_text()) if f.exists() else {"rank": r, "exitcode": pr.exitcode})
    rec = {"mesh": "data 1 x model 2", "processes": TP_RANKS, "backend": "gloo (CUDA tensors)",
           "dtype": "float32", "layers": TP_LAYERS, "steps": TP_STEPS, "one_process": one,
           "one_process_peak_device_bytes": peak, "ranks": ranks, "wall_s": wall,
           "note": "gloo stages every collective through the host: these times say nothing "
                   "about NVLink"}
    for r, pr in enumerate(procs):
        require(pr.exitcode == 0 and ranks[r].get("ok"),
                f"tensor-parallel rank {r} failed (exit {pr.exitcode}): "
                f"{ranks[r].get('error', 'no record')} {ranks[r].get('traceback', '')}")
    worst = 0.0
    for rk in ranks:
        for got, want in zip(rk["steps"], one):
            for key in ("loss", "grad_norm"):
                rel = abs(got[key] - want[key]) / abs(want[key])
                worst = max(worst, rel)
                require(math.isfinite(got[key]) and rel <= TP_REL_TOL,
                        f"rank {rk['rank']}'s {key} {got[key]} leaves the one-process f32 "
                        f"step's {want[key]} by {rel}")
    rec["max_rel_err"] = worst
    rec["tol"] = TP_REL_TOL
    rec["rank_flops_over_one_process"] = [rk["steps"][0]["flops"] / one[0]["flops"] for rk in ranks]
    rec["ssm"] = {arch: tp_ssm_check(arch, ssm_one[arch], [rk["ssm"][arch] for rk in ranks], work)
                  for arch in TP_SSM}
    shutil.rmtree(work, ignore_errors=True)
    return rec


def tp_ssm_check(arch: str, one: dict, ranks: list, work: Path) -> dict:
    """An SSM run's gates: the gathered prefill and decode logits within
    ``TP_SSM_LOGIT_TOL`` of the one-process run's on the same weights; each
    rank's losses and first grad norm within ``TP_REL_TOL`` of the
    one-process f32 steps', a later grad norm within ``TP_SSM_GNORM_TOL``
    (AdamW's first step moves every weight by about the learning rate
    whatever its gradient's size, so the rounding of near-zero gradient
    entries reaches the next gradient: PERF.md section 6, PR 24); each
    rank's FLOPs in the first step the one-process step's share (``1 /
    TP_RANKS``) plus what every rank repeats (``tp_ssm_repeated_flops``),
    within ``TP_FLOPS_REL_TOL``."""
    cfg = tp_ssm_config(arch)
    worst = 0.0
    for r, rk in enumerate(ranks):
        for i, (got, want) in enumerate(zip(rk["steps"], one["steps"])):
            for key in ("loss", "grad_norm"):
                rel = abs(got[key] - want[key]) / abs(want[key])
                tol = TP_SSM_GNORM_TOL if key == "grad_norm" and i else TP_REL_TOL
                worst = max(worst, rel)
                require(math.isfinite(got[key]) and rel <= tol,
                        f"{arch} rank {r}'s {key} {got[key]} at step {i} leaves the one-process "
                        f"f32 step's {want[key]} by {rel} (tolerance {tol})")
    got = torch.load(work / f"tp_ssm_{arch}.pt")
    want = one["logits"]
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            f"{arch}: sharded logits {tuple(got.shape)} against {tuple(want.shape)}")
    diff = (got - want).abs()
    excess = (diff - TP_SSM_LOGIT_TOL - TP_SSM_LOGIT_TOL * want.abs()).max().item()
    require(excess <= 0, f"{arch}: sharded prefill/decode logits leave the one-process run's "
                         f"by {diff.max().item()}")
    one_flops = one["steps"][0]["flops"]
    rep = tp_ssm_repeated_flops(cfg)
    share = (one_flops - rep) / TP_RANKS + rep
    over = [rk["steps"][0]["flops"] / share for rk in ranks]
    require(all(abs(o - 1.0) <= TP_FLOPS_REL_TOL for o in over),
            f"{arch}: a rank's FLOPs over its share {over} (share {share}, one process "
            f"{one_flops})")
    return {"layers": cfg.num_layers, "batch": TP_SSM_BATCH, "seq": TP_SSM_SEQ,
            "decode_steps": TP_SSM_NEW, "one_process": one["steps"],
            "one_process_peak_device_bytes": one["peak_device_bytes"], "ranks": ranks,
            "max_rel_err": worst, "later_grad_norm_tol": TP_SSM_GNORM_TOL,
            "logits_max_abs_err": diff.max().item(), "logits_tol": TP_SSM_LOGIT_TOL,
            "repeated_flops": rep,
            "rank_flops_over_one_process": [rk["steps"][0]["flops"] / one_flops for rk in ranks],
            "rank_flops_over_share": over}


def distributed_phase(out: Path) -> dict:
    """Phase 18: distributed training (``distributed.fsdp``,
    ``train.dp_trainer``, ``distributed.compression``,
    ``distributed.elastic``) in a one-rank process group (a FileStore under
    ``out``; NCCL for the card's tensors, gloo for the host's).

    1. llama3.2-1b's ``CONFIG`` at full width and depth (bf16, remat
       "dots", random weights from seed 0), deterministic algorithms on:
       ``DIST_STEPS`` steps of the one-process ``make_train_step``, then
       the same from the same weights through ``make_sharded_train_step``
       over data 1 x model 1 (the tensor-parallel step on a one-rank model
       group): loss and grad norm within 1e-6 of each other; each step's
       ms, peak bytes, the slices' bytes, collective bytes and calls a
       step, and the model group's (``tp``) among them; one more step of
       each traced (device busy, launches, idle share);
    2. two processes on the card in a gloo group over CUDA tensors
       (``tp_two_process``): data 1 x model 2, the same config in f32 at
       full width, ``TP_LAYERS`` deep, 2 steps within 1e-4 of 2 f32
       one-process steps from the same weights; then in the same two
       processes each of ``TP_SSM`` (falcon-mamba-7b 1 layer, zamba2-2.7b
       one superblock) at full width in f32, their scans chunked by 64,
       the Mamba blocks split over the ranks: the sharded prefill and 2
       decode steps, then 2 steps, against the one-process f32 run
       (``tp_ssm_check``);
       which collectives and dtypes gloo takes on CUDA tensors; each
       rank's ms, peak bytes, FLOPs and ``tp`` collectives a step;
    3. ``make_dp_train_step``, deterministic algorithms still on: 8 steps
       uncompressed and 8 with ``compress_grads`` over phase 17's repeated
       8 x 512 batch
       (``cosine_lr(1e-3, warmup=2, total=8)``): both losses fall, the gap
       between the last losses under ``0.15·(first - last) + 0.05``
       (``tests/test_distributed.py``'s bound); ms a step, peak bytes,
       the residual's bytes;
    4. ``ElasticRunner`` on the toy quadratic failing at step 17 and
       recovering: bit-equal to a run never interrupted;
    5. one f32 sharded step of every SMOKE config, card against CPU
       (1e-4);
    6. B1-B6 launch no time in the phase."""
    import torch.distributed as dist

    from repro_torch.distributed import comm, make_train_mesh
    from repro_torch.distributed.fsdp import make_sharded_train_step
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.train.dp_trainer import make_dp_train_step

    t_phase = time.perf_counter()
    reset_counts()
    rec: dict = {}
    cfg = get_lm_config(LM_ARCH)
    batch = synthetic_batch(np.random.default_rng(1), cfg, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.set_device(0)
    store = out / "dist_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{store.resolve()}",
                            world_size=1, rank=0)
    try:
        mesh = make_train_mesh(model=1, device="cuda")
        rec["mesh"] = {"shape": list(mesh.shape), "axes": list(mesh.axis_names),
                       "backend": "cpu:gloo,cuda:nccl", "world_size": 1}

        # 1. the sharded step against the one-process step, same weights
        torch.use_deterministic_algorithms(True, warn_only=True)   # the embedding's scatter-add
        runs = {}
        for form in ("one_process", "sharded"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            model = lm.init_params(cfg, seed=0)
            opt = tp_schedule()
            if form == "one_process":
                state, ustep = opt.init(model), lm.make_train_step(cfg, opt)
                step = lambda: ustep(model, state, batch)[2]      # noqa: E731
            else:
                shard_state, sstep = make_sharded_train_step(cfg, opt, mesh)
                state = shard_state(model)
                del model
                step = lambda: sstep(state, batch)[1]             # noqa: E731
            torch.cuda.synchronize()
            state_bytes = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            comm.reset_counts()
            losses, gnorms, ms = [], [], []
            for _ in range(DIST_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(m["loss"].item())
                gnorms.append(m["grad_norm"].item())
            p50 = float(np.percentile(ms[1:], 50))
            runs[form] = {"losses": losses, "grad_norms": gnorms, "step_ms": ms,
                          "step_p50_ms": p50, "warmup_step_ms": ms[0],
                          "state_bytes": state_bytes,
                          "peak_device_bytes": torch.cuda.max_memory_allocated() - base}
            for key, counts in (("collectives_per_step", comm.counts()),
                                ("tp_collectives_per_step", comm.counts(tp=True))):
                runs[form][key] = {k: {"bytes": v["bytes"] / DIST_STEPS,
                                       "calls": v["calls"] / DIST_STEPS} for k, v in counts.items()}
            runs[form]["trace"] = lm_trace(step, p50)     # a fourth step, traced
            if form == "sharded":
                runs[form]["slice_bytes"] = sum(
                    t.numel() * t.element_size() for tree in (state["params"], state["opt"].mu,
                                                              state["opt"].nu, state["opt"].master)
                    for t in tree.values())
            del state, step, m
            if form == "one_process":
                del model, ustep
            else:
                del sstep, shard_state
        torch.cuda.empty_cache()
        for key in ("losses", "grad_norms"):
            for a, b in zip(runs["sharded"][key], runs["one_process"][key]):
                require(math.isfinite(a) and abs(a - b) <= DIST_REL_TOL * abs(b),
                        f"the sharded step's {key} {runs['sharded'][key]} leave the one-process "
                        f"step's {runs['one_process'][key]}")
        runs["sharded_over_one_process"] = (runs["sharded"]["step_p50_ms"]
                                            / runs["one_process"]["step_p50_ms"])
        rec["sharded_step"] = runs
        torch.use_deterministic_algorithms(False)

        # 2. two processes on the card, tensor-parallel over a gloo group
        t0 = time.perf_counter()
        rec["tp_two_process"] = tp_two_process(out / "tp_work")
        rec["tp_two_process"]["seconds"] = time.perf_counter() - t0

        # 3. the data-parallel trainer, with and without int8 compression
        # (deterministic algorithms on: the gap gate reads one run)
        torch.use_deterministic_algorithms(True, warn_only=True)
        dp = {}
        for compress in (False, True):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            model = lm.init_params(cfg, seed=0)
            init_state, dstep = make_dp_train_step(cfg, tp_schedule(), mesh, compress_grads=compress)
            state = init_state(model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            comm.reset_counts()
            losses, ms = [], []
            for _ in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = dstep(state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(m["loss"].item())
            dp["int8" if compress else "pmean"] = {
                "losses": losses, "step_ms": ms, "step_p50_ms": float(np.percentile(ms[1:], 50)),
                "peak_device_bytes": torch.cuda.max_memory_allocated() - base,
                "residual_bytes": sum(r.numel() * r.element_size()
                                      for r in state["residual"].values()),
                "collectives_per_step": {k: {"bytes": v["bytes"] / TRAIN_STEPS,
                                             "calls": v["calls"] / TRAIN_STEPS}
                                         for k, v in comm.counts().items()}}
            require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
                    f"the DP trainer's loss did not fall (compress={compress}): {losses}")
            del model, state, dstep, init_state, m
            torch.cuda.empty_cache()
        plain, packed = dp["pmean"]["losses"], dp["int8"]["losses"]
        gap, limit = abs(packed[-1] - plain[-1]), 0.15 * abs(plain[0] - plain[-1]) + 0.05
        require(gap < limit, f"int8 compression leaves the trajectory: {gap} >= {limit}")
        dp.update(last_loss_gap=gap, gap_limit=limit,
                  compressed_over_plain=dp["int8"]["step_p50_ms"] / dp["pmean"]["step_p50_ms"])
        rec["dp_trainer"] = dp
        torch.use_deterministic_algorithms(False)
        rec["deterministic_algorithms"] = "sections 1 and 3"

        # 4. the elastic runner: a failure at step 17 recovers bit for bit
        mesh_of = lambda n: make_train_mesh(ranks=range(n), device="cuda")   # noqa: E731
        t0 = time.perf_counter()
        w_fail, steps, restarts = elastic_toy(mesh_of, out / "elastic_fail", ELASTIC_FAIL_AT)
        w_whole, steps_w, _ = elastic_toy(mesh_of, out / "elastic_whole", None)
        require(steps == steps_w == 30 and restarts == 1, f"elastic: {steps} steps, {restarts}")
        require(torch.equal(w_fail, w_whole), f"elastic: {w_fail} != {w_whole}")
        rec["elastic"] = {"steps": steps, "restarts": restarts, "fail_at": ELASTIC_FAIL_AT,
                          "bit_equal": True, "w": w_fail.tolist(), "seconds": time.perf_counter() - t0}

        # 5. card against CPU, one sharded step of every SMOKE config
        t0 = time.perf_counter()
        mesh_cpu = make_train_mesh(model=1, device="cpu")
        rec["card_vs_cpu"] = {"smoke_f32_max_abs_err": {a: dist_smoke_card_vs_cpu(a, mesh, mesh_cpu)
                                                        for a in LM_ARCHS},
                              "tol": DIST_SMOKE_TOL, "seconds": time.perf_counter() - t0}
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
        torch.cuda.empty_cache()

    # 6. no UDG kernel on this path
    launches = dict(ops.LAUNCHES)
    require(not any(launches.values()), f"the distributed path launched a UDG kernel: {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    rec["budget_s"] = DIST_BUDGET_S
    if rec["seconds"] > DIST_BUDGET_S:
        print(f"distributed phase: {rec['seconds']:.1f} s, over its {DIST_BUDGET_S} s budget",
              flush=True)
    emit({"reduced": {"tp_two_process_layers": [get_lm_config(LM_ARCH).num_layers, TP_LAYERS],
                      "why": "gloo stages every collective of the two processes through the "
                             "host; the run's time limit"}})
    emit({"reduced": {"tp_two_process_ssm": {
        arch: {"layers": [get_lm_config(arch).num_layers, n], "batch": TP_SSM_BATCH,
               "seq": TP_SSM_SEQ, "decode_steps": TP_SSM_NEW,
               "ssm_chunk": [get_lm_config(arch).ssm_chunk, TP_SSM_CHUNK]}
        for arch, n in TP_SSM.items()},
        "why": "two ranks share the one card and its 80 GB; the f32 one-process step keeps "
               "the chunked scan's [B, chunk, d_inner, d_state] tensors of a whole "
               "superblock; the run's time limit; the chunk cut so that the sequence "
               "spans two"}})
    emit({"tp_two_process_ssm": {arch: {
        "reads": v["ranks"][0]["reads"], "tp_per_step": v["ranks"][0]["steps"][-1]["tp"],
        "tp_serve": v["ranks"][0]["serve"]["tp"], "max_rel_err": v["max_rel_err"],
        "logits_max_abs_err": v["logits_max_abs_err"],
        "rank_flops_over_one_process": v["rank_flops_over_one_process"],
        "peak_device_bytes": [rk["steps"][0]["peak_device_bytes"] for rk in v["ranks"]]}
        for arch, v in rec["tp_two_process"]["ssm"].items()}})
    emit({"distributed": rec, "card": RECORD.get("card")})
    (out / "distributed.json").write_text(json.dumps(rec, indent=1))
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=FULL_N, help="corpus size")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "chip_smoke")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one auto batch with torch.profiler")
    ap.add_argument("--form", action="append", default=[], metavar="NAME=SOURCE",
                    help="another source of filter_dist.cu or beam_merge.cu to build, hold "
                         "and time beside the committed one on its kernel's inputs and on the "
                         "main path; repeatable")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    out = args.out
    out.mkdir(parents=True, exist_ok=True)

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    RECORD["card"] = smi

    # 2. build
    build_s = _build.build_all()
    (out / "nvcc.txt").write_text("".join(
        f"== {name}.cu ==\n{log}\n" for name, log in _build.LOGS.items()))
    require(_build.library("filter_dist").filter_dist_max_tile() == ops.SCORER_MAX_TILE,
            "filter_dist.cu's kMaxTile is not ops.SCORER_MAX_TILE")
    build_forms(args.form, out)
    emit({"build": {"nvcc_s": round(build_s, 2), "sources": sorted(_build.ARGTYPES),
                    "forms": sorted(FORMS), "merge_forms": sorted(MERGE_FORMS)}})

    # 3. index: the wave constructor (batched=None at this n), searches on the card
    n = args.n
    if n != FULL_N:
        emit({"reduced": {"n": [FULL_N, n], "why": "chosen with --n"}})
    vecs, s, t = make_dataset(n, DIM, seed=0)
    reset_counts()
    t0 = time.perf_counter()
    g, et, rep = build_index(vecs, s, t, CONFIG.relation, M=16, Z=128, K_p=8,
                             batched=None, device="cuda")
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    build_launches = dict(ops.LAUNCHES)
    require(rep.waves > 0, "build_index(batched=None) did not run the wave constructor")
    require(build_launches["filter_dist_gather"] > 0, "the wave build launched no B3")
    t0 = time.perf_counter()
    dg = export_planned_graph(g, et, device="cuda")
    export_s = time.perf_counter() - t0
    dev_bytes = {k: int(v.numel() * v.element_size())
                 for k, v in vars(dg.device()).items() if v is not None}
    emit({"index": {
        "n": n, "d": DIM, "relation": CONFIG.relation, "build_s": round(index_s, 1),
        "wave_search_s": round(rep.search_seconds, 1),
        "host_sweep_s": round(index_s - rep.search_seconds, 1),
        "waves": rep.waves, "broad_searches": rep.broad_searches,
        "b3_launches": build_launches["filter_dist_gather"],
        "loop_iterations": search_mod.LOOP_STATS["iterations"],
        "export_s": round(export_s, 2), "max_labeled_degree": int(max(g.adj[u].size for u in range(g.n))),
        "E": dg.max_degree, "tuples": rep.num_tuples, "device_bytes": dev_bytes,
    }})

    # 4. constructor parity at a size where every build is short
    emit({"constructor_parity": constructor_parity()})

    # 5. kernels at the paths' shapes
    qv, s_q, t_q = make_queries(BATCH, s, t, SELECTIVITIES, 1)
    q_dev = torch.as_tensor(qv, device="cuda")
    states, ep, _ = prepare_states_extended(dg, s_q, t_q)
    rows = check_kernels(dg, q_dev, torch.as_tensor(states, device="cuda"),
                         torch.as_tensor(ep, device="cuda"))
    delta_case = delta_scan_case(q_dev, s_q, t_q, n // 8)
    RECORD["kernel_cases"].append(delta_case)
    emit({"delta_scan_kernel": {k: delta_case[k] for k in (
        "B", "C", "D", "ms", "queued_ms", "plain_ms", "bound_ms", "bound_by", "pair_floor_ms",
        "every_pair_floor_ms", "passing_share", "materialized_bytes", "materialize_ms",
        "max_abs_err")}})

    # 6. main path: counts to 0 just before, read just after
    reset_counts()
    lat = []
    for i in range(1 + TIMED_BATCHES):          # the first is warm-up
        t0 = time.perf_counter()
        ids, d, pb = execute_batch(dg, qv, s_q, t_q, k=K, beam=BEAM, plan="auto",
                                   return_plans=True)
        lat.append(time.perf_counter() - t0)
    mix = pb.mix()
    bq, bs, bt = make_queries(BATCH, s, t, (BRUTE_SELECTIVITY,), 2)
    t0 = time.perf_counter()
    b_ids, b_d = execute_batch(dg, bq, bs, bt, k=K, beam=BEAM, plan="brute")
    brute_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    loop = dict(search_mod.LOOP_STATS)
    for name in ("filter_dist_gather_packed", "beam_merge", "filter_dist_gather"):
        require(launches[name] > 0, f"kernel {name} never launched on the main path")
    for res_ids, res_d in ((ids, d), (b_ids, b_d)):
        require(res_ids.shape == (BATCH, K) and res_d.shape == (BATCH, K), "result shape")
        # every query has >= k valid objects
        require(np.all(np.isfinite(res_d)), "non-finite distance in a result")
    recall, gt, gt_dists = {}, {}, {}
    for name, (qq, ss, tt, rid) in {"auto": (qv, s_q, t_q, ids), "brute": (bq, bs, bt, b_ids)}.items():
        qs = QuerySet(CONFIG.relation, qq[:1024], ss[:1024], tt[:1024], 0.0, np.zeros(1024), K)
        gt[name] = ground_truth(qs, vecs, s, t).gt_ids
        gt_dists[name] = qs.gt_dists
        recall[name] = recall_at_k(rid[:1024], qs)
    by_selectivity = {}
    for g_, sel in enumerate(SELECTIVITIES):
        idx = np.arange(g_, 1024, len(SELECTIVITIES))
        qs = QuerySet(CONFIG.relation, qv[idx], s_q[idx], t_q[idx], sel, np.zeros(idx.size), K,
                      gt_ids=gt["auto"][idx])
        plans = np.bincount(pb.plans[idx], minlength=3)
        by_selectivity[str(sel)] = {"recall_at_10": recall_at_k(ids[idx], qs),
                                    "plans": {PLAN_NAMES[p]: int(c) for p, c in enumerate(plans)}}
    require(recall["brute"] >= 0.999, f"exact brute scan recall {recall['brute']}")
    timed = lat[1:]
    emit({"main_path": {
        "batch": BATCH, "beam": BEAM, "k": K, "timed_batches": len(timed),
        "qps": BATCH / statistics.median(timed),
        "p50_batch_ms": float(np.percentile(timed, 50) * 1e3),
        "p99_batch_ms": float(np.percentile(timed, 99) * 1e3),
        "warmup_batch_ms": lat[0] * 1e3, "brute_batch_ms": brute_s * 1e3,
        "plan_mix": mix, "recall_at_10": recall["auto"], "brute_recall_at_10": recall["brute"],
        "recall_queries": 1024, "by_selectivity": by_selectivity, "launches": launches, "loop_syncs": loop["syncs"],
        "loop_iterations": loop["iterations"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }})
    emit({"main_path_stats": main_path_stats(dg, qv, s_q, t_q, launches, loop, (ids, d),
                                             1 + TIMED_BATCHES)})

    if args.profile:
        emit({"profile": profile_batch(
            lambda: execute_batch(dg, qv, s_q, t_q, k=K, beam=BEAM, plan="auto"),
            statistics.median(timed) * 1e3, out)})
    merges = merge_captures(lambda: execute_batch(dg, qv, s_q, t_q, k=K, beam=BEAM, plan="auto"),
                            dg.device().table.shape[0])
    RECORD["kernel_cases"] += merges["cases"]
    emit({"beam_merge_loop": {
        "launches": merges["launches"],
        "cases": [{k: c.get(k) for k in ("case", "L", "C", "finite_per_row", "kept_per_row_mean",
                                         "ms", "queued_ms", "fused_queued_ms", "bound_ms",
                                         "fused_bound_ms", "forms", "again")}
                  for c in merges["cases"]]}})
    if FORMS or MERGE_FORMS:
        emit({"main_path_ab": main_path_ab(
            lambda: execute_batch(dg, qv, s_q, t_q, k=K, beam=BEAM, plan="auto"), (ids, d))})

    # 7. unfused path
    path_launches = {"main": launches}
    path_launches["unfused"] = unfused_path(dg, qv, s_q, t_q)
    # 8. int32 path
    path_launches["int32"] = int32_path(dg, qv, s_q, t_q)
    # 9. distance matrices: exact (B5) and int8 (B6) scans of the corpus
    path_launches["distance_matrices"] = distance_matrix_path(
        dg, qv[:1024], s_q[:1024], t_q[:1024], vecs, s, t, gt["auto"])
    RECORD["launches_by_path"] = path_launches

    # 10. parity: the same queries on the CPU (plain versions) and the card
    sub = slice(0, PARITY_QUERIES)
    t0 = time.perf_counter()
    ids_c, d_c, pb_c = execute_batch(dg, qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM,
                                     plan="auto", return_plans=True, device="cpu")
    cpu_s = time.perf_counter() - t0
    ids_g, d_g, pb_g = execute_batch(dg, qv[sub], s_q[sub], t_q[sub], k=K, beam=BEAM,
                                     plan="auto", return_plans=True)
    require(np.array_equal(pb_c.plans, pb_g.plans), "plans differ between the CPU and the card")
    bad = mismatches(ids_c, d_c, ids_g, d_g)
    require(not bad, f"card vs CPU: {bad[:5]}")
    emit({"reduced": {"cpu_parity_queries": {"main": [128, PARITY_QUERIES],
                                             "stream": [64, STREAM_CPU_QUERIES],
                                             "serve": [64, SERVE_CPU_QUERIES]},
                      "why": "the card-against-CPU checks run the plain versions on the host "
                             "(about 0.7-1.2 s a query at d 768); the time went to the train "
                             "phase (17) within the run's time limit"}})
    emit({"parity": {
        "queries": PARITY_QUERIES, "cpu_s": cpu_s, "plans": {PLAN_NAMES[p]: int((pb_g.plans == p).sum()) for p in PLAN_NAMES},
        "ids_equal": bool(np.array_equal(ids_c, ids_g)),
        "max_abs_err": float(np.max(np.abs(np.where(np.isfinite(d_c), d_c - d_g, 0.0)))),
    }})
    # a beam wider than B2's registers hold (the wide search at 2 x 300)
    sub = slice(0, WIDE_BEAM_QUERIES)
    merges = ops.LAUNCHES["beam_merge"]
    t0 = time.perf_counter()
    ids_g, d_g = execute_batch(dg, qv[sub], s_q[sub], t_q[sub], k=K, beam=WIDE_BEAM)
    card_s = time.perf_counter() - t0
    merges = ops.LAUNCHES["beam_merge"] - merges
    t0 = time.perf_counter()
    ids_c, d_c = execute_batch(dg, qv[sub], s_q[sub], t_q[sub], k=K, beam=WIDE_BEAM, device="cpu")
    bad = mismatches(ids_c, d_c, ids_g, d_g)
    require(not bad, f"card vs CPU at beam {WIDE_BEAM}: {bad[:5]}")
    emit({"wide_beam_parity": {
        "queries": WIDE_BEAM_QUERIES, "beam": WIDE_BEAM, "b2_launches": merges,
        "card_s": round(card_s, 2), "cpu_s": round(time.perf_counter() - t0, 2),
        "ids_equal": bool(np.array_equal(ids_c, ids_g))}})

    # 11. streaming: the two-tier index, its WAL and recovery, at the shard's shape
    t0 = time.perf_counter()
    stream_launches, stream_idx, stream_q = stream_phase(n, ROOT / "build" / "stream_work")
    RECORD["stream_s"] = time.perf_counter() - t0
    RECORD["launches_by_path"]["stream"] = stream_launches

    # 12. serving: the sharded index through the launcher's loop, the streaming
    # server, the sharded streaming index
    t0 = time.perf_counter()
    serve_launches = serve_phase(n, vecs, s, t, qv, s_q, t_q, gt["auto"], stream_idx, stream_q, out)
    RECORD["serve_s"] = time.perf_counter() - t0
    RECORD["launches_by_path"]["serve"] = serve_launches
    del stream_idx

    # 13. the segmented tier: routed worklists over a flat segment stack, its
    # sharded form and the segmented streaming tier with its manifest
    t0 = time.perf_counter()
    seg_launches = segmented_phase(n, vecs, s, t, out)
    RECORD["segmented_s"] = time.perf_counter() - t0
    RECORD["launches_by_path"]["segmented"] = seg_launches

    # 14. fault injection: the chaos scenario on the card, and the full-width
    # step taken in phases 11 and 12 with its torn WAL tail recovered here
    t0 = time.perf_counter()
    fault_launches = fault_phase(stream_q)
    RECORD["fault_s"] = time.perf_counter() - t0
    RECORD["launches_by_path"]["fault"] = {"chaos": fault_launches,
                                           "full_width": FAULT["compaction"]["launches"]}

    # 15. the hybrid-search baselines beside the card's search
    t0 = time.perf_counter()
    RECORD["launches_by_path"]["baselines"] = baselines_phase(
        dg, vecs, s, t, (qv, s_q, t_q), (bq, bs, bt), {k: (gt[k], gt_dists[k]) for k in gt})
    RECORD["baselines_s"] = time.perf_counter() - t0

    # 16. the LM substrate's serving path, after the UDG phases' device state
    del dg, q_dev
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_launches = lm_phase(out)
    RECORD["lm_s"] = time.perf_counter() - t0
    RECORD["launches_by_path"]["lm"] = lm_launches

    # 17. training: llama3.2-1b's train step at full width, the remat
    # policies, card against CPU, the launcher's checkpoints and resume
    t0 = time.perf_counter()
    train_launches = train_phase(out)
    RECORD["train_s"] = time.perf_counter() - t0
    RECORD["launches_by_path"]["train"] = train_launches

    # 18. distributed training: the sharded step, the DP trainer with int8
    # compression, elastic restarts, in a one-rank process group
    t0 = time.perf_counter()
    dist_launches = distributed_phase(out)
    RECORD["distributed_s"] = time.perf_counter() - t0
    RECORD["launches_by_path"]["distributed"] = dist_launches

    # kernel -> (source, the TPU kernel's pallas_call, the path its launches count on)
    replaces = {
        "filter_dist_gather_packed": ("src/repro_torch/kernels/csrc/filter_dist.cu",
                                      "src/repro/kernels/filter_dist.py:404", "main"),
        "beam_merge": ("src/repro_torch/kernels/csrc/beam_merge.cu",
                       "src/repro/kernels/beam_merge.py:273", "main"),
        "filter_dist_gather": ("src/repro_torch/kernels/csrc/filter_dist.cu",
                               "src/repro/kernels/filter_dist.py:266", "main"),
        "filter_dist": ("src/repro_torch/kernels/csrc/filter_dist.cu",
                        "src/repro/kernels/filter_dist.py:104", "unfused"),
        "l2dist": ("src/repro_torch/kernels/csrc/l2dist.cu",
                   "src/repro/kernels/l2dist.py:72", "distance_matrices"),
        "int8_l2dist": ("src/repro_torch/kernels/csrc/l2dist.cu",
                        "src/repro/kernels/int8dist.py:72", "distance_matrices"),
    }
    table = []
    for name, (src, tpu, path) in replaces.items():
        r = rows[name]
        require(path_launches[path][name] > 0, f"kernel {name} never launched on the {path} path")
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": path_launches[path][name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "fraction_of_bound": r["bound_ms"] / r["ms"], "queued_ms": r["queued_ms"],
            "stream_launches": (stream_launches["unfused"][name] if name == "filter_dist" else
                                sum(stream_launches[p][name] for p in ("auto", "graph", "wide"))),
            "serve_launches": (serve_launches["unfused"][name] if name == "filter_dist" else
                               serve_launches["auto/all_gather"][name]),
            "segmented_launches": seg_launches["unfused" if name == "filter_dist" else "auto"][name],
            "fault_launches": {"chaos": fault_launches[name],
                               "full_width": FAULT["compaction"]["launches"][name]},
            "lm_launches": lm_launches[name],
            "train_launches": train_launches[name],
            "distributed_launches": dist_launches[name],
            "serve_data2_launches": serve_launches["auto/data2"][name],
            "ok": True,
        })
    RECORD["seconds"] = time.perf_counter() - t_all
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    print(f"total {RECORD['seconds']:.1f} s", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
