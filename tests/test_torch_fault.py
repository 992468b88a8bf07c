"""The port's fault injection and chaos scenario against the JAX package's.

* ``FaultInjector``: the same seed and visits fire the same faults in both
  packages (``fired``, raised visits, delays), the counter renders to the
  same Prometheus text, and ``wrap`` / ``wrap_method`` / ``injected`` undo
  their patch;
* the corruption helpers leave byte-equal files, and ``poison_vector``
  gives equal arrays with the same non-finite position;
* twins of ``tests/test_fault.py``'s injector-driven tests on the port
  (``device="cpu"``): compaction failures back off and recover,
  ``join_compaction`` raises the port's ``InjectedFault``, poison is
  rejected before any search;
* ``run_chaos(seed, tiny=True, device="cpu")`` is ok for seeds 0-4, and
  every field that is a function of the seed equals the JAX package's
  (wall-clock fields are not compared); the CLI exits 0; with no device it
  asks for the card.

One departure (ROADMAP C3): where the corrupt-snapshot point draws a
victim whose WAL history is whole, the reference still expects a
quarantine and reports ``ok`` false; the port expects the recovery from
the log that both packages perform, so only that run's verdict differs.
"""
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.fault as jf
import repro.fault.chaos as jchaos
import repro_torch.fault as tf
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs.export import to_prometheus_text as jax_prometheus
from repro_torch.fault.chaos import run_chaos
from repro_torch.kernels import ops
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.export import to_prometheus_text
from repro_torch.serve.batching import StreamingServer
from repro_torch.stream import CompactionPolicy, StreamingIndex
from torch_cases import K  # noqa: F401  (pins torch to one thread)

SRC = Path(__file__).resolve().parents[1] / "src"
SEEDS = range(5)
WALL_CLOCK = ("backoff_waits", "recovery_seconds")


def _schedule(mod, registry, seed):
    """Drive one injector over a fixed visit sequence; returns what fired,
    which visits raised and the delays asked for."""
    slept = []
    inj = mod.FaultInjector(seed, registry=registry, sleep=slept.append)
    inj.add("wal.append", mod.FaultSpec("error", probability=0.3))
    inj.add("wal.append", mod.FaultSpec("delay", probability=0.5, delay_s=0.25))
    inj.add("compaction.build", mod.FaultSpec("error", max_hits=2))
    inj.add("serve.step", mod.FaultSpec("delay", probability=0.3, delay_s=0.01, max_hits=4))
    inj.add("serve.step", mod.FaultSpec("error", probability=0.2))
    raised = []
    points = ("wal.append", "compaction.build", "serve.step", "never.configured")
    for i in range(120):
        point = points[(i * 7 + i // 3) % len(points)]
        try:
            inj.on(point)
        except mod.InjectedFault as exc:
            raised.append((exc.point, exc.visit))
    return inj.fired, raised, slept


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_injector_schedules_equal_the_reference(seed):
    jreg, treg = JaxRegistry(), MetricsRegistry()
    want = _schedule(jf, jreg, seed)
    got = _schedule(tf, treg, seed)
    assert got == want
    assert any(k == "error" for _, k, _ in got[0]) and got[2]
    assert to_prometheus_text(treg) == jax_prometheus(jreg)
    assert "repro_faults_injected_total" in to_prometheus_text(treg)


def test_fault_spec_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="unknown fault kind"):
        tf.FaultSpec("crash")


def test_wrap_and_injected_undo_the_patch():
    class Box:
        def value(self, x):
            return x + 1

    box = Box()
    inj = tf.FaultInjector(0)
    inj.add("box", tf.FaultSpec("error", max_hits=1))
    guarded = inj.wrap("box", box.value)
    assert guarded.__name__ == "value"
    with pytest.raises(tf.InjectedFault) as info:
        guarded(1)
    assert (info.value.point, info.value.visit) == ("box", 0)
    assert guarded(1) == 2                      # healed after max_hits

    def unpatched():            # the method again, not a guard around it
        return getattr(box.value, "__func__", None) is Box.value

    undo = inj.wrap_method(box, "value", "box")
    assert not unpatched() and box.value(2) == 3
    undo()
    assert unpatched() and box.value(2) == 3
    inj.add("box2", tf.FaultSpec("error"))
    with inj.injected(box, "value", "box2"):
        with pytest.raises(tf.InjectedFault):
            box.value(0)
    assert unpatched()
    with pytest.raises(RuntimeError, match="inside"):
        with inj.injected(box, "value", "box"):
            raise RuntimeError("inside")
    assert unpatched()
    assert inj.fired == [("box", "error", 0), ("box2", "error", 0)]
    assert inj._visits == {"box": 3, "box2": 1}


@pytest.mark.parametrize("offset", [0, 17, -1, -300, 4095, 10_000])
def test_corrupt_byte_and_truncate_file_match(tmp_path, offset):
    payload = np.random.default_rng(5).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    files = []
    for name, mod in (("jax", jf), ("port", tf)):
        path = tmp_path / f"{name}.log"
        path.write_bytes(payload)
        off = mod.corrupt_byte(str(path), offset, xor=0x5A)
        keep = mod.truncate_file(str(path), 4096 + offset if offset < 0 else offset)
        files.append((path.read_bytes(), off, keep))
    assert files[0] == files[1]
    assert files[1][0] != payload[: files[1][2]] or files[1][1] >= files[1][2]
    empty = tmp_path / "empty.log"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        tf.corrupt_byte(str(empty), 0)


@pytest.mark.parametrize("kind", ["nan", "inf", "-inf"])
def test_poison_vector_matches(kind):
    for seed in SEEDS:
        got = tf.poison_vector(768, kind=kind, seed=seed)
        want = jf.poison_vector(768, kind=kind, seed=seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        assert np.flatnonzero(~np.isfinite(got)).size == 1
        np.testing.assert_array_equal(got, want)


# --- twins of tests/test_fault.py's injector-driven tests, on the port -------


def _index(seed):
    rng = np.random.default_rng(seed)
    idx = StreamingIndex(
        8, "containment", node_capacity=256, delta_capacity=64, edge_capacity=16,
        policy=CompactionPolicy(max_delta_fraction=0.02, min_mutations=8), device="cpu",
    )
    for _ in range(32):
        s, t = np.sort(rng.uniform(0, 100, 2))
        idx.insert(rng.standard_normal(8).astype(np.float32), float(s), float(t))
    return idx


def test_compaction_failure_backs_off_and_recovers():
    idx = _index(0)
    srv = StreamingServer(idx, batch_size=4, k=5, timeout_s=0.0, compaction_backoff_s=0.005)
    epoch0 = idx.epoch
    q = np.random.default_rng(9).standard_normal(8).astype(np.float32)
    before = idx.search(q, 20.0, 80.0, k=5)
    inj = tf.FaultInjector(0)
    inj.add("build", tf.FaultSpec("error", max_hits=1))
    with inj.injected(idx, "build_epoch", "build"):
        assert srv.maybe_compact_async()
        srv._worker.join()
        assert not srv.maybe_compact_async()    # the failure reaped: backoff
        assert isinstance(srv.last_compaction_error, tf.InjectedFault)
        assert idx.epoch == epoch0, "a failed build must not swap the epoch"
        mid = idx.search(q, 20.0, 80.0, k=5)
        np.testing.assert_array_equal(mid[0], before[0])
        np.testing.assert_array_equal(mid[1], before[1])
        deadline = time.monotonic() + 15.0
        while idx.epoch == epoch0 and time.monotonic() < deadline:
            if srv.maybe_compact_async() and srv._worker is not None:
                srv._worker.join()
                srv.maybe_compact_async()
            time.sleep(0.002)
    assert idx.epoch > epoch0
    assert srv._fail_count == 0 and srv.last_compaction_error is None
    assert inj.fired == [("build", "error", 0)]


def test_join_compaction_raises_the_ports_injected_fault():
    idx = _index(1)
    srv = StreamingServer(idx, batch_size=4, k=5)
    inj = tf.FaultInjector(0)
    inj.add("build", tf.FaultSpec("error"))
    with inj.injected(idx, "build_epoch", "build"):
        assert srv.maybe_compact_async()
        with pytest.raises(tf.InjectedFault):
            srv.join_compaction()
    assert not isinstance(tf.InjectedFault("p", 0), jf.InjectedFault)


def test_poison_rejected_before_any_search():
    idx = _index(2)
    srv = StreamingServer(idx, batch_size=4, k=5)
    rng = np.random.default_rng(2)
    launches = dict(ops.LAUNCHES)
    searches = []
    search = idx.search
    idx.search = lambda *a, **kw: searches.append(a) or search(*a, **kw)
    try:
        for kind in ("nan", "inf", "-inf"):
            with pytest.raises(ValueError, match="non-finite"):
                srv.submit(tf.poison_vector(8, kind=kind), 10.0, 90.0)
        good = rng.standard_normal(8).astype(np.float32)
        for s_q, t_q in ((float("nan"), 90.0), (10.0, float("inf"))):
            with pytest.raises(ValueError, match="non-finite"):
                srv.submit(good, s_q, t_q)
        assert srv.batcher.pending == 0 and not searches
        assert dict(ops.LAUNCHES) == launches
        rid = srv.submit(good, 10.0, 90.0)
        assert rid in srv.step(force=True) and len(searches) == 1
    finally:
        del idx.search


# --- the chaos scenario --------------------------------------------------------


def _seeded_fields(summary):
    """The summary without its verdicts and wall-clock fields."""
    out = copy.deepcopy(summary)
    out.pop("device", None)
    out.pop("ok")
    for phase in ("compaction", "poison", "overload", "crash_recovery", "segmented"):
        out[phase].pop("ok")
        for key in WALL_CLOCK:
            out[phase].pop(key, None)
    for run in out["segmented"]["runs"]:
        run.pop("ok")
        run.pop("history_whole", None)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_run_chaos_equals_the_reference(seed):
    got = run_chaos(seed, tiny=True, device="cpu")
    want = jchaos.run_chaos(seed, tiny=True)
    assert got["ok"], json.dumps(got, default=str)
    assert got["device"] == "cpu"
    assert _seeded_fields(got) == _seeded_fields(want)
    assert got["faults_fired"] == 4
    for phase in ("compaction", "poison", "overload", "crash_recovery"):
        assert want[phase]["ok"] and got[phase]["ok"]
    for mine, ref in zip(got["segmented"]["runs"], want["segmented"]["runs"]):
        # C3: the reference expects a quarantine even where the victim's
        # WAL history is whole, and fails that run
        assert mine["ok"] and ref["ok"] == (not mine.get("history_whole", False))


def test_chaos_cli_exits_zero(tmp_path):
    out = tmp_path / "chaos.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.fault.chaos", "--tiny", "--seed", "0",
         "--device", "cpu", "--json", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(out.read_text())
    assert summary["ok"] and summary["device"] == "cpu" and summary["seed"] == 0
    assert json.loads(proc.stdout) == summary


def test_run_chaos_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_chaos(0)
