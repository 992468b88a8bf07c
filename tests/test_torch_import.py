"""``import repro_torch`` loads neither jax nor any module of the JAX package.

Checked in a fresh interpreter: this test process has imported jax already.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device

SRC = Path(__file__).resolve().parents[1] / "src"
PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, capture_output=True,
                         text=True, check=True).stdout.split()
    assert int(out[0]) >= 81                       # every submodule was imported
    assert len(out) == 1, f"loaded: {out[1]}"


OBS_STREAM = """
import sys
import repro_torch.obs, repro_torch.stream
from repro_torch.obs import SearchStats, record_search_stats, trace_span
from repro_torch.stream import StreamingIndex, WriteAheadLog, recover
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(bad) or "none")
"""


def test_obs_and_stream_import_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", OBS_STREAM], env=env, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["none"], f"loaded: {out}"


SERVE = """
import sys
import repro_torch.serve, repro_torch.distributed, repro_torch.launch.serve
from repro_torch.serve import (StreamingServer, build_sharded_index, remap_shard_ids,
                               segments_to_sharded_index, serve_batch,
                               serve_streaming_batch, sharded_index_from_numpy)
from repro_torch.distributed import ShardMesh, make_host_mesh, make_process_mesh
from repro_torch.launch.serve import main, serve_requests
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(bad) or "none")
"""


def test_serve_distributed_and_launcher_import_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", SERVE], env=env, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["none"], f"loaded: {out}"


SCALE = """
import sys
import repro_torch.scale
from repro_torch.scale import (SegmentedIndex, SegmentedStreamingIndex, build_segmented_index,
                               recover_segmented, segmented_index_from_numpy)
from repro_torch.search import SegmentStack
from repro_torch.exec import worklist_exec_core
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(bad) or "none")
"""


def test_scale_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", SCALE], env=env, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["none"], f"loaded: {out}"


FAULT_BASELINES = """
import sys
import repro_torch.fault, repro_torch.fault.chaos, repro_torch.baselines
from repro_torch.fault import FaultInjector, FaultSpec, InjectedFault, poison_vector
from repro_torch.fault.chaos import main, run_chaos
from repro_torch.baselines import Acorn, HiPNG, PostFilterHNSW, PreFilter, build_knn_graph
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(bad) or "none")
"""


def test_fault_and_baselines_import_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", FAULT_BASELINES], env=env, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["none"], f"loaded: {out}"


MODELS = """
import sys
import repro_torch.models, repro_torch.configs
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import (decode_step, forward, init_decode_state, init_params,
                                params_from_numpy, prefill_step)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(bad) or "none")
"""


def test_models_and_configs_import_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", MODELS], env=env, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["none"], f"loaded: {out}"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


TRAIN = """
import sys
import repro_torch.train, repro_torch.launch.train, repro_torch.launch.mesh
from repro_torch.train import CheckpointManager, adamw, cosine_lr, load_checkpoint, save_checkpoint
from repro_torch.train.optimizer import AdamWState
from repro_torch.launch.train import main, synthetic_batch
from repro_torch.launch.mesh import data_axes, make_host_mesh, make_production_mesh, mesh_axis_names
from repro_torch.models import loss_fn, make_train_step, params_to_numpy, softmax_xent
import torch
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(bad) or "none", torch.cuda.is_initialized(),
      torch.distributed.is_available() and torch.distributed.is_initialized())
"""


def test_train_and_launchers_import_no_jax_and_touch_no_device():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", TRAIN], env=env, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["none", "False", "False"], f"loaded: {out}"


DISTRIBUTED_TRAINING = """
import sys
import repro_torch.distributed, repro_torch.launch.dryrun
from repro_torch.distributed import comm, compat, compression, elastic, fsdp, sharding
from repro_torch.distributed.compat import abstract_mesh
from repro_torch.distributed.elastic import ElasticRunner, remesh
from repro_torch.distributed.fsdp import make_sharded_train_step
from repro_torch.train.dp_trainer import make_dp_train_step
from repro_torch.launch import dryrun, hlo, inspect_cell, report, roofline
import torch
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(bad) or "none", torch.cuda.is_initialized(), torch.distributed.is_initialized())
"""


def test_distributed_training_and_dryrun_import_no_jax_and_touch_no_device():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", DISTRIBUTED_TRAINING], env=env,
                         capture_output=True, text=True, check=True).stdout.split()
    assert out == ["none", "False", "False"], f"loaded: {out}"
