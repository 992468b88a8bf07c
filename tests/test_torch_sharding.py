"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, on the abstract production meshes.

For every architecture and both production meshes (data 16 x model 16,
pod 2 x data 16 x model 16):

* every parameter's spec is the reference's spec of the same leaf with the
  leading entries of its stack dims dropped (the port's layers are
  unstacked: ``layers.3.attn.wq`` is row 3 of ``layers/attn/wq``), and the
  optimizer's mirror them; every assigned axis divides its dim (the twin of
  ``tests/test_sharding_specs.py``);
* the decode state's specs at ``decode_32k`` and ``long_500k`` equal the
  reference's (stacked alike) and divide their dims, skipping the same
  ``long_500k`` cases;
* ``batch_spec`` and ``logits_spec`` equal the reference's at the
  reference test's shapes;
* the mesh forms the rules read (``MeshSpec``, ``ShardMesh``, a torch
  ``DeviceMesh`` on a fake process group, in a subprocess) give the same
  sizes.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from repro.configs import ARCH_NAMES, SHAPES, get_config as ref_get_config, shape_supported
from repro.distributed import sharding as ref_sharding
from repro.distributed.compat import abstract_mesh as ref_abstract_mesh
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_params_shapes as ref_init_params_shapes
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.compat import abstract_mesh
from repro_torch.distributed.mesh import make_host_mesh
from repro_torch.models import init_decode_state, init_params_shapes
from repro_torch.models.convert import stack_index
from repro_torch.train import adamw

REPO = Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def _full(spec, ndim):
    entries = tuple(spec)
    return entries + (None,) * (ndim - len(entries))


def _ref_tree(specs, tree):
    """'a/b/c' -> (spec entries padded to the leaf's ndim) of a reference tree."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return {"/".join(str(getattr(k, "key", k)) for k in path): _full(s, len(leaf.shape))
            for (path, leaf), s in zip(leaves, spec_leaves)}


def _divides(shape, spec, mesh, what):
    for dim, axes in zip(shape, tuple(spec)):
        size = sh._axis_size(mesh, axes)
        assert dim % size == 0, f"{what}: dim {dim} not divisible by {axes} (={size})"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_opt_specs_equal_the_references(arch, mesh_name):
    shape = MESHES[mesh_name]
    ref_params = ref_init_params_shapes(ref_get_config(arch))
    want = _ref_tree(ref_sharding.param_specs(ref_params, ref_get_config(arch),
                                              ref_abstract_mesh(shape)), ref_params)
    mesh = abstract_mesh(shape)
    model = init_params_shapes(get_config(arch))
    got = sh.param_specs(model, get_config(arch), mesh)
    named = dict(model.named_parameters())
    assert list(got) == list(named)
    keys = set()
    for name, spec in got.items():
        path, idx = stack_index(name)
        key = "/".join(path)
        keys.add(key)
        assert isinstance(spec, sh.PartitionSpec) and len(spec) <= named[name].dim(), name
        assert _full(spec, named[name].dim()) == want[key][len(idx):], (name, spec, want[key])
        _divides(named[name].shape, spec, mesh, f"{arch} {name}")
    assert keys == set(want)
    opt = adamw()
    state = opt.init(init_params_shapes(get_config("llama3.2-1b", smoke=True)))
    ospecs = sh.opt_state_specs(state, got)
    assert ospecs.step == sh.P() and ospecs.mu is got and ospecs.nu is got and ospecs.master is got


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_equal_the_references(arch, mesh_name, shape_name):
    ref_cfg = ref_get_config(arch)
    ok, _ = shape_supported(ref_cfg, shape_name)
    if not ok:
        pytest.skip("long_500k rule")
    s = SHAPES[shape_name]
    ref_cache = jax.eval_shape(lambda: ref_init_decode_state(ref_cfg, s.global_batch, s.seq_len))
    want = _ref_tree(ref_sharding.cache_specs(ref_cache, ref_cfg, ref_abstract_mesh(MESHES[mesh_name])),
                     ref_cache)
    cfg = get_config(arch)
    mesh = abstract_mesh(MESHES[mesh_name])
    cache = init_decode_state(cfg, s.global_batch, s.seq_len, device="meta")
    got = sh.cache_specs(cache, cfg, mesh)

    def walk(tree, specs, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, specs[k], prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), v, specs[k]

    seen = set()
    for key, leaf, spec in walk(cache, got):
        seen.add(key)
        assert _full(spec, leaf.dim()) == want[key], (key, spec, want[key])
        _divides(leaf.shape, spec, mesh, f"{arch} {shape_name} {key}")
    assert seen == set(want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_logits_specs(mesh_name):
    mesh, ref_mesh = abstract_mesh(MESHES[mesh_name]), ref_abstract_mesh(MESHES[mesh_name])
    for b in (1, 32, 128, 256):
        spec = sh.batch_spec(mesh, (b, 4096))
        assert b % sh._axis_size(mesh, tuple(spec)[0]) == 0
        assert tuple(spec) == tuple(ref_sharding.batch_spec(ref_mesh, (b, 4096)))
    for b, v in ((1, 256000), (128, 2048), (32, 262144)):
        spec = sh.logits_spec(mesh, (b, v))
        assert b % sh._axis_size(mesh, tuple(spec)[0]) == 0
        assert v % sh._axis_size(mesh, tuple(spec)[-1]) == 0
        assert tuple(spec) == tuple(ref_sharding.logits_spec(ref_mesh, (b, v)))


DEVICE_MESH = """
import sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import sharding as sh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
mesh = init_device_mesh("cpu", (2, 16, 16), mesh_dim_names=("pod", "data", "model"))
print(sh.mesh_sizes(mesh), sh._fsdp(mesh), sh._axis_size(mesh, ("pod", "data")),
      tuple(sh.batch_spec(mesh, (64, 8))))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
dist.destroy_process_group()
"""


def test_every_mesh_form_gives_the_same_sizes():
    spec = abstract_mesh({"pod": 2, "data": 16, "model": 16})
    assert sh.mesh_sizes(spec) == {"pod": 2, "data": 16, "model": 16}
    host = make_host_mesh(16, data=16, pod=2, device="cpu")
    assert sh.mesh_sizes(host) == sh.mesh_sizes(spec)
    ref_mesh = ref_abstract_mesh({"pod": 2, "data": 16, "model": 16})
    assert {n: ref_mesh.shape[n] for n in ref_mesh.axis_names} == sh.mesh_sizes(spec)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", DEVICE_MESH], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "{'pod': 2, 'data': 16, 'model': 16} ('pod', 'data') 32 (('pod', 'data'), None)"
    assert lines[1] == "[]"
