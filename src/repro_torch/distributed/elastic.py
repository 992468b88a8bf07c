"""Elastic scaling + failure recovery for the training loop (the JAX
package's ``distributed/elastic.py``).

Policy (mirrors what a fleet controller does at 1000-node scale):
  * training state is periodically checkpointed (atomic, hash-verified —
    ``repro_torch.train.checkpoint``), unsharded: the slices are gathered
    (``all_gather`` over each leaf's axes), the mesh's first rank saves and
    the others wait at a barrier;
  * on a node failure the job restarts on the surviving capacity: the
    checkpoint is loaded into a host copy of the state (in place, as
    ``CheckpointManager.restore_latest`` does) and re-placed onto a NEW
    mesh built from the healthy ranks;
  * batch is re-split over the new data-parallel degree, keeping the GLOBAL
    batch constant (per-rank batch grows) so optimization is unaffected;
  * when capacity returns, the same mechanism scales back up.

``make_mesh(n)`` builds a mesh over the first n ranks of the process group
(``distributed.mesh.make_train_mesh(ranks=range(n))``). Every rank calls it
at every (re)start, in the same order, since each creates every group;
a rank outside the new mesh takes no further step and ``run`` returns
``None`` for its state.

``remesh`` performs the re-placement; ``ElasticRunner`` drives a restart
loop with injected failures for testing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro_torch.distributed.fsdp import gather
from repro_torch.distributed.sharding import local_shard
from repro_torch.train.checkpoint import CheckpointManager


def remesh(tree, specs, mesh):
    """This rank's slices of an unsharded (host) tree under ``specs``, on
    the mesh's device."""
    return tree_map(lambda x, s: local_shard(torch.as_tensor(x), s, mesh, mesh.coord)
                    .to(mesh.device, copy=True).contiguous(), tree, specs)


def unshard(tree, specs, mesh):
    """The whole tensors of a sliced tree, on the host (every rank of the
    mesh gathers them)."""
    with torch.no_grad():
        return tree_map(lambda x, s: gather(x.detach(), s, mesh, "checkpoint").cpu(), tree, specs)


@dataclasses.dataclass
class ElasticRunner:
    """Checkpoint-restart training loop with failure injection hooks.

    make_mesh(n_ranks) -> mesh;  make_step(mesh) -> step;
    state_specs(mesh) -> spec tree for the train state.
    """

    ckpt: CheckpointManager
    make_mesh: Callable[[int], object]
    make_step: Callable[[object], Callable]
    state_specs: Callable[[object], object]
    ckpt_every: int = 10

    def _save(self, step: int, state, specs, mesh) -> None:
        whole = unshard(state, specs, mesh)
        if dist.get_rank() == mesh.ranks[0]:
            self.ckpt.save(step, whole)
            self.ckpt.wait()
        dist.barrier(group=mesh.group(mesh.axis_names))

    def run(
        self,
        state,
        batches,
        *,
        n_devices: int,
        fail_at: Optional[int] = None,
        recover_devices: Optional[int] = None,
        start_step: int = 0,
    ):
        """Run until batches are exhausted; simulate one failure at
        ``fail_at`` (restart on ``recover_devices`` ranks). ``state`` is
        the unsharded host tree. Returns (state, steps_run, restarts), the
        state this rank's slices (``None`` on a rank left out of the
        mesh)."""
        template = tree_map(lambda x: torch.as_tensor(x).detach().cpu().clone(), state)
        mesh = self.make_mesh(n_devices)
        if not mesh.member:
            return None, start_step, 0
        specs = self.state_specs(mesh)
        step_fn = self.make_step(mesh)
        state = remesh(state, specs, mesh)
        restarts = 0
        step = start_step
        i = 0
        while i < len(batches):
            if fail_at is not None and step == fail_at and restarts == 0:
                # --- simulated node failure: lose the in-memory state -----
                restarts += 1
                n_new = recover_devices or n_devices
                mesh = self.make_mesh(n_new)
                if not mesh.member:
                    return None, step, restarts
                specs = self.state_specs(mesh)
                step_fn = self.make_step(mesh)
                host_state, step, _ = self.ckpt.restore_latest(template)
                state = remesh(host_state, specs, mesh)
                i = step - start_step  # replay data from the checkpoint
                continue
            state = step_fn(state, batches[i])
            step += 1
            i += 1
            if step % self.ckpt_every == 0:
                self._save(step, state, specs, mesh)
        self._save(step, state, specs, mesh)
        return state, step, restarts
