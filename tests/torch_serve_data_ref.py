"""The JAX package's sharded serving at data 2 x model 2, for ``test_torch_serve_data.py``.

Run as a script in a fresh interpreter with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``): the reference's
``make_host_mesh(model_parallel=2)`` is then a (data 2, model 2) mesh, and
``shard_map`` splits each batch over ``data``. Serves ``torch_serve_ref.py``'s
(containment, 2 shards) case with ``plan`` auto and graph and both merges
and writes the index, its planners and the answers into one ``.npz``:

    python tests/torch_serve_data_ref.py OUT.npz
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_serve_ref as case  # noqa: E402

REL, S = "containment", 2


def main(out_path):
    from repro.exec import PlannerConfig
    from repro.launch.mesh import data_axes, make_host_mesh
    from repro.serve import build_sharded_index, serve_batch

    vecs, s, t = case.dataset()
    idx = build_sharded_index(vecs, s, t, REL, S, M=8, Z=32)
    mesh = make_host_mesh(model_parallel=S)
    out = {"mesh/shape": np.asarray(mesh.devices.shape),
           "mesh/axes": np.asarray(mesh.axis_names), "mesh/data_axes": np.asarray(data_axes(mesh))}
    for f in case.STACK_FIELDS:
        out[f] = np.asarray(getattr(idx, f))
    out["n_local"] = np.asarray(idx.n_local)
    for sh, est in enumerate(idx.planners):
        for f in case.STATE_FIELDS:
            out[f"planner{sh}/{f}"] = np.asarray(getattr(est, f))
    qv, s_q, t_q = case.queries(s, t, REL)
    cfg = PlannerConfig(**case.PLANNER)
    for plan in ("auto", "graph"):
        for merge in case.MERGES:
            ids, d = serve_batch(idx, mesh, qv, s_q, t_q, k=case.K, beam=case.BEAM, merge=merge,
                                 plan=plan, planner_config=cfg)
            out[f"{plan}/{merge}/ids"], out[f"{plan}/{merge}/d"] = ids, d
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
