"""The JAX package's segmented index served through its sharded step, at the
sizes of ``test_torch_segmented.py``'s sharded case.

Run as a script in a fresh interpreter with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``); writes every
array the test compares into one ``.npz``:

    python tests/torch_segmented_ref.py OUT.npz

It builds ``build_segmented_index`` (four segments), stacks it with
``segments_to_sharded_index`` and serves the queries with ``serve_batch``
on a four-device mesh (``plan`` auto and graph, both merges, the jnp
oracles), then again with one segment quarantined. The segmented index's
arrays go into the file too, so the port searches the very same index
(``index_arrays`` / ``from_file``). Also imported by the tests for the
shared sizes and the carrying helpers.
"""
import sys

import numpy as np

N, D, NQ, K, BEAM = 1024, 8, 24, 10, 32
BUILD = dict(cells_per_axis=2, M=8, Z=32, K_p=4, quantize_int8=True)
RELATION = "overlap"
PLANNER = dict(brute_max_valid=32, wide_max_fraction=0.3)
MERGES = ("all_gather", "tournament")
QUARANTINED = 1
STACK_FIELDS = ("vectors", "nbr", "labels", "norms", "U_X", "U_Y", "num_y",
                "entry_node", "entry_y_rank")
GRAPH_FIELDS = ("vectors", "nbr", "labels", "plabels", "U_X", "U_Y", "entry_node",
                "entry_y_rank", "relation", "norms", "vec_q", "scales")
STATE_FIELDS = ("cum", "edges_x", "edges_y", "_ids", "_xr", "_yr", "_off",
                "n", "num_x", "num_y", "buckets")


def index_arrays(idx):
    """``(arrays, segments)`` of a JAX ``SegmentedIndex``, as
    ``repro_torch.scale.segmented_index_from_numpy`` takes them (numpy;
    fields a segment's export lacks are left out)."""
    arrays = {
        "relation": idx.relation.name, "vectors": np.asarray(idx.vectors),
        "node_capacity": idx.node_capacity, "edge_capacity": idx.edge_capacity,
        "quantized": idx.quantized, "packed": idx.packed,
        "edges_x": idx.grid.edges_x, "edges_y": idx.grid.edges_y,
        "vals_x": idx.grid.vals_x, "vals_y": idx.grid.vals_y,
        "X": idx.space.X, "Y": idx.space.Y, "U_X": idx.space.U_X, "U_Y": idx.space.U_Y,
    }
    segs = []
    for seg in idx.segments:
        sd = {f: getattr(seg.dg, f) for f in GRAPH_FIELDS}
        sd.update({f: getattr(seg.dg.planner, f) for f in STATE_FIELDS})
        sd = {f: np.asarray(v) for f, v in sd.items() if v is not None}
        sd.update(cell=seg.cell, ids=seg.ids)
        segs.append(sd)
    return arrays, segs


def to_file(out: dict, arrays: dict, segs: list) -> None:
    for f, v in arrays.items():
        out[f"index/{f}"] = np.asarray(v)
    out["index/segments"] = np.asarray(len(segs))
    for i, sd in enumerate(segs):
        for f, v in sd.items():
            out[f"seg{i}/{f}"] = np.asarray(v)


def from_file(z: dict):
    """Inverse of ``to_file``: ``(arrays, segments)``."""
    arrays = {k.split("/", 1)[1]: v for k, v in z.items() if k.startswith("index/")}
    segs = [{k.split("/", 1)[1]: v for k, v in z.items() if k.startswith(f"seg{i}/")}
            for i in range(int(arrays.pop("segments")))]
    return arrays, segs


def dataset():
    from repro.data import make_dataset

    return make_dataset(N, D, seed=0)


def queries(s, t):
    """NQ queries at three selectivities."""
    from repro.data import generate_queries, make_queries_vectors

    qv = make_queries_vectors(NQ, D, seed=1)
    s_q, t_q = np.empty(NQ), np.empty(NQ)
    for j, sel in enumerate((0.02, 0.2, 0.6)):
        idx = np.arange(j, NQ, 3)
        part = generate_queries(qv[idx], s, t, RELATION, sel, k=K, seed=j)
        s_q[idx], t_q[idx] = part.s_q, part.t_q
    return qv, s_q, t_q


def main(out_path):
    from repro.exec import PlannerConfig
    from repro.launch.mesh import make_host_mesh
    from repro.scale import build_segmented_index
    from repro.serve.distributed import segments_to_sharded_index, serve_batch

    cfg = PlannerConfig(**PLANNER)
    vecs, s, t = dataset()
    idx = build_segmented_index(vecs, s, t, RELATION, **BUILD)
    out = {}
    to_file(out, *index_arrays(idx))
    qv, s_q, t_q = queries(s, t)
    for case in ("all", "quarantined"):
        if case == "quarantined":
            idx.quarantine_segment(QUARANTINED)
        sh, id_map = segments_to_sharded_index(idx)
        mesh = make_host_mesh(model_parallel=sh.num_shards)
        p = case + "/"
        for f in STACK_FIELDS:
            out[p + f] = np.asarray(getattr(sh, f))
        out[p + "id_map"] = id_map
        for plan in ("auto", "graph"):
            for merge in MERGES:
                ids, d = serve_batch(sh, mesh, qv, s_q, t_q, k=K, beam=BEAM, merge=merge,
                                     plan=plan, planner_config=cfg, id_map=id_map)
                out[p + f"{plan}/{merge}/ids"], out[p + f"{plan}/{merge}/d"] = ids, d
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
