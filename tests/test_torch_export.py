"""The port's host constructor and device export against the JAX package's.

Per relation, at n=600 and d=16: the port's ``build_index(batched=False)``
gives the reference's adjacency tuples, its export (with the planner the
exec layer attaches) equals the reference's array by array (ints bit-equal,
norms within 1e-6), and ``planned_graph_from_numpy`` reproduces the port's
own export.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.search as jsearch
import repro_torch.core as tcore
from repro.core.predicates import RELATIONS
from repro.data import make_dataset
from repro_torch.exec import export_planned_graph, planned_graph_from_numpy
from repro_torch.exec.estimator import STATE_FIELDS
from repro_torch.search import export_device_graph
from repro_torch.search.device_graph import GRAPH_FIELDS

N, D = 600, 16
INT_FIELDS = ("nbr", "plabels", "labels", "entry_node", "entry_y_rank", "vec_q")
EXACT_FIELDS = ("vectors", "U_X", "U_Y", "scales")
PLANNER_FIELDS = ("cum", "edges_x", "edges_y", "_ids", "_xr", "_yr", "_off")


@pytest.fixture(scope="module", params=sorted(RELATIONS))
def built(request):
    rel = request.param
    dist = "uncapped" if rel == "query_within_data" else "uniform"
    vecs, s, t = make_dataset(N, D, distribution=dist, seed=0)
    jg, jet, _ = jcore.build_index(vecs, s, t, rel, batched=False)
    tg, tet, _ = tcore.build_index(vecs, s, t, rel, batched=False)
    return rel, (jg, jet), (tg, tet)


def test_build_gives_the_reference_adjacency(built):
    _, (jg, _), (tg, _) = built
    assert tg.n == jg.n and tg.num_tuples == jg.num_tuples
    assert tg.num_patch_tuples == jg.num_patch_tuples
    for u in range(jg.n):
        for a, b in zip(jg.tuples(u), tg.tuples(u)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantize", [False, True])
def test_export_equals_reference_array_by_array(built, quantize):
    _, (jg, jet), (tg, tet) = built
    jdg = jsearch.export_device_graph(jg, jet, quantize_int8=quantize)
    tdg = export_planned_graph(tg, tet, quantize_int8=quantize, device="cpu")
    assert tdg.relation == jdg.relation and tdg.max_degree == jdg.max_degree
    for f in INT_FIELDS + EXACT_FIELDS:
        a, b = getattr(jdg, f), getattr(tdg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_allclose(tdg.norms, jdg.norms, rtol=1e-6, atol=1e-6)
    for f in PLANNER_FIELDS:
        np.testing.assert_array_equal(getattr(tdg.planner, f), getattr(jdg.planner, f))
    assert tdg.nbytes_by_component() == jdg.nbytes_by_component()
    np.testing.assert_array_equal(tdg.labels_i32(), jdg.labels_i32())


@pytest.mark.parametrize("quantize", [False, True])
def test_device_graph_from_numpy_reproduces_the_export(built, quantize):
    _, _, (tg, tet) = built
    tdg = export_planned_graph(tg, tet, quantize_int8=quantize, device="cpu")
    arrays = {f: getattr(tdg, f) for f in GRAPH_FIELDS}
    arrays.update({f: getattr(tdg.planner, f) for f in STATE_FIELDS})
    back = planned_graph_from_numpy(arrays, device="cpu")
    for f in GRAPH_FIELDS:
        a, b = getattr(tdg, f), getattr(back, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    for f in PLANNER_FIELDS:
        np.testing.assert_array_equal(getattr(back.planner, f), getattr(tdg.planner, f))
    lo, hi = tdg.planner.count_bounds(np.arange(40), np.arange(40))
    np.testing.assert_array_equal(back.planner.count_bounds(np.arange(40), np.arange(40))[0], lo)
    np.testing.assert_array_equal(back.planner.exact_valid_ids(3, 500),
                                  tdg.planner.exact_valid_ids(3, 500))
    dev, ref = back.device("cpu"), tdg.device("cpu")
    assert back.device("cpu") is dev                        # memoized per device
    for f in ("table", "scales", "norms", "nbr", "labels"):
        a, b = getattr(dev, f), getattr(ref, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), f
    assert dev.packed and dev.labels.dtype == torch.int32   # uint32 words as int32


def test_forced_int32_layout_is_exported_not_searched(built):
    """A forced int32 export carries no packed words and serves its int32
    rectangles to every branch; a packed export serves its words to the
    fused search and the memoized int32 view to ``fused=False``."""
    _, _, (tg, tet) = built
    tdg = export_device_graph(tg, tet, packed_labels=False, device="cpu")
    assert tdg.plabels is None and tdg.labels_i32() is tdg.labels
    assert tdg.planner is None                  # the search layer builds none
    for fused in (True, False):
        lab = tdg.serving_labels(fused=fused, device="cpu")
        assert lab is tdg.device("cpu").labels and lab.shape[-1] == 4
    pdg = export_device_graph(tg, tet, device="cpu")
    assert pdg.serving_labels(device="cpu") is pdg.device("cpu").labels
    i32 = pdg.serving_labels(fused=False, device="cpu")
    assert i32 is pdg.serving_labels(fused=False, device="cpu")   # memoized
    np.testing.assert_array_equal(i32.numpy(), tdg.labels)


def test_batched_constructor_is_not_ported():
    """``batched=True`` builds in waves on the device it is given, and
    ``device=None`` means the card."""
    vecs, s, t = make_dataset(40, 4, seed=0)
    g, rep = tcore.build_udg(vecs, s, t, "containment", M=4, Z=8, batched=True,
                             wave=16, device="cpu")
    assert rep.waves == 3 and rep.broad_searches == 2 and g.num_tuples > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcore.build_udg(vecs, s, t, "containment", batched=True)
