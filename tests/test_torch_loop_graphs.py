"""The search loop's CUDA graphs (``repro_torch.search.batched``:
``GraphCache``, ``graph_key``, ``LoopGraphs``).

On the CPU: the cache's sightings and eviction with stub entries, and what
the key tells apart. On the card (marked ``card``, skipped without CUDA):
two batches through the replayed search at the bulk cell's shapes, bit-equal
to the eager loop and to the CPU's plain search, with the same kernel launch
and loop counts. This file imports no JAX, so on the card's machine, which
has none, it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m card tests/test_torch_loop_graphs.py
"""
import threading

import numpy as np
import pytest
import torch

import repro_torch.obs.trace as trace
from repro_torch.kernels import _build, ops
from repro_torch.search import batched
from repro_torch.search.batched import GraphCache, graph_key, prepare_states, search_core


class Stub:
    """An entry as the cache sees one: a key and a lock."""

    def __init__(self, key):
        self.key = key
        self.lock = threading.Lock()


def maker(made: list, key):
    def make():
        made.append(key)
        return Stub(key)
    return make


def take(cache, key, made):
    """Take ``key`` and give it straight back; returns the entry or None."""
    entry = cache.take(key, maker(made, key))
    if entry is not None:
        entry.lock.release()
    return entry


def test_a_key_gets_its_entry_on_its_second_sighting():
    cache, made = GraphCache(size=2), []
    assert cache.take("a", maker(made, "a")) is None and made == []
    entry = cache.take("a", maker(made, "a"))
    assert entry.key == "a" and made == ["a"] and entry.lock.locked()
    # held by one call: another runs eagerly, and nothing is made again
    assert cache.take("a", maker(made, "a")) is None
    entry.lock.release()
    assert take(cache, "a", made) is entry and made == ["a"]
    assert not entry.lock.locked()


def test_the_least_recently_used_entry_is_evicted():
    cache, made = GraphCache(size=2), []
    for key in "abc":
        assert take(cache, key, made) is None
        assert take(cache, key, made).key == key
    assert made == ["a", "b", "c"]
    # "a" went when "c" came: seen afresh, made again at its second sighting
    assert take(cache, "a", made) is None
    assert take(cache, "a", made).key == "a" and made == ["a", "b", "c", "a"]
    # "b" went when "a" came back; "c" stays, and using it keeps it
    assert take(cache, "c", made).key == "c"
    assert take(cache, "b", made) is None
    assert take(cache, "b", made).key == "b"
    assert take(cache, "c", made).key == "c" and made == ["a", "b", "c", "a", "b"]
    assert take(cache, "a", made) is None


def test_sightings_are_bounded():
    cache, made = GraphCache(size=2, sightings=2), []
    for key in "xyz":
        assert take(cache, key, made) is None
    # "x" was forgotten when "z" was seen: its next sighting is a first one
    assert take(cache, "x", made) is None
    assert take(cache, "z", made).key == "z" and made == ["z"]


def tensors(n=64, D=8, E=4, B=5, L=4, int8=False):
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(n, D, generator=gen)
    return dict(
        table=table.to(torch.int8) if int8 else table,
        nbr=torch.randint(0, n, (n, E), generator=gen, dtype=torch.int32),
        labels=torch.zeros((n, E, 2), dtype=torch.int32),
        norms=torch.ones(n), scales=torch.ones(n) if int8 else None,
        q=torch.randn(B, D, generator=gen), states=torch.zeros((B, 2), dtype=torch.int32),
        ep=torch.zeros(B, dtype=torch.int32),
    )


SIZES = dict(beam=4, expand=1, max_iters=16, block=8)


def key_of(t, **sizes):
    return graph_key(t["table"], t["nbr"], t["labels"], t["norms"], t["scales"], t["q"],
                     t["states"], t["ep"], **{**SIZES, **sizes})


@pytest.mark.parametrize("change", [
    lambda t: t.update(q=torch.zeros(6, 8)),                          # B
    lambda t: t.update(tensors(D=16)),                                # D
    lambda t: t.update(tensors(n=65)),                                # n
    lambda t: t.update(nbr=torch.zeros((64, 5), dtype=torch.int32),
                       labels=torch.zeros((64, 5, 2), dtype=torch.int32)),   # E
    lambda t: t.update(tensors(int8=True)),                           # table dtype, scales
    lambda t: t.update(table=t["table"].clone()),                     # an index pointer
    lambda t: t.update(nbr=t["nbr"].clone()),
    lambda t: t.update(labels=t["labels"].clone()),
    lambda t: t.update(norms=t["norms"].clone()),
    lambda t: t.update(ep=t["ep"].long()),                            # an input dtype
], ids=["B", "D", "n", "E", "int8", "table", "nbr", "labels", "norms", "ep-dtype"])
def test_a_change_of_what_a_capture_bakes_in_is_a_new_key(change):
    t = tensors()
    before = key_of(t)
    assert key_of(dict(t)) == before
    change(t)
    assert key_of(t) != before


@pytest.mark.parametrize("sizes", [dict(beam=8), dict(expand=2), dict(max_iters=24),
                                   dict(block=4)], ids=["L", "M", "max_iters", "block"])
def test_a_change_of_the_loop_is_a_new_key(sizes):
    t = tensors()
    assert key_of(t, **sizes) != key_of(t)


def test_another_kernel_build_is_a_new_key(monkeypatch):
    """``_build.swapped`` puts another build in place of a library: graphs
    captured with the first would still launch it."""
    t = tensors()
    before = key_of(t)
    monkeypatch.setitem(_build._libs, "beam_merge", object())
    assert key_of(t) != before


def test_new_queries_in_place_keep_the_key():
    """Each batch's queries, states and entries are copied into the entry's
    static inputs, so only their shapes and dtypes are in the key."""
    t = tensors()
    before = key_of(t)
    t.update(q=torch.randn(5, 8), states=torch.ones((5, 2), dtype=torch.int32),
             ep=torch.ones(5, dtype=torch.int32))
    assert key_of(t) == before


# --- on the card ------------------------------------------------------------------------

N, D, B, K = 4096, 128, 4096, 10
# the bulk cell's two searches: GRAPH and GRAPH_WIDE (L, M, max_iters)
SEARCHES = [(64, 1, 128), (128, 2, 256)]
CPU_ROWS = 128
SELECTIVITIES = (0.003, 0.01, 0.03, 0.1, 0.3)


@pytest.fixture(scope="module")
def card_index():
    """A packed-label index built and exported on the card, and three
    batches of queries of one shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured and replayed only there")
    from repro_torch.core import build_index
    from repro_torch.data import generate_queries, make_dataset, make_queries_vectors
    from repro_torch.exec import export_planned_graph

    vecs, s, t = make_dataset(N, D, seed=0)
    g, et, _ = build_index(vecs, s, t, "containment", device="cuda")
    dg = export_planned_graph(g, et, device="cuda")
    di = dg.device("cuda")
    labels = dg.serving_labels(device="cuda")
    assert labels.shape[-1] == 2
    batches = []
    for seed in range(3):
        qv = make_queries_vectors(B, D, seed=10 + seed)
        s_q, t_q = np.empty(B), np.empty(B)
        for j, sel in enumerate(SELECTIVITIES):
            idx = np.arange(j, B, len(SELECTIVITIES))
            qs = generate_queries(qv[idx], s, t, "containment", sel, k=K, seed=100 * seed + j)
            s_q[idx], t_q[idx] = qs.s_q, qs.t_q
        states, ep = prepare_states(dg, s_q, t_q)
        assert (ep >= 0).mean() > 0.9
        batches.append(tuple(torch.as_tensor(x, device="cuda") for x in (qv, states, ep)))
    return (di.table, di.nbr, labels, di.norms, di.scales), batches


def search(index, batch, L, M, max_iters):
    table, nbr, labels, norms, scales = index
    return search_core(table, nbr, labels, *batch, k=K, beam=L, expand=M, max_iters=max_iters,
                       norms=norms, scales=scales)


def counted(fn):
    """(fn(), its ops.LAUNCHES and LOOP_STATS deltas, its replay spans)."""
    launches, loop = dict(ops.LAUNCHES), dict(batched.LOOP_STATS)
    n, _, calls = trace.TOTALS.read()
    with trace.trace_span(trace.BATCH):
        out = fn()
    torch.cuda.synchronize()
    m, _, after = trace.TOTALS.read()
    assert m == n + 1
    return (out, {k: v - launches[k] for k, v in ops.LAUNCHES.items()},
            {k: v - loop[k] for k, v in batched.LOOP_STATS.items()},
            after["search.block.replay"] - calls["search.block.replay"])


def same(got, want):
    return torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32),
                                                        want[1].view(torch.int32))


@pytest.mark.card
@pytest.mark.parametrize("L,M,max_iters", SEARCHES, ids=["graph", "wide"])
def test_replayed_search_is_the_eager_loop(card_index, monkeypatch, L, M, max_iters):
    index, (b0, b1, b2) = card_index
    with monkeypatch.context() as m:
        m.setattr(batched, "_graph_entry", lambda key, make: None)
        eager = [counted(lambda b=b: search(index, b, L, M, max_iters)) for b in (b1, b2)]
    assert all(e[3] == 0 for e in eager)
    monkeypatch.setattr(batched, "_GRAPHS", GraphCache())
    first = counted(lambda: search(index, b0, L, M, max_iters))
    assert first[3] == 0                                   # a first sighting runs eagerly
    replayed = [counted(lambda: search(index, b1, L, M, max_iters))]
    kept = tuple(x.clone() for x in replayed[0][0])
    replayed.append(counted(lambda: search(index, b2, L, M, max_iters)))
    for (got, launches, loop, replays), (want, e_launches, e_loop, _) in zip(replayed, eager):
        assert same(got, want)
        assert launches == e_launches and loop == e_loop
        assert replays == loop["iterations"] // batched.LOOP_BLOCK > 0
    # the first call's answer is its own, not a view of the graphs' buffers
    assert same(replayed[0][0], kept)
    # the CPU's plain search on the first rows of the second batch
    cpu_index = tuple(None if x is None else x.cpu() for x in index)
    rows = tuple(x[:CPU_ROWS].cpu() for x in b2)
    want = search(cpu_index, rows, L, M, max_iters)
    assert same(tuple(x[:CPU_ROWS].cpu() for x in replayed[1][0]), want)
