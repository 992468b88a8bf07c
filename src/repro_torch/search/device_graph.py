"""Device-resident UDG: padded dense arrays exported from the host index.

The host adjacency (ragged lists of labeled tuples) is exported as

  nbr     [n, E] int32       neighbor id per tuple slot (-1 = padding)
  plabels [n, E, 2] uint32   bit-packed canonical rank rectangles — the
                             default layout: (l, r) in the two 16-bit
                             halves of word 0, (b, e) in word 1
  labels  [n, E, 4] int32    the unpacked layout, kept only when a grid
                             exceeds the 16-bit rank budget (or the caller
                             forces ``packed_labels=False``)

with E = max labeled degree rounded up to a lane multiple, plus the entry
table, the canonical grids, cached per-node squared norms, optional int8
storage with per-vector scales, and the planner's selectivity estimator
(built by the exec layer and handed in: ``repro_torch.exec.export_planned_graph``).
The host arrays are numpy and equal the JAX package's export array by array,
but for the norms: summed in f64 in the scorers' order and rounded once,
they are within an f32 ulp of the reference's f32 sums.

``DeviceGraph.device(device)`` stages the search-visible arrays as torch
tensors, memoized per device. On a device the packed words are carried as
int32 bit patterns (torch has no shifts for uint32). ``serving_labels``
picks the layout a search runs with, as the reference's does: the packed
words for the fused search when the export has them, otherwise (and always
for ``fused=False``) the int32 ``[n, E, 4]`` rectangles.

``device_graph_from_numpy`` rebuilds a ``DeviceGraph`` from another
export's arrays unchanged, so two implementations can search the same index.
``SegmentStack`` concatenates uniform-capacity exports into the one flat
graph the segmented tier's worklist searches (``repro_torch.scale``).
``BroadExport`` is the wave constructor's label-ignoring adjacency, and
``DeltaSegment`` the streaming index's fixed-capacity view of its delta
tier (``repro_torch.stream``).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core.entry import EntryTable
from repro_torch.core.graph import LabeledGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import unpack_labels as _unpack_labels_tensor
from repro_torch.kernels.ref import warp_dot

# canonical ranks are packed two-per-word in 16-bit halves; a grid axis
# with more distinct values than this cannot use the packed layout
RANK_LIMIT = 1 << 16


def pack_labels(labels: np.ndarray) -> np.ndarray:
    """Bit-pack int32 rank rectangles ``[..., 4]`` (l, r, b, e) into uint32
    word pairs ``[..., 2]``: word 0 = ``l | r << 16``, word 1 =
    ``b | e << 16``. Raises ``ValueError`` when any rank is negative or
    >= 2^16 (use the int32 layout instead — see ``export_device_graph``)."""
    labels = np.asarray(labels)
    if labels.shape[-1] != 4:
        raise ValueError(f"expected trailing dim 4, got {labels.shape}")
    if labels.size and (labels.min() < 0 or labels.max() >= RANK_LIMIT):
        raise ValueError(
            f"rank out of 16-bit range [0, {RANK_LIMIT}): "
            f"min={labels.min() if labels.size else 0} "
            f"max={labels.max() if labels.size else 0}"
        )
    u = labels.astype(np.uint32)
    out = np.empty(labels.shape[:-1] + (2,), dtype=np.uint32)
    out[..., 0] = u[..., 0] | (u[..., 1] << 16)
    out[..., 1] = u[..., 2] | (u[..., 3] << 16)
    return out


def unpack_labels(plabels: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_labels`: uint32 ``[..., 2]`` -> int32
    ``[..., 4]`` rectangles. Bitwise round-trip."""
    plabels = np.asarray(plabels, dtype=np.uint32)
    if plabels.shape[-1] != 2:
        raise ValueError(f"expected trailing dim 2, got {plabels.shape}")
    out = np.empty(plabels.shape[:-1] + (4,), dtype=np.int32)
    out[..., 0] = (plabels[..., 0] & 0xFFFF).astype(np.int32)
    out[..., 1] = (plabels[..., 0] >> 16).astype(np.int32)
    out[..., 2] = (plabels[..., 1] & 0xFFFF).astype(np.int32)
    out[..., 3] = (plabels[..., 1] >> 16).astype(np.int32)
    return out


def unpack_labels_device(plabels: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`unpack_labels` for device tensors: packed word
    pairs ``[..., 2]`` (int32 bit patterns, as ``DeviceGraph.device()``
    stages them) -> int32 ``[..., 4]`` rectangles, on the tensor's device.
    The serving step's ``fused=False`` branch reads its int32 rectangles
    from a packed label stack through it; one definition of the word
    layout, shared with the kernels' plain versions (``kernels/ref.py``)."""
    return _unpack_labels_tensor(plabels)


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    """Torch views of a ``DeviceGraph``'s search-visible arrays on one device.

    ``table`` is the storage the distance kernels score (int8 ``vec_q`` when
    quantized, else f32 ``vectors``); ``labels`` is the packed ``[n, E, 2]``
    table as int32 bit patterns when the export packed, else the int32
    ``[n, E, 4]`` layout."""

    table: torch.Tensor              # [n, d] f32 or int8
    scales: torch.Tensor | None      # [n] f32 (int8 storage only)
    norms: torch.Tensor              # [n] f32 cached ‖v‖²
    nbr: torch.Tensor                # [n, E] int32
    labels: torch.Tensor             # [n, E, 2] or [n, E, 4] int32

    @property
    def packed(self) -> bool:
        return self.labels.shape[-1] == 2


@dataclasses.dataclass
class DeviceGraph:
    vectors: np.ndarray        # [n, d] f32
    nbr: np.ndarray            # [n, E] int32, -1 padded
    labels: np.ndarray | None  # [n, E, 4] int32 — None when packed-only
    U_X: np.ndarray            # [num_x] f64 canonical X values
    U_Y: np.ndarray            # [num_y] f64 canonical Y values
    entry_node: np.ndarray     # [num_x] int32 (-1 = none)
    entry_y_rank: np.ndarray   # [num_x] int32
    relation: str
    norms: np.ndarray | None = None   # [n] f32 cached ‖v‖² of the rows the
                                      # search scores (dequantized if int8);
                                      # every export carries them
    vec_q: np.ndarray | None = None   # [n, d] int8 quantized storage
    scales: np.ndarray | None = None  # [n] f32 per-vector dequant scales
    planner: object | None = None     # repro_torch.exec.SelectivityEstimator
    plabels: np.ndarray | None = None  # [n, E, 2] uint32 bit-packed labels
    _cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def max_degree(self) -> int:
        return int(self.nbr.shape[1])

    def labels_i32(self) -> np.ndarray:
        """The int32 ``[n, E, 4]`` rectangle view — the stored array when
        the export fell back, otherwise unpacked (and cached) from the
        packed words."""
        if self.labels is not None:
            return self.labels
        out = self._cache.get("labels_i32")
        if out is None:
            out = self._cache["labels_i32"] = unpack_labels(self.plabels)
        return out

    def device(self, device=None) -> DeviceIndex:
        """Memoized torch bundle of the search-visible arrays on ``device``
        (``None`` = the CUDA card)."""
        dev = resolve_device(device)
        key = ("device", str(dev))
        out = self._cache.get(key)
        if out is None:
            if self.vec_q is not None:
                table, scales = self.vec_q, self.scales
            else:
                table, scales = self.vectors, None
            lab = self.plabels.view(np.int32) if self.plabels is not None else self.labels

            def put(a):
                return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            out = self._cache[key] = DeviceIndex(
                table=put(table), scales=put(scales), norms=put(self.norms),
                nbr=put(self.nbr), labels=put(lab),
            )
        return out

    def serving_labels(self, *, fused: bool = True, packed: bool | None = None,
                       device=None) -> torch.Tensor:
        """The device label view a search runs with, one rule for every
        entry point (as the reference's):

        * ``packed=None``: the packed words whenever the export has them;
        * ``packed=True``: require them (``ValueError`` on an int32 export,
          whatever ``fused``);
        * ``packed=False``: the int32 ``[n, E, 4]`` rectangles;
        * ``fused=False``: always the int32 rectangles, the only layout the
          unfused branch reads."""
        if packed is None:
            packed = self.plabels is not None
        elif packed and self.plabels is None:
            raise ValueError(
                "packed=True but the export carries no packed labels (grid "
                "beyond the 16-bit rank budget or packed_labels=False)")
        di = self.device(device)
        if fused and packed:
            return di.labels
        return self.device_labels_i32(device) if di.packed else di.labels

    def device_labels_i32(self, device=None) -> torch.Tensor:
        """Memoized int32 ``[n, E, 4]`` rectangles on ``device``."""
        dev = resolve_device(device)
        key = ("labels_i32", str(dev))
        out = self._cache.get(key)
        if out is None:
            out = self._cache[key] = torch.from_numpy(self.labels_i32()).to(dev)
        return out

    def nbytes_by_component(self) -> dict:
        """Host bytes of each index component (the at-rest layout: packed
        labels when available; the lazily unpacked cache is not counted)."""
        lab = self.plabels if self.plabels is not None else self.labels
        out = {
            "vectors": self.vectors.nbytes,
            "nbr": self.nbr.nbytes,
            "labels": lab.nbytes if lab is not None else 0,
            "grids": self.U_X.nbytes + self.U_Y.nbytes,
            "entry": self.entry_node.nbytes + self.entry_y_rank.nbytes,
        }
        if self.norms is not None:
            out["norms"] = self.norms.nbytes
        if self.vec_q is not None:
            out["vec_q"] = self.vec_q.nbytes
        if self.scales is not None:
            out["scales"] = self.scales.nbytes
        return out


def export_device_graph(
    g: LabeledGraph,
    et: EntryTable | None = None,
    *,
    lane: int = 8,
    node_capacity: int | None = None,
    edge_capacity: int | None = None,
    quantize_int8: bool = False,
    packed_labels: bool | None = None,
    planner=None,
    device=None,
) -> DeviceGraph:
    """Pad the host adjacency into dense arrays (E = max degree, lane-aligned)
    and stage the search-visible ones on ``device`` (``None`` = the card).

    ``node_capacity``/``edge_capacity`` fix the padded dims to static sizes.
    Rows whose labeled degree exceeds ``edge_capacity`` keep their earliest
    tuples (the threshold sweep's; patch tuples come last and go first).
    ``packed_labels``: ``None`` packs when both grids fit 16-bit ranks and
    falls back to int32 with a warning otherwise; ``True`` requires the
    packed layout; ``False`` forces int32. With ``quantize_int8`` the export
    carries int8 storage and per-vector scales, and the cached norms are of
    the dequantized rows. ``planner`` is carried as given (the exec layer
    builds it: ``repro_torch.exec.export_planned_graph``).
    """
    if et is None:
        et = EntryTable(g)
    degs = [g.adj[u].size for u in range(g.n)]
    E = max(degs) if degs else 1
    E = max(((E + lane - 1) // lane) * lane, lane)
    if edge_capacity is not None:
        E = edge_capacity
    n_pad = g.n if node_capacity is None else node_capacity
    if n_pad < g.n:
        raise ValueError(f"node_capacity {n_pad} < graph size {g.n}")
    nbr = np.full((n_pad, E), -1, dtype=np.int32)
    labels = np.zeros((n_pad, E, 4), dtype=np.int32)
    for u in range(g.n):
        nb, l, r, b, e = g.tuples(u)
        k = min(nb.shape[0], E)
        nbr[u, :k] = nb[:k]
        labels[u, :k, 0] = l[:k]
        labels[u, :k, 1] = r[:k]
        labels[u, :k, 2] = b[:k]
        labels[u, :k, 3] = e[:k]
    vectors = g.vectors
    if n_pad > g.n:
        vectors = np.zeros((n_pad, g.dim), dtype=np.float32)
        vectors[: g.n] = g.vectors
    vec_q = scales = None
    if quantize_int8:
        v32 = np.asarray(vectors, dtype=np.float32)
        amax = np.maximum(np.max(np.abs(v32), axis=1), 1e-12)
        scales = (amax / 127.0).astype(np.float32)
        vec_q = np.clip(np.round(v32 / scales[:, None]), -127, 127).astype(np.int8)
        scored = vec_q.astype(np.float32) * scales[:, None]
    else:
        scored = np.asarray(vectors, dtype=np.float32)
    # summed in the scorers' f64 order and rounded once (within an f32 ulp of
    # the reference's f32 sum): the norm the unfused scorer recomputes from
    # the row is then this one, bit for bit
    norms = warp_dot(torch.from_numpy(scored), torch.from_numpy(scored)).numpy()
    ent = et.device_arrays()
    num_x, num_y = g.space.U_X.shape[0], g.space.U_Y.shape[0]
    fits = num_x <= RANK_LIMIT and num_y <= RANK_LIMIT
    plabels = None
    if packed_labels is None:
        if fits:
            plabels = pack_labels(labels)
            labels = None
        else:
            warnings.warn(
                f"canonical grid ({num_x} x {num_y}) exceeds the 16-bit "
                f"rank budget ({RANK_LIMIT}); falling back to the int32 "
                "label layout", RuntimeWarning, stacklevel=2,
            )
    elif packed_labels:
        if not fits:
            raise ValueError(
                f"packed_labels=True but canonical grid ({num_x} x {num_y})"
                f" exceeds the 16-bit rank budget ({RANK_LIMIT})"
            )
        plabels = pack_labels(labels)
        labels = None
    dg = DeviceGraph(
        vectors=vectors,
        nbr=nbr,
        labels=labels,
        U_X=g.space.U_X.copy(),
        U_Y=g.space.U_Y.copy(),
        entry_node=ent["entry_node"],
        entry_y_rank=ent["entry_y_rank"],
        relation=g.relation.name,
        norms=norms,
        vec_q=vec_q,
        scales=scales,
        planner=planner,
        plabels=plabels,
    )
    dg.device(device)
    return dg


# the DeviceGraph fields device_graph_from_numpy takes (None where absent)
GRAPH_FIELDS = (
    "vectors", "nbr", "labels", "plabels", "U_X", "U_Y", "entry_node",
    "entry_y_rank", "relation", "norms", "vec_q", "scales",
)


def device_graph_from_numpy(arrays: dict, *, planner=None, device=None) -> DeviceGraph:
    """A ``DeviceGraph`` over another export's arrays, taken unchanged.

    ``arrays`` holds the export's fields (``GRAPH_FIELDS``; absent or
    ``None`` where the export has none, e.g. ``vec_q`` of an f32 export);
    ``planner`` is carried as given (``repro_torch.exec.planned_graph_from_numpy``
    rebuilds it from the same arrays). The device bundle is staged on
    ``device`` (``None`` = the card)."""

    def arr(name):
        v = arrays.get(name)
        return None if v is None else np.array(v)

    fields = {f: arr(f) for f in GRAPH_FIELDS if f != "relation"}
    if fields["plabels"] is not None:
        fields["plabels"] = fields["plabels"].view(np.uint32)
    dg = DeviceGraph(relation=str(arrays["relation"]), planner=planner, **fields)
    dg.device(device)
    return dg


class SegmentStack:
    """Flat concatenation of uniform-capacity segment exports on one device.

    The segmented tier's worklist scheduler (``repro_torch.scale``) runs any
    routed-segment mix as one search over one *flat* graph: segment ``i``
    owns rows ``[i·node_capacity, (i+1)·node_capacity)`` of every stacked
    view, and each part's neighbour table is **pre-offset** by that base
    when it is stacked (``nbr + i·node_capacity`` where real, ``-1`` where
    padding). Adjacency is segment-closed, so the unmodified search core
    walks the flat graph and every query row stays inside its own segment.

    ``gids`` maps each flat node to its global object id (``-1`` on
    capacity-padding rows). ``set_segment`` replaces one part and drops only
    the memoized flat concatenations; every other part keeps the same
    tensors, so a segment-local epoch swap restages one segment, not the
    fleet.
    """

    def __init__(self, *, node_capacity: int, edge_capacity: int, device=None):
        self.node_capacity = int(node_capacity)
        self.edge_capacity = int(edge_capacity)
        self.device = resolve_device(device)
        self._parts: list = []
        self._flat: dict = {}

    @property
    def num_segments(self) -> int:
        return len(self._parts)

    @property
    def packed(self) -> bool:
        return bool(self._parts) and self._parts[0]["labels"].shape[-1] == 2

    @property
    def quantized(self) -> bool:
        return bool(self._parts) and self._parts[0]["scales"] is not None

    def part(self, i: int) -> dict:
        """Segment ``i``'s part (table/scales/norms/nbr/labels/gids)."""
        return self._parts[i]

    def _make_part(self, si: int, dg: DeviceGraph, gids: np.ndarray) -> dict:
        di = dg.device(self.device)
        ncap, ecap = self.node_capacity, self.edge_capacity
        if di.table.shape[0] != ncap:
            raise ValueError(
                f"segment export has {di.table.shape[0]} node rows, "
                f"stack capacity is {ncap}")
        if di.nbr.shape[1] != ecap:
            raise ValueError(
                f"segment export has edge capacity {di.nbr.shape[1]}, "
                f"stack capacity is {ecap}")
        if self._parts:
            first = self._parts[0]
            if (di.scales is None) != (first["scales"] is None):
                raise ValueError("mixed quantized/f32 segments in one stack")
            if di.labels.shape[-1] != first["labels"].shape[-1]:
                raise ValueError("mixed label layouts in one stack")
        g = np.full(ncap, -1, dtype=np.int32)
        gids = np.asarray(gids).reshape(-1)
        g[: gids.shape[0]] = gids.astype(np.int32)
        return {
            "table": di.table,
            "scales": di.scales,
            "norms": di.norms,
            "nbr": torch.where(di.nbr >= 0, di.nbr + si * ncap, -1).to(torch.int32),
            "labels": di.labels,
            "gids": torch.from_numpy(g).to(self.device),
        }

    def append_segment(self, dg: DeviceGraph, gids: np.ndarray) -> None:
        """Append one segment's export as the next slice."""
        self._parts.append(self._make_part(len(self._parts), dg, gids))
        self._flat.clear()

    def set_segment(self, i: int, dg: DeviceGraph, gids: np.ndarray) -> None:
        """Replace segment ``i``'s part (an epoch swap); every other part's
        tensors are untouched, only the flat memos rebuild."""
        self._parts[i] = self._make_part(i, dg, gids)
        self._flat.clear()

    def blank_segment(self, i: int) -> None:
        """Scrub segment ``i``'s slice: zeroed table, norms, scales and
        labels, empty adjacency, every gid -1, in the same shapes and
        dtypes. Quarantine uses it so a poisoned segment's rows never
        surface: a traversal landing there finds no edges and gid -1."""
        old = self._parts[i]
        self._parts[i] = {
            "table": torch.zeros_like(old["table"]),
            "scales": None if old["scales"] is None else torch.zeros_like(old["scales"]),
            "norms": torch.zeros_like(old["norms"]),
            "nbr": torch.full_like(old["nbr"], -1),
            "labels": torch.zeros_like(old["labels"]),
            "gids": torch.full_like(old["gids"], -1),
        }
        self._flat.clear()

    def flat(self, key: str):
        """Memoized flat ``[S·node_capacity, ...]`` concatenation of one
        component (``table``/``scales``/``norms``/``nbr``/``labels``/
        ``labels_i32``/``gids``); ``scales`` is ``None`` on an f32 stack."""
        out = self._flat.get(key)
        if out is None:
            if key == "labels_i32":
                parts = [unpack_labels_device(p["labels"]) if p["labels"].shape[-1] == 2
                         else p["labels"] for p in self._parts]
            else:
                parts = [p[key] for p in self._parts]
                if any(v is None for v in parts):
                    return None
            out = self._flat[key] = torch.cat(parts, dim=0)
        return out

    def flat_labels(self, *, fused: bool = True, packed: bool | None = None):
        """The flat label view under ``DeviceGraph.serving_labels``'s rule:
        the packed words when the stack has them and the search runs
        fused, else the int32 ``[.., E, 4]`` rectangles."""
        if packed is None:
            packed = self.packed
        elif packed and not self.packed:
            raise ValueError("packed=True but the stack carries no packed labels")
        if fused and packed:
            return self.flat("labels")
        return self.flat("labels_i32") if self.packed else self.flat("labels")

    def nbytes_by_component(self) -> dict:
        """Device bytes of each stacked component over every part (the flat
        memos, which copy them, are not counted)."""
        out: dict = {}
        for p in self._parts:
            for key in ("table", "scales", "norms", "nbr", "labels", "gids"):
                v = p.get(key)
                if v is not None:
                    out[key] = out.get(key, 0) + v.numel() * v.element_size()
        return out

    def nbytes(self) -> int:
        return sum(self.nbytes_by_component().values())


class BroadExport:
    """Incrementally maintained *broad* (label-ignoring) adjacency of the
    wave constructor: a padded ``[n_pad, width]`` int32 unique-neighbor table
    (-1 padded), folded in edge by edge as the host emits them, so a wave's
    search reads a column slice instead of a full export. A numpy copy of the
    reference's ``BroadExport``.

    ``max_width`` bounds the per-row degree: once a row is full, later
    neighbors are dropped. Rows fill in discovery order, so what survives
    is the node's own sweep-time neighborhood (diversity-PRUNEd close
    neighbors) plus the earliest reverse edges — the connectivity-critical
    set, same policy as ``export_device_graph`` under ``edge_capacity``.
    Capping keeps the wave search's per-iteration gather narrow as hub
    degrees grow: broad-pool recall is flat down to width ≈ Z while the
    iteration cost scales linearly with width.
    """

    def __init__(
        self,
        n_pad: int,
        *,
        init_degree: int = 64,
        lane: int = 32,
        max_width: int | None = None,
    ):
        self._lane = lane
        self._max_width = None
        if max_width is not None:
            self._max_width = ((int(max_width) + lane - 1) // lane) * lane
        cap = max(int(init_degree), lane)
        if self._max_width is not None:
            cap = min(cap, self._max_width)
        self._nbr = np.full((n_pad, cap), -1, dtype=np.int32)
        self._deg = np.zeros(n_pad, dtype=np.int32)
        self.max_degree = 0

    def _grow(self, need: int) -> None:
        cap = self._nbr.shape[1]
        new_cap = max(need, cap * 2)
        new_cap = ((new_cap + self._lane - 1) // self._lane) * self._lane
        if self._max_width is not None:
            new_cap = min(new_cap, self._max_width)
        if new_cap <= cap:
            return
        grown = np.full((self._nbr.shape[0], new_cap), -1, dtype=np.int32)
        grown[:, :cap] = self._nbr
        self._nbr = grown

    def add_edges(self, u: int, vs: np.ndarray) -> None:
        """Fold the bidirectional pairs (u, v) for v in ``vs`` into the table,
        deduplicating; full rows (``max_width``) drop further neighbors."""
        vs = np.unique(np.asarray(vs, dtype=np.int32))
        vs = vs[vs != u]
        if vs.size == 0:
            return
        du = int(self._deg[u])
        new = vs[~np.isin(vs, self._nbr[u, :du])]
        if new.size == 0:
            return
        if du + new.size > self._nbr.shape[1]:
            self._grow(du + int(new.size))
        space = self._nbr.shape[1] - du
        fwd = new[:space]
        self._nbr[u, du : du + fwd.size] = fwd
        self._deg[u] = du + fwd.size
        self.max_degree = max(self.max_degree, du + int(fwd.size))
        for v in new.tolist():
            dv = int(self._deg[v])
            if dv >= self._nbr.shape[1]:
                self._grow(dv + 1)  # no-op once at max_width
                if dv >= self._nbr.shape[1]:
                    continue  # row full under max_width
            # capping breaks the symmetry invariant, so membership is
            # re-checked (rows are <= max_width wide; O(width) scan)
            if u in self._nbr[v, :dv]:
                continue
            self._nbr[v, dv] = u
            self._deg[v] = dv + 1
            if dv + 1 > self.max_degree:
                self.max_degree = dv + 1

    def export_width(self) -> int:
        """Current lane-aligned export width."""
        w = max(self.max_degree, 1)
        return ((w + self._lane - 1) // self._lane) * self._lane

    def view(self, width: int | None = None) -> np.ndarray:
        """``[n_pad, width]`` int32 neighbor table (-1 padded), no copy."""
        return self._nbr[:, : (width or self.export_width())]


@dataclasses.dataclass
class DeltaSegment:
    """Fixed-capacity view of the streaming index's mutable delta tier.

    ``labels`` rectangles are in monotone float-key space
    (``repro_torch.stream.delta.sort_key``): slot i is active for the query
    key state (a, c) iff ``l <= a <= r and b <= c <= e`` with ``(l, r, b,
    e) = (INT32_MIN, key(X_i), key(Y_i), INT32_MAX)``, which is the
    predicate ``X_i >= x_q and Y_i <= y_q`` of Eq. (1), tested by the same
    gather scorer (B3) as graph-tier candidates. Dead and unwritten slots
    have ``slot_ids = -1`` (masked by the scorer) and an empty rectangle.
    """

    vectors: np.ndarray    # [C, d] f32
    labels: np.ndarray     # [C, 4] int32 key-space rectangles
    slot_ids: np.ndarray   # [C] int32, slot index or -1 = dead
    ext_ids: np.ndarray    # [C] int32 external ids (-1 = dead)

    @property
    def capacity(self) -> int:
        return int(self.vectors.shape[0])

    def nbytes(self) -> int:
        return sum(
            a.nbytes for a in (self.vectors, self.labels, self.slot_ids, self.ext_ids)
        )
