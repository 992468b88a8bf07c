"""Collective-communication byte accounting (the JAX package's
``launch/hlo.py``).

The reference parses the optimized HLO of a compiled step: every
``all-gather`` / ``all-reduce`` / ``reduce-scatter`` / ``all-to-all`` /
``collective-permute`` contributes its operand bytes. Eager PyTorch has no
HLO to parse: every collective of the port's training path runs through
``repro_torch.distributed.comm``, which counts each call's operand bytes
(the bytes this rank sends: the local shard of a gather, the tensor of a
reduce) by the same kind names. ``collective_bytes`` turns those counts
into the reference's dict, so the dry-run's records keep their shape.
"""
from __future__ import annotations

from typing import Dict, Mapping

from repro_torch.distributed.comm import KINDS

COLLECTIVE_OPS = KINDS


def collective_bytes(counts: Mapping[str, Mapping[str, int]]) -> Dict[str, int]:
    """Per-collective-kind operand bytes (per rank), plus op counts.

    ``counts`` is ``distributed.comm.counts()`` (``{kind: {"bytes",
    "calls"}}``). Returns {kind: bytes, ..., f"{kind}_count": int,
    "total": int} with only the kinds that ran, as the reference's."""
    out: Dict[str, int] = {}
    for kind in COLLECTIVE_OPS:
        c = counts.get(kind)
        if c and c.get("calls"):
            out[kind] = int(c["bytes"])
            out[f"{kind}_count"] = int(c["calls"])
    out["total"] = sum(out[k] for k in COLLECTIVE_OPS if k in out)
    return out
