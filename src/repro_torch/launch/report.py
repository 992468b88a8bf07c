"""Aggregate dry-run JSON records into the EXPERIMENTS.md §Dry-run and
§Roofline tables.

    PYTHONPATH=src python -m repro_torch.launch.report --dir experiments/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(directory: str) -> List[Dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        try:
            recs.append(json.load(open(f)))
        except json.JSONDecodeError:
            continue
    return recs


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def baseline(recs: List[Dict]) -> List[Dict]:
    """Untagged records only (hillclimb variants carry a tag)."""
    return [r for r in recs if not r.get("tag") or r["arch"] == "udg-serve"]


def dryrun_table(recs: List[Dict], mesh: str) -> str:
    lines = [
        "| arch | shape | status | compile | params | bytes/device (args+tmp) | "
        "collective bytes/device | dominant collective |",
        "|---|---|---|---|---|---|---|---|",
    ]
    order = {s: i for i, s in enumerate(SHAPE_ORDER)}
    for r in sorted(
        (r for r in recs if r.get("mesh") == mesh and r["arch"] != "udg-serve"),
        key=lambda r: (r["arch"], order.get(r["shape"], 9)),
    ):
        if r.get("skipped"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | SKIP (long_500k rule) | — | — | — | — | — |"
            )
            continue
        if not r.get("ok"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | FAIL | — | — | — | — | — |"
            )
            continue
        mem = r["memory"]
        coll = r.get("collectives", {})
        kinds = {k: v for k, v in coll.items()
                 if not k.endswith("_count") and k != "total"}
        dom = max(kinds, key=kinds.get) if kinds else "—"
        lines.append(
            "| {a} | {s} | OK | {c}s | {p:.2f}B | {m} | {cb} | {dom} |".format(
                a=r["arch"], s=r["shape"], c=r.get("compile_s", "-"),
                p=r["n_params"] / 1e9,
                m=fmt_bytes(mem["argument_bytes"] + mem["temp_bytes"]),
                cb=fmt_bytes(coll.get("total", 0)),
                dom=dom,
            )
        )
    return "\n".join(lines)


def roofline_table(recs: List[Dict], mesh: str = "pod16x16") -> str:
    lines = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "MODEL_FLOPS | useful/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    order = {s: i for i, s in enumerate(SHAPE_ORDER)}
    for r in sorted(
        (r for r in recs if r.get("mesh") == mesh and r.get("ok")),
        key=lambda r: (r["arch"], order.get(r["shape"], 9)),
    ):
        rf = r["roofline"]
        lines.append(
            "| {a} | {s} | {c} | {m} | {co} | **{b}** | {mf:.2e} | {u:.2f} | {f:.3f} |".format(
                a=r["arch"], s=r["shape"],
                c=fmt_s(rf["compute_s"]), m=fmt_s(rf["memory_s"]),
                co=fmt_s(rf["collective_s"]), b=rf["bottleneck"],
                mf=rf["model_flops_total"], u=rf["useful_flops_ratio"],
                f=rf["roofline_fraction"],
            )
        )
    return "\n".join(lines)


def summary(recs: List[Dict]) -> str:
    ok = sum(1 for r in recs if r.get("ok"))
    skip = sum(1 for r in recs if r.get("skipped"))
    fail = sum(1 for r in recs if not r.get("ok") and not r.get("skipped"))
    return f"{ok} compiled OK, {skip} documented skips, {fail} failures"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args()
    recs = baseline(load(args.dir))
    print("## Summary:", summary(recs))
    print()
    print("## Dry-run table,", args.mesh)
    print(dryrun_table(recs, args.mesh))
    print()
    print("## Roofline table (single pod)")
    print(roofline_table(recs, "pod16x16"))


if __name__ == "__main__":
    main()
