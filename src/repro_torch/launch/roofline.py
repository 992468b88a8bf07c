"""Roofline-term derivation from dry-run records (the JAX package's
``launch/roofline.py``), for the NVIDIA H100 SXM.

Hardware model (NVIDIA H100 Tensor Core GPU data sheet, SXM5):
  peak dense bf16 compute   989 TFLOP/s per card
  HBM3 bandwidth            3.35 TB/s per card
  NVLink 4                  450 GB/s per card and direction (900 GB/s
                            both ways), all to all within one node
Inter-node links (InfiniBand NDR, 400 Gb/s a NIC) are not modelled: every
collective is charged at the NVLink rate, as if the mesh lay inside one
NVLink domain. The reference charges its TPU v5e rates (197 TFLOP/s, 819
GB/s, 50 GB/s a link); no number of either model is a measured time.

The dry-run's counts are per rank (``launch/dryrun.py`` runs one rank's
step), so the three terms
  compute    = flops_per_chip / peak
  memory     = hbm_bytes_per_chip / hbm_bw
  collective = collective_bytes_per_chip / link_bw
are the spec's total / (chips x rate) form. A record whose work runs at
other rates passes its own compute time (``derive(compute_s=)``).

MODEL_FLOPS uses 6*N*D for training (N = params, D = tokens; N_active for
MoE) and 2*N*D for forward-only (prefill/decode) steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12      # dense bf16 / card
HBM_BW = 3.35e12         # bytes/s / card
LINK_BW = 450e9          # bytes/s / card and direction (NVLink 4)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops_total: float
    compute_s: Optional[float] = None     # None: flops_per_chip / PEAK_FLOPS
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flops_ratio: float = 0.0
    roofline_fraction: float = 0.0

    def finalize(self) -> "RooflineTerms":
        if self.compute_s is None:
            self.compute_s = self.flops_per_chip / PEAK_FLOPS
        self.memory_s = self.hbm_bytes_per_chip / HBM_BW
        self.collective_s = self.collective_bytes_per_chip / LINK_BW
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.bottleneck = max(terms, key=terms.get)  # type: ignore[arg-type]
        total_flops = self.flops_per_chip * self.chips
        self.useful_flops_ratio = (
            self.model_flops_total / total_flops if total_flops else 0.0
        )
        # fraction of the compute roofline realized if the step runs at the
        # bound given by its dominant term: useful_time / bound_time
        useful_time = self.model_flops_total / (self.chips * PEAK_FLOPS)
        bound = max(terms.values())
        self.roofline_fraction = useful_time / bound if bound > 0 else 0.0
        return self

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops(
    kind: str, n_params: int, n_active_params: int, tokens: int
) -> float:
    """6ND train / 2ND forward-only, with N = active params for MoE."""
    n = n_active_params or n_params
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def derive(
    *,
    arch: str,
    shape: str,
    mesh: str,
    chips: int,
    cost: Dict,
    coll: Dict,
    kind: str,
    n_params: int,
    n_active_params: int,
    tokens: int,
    compute_s: Optional[float] = None,
) -> RooflineTerms:
    """The three terms of one record. ``compute_s``, when given, replaces
    ``flops / PEAK_FLOPS``: work that runs at other rates than dense bf16
    (the udg-serve cell's FP32 scoring and merge compares,
    ``kernels/bounds.py``)."""
    return RooflineTerms(
        arch=arch,
        shape=shape,
        mesh=mesh,
        chips=chips,
        flops_per_chip=float(cost.get("flops", 0.0)),
        hbm_bytes_per_chip=float(cost.get("bytes accessed", 0.0)),
        collective_bytes_per_chip=float(coll.get("total", 0)),
        model_flops_total=model_flops(kind, n_params, n_active_params, tokens),
        compute_s=compute_s,
    ).finalize()
