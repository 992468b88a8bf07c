"""Model / run configuration system (a copy of the JAX package's
``configs/base.py``; only ``dtype_of`` differs, returning torch dtypes).

``ModelConfig`` is a frozen dataclass describing one architecture; each
assigned architecture gets a module in this package exporting ``CONFIG``
(full production scale) and ``SMOKE`` (a reduced same-family config for CPU
smoke tests). ``repro_torch.configs.registry`` resolves ``--arch`` names.

Three fields are the reference's knobs for a compiled, sharded program and
are kept so that the two packages' configs stay equal field for field; in
one torch process none of them changes a value:

- ``remat``: what the backward pass recomputes instead of keeping
  (``models.model._maybe_remat``: ``none``, ``dots``, ``full``); it changes
  memory, never a value;
- ``gather_weights``: a sharding constraint at each weight's use; on one
  device the identity;
- ``unroll_layers``: a Python-unrolled stack instead of ``lax.scan`` (the
  same values); the port always loops over its layers in Python.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp_type: str = "swiglu"       # swiglu | squared_relu | gelu
    # attention pattern
    attn_pattern: str = "full"     # full | local_global
    window_size: int = 1024
    global_every: int = 6          # 5 local : 1 global
    attn_chunk: int = 512
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 256
    # SSM
    ssm_kind: str = ""             # "" | mamba1 | mamba2
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # mamba2 only
    ssm_chunk: int = 128
    ssm_impl: str = "scan"         # scan | ssd (chunked quadratic, perf)
    # hybrid (zamba2): one weight-shared attention block every N layers
    hybrid_every: int = 0
    # modality frontend stubs
    num_codebooks: int = 1         # musicgen: 4 EnCodec codebooks
    # numerics
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: str = "dots"            # none | full | dots
    unroll_layers: bool = False    # dry-run probes: python-unrolled stack
    gather_weights: bool = False   # explicit ZeRO-3 gather-at-use (perf)
    ring_local: bool = False       # ring-buffer caches for local layers
    # which shapes are supported (long_500k rule, DESIGN.md section 4)
    sub_quadratic: bool = False

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.ssm_kind != "" and self.hybrid_every == 0

    @property
    def is_hybrid(self) -> bool:
        return self.hybrid_every > 0

    def layer_groups(self) -> Tuple[int, int]:
        """(num_superblocks, layers_per_superblock) for the scanned stack."""
        if self.is_hybrid:
            assert self.num_layers % self.hybrid_every == 0
            return self.num_layers // self.hybrid_every, self.hybrid_every
        if self.attn_pattern == "local_global":
            assert self.num_layers % self.global_every == 0
            return self.num_layers // self.global_every, self.global_every
        return self.num_layers, 1


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered in the dry-run."""
    name: str
    kind: str                     # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """long_500k rule: run only for sub-quadratic (SSM/hybrid/local) archs."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, (
            f"{cfg.name} is pure full attention; long_500k requires "
            "sub-quadratic attention (skip documented in DESIGN.md section 4)"
        )
    return True, ""


def dtype_of(cfg: ModelConfig):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
